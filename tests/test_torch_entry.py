"""knnsvc_torch's entry points and guards on the CPU: the CLI driven end to
end from `.knnsvc.pkl` files, no silent CPU fallback, the multi-device
matchers give the dense matchers' waveforms, the unported options (orbax,
mp3) raise, and no file of the port imports JAX or the JAX package."""

import ast
import json
import pathlib

import numpy as np
import pytest
import torch

from knnsvc_tpu.io.checkpoints import save_params
from knnsvc_torch.cli.inference import main
from knnsvc_torch.hub import KnnSvc
from knnsvc_torch.utils.layer_weights import generate_matrix_from_index

from test_torch_common import (SMALL_HIFIGAN, SMALL_WAVLM, int16_codes, small_generator,
                               small_wavlm, write_pair)

REPO = pathlib.Path(__file__).resolve().parent.parent


@pytest.fixture(scope="module")
def pair(tmp_path_factory):
    root = tmp_path_factory.mktemp("torch_entry")
    return root, write_pair(root)


def test_unported_options_raise(pair):
    root, (src, ref) = pair
    cfg, _, wavlm_params = small_wavlm()
    h, _, _, _, gen_params = small_generator("mix")
    knn = KnnSvc(wavlm_params, cfg, gen_params, h, "mix", device="cpu")
    knn.weighting = generate_matrix_from_index(2, size=cfg.encoder_layers + 1)
    out = str(root / "unported.wav")
    # the multi-device matchers run on both pair paths: the sharded searches
    # pick the dense ones' rows, so the waveforms are the same bits
    pair = lambda fast, matcher, name: int16_codes(knn.convert_pair(
        src, ref, fast=fast, matcher=matcher, output_path=str(root / name)))
    for fast, dense in ((False, "exact"), (False, "int8"), (True, "exact")):
        want = pair(fast, dense, f"{dense}_{fast}.wav")
        got = pair(fast, "sharded" if dense == "exact" else "sharded_int8", "sharded.wav")
        np.testing.assert_array_equal(got, want)
    with pytest.raises(NotImplementedError, match="mp3"):
        knn.convert_pair(src, ref, fast=True, output_path=str(root / "unported.mp3"))
    orbax = root / "orbax_only"
    (orbax / "orbax").mkdir(parents=True, exist_ok=True)
    with pytest.raises(NotImplementedError, match="orbax"):
        KnnSvc.load(str(orbax), "mix", device="cpu")
    with pytest.raises(ValueError, match="no_post_opt"):
        knn.convert_pair(src, ref, fast=True, matcher="sharded_int8", post_opt="post_opt_0.2",
                         output_path=out)


def test_cli_loads_knnsvc_pkl_and_converts_on_cpu(pair, tmp_path):
    """`.knnsvc.pkl` files written by the JAX package (a {'cfg', 'model'}
    WavLM payload and a {'generator': ...} HiFi-GAN payload) drive the
    port's CLI end to end with --device cpu."""
    _, (src, ref) = pair
    wavlm_cfg = {**SMALL_WAVLM, "encoder_layers": 6}   # layer 6 is the served one
    cfg, jcfg, wavlm_params = small_wavlm(overrides={"encoder_layers": 6})
    _, _, _, _, gen_params = small_generator("mix")
    save_params(str(tmp_path / "WavLM-small.knnsvc.pkl"), {"cfg": wavlm_cfg, "model": wavlm_params})
    save_params(str(tmp_path / "g_00000001_mix.knnsvc.pkl"), {"generator": gen_params})
    (tmp_path / "config.json").write_text(json.dumps(
        {k: list(v) if isinstance(v, tuple) else v for k, v in SMALL_HIFIGAN.items()}))
    out = tmp_path / "cli.wav"
    assert main([src, ref, "--ckpt_dir", str(tmp_path), "--ckpt_type", "mix",
                 "--wavlm_ckpt", str(tmp_path / "WavLM-small.knnsvc.pkl"),
                 "--config", str(tmp_path / "config.json"), "--fast", "true",
                 "--device", "cpu", "--out", str(out)]) == 0
    codes = int16_codes(out)
    assert codes.shape == (50 * 320,) and np.abs(codes).max() > 0

    knn = KnnSvc.load(str(tmp_path), "mix", str(tmp_path / "WavLM-small.knnsvc.pkl"),
                      str(tmp_path / "config.json"), device="cpu")
    assert knn.wavlm_cfg == cfg and len(knn.wavlm.encoder.layers) == 6
    np.testing.assert_array_equal(knn.wavlm.encoder.layers[5].fc1.weight.detach().numpy(),
                                  wavlm_params["encoder"]["layers"]["fc1"]["w"][5].T)
    np.testing.assert_array_equal(knn.vocoder.dec.conv_post.weight.detach().numpy(),
                                  gen_params["dec"]["conv_post"]["w"])


def test_cuda_default_raises_without_a_card(monkeypatch, pair):
    """Entry points default to device='cuda' and never fall back to the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        KnnSvc.random_init()
    _, (src, ref) = pair
    with pytest.raises(RuntimeError, match="no CUDA device"):
        main([src, ref, "--random_init", "true", "--fast", "true"])


def _imported_roots(path: pathlib.Path) -> set[str]:
    roots = set()
    for node in ast.walk(ast.parse(path.read_text(), filename=str(path))):
        if isinstance(node, ast.Import):
            roots.update(alias.name.split(".")[0] for alias in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            roots.add(node.module.split(".")[0])
    return roots


def test_port_imports_neither_jax_nor_the_jax_package():
    files = sorted((REPO / "knnsvc_torch").rglob("*.py")) + [REPO / "chip_smoke.py"]
    assert len(files) > 20
    names = {str(p.relative_to(REPO)) for p in files}
    assert {"knnsvc_torch/io/vad.py", "knnsvc_torch/match/quantized_pool.py",
            "knnsvc_torch/match/pipeline.py", "knnsvc_torch/match/pool.py",
            "knnsvc_torch/hub.py", "knnsvc_torch/cli/inference.py",
            "knnsvc_torch/models/wavlm/streaming.py", "knnsvc_torch/ops/concat_scan.py",
            "knnsvc_torch/match/concat_cost.py"} <= names
    for path in files:
        bad = _imported_roots(path) & {"jax", "jaxlib", "knnsvc_tpu"}
        assert not bad, f"{path.relative_to(REPO)} imports {sorted(bad)}"
