"""knnsvc_torch's entry points and guards on the CPU: the CLI driven end to
end from `.knnsvc.pkl` files (and with --precision high), no silent CPU
fallback, the multi-device matchers give the dense matchers' waveforms, an
`.mp3` output path writes an mp3, a directory holding only an orbax
checkpoint serves, no file of the port imports JAX, the JAX package, orbax
or tensorstore, every module of the JAX package has a counterpart, and each
subpackage exports the JAX package's names."""

import ast
import json
import pathlib

import numpy as np
import pytest
import torch

from knnsvc_tpu.io.checkpoints import save_params
from knnsvc_torch.cli.inference import main
from knnsvc_torch.hub import KnnSvc
from knnsvc_torch.io.audio import load_audio
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
    # an .mp3 output path: libmp3lame's CBR file (160 kbit/s at 16 kHz), which
    # decodes back near the WAV output, at tests/test_io_audio.py's 15 dB, in
    # the band that LAME keeps at this rate (its low-pass is at ~7.2 kHz; this
    # random-weight output holds 4% of its energy above 7 kHz)
    wav = load_audio(knn.convert_pair(src, ref, fast=True, output_path=str(root / "out.wav")))[0][0]
    decoded, sr = load_audio(knn.convert_pair(src, ref, fast=True,
                                              output_path=str(root / "out.mp3")))
    assert sr == 16000 and decoded.shape[0] == 1
    lag = int(np.argmax(np.correlate(decoded[0][:len(wav) // 2 + 2000], wav[:len(wav) // 2],
                                     "valid")))
    n = min(len(wav), len(decoded[0]) - lag)
    assert lag == 576 + 529 and n == len(wav)  # LAME's encoder delay, the decoder's
    want, got = np.fft.rfft(wav[:n]), np.fft.rfft(decoded[0][lag:lag + n])
    band = np.fft.rfftfreq(n, 1 / 16000) < 7000
    snr = 10 * np.log10(np.sum(np.abs(want[band]) ** 2) / np.sum(np.abs(got - want)[band] ** 2))
    assert snr > 15.0, f"mp3 output SNR {snr:.1f} dB below 7 kHz"
    # a directory holding only orbax/ (a training run's TrainState) serves
    # its generator: the same waveform as the model built from the same trees
    from knnsvc_torch.io.checkpoints import save_params as port_save_params
    from knnsvc_torch.io.orbax_ckpt import save_train_state

    orbax = root / "orbax_only"
    save_train_state(str(orbax / "orbax"), 7, {"g_params": gen_params, "steps": np.int32(7)})
    port_save_params(str(root / "wavlm_small.knnsvc.pkl"), {"cfg": SMALL_WAVLM,
                                                            "model": wavlm_params})
    (root / "small_config.json").write_text(json.dumps(SMALL_HIFIGAN))
    served = KnnSvc.load(str(orbax), "mix", wavlm_ckpt=str(root / "wavlm_small.knnsvc.pkl"),
                         config_path=str(root / "small_config.json"), device="cpu")
    served.weighting = knn.weighting
    np.testing.assert_array_equal(
        int16_codes(served.convert_pair(src, ref, fast=True, output_path=str(root / "ob.wav"))),
        pair(True, "exact", "exact_orbax_twin.wav"))
    with pytest.raises(ValueError, match="no_post_opt"):
        knn.convert_pair(src, ref, fast=True, matcher="sharded_int8", post_opt="post_opt_0.2",
                         output_path=out)


def _write_checkpoints(root):
    """JAX-written `.knnsvc.pkl` files of the small models under `root`:
    -> (WavLM cfg, WavLM params, generator params, the CLI's model flags)."""
    wavlm_cfg = {**SMALL_WAVLM, "encoder_layers": 6}   # layer 6 is the served one
    cfg, jcfg, wavlm_params = small_wavlm(overrides={"encoder_layers": 6})
    _, _, _, _, gen_params = small_generator("mix")
    save_params(str(root / "WavLM-small.knnsvc.pkl"), {"cfg": wavlm_cfg, "model": wavlm_params})
    save_params(str(root / "g_00000001_mix.knnsvc.pkl"), {"generator": gen_params})
    (root / "config.json").write_text(json.dumps(
        {k: list(v) if isinstance(v, tuple) else v for k, v in SMALL_HIFIGAN.items()}))
    flags = ["--ckpt_dir", str(root), "--ckpt_type", "mix",
             "--wavlm_ckpt", str(root / "WavLM-small.knnsvc.pkl"),
             "--config", str(root / "config.json")]
    return cfg, wavlm_params, gen_params, flags


def test_cli_loads_knnsvc_pkl_and_converts_on_cpu(pair, tmp_path):
    """`.knnsvc.pkl` files written by the JAX package (a {'cfg', 'model'}
    WavLM payload and a {'generator': ...} HiFi-GAN payload) drive the
    port's CLI end to end with --device cpu."""
    _, (src, ref) = pair
    cfg, wavlm_params, gen_params, flags = _write_checkpoints(tmp_path)
    out = tmp_path / "cli.wav"
    assert main([src, ref, *flags, "--fast", "true", "--device", "cpu", "--out", str(out)]) == 0
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


def test_cli_and_policy_take_the_jax_precision_names(pair, tmp_path):
    """--precision high converts and leaves the policy at "high", as the
    JAX CLI's choices allow; "default" is "fastest", as in the JAX
    package's precision names."""
    from knnsvc_torch.precision import get_precision, set_precision

    _, (src, ref) = pair
    *_, flags = _write_checkpoints(tmp_path)
    out = tmp_path / "high.wav"
    try:
        assert main([src, ref, *flags, "--fast", "true", "--device", "cpu",
                     "--precision", "high", "--out", str(out)]) == 0
        assert get_precision() == "high" and int16_codes(out).shape == (50 * 320,)
        set_precision("default")
        assert get_precision() == "fastest"
        assert torch.backends.cuda.matmul.allow_tf32
        with pytest.raises(ValueError, match="precision must be one of"):
            set_precision("bf16")
    finally:
        set_precision("highest")
    assert torch.backends.cuda.matmul.allow_tf32 is False


def test_new_entry_points_default_to_cuda(monkeypatch, tmp_path):
    """initialize_distributed, the regression metrics, speaker similarity's
    embedder, the Whisper transcriber and train()'s default mesh run on
    device='cuda' unless told otherwise, and raise without a card."""
    from knnsvc_torch.config import HiFiGANConfig
    from knnsvc_torch.eval.intelligibility import default_whisper_transcriber
    from knnsvc_torch.eval.regression import spectral_distance
    from knnsvc_torch.eval.speaker_sim import compute_speaker_similarity, mfcc_stats_embedder
    from knnsvc_torch.io.audio import save_audio
    from knnsvc_torch.parallel.mesh import initialize_distributed, make_mesh
    from knnsvc_torch.train.loop import train

    from test_torch_common import TINY_H

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    wav = np.zeros(3200, np.float32)
    save_audio(tmp_path / "a.wav", wav, 16000)
    (tmp_path / "pairs.csv").write_text("src_speaker,tgt_speaker,x_path,y_path,label\n"
                                        "s,t,a,a,0\ns,t,a,a,1\n")
    calls = [
        lambda: initialize_distributed(),
        lambda: initialize_distributed("127.0.0.1:29500", 2, 0),
        lambda: spectral_distance(str(tmp_path / "a.wav"), str(tmp_path / "a.wav")),
        lambda: mfcc_stats_embedder(wav),
        lambda: compute_speaker_similarity(str(tmp_path / "pairs.csv"), str(tmp_path),
                                           str(tmp_path), result_dir=str(tmp_path)),
        lambda: default_whisper_transcriber(str(tmp_path)),
        lambda: train(HiFiGANConfig.from_dict(TINY_H), str(tmp_path), str(tmp_path),
                      str(tmp_path), str(tmp_path), str(tmp_path / "ckpt")),
        lambda: make_mesh(),
    ]
    for call in calls:
        with pytest.raises(RuntimeError, match="no CUDA device"):
            call()
    assert not torch.distributed.is_initialized()


def _imported_roots(path: pathlib.Path) -> set[str]:
    roots = set()
    for node in ast.walk(ast.parse(path.read_text(), filename=str(path))):
        if isinstance(node, ast.Import):
            roots.update(alias.name.split(".")[0] for alias in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            roots.add(node.module.split(".")[0])
    return roots


def test_port_imports_neither_jax_nor_the_jax_package():
    files = sorted((REPO / "knnsvc_torch").rglob("*.py")) + [REPO / "chip_smoke.py",
                                                             REPO / "tests" / "torch_dp_worker.py"]
    assert len(files) > 20
    names = {str(p.relative_to(REPO)) for p in files}
    assert {"knnsvc_torch/io/vad.py", "knnsvc_torch/match/quantized_pool.py",
            "knnsvc_torch/match/pipeline.py", "knnsvc_torch/match/pool.py",
            "knnsvc_torch/hub.py", "knnsvc_torch/cli/inference.py",
            "knnsvc_torch/models/wavlm/streaming.py", "knnsvc_torch/ops/concat_scan.py",
            "knnsvc_torch/match/concat_cost.py", "knnsvc_torch/eval/speaker_sim.py",
            "knnsvc_torch/eval/regression.py", "knnsvc_torch/eval/intelligibility.py",
            "knnsvc_torch/utils/profiling.py", "knnsvc_torch/utils/flops.py",
            "knnsvc_torch/train/spectral_losses.py", "knnsvc_torch/models/hifigan/harm_head.py",
            "knnsvc_torch/models/wavlm/masking.py", "knnsvc_torch/parallel/mesh.py",
            "knnsvc_torch/train/legacy_audio_dataset.py", "tests/torch_dp_worker.py",
            "knnsvc_torch/io/orbax_ckpt.py", "knnsvc_torch/io/ocdbt.py",
            "knnsvc_torch/io/zarr2.py"} <= names
    for path in files:
        bad = _imported_roots(path) & {"jax", "jaxlib", "knnsvc_tpu", "orbax", "tensorstore"}
        assert not bad, f"{path.relative_to(REPO)} imports {sorted(bad)}"


def test_every_jax_module_has_a_counterpart():
    """Every module of the JAX package has a counterpart in the port, orbax
    checkpoints too (io/orbax_ckpt.py, which reads and writes their format
    without orbax)."""
    def modules(pkg):
        return {str(p.relative_to(REPO / pkg)) for p in (REPO / pkg).rglob("*.py")}

    assert modules("knnsvc_tpu") - modules("knnsvc_torch") == set()


SUBPACKAGES = ["", "ops", "models", "models.wavlm", "models.hifigan", "match", "io", "utils",
               "dsp", "parallel", "eval", "train", "cli"]


def _public(module) -> set[str]:
    """__all__, or the names a package binds itself (not submodules)."""
    import types

    if hasattr(module, "__all__"):
        return set(module.__all__)
    return {n for n, v in vars(module).items()
            if not n.startswith("_") and not isinstance(v, types.ModuleType)
            and n not in ("annotations",)}


@pytest.mark.parametrize("sub", SUBPACKAGES)
def test_subpackage_exports_the_jax_names(sub):
    """Each subpackage exports what its JAX counterpart exports, every name
    bound; parallel adds Mesh, the port's grid of devices (JAX imports its
    own from jax.sharding)."""
    import importlib

    jax_mod = importlib.import_module("knnsvc_tpu" + ("." + sub if sub else ""))
    mod = importlib.import_module("knnsvc_torch" + ("." + sub if sub else ""))
    extra = {"Mesh"} if sub == "parallel" else set()
    assert _public(mod) == _public(jax_mod) | extra
    for name in _public(mod):
        assert getattr(mod, name) is not None, name
