"""The port's bulk loops and folder-mode CLI against the JAX package on the
CPU, small configs, the same parameters and the same f0 sidecars (so both
packages skip the extractors):

- bulk_convert's three loops — the host loop (with required_subset_file,
  duration_limit, then resume), the fast loop (with duration_limit), and
  the fast loop with data_batch=3 — the same files written, waveforms
  within 2e-4 plus one int16 step where the fast loops quantize on the
  device;
- the CLI's folder mode (the JAX CLI's output tree), `--fast false` pair
  mode, and its argument guards."""

import os
import shutil

import jax
import numpy as np
import pytest

from knnsvc_tpu.hub import KnnSvc as JaxKnnSvc
from knnsvc_torch.cli import inference as cli
from knnsvc_torch.dsp.f0 import save_f0_sidecar
from knnsvc_torch.hub import KnnSvc
from knnsvc_torch.io.audio import load_audio, save_audio
from knnsvc_torch.match.pipeline import subset_key
from knnsvc_torch.utils.layer_weights import generate_matrix_from_index

from test_torch_common import SR, _vibrato_f0, small_generator, small_wavlm, vibrato_wav

WAV_ATOL = 2e-4
INT16_STEP = 1.0 / 32768


def _models(ckpt_type):
    cfg, jcfg, params = small_wavlm()
    h, jh, _, _, gen = small_generator(ckpt_type)
    w = generate_matrix_from_index(2, size=cfg.encoder_layers + 1)
    jknn = JaxKnnSvc(jax.tree.map(np.asarray, params), jcfg, gen, jh, ckpt_type)
    knn = KnnSvc(params, cfg, gen, h, ckpt_type, device="cpu")
    jknn.weighting = knn.weighting = w
    return knn, jknn


@pytest.fixture(scope="module")
def mix_models():
    return _models("mix")


@pytest.fixture(scope="module")
def dataset(tmp_path_factory):
    """A dataset root of two singers, two utterances each (1.0 and 1.3 s),
    with f0 sidecars, and an `f0_cache` folder that bulk mode skips."""
    root = tmp_path_factory.mktemp("bulk") / "data"
    for s, (spk, hz) in enumerate((("alto", 200), ("tenor", 150))):
        (root / spk).mkdir(parents=True)
        for u, seconds in enumerate((1.0, 1.3)):
            seed = 40 + 10 * s + u
            path = root / spk / f"{spk}_{u}.wav"
            wav = vibrato_wav(seconds, hz * (1 + 0.1 * u), seed)
            save_audio(path, wav, SR)
            save_f0_sidecar(str(path), _vibrato_f0(len(wav) // 320 + 1, hz * (1 + 0.1 * u), seed))
    (root / "f0_cache").mkdir()
    return root


def _tree(out_dir):
    return sorted(os.path.relpath(p, out_dir) for p in
                  (os.path.join(d, f) for d, _, fs in os.walk(out_dir) for f in fs))


def _assert_same_outputs(got_dir, want_dir, atol):
    names = _tree(want_dir)
    assert names and _tree(got_dir) == names
    for name in names:
        got, sr = load_audio(os.path.join(got_dir, name))
        want, _ = load_audio(os.path.join(want_dir, name))
        assert sr == SR and got.shape == want.shape and np.isfinite(got).all()
        assert np.abs(want).max() > 1e-2
        np.testing.assert_allclose(got, want, atol=atol, rtol=0)


def test_bulk_convert_host_loop_matches_jax(dataset, mix_models, tmp_path):
    """required_subset_file and duration_limit, then resume fills in the rest."""
    knn, jknn = mix_models
    csv_path = tmp_path / "subset.csv"
    keys = [subset_key("alto_0.wav", str(dataset / "tenor")),
            subset_key("tenor_1.wav", str(dataset / "alto"))]
    csv_path.write_text("a,b,key,split\n" + "".join(f"x,y,{k},0\n" for k in keys)
                        + f"x,y,{subset_key('alto_1.wav', str(dataset / 'tenor'))},1\n")
    runs = {}
    for name, model in (("jax", jknn), ("torch", knn)):
        out = tmp_path / name
        first = model.bulk_convert(str(dataset), str(dataset), str(out),
                                   required_subset_file=str(csv_path), duration_limit=1.0)
        assert len(first) == 2
        rest = model.bulk_convert(str(dataset), str(dataset), str(out), duration_limit=1.0,
                                  resume=True)
        assert len(rest) == 2 and not set(rest) & set(first)
        assert model.bulk_convert(str(dataset), str(dataset), str(out), duration_limit=1.0,
                                  resume=True) == []
        runs[name] = out
    assert _tree(runs["torch"]) == ["alto/alto_0/tenor.wav", "alto/alto_1/tenor.wav",
                                    "tenor/tenor_0/alto.wav", "tenor/tenor_1/alto.wav"]
    _assert_same_outputs(runs["torch"], runs["jax"], WAV_ATOL)


@pytest.mark.parametrize("data_batch,duration_limit", [(None, 1.0), (3, None)],
                         ids=["fast-duration_limit", "fast-batch3"])
def test_bulk_convert_fast_loops_match_jax(dataset, mix_models, tmp_path, data_batch,
                                           duration_limit):
    """The device-resident loops: bucket-padded queries and vocoding, int16
    downloads; duration_limit cuts each target pool at limit * 50 frames;
    with data_batch=3 the batched match and vocoder call, each target's
    batch of 2 jobs filled with a repeat that is computed and dropped."""
    knn, jknn = mix_models
    for name, model in (("jax", jknn), ("torch", knn)):
        written = model.bulk_convert(str(dataset), str(dataset), str(tmp_path / name),
                                     fast=True, data_batch=data_batch,
                                     duration_limit=duration_limit)
        assert len(written) == 4
    _assert_same_outputs(tmp_path / "torch", tmp_path / "jax", WAV_ATOL + INT16_STEP)


def test_cli_folder_and_host_pair_modes(dataset, mix_models, tmp_path, monkeypatch):
    """Folder mode names its output tree as the JAX CLI does (next to the
    target root, `duration_limit_N_` prefix); --fast false pair mode writes
    the host-pool path's WAV."""
    knn, _ = mix_models
    monkeypatch.setattr(KnnSvc, "random_init", classmethod(lambda cls, *a, **k: knn))
    out = tmp_path / "pair.wav"
    src = dataset / "alto" / "alto_0.wav"
    assert cli.main([str(src), str(dataset / "tenor" / "tenor_1.wav"), "--random_init", "true",
                     "--fast", "false", "--out", str(out)]) == 0
    y, sr = load_audio(out)
    assert sr == SR and y.shape[-1] == 50 * 320 and np.abs(y).max() > 1e-2

    assert cli.main([str(dataset), str(dataset), "--random_init", "true", "--fast", "true",
                     "--dur_limit", "2"]) == 0
    expect = dataset.parent / f"duration_limit_2_{dataset.name}_to_{dataset.name}_mix_post_opt_no_post_opt"
    assert _tree(expect) == ["alto/alto_0/tenor.wav", "alto/alto_1/tenor.wav",
                             "tenor/tenor_0/alto.wav", "tenor/tenor_1/alto.wav"]
    assert cli.main([str(dataset), str(dataset), "--random_init", "true", "--resume", "true",
                     "--matcher", "int8"]) == 0
    assert len(_tree(dataset.parent / f"{dataset.name}_to_{dataset.name}_mix_post_opt_no_post_opt")) == 4


# the JAX CLI's own streaming rejections: int8 does not stream, and folder
# mode converts whole utterances
@pytest.mark.parametrize("mode,flags,match", [
    ("pair", ["--stream_chunk_s", "2.0", "--matcher", "int8"], "matcher"),
    ("folder", ["--stream_chunk_s", "2.0", "--fast", "true"], "pair"),
])
def test_cli_rejects_flags_the_path_ignores(dataset, mode, flags, match):
    src = str(dataset / "alto" / "alto_0.wav")
    inputs = [src, src] if mode == "pair" else [str(dataset), str(dataset)]
    with pytest.raises(SystemExit, match=match):
        cli.main([*inputs, "--random_init", "true", "--device", "cpu", *flags])
    with pytest.raises(SystemExit, match="files or both must be folders"):
        cli.main([src, str(dataset), "--fast", "true"])


@pytest.mark.parametrize("mode,base,flag,warning", [
    ("pair", ["--fast", "false"], ["--f0_method", "device"],
     "--f0_method device is ignored by the host-pool path"),
    ("pair", ["--fast", "false"], ["--upload_depth", "int16"],
     "--upload_depth int16 is ignored by the host-pool path"),
    ("folder", ["--fast", "true"], ["--upload_depth", "int16"],
     "--upload_depth int16 is ignored by folder mode"),
    ("pair", ["--fast", "false"], ["--stream_context_s", "2.0"],
     "--stream_context_s is ignored by every path but streaming"),
])
def test_cli_warns_of_flags_the_path_ignores(dataset, mix_models, tmp_path, monkeypatch, capsys,
                                             mode, base, flag, warning):
    """A flag that the chosen path ignores converts as the JAX CLI does: exit
    0, one warning line on stderr, and the output bytes of the same command
    line without the flag."""
    knn, _ = mix_models
    monkeypatch.setattr(KnnSvc, "random_init", classmethod(lambda cls, *a, **k: knn))
    root = tmp_path / "data"
    shutil.copytree(dataset, root)
    out_tree = tmp_path / "data_to_data_mix_post_opt_no_post_opt"

    def run(flags, out):
        if mode == "pair":
            src, tgt = root / "alto" / "alto_0.wav", root / "tenor" / "tenor_1.wav"
            argv = [str(src), str(tgt), "--out", str(out)]
        else:
            argv = [str(root), str(root)]
        capsys.readouterr()
        assert cli.main([*argv, "--random_init", "true", "--device", "cpu", *base, *flags]) == 0
        err = capsys.readouterr().err
        if mode == "pair":
            return {"out.wav": out.read_bytes()}, err
        files = {name: (out_tree / name).read_bytes() for name in _tree(out_tree)}
        shutil.rmtree(out_tree)
        return files, err

    want, err = run([], tmp_path / "plain.wav")
    assert "warning" not in err
    got, err = run(flag, tmp_path / "flagged.wav")
    warned = [ln for ln in err.splitlines() if "warning" in ln]
    assert len(warned) == 1 and warned[0].startswith(f"warning: {warning}")
    assert want and got == want
