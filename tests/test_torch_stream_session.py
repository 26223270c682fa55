"""knnsvc_torch's streaming entry points on the CPU, the port alone: a
single-chunk stream is the fast pair path bit for bit; zero context still
gives complete audio; a StreamSession fed uneven pieces and flushed gives
the file stream's audio bit for bit (windowed and cached, with the
concat-cost carry); the CLI's --stream_chunk_s writes stream_convert's
file; and the checks (cached encoder without a one-hot weighting, the
matchers; the multi-device ones stream each window alone, as the dense
matchers without a concat carry do)."""

import numpy as np
import pytest

from knnsvc_torch.cli import inference as cli
from knnsvc_torch.hub import KnnSvc
from knnsvc_torch.io.audio import load_audio
from knnsvc_torch.match.pool import load_utterance
from knnsvc_torch.utils.layer_weights import generate_matrix_from_index

from test_torch_common import int16_codes, small_generator, small_wavlm, write_vibrato_pair


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    root = tmp_path_factory.mktemp("torch_stream_session")
    cfg, _, wavlm_params = small_wavlm()
    h, _, _, _, gen_params = small_generator("mix")
    knn = KnnSvc(wavlm_params, cfg, gen_params, h, "mix", device="cpu")
    knn.weighting = generate_matrix_from_index(2, size=cfg.encoder_layers + 1)
    return root, knn, write_vibrato_pair(root)


@pytest.mark.parametrize("post_opt", ["no_post_opt", "no_post_opt_0.2"])
def test_single_chunk_stream_is_the_fast_pair(world, post_opt):
    """One chunk covering the utterance: the same encode, register shift,
    concat-cost picks and int16 quantize as convert_pair(fast=True)."""
    root, knn, (src, ref) = world
    want = int16_codes(knn.convert_pair(src, ref, fast=True, post_opt=post_opt,
                                        output_path=str(root / f"pair_{post_opt}.wav")))
    chunks = list(knn.stream_convert_chunks(src, ref, chunk_s=2.0, context_s=0.5,
                                            matcher="exact", post_opt=post_opt))
    assert len(chunks) == 1
    got = np.round(chunks[0].astype(np.float64) * 32768).astype(np.int64)
    np.testing.assert_array_equal(got, want)


def test_zero_context_gives_complete_audio(world):
    """context_s=0 on a multi-chunk input is clamped to one hop, and the end
    of the input comes from the sample position, so no chunk is cut short."""
    _, knn, (src, ref) = world
    chunks = list(knn.stream_convert_chunks(src, ref, chunk_s=0.25, context_s=0.0))
    assert len(chunks) >= 3
    n_src = len(load_utterance(src))
    assert abs(sum(len(c) for c in chunks) - n_src) <= 2 * 320
    assert all(np.isfinite(c).all() for c in chunks)


@pytest.mark.parametrize("kw", [
    dict(chunk_s=0.3, context_s=0.2, post_opt="no_post_opt_0.2"),
    dict(chunk_s=0.3, context_s=0.2, right_context_s=0.1, encoder="cached",
         post_opt="no_post_opt_0.2"),
    dict(chunk_s=0.25, context_s=0.3, encoder="cached"),
])
def test_session_equals_file_stream(world, kw):
    """Uneven pushes and a flush give the file stream's chunks bit for bit:
    a chunk's output does not depend on when its samples arrived."""
    _, knn, (src, ref) = world
    kw = dict(kw, matcher="exact")
    wav = load_utterance(src)
    want = np.concatenate(list(knn.stream_convert_chunks(src, ref, **kw)))
    sess = knn.stream_session(ref, **kw)
    rng = np.random.default_rng(11)
    outs, i = [], 0
    while i < len(wav):
        n = int(rng.integers(100, 4000))
        outs.append(sess.push(wav[i:i + n]))
        assert outs[-1].dtype == np.float32
        i += n
    assert sum(len(o) for o in outs) > 0          # mid-stream chunks came out while pushing
    assert len(sess._buf) < len(wav)              # consumed history was dropped
    outs.append(sess.flush())
    np.testing.assert_array_equal(np.concatenate(outs), want)
    assert sess.pending_s == 0.0
    with pytest.raises(RuntimeError, match="flushed"):
        sess.push(wav[:100])


def test_stream_checks(world):
    _, knn, (src, ref) = world
    kw = dict(chunk_s=0.25, context_s=0.2)
    want = list(knn.stream_convert_chunks(src, ref, matcher="exact", **kw))
    # the sharded matcher streams the dense one's chunks bit for bit (the
    # target pool on the default CPU pool mesh, no concat carry either way)
    got = list(knn.stream_convert_chunks(src, ref, matcher="sharded", **kw))
    assert len(got) == len(want) >= 3
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b)
    sess = knn.stream_session(ref, matcher="sharded_int8", **kw)
    out = np.concatenate([sess.push(load_utterance(src)), sess.flush()])
    assert abs(len(out) - len(load_utterance(src))) <= 2 * 320 and np.isfinite(out).all()
    with pytest.raises(ValueError, match="no_post_opt"):
        knn.stream_session(ref, matcher="sharded_int8", post_opt="post_opt_0.2")
    with pytest.raises(ValueError, match="matcher"):
        list(knn.stream_convert_chunks(src, ref, matcher="int8"))
    with pytest.raises(ValueError, match="encoder"):
        knn.stream_session(ref, encoder="kv")
    weighting = knn.weighting
    knn.weighting = np.full_like(weighting, 1.0 / weighting.size)
    try:
        with pytest.raises(ValueError, match="one-hot"):
            list(knn.stream_convert_chunks(src, ref, encoder="cached"))
    finally:
        knn.weighting = weighting


def test_cli_stream_writes_stream_convert_file(world, monkeypatch, capsys):
    root, knn, (src, ref) = world
    monkeypatch.setattr(KnnSvc, "random_init", classmethod(lambda cls, *a, **k: knn))
    kw = dict(chunk_s=0.4, context_s=0.25, encoder="cached", post_opt="no_post_opt_0.2",
              matcher="exact")
    want = knn.stream_convert(src, ref, output_path=str(root / "api.wav"), **kw)
    out = root / "cli.wav"
    assert cli.main([src, ref, "--random_init", "true", "--device", "cpu", "--out", str(out),
                     "--stream_chunk_s", "0.4", "--stream_context_s", "0.25",
                     "--stream_encoder", "cached", "--post_opt", "no_post_opt_0.2",
                     "--matcher", "exact"]) == 0
    y, sr = load_audio(out)
    assert sr == 16000 and abs(y.shape[-1] - len(load_utterance(src))) <= 2 * 320
    np.testing.assert_array_equal(int16_codes(out), int16_codes(want))
    # a flag the chosen path ignores: one warning line, and the bytes of the
    # same command line without it (as the JAX CLI converts). The first
    # host-pool run extracts f0 and writes the sidecars that every later run,
    # streamed or not, reads: it runs first, and the pairs compared come after
    base = [src, ref, "--random_init", "true", "--device", "cpu"]
    stream = ["--stream_chunk_s", "0.4", "--stream_context_s", "0.25", "--stream_encoder",
              "cached", "--post_opt", "no_post_opt_0.2", "--matcher", "exact"]
    assert cli.main([*base, "--out", str(root / "sidecars.wav")]) == 0
    for i, (plain, flag, warning) in enumerate((
            ([], ["--stream_encoder", "cached"], "--stream_encoder is ignored"),
            (stream, ["--upload_depth", "int16"], "--upload_depth int16 is ignored by the "
                                                  "streaming"))):
        want_out, flagged = root / f"plain{i}.wav", root / f"flagged{i}.wav"
        assert cli.main([*base, "--out", str(want_out), *plain]) == 0
        capsys.readouterr()
        assert cli.main([*base, "--out", str(flagged), *plain, *flag]) == 0
        warned = [ln for ln in capsys.readouterr().err.splitlines() if "warning" in ln]
        assert len(warned) == 1 and warned[0].startswith(f"warning: {warning}")
        assert flagged.read_bytes() == want_out.read_bytes()
    with pytest.raises(SystemExit, match="sharded_int8 streams no_post_opt"):
        cli.main([src, ref, "--random_init", "true", "--device", "cpu",
                  "--stream_chunk_s", "0.4", "--matcher", "sharded_int8",
                  "--post_opt", "post_opt_0.2"])
