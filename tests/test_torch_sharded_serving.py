"""The multi-device matchers through the port's bulk, host-pool, streaming
and CLI entry points on the CPU:

- bulk_convert(fast=True, matcher='sharded_int8') against the JAX package,
  serial on the default pool mesh and batched (data_batch=2) on a 2 x 2
  (data, pool) mesh, and the dense batched loop on a (2, 1) data mesh: the
  same files, waveforms within 2e-4 plus one int16 step (as
  tests/test_torch_bulk.py), and the data_batch check;
- match_at_inference_time with matcher='sharded' and post_opt makes no
  dense copy of the target pool (JAX tests/test_pipeline.py:341);
- a single-chunk 'sharded_int8' stream is the fast pair bit for bit (JAX
  tests/test_streaming.py:270), and the CLI's --matcher sharded_int8
  stream writes stream_convert's file."""

import os

import jax
import numpy as np
import pytest
import torch

from knnsvc_tpu.hub import KnnSvc as JaxKnnSvc
from knnsvc_tpu.parallel.mesh import make_mesh as jax_make_mesh
from knnsvc_torch.cli import inference as cli
from knnsvc_torch.dsp.f0 import save_f0_sidecar
from knnsvc_torch.hub import KnnSvc
from knnsvc_torch.io.audio import load_audio, save_audio
from knnsvc_torch.match.pipeline import match_at_inference_time
from knnsvc_torch.match.pool import build_speaker_pool
from knnsvc_torch.parallel import make_mesh
from knnsvc_torch.parallel.sharded_match import ShardedPool
from knnsvc_torch.utils.layer_weights import generate_matrix_from_index

from test_torch_common import (SR, _vibrato_f0, int16_codes, small_generator, small_wavlm,
                               vibrato_wav, write_pair, write_vibrato_pair)

WAV_ATOL = 2e-4
INT16_STEP = 1.0 / 32768
CPU8 = [torch.device("cpu")] * 8


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    """The small mix models of both packages, a pair with f0 sidecars, one
    without (a stream window has no sidecar, so the pair it is held to
    extracts f0 too) and a dataset root of two singers with two utterances
    each."""
    root = tmp_path_factory.mktemp("torch_sharded_serving")
    cfg, jcfg, params = small_wavlm()
    h, jh, _, _, gen = small_generator("mix")
    w = generate_matrix_from_index(2, size=cfg.encoder_layers + 1)
    jknn = JaxKnnSvc(jax.tree.map(np.asarray, params), jcfg, gen, jh, "mix")
    knn = KnnSvc(params, cfg, gen, h, "mix", device="cpu")
    jknn.weighting = knn.weighting = w
    data = root / "data"
    for s, (spk, hz) in enumerate((("alto", 200), ("tenor", 150))):
        (data / spk).mkdir(parents=True)
        for u, seconds in enumerate((1.0, 1.3)):
            seed = 40 + 10 * s + u
            path = data / spk / f"{spk}_{u}.wav"
            wav = vibrato_wav(seconds, hz * (1 + 0.1 * u), seed)
            save_audio(path, wav, SR)
            save_f0_sidecar(str(path), _vibrato_f0(len(wav) // 320 + 1, hz * (1 + 0.1 * u), seed))
    return root, knn, jknn, write_pair(root), data, write_vibrato_pair(root)


def _tree(out_dir):
    return sorted(os.path.relpath(os.path.join(d, f), out_dir)
                  for d, _, fs in os.walk(out_dir) for f in fs)


def _assert_same_outputs(got_dir, want_dir):
    names = _tree(want_dir)
    assert len(names) == 4 and _tree(got_dir) == names
    for name in names:
        got, sr = load_audio(os.path.join(got_dir, name))
        want, _ = load_audio(os.path.join(want_dir, name))
        assert sr == SR and got.shape == want.shape and np.abs(want).max() > 1e-2
        np.testing.assert_allclose(got, want, atol=WAV_ATOL + INT16_STEP, rtol=0)


@pytest.mark.parametrize("matcher,grid,data_batch", [
    ("sharded_int8", None, None),       # the serial fast loop on the default pool mesh
    ("sharded_int8", (2, 2), 2),        # batch over 'data' composed with the pool over 'pool'
    ("exact", (2, 1), None),            # the dense batched loop on a data mesh
], ids=["int8-serial", "int8-2x2-batch2", "exact-data-mesh"])
def test_bulk_convert_fast_matches_jax(world, tmp_path, matcher, grid, data_batch):
    _, knn, jknn, _, data, _ = world
    mesh = jmesh = None
    if grid is not None:
        mesh, jmesh = make_mesh(*grid, devices=CPU8), jax_make_mesh(*grid)
    kw = dict(fast=True, matcher=matcher, data_batch=data_batch)
    assert len(jknn.bulk_convert(str(data), str(data), str(tmp_path / "jax"), mesh=jmesh,
                                 **kw)) == 4
    assert len(knn.bulk_convert(str(data), str(data), str(tmp_path / "torch"), mesh=mesh,
                                **kw)) == 4
    _assert_same_outputs(tmp_path / "torch", tmp_path / "jax")
    if grid is not None:
        with pytest.raises(ValueError, match="multiple of the mesh 'data' axis"):
            knn.bulk_convert(str(data), str(data), str(tmp_path / "bad"), fast=True,
                             matcher=matcher, mesh=mesh, data_batch=3)
        assert not (tmp_path / "bad").exists() or _tree(tmp_path / "bad") == []


def test_sharded_host_match_makes_no_dense_pool(world):
    """matcher='sharded' with post_opt on: every pool-frame array lives at
    P_pad / n_pool rows per shard, and no dense copy is made."""
    root, knn, _, (src, ref), _, _ = world
    ref_pool = build_speaker_pool(ref, knn.wavlm, knn.weighting, knn.weighting)
    mesh = make_mesh(1, 8, devices=CPU8)
    got = match_at_inference_time(src, ref, knn.wavlm, knn.weighting, knn.weighting,
                                  ckpt_type="mix", post_opt="post_opt_0.2", ref_pool=ref_pool,
                                  matcher="sharded", mesh=mesh)
    prep = ref_pool.__dict__["_device_prep"]
    assert "matching" not in prep and "synth" not in prep and "harmonics" not in prep
    sp = prep["sharded"]
    assert isinstance(sp, ShardedPool) and sp.mesh is mesh and prep["sharded_mesh"] is mesh
    P = len(ref_pool.f0)
    assert sp.true_len == P and sp.f0.shape == (P,)           # f0: the one unpadded track
    for grid in (sp.matching, sp.synth, sp.harmonics):
        assert all(s.shape[0] == -(-P // 8) for s in grid[0])
    # the same mesh object reuses the shards
    match_at_inference_time(src, ref, knn.wavlm, knn.weighting, knn.weighting,
                            ckpt_type="mix", ref_pool=ref_pool, matcher="sharded", mesh=mesh)
    assert prep["sharded"] is sp
    (feats,) = got.values()
    assert feats.out_feats_weighted.shape[1] == sp.synth[0][0].shape[1]


def test_single_chunk_sharded_int8_stream_is_the_fast_pair(world):
    root, knn, _, _, _, (src, ref) = world
    want = int16_codes(knn.convert_pair(src, ref, fast=True, matcher="sharded_int8",
                                        output_path=str(root / "pair_q8.wav")))
    chunks = list(knn.stream_convert_chunks(src, ref, chunk_s=2.0, context_s=0.5,
                                            matcher="sharded_int8"))
    assert len(chunks) == 1
    got = np.round(chunks[0].astype(np.float64) * 32768).astype(np.int64)
    np.testing.assert_array_equal(got, want)


def test_cli_sharded_int8_stream(world, monkeypatch):
    root, knn, _, _, _, (src, ref) = world
    monkeypatch.setattr(KnnSvc, "random_init", classmethod(lambda cls, *a, **k: knn))
    want = knn.stream_convert(src, ref, output_path=str(root / "api_q8.wav"), chunk_s=0.4,
                              context_s=0.25, matcher="sharded_int8")
    out = root / "cli_q8.wav"
    assert cli.main([src, ref, "--random_init", "true", "--device", "cpu", "--out", str(out),
                     "--stream_chunk_s", "0.4", "--stream_context_s", "0.25",
                     "--matcher", "sharded_int8"]) == 0
    np.testing.assert_array_equal(int16_codes(out), int16_codes(want))
    with pytest.raises(SystemExit, match="sharded_int8 streams no_post_opt"):
        cli.main([src, ref, "--random_init", "true", "--device", "cpu",
                  "--stream_chunk_s", "0.4", "--matcher", "sharded_int8",
                  "--post_opt", "no_post_opt_0.2"])
