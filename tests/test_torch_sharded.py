"""The port's multi-device matchers (knnsvc_torch/parallel) against the JAX
package on the CPU. JAX runs on the eight virtual CPU devices of
tests/conftest.py; the port on a mesh of eight logical CPU shards
(make_mesh(devices=[cpu] * 8)), the way one card runs logical shards.

- sharded_knn_topk and shard_pool at 8 and 3 pool shards: indices exact
  against JAX's and against the port's dense knn_topk, padding never
  picked, the too-small-pool ValueError with JAX's text;
- shard_speaker_pool's layout: rows per shard, true_len, the f0 track
  unpadded, int8 matching rows with no fp32 copy;
- sharded_match_core (no_post_opt and post_opt_0.2, mix and wavlm_only)
  against JAX's sharded core at the dense port tests' tolerances (1e-6
  without the optimizer, 3e-3 with it: tests/test_torch_smoothness.py),
  and equal to the port's dense core;
- sharded_match_core_int8 against JAX's, both batched cores on a 4 x 2
  mesh against JAX's and against the single-utterance cores;
- the plain concat scan reading a sharded pool's rows against the dense
  plain scan, and the sharded wrapper entries on the CPU."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from knnsvc_tpu.parallel import sharded_match as J
from knnsvc_tpu.parallel.mesh import make_mesh as jax_make_mesh
from knnsvc_tpu.parallel.sharded_knn import shard_pool as jax_shard_pool
from knnsvc_tpu.parallel.sharded_knn import sharded_knn_topk as jax_sharded_knn_topk
from knnsvc_torch.match.concat_cost import knn_with_concat_cost, knn_with_concat_cost_pair
from knnsvc_torch.match.knn import knn_topk
from knnsvc_torch.match.pipeline import match_core, match_core_post_opt
from knnsvc_torch.ops.concat_scan import (concat_cost_pair, concat_cost_pair_sharded,
                                          concat_cost_single, concat_cost_single_sharded)
from knnsvc_torch.parallel import make_mesh, shard_pool, sharded_knn_topk
from knnsvc_torch.parallel.mesh import gather_rows, shard_rows
from knnsvc_torch.parallel.sharded_match import (shard_speaker_pool, sharded_match_core,
                                                 sharded_match_core_batch,
                                                 sharded_match_core_int8,
                                                 sharded_match_core_int8_batch)

CPU = torch.device("cpu")


def _mesh(n_data, n_pool):
    return (make_mesh(n_data, n_pool, devices=[CPU] * 8),
            jax_make_mesh(n_data=n_data, n_pool=n_pool))


def _world(T=45, P=123, D=64, seed=6):
    """Query, pools and f0 tracks as the dense parity tests draw them; P is
    no multiple of 8, so the last shards carry padding."""
    rng = np.random.default_rng(seed)
    q, matching, synth = (rng.standard_normal((n, D)).astype(np.float32) for n in (T, P, P))
    pool_f0 = (150 + 300 * rng.random(P)).astype(np.float32)
    pool_f0[::5] = 0.0
    qf0 = (100 + 200 * rng.random(T)).astype(np.float32)
    qf0[::6] = 0.0
    harm = rng.random((P, 49)).astype(np.float32)
    return q, qf0, matching, synth, harm, pool_f0


# ----------------------------------------------------------- mesh and kNN


def test_make_mesh_grid_and_defaults():
    mesh = make_mesh(4, 2, devices=[CPU] * 8)
    assert mesh.shape == {"data": 4, "pool": 2} and mesh.first == CPU
    assert make_mesh(n_pool=4, devices=[CPU] * 8).shape == {"data": 2, "pool": 4}
    with pytest.raises(ValueError, match="needs 9 devices"):
        make_mesh(3, 3, devices=[CPU] * 8)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            make_mesh()


@pytest.mark.parametrize("n_pool", [8, 3])
def test_sharded_knn_topk_matches_jax_and_dense(n_pool):
    rng = np.random.default_rng(0)
    pool = rng.standard_normal((333, 32)).astype(np.float32)
    query = rng.standard_normal((17, 32)).astype(np.float32)
    query[4] = pool[100] * 3.0                      # a tie that must resolve to the dense order
    pool[101] = pool[100]
    mesh, jmesh = _mesh(1, n_pool)
    shards, true_len = shard_pool(pool, mesh)
    got_i, got_d = sharded_knn_topk(torch.from_numpy(query), shards, true_len, mesh, k=16)
    jshards, jlen = jax_shard_pool(pool, jmesh)
    want_i, want_d = jax_sharded_knn_topk(jnp.asarray(query), jshards, jnp.int32(jlen), jmesh,
                                          k=16)
    np.testing.assert_array_equal(got_i.numpy(), np.asarray(want_i))
    np.testing.assert_allclose(got_d.numpy(), np.asarray(want_d), atol=1e-6)
    dense_i, _ = knn_topk(torch.from_numpy(query), torch.from_numpy(pool), k=16)
    assert torch.equal(got_i, dense_i)
    assert list(got_i[4, :2]) == [100, 101]


def test_sharded_knn_never_picks_padding_and_rejects_small_pools():
    rng = np.random.default_rng(1)
    pool = rng.standard_normal((13, 8)).astype(np.float32)   # 13 % 8 != 0: 3 padded rows
    query = rng.standard_normal((5, 8)).astype(np.float32)
    mesh, jmesh = _mesh(1, 8)
    shards, true_len = shard_pool(pool, mesh)
    assert true_len == 13 and [s.shape[0] for s in shards[0]] == [2] * 8
    assert not shards[0][7].any()                             # the zero padding
    idx, vals = sharded_knn_topk(torch.from_numpy(query), shards, true_len, mesh, k=4)
    assert int(idx.max()) < 13 and torch.isfinite(vals).all()
    jshards, _ = jax_shard_pool(pool, jmesh)
    want, _ = jax_sharded_knn_topk(jnp.asarray(query), jshards, jnp.int32(13), jmesh, k=4)
    np.testing.assert_array_equal(idx.numpy(), np.asarray(want))
    with pytest.raises(ValueError, match=r"8 shards x 2 rows/shard yield 16 candidates < k=32"):
        sharded_knn_topk(torch.from_numpy(query), shards, true_len, mesh, k=32)
    with pytest.raises(ValueError, match="too small to shard"):
        J._check_shardable(8, 2, 32)                  # the JAX core raises the same text


def test_shard_speaker_pool_layout():
    _, _, matching, synth, harm, pool_f0 = _world()
    mesh, _ = _mesh(4, 2)
    sp = shard_speaker_pool(matching, synth, pool_f0, harm, mesh)
    assert sp.true_len == 123 and sp.f0.shape == (123,) and sp.mesh is mesh
    for grid, width in ((sp.matching, 64), (sp.synth, 64), (sp.harmonics, 49)):
        assert len(grid) == 4 and all(len(row) == 2 for row in grid)
        assert all(s.shape == (62, width) for row in grid for s in row)
        # one copy per device and block: the grid rows share the CPU's copies
        assert all(row[p] is grid[0][p] for row in grid for p in range(2))
    np.testing.assert_array_equal(torch.cat(sp.synth[0])[:123].numpy(), synth)
    assert not sp.synth[0][1][-1].any()
    q8 = shard_speaker_pool(matching, synth, pool_f0, None, mesh, quantize_matching=True)
    assert q8.matching is None and q8.harmonics is None
    assert q8.matching_q8[0][0].dtype == torch.int8 and q8.inv_norms[0][1].shape == (62,)
    jq8 = J.shard_speaker_pool(matching, synth, pool_f0, None, _mesh(1, 2)[1],
                               quantize_matching=True)
    np.testing.assert_array_equal(torch.cat(q8.matching_q8[0]).numpy(),
                                  np.asarray(jq8.matching_q8))
    np.testing.assert_array_equal(torch.cat(q8.inv_norms[0]).numpy(), np.asarray(jq8.inv_norms))


def test_gather_rows_is_the_dense_gather():
    rng = np.random.default_rng(3)
    pool = torch.from_numpy(rng.standard_normal((21, 5)).astype(np.float32))
    mesh, _ = _mesh(1, 4)
    shards = shard_rows(pool, mesh)[0]
    idx = torch.from_numpy(rng.integers(0, 21, (7, 3, 2)))
    assert torch.equal(gather_rows(shards, idx), pool[idx])


# ----------------------------------------------------------- the match cores


@pytest.mark.parametrize("use_harmonics", [True, False], ids=["mix", "wavlm_only"])
@pytest.mark.parametrize("post_opt", ["no_post_opt", "post_opt_0.2"])
def test_sharded_match_core_matches_jax_and_dense(use_harmonics, post_opt):
    q, qf0, matching, synth, harm, pool_f0 = _world()
    cw, opt = (-1.0, False) if post_opt == "no_post_opt" else (0.2, True)
    mesh, jmesh = _mesh(1, 8)
    sp = shard_speaker_pool(matching, synth, pool_f0, harm if use_harmonics else None, mesh)
    got = sharded_match_core(q, qf0, sp.matching, sp.synth, sp.harmonics, sp.f0, sp.true_len,
                             None, mesh=mesh, topk=4, use_harmonics=use_harmonics,
                             concat_weight=cw, opt_enabled=opt)
    jsp = J.shard_speaker_pool(matching, synth, pool_f0, harm, jmesh)
    want = J.sharded_match_core(jnp.asarray(q), jnp.asarray(qf0), jsp.matching, jsp.synth,
                                jsp.harmonics if use_harmonics else jsp.synth, jsp.f0,
                                jsp.true_len, jnp.float32(np.nan), mesh=jmesh, topk=4,
                                use_harmonics=use_harmonics, concat_weight=cw,
                                opt_enabled=opt)
    atol = 3e-3 if opt else 1e-6
    np.testing.assert_allclose(got[0].numpy(), np.asarray(want[0]), atol=atol)
    np.testing.assert_allclose(got[1].numpy(), np.asarray(want[1]), rtol=1e-6)
    if use_harmonics:
        np.testing.assert_allclose(got[2].numpy(), np.asarray(want[2]), atol=atol)
    else:
        assert got[2] is None and want[2] is None
    # the port's dense core on the same inputs: the same selections, bit for bit
    t = [torch.from_numpy(a) for a in (q, matching, synth, pool_f0, harm, qf0)]
    if opt:
        dense = match_core_post_opt(*t, None, topk=4, use_harmonics=use_harmonics,
                                    concat_weight=cw, opt_enabled=opt)
    else:
        dense = match_core(*t, None, topk=4, use_harmonics=use_harmonics)
    for a, b in zip(got, dense):
        assert (a is None and b is None) or torch.equal(a, b)


def test_sharded_match_core_int8_matches_jax():
    q, qf0, matching, synth, harm, pool_f0 = _world(seed=8)
    mesh, jmesh = _mesh(1, 8)
    sp = shard_speaker_pool(matching, synth, pool_f0, harm, mesh, quantize_matching=True)
    got = sharded_match_core_int8(q, qf0, sp.matching_q8, sp.inv_norms, sp.synth, sp.harmonics,
                                  sp.f0, sp.true_len, None, mesh=mesh, topk=4,
                                  use_harmonics=True)
    jsp = J.shard_speaker_pool(matching, synth, pool_f0, harm, jmesh, quantize_matching=True)
    want = J.sharded_match_core_int8(jnp.asarray(q), jnp.asarray(qf0), jsp.matching_q8,
                                     jsp.inv_norms, jsp.synth, jsp.harmonics, jsp.f0,
                                     jsp.true_len, jnp.float32(np.nan), mesh=jmesh, topk=4,
                                     use_harmonics=True)
    np.testing.assert_allclose(got[0].numpy(), np.asarray(want[0]), atol=1e-6)
    np.testing.assert_allclose(got[1].numpy(), np.asarray(want[1]), rtol=1e-6)
    np.testing.assert_allclose(got[2].numpy(), np.asarray(want[2]), atol=1e-6)


def _batch(seed=9, B=4, T=40):
    q, qf0, matching, synth, harm, pool_f0 = _world(seed=seed)
    rng = np.random.default_rng(seed + 1)
    qs = rng.standard_normal((B, T, q.shape[1])).astype(np.float32)
    qf0s = (100 + 200 * rng.random((B, T))).astype(np.float32)
    qf0s[:, ::7] = 0.0
    return qs, qf0s, matching, synth, harm, pool_f0


@pytest.mark.parametrize("int8", [False, True], ids=["fp32-no_post_opt_0.2", "int8"])
def test_batched_cores_on_a_2d_mesh_match_jax_and_the_serial_core(int8):
    """Mesh (data, pool) = 4 x 2: the batch on the data axis, the pool on
    the pool axis. fp32 with the concat cost on (no_post_opt_0.2), as the
    JAX package's own 2-D test (tests/test_pipeline.py:464)."""
    qs, qf0s, matching, synth, harm, pool_f0 = _batch()
    mesh, jmesh = _mesh(4, 2)
    sp = shard_speaker_pool(matching, synth, pool_f0, harm, mesh, quantize_matching=int8)
    jsp = J.shard_speaker_pool(matching, synth, pool_f0, harm, jmesh, quantize_matching=int8)
    jqs, jqf0s = jnp.asarray(qs), jnp.asarray(qf0s)
    if int8:
        got = sharded_match_core_int8_batch(qs, qf0s, sp.matching_q8, sp.inv_norms, sp.synth,
                                            sp.harmonics, sp.f0, sp.true_len, mesh=mesh,
                                            topk=4, use_harmonics=True)
        want = J.sharded_match_core_int8_batch(jqs, jqf0s, jsp.matching_q8, jsp.inv_norms,
                                               jsp.synth, jsp.harmonics, jsp.f0, jsp.true_len,
                                               mesh=jmesh, topk=4, use_harmonics=True)
    else:
        got = sharded_match_core_batch(qs, qf0s, sp.matching, sp.synth, sp.harmonics, sp.f0,
                                       sp.true_len, mesh=mesh, topk=4, use_harmonics=True,
                                       concat_weight=0.2, opt_enabled=False)
        want = J.sharded_match_core_batch(jqs, jqf0s, jsp.matching, jsp.synth, jsp.harmonics,
                                          jsp.f0, jsp.true_len, mesh=jmesh, topk=4,
                                          use_harmonics=True, concat_weight=0.2,
                                          opt_enabled=False)
    for a, b in zip(got, want):
        assert a.shape == b.shape
    np.testing.assert_allclose(got[0].numpy(), np.asarray(want[0]), atol=1e-6)
    np.testing.assert_allclose(got[1].numpy(), np.asarray(want[1]), rtol=1e-6)
    np.testing.assert_allclose(got[2].numpy(), np.asarray(want[2]), atol=1e-6)
    for i in range(len(qs)):
        if int8:
            one = sharded_match_core_int8(qs[i], qf0s[i], sp.matching_q8, sp.inv_norms,
                                          sp.synth, sp.harmonics, sp.f0, sp.true_len, None,
                                          mesh=mesh, topk=4, use_harmonics=True)
        else:
            one = sharded_match_core(qs[i], qf0s[i], sp.matching, sp.synth, sp.harmonics, sp.f0,
                                     sp.true_len, None, mesh=mesh, topk=4, use_harmonics=True,
                                     concat_weight=0.2, opt_enabled=False)
        for a, b in zip(got, one):
            assert torch.equal(a[i], b)
    with pytest.raises(ValueError, match="must divide the batch"):
        if int8:
            sharded_match_core_int8_batch(qs[:3], qf0s[:3], sp.matching_q8, sp.inv_norms,
                                          sp.synth, sp.harmonics, sp.f0, sp.true_len,
                                          mesh=mesh, topk=4, use_harmonics=True)
        else:
            sharded_match_core_batch(qs[:3], qf0s[:3], sp.matching, sp.synth, sp.harmonics,
                                     sp.f0, sp.true_len, mesh=mesh, topk=4, use_harmonics=True,
                                     concat_weight=0.2, opt_enabled=False)


# ----------------------------------------------------------- concat cost on shards


@pytest.mark.parametrize("n_pool", [1, 3, 8])
def test_plain_scan_on_sharded_rows_equals_the_dense_scan(n_pool):
    rng = np.random.default_rng(4)
    T, P, D, k = 40, 61, 32, 4
    src = torch.from_numpy(rng.standard_normal((T, D)).astype(np.float32))
    tgt = torch.from_numpy(rng.standard_normal((P, D)).astype(np.float32))
    idx_u = torch.from_numpy(rng.integers(0, P, (T, k)))
    idx_p = torch.from_numpy(rng.integers(0, P, (T, k)))
    idx_u[5:9] = P - 1                                   # prev + 1 clamps at the true length
    sf0 = torch.from_numpy((150 + 100 * rng.random(T)).astype(np.float32))
    tf0 = torch.from_numpy((150 + 100 * rng.random(P)).astype(np.float32))
    mesh, _ = _mesh(1, n_pool)
    shards = shard_rows(tgt, mesh)[0]
    rows = lambda ids: gather_rows(shards, ids)
    want = knn_with_concat_cost_pair(idx_u, idx_p, src, tgt, sf0, tf0, concat_weight=0.2)
    got = knn_with_concat_cost_pair(idx_u, idx_p, src, rows, sf0, tf0, concat_weight=0.2,
                                    pool_len=P)
    assert all(torch.equal(a, b) for a, b in zip(got, want))
    assert torch.equal(knn_with_concat_cost(idx_u, src, rows, concat_weight=0.3, pool_len=P),
                       knn_with_concat_cost(idx_u, src, tgt, concat_weight=0.3))
    # the wrapper's sharded entries take the plain version on the CPU
    before = concat_cost_pair.launches
    got_w = concat_cost_pair_sharded(idx_u, idx_p, src, shards, P, sf0, tf0, concat_weight=0.2)
    assert all(torch.equal(a, b) for a, b in zip(got_w, want))
    assert torch.equal(concat_cost_single_sharded(idx_p, src, shards, P, sf0, tf0),
                       concat_cost_single(idx_p, src, tgt, sf0, tf0))
    assert concat_cost_pair.launches == before
    with pytest.raises(ValueError, match="pool_len"):
        concat_cost_single_sharded(idx_u, src, shards, len(shards) * shards[0].shape[0] + 1)
