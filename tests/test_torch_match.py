"""knnsvc_torch match stage against the JAX package on the CPU: kNN indices
exactly (a constructed tie included), the f0 register shift, the f0
re-rank exactly, and the whole no_post_opt match core."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from knnsvc_tpu.match.distance import cosine_distance as jax_cosine_distance
from knnsvc_tpu.match.f0_logic import shift_f0_to_target_register as jax_shift
from knnsvc_tpu.match.f0_logic import sort_by_f0_compatibility as jax_sort
from knnsvc_tpu.match.knn import knn_topk as jax_knn_topk
from knnsvc_tpu.match.pipeline import _match_core
from knnsvc_torch.match.distance import cosine_distance
from knnsvc_torch.match.f0_logic import (shift_f0_to_target_register,
                                         sort_by_f0_compatibility, torch_median)
from knnsvc_torch.match.knn import knn_topk
from knnsvc_torch.match.pipeline import match_core


def _feats(n, d, seed):
    return np.random.default_rng(seed).standard_normal((n, d)).astype(np.float32)


def test_cosine_distance_clamps_zero_and_nan_rows():
    src, pool = _feats(5, 16, 0), _feats(7, 16, 1)
    src[1] = 0.0
    pool[2] = 0.0
    pool[4, 3] = np.nan
    want = np.asarray(jax_cosine_distance(jnp.asarray(src), jnp.asarray(pool)))
    got = cosine_distance(torch.from_numpy(src), torch.from_numpy(pool)).numpy()
    np.testing.assert_allclose(got, want, atol=1e-6)
    assert (got[1] == 2.0).all() and (got[:, 2] == 2.0).all() and (got[:, 4] == 2.0).all()


@pytest.mark.parametrize("k", [4, 32])
def test_knn_topk_indices_exact_with_ties(k):
    """Duplicate pool rows give exactly equal distances: both must list them
    in ascending pool order (lax.top_k's tie rule)."""
    q, pool = _feats(40, 32, 2), _feats(90, 32, 3)
    pool[50] = pool[10]
    pool[77] = pool[10]
    pool[60] = 2.0 * pool[20]       # a scaled copy: the same cosine
    q[7] = pool[10]                 # query 7's three nearest are exact ties
    want_i, want_d = map(np.asarray, jax_knn_topk(jnp.asarray(q), jnp.asarray(pool), k=k))
    got_i, got_d = knn_topk(torch.from_numpy(q), torch.from_numpy(pool), k=k)
    np.testing.assert_array_equal(got_i.numpy(), want_i)
    np.testing.assert_allclose(got_d.numpy(), want_d, atol=1e-6)
    assert list(got_i[7, :3].numpy()) == [10, 50, 77]


@pytest.mark.parametrize("src_log_median", [None, float(np.log(180.0)), float("nan")])
def test_shift_f0_to_target_register(src_log_median):
    rng = np.random.default_rng(4)
    qf0 = (100 + 200 * rng.random(50)).astype(np.float32)
    qf0[::4] = 0.0
    tf0 = (200 + 300 * rng.random(64)).astype(np.float32)
    tf0[::3] = 0.0
    want = np.asarray(jax_shift(jnp.asarray(qf0), jnp.asarray(tf0), src_log_median))
    got = shift_f0_to_target_register(torch.from_numpy(qf0), torch.from_numpy(tf0),
                                      src_log_median).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-6)
    assert (got[qf0 == 0] == 0).all()
    unvoiced = np.zeros(64, np.float32)   # fully unvoiced target: zero shift
    got = shift_f0_to_target_register(torch.from_numpy(qf0), torch.from_numpy(unvoiced))
    np.testing.assert_allclose(got.numpy(), qf0, rtol=1e-6)   # exp(log(f0) + 0)


def test_sort_by_f0_compatibility_exact_and_torch_median():
    rng = np.random.default_rng(5)
    T, P = 30, 80
    expected = (100 + 300 * rng.random(T)).astype(np.float32)
    pool_f0 = (80 + 400 * rng.random(P)).astype(np.float32)
    pool_f0[::7] = 0.0                               # equal badness: stable order
    idx = rng.integers(0, P, (T, 32)).astype(np.int32)
    want = np.asarray(jax_sort(jnp.asarray(expected), jnp.asarray(pool_f0), jnp.asarray(idx)))
    got = sort_by_f0_compatibility(torch.from_numpy(expected), torch.from_numpy(pool_f0),
                                   torch.from_numpy(idx).long()).numpy()
    np.testing.assert_array_equal(got, want)
    x = torch.tensor([[3.0, 1.0, 4.0, 2.0], [5.0, 9.0, 2.0, 6.0]])
    assert torch_median(x).tolist() == torch.median(x, dim=-1).values.tolist()


@pytest.mark.parametrize("spread_hz,min_share", [(20.0, 0.995), (0.3, 0.8)])
def test_sort_by_f0_compatibility_near_ties(spread_hz, min_share):
    """Candidates whose f0s lie within a fraction of a Hz of each other get
    badness values an ulp apart, and the last bit of log decides their
    order, where XLA's log and torch's differ on some values. Measured here
    on 2000 frames x 32 candidates around 270 Hz: with a sung spread
    (+-10 Hz) nearly every row keeps JAX's order; with a pure tone's
    (+-0.15 Hz) about a seventh of the rows do not."""
    rng = np.random.default_rng(0)
    T, P = 2000, 3000
    pool_f0 = (270 + spread_hz * rng.random(P)).astype(np.float32)
    expected = (270 + spread_hz * rng.random(T)).astype(np.float32)
    idx = rng.integers(0, P, (T, 32)).astype(np.int32)
    want = np.asarray(jax_sort(jnp.asarray(expected), jnp.asarray(pool_f0), jnp.asarray(idx)))
    got = sort_by_f0_compatibility(torch.from_numpy(expected), torch.from_numpy(pool_f0),
                                   torch.from_numpy(idx).long()).numpy()
    same = float((got == want).all(axis=1).mean())
    assert same >= min_share, same


@pytest.mark.parametrize("use_harmonics", [True, False])
def test_match_core_matches_jax(use_harmonics):
    rng = np.random.default_rng(6)
    T, P, D = 45, 120, 64
    q, matching, synth = _feats(T, D, 7), _feats(P, D, 8), _feats(P, D, 9)
    pool_f0 = (150 + 300 * rng.random(P)).astype(np.float32)
    pool_f0[::5] = 0.0
    qf0 = (100 + 200 * rng.random(T)).astype(np.float32)
    qf0[::6] = 0.0
    harm = rng.random((P, 49)).astype(np.float32)
    want = _match_core(*map(jnp.asarray, (q, matching, synth, pool_f0, harm, qf0)),
                       jnp.float32(np.nan), topk=4, approx=False, use_harmonics=use_harmonics)
    got = match_core(*map(torch.from_numpy, (q, matching, synth, pool_f0, harm, qf0)),
                     None, topk=4, use_harmonics=use_harmonics)
    np.testing.assert_allclose(got[0].numpy(), np.asarray(want[0]), atol=1e-6)
    np.testing.assert_allclose(got[1].numpy(), np.asarray(want[1]), rtol=1e-6)
    if use_harmonics:
        np.testing.assert_allclose(got[2].numpy(), np.asarray(want[2]), atol=1e-6)
    else:
        assert got[2] is None and want[2] is None
