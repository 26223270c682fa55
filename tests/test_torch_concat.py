"""knnsvc_torch's concat-cost reselection on the CPU against the JAX package,
selection for selection, at k in KS: the plain pair against the lax.scan
pair and, at k = 4 (the only k it takes), the Pallas kernel (interpret
mode, as tests/test_ops.py runs it); the single lane (unpitched and
pitched) against the single scan; on cases that reach the sticky latch,
the P-1 clamp, duplicate candidates and unvoiced frames. The CUDA kernel's
own tests are in test_torch_gpu.py."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from knnsvc_tpu.match.concat_cost import knn_with_concat_cost as jax_single
from knnsvc_tpu.match.concat_cost import knn_with_concat_cost_pair as jax_pair
from knnsvc_tpu.ops.concat_scan import concat_cost_pair_pallas
from knnsvc_torch.match.concat_cost import knn_with_concat_cost, knn_with_concat_cost_pair
from knnsvc_torch.ops.concat_scan import concat_cost_pair, concat_cost_prepass, concat_cost_single

CASES = ["random", "sticky_latch", "clamp_and_duplicates", "unvoiced"]
KS = [1, 2, 3, 4, 6, 8]


def _inputs(case, T=37, P=53, D=128, k=4, seed=11):
    """(idx_u, idx_p, src, tgt, shifted f0, target f0) as numpy. Every case
    has a smooth source stretch (baselines < 0.08) that a jump ends, so the
    pitched lane's weight latches to 0 part way through."""
    rng = np.random.default_rng(seed + CASES.index(case))
    src = rng.standard_normal((T, D)).astype(np.float32)
    src[12:20] = src[12] + 0.01 * rng.standard_normal((8, D)).astype(np.float32)
    tgt = rng.standard_normal((P, D)).astype(np.float32)
    idx_u = rng.integers(0, P, (T, k)).astype(np.int32)
    idx_p = rng.integers(0, P, (T, k)).astype(np.int32)
    sf0 = (80 + 300 * rng.random(T)).astype(np.float32)
    tf0 = (80 + 300 * rng.random(P)).astype(np.float32)
    if case == "sticky_latch":
        # a longer smooth run first, so the latch falls late, and the
        # target rows near the picks smooth too (concat costs under 5 b)
        src[:25] = src[0] + 0.005 * rng.standard_normal((25, D)).astype(np.float32)
        tgt[:20] = tgt[0] + 0.05 * rng.standard_normal((20, D)).astype(np.float32)
        idx_u[:, :2] = rng.integers(0, 20, (T, min(k, 2)))
        idx_p[:, :2] = rng.integers(0, 20, (T, min(k, 2)))
    elif case == "clamp_and_duplicates":
        # pool row P-1 among the own candidates (its +1 clamps to P-1), and
        # own candidates that repeat each other and the previous picks + 1
        # (columns taken modulo k, so every k has them)
        idx_u[::3, 0] = P - 1
        idx_p[::4, 1 % k] = P - 1
        idx_u[1::2, 2 % k] = idx_u[1::2, 1 % k]
        idx_p[1:, 3 % k] = np.minimum(idx_p[:-1, 0] + 1, P - 1)
        idx_u[1:, 3 % k] = np.minimum(idx_u[:-1, 3 % k] + 1, P - 1)
    elif case == "unvoiced":
        sf0[::3] = 0.0
        tf0[::4] = 0.0
    return idx_u, idx_p, src, tgt, sf0, tf0


def _torch(*arrays):
    return [torch.from_numpy(a) for a in arrays]


def _jax(*arrays):
    return [jnp.asarray(a) for a in arrays]


@pytest.mark.parametrize("k", KS)
@pytest.mark.parametrize("case", CASES)
def test_pair_equals_jax_scan_and_pallas_kernel(case, k):
    arrays = _inputs(case, k=k)
    want_u, want_p = map(np.asarray, jax_pair(*_jax(*arrays), concat_weight=0.2))
    got_u, got_p = knn_with_concat_cost_pair(*_torch(*arrays), concat_weight=0.2)
    assert got_u.shape == got_p.shape == (arrays[2].shape[0], k)
    np.testing.assert_array_equal(got_u.numpy(), want_u)
    np.testing.assert_array_equal(got_p.numpy(), want_p)
    if k == 4:
        pal_u, pal_p = map(np.asarray, concat_cost_pair_pallas(
            *_jax(*arrays), concat_weight=0.2, interpret=True))
        np.testing.assert_array_equal(got_u.numpy(), pal_u)
        np.testing.assert_array_equal(got_p.numpy(), pal_p)
    # the reselection changed something: it is not the identity on the inputs
    assert (got_u.numpy()[1:] != arrays[0][1:]).any()
    assert (got_p.numpy()[1:] != arrays[1][1:]).any()


@pytest.mark.parametrize("k", KS)
@pytest.mark.parametrize("case", CASES)
@pytest.mark.parametrize("pitched", [False, True])
def test_single_lane_equals_jax_scan(case, pitched, k):
    idx_u, idx_p, src, tgt, sf0, tf0 = _inputs(case, k=k)
    idx = idx_p if pitched else idx_u
    f0s = (sf0, tf0) if pitched else ()
    want = np.asarray(jax_single(*_jax(idx, src, tgt, *f0s), concat_weight=0.2))
    got = knn_with_concat_cost(*_torch(idx, src, tgt, *f0s), concat_weight=0.2)
    assert got.dtype == torch.int64
    np.testing.assert_array_equal(got.numpy(), want)


def test_sticky_latch_is_reached():
    """The latch case holds frames under the 0.08 baseline, then one over it."""
    _, _, src, _, _, _ = _inputs("sticky_latch")
    svn = src / np.linalg.norm(src, axis=1, keepdims=True)
    b = 2 * (1 - (svn[:-1] * svn[1:]).sum(1))
    assert (b[:20] < 0.08).all() and (b >= 0.08).any()


@pytest.mark.parametrize("concat_weight", [0.2, 0.3])
def test_wrapper_on_cpu_is_the_plain_version(concat_weight):
    idx_u, idx_p, src, tgt, sf0, tf0 = _torch(*_inputs("random"))
    before = concat_cost_pair.launches
    got_u, got_p = concat_cost_pair(idx_u.long(), idx_p, src, tgt, sf0, tf0,
                                    concat_weight=concat_weight)
    want_u, want_p = knn_with_concat_cost_pair(idx_u, idx_p, src, tgt, sf0, tf0,
                                               concat_weight=concat_weight)
    assert torch.equal(got_u, want_u) and torch.equal(got_p, want_p)
    got = concat_cost_single(idx_u, src, tgt, concat_weight=concat_weight)
    assert torch.equal(got, knn_with_concat_cost(idx_u, src, tgt, concat_weight=concat_weight))
    assert concat_cost_pair.launches == before, "a CPU tensor must not count a launch"


def test_wrapper_rejects_bad_inputs_on_cpu():
    idx_u, idx_p, src, tgt, sf0, tf0 = _torch(*_inputs("random"))
    with pytest.raises(TypeError, match="integers"):
        concat_cost_pair(idx_u.float(), idx_p, src, tgt, sf0, tf0)
    with pytest.raises(ValueError, match="shape"):
        concat_cost_pair(idx_u[:5], idx_p, src, tgt, sf0, tf0)
    with pytest.raises(ValueError, match="shape"):
        concat_cost_single(idx_u, src, tgt[:, :64])


def test_prepass_takes_only_cuda_tensors():
    """The pre-pass alone is a timing helper of the CUDA kernel; a CPU tensor
    is refused before anything is built or launched."""
    idx_u, idx_p, src, tgt, _, _ = _torch(*_inputs("random"))
    idx = torch.stack([idx_u, idx_p], dim=1).to(torch.int32)
    with pytest.raises(ValueError, match="CUDA"):
        concat_cost_prepass(idx, src, tgt)
