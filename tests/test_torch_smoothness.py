"""knnsvc_torch's smoothness optimizer and post_opt match core on the CPU
against the JAX package: 50 steps to 1e-5 with equal step counts, the full
run to the same step count and a converged loss within 2% (as
tests/test_match.py judges the JAX optimizer against the reference), the
weights on the simplex, `match_core_post_opt` against
`_match_core_post_opt` with and without harmonics and the optimizer, and
the fixture of the JAX optimizer's results that the card tests hold the
CUDA kernel to (tests/test_torch_smoothness_kernel.py)."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from knnsvc_tpu.match.pipeline import _match_core_post_opt
from knnsvc_tpu.match.smoothness import _gather_surrounding, _loss_fn
from knnsvc_tpu.match.smoothness import optimize_smoothness_weights as jax_optimize
from knnsvc_torch.match.pipeline import match_core_post_opt
from knnsvc_torch.match.smoothness import (HARMONICS_LOSS_SCALE, WAVLM_LOSS_SCALE,
                                           optimize_smoothness_weights)


def _problem(T, P, D, seed):
    rng = np.random.default_rng(seed)
    pool = rng.standard_normal((P, D)).astype(np.float32)
    idx = rng.integers(0, P, (T, 4)).astype(np.int32)
    return idx, pool


def _jax_loss(w, idx, pool, scale):
    """The JAX loss of softmax-processed weights (logits = log w)."""
    surrounding = _gather_surrounding(jnp.asarray(idx), jnp.asarray(pool), None)
    return float(_loss_fn(jnp.log(jnp.asarray(w) + 1e-12), surrounding, scale))


@pytest.mark.parametrize("scale,D", [(WAVLM_LOSS_SCALE, 64), (HARMONICS_LOSS_SCALE, 49)])
def test_fifty_steps_match_jax(scale, D):
    idx, pool = _problem(30, 90, D, seed=1)
    want, want_steps = jax_optimize(jnp.asarray(idx), jnp.asarray(pool), scale=scale,
                                    max_steps=50, return_steps=True)
    got, steps = optimize_smoothness_weights(torch.from_numpy(idx), torch.from_numpy(pool),
                                             scale=scale, max_steps=50, return_steps=True)
    assert steps == int(want_steps) == 50
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5)


@pytest.mark.parametrize("seed", [2, 3])
def test_full_run_matches_jax(seed):
    idx, pool = _problem(40, 120, 32, seed=seed)
    want, want_steps = jax_optimize(jnp.asarray(idx), jnp.asarray(pool),
                                    scale=WAVLM_LOSS_SCALE, return_steps=True)
    got, steps = optimize_smoothness_weights(torch.from_numpy(idx), torch.from_numpy(pool),
                                             scale=WAVLM_LOSS_SCALE, return_steps=True)
    assert steps == int(want_steps), (steps, int(want_steps))
    ours = _jax_loss(got.numpy(), idx, pool, WAVLM_LOSS_SCALE)
    theirs = _jax_loss(np.asarray(want), idx, pool, WAVLM_LOSS_SCALE)
    assert ours <= theirs * 1.02 + 1e-6, (ours, theirs)
    uniform = _jax_loss(np.full(idx.shape, 0.25, np.float32), idx, pool, WAVLM_LOSS_SCALE)
    assert ours < uniform


@pytest.mark.parametrize("name", ["wavlm", "harmonics"])
def test_kernel_fixture_holds_the_jax_optimizers_result(name):
    """tests/torch_data/smoothness_fixtures.npz, which the card tests hold
    the CUDA kernel to, is what the JAX optimizer gives: its inputs rebuild
    from the recipe (jax_fixture checks their SHA-256), and at the harmonic
    lane (D = 49; the WavLM lane's run takes tens of seconds here) JAX gives
    the same steps and weights again, and the loss of its weights."""
    from test_torch_smoothness_kernel import jax_fixture

    idx, pool, scale, want = jax_fixture(name)
    if name == "wavlm":
        return
    again, steps = jax_optimize(jnp.asarray(idx, jnp.int32), jnp.asarray(pool), scale=scale,
                                return_steps=True)
    assert int(steps) == want["steps"]
    np.testing.assert_allclose(np.asarray(again), want["weights"], atol=1e-6, rtol=0)
    surrounding = _gather_surrounding(jnp.asarray(idx, jnp.int32), jnp.asarray(pool), None)
    loss = float(_loss_fn(jnp.log(again), surrounding, scale))
    assert abs(loss - want["loss"]) <= 1e-6 * want["loss"], (loss, want["loss"])


def test_weights_on_the_simplex():
    idx, pool = _problem(25, 60, 16, seed=4)
    w = optimize_smoothness_weights(torch.from_numpy(idx), torch.from_numpy(pool))
    assert w.shape == (25, 4) and w.dtype == torch.float32
    assert (w >= 0).all()
    np.testing.assert_allclose(w.sum(dim=1).numpy(), 1.0, atol=1e-6)


@pytest.mark.parametrize("topk", [2, 4, 8])
@pytest.mark.parametrize("use_harmonics", [True, False])
@pytest.mark.parametrize("opt_enabled", [True, False])
def test_match_core_post_opt_matches_jax(use_harmonics, opt_enabled, topk):
    rng = np.random.default_rng(6)
    T, P, D = 45, 120, 64
    q, matching, synth = (rng.standard_normal((n, D)).astype(np.float32) for n in (T, P, P))
    pool_f0 = (150 + 300 * rng.random(P)).astype(np.float32)
    pool_f0[::5] = 0.0
    qf0 = (100 + 200 * rng.random(T)).astype(np.float32)
    qf0[::6] = 0.0
    harm = rng.random((P, 49)).astype(np.float32)
    arrays = (q, matching, synth, pool_f0, harm, qf0)
    want = _match_core_post_opt(*map(jnp.asarray, arrays), jnp.float32(np.nan), topk=topk,
                                approx=False, use_harmonics=use_harmonics,
                                concat_weight=0.2, opt_enabled=opt_enabled)
    got = match_core_post_opt(*map(torch.from_numpy, arrays), None, topk=topk,
                              use_harmonics=use_harmonics, concat_weight=0.2,
                              opt_enabled=opt_enabled)
    # the selections are exact (test_torch_concat.py), so without the
    # optimizer the outputs are means of the same rows. With it, a few
    # hundred Adam steps carry fp32 rounding into the weights: up to 2e-4
    # after a full run, as far as the JAX package's own unroll=1 and
    # unroll=8 loops drift apart on the same input; over the k <= 8 rows of
    # a convex mix of unit-variance entries (up to ~4) that is < 3e-3
    atol = 3e-3 if opt_enabled else 1e-6
    np.testing.assert_allclose(got[0].numpy(), np.asarray(want[0]), atol=atol)
    np.testing.assert_allclose(got[1].numpy(), np.asarray(want[1]), rtol=1e-6)
    if use_harmonics:
        np.testing.assert_allclose(got[2].numpy(), np.asarray(want[2]), atol=atol)
    else:
        assert got[2] is None and want[2] is None
