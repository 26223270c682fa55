"""knnsvc_torch.ops.attention's diagonal entry on the CPU: the plain version
against the JAX package's Pallas kernel (interpret mode) at 2e-5, as
tests/test_ops.py holds the Pallas kernel, and the launch counters. The
entry takes the bias as its (H, 2T-1) diagonal table; the Pallas kernel gets
the same table expanded with numpy. The full (H, T, T) entry is held to the
Pallas kernel in test_torch_surface.py; the CUDA kernel's own tests are in
test_torch_gpu.py."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from knnsvc_tpu.ops.attention import gated_bias_attention as jax_gated_bias_attention
from knnsvc_torch.ops.attention import gated_bias_attention, gated_bias_attention_diag


def _inputs(H, T, d, gate_value=None, seed=0):
    rng = np.random.default_rng(seed)
    q, k, v = (rng.standard_normal((H, T, d)).astype(np.float32) for _ in range(3))
    diag = rng.standard_normal((H, 2 * T - 1)).astype(np.float32)
    if gate_value is None:
        gate = (rng.random((H, T)) * 2).astype(np.float32)
    else:
        gate = np.full((H, T), gate_value, np.float32)
    return q, k, v, diag, gate


def _expand(diag):
    """bias[h, i, j] = diag[h, T-1 + j - i], in numpy."""
    T = (diag.shape[-1] + 1) // 2
    i = np.arange(T)
    return diag[:, (T - 1) + i[None, :] - i[:, None]]


@pytest.mark.parametrize("T", [96, 200])
@pytest.mark.parametrize("gate_value", [1.0, 0.0, -0.5])
def test_plain_attention_matches_pallas_kernel(T, gate_value):
    """T=96 is block-aligned for block_q=96, T=200 is ragged (padded keys
    must take no weight under zero or negative gates)."""
    q, k, v, diag, gate = arrays = _inputs(4, T, 64, gate_value)
    ref = np.asarray(jax_gated_bias_attention(*map(jnp.asarray, (q, k, v, _expand(diag), gate)),
                                              block_q=96, interpret=True))
    before = gated_bias_attention_diag.launches
    got = gated_bias_attention_diag(*map(torch.from_numpy, arrays))
    assert gated_bias_attention_diag.launches == before, "a CPU tensor must not count a launch"
    assert got.shape == ref.shape and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), ref, atol=2e-5)


def test_launch_counter_stays_zero_on_cpu():
    gated_bias_attention.launches = gated_bias_attention_diag.launches = 0
    q, k, v, diag, gate = map(torch.from_numpy, _inputs(2, 33, 64, seed=3))
    gated_bias_attention_diag(q, k, v, diag, gate)
    gated_bias_attention(q, k, v, torch.from_numpy(_expand(diag.numpy())), gate)
    assert gated_bias_attention.launches == gated_bias_attention_diag.launches == 0
