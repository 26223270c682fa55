"""knnsvc_torch.ops.attention on the CPU: the plain version against the JAX
package's Pallas kernel (interpret mode) at 2e-5, as tests/test_ops.py holds
the Pallas kernel, and the launch counter. The CUDA kernel's own tests are
in test_torch_gpu.py."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from knnsvc_tpu.ops.attention import gated_bias_attention as jax_gated_bias_attention
from knnsvc_torch.ops.attention import gated_bias_attention


def _inputs(H, T, d, gate_value=None, seed=0):
    rng = np.random.default_rng(seed)
    q, k, v = (rng.standard_normal((H, T, d)).astype(np.float32) for _ in range(3))
    bias = rng.standard_normal((H, T, T)).astype(np.float32)
    if gate_value is None:
        gate = (rng.random((H, T)) * 2).astype(np.float32)
    else:
        gate = np.full((H, T), gate_value, np.float32)
    return q, k, v, bias, gate


@pytest.mark.parametrize("T", [96, 200])
@pytest.mark.parametrize("gate_value", [1.0, 0.0, -0.5])
def test_plain_attention_matches_pallas_kernel(T, gate_value):
    """T=96 is block-aligned for block_q=96, T=200 is ragged (padded keys
    must take no weight under zero or negative gates)."""
    arrays = _inputs(4, T, 64, gate_value)
    ref = np.asarray(jax_gated_bias_attention(*map(jnp.asarray, arrays), block_q=96,
                                              interpret=True))
    before = gated_bias_attention.launches
    got = gated_bias_attention(*map(torch.from_numpy, arrays))
    assert gated_bias_attention.launches == before, "a CPU tensor must not count a launch"
    assert got.shape == ref.shape and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), ref, atol=2e-5)


def test_launch_counter_stays_zero_on_cpu():
    gated_bias_attention.launches = 0
    gated_bias_attention(*map(torch.from_numpy, _inputs(2, 33, 64, seed=3)))
    assert gated_bias_attention.launches == 0
