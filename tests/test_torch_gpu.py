"""knnsvc_torch's CUDA kernels against their plain PyTorch versions on a card.

Every test here is marked gpu and skips when torch sees no CUDA device
(decided inside the test). The file imports neither JAX nor the JAX
package, so it also runs where those are not installed:

    python -m pytest tests/test_torch_gpu.py -m gpu --noconftest -p no:cacheprovider

Tolerances: 1e-4 at the main path's T=1500, where the kernel sums 1500
fp32 terms per score and per output in another order than cuBLAS and
torch.softmax; 2e-5 (test_ops.py's bound for the Pallas kernel) at T<=200.
"""

import numpy as np
import pytest
import torch

from knnsvc_torch.ops.attention import gated_bias_attention, reference_attention


def _cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels are compiled for sm_90a")
    return torch.device("cuda")


def _inputs(H, T, d, gate_value, seed, device):
    rng = np.random.default_rng(seed)
    arrays = [rng.standard_normal((H, T, d)).astype(np.float32) for _ in range(3)]
    arrays.append(rng.standard_normal((H, T, T)).astype(np.float32))
    arrays.append((rng.random((H, T)) * 2).astype(np.float32) if gate_value is None
                  else np.full((H, T), gate_value, np.float32))
    return [torch.from_numpy(a).to(device) for a in arrays]


@pytest.mark.gpu
@pytest.mark.parametrize("H,T,gate_value,atol", [
    (16, 1500, None, 1e-4),   # the main path's shape (one 30-s chunk)
    (4, 200, 1.0, 2e-5),
    (4, 200, 0.0, 2e-5),
    (4, 200, -0.5, 2e-5),
    (3, 61, None, 2e-5),      # T not a multiple of 4: scalar bias loads
])
def test_attention_kernel_matches_plain(H, T, gate_value, atol):
    arrays = _inputs(H, T, 64, gate_value, seed=5, device=_cuda())
    before = gated_bias_attention.launches
    got = gated_bias_attention(*arrays)
    torch.cuda.synchronize()
    assert gated_bias_attention.launches == before + 1
    want = reference_attention(*arrays)
    assert got.shape == want.shape and torch.isfinite(got).all()
    assert float((got - want).abs().max()) <= atol


@pytest.mark.gpu
def test_attention_kernel_rejects_bad_inputs():
    q, k, v, bias, gate = _inputs(2, 64, 64, None, seed=6, device=_cuda())
    before = gated_bias_attention.launches
    with pytest.raises(TypeError):
        gated_bias_attention(q.double(), k, v, bias, gate)
    with pytest.raises(ValueError):
        gated_bias_attention(q, k, v, bias[:, :, :32], gate)
    with pytest.raises(ValueError):                 # head dim 32: not compiled
        gated_bias_attention(q[:, :, :32].contiguous(), k[:, :, :32].contiguous(),
                             v[:, :, :32].contiguous(), bias, gate)
    with pytest.raises(ValueError):
        gated_bias_attention(q.transpose(1, 2).contiguous().transpose(1, 2), k, v, bias, gate)
    assert gated_bias_attention.launches == before
