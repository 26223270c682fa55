"""Self-attention with a gated relative-position bias: the wrapper of the
hand-written CUDA kernel (csrc/gated_bias_attention.cu) and its plain
PyTorch version.

Counterpart of knnsvc_tpu/ops/attention.py::gated_bias_attention, the
Pallas TPU kernel (pl.pallas_call at attention.py:82):

    out = softmax(q k^T * d^-1/2 + gate[..., None] * bias) v

The wrapper takes the plain version only for tensors that lie on the CPU.
A CUDA tensor launches the kernel or raises; nothing falls back.
"""

from __future__ import annotations

import ctypes

import torch

KERNEL = "gated_bias_attention"
HEAD_DIM = 64  # the kernel's compiled head dim (WavLM-Large: 1024 / 16)


def reference_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        bias: torch.Tensor | None, gate: torch.Tensor | None) -> torch.Tensor:
    """Plain version with the same semantics, over any leading dims:
    q, k, v (..., H, T, d); bias (H, T, T); gate (..., H, T)."""
    d = q.shape[-1]
    s = torch.einsum("...htd,...hsd->...hts", q, k) * (d ** -0.5)
    if bias is not None:
        s = s + gate[..., None] * bias
    p = torch.softmax(s, dim=-1)
    return torch.einsum("...hts,...hsd->...htd", p, v)


def _check_cuda_inputs(q, k, v, bias, gate) -> tuple[int, int, int]:
    H, T, d = q.shape
    expected = {"q": (H, T, d), "k": (H, T, d), "v": (H, T, d),
                "bias": (H, T, T), "gate": (H, T)}
    for name, t in zip(expected, (q, k, v, bias, gate)):
        if t.device != q.device:
            raise ValueError(f"{name} is on {t.device}, q on {q.device}")
        if t.dtype != torch.float32:
            raise TypeError(f"{name} must be float32, got {t.dtype}")
        if tuple(t.shape) != expected[name]:
            raise ValueError(f"{name} has shape {tuple(t.shape)}, expected {expected[name]}")
        if not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError(f"{name} must be contiguous and 16-byte aligned")
    if d != HEAD_DIM:
        raise ValueError(f"the CUDA kernel takes head dim {HEAD_DIM}, got {d}")
    return H, T, d


def gated_bias_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         bias: torch.Tensor, gate: torch.Tensor) -> torch.Tensor:
    """q, k, v (H, T, d); bias (H, T, T); gate (H, T) per-query scale of the
    bias. q arrives unscaled (1/sqrt(d) is applied inside). -> (H, T, d) fp32.

    CPU tensors take `reference_attention`. CUDA tensors launch the kernel on
    the current stream and add one to `gated_bias_attention.launches`."""
    if q.device.type == "cpu":
        return reference_attention(q, k, v, bias, gate)
    if q.device.type != "cuda":
        raise ValueError(f"gated_bias_attention runs on cpu or cuda, not {q.device}")
    H, T, d = _check_cuda_inputs(q, k, v, bias, gate)
    from knnsvc_torch.ops.build import check_launch, load_kernel

    lib = load_kernel(KERNEL)
    fn = lib.gated_bias_attention_f32
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 3 + [ctypes.c_float, ctypes.c_void_p]
    out = torch.empty_like(q)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        code = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), bias.data_ptr(),
                  gate.data_ptr(), out.data_ptr(), H, T, d, d ** -0.5, stream)
    check_launch(lib, KERNEL, code)
    gated_bias_attention.launches += 1
    return out


gated_bias_attention.launches = 0
