"""Self-attention with a gated bias: the wrappers of the hand-written CUDA
kernel (csrc/gated_bias_attention.cu) and its plain PyTorch version.

Counterpart of knnsvc_tpu/ops/attention.py::gated_bias_attention, the
Pallas TPU kernel (pl.pallas_call at attention.py:82):

    out = softmax(q k^T * d^-1/2 + gate[..., None] * bias) v

The kernel has two entries, one per form of the bias:
- `gated_bias_attention(q, k, v, bias, gate)` takes the (H, T, T) bias, as
  the TPU kernel does;
- `gated_bias_attention_diag(q, k, v, diag, gate)` takes the (H, 2T-1)
  diagonal table of a Toeplitz bias, bias[h, i, j] = diag[h, T-1 + j - i].
  WavLM's relative-position bias is that gather (`toeplitz_bias` expands
  it), so the served encoder calls this entry and never builds the (H, T, T)
  tensor.
Both run one inner loop: a Toeplitz bias through the first gives the
second's output bit for bit. Both take every head dim d from 1 to MAX_HEAD_DIM
= 256: the kernel is compiled for d = 16, 32, 64, 128 and 256 and
zero-fills d up to the smallest of them inside its copies. No WavLM, HuBERT
or wav2vec 2.0 configuration has a head dim above 64.

The wrappers take the plain version only for tensors that lie on the CPU.
A CUDA tensor launches the kernel or raises; nothing falls back.
"""

from __future__ import annotations

import ctypes

import torch

from knnsvc_torch.precision import get_precision

KERNEL = "gated_bias_attention"
MAX_HEAD_DIM = 256   # the widest of the kernel's instances (16, 32, 64, 128, 256 columns)


def toeplitz_bias(diag: torch.Tensor) -> torch.Tensor:
    """(..., 2T-1) diagonal table -> (..., T, T) bias with
    bias[..., i, j] = diag[..., T-1 + j - i] (a gather: values are copied
    bit for bit)."""
    T = (diag.shape[-1] + 1) // 2
    i = torch.arange(T, device=diag.device)
    return diag[..., (T - 1) + (i[None, :] - i[:, None])]


def reference_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        bias: torch.Tensor | None, gate: torch.Tensor | None) -> torch.Tensor:
    """Plain version with the same semantics, over any leading dims:
    q, k, v (..., H, T, d); gate (..., H, T); bias the full (..., H, T, T)
    bias, or the (H, 2T-1) diagonal table of a Toeplitz one, or None."""
    d, T = q.shape[-1], q.shape[-2]
    s = torch.einsum("...htd,...hsd->...hts", q, k) * (d ** -0.5)
    if bias is not None:
        if bias.dim() == 2 and bias.shape[-1] == 2 * T - 1:
            bias = toeplitz_bias(bias)
        elif bias.dim() < 3 or tuple(bias.shape[-2:]) != (T, T):
            raise ValueError(f"bias of shape {tuple(bias.shape)}: expected (..., H, {T}, {T}) "
                             f"or a (H, {2 * T - 1}) diagonal table")
        s = s + gate[..., None] * bias
    p = torch.softmax(s, dim=-1)
    return torch.einsum("...hts,...hsd->...htd", p, v)


def _check_inputs(q, k, v, bias, gate, bias_shape) -> None:
    """Shapes on every device; dtype, device, layout and head dim for the
    kernel's (CUDA) inputs: rows of q, k and v start 16-byte aligned when d
    is a multiple of 4, so their base must be too; other d take 4-byte
    copies."""
    H, T, d = q.shape
    expected = {"q": (H, T, d), "k": (H, T, d), "v": (H, T, d),
                "bias": bias_shape(H, T), "gate": (H, T)}
    for name, t in zip(expected, (q, k, v, bias, gate)):
        if tuple(t.shape) != expected[name]:
            raise ValueError(f"{name} has shape {tuple(t.shape)}, expected {expected[name]}")
        if q.device.type == "cpu":
            continue
        if t.device != q.device:
            raise ValueError(f"{name} is on {t.device}, q on {q.device}")
        if t.dtype != torch.float32:
            raise TypeError(f"{name} must be float32, got {t.dtype}")
        align = 4 if name in ("q", "k", "v") and d % 4 else 16
        if not t.is_contiguous() or t.data_ptr() % align:
            raise ValueError(f"{name} must be contiguous and {align}-byte aligned")
    if q.device.type != "cpu" and not 1 <= d <= MAX_HEAD_DIM:
        raise ValueError(f"the CUDA kernel takes head dims 1..{MAX_HEAD_DIM}, got {d}")


def kernel_scales(d: int) -> tuple[float, float]:
    """(Q's scale, S's scale) of the kernel: d^-1/2 multiplies Q up front
    where it is a power of two (d a power of 4), which is exact, and the
    product S otherwise, as the plain version does."""
    if d & (d - 1) == 0 and (d.bit_length() - 1) % 2 == 0:
        return d ** -0.5, 1.0
    return 1.0, d ** -0.5


def _launch(entry: str, q, k, v, bias, gate) -> torch.Tensor:
    """One launch of the kernel's `entry` on q's current stream."""
    from knnsvc_torch.ops.build import check_launch, load_kernel

    H, T, d = q.shape
    lib = load_kernel(KERNEL)
    fn = getattr(lib, entry)
    fn.restype = ctypes.c_int
    fn.argtypes = ([ctypes.c_void_p] * 6 + [ctypes.c_int] * 3
                   + [ctypes.c_float] * 2 + [ctypes.c_int, ctypes.c_void_p])
    passes = 1 if get_precision() == "fastest" else 3
    q_scale, s_scale = kernel_scales(d)
    out = torch.empty_like(q)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        code = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), bias.data_ptr(),
                  gate.data_ptr(), out.data_ptr(), H, T, d, q_scale, s_scale, passes, stream)
    check_launch(lib, KERNEL, code)
    return out


def _device_of(q: torch.Tensor, name: str) -> str:
    if q.device.type not in ("cpu", "cuda"):
        raise ValueError(f"{name} runs on cpu or cuda, not {q.device}")
    return q.device.type


def gated_bias_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         bias: torch.Tensor, gate: torch.Tensor) -> torch.Tensor:
    """q, k, v (H, T, d); bias (H, T, T); gate (H, T) per-query scale of the
    bias. q arrives unscaled (1/sqrt(d) is applied inside). -> (H, T, d)
    fp32. Padded keys take no weight under any gate, as in the TPU kernel.

    CPU tensors take `reference_attention`. CUDA tensors launch the kernel's
    full-bias entry on the current stream and add one to
    `gated_bias_attention.launches`: its products take 3 TF32 tensor-core
    passes (fp32-grade) under the "highest" precision policy and one under
    "fastest", as cuBLAS takes TF32 there."""
    _check_inputs(q, k, v, bias, gate, lambda H, T: (H, T, T))
    if _device_of(q, "gated_bias_attention") == "cpu":
        return reference_attention(q, k, v, bias, gate)
    out = _launch("gated_bias_attention_full_f32", q, k, v, bias, gate)
    gated_bias_attention.launches += 1
    return out


def gated_bias_attention_diag(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                              diag: torch.Tensor, gate: torch.Tensor) -> torch.Tensor:
    """`gated_bias_attention` with a Toeplitz bias given as its (H, 2T-1)
    diagonal table, bias[h, i, j] = diag[h, T-1 + j - i] (WavLM's
    relative-position bias). CUDA tensors launch the kernel's diagonal entry
    and add one to `gated_bias_attention_diag.launches`."""
    _check_inputs(q, k, v, diag, gate, lambda H, T: (H, 2 * T - 1))
    if _device_of(q, "gated_bias_attention_diag") == "cpu":
        return reference_attention(q, k, v, diag, gate)
    out = _launch("gated_bias_attention_f32", q, k, v, diag, gate)
    gated_bias_attention_diag.launches += 1
    return out


gated_bias_attention.launches = 0
gated_bias_attention_diag.launches = 0
