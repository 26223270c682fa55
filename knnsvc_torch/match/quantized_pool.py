"""int8-quantized matching pools (counterpart of
knnsvc_tpu/match/quantized_pool.py).

Row-wise symmetric int8 quantization cuts the matching pool's memory by 4x.
Cosine distance needs only each row's direction, so the per-row scales
cancel:

    cos(q, p_j) = (q8 . v_j) / (|q8| |v_j|)   with p_j ~= s_j * v_j (int8)

and only the quantized rows' inverse norms are kept. `quantize_pool` is the
JAX package's host numpy pass, copied; `knn_topk_quantized` quantizes the
query rows on their device with the same float32 operations as the JAX
package (XLA turns the division by 127 into a product with the float32
reciprocal, so this does too).

The int8 x int8 -> int32 product (an XLA dot_general in the JAX package,
not a Pallas kernel) is a library call here, and its integer result is
exact on every device: on a card, `torch._int_mm` (cuBLASLt int8 GEMM
with int32 accumulation), whose shape rules (more than 16 rows; the inner
dimension and the column count multiples of 8) are met by zero rows and
columns added here and cut off after; on the CPU a float32 product, exact
while |sum| <= 127^2 * D < 2^24, i.e. D <= 1040 (WavLM-Large: 1024), and an
int64 product above. Ties keep ascending pool order (a stable sort), and
`approx` (lax.approx_min_k, a TPU op) is this exact search.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

# the (q_chunk, P) distance tile stays under ~256 MB fp32, as in match/knn.py
_MAX_TILE_ELEMS = 64 * 1024 * 1024
_INV_127_F32 = float(np.float32(1.0 / 127.0))
_EXACT_F32_DIM = (1 << 24) // (127 * 127)      # 1040


class QuantizedPool(NamedTuple):
    values: torch.Tensor      # (P, D) int8
    inv_norms: torch.Tensor   # (P,) float32, 1/|values_row| (zero rows -> 0)


def quantize_pool(pool, device: str | torch.device = "cuda") -> QuantizedPool:
    """Row-wise symmetric int8 quantization on the host (once per pool),
    the result moved to `device` (a CUDA request without a card raises)."""
    from knnsvc_torch.hub import resolve_device

    device = resolve_device(device)
    p = np.asarray(pool, dtype=np.float32)
    absmax = np.max(np.abs(p), axis=1, keepdims=True)
    scale = np.where(absmax > 0, absmax / 127.0, 1.0)
    q = np.clip(np.round(p / scale), -127, 127).astype(np.int8)
    norms = np.linalg.norm(q.astype(np.float32), axis=1)
    inv = np.where(norms > 0, 1.0 / np.where(norms > 0, norms, 1.0), 0.0).astype(np.float32)
    return QuantizedPool(torch.from_numpy(q).to(device), torch.from_numpy(inv).to(device))


def quantize_rows(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """(Q, D) float rows -> (int8 rows, (Q, 1) float32 inverse norms of the
    int8 rows), on x's device."""
    xf = x.to(torch.float32)
    absmax = xf.abs().amax(dim=1, keepdim=True)
    scale = torch.where(absmax > 0, absmax * _INV_127_F32, 1.0)
    q8 = torch.clamp(torch.round(xf / scale), -127, 127).to(torch.int8)
    # the squares of int8 values sum exactly in float32 (< 2^24 for D <= 1040)
    norm = torch.linalg.vector_norm(q8.to(torch.float32), dim=1, keepdim=True)
    return q8, torch.where(norm > 0, 1.0 / norm, 0.0)


def _pad_to(x: torch.Tensor, rows: int, cols: int) -> torch.Tensor:
    return torch.nn.functional.pad(x, (0, cols - x.shape[1], 0, rows - x.shape[0]))


def int8_dot(q8: torch.Tensor, values: torch.Tensor) -> torch.Tensor:
    """(Q, D) int8 x (P, D) int8 -> (Q, P) int32 dot products, exact."""
    Q, D = q8.shape
    P = values.shape[0]
    if q8.device.type == "cuda":
        up8 = lambda n: -(-n // 8) * 8
        Qp, Dp, Pp = max(up8(Q), 24), up8(D), up8(P)
        a = _pad_to(q8, Qp, Dp) if (Qp, Dp) != (Q, D) else q8.contiguous()
        b = _pad_to(values, Pp, Dp) if (Pp, Dp) != (P, D) else values
        return torch._int_mm(a, b.t())[:Q, :P]
    if D <= _EXACT_F32_DIM:
        return (q8.to(torch.float32) @ values.to(torch.float32).t()).to(torch.int32)
    return (q8.to(torch.int64) @ values.to(torch.int64).t()).to(torch.int32)


def knn_topk_quantized(query: torch.Tensor, pool: QuantizedPool, k: int = 32,
                       approx: bool = True) -> tuple[torch.Tensor, torch.Tensor]:
    """Top-k cosine neighbours against an int8 pool. query (Q, D) float on
    the pool's device -> (indices (Q, k) int64, cosine distances (Q, k)),
    ascending by distance. The query rows are row-wise quantized too (their
    scales cancel in the cosine)."""
    del approx  # exact on every device
    q8, q_inv = quantize_rows(query)
    P = pool.values.shape[0]
    k = min(k, P)
    q_chunk = max(1, _MAX_TILE_ELEMS // max(P, 1))
    idx, vals = [], []
    for start in range(0, q8.shape[0], q_chunk):
        dot = int8_dot(q8[start:start + q_chunk], pool.values).to(torch.float32)
        dists = 1.0 - dot * q_inv[start:start + q_chunk] * pool.inv_norms[None, :]
        v, i = torch.sort(dists, dim=1, stable=True)
        idx.append(i[:, :k])
        vals.append(v[:, :k])
    return torch.cat(idx), torch.cat(vals)
