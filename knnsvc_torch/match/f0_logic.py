"""f0 register shifting and f0-compatibility re-ranking (counterpart of
knnsvc_tpu/match/f0_logic.py).

Torch-median semantics matter here: torch.median returns the LOWER of the two
middle elements for even counts; the reference's register shift depends on
it. Everything stays on the tensors' device (no host sync).
"""

from __future__ import annotations

import math

import numpy as np
import torch


def torch_median(x: torch.Tensor, dim: int = -1) -> torch.Tensor:
    """torch.median along a dim: sorted[(n-1)//2]."""
    s = torch.sort(x, dim=dim).values
    return s.select(dim, (x.shape[dim] - 1) // 2)


def masked_log_median(f0: torch.Tensor) -> torch.Tensor:
    """torch.median(torch.log(f0[f0 != 0])) without a data-dependent shape:
    unvoiced frames sort last as +inf (ref ddsp_prematch_dataset.py:1224-1225).
    A fully unvoiced track gives +inf."""
    mask = f0 != 0
    n = mask.sum()
    vals = torch.where(mask, torch.log(torch.where(mask, f0, 1.0)), torch.inf)
    s = torch.sort(vals).values
    return s[torch.clamp(n - 1, min=0) // 2]


def shift_f0_to_target_register(query_f0: torch.Tensor, matching_f0: torch.Tensor,
                                src_log_median: float | None = None) -> torch.Tensor:
    """Log-median alignment of voiced source frames into the target's register
    (ref ddsp_prematch_dataset.py:1224-1233):
    shifted = exp(log f0 + median(log tgt) - median(log src)) on voiced frames.

    src_log_median overrides median(log src); None or NaN means the input's
    own median (the reference semantics). A fully unvoiced track gives a
    zero shift instead of inf/NaN."""
    if src_log_median is None or math.isnan(src_log_median):
        src_med = masked_log_median(query_f0)
    else:
        src_med = torch.tensor(src_log_median, dtype=torch.float32, device=query_f0.device)
    delta = masked_log_median(matching_f0) - src_med
    delta = torch.where(torch.isfinite(delta), delta, 0.0)
    voiced = query_f0 != 0
    shifted = torch.exp(torch.log(torch.where(voiced, query_f0, 1.0)) + delta)
    return torch.where(voiced, shifted, query_f0)


_INV_LN2_F32 = float(np.float32(1.0 / np.log(2.0)))


def _log2(x: torch.Tensor) -> torch.Tensor:
    """log2 as jnp.log2 computes it: log(x) / log(2), which XLA compiles to a
    product with the fp32 reciprocal. Candidates with nearly equal f0 get
    badness values an ulp apart, so the last bit decides their order; this
    form keeps the JAX package's order more often than torch.log2 does
    (tests/test_torch_match.py::test_sort_by_f0_compatibility_near_ties)."""
    return torch.log(x) * _INV_LN2_F32


def sort_by_f0_compatibility(expected_f0: torch.Tensor, f0_list: torch.Tensor,
                             target_feature_indices: torch.Tensor) -> torch.Tensor:
    """Stable re-sort of each frame's candidate indices by
    |log2(cand_f0 + 1e-5) - log2(expected_f0 + 1e-5)|
    (ref ddsp_prematch_dataset.py:954-1016)."""
    cand_f0 = f0_list[target_feature_indices]                       # (T, k)
    badness = torch.abs(_log2(cand_f0 + 1e-5) - _log2(expected_f0[:, None] + 1e-5))
    order = torch.argsort(badness, dim=1, stable=True)
    return torch.gather(target_feature_indices, 1, order)


def compute_shift(query_f0: torch.Tensor, f0_list: torch.Tensor,
                  target_feature_indices: torch.Tensor) -> torch.Tensor:
    """Least-squares multiplicative f0 shift (ref ddsp_prematch_dataset.py:
    929-950, off the live path, which uses the log-median shift above):
    the s minimising ||s*q - median_tgt|| over frames whose candidates'
    median f0 is voiced; 1 when there is none. -> a 0-d tensor."""
    med = torch_median(f0_list[target_feature_indices], dim=-1)       # (T,)
    q = torch.where(med == 0, 0.0, query_f0)
    denom = torch.sum(q * q)
    return torch.where(denom > 0, torch.sum(q * med) / denom, 1.0)


def smoothen_f0(f0, slice_list, frame_per_second: int = 50) -> np.ndarray:
    """Linear interpolation across glitchy [start_s, end_s] windows
    (ref lib_ongaku_test.py:248-263). A host numpy utility, as in the JAX
    package: f0 (an array, or a tensor on any device) -> a numpy copy."""
    if isinstance(f0, torch.Tensor):
        f0 = f0.detach().cpu().numpy()
    f0 = np.asarray(f0).copy()
    for start_s, end_s in slice_list:
        a = int(start_s * frame_per_second)
        b = min(int(end_s * frame_per_second), len(f0) - 1)
        if b <= a:
            continue
        f0[a:b + 1] = np.interp(np.arange(a, b + 1), [a, b], [f0[a], f0[b]])
    return f0


def interp_f0_candidates(x: torch.Tensor, xp: torch.Tensor, fp: torch.Tensor) -> torch.Tensor:
    """Log-domain piecewise-linear interpolation of per-frame candidate
    tracks (ref ddsp_prematch_dataset.py:1019-1060 `interp`; off the live
    path). x (B,), xp (B, F) increasing, fp (B, F, N). Each row's line is
    the segment of xp[b] that holds x[b]. The result broadcasts as the JAX
    function's does: (B, B, N), [i, j] being row j's line at x[i] (for
    B = 1, (1, 1, N))."""
    xl = torch.log(x + 1e-5)[:, None]                                # (B, 1)
    xpl = torch.log(xp + 1e-5)                                       # (B, F)
    m = (fp[:, 1:] - fp[:, :-1]) / (xpl[:, 1:, None] - xpl[:, :-1, None])
    b = fp[:, :-1] - m * xpl[:, :-1, None]
    idx = torch.clamp(torch.sum(xl >= xpl, dim=-1) - 1, 0, m.shape[1] - 1)   # (B,)
    gather = idx[:, None, None].expand(-1, 1, m.shape[2])
    mi = torch.gather(m, 1, gather)
    bi = torch.gather(b, 1, gather)
    return mi[:, 0] * xl[..., None] + bi[:, 0]
