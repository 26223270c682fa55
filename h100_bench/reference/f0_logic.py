"""A frozen copy of knnsvc_torch/match/f0_logic.py, plain PyTorch; nothing of the port is
imported. The original's description:

f0 register shifting and f0-compatibility re-ranking (counterpart of
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
