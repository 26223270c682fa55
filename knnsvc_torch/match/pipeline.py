"""The match stage (counterpart of knnsvc_tpu/match/pipeline.py: `_match_core`
and `_match_core_post_opt`).

Ordering quirks kept from the reference (ref ddsp_prematch_dataset.py:1074-1459):
the WavLM feature output uses the unpitched selection (top-k of the raw kNN,
optionally concat-reselected), while the harmonic amplitudes use the
f0-prioritized selection, re-sorted from the original 32 candidates
(optionally pitched-concat-reselected); uniform mean weights when the
smoothness optimizer is off.
"""

from __future__ import annotations

import torch
from torch.profiler import record_function

from knnsvc_torch.match.f0_logic import shift_f0_to_target_register, sort_by_f0_compatibility
from knnsvc_torch.match.knn import knn_topk
from knnsvc_torch.match.smoothness import (HARMONICS_LOSS_SCALE, WAVLM_LOSS_SCALE,
                                           optimize_smoothness_weights)
from knnsvc_torch.ops.concat_scan import concat_cost_pair, concat_cost_single

KNN_CANDIDATES = 32  # ref :1203


def match_core(q: torch.Tensor, matching: torch.Tensor, synth: torch.Tensor,
               pool_f0: torch.Tensor, harmonics: torch.Tensor | None, qf0: torch.Tensor,
               qmed: float | None, topk: int, use_harmonics: bool):
    """kNN top-32 -> register shift -> top-k mean of `synth` (and, with
    harmonics, the pitched re-rank and the top-k mean of `harmonics`).
    Returns (out (T, D), shifted f0 (T,), harm (T, 49) or None)."""
    nearest_nbrs, _ = knn_topk(q, matching, k=KNN_CANDIDATES)
    shifted = shift_f0_to_target_register(qf0, pool_f0, qmed)
    out = synth[nearest_nbrs[:, :topk]].mean(dim=1)
    harm = None
    if use_harmonics:
        pitched = sort_by_f0_compatibility(shifted, pool_f0, nearest_nbrs)[:, :topk]
        harm = harmonics[pitched].mean(dim=1)
    return out, shifted, harm


def _weighted(pool: torch.Tensor, idx: torch.Tensor, opt_enabled: bool,
              scale: float) -> torch.Tensor:
    """Smoothness-weighted sum of the selected rows, or their mean."""
    if not opt_enabled:
        return pool[idx].mean(dim=1)
    w = optimize_smoothness_weights(idx, pool, scale=scale)
    return (pool[idx] * w[..., None]).sum(dim=1)


def match_core_post_opt(q: torch.Tensor, matching: torch.Tensor, synth: torch.Tensor,
                        pool_f0: torch.Tensor, harmonics: torch.Tensor | None,
                        qf0: torch.Tensor, qmed: float | None, topk: int,
                        use_harmonics: bool, concat_weight: float, opt_enabled: bool):
    """The post_opt match: kNN top-32, register shift and pitched re-rank as
    in `match_core`; then the concat-cost reselection (both lanes on one
    kernel launch with harmonics, the unpitched lane alone without; skipped
    when concat_weight == -1); then the two smoothness optimizations (or
    uniform means when opt_enabled is False) and the weighted gathers.
    Returns (out (T, D), shifted f0 (T,), harm (T, 49) or None)."""
    nearest_nbrs, _ = knn_topk(q, matching, k=KNN_CANDIDATES)
    shifted = shift_f0_to_target_register(qf0, pool_f0, qmed)
    target_idx = nearest_nbrs[:, :topk]
    pitched_idx = None
    if use_harmonics:
        pitched_idx = sort_by_f0_compatibility(shifted, pool_f0, nearest_nbrs)[:, :topk]

    if concat_weight != -1.0:
        with record_function("knnsvc.concat_cost"):
            if use_harmonics:
                target_idx, pitched_idx = concat_cost_pair(
                    target_idx, pitched_idx, q, matching, shifted, pool_f0,
                    concat_weight=concat_weight)
            else:
                target_idx = concat_cost_single(target_idx, q, matching,
                                                concat_weight=concat_weight)

    with record_function("knnsvc.smoothness"):
        out = _weighted(synth, target_idx, opt_enabled, WAVLM_LOSS_SCALE)
        harm = (_weighted(harmonics, pitched_idx, opt_enabled, HARMONICS_LOSS_SCALE)
                if use_harmonics else None)
    return out, shifted, harm
