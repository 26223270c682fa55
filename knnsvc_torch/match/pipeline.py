"""The no_post_opt match (counterpart of knnsvc_tpu/match/pipeline.py::_match_core).

Ordering quirks kept from the reference (ref ddsp_prematch_dataset.py:1074-1459):
the WavLM feature output uses the unpitched selection (top-k of the raw kNN),
while the harmonic amplitudes use the f0-prioritized selection, re-sorted
from the original 32 candidates; uniform mean weights when post_opt is off.
"""

from __future__ import annotations

import torch

from knnsvc_torch.match.f0_logic import shift_f0_to_target_register, sort_by_f0_compatibility
from knnsvc_torch.match.knn import knn_topk

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
