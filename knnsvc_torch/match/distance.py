"""Cosine distance (counterpart of knnsvc_tpu/match/distance.py::cosine_distance)."""

from __future__ import annotations

import torch


def cosine_distance(source: torch.Tensor, pool: torch.Tensor) -> torch.Tensor:
    """1 - cosine similarity. source (Q, D), pool (P, D) -> (Q, P).

    Zero-norm rows (digital silence, pool padding) get the maximum distance
    2.0 instead of NaN, and so do NaN inputs, so neither can win top-k (the
    reference merely detects NaN and aborts, lib_ongaku_test.py:166-169)."""
    src_norm = torch.linalg.vector_norm(source, dim=-1, keepdim=True)
    pool_norm = torch.linalg.vector_norm(pool, dim=-1, keepdim=True)
    dot = source @ pool.T
    denom = src_norm * pool_norm.T
    positive = denom > 0.0
    cos = torch.where(positive, dot / torch.where(positive, denom, 1.0), -1.0)
    dist = 1.0 - cos
    return torch.where(torch.isnan(dist), 2.0, dist)
