"""Cosine distances (counterpart of knnsvc_tpu/match/distance.py)."""

from __future__ import annotations

import torch


def _distance(dot: torch.Tensor, denom: torch.Tensor) -> torch.Tensor:
    """1 - dot / denom, with 2.0 where denom is not positive or the result is
    NaN."""
    positive = denom > 0.0
    cos = torch.where(positive, dot / torch.where(positive, denom, 1.0), -1.0)
    dist = 1.0 - cos
    return torch.where(torch.isnan(dist), 2.0, dist)


def cosine_distance(source: torch.Tensor, pool: torch.Tensor, eps: float = 0.0) -> torch.Tensor:
    """1 - cosine similarity. source (Q, D), pool (P, D) -> (Q, P); eps is
    added to the product of the norms.

    Zero-norm rows (digital silence, pool padding) get the maximum distance
    2.0 instead of NaN, and so do NaN inputs, so neither can win top-k (the
    reference merely detects NaN and aborts, lib_ongaku_test.py:166-169)."""
    src_norm = torch.linalg.vector_norm(source, dim=-1, keepdim=True)
    pool_norm = torch.linalg.vector_norm(pool, dim=-1, keepdim=True)
    return _distance(source @ pool.T, src_norm * pool_norm.T + eps)


def weighted_cosine_distance(source: torch.Tensor, pool: torch.Tensor,
                             weights: torch.Tensor | None = None) -> torch.Tensor:
    """Per-source-row feature weighting (ref ddsp_matcher.py:225-269
    fast_weighted_cosine_dist): for pair (i, j),
    1 - <w_i*x_i, y_j> / (||w_i*x_i|| * ||w_i*y_j||). source, weights
    (Q, D), pool (P, D) -> (Q, P); without weights, `cosine_distance`. The
    (Q, P) weighted pool norms are one product, w^2 (y^2)^T, as in the JAX
    package: no (Q, P, D) tensor is built."""
    if weights is None:
        return cosine_distance(source, pool)
    ws = source * weights
    src_norm = torch.linalg.vector_norm(ws, dim=-1)
    pool_norms_sq = (weights ** 2) @ (pool ** 2).T
    return _distance(ws @ pool.T, src_norm[:, None] * torch.sqrt(pool_norms_sq))
