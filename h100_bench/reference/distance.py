"""A frozen copy of knnsvc_torch/match/distance.py, plain PyTorch; nothing of the port is
imported. The original's description:

Cosine distances (counterpart of knnsvc_tpu/match/distance.py).
"""

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
