"""k-nearest-neighbour search over the target frame pool (counterpart of
knnsvc_tpu/match/knn.py::knn_topk).

The JAX package's lax.top_k breaks ties toward the lowest index and
torch.topk promises no order among ties, so each query tile is sorted with
a stable sort and cut to k: equal distances keep ascending pool order.
`approx=True` (lax.approx_min_k, a TPU op) maps to this exact search.
"""

from __future__ import annotations

import torch

from knnsvc_torch.match.distance import cosine_distance

# keep the materialized (q_chunk, P) distance tile under ~256 MB fp32
_MAX_TILE_ELEMS = 64 * 1024 * 1024


def knn_topk(query: torch.Tensor, pool: torch.Tensor, k: int = 32,
             approx: bool = False) -> tuple[torch.Tensor, torch.Tensor]:
    """Top-k smallest cosine distances. query (Q, D), pool (P, D) ->
    (indices (Q, k) int64, distances (Q, k)), both ascending by distance."""
    del approx  # exact on every device
    P = pool.shape[0]
    k = min(k, P)  # tiny pools have < k rows
    q_chunk = max(1, _MAX_TILE_ELEMS // max(P, 1))
    idx, vals = [], []
    for start in range(0, query.shape[0], q_chunk):
        dists = cosine_distance(query[start:start + q_chunk], pool)
        v, i = torch.sort(dists, dim=1, stable=True)
        idx.append(i[:, :k])
        vals.append(v[:, :k])
    return torch.cat(idx), torch.cat(vals)
