"""kNN over a pool sharded across a mesh's pool axis (counterpart of
knnsvc_tpu/parallel/sharded_knn.py).

The reference bounds one GPU's memory by looping 20 query rows at a time
over the whole pool (ref lib_ongaku_test.py:154-173). Here the POOL is
split: each shard's device computes the cosine distances of the queries to
its rows and a local top-min(k, shard_len); the candidates are collected
on the first shard's device, shard-major, and one final top-k merges them.
Queries are replicated (they are tiny next to an hours-scale pool).

Ties: lax.top_k keeps the lowest position among ties, so the JAX merge
resolves a tie to the lower shard, then the lower id: the dense order.
Both the local top-k and the merge here are stable sorts, which keep that
order. Padding: the pool is zero-padded to a shard multiple, and rows at a
global id >= true_len get distance +inf, so padding sorts after every row.
"""

from __future__ import annotations

from typing import Callable, Sequence

import torch
from torch.profiler import record_function

from knnsvc_torch.match.distance import cosine_distance
from knnsvc_torch.parallel.mesh import Mesh, shard_rows

# each (query chunk, shard_len) distance tile stays under ~256 MB fp32, as in match/knn.py
_MAX_TILE_ELEMS = 64 * 1024 * 1024


def check_shardable(n_shards: int, shard_len: int, k: int) -> int:
    """k_local, the candidates each shard contributes; raises when the
    shards together cannot yield k."""
    k_local = min(k, shard_len)   # tiny shards contribute fewer candidates
    if n_shards * k_local < k:
        raise ValueError(
            f"reference pool too small to shard: {n_shards} shards x "
            f"{shard_len} rows/shard yield {n_shards * k_local} candidates "
            f"< k={k}. The sharded matchers need >= "
            f"{-(-k // n_shards)} pool rows per shard "
            f"(~{-(-k // n_shards) * n_shards} frames total); use the dense "
            f"matcher ('exact'/'approx') for pools this small.")
    return k_local


def shard_pool(pool, mesh: Mesh) -> tuple[list[list[torch.Tensor]], int]:
    """Zero-pad the pool's frame axis to a pool-shard multiple and place
    each shard on its device. -> (shards [data row][pool shard], true
    length)."""
    pool = torch.as_tensor(pool)
    return shard_rows(pool, mesh), pool.shape[0]


def _shard_candidates(n_queries: int, shards: Sequence, true_len: int, k_local: int,
                      distances: Callable) -> tuple[torch.Tensor, torch.Tensor]:
    """Each shard's local top-k_local, collected on the first shard's
    device, shard-major: -> (distances (Q, S * k_local), global ids (Q, S *
    k_local) int64)."""
    shard_len = shards[0].shape[0]
    first = shards[0].device
    vals, ids = [], []
    for s in range(len(shards)):
        n_valid = min(max(true_len - s * shard_len, 0), shard_len)
        chunk = max(1, _MAX_TILE_ELEMS // shard_len)
        v_s, i_s = [], []
        for a in range(0, n_queries, chunk):
            d = distances(s, a, min(a + chunk, n_queries))
            d[:, n_valid:] = torch.inf
            v, i = torch.sort(d, dim=1, stable=True)
            v_s.append(v[:, :k_local])
            i_s.append(i[:, :k_local])
        vals.append(torch.cat(v_s).to(first))
        ids.append((torch.cat(i_s) + s * shard_len).to(first))
    return torch.cat(vals, dim=1), torch.cat(ids, dim=1)


def shard_topk(n_queries: int, shards: Sequence, true_len: int, k: int,
               distances: Callable) -> tuple[torch.Tensor, torch.Tensor]:
    """The top-k of n_queries rows over a pool split into `shards`, on the
    first shard's device: (ids (Q, k) int64 into the unpadded pool,
    distances (Q, k)), ties to the lower shard and id. distances(s, a, b)
    gives query rows a..b against shard s's rows, (b - a, shard_len), on
    shard s's device."""
    k_local = check_shardable(len(shards), shards[0].shape[0], k)
    with record_function("knnsvc.sharded_knn"):
        vals, ids = _shard_candidates(n_queries, shards, true_len, k_local, distances)
        v, pick = torch.sort(vals, dim=1, stable=True)
        return torch.gather(ids, 1, pick[:, :k]), v[:, :k]


def cosine_distances(query: torch.Tensor, shards: Sequence[torch.Tensor]) -> Callable:
    """shard_topk's distances for fp32 shards: the cosine distances of the
    query rows to shard s, the queries moved once to each shard's device."""
    moved: dict[torch.device, torch.Tensor] = {}

    def distances(s, a, b):
        dev = shards[s].device
        if dev not in moved:
            moved[dev] = query.to(device=dev, dtype=torch.float32)
        return cosine_distance(moved[dev][a:b], shards[s])

    return distances


def sharded_knn_topk(query: torch.Tensor, pool: Sequence[Sequence[torch.Tensor]], true_len: int,
                     mesh: Mesh, k: int = 32) -> tuple[torch.Tensor, torch.Tensor]:
    """query (Q, D), replicated to the shards' devices; pool: shard_pool's
    shards (grid row 0 searches); true_len: the unpadded pool length.
    -> (indices (Q, k) int64 into the unpadded pool, distances (Q, k)) on
    the mesh's first device."""
    row = pool[0]
    idx, dist = shard_topk(query.shape[0], row, int(true_len), k, cosine_distances(query, row))
    return idx.to(mesh.first), dist.to(mesh.first)
