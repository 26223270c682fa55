"""The match against a target pool sharded over a mesh's pool axis
(counterpart of knnsvc_tpu/parallel/sharded_match.py): the distributed kNN,
the f0 register shift, the f0-priority re-rank, the concat-cost
reselection, the smoothness optimizer and the output gathers.

Memory: the matching, synth and harmonics pools (the O(pool-frames)
arrays) each live at P / n_pool rows per device, zero-padded to a shard
multiple; nothing downstream re-replicates them. With quantize_matching the
matching rows are stored int8 and the fp32 ones are never placed. The f0
track, (P,) floats, is one tensor on the mesh's first device, unpadded: the
pitch costs index it per candidate.

The JAX core computes the replicated downstream results on every shard
(shard_map, :133-170 there); here they are computed once, on the first
device of the grid row (the mesh's first device for one utterance). Rows
reach them through parallel/mesh.gather_rows, a masked gather per shard
summed onto that device: the top-k means, the smoothness neighbourhoods
(T, k, 3, D) at clip(id + {-1, 0, 1}, 0, true_len - 1) and the weighted
outputs. Only candidate rows move, never a shard. The concat-cost
reselection runs the port's kernel with the shards' pointer table (one
launch; the JAX core runs its XLA scan over the same masked gathers), and
the optimizer is match/smoothness.py's.

Selections equal the dense match's (match/pipeline.py) wherever the
per-shard distances round like the full pool's: every stage after the kNN
reads the same rows and computes the same arithmetic. The batched cores
split the batch over the mesh's data axis, contiguous blocks of B / n_data
utterances per grid row, the kNN as one block per row and the serial
stages per utterance, each with its own register shift.
"""

from __future__ import annotations

import dataclasses
from typing import Sequence

import numpy as np
import torch
from torch.profiler import record_function

from knnsvc_torch.match.f0_logic import shift_f0_to_target_register, sort_by_f0_compatibility
from knnsvc_torch.match.quantized_pool import int8_dot, quantize_pool, quantize_rows
from knnsvc_torch.match.smoothness import (HARMONICS_LOSS_SCALE, WAVLM_LOSS_SCALE,
                                           optimize_smoothness_from_surrounding)
from knnsvc_torch.ops.concat_scan import concat_cost_pair_sharded, concat_cost_single_sharded
from knnsvc_torch.parallel.mesh import Mesh, gather_rows, shard_rows
from knnsvc_torch.parallel.sharded_knn import cosine_distances, shard_topk

Grid = list[list[torch.Tensor]]     # [data row][pool shard] -> (shard_len, ...)


@dataclasses.dataclass
class ShardedPool:
    """A speaker pool laid out for a mesh's pool axis: the per-frame arrays
    as grids of shards ([data row][pool shard], padded to a shard
    multiple), the f0 track unpadded on the mesh's first device. With
    quantize_matching the fp32 matching rows are absent and the search runs
    on int8 rows (row scales cancel in the cosine, match/quantized_pool.py):
    serving configs only, since the concat cost and the optimizer read fp32
    matching rows."""

    matching: Grid | None           # (shard_len, D) fp32, or None (int8)
    synth: Grid                     # (shard_len, D)
    harmonics: Grid | None          # (shard_len, 49)
    f0: torch.Tensor                # (P,) unpadded, on mesh.first
    true_len: int                   # unpadded pool length
    mesh: Mesh
    matching_q8: Grid | None = None     # (shard_len, D) int8
    inv_norms: Grid | None = None       # (shard_len,) fp32


def _tensor(a) -> torch.Tensor:
    return a if isinstance(a, torch.Tensor) else torch.from_numpy(np.ascontiguousarray(a))


def shard_speaker_pool(matching, synth, f0, harmonics, mesh: Mesh,
                       quantize_matching: bool = False) -> ShardedPool:
    """Pad the pool arrays' frame axis to a pool-shard multiple and place
    the shards; the f0 track goes to the mesh's first device. Arrays may be
    numpy (host pools) or tensors on any device (device pools).
    quantize_matching stores the matching rows int8 with per-row inverse
    norms (4x fewer bytes; the fp32 rows are never placed)."""
    matching_q8 = inv_norms = matching_sh = None
    if quantize_matching:
        host = matching.cpu().numpy() if isinstance(matching, torch.Tensor) else matching
        qp = quantize_pool(host, "cpu")
        matching_q8, inv_norms = shard_rows(qp.values, mesh), shard_rows(qp.inv_norms, mesh)
    else:
        matching_sh = shard_rows(_tensor(matching), mesh)
    return ShardedPool(
        matching=matching_sh,
        synth=shard_rows(_tensor(synth), mesh),
        harmonics=None if harmonics is None else shard_rows(_tensor(harmonics), mesh),
        f0=_tensor(f0).to(device=mesh.first, dtype=torch.float32),
        true_len=int(_tensor(f0).shape[0]),
        mesh=mesh,
        matching_q8=matching_q8,
        inv_norms=inv_norms,
    )


def _quantize_queries(q: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Row-wise query quantization over the last axis: (..., D) -> (int8
    rows (..., D), inverse norms (..., 1)), the JAX core's
    _quantize_queries (the dense int8 matcher's operations, XLA's product
    with the fp32 reciprocal of 127 included)."""
    q8, inv = quantize_rows(q.reshape(-1, q.shape[-1]))
    return q8.reshape(q.shape), inv.reshape(*q.shape[:-1], 1)


def _nearest_int8(q: torch.Tensor, shards: Sequence[torch.Tensor],
                  inv_shards: Sequence[torch.Tensor], true_len: int, k: int) -> torch.Tensor:
    """(Q, D) fp32 queries, quantized on their device, against int8 shards
    -> the merged top-k ids (Q, k)."""
    q8, q_inv = _quantize_queries(q)
    moved: dict = {}

    def distances(s, a, b):
        dev = shards[s].device
        if dev not in moved:
            moved[dev] = (q8.to(dev), q_inv.to(dev))
        dot = int8_dot(moved[dev][0][a:b], shards[s]).to(torch.float32)
        return 1.0 - dot * moved[dev][1][a:b] * inv_shards[s][None, :]

    return shard_topk(q.shape[0], shards, true_len, k, distances)[0]


def _gather(shards: Sequence[torch.Tensor], idx: torch.Tensor) -> torch.Tensor:
    with record_function("knnsvc.shard_gather"):
        return gather_rows(shards, idx, idx.device)


def _weighted_output(shards, idx, true_len: int, opt_enabled: bool, scale: float,
                     max_opt_steps: int) -> torch.Tensor:
    """The smoothness-weighted sum of the selected rows, or their mean."""
    if not opt_enabled:
        return _gather(shards, idx).mean(dim=1)
    offs = torch.tensor([-1, 0, 1], device=idx.device)
    sidx = torch.clamp(idx[:, :, None] + offs, 0, true_len - 1)          # (T, k, 3)
    surr = _gather(shards, sidx)                                          # (T, k, 3, D)
    w = optimize_smoothness_from_surrounding(surr.reshape(*idx.shape, -1), scale=scale,
                                             max_steps=max_opt_steps)
    return (surr[:, :, 1] * w[..., None]).sum(dim=1)


def _downstream(q, qf0, qmed, nearest_nbrs, d: int, synth: Grid, harm: Grid | None,
                matching: Grid | None, pool_f0: torch.Tensor, true_len: int, topk: int,
                use_harmonics: bool, concat_weight: float, opt_enabled: bool,
                max_opt_steps: int):
    """Everything after the kNN for one utterance, on grid row d's first
    device: -> (out (T, D), shifted f0 (T,), harmonics (T, H) or None)."""
    shifted = shift_f0_to_target_register(qf0, pool_f0, qmed)
    target_idx = nearest_nbrs[:, :topk]
    pitched_idx = None
    if use_harmonics:
        # ids past the pool (possible only when it has fewer than k rows) read
        # its last f0, as XLA's clamped gather does
        p_pad = len(synth[d]) * synth[d][0].shape[0]
        f0_ids = torch.cat([pool_f0, pool_f0[-1:].expand(p_pad - true_len)])
        pitched_idx = sort_by_f0_compatibility(shifted, f0_ids, nearest_nbrs)[:, :topk]
    if concat_weight != -1.0:
        with record_function("knnsvc.concat_cost"):
            if use_harmonics:
                target_idx, pitched_idx = concat_cost_pair_sharded(
                    target_idx, pitched_idx, q, matching[d], true_len, shifted, pool_f0,
                    concat_weight=concat_weight)
            else:
                target_idx = concat_cost_single_sharded(target_idx, q, matching[d], true_len,
                                                        concat_weight=concat_weight)
    with record_function("knnsvc.smoothness"):
        out = _weighted_output(synth[d], target_idx, true_len, opt_enabled, WAVLM_LOSS_SCALE,
                               max_opt_steps)
        harm_out = None
        if use_harmonics:
            harm_out = _weighted_output(harm[d], pitched_idx, true_len, opt_enabled,
                                        HARMONICS_LOSS_SCALE, max_opt_steps)
    return out, shifted, harm_out


def _check_harmonics(harm_sh, use_harmonics: bool) -> None:
    if use_harmonics and harm_sh is None:
        raise ValueError("use_harmonics needs the pool's harmonic amplitudes (harm_sh)")


def _check_batch(B: int, mesh: Mesh) -> int:
    n_data = mesh.shape["data"]
    if B % n_data != 0:
        raise ValueError(f"mesh 'data' axis ({n_data}) must divide the batch ({B})")
    return B // n_data


@torch.no_grad()
def sharded_match_core(q, qf0, matching_sh: Grid, synth_sh: Grid, harm_sh: Grid | None,
                       pool_f0: torch.Tensor, true_len: int, qmed: float | None = None, *,
                       mesh: Mesh, topk: int, use_harmonics: bool, concat_weight: float,
                       opt_enabled: bool, k: int = 32, max_opt_steps: int = 100_000):
    """One utterance against a sharded fp32 pool (grid row 0): q (T, D), qf0
    (T,); qmed overrides the query's log-median in the register shift
    (None or NaN: its own). concat_weight -1 turns the reselection off.
    -> (out (T, D), shifted f0 (T,), harmonics (T, H) or None) on the mesh's
    first device: the dense `match_core` / `match_core_post_opt`'s
    selection semantics."""
    _check_harmonics(harm_sh, use_harmonics)
    row = matching_sh[0]
    dev = mesh.first
    q = torch.as_tensor(q).to(device=dev, dtype=torch.float32)
    qf0 = torch.as_tensor(qf0).to(device=dev, dtype=torch.float32)
    nn = shard_topk(q.shape[0], row, int(true_len), k, cosine_distances(q, row))[0]
    return _downstream(q, qf0, qmed, nn, 0, synth_sh, harm_sh, matching_sh, pool_f0.to(dev),
                       int(true_len), topk, use_harmonics, concat_weight, opt_enabled,
                       max_opt_steps)


@torch.no_grad()
def sharded_match_core_batch(qs, qf0s, matching_sh: Grid, synth_sh: Grid, harm_sh: Grid | None,
                             pool_f0: torch.Tensor, true_len: int, *, mesh: Mesh, topk: int,
                             use_harmonics: bool, concat_weight: float, opt_enabled: bool,
                             k: int = 32, max_opt_steps: int = 100_000):
    """A batch qs (B, T, D), qf0s (B, T) over the data axis against the
    sharded pool over the pool axis: B / n_data utterances and P / n_pool
    pool rows per device. Each utterance's register shift uses its own
    voiced median. -> (out (B, T, D), shifted (B, T), harmonics (B, T, H)
    or None) on the mesh's first device."""
    _check_harmonics(harm_sh, use_harmonics)
    qs, qf0s = torch.as_tensor(qs), torch.as_tensor(qf0s)
    per = _check_batch(qs.shape[0], mesh)
    outs = []
    for d in range(mesh.shape["data"]):
        dev = mesh.devices[d][0]
        q_d = qs[d * per:(d + 1) * per].to(device=dev, dtype=torch.float32)
        f_d = qf0s[d * per:(d + 1) * per].to(device=dev, dtype=torch.float32)
        Bd, T, D = q_d.shape
        rows = q_d.reshape(Bd * T, D)
        nn = shard_topk(Bd * T, matching_sh[d], int(true_len), k,
                        cosine_distances(rows, matching_sh[d]))[0].reshape(Bd, T, -1)
        f0_d = pool_f0.to(dev)
        outs += [_downstream(q_d[b], f_d[b], None, nn[b], d, synth_sh, harm_sh, matching_sh,
                             f0_d, int(true_len), topk, use_harmonics, concat_weight,
                             opt_enabled, max_opt_steps) for b in range(Bd)]
    return _stack(outs, mesh.first, use_harmonics)


def _stack(outs, dev: torch.device, use_harmonics: bool):
    out = torch.stack([o[0].to(dev) for o in outs])
    shifted = torch.stack([o[1].to(dev) for o in outs])
    harm = torch.stack([o[2].to(dev) for o in outs]) if use_harmonics else None
    return out, shifted, harm


@torch.no_grad()
def sharded_match_core_int8(q, qf0, matching_q8: Grid, inv_norms: Grid, synth_sh: Grid,
                            harm_sh: Grid | None, pool_f0: torch.Tensor, true_len: int,
                            qmed: float | None = None, *, mesh: Mesh, topk: int,
                            use_harmonics: bool, k: int = 32):
    """`sharded_match_core` with the matching pool stored int8: each
    shard's candidate search on int8 rows (the queries quantized row-wise
    on the mesh's first device; on a card `torch._int_mm`), the merge and
    everything after as the fp32 core's no_post_opt path. The concat cost
    and the optimizer read fp32 matching rows: use the fp32 core for
    post_opt."""
    _check_harmonics(harm_sh, use_harmonics)
    dev = mesh.first
    q = torch.as_tensor(q).to(device=dev, dtype=torch.float32)
    qf0 = torch.as_tensor(qf0).to(device=dev, dtype=torch.float32)
    nn = _nearest_int8(q, matching_q8[0], inv_norms[0], int(true_len), k)
    return _downstream(q, qf0, qmed, nn, 0, synth_sh, harm_sh, None, pool_f0.to(dev),
                       int(true_len), topk, use_harmonics, -1.0, False, 0)


@torch.no_grad()
def sharded_match_core_int8_batch(qs, qf0s, matching_q8: Grid, inv_norms: Grid, synth_sh: Grid,
                                  harm_sh: Grid | None, pool_f0: torch.Tensor, true_len: int,
                                  *, mesh: Mesh, topk: int, use_harmonics: bool, k: int = 32):
    """The int8 core over a batch, split as `sharded_match_core_batch`:
    B / n_data utterances and P / (4 n_pool) matching bytes per device;
    no_post_opt only. Each utterance's register shift uses its own voiced
    median."""
    _check_harmonics(harm_sh, use_harmonics)
    qs, qf0s = torch.as_tensor(qs), torch.as_tensor(qf0s)
    per = _check_batch(qs.shape[0], mesh)
    outs = []
    for d in range(mesh.shape["data"]):
        dev = mesh.devices[d][0]
        q_d = qs[d * per:(d + 1) * per].to(device=dev, dtype=torch.float32)
        f_d = qf0s[d * per:(d + 1) * per].to(device=dev, dtype=torch.float32)
        Bd, T, D = q_d.shape
        nn = _nearest_int8(q_d.reshape(Bd * T, D), matching_q8[d], inv_norms[d],
                           int(true_len), k).reshape(Bd, T, -1)
        f0_d = pool_f0.to(dev)
        outs += [_downstream(q_d[b], f_d[b], None, nn[b], d, synth_sh, harm_sh, None, f0_d,
                             int(true_len), topk, use_harmonics, -1.0, False, 0)
                 for b in range(Bd)]
    return _stack(outs, mesh.first, use_harmonics)
