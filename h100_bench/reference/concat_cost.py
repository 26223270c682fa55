"""A frozen copy of knnsvc_torch/match/concat_cost.py, plain PyTorch; nothing of the port is
imported. The original's description:

Concatenation-cost candidate reselection, the paper's CAT step: the plain
PyTorch version (counterpart of knnsvc_tpu/match/concat_cost.py:
`knn_with_concat_cost` and `knn_with_concat_cost_pair`).

Reference: lib_ongaku_test.py:270-369, a strictly serial per-frame greedy
pass. Frame 0 passes through. Frame t's candidates are its own top-k
followed by min(frame t-1's picks + 1, P - 1), duplicates kept; each costs

    matching = 1 - cand . sv / |cand|              (sv = row-normalized source)
    cc       = 1 - prev . cand / (|prev| |cand|)   (k x 2k, against t-1's picks)
    total    = weight * torch_median(cc over prev) + matching [+ |dlog2 f0|]

and the k cheapest are kept, ties to the lowest candidate position (the
order of lax.top_k(-total)). The unpitched lane sharpens cc > b to
1.5 cc - b, with b = 2 (1 - svn[t-1] . svn[t]) the source's own continuity.
The pitched lane zeroes cc < 5 b while b < 0.08, latches its weight to 0
for good once b >= 0.08 (the reference reassigns `concat_weight = 0`,
lib_ongaku_test.py:325-332), and adds |log2 f0_cand - log2 f0_src|.

Lanes are independent and run stacked: (T, L, k) selections, lane l
pitched or not. The pool is a (P, D) tensor, or a callable that gathers the
rows of given ids, with the pool length P beside it: a pool sharded over a
mesh (parallel/mesh.gather_rows, the JAX core's `gather_rows`), P its
unpadded length. This is a Python loop over frames, a few dozen small ops
each; on the card the serving path runs the same recurrence as one kernel
(ops/concat_scan.py, csrc/concat_cost_pair.cu), and this loop is the plain
version it is held to.

Streaming (`concat_cost_stream_core`, `concat_cost_pair_stream_core`):
a chunk continues the recurrence from a carry, the previous frame's picks
and the pitched lane's weight after it. The carry goes in as frame 0 (its
ids the carried picks, its source row the previous frame's), which passes
through, so frame 1 sees the carried picks in their order and takes its
baseline against the previous source row, and the pitched lanes start
from the carried weight. Chaining chunks so gives the whole-utterance
pass frame for frame, the sticky latch included.
"""

from __future__ import annotations

from typing import Callable

import torch

from .f0_logic import _log2, torch_median


def _norm(x: torch.Tensor) -> torch.Tensor:
    """sqrt(sum(x * x)) over the last dim, as jnp.linalg.norm computes it."""
    return torch.sqrt((x * x).sum(-1))


def scan_inputs(src: torch.Tensor, shifted_src_f0: torch.Tensor | None,
                tgt_f0: torch.Tensor | None):
    """The per-frame inputs of the scan, computed once: the row-normalized
    source svn (T, D), the continuity baselines b (T-1,) of frames 1..T-1,
    and the log2 f0 tracks log2(f0 + 1e-5) (None without f0)."""
    svn = src / _norm(src)[:, None]
    baselines = 2.0 * (1.0 - (svn[:-1] * svn[1:]).sum(-1))
    src_lf0 = None if shifted_src_f0 is None else _log2(shifted_src_f0 + 1e-5)
    tgt_lf0 = None if tgt_f0 is None else _log2(tgt_f0 + 1e-5)
    return svn, baselines, src_lf0, tgt_lf0


Pool = torch.Tensor | Callable[[torch.Tensor], torch.Tensor]


def concat_cost_scan(idx: torch.Tensor, svn: torch.Tensor, tgt: Pool,
                     baselines: torch.Tensor, src_lf0: torch.Tensor | None,
                     tgt_lf0: torch.Tensor | None, pitched: tuple[bool, ...],
                     concat_weight: float,
                     pitched_weight: float | torch.Tensor | None = None,
                     pool_len: int | None = None) -> torch.Tensor:
    """The serial reselection over T frames for L stacked lanes.
    idx (T, L, k) integer ids into tgt (P, D), or into the pool of
    pool_len rows that the callable tgt gathers; pitched[l] says whether
    lane l is pitched (then src_lf0 (T,) and tgt_lf0 (P,) are needed). The
    pitched lanes' weight starts at `pitched_weight` (default
    concat_weight; a carry may bring 0), the unpitched lanes' is
    concat_weight throughout. -> (T, L, k) int64 selections."""
    T, L, k = idx.shape
    rows = tgt if callable(tgt) else tgt.__getitem__
    P = tgt.shape[0] if pool_len is None else pool_len
    idx = idx.long()
    lane_pitched = torch.tensor(pitched, device=idx.device)                   # (L,)
    weight = torch.full((L,), concat_weight, dtype=torch.float32, device=idx.device)
    if pitched_weight is not None:
        weight = torch.where(lane_pitched, torch.as_tensor(
            pitched_weight, dtype=torch.float32, device=idx.device), weight)
    prev = idx[0]                                                             # (L, k)
    prev_feats = rows(prev)                                                   # (L, k, D)
    pn = _norm(prev_feats)
    lanes = torch.arange(L, device=idx.device)[:, None]
    out = [prev]
    for t in range(1, T):
        cand = torch.cat([idx[t], torch.clamp(prev + 1, max=P - 1)], dim=1)  # (L, 2k)
        feats = rows(cand)                                                    # (L, 2k, D)
        cn = _norm(feats)
        matching = 1.0 - (feats * svn[t]).sum(-1) / cn
        cross = (prev_feats[:, :, None, :] * feats[:, None, :, :]).sum(-1)    # (L, k, 2k)
        cc = 1.0 - cross / (pn[:, :, None] * cn[:, None, :])
        b = baselines[t - 1]
        low = b < 0.08
        cc_u = torch.where(cc > b, 1.5 * cc - b, cc)
        cc_p = torch.where(low & (cc < 5.0 * b), 0.0, cc)
        cc = torch.where(lane_pitched[:, None, None], cc_p, cc_u)
        weight = torch.where(lane_pitched & ~low, 0.0, weight)               # sticky
        total = weight[:, None] * torch_median(cc, dim=1) + matching         # (L, 2k)
        if any(pitched):
            pitch = torch.abs(tgt_lf0[cand] - src_lf0[t])
            total = torch.where(lane_pitched[:, None], total + pitch, total)
        pick = torch.sort(total, dim=1, stable=True).indices[:, :k]
        prev = torch.gather(cand, 1, pick)
        prev_feats = feats[lanes, pick]
        pn = torch.gather(cn, 1, pick)
        out.append(prev)
    return torch.stack(out)


def knn_with_concat_cost(idx: torch.Tensor, src: torch.Tensor, tgt: Pool,
                         shifted_src_f0: torch.Tensor | None = None,
                         tgt_f0: torch.Tensor | None = None,
                         concat_weight: float = 0.2, pool_len: int | None = None) -> torch.Tensor:
    """One lane, pitched when both f0 tracks are given. idx (T, k) ->
    reselected (T, k) int64. tgt: the pool, or a row-gather callable with
    pool_len."""
    pitched = shifted_src_f0 is not None
    svn, baselines, src_lf0, tgt_lf0 = scan_inputs(
        src, shifted_src_f0, tgt_f0 if pitched else None)
    return concat_cost_scan(idx[:, None], svn, tgt, baselines, src_lf0, tgt_lf0,
                            (pitched,), concat_weight, pool_len=pool_len)[:, 0]


def knn_with_concat_cost_pair(idx_unpitched: torch.Tensor, idx_pitched: torch.Tensor,
                              src: torch.Tensor, tgt: Pool,
                              shifted_src_f0: torch.Tensor, tgt_f0: torch.Tensor,
                              concat_weight: float = 0.2, pool_len: int | None = None):
    """Both reselections of the post_opt match in one pass: lane 0
    unpitched (the WavLM selection), lane 1 pitched (the harmonic one).
    -> (unpitched (T, k), pitched (T, k)) int64. tgt: the pool, or a
    row-gather callable with pool_len."""
    svn, baselines, src_lf0, tgt_lf0 = scan_inputs(src, shifted_src_f0, tgt_f0)
    out = concat_cost_scan(torch.stack([idx_unpitched, idx_pitched], dim=1), svn, tgt,
                           baselines, src_lf0, tgt_lf0, (False, True), concat_weight,
                           pool_len=pool_len)
    return out[:, 0], out[:, 1]
