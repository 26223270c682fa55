"""The match stage (counterpart of knnsvc_tpu/match/pipeline.py).

`match_core` and `match_core_post_opt` are the JAX package's `_match_core`
and `_match_core_post_opt`, the serving path's match;
`match_core_post_opt_stream` and `match_utterance_stream` its streaming
form, the concat-cost reselection continuing from a cross-chunk carry
(`_match_core_post_opt_stream` there). The host-pool and
bulk paths add `match_utterance` (one utterance against a prepared target
pool: exact/approx through those two, int8 through the step path),
`match_at_inference_time` (source pool x target pool), and
`match_utterances_batched` (a batch of equal-length queries against one
pool, the vmapped `_match_core_batch` there: here the kNN runs as one block
over the batch and the serial stages, concat cost and smoothness, loop
over its utterances). The multi-device matchers 'sharded' and
'sharded_int8' run a pool sharded over a mesh's pool axis
(parallel/sharded_match.py; pass a ShardedPool, or a mesh where the
pipeline builds one), and a mesh's data axis splits the batched match.

Ordering quirks kept from the reference (ref ddsp_prematch_dataset.py:1074-1459):
the WavLM feature output uses the unpitched selection (top-k of the raw kNN,
optionally concat-reselected), while the harmonic amplitudes use the
f0-prioritized selection, re-sorted from the original 32 candidates
(optionally pitched-concat-reselected); uniform mean weights when the
smoothness optimizer is off; prioritize_f0 is mandatory (ref :1375).
"""

from __future__ import annotations

import dataclasses
import functools
import os
from pathlib import Path
from typing import Iterable

import numpy as np
import torch
from torch.profiler import record_function

from knnsvc_torch.config import PostOpt, uses_harmonics
from knnsvc_torch.match.f0_logic import shift_f0_to_target_register, sort_by_f0_compatibility
from knnsvc_torch.match.knn import knn_topk
from knnsvc_torch.match.pool import SpeakerPool, build_speaker_pool
from knnsvc_torch.match.quantized_pool import QuantizedPool, knn_topk_quantized, quantize_pool
from knnsvc_torch.match.smoothness import (HARMONICS_LOSS_SCALE, WAVLM_LOSS_SCALE,
                                           optimize_smoothness_weights)
from knnsvc_torch.ops.concat_scan import (concat_cost_pair, concat_cost_pair_stream,
                                          concat_cost_single, concat_cost_single_stream)
from knnsvc_torch.parallel.mesh import Mesh, make_mesh

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


def _candidates(q, matching, pool_f0, qf0, qmed, topk: int, use_harmonics: bool):
    """kNN top-32, register shift, and the top-k of each lane: (shifted f0
    (T,), unpitched ids (T, k), pitched ids (T, k) or None)."""
    nearest_nbrs, _ = knn_topk(q, matching, k=KNN_CANDIDATES)
    shifted = shift_f0_to_target_register(qf0, pool_f0, qmed)
    pitched_idx = None
    if use_harmonics:
        pitched_idx = sort_by_f0_compatibility(shifted, pool_f0, nearest_nbrs)[:, :topk]
    return shifted, nearest_nbrs[:, :topk], pitched_idx


def _smoothed(synth, harmonics, target_idx, pitched_idx, opt_enabled: bool):
    """Both smoothness optimizations (or uniform means) and the weighted
    gathers: (out (T, D), harm (T, 49) or None)."""
    with record_function("knnsvc.smoothness"):
        out = _weighted(synth, target_idx, opt_enabled, WAVLM_LOSS_SCALE)
        harm = (None if pitched_idx is None
                else _weighted(harmonics, pitched_idx, opt_enabled, HARMONICS_LOSS_SCALE))
    return out, harm


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
    shifted, target_idx, pitched_idx = _candidates(q, matching, pool_f0, qf0, qmed, topk,
                                                   use_harmonics)
    if concat_weight != -1.0:
        with record_function("knnsvc.concat_cost"):
            if use_harmonics:
                target_idx, pitched_idx = concat_cost_pair(
                    target_idx, pitched_idx, q, matching, shifted, pool_f0,
                    concat_weight=concat_weight)
            else:
                target_idx = concat_cost_single(target_idx, q, matching,
                                                concat_weight=concat_weight)
    out, harm = _smoothed(synth, harmonics, target_idx, pitched_idx, opt_enabled)
    return out, shifted, harm


def match_core_post_opt_stream(q: torch.Tensor, matching: torch.Tensor, synth: torch.Tensor,
                               pool_f0: torch.Tensor, harmonics: torch.Tensor | None,
                               qf0: torch.Tensor, qmed: float | None, carry, topk: int,
                               use_harmonics: bool, concat_weight: float, opt_enabled: bool,
                               scan_from: int):
    """The post_opt match of one streaming window. The kNN, register shift
    and pitched re-rank run over all T window frames (the vocoder margins
    need the shifted f0); the concat-cost reselection runs over [scan_from,
    T), the frames this chunk owns, from `carry` = (picks (L, k), pitched
    weight) of the previous chunk's last emitted frame, or (carry None, the
    first chunk) from frame scan_from's own top-k. Chaining chunks so gives
    the whole-utterance pass frame for frame (ref lib_ongaku_test.py:294-336).
    The smoothness weights are solved per window slice. concat_weight -1
    keeps frame-local selections, with weights -1.
    Returns (out (Ts, D), shifted (T,), harm (Ts, 49) or None, picks (Ts,
    L, k), the weight after each frame (Ts,)), Ts = T - scan_from."""
    shifted, target_idx, pitched_idx = _candidates(q, matching, pool_f0, qf0, qmed, topk,
                                                   use_harmonics)
    s = scan_from
    sel_u, sel_p = target_idx[s:], None if pitched_idx is None else pitched_idx[s:]
    if concat_weight == -1.0:
        weights = torch.full((q.shape[0] - s,), -1.0, device=q.device)
    else:
        lead = 0
        if carry is None:
            # the first chunk: frame s passes through as its own top-k and is
            # the carry into [s + 1, T), as the whole-utterance pass starts
            lead = 1
            carry = (sel_u[:1] if sel_p is None else torch.stack([sel_u[0], sel_p[0]]),
                     concat_weight)
        elif s < 1:
            raise ValueError("a carried chunk needs the previous frame in its window "
                             f"(scan_from >= 1, got {s})")
        a = s + lead
        with record_function("knnsvc.concat_cost"):
            if use_harmonics:
                u, p, weights = concat_cost_pair_stream(
                    target_idx[a:], pitched_idx[a:], q[a - 1], q[a:], matching, shifted[a:],
                    pool_f0, carry[0], carry[1], concat_weight=concat_weight)
                sel_p = torch.cat([sel_p[:lead], p])
            else:
                u, weights = concat_cost_single_stream(target_idx[a:], q[a - 1], q[a:], matching,
                                                       carry[0][0], carry[1],
                                                       concat_weight=concat_weight)
        sel_u = torch.cat([sel_u[:lead], u])
        weights = torch.cat([torch.full((lead,), concat_weight, device=q.device), weights])
    out, harm = _smoothed(synth, harmonics, sel_u, sel_p, opt_enabled)
    sel = sel_u[:, None] if sel_p is None else torch.stack([sel_u, sel_p], dim=1)
    return out, shifted, harm, sel, weights


@torch.no_grad()
def match_utterance_stream(query_seq, query_f0, matching_list: torch.Tensor,
                           synth_list: torch.Tensor, matching_f0: torch.Tensor,
                           harmonics_list: torch.Tensor | None, ckpt_type: str,
                           post_opt: PostOpt, scan_from: int, carry: tuple | None,
                           topk: int = 4, matcher: str = "approx",
                           query_f0_log_median: float | None = None):
    """One streaming window of the post_opt match with cross-chunk concat
    continuity, on the pool's device. `carry` is (picks (L, k), weight) of
    the previous chunk's last emitted frame, None for the first chunk;
    `scan_from` is the window-local index of the first frame this chunk
    owns. Returns (out (Ts, D), shifted (T,), harm (Ts, 49) or None,
    carry_at), where carry_at(emit_end) is the carry after window-local
    frame emit_end - 1, for the next chunk. Everything stays on the device."""
    if matcher not in ("exact", "approx"):
        raise ValueError(f"the carried streaming match takes matcher 'exact' or 'approx', not "
                         f"{matcher!r} (the sharded matchers match each window alone, "
                         "match_utterance)")
    device = synth_list.device
    q = torch.as_tensor(query_seq).to(device=device, dtype=torch.float32)
    qf0 = torch.as_tensor(query_f0).to(device=device, dtype=torch.float32)
    use_harm = uses_harmonics(ckpt_type)
    if use_harm and harmonics_list is None:
        raise ValueError(f"{ckpt_type} needs the pool's harmonic amplitudes")
    if carry is not None:
        lanes = 2 if use_harm else 1
        if carry[0].numel() != lanes * topk:
            raise ValueError(f"the carry holds {tuple(carry[0].shape)} picks, expected "
                             f"({lanes}, {topk})")
        carry = (carry[0].reshape(lanes, topk), carry[1])
    out, shifted, harm, sel, weights = match_core_post_opt_stream(
        q, matching_list, synth_list, matching_f0, harmonics_list, qf0, query_f0_log_median,
        carry, topk=topk, use_harmonics=use_harm, concat_weight=post_opt.concat_weight,
        opt_enabled=post_opt.enabled, scan_from=scan_from)

    def carry_at(emit_end: int):
        """The carry after window-local frame emit_end - 1, the last frame
        this chunk emitted."""
        pos = emit_end - 1 - scan_from
        return sel[pos], weights[pos]

    return out, shifted, harm, carry_at


# ------------------------------------------------------- host-pool / bulk paths


SHARDED_MATCHERS = ("sharded", "sharded_int8")


@functools.lru_cache(maxsize=None)
def _default_pool_mesh(device_type: str = "cuda") -> Mesh:
    """One shared pool mesh per device type: every visible card on the pool
    axis, or the CPU as one shard. _prepare_ref_pool caches shards by mesh
    identity, so a fresh mesh per call would re-shard (re-upload) the whole
    target pool on every conversion."""
    if device_type == "cpu":
        return make_mesh(n_data=1, n_pool=1, devices=[torch.device("cpu")])
    return make_mesh(n_data=1, n_pool=torch.cuda.device_count())


def pool_mesh_for(device: torch.device, mesh: Mesh | None = None) -> Mesh:
    """The mesh a sharded matcher runs on: the caller's, else the default
    one of `device`'s type."""
    return mesh if mesh is not None else _default_pool_mesh(torch.device(device).type)


def check_sharded_int8(post_opt: PostOpt) -> None:
    """sharded_int8 keeps no fp32 matching rows, which the concat cost and
    the optimizer read."""
    if post_opt.enabled or post_opt.concat_weight != -1.0:
        raise ValueError("sharded_int8 serves no_post_opt configs only (concat/smoothness "
                         "read fp32 matching rows; use matcher='sharded')")


@dataclasses.dataclass
class ConversionFeatures:
    """Vocoder inputs of one source utterance: numpy arrays, or tensors on
    the device when a caller asked for them there (as_numpy=False)."""

    out_feats_weighted: np.ndarray | torch.Tensor                   # (T, D)
    shifted_query_f0: np.ndarray | torch.Tensor                     # (T,)
    harmonics_out_feats_weighted: np.ndarray | torch.Tensor | None = None  # (T, 49), mix only


def subset_key(src_path: str, ref_path: str) -> str:
    """Membership key of required_subset filtering (ref :1181)."""
    return os.path.basename(src_path).split(".")[0] + "/" + os.path.basename(ref_path)


def _prepare_ref_pool(ref_pool: SpeakerPool, need_fp32_matching: bool, need_harmonics: bool,
                      need_quantized: bool, device: torch.device, mesh: Mesh | None = None,
                      quantize_sharded: bool = False) -> dict:
    """The target pool's device copies, made once and memoized ON the pool
    object: SpeakerPool's concatenated views re-run np.concatenate on each
    access and quantize_pool is an O(P D) host pass, and a bulk run shares
    each target pool across every source speaker. Living on the pool, the
    copies are freed with it when the bulk loop's FIFO evicts it.

    With a mesh (the sharded matchers) the pool is sharded over its pool
    axis, keyed by the mesh object, and no dense copy of any pool array is
    made; quantize_sharded stores the matching rows int8."""
    prep = ref_pool.__dict__.setdefault("_device_prep", {})
    if "host_matching" not in prep:
        prep["host_matching"] = ref_pool.matching
    if mesh is not None:
        from knnsvc_torch.parallel.sharded_match import shard_speaker_pool

        key = "sharded_int8" if quantize_sharded else "sharded"
        if prep.get(f"{key}_mesh") is not mesh:
            prep[f"{key}_mesh"] = mesh
            prep[key] = shard_speaker_pool(
                prep["host_matching"], ref_pool.synth, ref_pool.f0,
                ref_pool.harmonics if need_harmonics else None, mesh,
                quantize_matching=quantize_sharded)
        return prep
    if prep.get("device") != device:
        host = prep["host_matching"]
        prep.clear()
        prep.update(device=device, host_matching=host)
    if "synth" not in prep:
        prep["synth"] = torch.from_numpy(ref_pool.synth).to(device)
        prep["f0"] = torch.from_numpy(ref_pool.f0).to(device)
    if need_fp32_matching and "matching" not in prep:
        prep["matching"] = torch.from_numpy(prep["host_matching"]).to(device)
    if need_harmonics and "harmonics" not in prep:
        prep["harmonics"] = torch.from_numpy(ref_pool.harmonics).to(device)
    if need_quantized and "quantized" not in prep:
        prep["quantized"] = quantize_pool(prep["host_matching"], device)
    return prep


def _to_numpy(x: torch.Tensor | None) -> np.ndarray | None:
    return None if x is None else x.detach().to(torch.float32).cpu().numpy()


@torch.no_grad()
def match_utterance(query_seq, query_f0, matching_list: torch.Tensor | None,
                    synth_list: torch.Tensor, matching_f0: torch.Tensor,
                    harmonics_list: torch.Tensor | None, ckpt_type: str, post_opt: PostOpt,
                    topk: int = 4, prioritize_f0: bool = True, matcher: str = "exact",
                    quantized: QuantizedPool | None = None, sharded=None,
                    as_numpy: bool = True,
                    query_f0_log_median: float | None = None) -> ConversionFeatures:
    """Convert one utterance against a prepared target pool on the pool's
    device. query_seq (T, D) and query_f0 (T,) are numpy or tensors.

    matcher: 'exact' and 'approx' (both exact search here) run `match_core`
    or `match_core_post_opt`; 'int8' (pass `quantized`) the step path: the
    int8 kNN, the register shift, the unpitched lane's concat-cost
    reselection, then the pitched lane's (one kernel launch each on a card),
    then the smoothness optimizer; 'sharded' and 'sharded_int8' (pass
    `sharded`, a ShardedPool; the dense pool arguments may be None) the
    match over a pool sharded on a mesh's pool axis, on the mesh's first
    device (parallel/sharded_match.py), the int8 one for no_post_opt only.
    as_numpy=False leaves the outputs on the device. query_f0_log_median
    overrides the query's own log-median in the register shift (None: the
    reference semantics)."""
    if not prioritize_f0:
        raise ValueError("prioritize_f0 is mandatory on the reference live path (ref :1375)")
    if matcher in SHARDED_MATCHERS:
        return _match_sharded(query_seq, query_f0, ckpt_type, post_opt, topk, sharded,
                              matcher, as_numpy, query_f0_log_median)
    if matcher not in ("exact", "approx", "int8"):
        raise ValueError(f"matcher must be 'exact', 'approx', 'int8', 'sharded' or "
                         f"'sharded_int8', not {matcher!r}")
    device = synth_list.device
    q = torch.as_tensor(query_seq).to(device=device, dtype=torch.float32)
    qf0 = torch.as_tensor(query_f0).to(device=device, dtype=torch.float32)
    use_harm = uses_harmonics(ckpt_type)
    if use_harm and harmonics_list is None:
        raise ValueError(f"{ckpt_type} needs the pool's harmonic amplitudes")

    if matcher in ("exact", "approx"):
        if matching_list is None:
            raise ValueError(f"matcher {matcher!r} needs the fp32 matching pool")
        args = (q, matching_list, synth_list, matching_f0, harmonics_list, qf0,
                query_f0_log_median)
        if not post_opt.enabled and post_opt.concat_weight == -1.0:
            out, shifted, harm = match_core(*args, topk=topk, use_harmonics=use_harm)
        else:
            out, shifted, harm = match_core_post_opt(
                *args, topk=topk, use_harmonics=use_harm,
                concat_weight=post_opt.concat_weight, opt_enabled=post_opt.enabled)
    else:
        if quantized is None:
            raise ValueError("matcher 'int8' needs the quantized pool")
        if post_opt.concat_weight != -1.0 and matching_list is None:
            raise ValueError("the concat cost reads the fp32 matching pool")
        nearest_nbrs, _ = knn_topk_quantized(q, quantized, k=KNN_CANDIDATES)
        shifted = shift_f0_to_target_register(qf0, matching_f0, query_f0_log_median)
        target_idx = nearest_nbrs[:, :topk]
        pitched_idx = (sort_by_f0_compatibility(shifted, matching_f0, nearest_nbrs)[:, :topk]
                       if use_harm else None)
        if post_opt.concat_weight != -1.0:
            with record_function("knnsvc.concat_cost"):
                target_idx = concat_cost_single(target_idx, q, matching_list,
                                                concat_weight=post_opt.concat_weight)
                if use_harm:
                    pitched_idx = concat_cost_single(pitched_idx, q, matching_list, shifted,
                                                     matching_f0,
                                                     concat_weight=post_opt.concat_weight)
        out, harm = _smoothed(synth_list, harmonics_list, target_idx, pitched_idx,
                              post_opt.enabled)
    return _features(out, shifted, harm, as_numpy)


def _features(out, shifted, harm, as_numpy: bool) -> ConversionFeatures:
    if not as_numpy:
        return ConversionFeatures(out, shifted, harm)
    return ConversionFeatures(_to_numpy(out), _to_numpy(shifted), _to_numpy(harm))


def _match_sharded(query_seq, query_f0, ckpt_type: str, post_opt: PostOpt, topk: int, sharded,
                   matcher: str, as_numpy: bool, qmed: float | None) -> ConversionFeatures:
    """match_utterance's sharded matchers: the fp32 core, or the int8 one
    when the pool holds int8 matching rows (as the JAX package dispatches)."""
    from knnsvc_torch.parallel.sharded_match import sharded_match_core, sharded_match_core_int8

    if sharded is None:
        raise ValueError(f"matcher={matcher!r} needs a ShardedPool (sharded=)")
    use_harm = uses_harmonics(ckpt_type)
    if sharded.matching_q8 is not None:
        check_sharded_int8(post_opt)
        out, shifted, harm = sharded_match_core_int8(
            query_seq, query_f0, sharded.matching_q8, sharded.inv_norms, sharded.synth,
            sharded.harmonics, sharded.f0, sharded.true_len, qmed, mesh=sharded.mesh,
            topk=topk, use_harmonics=use_harm)
    else:
        out, shifted, harm = sharded_match_core(
            query_seq, query_f0, sharded.matching, sharded.synth, sharded.harmonics, sharded.f0,
            sharded.true_len, qmed, mesh=sharded.mesh, topk=topk, use_harmonics=use_harm,
            concat_weight=post_opt.concat_weight, opt_enabled=post_opt.enabled)
    return _features(out, shifted, harm, as_numpy)


@torch.no_grad()
def match_at_inference_time(src_path: str | Path, ref_path: str | Path, wavlm,
                            match_weights: np.ndarray, synth_weights: np.ndarray,
                            topk: int = 4, prioritize_f0: bool = True,
                            ckpt_type: str = "wavlm_only",
                            required_subset: Iterable[str] | None = None,
                            post_opt: str = "no_post_opt", duration_limit: float | None = None,
                            query_pool: SpeakerPool | None = None,
                            ref_pool: SpeakerPool | None = None,
                            matcher: str = "exact",
                            mesh: Mesh | None = None) -> dict[str, ConversionFeatures]:
    """Every source utterance against the target pool, on the encoder's
    device: {source utterance path: ConversionFeatures (numpy)}. Pools may
    be passed in to reuse them across pairs (the reference rebuilds them,
    its cache force-disabled, ref :1086-1087). The sharded matchers shard
    the target pool over `mesh`'s pool axis (default: every card, or the
    CPU) and make no dense copy of it."""
    popt = PostOpt.parse(post_opt)
    if matcher == "sharded_int8":
        check_sharded_int8(popt)
    required = set(required_subset) if required_subset is not None else None
    with record_function("knnsvc.speaker_pool"):
        if query_pool is None:
            query_pool = build_speaker_pool(src_path, wavlm, match_weights, synth_weights)
        if ref_pool is None:
            ref_pool = build_speaker_pool(ref_path, wavlm, match_weights, synth_weights,
                                          duration_limit=duration_limit)
    # the fp32 matching pool goes to the device only when something reads it:
    # the int8 matcher's search does not, its concat cost does
    need_fp32 = matcher != "int8" or popt.concat_weight != -1.0
    device = next(wavlm.parameters()).device
    sharded = matcher in SHARDED_MATCHERS
    prep = _prepare_ref_pool(ref_pool, need_fp32, uses_harmonics(ckpt_type),
                             matcher == "int8", device,
                             mesh=pool_mesh_for(device, mesh) if sharded else None,
                             quantize_sharded=matcher == "sharded_int8")
    results: dict[str, ConversionFeatures] = {}
    for item, pools in query_pool.utterances.items():
        if required is not None and subset_key(item, str(ref_path)) not in required:
            continue
        results[item] = match_utterance(
            pools.matching, pools.f0, prep.get("matching"), prep.get("synth"), prep.get("f0"),
            prep.get("harmonics"), ckpt_type, popt, topk=topk, prioritize_f0=prioritize_f0,
            matcher=matcher, quantized=prep.get("quantized"),
            sharded=prep.get(matcher) if sharded else None)
    return results


@torch.no_grad()
def match_utterances_batched(qs, qf0s, matching: torch.Tensor | None, synth: torch.Tensor | None,
                             pool_f0: torch.Tensor | None, harmonics: torch.Tensor | None,
                             ckpt_type: str, post_opt: PostOpt, topk: int = 4,
                             matcher: str = "approx", mesh: Mesh | None = None, sharded=None):
    """A batch of equal-length queries (B, Tb, D) with f0 (B, Tb) against one
    target pool -> (out (B, Tb, D), shifted f0 (B, Tb), harmonics (B, Tb,
    49) or None), on the pool's device. The kNN runs as one block over the
    batch's B * Tb rows (each row's search is independent of the others);
    the register shift uses each utterance's own median, and the concat
    cost and smoothness, serial in frames, run per utterance — per
    utterance the result is `match_utterance`'s. The JAX package vmaps its
    fused core instead.

    mesh (dense matchers): the batch split over its data axis, B / n_data
    utterances per grid row on the row's first device with the pool
    replicated there; the outputs come back to the mesh's first device.
    matcher 'sharded' / 'sharded_int8' (pass `sharded`, a ShardedPool on a
    (data, pool) mesh): the batch over the data axis and the pool over the
    pool axis (parallel/sharded_match.py's batched cores)."""
    use_harm = uses_harmonics(ckpt_type)
    if matcher in SHARDED_MATCHERS:
        from knnsvc_torch.parallel.sharded_match import (sharded_match_core_batch,
                                                         sharded_match_core_int8_batch)

        if sharded is None:
            raise ValueError(f"matcher={matcher!r} needs a ShardedPool (sharded=)")
        if sharded.matching_q8 is not None:
            check_sharded_int8(post_opt)
            return sharded_match_core_int8_batch(
                qs, qf0s, sharded.matching_q8, sharded.inv_norms, sharded.synth,
                sharded.harmonics, sharded.f0, sharded.true_len, mesh=sharded.mesh, topk=topk,
                use_harmonics=use_harm)
        return sharded_match_core_batch(
            qs, qf0s, sharded.matching, sharded.synth, sharded.harmonics, sharded.f0,
            sharded.true_len, mesh=sharded.mesh, topk=topk, use_harmonics=use_harm,
            concat_weight=post_opt.concat_weight, opt_enabled=post_opt.enabled)
    if matcher not in ("exact", "approx"):
        raise ValueError(f"the batched match takes matcher 'exact', 'approx', 'sharded' or "
                         f"'sharded_int8', not {matcher!r}")
    qs, qf0s = torch.as_tensor(qs), torch.as_tensor(qf0s)
    if mesh is None:
        return _match_batch_dense(qs, qf0s, matching, synth, pool_f0, harmonics, use_harm,
                                  post_opt, topk)
    n_data = mesh.shape["data"]
    if qs.shape[0] % n_data != 0:
        raise ValueError(f"mesh 'data' axis ({n_data}) must divide the batch ({qs.shape[0]})")
    per = qs.shape[0] // n_data
    parts = []
    for d in range(n_data):
        dev = mesh.devices[d][0]
        on = lambda t: None if t is None else t.to(dev)
        parts.append(_match_batch_dense(qs[d * per:(d + 1) * per], qf0s[d * per:(d + 1) * per],
                                        on(matching), on(synth), on(pool_f0), on(harmonics),
                                        use_harm, post_opt, topk))
    first = mesh.first
    cat = lambda i: torch.cat([p[i].to(first) for p in parts])
    return cat(0), cat(1), (cat(2) if use_harm else None)


def _match_batch_dense(qs, qf0s, matching, synth, pool_f0, harmonics, use_harm: bool,
                       post_opt: PostOpt, topk: int):
    """match_utterances_batched's dense body on the pool's device."""
    device = synth.device
    qs = qs.to(device=device, dtype=torch.float32)
    qf0s = qf0s.to(device=device, dtype=torch.float32)
    B, Tb, D = qs.shape
    with record_function("knnsvc.knn"):
        nearest_all, _ = knn_topk(qs.reshape(B * Tb, D), matching, k=KNN_CANDIDATES)
    nearest_all = nearest_all.reshape(B, Tb, -1)
    outs, shifts, harms = [], [], []
    for b in range(B):
        nearest_nbrs = nearest_all[b]
        shifted = shift_f0_to_target_register(qf0s[b], pool_f0)
        target_idx = nearest_nbrs[:, :topk]
        pitched_idx = (sort_by_f0_compatibility(shifted, pool_f0, nearest_nbrs)[:, :topk]
                       if use_harm else None)
        if post_opt.concat_weight != -1.0:
            with record_function("knnsvc.concat_cost"):
                if use_harm:
                    target_idx, pitched_idx = concat_cost_pair(
                        target_idx, pitched_idx, qs[b], matching, shifted, pool_f0,
                        concat_weight=post_opt.concat_weight)
                else:
                    target_idx = concat_cost_single(target_idx, qs[b], matching,
                                                    concat_weight=post_opt.concat_weight)
        out, harm = _smoothed(synth, harmonics, target_idx, pitched_idx, post_opt.enabled)
        outs.append(out)
        harms.append(harm)
        shifts.append(shifted)
    return torch.stack(outs), torch.stack(shifts), (torch.stack(harms) if use_harm else None)
