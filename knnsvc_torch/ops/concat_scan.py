"""Concatenation-cost reselection: the wrapper of the hand-written CUDA
kernel (csrc/concat_cost_pair.cu) and its plain PyTorch version.

Counterpart of knnsvc_tpu/ops/concat_scan.py::concat_cost_pair_pallas, the
Pallas TPU kernel (pl.pallas_call at concat_scan.py:182): the serial
per-frame reselection of match/concat_cost.py over stacked lanes, for any
k in 1..MAX_K. One call launches the kernel's pre-pass (pool norms and the
own candidates' source dots) and its chain (one block per lane) and counts
one launch. The chain keeps its candidate rows in shared memory while 9 k D
floats fit (at D = 1024: k <= 6) and reads them from L2 above. Rows of any
width D >= 1 are taken: when D % 4 == 0 they move by TMA bulk copies and
float4 loads, otherwise by 4-byte copies and scalar loads into rows padded
to a multiple of 4 with zeros.

The wrapper computes the row-normalized source, the continuity baselines
and the log2 f0 tracks with the same torch ops as the plain version
(match/concat_cost.scan_inputs), so kernel and plain version differ only in
the order of their dot-product sums. CPU tensors take the plain version
(match/concat_cost.concat_cost_scan). A CUDA tensor launches the kernel or
raises; nothing falls back.

The sharded entries (`concat_cost_pair_sharded`, `concat_cost_single_sharded`)
read a pool split over a mesh's pool axis (parallel/): a list of S shard
tensors of shard_len rows each and the unpadded pool length. The kernel
takes a device table of the shard base pointers (row g is in shard
g / shard_len); the dense entries pass a table of one. Shards on another
card than the source need peer access to it: the wrapper checks it and
enables it, and raises where it is missing. On the CPU the plain version
reads the rows through parallel/mesh.gather_rows.

The streaming entries (`concat_cost_pair_stream`, `concat_cost_single_stream`)
continue the recurrence from a cross-chunk carry in the same single launch:
the carry goes in as frame 0 (the kernel passes frame 0 through and stages
its rows as frame 1's previous picks), and the pitched lanes start from the
carried weight, the kernel's one extra argument. The weight after each
frame is the plain version's torch ops on the baselines, not the kernel's.
"""

from __future__ import annotations

import collections
import ctypes
import functools

import torch


KERNEL = "concat_cost_pair"
MAX_K = 32   # picks per lane the kernel takes: the kNN sets' width (match/pipeline.py)


def _check_inputs(lanes, src, shards, pool_len, shifted_src_f0, tgt_f0) -> None:
    """Devices, integer ids and shapes, on every device."""
    T, D = src.shape
    shard_len = shards[0].shape[0]
    if not 1 <= pool_len <= len(shards) * shard_len:
        raise ValueError(f"pool_len {pool_len} does not fit {len(shards)} shards of "
                         f"{shard_len} rows")
    for i, t in enumerate(shards):
        name = "tgt" if len(shards) == 1 else f"shard {i}"
        if tuple(t.shape) != (shard_len, D):
            raise ValueError(f"{name} has shape {tuple(t.shape)}, expected {(shard_len, D)}")
        if t.device != src.device and not (t.is_cuda and src.is_cuda):   # peers: _shard_table
            raise ValueError(f"{name} is on {t.device}, src on {src.device}")
    named = [("shifted_src_f0", shifted_src_f0, (T,)), ("tgt_f0", tgt_f0, (pool_len,))]
    named += [(f"lane {i} ids", x, (T, lanes[0].shape[1])) for i, x in enumerate(lanes)]
    for name, t, shape in named:
        if t is None:
            continue
        if t.device != src.device:
            raise ValueError(f"{name} is on {t.device}, src on {src.device}")
        if tuple(t.shape) != shape:
            raise ValueError(f"{name} has shape {tuple(t.shape)}, expected {shape}")
    for i, x in enumerate(lanes):
        if x.dtype.is_floating_point or x.dtype.is_complex or x.dtype == torch.bool:
            raise TypeError(f"lane {i} ids must be integers, got {x.dtype}")


def _check_kernel_shape(k: int, D: int) -> None:
    """What the CUDA kernel takes: every row width D >= 1, and k picks up
    to MAX_K."""
    if not 1 <= k <= MAX_K:
        raise ValueError(f"the CUDA concat-cost kernel takes 1 <= k <= {MAX_K}, got k={k}")
    if D < 1:
        raise ValueError(f"the CUDA concat-cost kernel takes rows of D >= 1 floats, got D={D}")


def _library():
    """The kernel's library (built on first use) with its C functions typed."""
    from knnsvc_torch.ops.build import load_kernel

    lib = load_kernel(KERNEL)
    ptr, i32 = ctypes.c_void_p, ctypes.c_int
    f32 = ctypes.c_float
    for fn, args in ((lib.concat_cost_pair_f32,
                      [ptr] * 3 + [i32] * 2 + [ptr] * 6 + [i32] * 6 + [f32, f32, ptr]),
                     (lib.concat_cost_prepass_f32,
                      [ptr] * 3 + [i32] * 2 + [ptr] * 2 + [i32] * 5 + [ptr]),
                     (lib.concat_cost_enable_peer_access, [i32])):
        fn.restype, fn.argtypes = i32, args
    return lib


_TABLES: collections.OrderedDict = collections.OrderedDict()
_MAX_TABLES = 64


def _shard_table(shards: list[torch.Tensor], device: torch.device) -> torch.Tensor:
    """The device array of the shards' base pointers, made once per set of
    pointers (an LRU of a few; the table holds nothing but the pointers, so
    a reused address gets the right table). Shards on another card than
    `device` must be readable from it: peer access is checked and enabled,
    and its absence raises."""
    from knnsvc_torch.ops.build import check_launch

    ptrs = tuple(t.data_ptr() for t in shards)
    key = (device, ptrs)
    if key in _TABLES:
        _TABLES.move_to_end(key)
        return _TABLES[key]
    for t in shards:
        if t.device != device:
            if not torch.cuda.can_device_access_peer(device.index, t.device.index):
                raise ValueError(f"a pool shard on {t.device} is not readable from {device}: "
                                 "the concat-cost kernel needs peer access between the cards")
            with torch.cuda.device(device):
                lib = _library()
                check_launch(lib, KERNEL, lib.concat_cost_enable_peer_access(t.device.index))
    table = torch.tensor(ptrs, dtype=torch.int64, device=device)
    _TABLES[key] = table
    if len(_TABLES) > _MAX_TABLES:
        _TABLES.popitem(last=False)
    return table


def concat_cost_prepass(idx: torch.Tensor, svn: torch.Tensor, tgt: torch.Tensor):
    """The kernel's pre-pass alone on the card, for timing it: idx (T, L, k)
    int32, svn (T, D), tgt (P, D) -> (pool norms (P,), source dots (2, T,
    L, k): [0] own candidate . svn[t], [1] min(own candidate + 1, P - 1) .
    svn[t + 1], 0 at t = T - 1). Counts no launch: the reselection's call
    does."""
    from knnsvc_torch.ops.build import check_launch

    T, L, k = idx.shape
    P, D = tgt.shape
    if not (idx.is_cuda and svn.is_cuda and tgt.is_cuda):
        raise ValueError("the concat-cost pre-pass runs on CUDA tensors only")
    if tuple(svn.shape) != (T, D):
        raise ValueError(f"svn has shape {tuple(svn.shape)}, expected {(T, D)}")
    _check_kernel_shape(k, D)
    _check_kernel_tensors(D, idx=idx, svn=svn, tgt=tgt)
    pnorm = tgt.new_empty(P)
    osd = tgt.new_empty((2, T, L, k))
    lib = _library()
    table = _shard_table([tgt], tgt.device)
    with torch.cuda.device(tgt.device):
        stream = torch.cuda.current_stream(tgt.device).cuda_stream
        code = lib.concat_cost_prepass_f32(idx.data_ptr(), svn.data_ptr(), table.data_ptr(), P,
                                           1, pnorm.data_ptr(), osd.data_ptr(), T, P, D, L, k,
                                           stream)
    check_launch(lib, KERNEL, code)
    return pnorm, osd


def _check_kernel_tensors(D: int, **tensors) -> None:
    """dtype and layout; rows of D % 4 != 0 floats are read 4 bytes at a
    time, so svn and the pool need only 4-byte alignment then."""
    for name, t in tensors.items():
        if t is None:
            continue
        if t.dtype != (torch.int32 if name == "idx" else torch.float32):
            raise TypeError(f"{name} must be {'int32' if name == 'idx' else 'float32'}, "
                            f"got {t.dtype}")
        rows = name == "svn" or name == "tgt" or name.startswith("shard ")
        align = 4 if rows and D % 4 else 16
        if not t.is_contiguous() or t.data_ptr() % align:
            raise ValueError(f"{name} must be contiguous and {align}-byte aligned")


def _concat_cost_lanes(lanes: list[torch.Tensor], pitched: tuple[bool, ...],
                       src: torch.Tensor, shards: list[torch.Tensor], pool_len: int,
                       shifted_src_f0: torch.Tensor | None, tgt_f0: torch.Tensor | None,
                       concat_weight: float, pitched_weight: float | None = None):
    """Stacked lanes of (T, k) ids -> ((T, L, k) int64 selections, the
    continuity baselines (T-1,)), the pool's pool_len rows held in `shards`
    (one tensor for a dense pool). The pitched lanes' weight starts at
    pitched_weight (default concat_weight)."""
    # imported here: importing knnsvc_torch.match runs its pipeline, which
    # imports this module
    from knnsvc_torch.match.concat_cost import concat_cost_scan, scan_inputs

    _check_inputs(lanes, src, shards, pool_len, shifted_src_f0, tgt_f0)
    init_weight = concat_weight if pitched_weight is None else pitched_weight
    if src.device.type == "cpu":
        from knnsvc_torch.parallel.mesh import gather_rows

        svn, baselines, src_lf0, tgt_lf0 = scan_inputs(src, shifted_src_f0, tgt_f0)
        rows = shards[0] if len(shards) == 1 else functools.partial(gather_rows, shards)
        return concat_cost_scan(torch.stack(lanes, dim=1), svn, rows, baselines, src_lf0,
                                tgt_lf0, pitched, concat_weight, init_weight,
                                pool_len=pool_len), baselines
    if src.device.type != "cuda":
        raise ValueError(f"the concat-cost reselection runs on cpu or cuda, not {src.device}")
    T, D = src.shape
    k = lanes[0].shape[1]
    _check_kernel_shape(k, D)
    if src.dtype != torch.float32:
        raise TypeError(f"src must be float32, got {src.dtype}")
    idx = torch.stack(lanes, dim=1).to(torch.int32).contiguous()      # (T, L, k)
    svn, baselines, src_lf0, tgt_lf0 = scan_inputs(src, shifted_src_f0, tgt_f0)
    _check_kernel_tensors(D, idx=idx, svn=svn, baselines=baselines, src_lf0=src_lf0,
                          tgt_lf0=tgt_lf0,
                          **{("tgt" if len(shards) == 1 else f"shard {i}"): t
                             for i, t in enumerate(shards)})
    from knnsvc_torch.ops.build import check_launch

    lib = _library()
    table = _shard_table(shards, src.device)
    out = torch.empty_like(idx)
    pnorm = src.new_empty(pool_len)           # scratch of the pre-pass
    osd = src.new_empty((2, T, len(lanes), k))
    pitched_mask = sum(1 << i for i, p in enumerate(pitched) if p)
    with torch.cuda.device(src.device):
        stream = torch.cuda.current_stream(src.device).cuda_stream
        code = lib.concat_cost_pair_f32(
            idx.data_ptr(), svn.data_ptr(), table.data_ptr(), shards[0].shape[0], len(shards),
            baselines.data_ptr(), None if src_lf0 is None else src_lf0.data_ptr(),
            None if tgt_lf0 is None else tgt_lf0.data_ptr(), pnorm.data_ptr(),
            osd.data_ptr(), out.data_ptr(), T, pool_len, D, len(lanes), k, pitched_mask,
            concat_weight, init_weight, stream)
    check_launch(lib, KERNEL, code)
    concat_cost_pair.launches += 1
    return out.long(), baselines


def concat_cost_pair(idx_unpitched: torch.Tensor, idx_pitched: torch.Tensor,
                     src: torch.Tensor, tgt: torch.Tensor, shifted_src_f0: torch.Tensor,
                     tgt_f0: torch.Tensor, concat_weight: float = 0.2):
    """Both post_opt reselections, lane 0 unpitched and lane 1 pitched, in
    one launch (one chain block per lane). idx (T, k) each; src (T, D);
    tgt (P, D); f0 (T,) and (P,) in Hz. -> (unpitched (T, k), pitched
    (T, k)) int64. CUDA tensors add one to `concat_cost_pair.launches`."""
    out, _ = _concat_cost_lanes([idx_unpitched, idx_pitched], (False, True), src, [tgt],
                                tgt.shape[0], shifted_src_f0, tgt_f0, concat_weight)
    return out[:, 0], out[:, 1]


def concat_cost_single(idx: torch.Tensor, src: torch.Tensor, tgt: torch.Tensor,
                       shifted_src_f0: torch.Tensor | None = None,
                       tgt_f0: torch.Tensor | None = None,
                       concat_weight: float = 0.2) -> torch.Tensor:
    """One lane on the same kernel (one block), pitched when both f0 tracks
    are given: the `wavlm_only` reselection. -> (T, k) int64. CUDA tensors
    add one to `concat_cost_pair.launches`."""
    pitched = shifted_src_f0 is not None
    return _concat_cost_lanes([idx], (pitched,), src, [tgt], tgt.shape[0], shifted_src_f0,
                              tgt_f0 if pitched else None, concat_weight)[0][:, 0]


def concat_cost_pair_sharded(idx_unpitched: torch.Tensor, idx_pitched: torch.Tensor,
                             src: torch.Tensor, shards: list[torch.Tensor], pool_len: int,
                             shifted_src_f0: torch.Tensor, tgt_f0: torch.Tensor,
                             concat_weight: float = 0.2):
    """`concat_cost_pair` on a pool split into shards: S tensors of
    shard_len rows (zero padding at the end), pool_len of those rows real;
    tgt_f0 (pool_len,). One launch reads every shard through the pointer
    table. -> (unpitched (T, k), pitched (T, k)) int64. CUDA tensors add
    one to `concat_cost_pair.launches`."""
    out, _ = _concat_cost_lanes([idx_unpitched, idx_pitched], (False, True), src, list(shards),
                                pool_len, shifted_src_f0, tgt_f0, concat_weight)
    return out[:, 0], out[:, 1]


def concat_cost_single_sharded(idx: torch.Tensor, src: torch.Tensor, shards: list[torch.Tensor],
                               pool_len: int, shifted_src_f0: torch.Tensor | None = None,
                               tgt_f0: torch.Tensor | None = None,
                               concat_weight: float = 0.2) -> torch.Tensor:
    """`concat_cost_single` (the `wavlm_only` lane) on a sharded pool, as
    `concat_cost_pair_sharded`. -> (T, k) int64. CUDA tensors add one to
    `concat_cost_pair.launches`."""
    pitched = shifted_src_f0 is not None
    return _concat_cost_lanes([idx], (pitched,), src, list(shards), pool_len, shifted_src_f0,
                              tgt_f0 if pitched else None, concat_weight)[0][:, 0]


def _stream_lanes(lanes, pitched, prev_idx, prev_src, src, tgt, shifted_src_f0, tgt_f0,
                  prev_weight, concat_weight):
    """One launch over [carry | T frames] -> ((T, L, k) picks, the weight
    after each frame (T,)). The carried weight is read to the host once (a
    4-byte copy) for the kernel's argument."""
    from knnsvc_torch.match.concat_cost import carried_inputs, scan_inputs, sticky_weights

    if prev_src.device != src.device or prev_idx.device != src.device:
        raise ValueError(f"the carry is on {prev_idx.device} and {prev_src.device}, "
                         f"src on {src.device}")
    lanes, src_all, f0_all = carried_inputs(lanes, prev_idx, prev_src, src, shifted_src_f0)
    w0 = float(prev_weight)
    out, baselines = _concat_cost_lanes(lanes, pitched, src_all, [tgt], tgt.shape[0], f0_all,
                                        tgt_f0, concat_weight, pitched_weight=w0)
    return out[1:], sticky_weights(baselines, w0, any(pitched))


def concat_cost_pair_stream(idx_unpitched: torch.Tensor, idx_pitched: torch.Tensor,
                            prev_src: torch.Tensor, src: torch.Tensor, tgt: torch.Tensor,
                            shifted_src_f0: torch.Tensor, tgt_f0: torch.Tensor,
                            prev_idx: torch.Tensor, prev_weight: float | torch.Tensor,
                            concat_weight: float = 0.2):
    """Both post_opt reselections of a streaming chunk, continuing from the
    carry (prev_idx (2, k): the previous frame's unpitched and pitched
    picks, in the order they were emitted; prev_src (D,): its source row;
    prev_weight: the pitched lane's weight after it), in one launch.
    -> (unpitched (T, k), pitched (T, k), the pitched weight after each
    frame (T,)); the plain version is match/concat_cost.concat_cost_pair_stream_core.
    CUDA tensors add one to `concat_cost_pair.launches`."""
    out, w = _stream_lanes([idx_unpitched, idx_pitched], (False, True), prev_idx, prev_src,
                           src, tgt, shifted_src_f0, tgt_f0, prev_weight, concat_weight)
    return out[:, 0], out[:, 1], w


def concat_cost_single_stream(idx: torch.Tensor, prev_src: torch.Tensor, src: torch.Tensor,
                              tgt: torch.Tensor, prev_idx: torch.Tensor,
                              prev_weight: float | torch.Tensor,
                              shifted_src_f0: torch.Tensor | None = None,
                              tgt_f0: torch.Tensor | None = None,
                              concat_weight: float = 0.2):
    """One lane of a streaming chunk (the `wavlm_only` reselection),
    continuing from the carry prev_idx (k,), prev_src (D,) and prev_weight;
    pitched when both f0 tracks are given. -> (selections (T, k), the
    weight after each frame (T,)). CUDA tensors add one to
    `concat_cost_pair.launches`."""
    pitched = shifted_src_f0 is not None
    out, w = _stream_lanes([idx], (pitched,), prev_idx, prev_src, src, tgt, shifted_src_f0,
                           tgt_f0 if pitched else None, prev_weight, concat_weight)
    return out[:, 0], w


concat_cost_pair.launches = 0
