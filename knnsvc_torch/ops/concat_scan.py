"""Concatenation-cost reselection: the wrapper of the hand-written CUDA
kernel (csrc/concat_cost_pair.cu) and its plain PyTorch version.

Counterpart of knnsvc_tpu/ops/concat_scan.py::concat_cost_pair_pallas, the
Pallas TPU kernel (pl.pallas_call at concat_scan.py:182): the serial
per-frame reselection of match/concat_cost.py over stacked lanes, k = 4.

The wrapper computes the row-normalized source, the continuity baselines
and the log2 f0 tracks with the same torch ops as the plain version
(match/concat_cost.scan_inputs), so kernel and plain version differ only in
the order of their dot-product sums. CPU tensors take the plain version
(match/concat_cost.concat_cost_scan). A CUDA tensor launches the kernel or
raises; nothing falls back.
"""

from __future__ import annotations

import ctypes

import torch

from knnsvc_torch.match.concat_cost import concat_cost_scan, scan_inputs

KERNEL = "concat_cost_pair"
K = 4                            # picks per lane: the reference's live top-k
# bytes of dynamic shared memory: a Hopper block's 227 KB less 1 KB for the
# kernel's static arrays
SMEM_LIMIT = 226 * 1024
SMEM_ROWS = 2 * 2 * K + 1        # two candidate buffers and the source row


def _check_inputs(lanes, src, tgt, shifted_src_f0, tgt_f0) -> None:
    """Devices, integer ids and shapes, on every device."""
    T, D = src.shape
    P = tgt.shape[0]
    named = [("tgt", tgt, (P, D)), ("shifted_src_f0", shifted_src_f0, (T,)),
             ("tgt_f0", tgt_f0, (P,))]
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
    """What the CUDA kernel is compiled for."""
    if k != K:
        raise ValueError(f"the CUDA concat-cost kernel is compiled for k={K} (the "
                         f"reference's top-k), got k={k}; other k on the card are still "
                         "to port (ROADMAP.md, Queue 2 item 2)")
    if D % 4:
        raise ValueError(f"the CUDA concat-cost kernel loads rows as float4: D={D} is "
                         "not a multiple of 4")
    if SMEM_ROWS * D * 4 > SMEM_LIMIT:
        raise ValueError(f"D={D} needs {SMEM_ROWS * D * 4} bytes of shared memory, "
                         f"more than the {SMEM_LIMIT} a block has")


def _check_kernel_tensors(**tensors) -> None:
    for name, t in tensors.items():
        if t is None:
            continue
        if t.dtype != (torch.int32 if name == "idx" else torch.float32):
            raise TypeError(f"{name} must be {'int32' if name == 'idx' else 'float32'}, "
                            f"got {t.dtype}")
        if not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError(f"{name} must be contiguous and 16-byte aligned")


def _concat_cost_lanes(lanes: list[torch.Tensor], pitched: tuple[bool, ...],
                       src: torch.Tensor, tgt: torch.Tensor,
                       shifted_src_f0: torch.Tensor | None, tgt_f0: torch.Tensor | None,
                       concat_weight: float) -> torch.Tensor:
    """Stacked lanes of (T, k) ids -> (T, L, k) int64 selections."""
    _check_inputs(lanes, src, tgt, shifted_src_f0, tgt_f0)
    if src.device.type == "cpu":
        svn, baselines, src_lf0, tgt_lf0 = scan_inputs(src, shifted_src_f0, tgt_f0)
        return concat_cost_scan(torch.stack(lanes, dim=1), svn, tgt, baselines,
                                src_lf0, tgt_lf0, pitched, concat_weight)
    if src.device.type != "cuda":
        raise ValueError(f"the concat-cost reselection runs on cpu or cuda, not {src.device}")
    T, D = src.shape
    P = tgt.shape[0]
    _check_kernel_shape(lanes[0].shape[1], D)
    if src.dtype != torch.float32:
        raise TypeError(f"src must be float32, got {src.dtype}")
    idx = torch.stack(lanes, dim=1).to(torch.int32).contiguous()      # (T, L, K)
    svn, baselines, src_lf0, tgt_lf0 = scan_inputs(src, shifted_src_f0, tgt_f0)
    _check_kernel_tensors(idx=idx, svn=svn, tgt=tgt, baselines=baselines,
                          src_lf0=src_lf0, tgt_lf0=tgt_lf0)
    from knnsvc_torch.ops.build import check_launch, load_kernel

    lib = load_kernel(KERNEL)
    fn = lib.concat_cost_pair_f32
    fn.restype = ctypes.c_int
    fn.argtypes = ([ctypes.c_void_p] * 7 + [ctypes.c_int] * 5
                   + [ctypes.c_float, ctypes.c_void_p])
    out = torch.empty_like(idx)
    pitched_mask = sum(1 << i for i, p in enumerate(pitched) if p)
    with torch.cuda.device(src.device):
        stream = torch.cuda.current_stream(src.device).cuda_stream
        code = fn(idx.data_ptr(), svn.data_ptr(), tgt.data_ptr(), baselines.data_ptr(),
                  None if src_lf0 is None else src_lf0.data_ptr(),
                  None if tgt_lf0 is None else tgt_lf0.data_ptr(),
                  out.data_ptr(), T, P, D, len(lanes), pitched_mask, concat_weight, stream)
    check_launch(lib, KERNEL, code)
    concat_cost_pair.launches += 1
    return out.long()


def concat_cost_pair(idx_unpitched: torch.Tensor, idx_pitched: torch.Tensor,
                     src: torch.Tensor, tgt: torch.Tensor, shifted_src_f0: torch.Tensor,
                     tgt_f0: torch.Tensor, concat_weight: float = 0.2):
    """Both post_opt reselections, lane 0 unpitched and lane 1 pitched, in
    one launch (one thread block per lane). idx (T, 4) each; src (T, D);
    tgt (P, D); f0 (T,) and (P,) in Hz. -> (unpitched (T, 4), pitched
    (T, 4)) int64. CUDA tensors add one to `concat_cost_pair.launches`."""
    out = _concat_cost_lanes([idx_unpitched, idx_pitched], (False, True), src, tgt,
                             shifted_src_f0, tgt_f0, concat_weight)
    return out[:, 0], out[:, 1]


def concat_cost_single(idx: torch.Tensor, src: torch.Tensor, tgt: torch.Tensor,
                       shifted_src_f0: torch.Tensor | None = None,
                       tgt_f0: torch.Tensor | None = None,
                       concat_weight: float = 0.2) -> torch.Tensor:
    """One lane on the same kernel (one block), pitched when both f0 tracks
    are given: the `wavlm_only` reselection. -> (T, 4) int64. CUDA tensors
    add one to `concat_cost_pair.launches`."""
    pitched = shifted_src_f0 is not None
    return _concat_cost_lanes([idx], (pitched,), src, tgt, shifted_src_f0,
                              tgt_f0 if pitched else None, concat_weight)[:, 0]


concat_cost_pair.launches = 0
