"""The smoothness optimizer on the card: the wrapper of the hand-written CUDA
kernel (csrc/smoothness_adam.cu), which runs a whole optimizer call (every
Adam step and the early stop) in one persistent cooperative launch.

Replaces no TPU kernel: the JAX package runs the optimizer as one jitted
lax.while_loop (knnsvc_tpu/match/smoothness.py:182). Its plain version is
the loop of match/smoothness.py, which CPU tensors take; a CUDA tensor
launches the kernel or raises, and nothing falls back.

The grid adapts to the call: `plan_grid` gives blocks of 256 threads, one
an SM, or, where a frame's columns fit 64 threads (the harmonics' D = 49),
blocks of 64 threads, four an SM; fewer where T is small (at least
MIN_FRAMES frames a block). Each block takes a contiguous range of frames
and one halo frame on each side, and a ring of 3 or 2 frames' rows in
shared memory where they fit (at k = 4 up to D ~1280 and ~1750), else
none (both reads of a frame from device memory).
"""

from __future__ import annotations

import ctypes
import dataclasses

import numpy as np
import torch

KERNEL = "smoothness_adam"
MAX_K = 32           # the kNN sets' width (match/pipeline.py)
MIN_FRAMES = 4       # frames a block at least, so small T takes few blocks
THREADS = (256, 64)  # threads a block (csrc/smoothness_adam.cu), 64 for narrow rows
MAX_WARPS = 8        # the reduction buffers' warps
STATIC_SMEM = 1024   # room left for the kernel's static shared memory
BLOCK_RESERVE = 1024 # shared memory the card keeps for each resident block


@dataclasses.dataclass(frozen=True)
class GridPlan:
    T: int
    blocks: int
    threads: int
    slots: int                      # frames of rows in the shared-memory ring (0: none)
    smem_bytes: int                 # dynamic shared memory a block

    @property
    def ranges(self) -> list[tuple[int, int]]:
        """Each block's own frames [f0, f1), as the kernel derives them
        from its block index."""
        return [(b * self.T // self.blocks, (b + 1) * self.T // self.blocks)
                for b in range(self.blocks)]

    @property
    def halos(self) -> list[tuple[int, int]]:
        """The frames each block streams, lo .. hi inclusive: its own and
        one on each side."""
        return [(max(f0 - 1, 0), min(f1, self.T - 1)) for f0, f1 in self.ranges]


def smem_bytes(k: int, D: int, slots: int) -> int:
    """Dynamic shared memory of a block (csrc/smoothness_adam.cu::smem_bytes):
    the ring, e of 3 frames, two reduction buffers of 8 warps x (k + 2)
    floats, the halo replicas (2 frames x 4 arrays x k)."""
    return 4 * (slots * k * 3 * D + 9 * D + 2 * MAX_WARPS * (k + 2) + 8 * k)


def plan_grid(T: int, k: int, D: int, n_sm: int, smem_optin: int, smem_sm: int,
              co_resident: int | None = None) -> GridPlan:
    """Blocks and their threads, each block's frames and halo, and the
    ring's depth for a call on (T, k, 3D) on a card of n_sm SMs of smem_sm
    bytes of shared memory, whose blocks may opt in to smem_optin; no more
    blocks an SM than `co_resident` (the occupancy query's count for the
    plan's instance). A thread takes a group of 4 columns (1 where
    D % 4 != 0). Block b owns [b T / B, (b + 1) T / B)."""
    groups = D // 4 if D % 4 == 0 else D
    threads = THREADS[1] if groups <= THREADS[1] else THREADS[0]
    room = smem_optin - STATIC_SMEM
    slots = next((s for s in (3, 2) if smem_bytes(k, D, s) <= room), 0)
    smem = smem_bytes(k, D, slots)
    if smem > room:
        raise ValueError(f"the smoothness kernel needs {smem} bytes of shared memory at "
                         f"D={D}, k={k}; the card offers {room}")
    per_sm = min(THREADS[0] // threads, smem_sm // (smem + STATIC_SMEM + BLOCK_RESERVE))
    per_sm = max(1, per_sm if co_resident is None else min(per_sm, co_resident))
    blocks = max(1, min(n_sm * per_sm, -(-T // MIN_FRAMES)))
    return GridPlan(T, blocks, threads, slots, smem)


def _library():
    from knnsvc_torch.ops.build import load_kernel

    lib = load_kernel(KERNEL)
    ptr, i32, i64, f32 = ctypes.c_void_p, ctypes.c_int, ctypes.c_long, ctypes.c_float
    lib.smoothness_adam_f32.restype = i32
    lib.smoothness_adam_f32.argtypes = ([ptr, ptr, i32] + [ptr] * 5 + [i32] * 6 + [i64]
                                        + [f32] * 12 + [i32] * 3 + [ptr])
    lib.smoothness_adam_occupancy.restype = i32
    lib.smoothness_adam_occupancy.argtypes = [i32, i32, i32, i64, ptr]
    return lib


_BIAS_CORRECTIONS: dict[int, torch.Tensor] = {}
_OCCUPANCY: dict[tuple, int] = {}


def _plan(lib, surrounding: torch.Tensor) -> GridPlan:
    """plan_grid for this card, its blocks an SM capped by the occupancy
    query for the planned instance (asked once a device and instance)."""
    from knnsvc_torch.ops.build import check_launch

    T, k, D3 = surrounding.shape
    D = D3 // 3
    props = torch.cuda.get_device_properties(surrounding.device)
    limits = (props.multi_processor_count, props.shared_memory_per_block_optin,
              props.shared_memory_per_multiprocessor)
    plan = plan_grid(T, k, D, *limits)
    vec = int(D % 4 == 0 and surrounding.data_ptr() % 16 == 0)
    key = (surrounding.device.index, min(kk for kk in (4, 8, 32) if k <= kk), plan.threads,
           vec, plan.smem_bytes)
    if key not in _OCCUPANCY:
        per_sm = ctypes.c_int()
        check_launch(lib, KERNEL, lib.smoothness_adam_occupancy(k, plan.threads, vec,
                                                                plan.smem_bytes,
                                                                ctypes.byref(per_sm)))
        _OCCUPANCY[key] = per_sm.value
    return plan_grid(T, k, D, *limits, co_resident=_OCCUPANCY[key])


def bias_corrections(device: torch.device, n: int, b1: float, b2: float) -> torch.Tensor:
    """(2, >= n) float32 on `device`: 1 - b1^t and 1 - b2^t for t = 1.., in
    float32 as the plain loop computes them. Built once a device and
    process, and again only for a larger n."""
    table = _BIAS_CORRECTIONS.get(device.index)
    if table is None or table.shape[1] < n:
        ts = np.arange(1, n + 1, dtype=np.float32)
        rows = [np.float32(1) - np.float32(b) ** ts for b in (b1, b2)]
        table = torch.from_numpy(np.stack(rows)).to(device)
        _BIAS_CORRECTIONS[device.index] = table
    return table


def smoothness_adam(surrounding: torch.Tensor, scale: float,
                    max_steps: int) -> tuple[torch.Tensor, int]:
    """surrounding (T, k, 3D) float32, contiguous, on a CUDA card -> (the
    best logits (T, k), the steps taken). One launch and one read-back of
    the step count; adds one to `smoothness_adam.launches`."""
    from knnsvc_torch.match import smoothness as opt
    from knnsvc_torch.ops.build import check_launch

    if surrounding.device.type != "cuda":
        raise ValueError(f"the smoothness kernel runs on cuda, not {surrounding.device}")
    if surrounding.dtype != torch.float32:
        raise TypeError(f"surrounding must be float32, got {surrounding.dtype}")
    if surrounding.dim() != 3 or surrounding.shape[2] % 3:
        raise ValueError(f"surrounding must be (T, k, 3D), got {tuple(surrounding.shape)}")
    if not surrounding.is_contiguous():
        raise ValueError("surrounding must be contiguous")
    T, k, D3 = surrounding.shape
    D = D3 // 3
    if T < 1 or D < 1:
        raise ValueError(f"the smoothness kernel needs T >= 1 frames and D >= 1, got "
                         f"{tuple(surrounding.shape)}")
    if not 1 <= k <= MAX_K:
        raise ValueError(f"the smoothness kernel takes 1 <= k <= {MAX_K}, got k={k}")
    dev = surrounding.device
    lib = _library()
    with torch.cuda.device(dev):
        plan = _plan(lib, surrounding)
        bc = bias_corrections(dev, max(max_steps, 1), opt._B1, opt._B2)
        # w by step parity, m, v, vhat, best_w; the gradients and the loss
        # partials by step parity; the barrier's counter and the step count
        n_state, n_grad, n_part = 6 * T * k, 2 * T * k, 4 * plan.blocks
        buf = torch.zeros(n_state + n_grad + n_part + 2, dtype=torch.float32, device=dev)
        counters = buf[-2:].view(torch.int32)
        ptr = buf.data_ptr()
        stream = torch.cuda.current_stream(dev).cuda_stream
        code = lib.smoothness_adam_f32(
            surrounding.data_ptr(), bc.data_ptr(), bc.shape[1], ptr, ptr + 4 * n_state,
            ptr + 4 * (n_state + n_grad), counters.data_ptr(), counters[1:].data_ptr(),
            T, k, D, plan.blocks, plan.threads, plan.slots, plan.smem_bytes,
            scale, 2.0 * scale / (max(T - 1, 1) * D), float(np.float32(1) / np.float32(D)),
            float(np.float32(1) / np.float32(T - 1)) if T > 1 else float("inf"),
            opt._LR, opt._B1, 1 - opt._B1, opt._B2, 1 - opt._B2, opt._EPS, opt._PLATEAU_TOL,
            opt._INIT_LOSS, opt._PLATEAU_EVERY, opt._FAIL_LIMIT, max_steps, stream)
    check_launch(lib, KERNEL, code)
    smoothness_adam.launches += 1
    return buf[5 * T * k:n_state].view(T, k), int(counters[1])


smoothness_adam.launches = 0
