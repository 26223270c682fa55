"""The device f0 extractor's Viterbi smoothing: the wrapper of the
hand-written CUDA kernel (csrc/f0_viterbi.cu) and its plain PyTorch version.

Counterpart of knnsvc_tpu/dsp/f0_device.py::_viterbi (:204), with the
distance transform _dt_min (:187). That stage is not a Pallas kernel: XLA
runs it as two lax.scan loops over the N frames (forward :234, backtrack
:247). The port gives it a kernel because the plain version is a chain of
~30 small launches per frame, and a 30-s chunk has 1501 frames.

What it computes: the min-cost path over N frames x (C voiced states + one
unvoiced state C). Per frame t, from running costs (dv (C,), du):
  best_v[j], arg_v[j] = min over i of dv[i] + lam_s |i - j|   (distance
      transform: a left and a right cumulative min of dv -+ i lam_s)
  new_dv[j] = min(best_v[j], du + switch) + cost_v[t, j]
  ptr_v[j]  = arg_v[j] if best_v[j] <= du + switch else C
  new_du    = min(du, min(dv) + switch) + cost_u[t]
  ptr_u     = C if du <= min(dv) + switch else argmin(dv)
then both are lowered by m = min(min(new_dv), new_du). The last frame's
state is argmin(dv) if min(dv) <= du else C, and the pointers are walked
back from it. Ties follow the JAX package exactly: the left cumulative min
keeps the leftmost index, the right one (a left pass over the reversed
array) the rightmost; left wins over right on <=; argmin takes the first
minimum. torch.cummin reports the LAST index among equal values, so the
plain version finds its indices from the positions where a strictly new
minimum starts. Silent frames set every voiced cost to 1e3, so ties are
common on real audio.

CPU tensors take the plain version. A CUDA tensor launches the kernel or
raises; nothing falls back.
"""

from __future__ import annotations

import ctypes

import torch

KERNEL = "f0_viterbi"
# C + 1 states the kernel holds: 4 or 8 a thread of 4 warps in registers up
# to 1024, then 4 to 32 a thread of 16 warps in shared memory; its int16
# pointers hold state indices up to 16383
MAX_STATES = 16384


def _leftmost_cummin(v: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Running (min, leftmost argmin) along the last axis: the index moves
    only where a value is strictly below every earlier one."""
    n = v.shape[-1]
    run = torch.cummin(v, dim=-1).values
    before = torch.cat([torch.full_like(v[..., :1], torch.inf), run[..., :-1]], dim=-1)
    ar = torch.arange(n, device=v.device)
    idx = torch.cummax(torch.where(v < before, ar, 0), dim=-1).values
    return torch.gather(v, -1, idx), idx


def dt_min(dv: torch.Tensor, lam_s: float, ramp: torch.Tensor
           ) -> tuple[torch.Tensor, torch.Tensor]:
    """best[j] = min_i dv[i] + lam_s |i - j| and its argmin, in O(C): a left
    and a right cumulative min of dv -+ i lam_s (`ramp` = arange(C) as
    floats). Counterpart of _dt_min, ties and all."""
    C = dv.shape[-1]
    shift = ramp * lam_s
    lv, li = _leftmost_cummin(dv - shift)
    left = lv + shift
    rv, ri = _leftmost_cummin((dv + shift).flip(-1))
    right = rv.flip(-1) - shift
    ri = (C - 1 - ri).flip(-1)
    take_l = left <= right
    return torch.where(take_l, left, right), torch.where(take_l, li, ri)


def viterbi_plain(cost_v: torch.Tensor, cost_u: torch.Tensor, lam_s: float,
                  switch: float) -> torch.Tensor:
    """The plain version: cost_v (N, C), cost_u (N,) float32 -> (N,) int32
    states, C meaning unvoiced. One step of the loop per frame, on the
    tensors' device."""
    N, C = cost_v.shape
    ramp = torch.arange(C, dtype=cost_v.dtype, device=cost_v.device)
    dv, du = cost_v[0], cost_u[0]
    ptr_v, ptr_u = [], []
    for t in range(1, N):
        best_v, arg_v = dt_min(dv, lam_s, ramp)
        stay_u = du + switch
        new_dv = torch.minimum(best_v, stay_u) + cost_v[t]
        ptr_v.append(torch.where(best_v <= stay_u, arg_v, C))
        best_from_v = dv.min() + switch
        new_du = torch.minimum(du, best_from_v) + cost_u[t]
        ptr_u.append(torch.where(du <= best_from_v, C, dv.argmin()))
        m = torch.minimum(new_dv.min(), new_du)
        dv, du = new_dv - m, new_du - m
    state = torch.where(dv.min() <= du, dv.argmin(), C)
    states = [state]
    if N > 1:
        # pointer row t maps frame t+1's state to frame t's; state C reads ptr_u
        ptrs = torch.cat([torch.stack(ptr_v), torch.stack(ptr_u)[:, None]], dim=1)
        for t in range(N - 2, -1, -1):
            state = ptrs[t].gather(0, state.reshape(1))[0]
            states.append(state)
    return torch.stack(states[::-1]).to(torch.int32)


def _library():
    from knnsvc_torch.ops.build import load_kernel

    lib = load_kernel(KERNEL)
    ptr, i32, f32 = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    lib.f0_viterbi_f32.restype = i32
    lib.f0_viterbi_f32.argtypes = [ptr, ptr, ptr, ptr, i32, i32, f32, f32, ptr]
    lib.f0_viterbi_pitch.restype = i32
    lib.f0_viterbi_pitch.argtypes = [i32]
    return lib


def check_states(C: int) -> None:
    """What the CUDA kernel takes: C + 1 <= MAX_STATES states."""
    if C + 1 > MAX_STATES:
        raise ValueError(f"the CUDA Viterbi holds C + 1 <= {MAX_STATES} states, got C={C}")


def f0_viterbi(cost_v: torch.Tensor, cost_u: torch.Tensor, lam_s: float,
               switch: float) -> torch.Tensor:
    """cost_v (N, C), cost_u (N,) float32 -> (N,) int32 states (C =
    unvoiced). lam_s and switch are the fp32 values of the transition cost
    per grid step and of the voicing switch. A CUDA tensor launches the
    kernel once (forward recursion and backtrack in one block) and adds one
    to `f0_viterbi.launches`."""
    if cost_v.dim() != 2 or tuple(cost_u.shape) != (cost_v.shape[0],):
        raise ValueError(f"cost_v must be (N, C) and cost_u (N,), got {tuple(cost_v.shape)} "
                         f"and {tuple(cost_u.shape)}")
    if cost_u.device != cost_v.device:
        raise ValueError(f"cost_u is on {cost_u.device}, cost_v on {cost_v.device}")
    N, C = cost_v.shape
    if N < 1 or C < 1:
        raise ValueError(f"the Viterbi needs N >= 1 frames and C >= 1 states, got {(N, C)}")
    if cost_v.device.type == "cpu":
        return viterbi_plain(cost_v, cost_u, lam_s, switch)
    if cost_v.device.type != "cuda":
        raise ValueError(f"the f0 Viterbi runs on cpu or cuda, not {cost_v.device}")
    for name, t in (("cost_v", cost_v), ("cost_u", cost_u)):
        if t.dtype != torch.float32:
            raise TypeError(f"{name} must be float32, got {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    check_states(C)
    from knnsvc_torch.ops.build import check_launch

    lib = _library()
    states = torch.empty(N, dtype=torch.int32, device=cost_v.device)
    pitch = lib.f0_viterbi_pitch(C)     # int16 pointers a frame: the instance's states
    ptrs = torch.empty((max(N - 1, 1), pitch), dtype=torch.int16, device=cost_v.device)
    with torch.cuda.device(cost_v.device):
        stream = torch.cuda.current_stream(cost_v.device).cuda_stream
        code = lib.f0_viterbi_f32(cost_v.data_ptr(), cost_u.data_ptr(), ptrs.data_ptr(),
                                  states.data_ptr(), N, C, lam_s, switch, stream)
    check_launch(lib, KERNEL, code)
    f0_viterbi.launches += 1
    return states


f0_viterbi.launches = 0
