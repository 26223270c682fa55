"""The f0 Viterbi in plain PyTorch: a frozen copy of the plain version in
knnsvc_torch/ops/viterbi.py (`_leftmost_cummin`, `dt_min`, `viterbi_plain`)."""

from __future__ import annotations

import torch


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
