"""Concatenation-smoothness weight optimization, the paper's OPT step
(counterpart of knnsvc_tpu/match/smoothness.py::optimize_smoothness_weights).

Per frame, convex weights over the k selected neighbours are learned so
that the weighted vectors change smoothly from frame to frame (ref
ddsp_prematch_dataset.py:465-925). Adam with AMSGrad (lr 0.1, betas
(0.9, 0.999), eps 1e-8) and the reference's early-stop bookkeeping:

- the loss is taken before the step, and the best weights are the
  pre-step weights of the lowest loss;
- every 100 steps (at t % 100 == 1) the loop stops when the best loss
  moved less than 1e-5 since the last check;
- it stops after 1000 steps in a row without a new best, and at 100k steps.

On a CUDA tensor the whole call is one launch of the hand-written kernel
(ops/smoothness_adam.py, csrc/smoothness_adam.cu), which keeps every step
and the early stop on the card; the host reads back the step count once.
A CPU tensor takes the plain version below, `_plain_loop`.

The plain loop makes no host sync per step. Steps run in blocks; within a
block each step is masked by `done`, as the JAX package's unrolled
`frozen_body` is, and the host reads `done` once per block, so the step
count is exact whatever the block size. Blocks end at t = 2, 102, 202,
...: the plateau check, the usual exit, sets `done` in the step at
t % 100 == 1, which is the last of its block, so that exit costs no masked
step and one sync per 100 steps. Only the stop after 1000 failures, which
may fall anywhere, can cost up to 99 masked steps.

Once `done` is set only the outputs freeze (the best weights and the step
count): Adam's state may run on through a block's masked steps, since
nothing reads it after `done`. The gradient is written out by hand in
plain torch, two batched products over the (T, k, 3D) neighbourhood
features and a few elementwise ops per step.
"""

from __future__ import annotations

import logging

import numpy as np
import torch

WAVLM_LOSS_SCALE = 0.1      # ref :460-461 (wavlm_phase_mae)
HARMONICS_LOSS_SCALE = 1e3  # ref :449-457 (phase_mae)

_LR = 1e-1
_B1, _B2, _EPS = 0.9, 0.999, 1e-8
_MAX_STEPS = 100_000
_PLATEAU_EVERY = 100
_PLATEAU_TOL = 1e-5
_FAIL_LIMIT = 1000
_INIT_LOSS = 20000.0   # the best and the last checked loss before step 0

_log = logging.getLogger(__name__)


def _gather_surrounding(indices: torch.Tensor, synth_set: torch.Tensor,
                        amp_ratio: torch.Tensor | None = None) -> torch.Tensor:
    """(T, k) ids -> (T, k, 3, D) pool rows at id offsets -1, 0, +1, clipped
    to the pool (ref :477-485), flattened to (T, k, 3D) for the products.
    amp_ratio (T, k), the training-time variant, scales each candidate's
    three rows."""
    P = synth_set.shape[0]
    offs = torch.tensor([-1, 0, 1], device=indices.device)
    idx = torch.clamp(indices[:, :, None] + offs, 0, P - 1)          # (T, k, 3)
    rows = synth_set[idx].reshape(indices.shape[0], indices.shape[1], -1)
    return rows if amp_ratio is None else rows * amp_ratio[:, :, None]


def _loss_and_grad(w: torch.Tensor, surrounding: torch.Tensor, scale: float):
    """The smoothness loss (ref :504-527) and its gradient in w. For
    offsets -1 and +1: the mean over frames of scale * the row-mean squared
    difference between the weighted vector at that offset, shifted by it,
    and the one at offset 0."""
    T, k, D3 = surrounding.shape
    D = D3 // 3
    p = torch.softmax(w, dim=1)                                       # (T, k)
    e = torch.bmm(p[:, None, :], surrounding)[:, 0].view(T, 3, D)     # (T, 3, D)
    d1 = e[1:, 0] - e[:-1, 1]
    d2 = e[1:, 1] - e[:-1, 2]
    loss = ((scale * (d1 * d1).mean(-1)).mean()
            + (scale * (d2 * d2).mean(-1)).mean())
    c = 2.0 * scale / (max(T - 1, 1) * D)    # T = 1: no pairs, a NaN loss, as in JAX
    g_e = torch.zeros_like(e)
    g_e[1:, 0] = c * d1
    g_e[:-1, 1] = -c * d1
    g_e[1:, 1] += c * d2
    g_e[:-1, 2] = -c * d2
    g_p = torch.bmm(surrounding, g_e.view(T, D3, 1))[:, :, 0]         # (T, k)
    grad = p * (g_p - (p * g_p).sum(dim=1, keepdim=True))            # softmax backward
    return loss, grad


@torch.no_grad()
def optimize_smoothness_weights(indices: torch.Tensor, synth_set: torch.Tensor,
                                scale: float = WAVLM_LOSS_SCALE,
                                amp_ratio: torch.Tensor | None = None,
                                max_steps: int = _MAX_STEPS, return_steps: bool = False):
    """indices (T, k) into synth_set (P, D) -> convex weights (T, k), the
    softmax of the best weights ('sum_to_1_geq', ref :426-428). amp_ratio
    (T, k) multiplies each candidate's gathered rows (prematch's amp-weighted
    variant, ref ddsp_prematch_dataset.py:1681). With return_steps, also the
    number of steps taken. Each call logs its step count at DEBUG level on
    this module's logger."""
    return optimize_smoothness_from_surrounding(
        _gather_surrounding(indices, synth_set, amp_ratio), scale=scale, max_steps=max_steps,
        return_steps=return_steps)


@torch.no_grad()
def optimize_smoothness_from_surrounding(surrounding: torch.Tensor,
                                         scale: float = WAVLM_LOSS_SCALE,
                                         max_steps: int = _MAX_STEPS, return_steps: bool = False):
    """The optimizer on gathered neighbourhoods: surrounding (T, k, 3D), the
    pool rows at id offsets -1, 0, +1 of each selection (a sharded pool
    gathers them across its shards, parallel/sharded_match.py; the JAX
    package's optimize_smoothness_from_surrounding). -> weights (T, k)[,
    steps]. A CUDA tensor launches the kernel once, a CPU tensor runs the
    plain loop. Each call adds its steps to
    `optimize_smoothness_from_surrounding.steps` and one to its `.runs`."""
    T, k = surrounding.shape[:2]
    if surrounding.device.type == "cuda":
        from knnsvc_torch.ops.smoothness_adam import smoothness_adam

        best_w, n_steps = smoothness_adam(surrounding, scale, max_steps)
    elif surrounding.device.type == "cpu":
        best_w, n_steps = _plain_loop(surrounding, scale, max_steps)
    else:
        raise ValueError(f"the smoothness optimizer runs on cpu or cuda, not {surrounding.device}")
    optimize_smoothness_from_surrounding.steps += n_steps
    optimize_smoothness_from_surrounding.runs += 1
    _log.debug("smoothness: %d steps (T=%d, k=%d, scale=%g)", n_steps, T, k, scale)
    weights = torch.softmax(best_w, dim=1)
    return (weights, n_steps) if return_steps else weights


optimize_smoothness_from_surrounding.steps = 0
optimize_smoothness_from_surrounding.runs = 0


def _plain_loop(surrounding: torch.Tensor, scale: float, max_steps: int):
    """The plain version, on the tensor's device: -> (the best logits (T, k),
    the steps taken)."""
    dev = surrounding.device
    T, k = surrounding.shape[:2]
    w = torch.zeros((T, k), dtype=torch.float32, device=dev)
    m, v, vhat, best_w = (torch.zeros_like(w) for _ in range(4))
    min_loss = torch.tensor(_INIT_LOSS, device=dev)
    converge_min_loss = torch.tensor(_INIT_LOSS, device=dev)
    fail_streak = torch.zeros((), dtype=torch.int32, device=dev)
    done = torch.zeros((), dtype=torch.bool, device=dev)
    steps = torch.zeros((), dtype=torch.int32, device=dev)

    issued, block_end = 0, 2
    while issued < max_steps:
        end = min(block_end, max_steps)
        # Adam's bias corrections 1 - beta^t of this block, in float32 as
        # the JAX package computes them
        ts = np.arange(issued + 1, end + 1, dtype=np.float32)
        bc1 = torch.from_numpy(np.float32(1) - np.float32(_B1) ** ts).to(dev)
        bc2 = torch.from_numpy(np.float32(1) - np.float32(_B2) ** ts).to(dev)
        for i, t in enumerate(range(issued, end)):
            active = ~done
            steps += active
            loss, grad = _loss_and_grad(w, surrounding, scale)
            if t % _PLATEAU_EVERY == 1:
                plateau = torch.abs(min_loss - converge_min_loss) < _PLATEAU_TOL
                converge_min_loss = min_loss
                done = done | plateau
            improved = loss < min_loss
            min_loss = torch.where(improved, loss, min_loss)
            best_w = torch.where(improved & active, w, best_w)
            fail_streak = torch.where(improved, 0, fail_streak + 1)
            done = done | (fail_streak >= _FAIL_LIMIT)

            m = _B1 * m + (1 - _B1) * grad
            v = _B2 * v + (1 - _B2) * grad * grad
            vhat = torch.maximum(vhat, v)
            w = w - _LR * (m / bc1[i]) / (torch.sqrt(vhat / bc2[i]) + _EPS)
        issued = end
        block_end += _PLATEAU_EVERY
        if bool(done):
            break
    return best_w, int(steps)
