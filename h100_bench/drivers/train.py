"""The vocoder's training step: someone fine-tuning the vocoder at the
reference's own configuration (full-width generator, MPD and MSD, AdamW,
the configuration's batch and segment), paying card time per step.

Set-up draws the training state's trees from the seed (inputs.py), builds
the port's TrainState from them and its `make_train_step`, and makes
`n_batches` distinct batches on the card. The state takes its first
`warm_steps` steps through that step on batches 0, 1, ... in set-up (their
losses and the first gradient are read back); then the window runs the
same state through the next batches in turn for `seconds` and ends in a
synchronize: `train_step_ms` is its wall time over the steps it took. The
host input pipeline (train/dataset) is bypassed.

Correctness: the window's first `checked_steps` steps are kept (Checked).
After the window the plain reference (reference/train.py) starts from the
same trees and takes the set-up steps and those steps on the same batches;
compare.train_numbers holds the two to the cell's limits.
"""

from __future__ import annotations

import functools
import sys
import time

import numpy as np

from h100_bench import compare, inputs
from h100_bench.harness import RunResult, reduce_trace, start_tracer

_SUFFIXES = ((".parametrizations.weight.original0", ".g"),
             (".parametrizations.weight.original1", ".v"),
             (".parametrizations.weight.original", ".v_sn"),
             (".weight", ".w"), (".bias", ".b"))


def leaf_name(prefix: str, torch_name: str) -> str:
    """A TrainState module's parameter name -> its leaf's dotted tree path."""
    for old, new in _SUFFIXES:
        if torch_name.endswith(old):
            return f"{prefix}.{torch_name[: -len(old)]}{new}"
    return f"{prefix}.{torch_name}"


def _log(msg: str) -> None:
    print(f"[train] {msg}", file=sys.stderr, flush=True)


def _named(state):
    for prefix, module in (("g", state.generator), ("mpd", state.mpd), ("msd", state.msd)):
        for name, p in module.named_parameters():
            yield leaf_name(prefix, name), p


def _norm(a) -> float:
    return float(np.linalg.norm(np.asarray(a, np.float64).ravel()))


def _ref_log_mel(h):
    from h100_bench.reference.stft import log_mel_spectrogram

    return functools.partial(log_mel_spectrogram, n_fft=h.n_fft, num_mels=h.num_mels,
                             sampling_rate=h.sampling_rate, hop_size=h.hop_size,
                             win_size=h.win_size, fmin=h.fmin, fmax=h.fmax)


def reference_readings(cfg: dict, tr: dict, trees, batches, device) -> dict:
    """The reference's steps from the trees, as many as the program takes
    in set-up and then compares in the window: every step's losses, the
    first gradient's norm per leaf, and each leaf's change over the
    window's checked steps."""
    import torch

    from h100_bench.reference.config import HiFiGANConfig
    from h100_bench.reference.train import Reference

    ref = Reference(*trees, HiFiGANConfig.from_dict(cfg["hifigan"]), cfg["ckpt_type"], device,
                    cfg.get("disc_width_scale", 1))
    warm = tr["warm_steps"]
    losses, grad_norms, start = [], {}, {}
    for k in range(warm + tr["checked_steps"]):
        if k == warm:
            start = {p: t.detach().clone() for p, t in ref.leaves.items()}
        r = ref.step(batches[k])
        losses.append((r["loss_gen_total"], r["loss_disc_total"]))
        if k == 0:
            grad_norms = {p: float(torch.linalg.vector_norm(g.double()))
                          for p, g in r["grads"].items()}
    change = {p: float(torch.linalg.vector_norm((ref.leaves[p].detach() - start[p]).double()))
              for p in grad_norms}
    return {"losses": losses, "grad_norms": grad_norms, "change_norms": change,
            "setup_steps": warm}


class Checked:
    """What the program's steps give for the check. The set-up steps'
    losses are read at once, and the first gradient's norm per leaf from
    AdamW's first moment after one step, (1 - b1) g. Of the window's first
    `checked_steps` steps the loss tensors and the leaves after the last
    are kept on the card (no host sync inside the window) and read after
    it, against the leaves the window started from."""

    def __init__(self, state, b1: float, checked_steps: int):
        self.state, self.b1, self.checked = state, b1, checked_steps
        self.params = list(_named(state))
        self.losses: list = []
        self.grad_norms: dict[str, float] = {}
        self.window: list = []          # the window's loss tensors
        self.n = 0                      # window steps seen

    def setup_step(self, metrics: dict, first: bool) -> None:
        import torch

        self.losses.append((float(metrics["loss_gen_total"]), float(metrics["loss_disc_total"])))
        if first:
            for name, p in self.params:
                opt = self.state.opt_g if name.startswith("g.") else self.state.opt_d
                if p in opt.state:
                    self.grad_norms[name] = float(torch.linalg.vector_norm(
                        opt.state[p]["exp_avg"].double())) / (1 - self.b1)

    def window_start(self) -> None:
        """In set-up: the leaves the window starts from, kept on the host."""
        self.start = {n: p.detach().to("cpu", copy=True) for n, p in self.params}

    def window_step(self, metrics: dict) -> None:
        """After each window step; does nothing past the checked ones."""
        self.n += 1
        if self.n > self.checked:
            return
        self.window.append((metrics["loss_gen_total"].detach(),
                            metrics["loss_disc_total"].detach()))
        if self.n == self.checked:
            self.end = {n: p.detach().clone() for n, p in self.params}

    def readings(self) -> dict:
        import torch

        change = {n: float(torch.linalg.vector_norm(
            self.end[n].cpu().double() - self.start[n].double())) for n in self.grad_norms}
        losses = self.losses + [(float(g), float(d)) for g, d in self.window]
        return {"losses": losses, "grad_norms": self.grad_norms, "change_norms": change,
                "setup_steps": len(self.losses)}


def _program(cell, ctx):
    """Set-up: the port's TrainState built from the seed's trees, its step,
    the batches, and the set-up steps taken through that step -> (state,
    step, trees, batches, Checked)."""
    import torch

    from knnsvc_torch.config import HiFiGANConfig, model_family_for_ckpt_type
    from knnsvc_torch.io.jax_params import train_state_from_numpy
    from knnsvc_torch.precision import set_precision
    from knnsvc_torch.train.trainer import make_train_step

    cfg, tr = cell.config, cell.traffic
    dev = torch.device(ctx.device)
    h = HiFiGANConfig.from_dict(cfg["hifigan"])
    set_precision(cfg["precision"])
    t = time.perf_counter()
    trees = inputs.train_weights(cfg, ctx.seed, dev)
    state = train_state_from_numpy(*trees, h, model_family_for_ckpt_type(cfg["ckpt_type"]), dev)
    step = make_train_step(h, state.family)
    batches = inputs.train_batches(cfg, tr["n_batches"], ctx.seed + 3, dev, _ref_log_mel(h))
    _log(f"state drawn and built, {len(batches)} batches made in {time.perf_counter() - t:.3f} s")
    t = time.perf_counter()
    checked = Checked(state, h.adam_b1, tr["checked_steps"])
    for k in range(tr["warm_steps"]):
        checked.setup_step(step(state, batches[k]), first=k == 0)
    _log(f"{tr['warm_steps']} set-up steps and their read-backs in "
         f"{time.perf_counter() - t:.3f} s")
    return state, step, trees, batches, checked


def program_readings(cell, ctx) -> dict[str, float]:
    """The program's readings of one seed: its set-up steps and the next
    `checked_steps` through the same call, with no window, against the
    reference's."""
    import torch

    state, step, trees, batches, checked = _program(cell, ctx)
    tr = cell.traffic
    checked.window_start()
    for k in range(tr["warm_steps"], tr["warm_steps"] + tr["checked_steps"]):
        checked.window_step(step(state, batches[k % len(batches)]))
    prog = checked.readings()
    del state, step, checked
    return compare.train_numbers(prog, reference_readings(
        cell.config, tr, trees, batches, torch.device(ctx.device)))


def run(cell, ctx) -> RunResult:
    import torch

    cfg, tr = cell.config, cell.traffic
    dev = torch.device(ctx.device)
    cuda = dev.type == "cuda"
    sync = torch.cuda.synchronize if cuda else (lambda: None)
    state, step, trees, batches, checked = _program(cell, ctx)
    h = state.generator.h
    n_batches = len(batches)
    i = tr["warm_steps"]
    checked.window_start()
    sync()
    if cuda:
        torch.cuda.reset_peak_memory_stats(dev)

    setup_s = time.time() - ctx.start_wall
    t0 = time.perf_counter()
    n = 0
    while True:
        m = step(state, batches[i % n_batches])
        checked.window_step(m)
        i += 1
        n += 1
        if time.perf_counter() - t0 >= ctx.seconds and n >= tr["checked_steps"]:
            break
    sync()
    window_s = time.perf_counter() - t0
    last = [float(v) for v in m.values()]
    failed = int(not np.all(np.isfinite(last)))
    _log(f"window: {n} steps in {window_s:.3f} s")

    view = None
    if ctx.trace:
        # the traced steps follow the window, so the window is timed as in
        # an untraced run; one step first warms the tracer up
        prof = start_tracer(cuda)
        step(state, batches[i % n_batches])
        i += 1
        prof.step()
        t = time.perf_counter()
        for k in range(tr["trace_steps"]):
            step(state, batches[i % n_batches])
            i += 1
            if k == tr["trace_steps"] - 1:
                sync()
                trace_window = time.perf_counter() - t
            prof.step()
        prof.stop()
        unit = {"batch": h.batch_size, "segment": h.segment_size}
        view = reduce_trace(prof.events(), trace_window)
        view.units = [unit] * tr["trace_steps"]
        view.window_units, view.window_wall_s = [unit] * n, window_s
        view.config, view.traffic = cfg, tr
        del prof
    peak = torch.cuda.max_memory_allocated(dev) if cuda else 0
    prog = checked.readings()
    del state, step, checked
    if cuda:
        torch.cuda.empty_cache()
    t = time.perf_counter()
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    readings = compare.train_numbers(prog, reference_readings(cfg, tr, trees, batches, dev))
    _log(f"reference over {tr['warm_steps'] + tr['checked_steps']} steps in "
         f"{time.perf_counter() - t:.3f} s")
    return RunResult(attempted=n + (tr["trace_steps"] + 1 if ctx.trace else 0), failed=failed,
                     end_to_end={"train_step_ms": 1e3 * window_s / n, "setup_s": float(setup_s)},
                     readings=readings, checks=compare.checks(readings, cell.limits),
                     memory_peak_bytes=int(peak), view=view)


def half_batch_readings(cell, ctx) -> dict[str, float]:
    """A fault planted in the reference put in the program's place: half of
    each batch left out, the mean taken over the rest."""
    import torch

    from h100_bench.reference.config import HiFiGANConfig

    cfg, tr = cell.config, cell.traffic
    dev = torch.device(ctx.device)
    trees = inputs.train_weights(cfg, ctx.seed, dev)
    batches = inputs.train_batches(cfg, tr["n_batches"], ctx.seed + 3, dev,
                                   _ref_log_mel(HiFiGANConfig.from_dict(cfg["hifigan"])))
    half = [{k: v[: v.shape[0] // 2] for k, v in b.items()} for b in batches]
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    return compare.train_numbers(reference_readings(cfg, tr, trees, half, dev),
                                 reference_readings(cfg, tr, trees, batches, dev))


def control_readings(cell, ctx, control: bool) -> dict[str, float]:
    """The compared numbers with the reference in the program's place,
    computed in TF32 (control=True) or float32, against the reference in
    float32."""
    import torch

    from h100_bench.reference.config import HiFiGANConfig

    cfg, tr = cell.config, cell.traffic
    dev = torch.device(ctx.device)
    h = HiFiGANConfig.from_dict(cfg["hifigan"])
    trees = inputs.train_weights(cfg, ctx.seed, dev)
    batches = inputs.train_batches(cfg, tr["n_batches"], ctx.seed + 3, dev, _ref_log_mel(h))
    sides = []
    for tf32 in (control, False):
        torch.backends.cuda.matmul.allow_tf32 = tf32
        torch.backends.cudnn.allow_tf32 = tf32
        sides.append(reference_readings(cfg, tr, trees, batches, dev))
    return compare.train_numbers(*sides)
