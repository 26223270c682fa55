"""Profiling and tracing utilities (counterpart of
knnsvc_tpu/utils/profiling.py; the reference has none beyond wall-clock
prints).

- `trace(log_dir)`: torch.profiler over a block (CPU, and CUDA when a card
  is visible), its Chrome trace written to <log_dir>/trace.json;
- `annotate(name)`: a torch.profiler record_function span;
- `force_completion(tree)`: waits for the cards that hold the tensors of a
  result (a no-op for CPU tensors);
- `StageTimer`: accumulates wall-clock per named stage, forcing device
  completion at each stage's end;
- `counters()`: a snapshot of the program's counters, each under one name.

The program's spans come at two levels, told apart by the separator:

- `knnsvc.<layer>` (a dot): a stage of a request, such as `pool_build`,
  `vocode` or `smoothness`, and `convert_pair`, the request's root; in
  w2v-BERT 2.0, `fbank` (the frontend) and `conformer_conv` (each layer's
  convolution module) take their device time out of `pool_build`'s. A
  trace's device time is charged to the innermost `knnsvc.` span open at
  its launch; readers of a trace take the layers' device time from that.
- `knnsvc:<part>` (a colon): a sub-step inside a layer whose span is read
  already, such as `pos_conv` in the WavLM encoder. The charging rule above
  passes over it (its name does not start with `knnsvc.`), so a part span
  adds a reading without moving any layer's.

No span costs anything without an active profiler.
"""

from __future__ import annotations

import contextlib
import json
import os
import time
from collections import defaultdict

import torch


@contextlib.contextmanager
def trace(log_dir: str):
    """Profile the block; yields the torch.profiler.profile, whose events
    stay readable after the block."""
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))


def annotate(name: str):
    """A named span in torch.profiler traces (context manager)."""
    return torch.profiler.record_function(name)


def _tensors(tree):
    if isinstance(tree, torch.Tensor):
        yield tree
    elif isinstance(tree, dict):
        for v in tree.values():
            yield from _tensors(v)
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            yield from _tensors(v)


def force_completion(tree):
    """Wait until the work that produces the tensors of `tree` (nested
    dicts, lists and tuples) is done: torch.cuda.synchronize on each CUDA
    device among them; CPU tensors are complete already. Returns tree."""
    for dev in {t.device for t in _tensors(tree) if t.device.type == "cuda"}:
        torch.cuda.synchronize(dev)
    return tree


class StageTimer:
    """Accumulating per-stage wall timer.

    with timer.stage("wavlm"):
        feats = timer.observe(encode(...))   # device completion forced on exit
    print(timer.report())
    """

    def __init__(self, sync: bool = True):
        self.totals: dict[str, float] = defaultdict(float)
        self.counts: dict[str, int] = defaultdict(int)
        self._sync = sync
        self._last_result = None

    @contextlib.contextmanager
    def stage(self, name: str, result_getter=None):
        t0 = time.perf_counter()
        try:
            yield self
        finally:
            if self._sync and self._last_result is not None:
                force_completion(self._last_result)
                self._last_result = None
            self.totals[name] += time.perf_counter() - t0
            self.counts[name] += 1

    def observe(self, result):
        """Register the stage's device output so completion can be forced."""
        self._last_result = result
        return result

    def report(self) -> str:
        rows = sorted(self.totals.items(), key=lambda kv: -kv[1])
        total = sum(self.totals.values())
        lines = [f"{name:24s} {t:8.3f}s  ({self.counts[name]}x, {100*t/max(total,1e-9):5.1f}%)"
                 for name, t in rows]
        return "\n".join(lines + [f"{'TOTAL':24s} {total:8.3f}s"])

    def as_json(self) -> str:
        return json.dumps({k: {"seconds": v, "count": self.counts[k]}
                           for k, v in self.totals.items()})


def counters() -> dict[str, int]:
    """The program's counters now, one name each: the launches of the
    hand-written kernels (their entry points' `.launches`; the smoothness
    kernel launches once an optimizer call on the card), the smoothness
    optimizer's steps and calls, and the waveforms w2v-BERT 2.0 encoded and
    the layers it ran over them. Two snapshots' difference counts what ran
    between them."""
    from knnsvc_torch.match.smoothness import optimize_smoothness_from_surrounding as opt
    from knnsvc_torch.models.w2vbert import W2VBert
    from knnsvc_torch.ops.attention import gated_bias_attention, gated_bias_attention_diag
    from knnsvc_torch.ops.concat_scan import concat_cost_pair
    from knnsvc_torch.ops.smoothness_adam import smoothness_adam
    from knnsvc_torch.ops.viterbi import f0_viterbi

    return {"attention.launches": gated_bias_attention.launches,
            "attention_diag.launches": gated_bias_attention_diag.launches,
            "concat_cost_pair.launches": concat_cost_pair.launches,
            "f0_viterbi.launches": f0_viterbi.launches,
            "smoothness_adam.launches": smoothness_adam.launches,
            "smoothness.steps": opt.steps, "smoothness.runs": opt.runs,
            "w2vbert.chunks": W2VBert.chunks, "w2vbert.layers_run": W2VBert.layers_run}
