"""One traced run of a benchmark cell, its trace reduced further than the
benchmark's readers go: by both span levels, with every idle interval
charged to a host span, and with the program's counters over the traced
requests alone.

    python3 tools/trace_split.py --workload mix.pair_new --seed 123 [--seconds 30]

Runs `h100_bench/run.py --trace 1` in this process (its result line comes
first), keeping the profiler's events and a `utils.profiling.counters()`
snapshot at each of the tracer's steps. Then prints one JSON line, also
written to chiprun_out/trace_split.<cell>.<seed>.json, a traced request
each where not said otherwise:

- `part_device_ms`, `part_host_ms`: device time of the operations whose
  launch has a `knnsvc:<part>` span as its first `knnsvc` ancestor, and the
  part spans' host time;
- `span_device_ops`: device operations charged to each `knnsvc.<stage>`
  span by the harness's rule (the innermost `knnsvc.` span above the
  launch); `f0_device_launches` adds `f0_device` and `f0_viterbi`;
- `idle_ms_by_span`: every idle interval of the traced requests (from the
  first one's start to the last one's end), divided among the innermost
  span of either level open on the requests' thread over it ("none":
  outside every span); `file_io_idle_ms`, the idle time under `load_wav`
  and `write_wav`;
- `request_idle_pct`: one minus the device's busy time over the host time
  of the root spans `knnsvc.convert_pair`;
- `counters`: each counter's change over the traced requests, and
  `smoothness_steps` a traced request, with `smoothness_step_host_us` and
  `smoothness_launches_per_step` over those steps;
- `latency_ratio`: each traced request's latency over the median untraced
  latency of the same pair in the window: the tracer's cost.

Fields the benchmark's result line has already are left out. Once
`h100_bench/harness.py::reduce_trace` computes these reductions itself, as
`split` does, and `drivers/pair.py` keeps the counters over the traced
requests, this tool has nothing left to add and is to be deleted.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)


class _CountingTracer:
    """The harness's tracer, with a counters() snapshot at each step."""

    def __init__(self, prof, snapshots):
        self._prof, self._snapshots = prof, snapshots

    def step(self):
        self._prof.step()
        try:
            from knnsvc_torch.utils.profiling import counters
        except ImportError:         # a program without counters: nothing to snapshot
            self._snapshots.append({})
        else:
            self._snapshots.append(counters())

    def __getattr__(self, name):
        return getattr(self._prof, name)


def _segments(spans):
    """Properly nested (start, end, name) spans of one thread -> the
    timeline of innermost names, [(start, end, name)]; time outside every
    span is left out."""
    out, stack, t = [], [], None        # stack: (end, name), innermost last

    def close_until(time):
        nonlocal t
        while stack and stack[-1][0] <= time:
            end, name = stack.pop()
            if end > t:
                out.append((t, end, name))
            t = max(t, end)

    for s, e, name in sorted(spans, key=lambda x: (x[0], -x[1])):
        close_until(s)
        if stack and s > t:
            out.append((t, s, stack[-1][1]))
        stack.append((e, name))
        t = s
    close_until(float("inf"))
    return out


def split(events) -> dict:
    """The reductions of the module docstring over the whole trace."""
    from torch.autograd import DeviceType

    from h100_bench.harness import SPAN_PREFIX, _device_events

    cpu = [e for e in events if e.device_type == DeviceType.CPU]
    spans = [e for e in cpu if e.name.startswith("knnsvc")]
    roots = [e for e in spans if e.name == "knnsvc.convert_pair"]
    runtime = {e.id: e for e in cpu if e.name.startswith("cu")}
    part_host = {}
    for e in spans:
        if e.name.startswith("knnsvc:"):
            part_host[e.name[7:]] = part_host.get(e.name[7:], 0.0) + e.time_range.elapsed_us()

    dev = _device_events(events)
    part_dev, ops, intervals = {}, {}, []
    for e in dev:
        intervals.append((e.time_range.start, e.time_range.end))
        p = runtime.get(e.id)
        first = p
        while first is not None and not first.name.startswith("knnsvc"):
            first = first.cpu_parent
        if first is not None and first.name.startswith("knnsvc:"):
            name = first.name[7:]
            part_dev[name] = part_dev.get(name, 0.0) + e.time_range.elapsed_us()
        while p is not None and not p.name.startswith(SPAN_PREFIX):
            p = p.cpu_parent
        stage = p.name[len(SPAN_PREFIX):] if p is not None else "other"
        ops[stage] = ops.get(stage, 0) + 1

    intervals.sort()
    gaps = []
    if intervals:
        # the idle stretches between device operations, and those of the
        # requests before their first operation and after their last
        start = min([intervals[0][0]] + [e.time_range.start for e in roots])
        last = max([intervals[-1][1]] + [e.time_range.end for e in roots])
        hi = start
        for s, end in intervals + [(last, last)]:
            if s > hi:
                gaps.append((hi, s))
            hi = max(hi, end)
    thread = roots[0].thread if roots else None
    timeline = _segments([(e.time_range.start, e.time_range.end, e.name) for e in spans
                          if e.thread == thread])
    idle, i = {}, 0
    for a, b in gaps:
        covered = 0.0
        while i < len(timeline) and timeline[i][1] <= a:
            i += 1
        j = i
        while j < len(timeline) and timeline[j][0] < b:
            s, e, name = timeline[j]
            us = min(b, e) - max(a, s)
            if us > 0:
                idle[name[7:]] = idle.get(name[7:], 0.0) + us
                covered += us
            j += 1
        idle["none"] = idle.get("none", 0.0) + (b - a) - covered
    root_us = sum(e.time_range.elapsed_us() for e in roots)
    return {"part_device_us": part_dev, "part_host_us": part_host, "span_device_ops": ops,
            "idle_us_by_span": idle, "root_host_us": root_us}


def main(argv=None, root: str = REPO) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, default=30.0)
    args = p.parse_args(argv)

    import torch

    from h100_bench import harness, run

    kept, snapshots = {}, []
    reduce_trace, start_tracer = harness.reduce_trace, harness.start_tracer

    def keep_reduce(events, window_s):
        view = reduce_trace(events, window_s)
        kept["split"], kept["view"] = split(events), view
        return view

    harness.reduce_trace = keep_reduce
    harness.start_tracer = lambda cuda: _CountingTracer(start_tracer(cuda), snapshots)
    device = "cuda" if torch.cuda.is_available() else "cpu"
    rc = run.main(["--workload", args.workload, "--seed", str(args.seed), "--seconds",
                   str(args.seconds), "--trace", "1"], root=root, device=device)
    if rc != 0 or "view" not in kept:
        return rc or 1
    view, sp = kept["view"], kept["split"]
    n = len(view.units)
    # the first step ends the tracer's warm-up request, the last the last traced one
    delta = {k: snapshots[-1][k] - snapshots[0][k] for k in snapshots[0]}
    steps = delta.get("smoothness.steps", 0)
    per_request_steps = [b["smoothness.steps"] - a["smoothness.steps"]
                         for a, b in zip(snapshots, snapshots[1:]) if a]
    untraced = {}
    for u in view.window_units:
        untraced.setdefault((u["src_s"], u["tgt_s"]), []).append(u["wall_s"])
    ratios = [u["wall_s"] / statistics.median(untraced[(u["src_s"], u["tgt_s"])])
              for u in view.units if (u["src_s"], u["tgt_s"]) in untraced]
    idle = sp["idle_us_by_span"]
    ops = sp["span_device_ops"]
    out = {
        "workload": args.workload, "seed": args.seed, "traced_requests": n,
        "torch": torch.__version__,
        "card": torch.cuda.get_device_name(0) if device == "cuda" else "cpu",
        "part_device_ms": {k: v / 1e3 / n for k, v in sp["part_device_us"].items()},
        "part_host_ms": {k: v / 1e3 / n for k, v in sp["part_host_us"].items()},
        "span_device_ops": {k: v / n for k, v in ops.items()},
        "f0_device_launches": (ops.get("f0_device", 0) + ops.get("f0_viterbi", 0)) / n,
        "idle_ms_by_span": {k: v / 1e3 / n for k, v in sorted(idle.items(),
                                                              key=lambda kv: -kv[1])},
        "request_idle_pct": (100.0 * (1.0 - view.busy_s * 1e6 / sp["root_host_us"])
                             if sp["root_host_us"] and view.has_device else None),
        "file_io_idle_ms": (idle.get("load_wav", 0.0) + idle.get("write_wav", 0.0)) / 1e3 / n,
        "counters": {k: v / n for k, v in delta.items()},
        "smoothness_steps_traced": per_request_steps,
        "smoothness_step_host_us": (1e3 * view.host_ms("smoothness") / steps if steps else None),
        "smoothness_launches_per_step": ops.get("smoothness", 0) / steps if steps else None,
        "latency_ratio": ratios,
        "latency_ratio_median": statistics.median(ratios) if ratios else None,
    }
    line = json.dumps(out)
    print(line, flush=True)
    os.makedirs(os.path.join(root, "chiprun_out"), exist_ok=True)
    with open(os.path.join(root, "chiprun_out",
                           f"trace_split.{args.workload}.{args.seed}.json"), "w") as f:
        f.write(line + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
