"""What every run shares: finding a cell's files by name, the device checks,
the reduction of a torch.profiler trace to spans and kernels, the check of
the loaded modules, and the result line.

A cell names a configuration (configs/<name>.json, the file BENCHMARK.json
gives) and a traffic mix (traffic/<name>.json), which names its driver
(drivers/<driver>.py); each per-layer metric is read by metrics/<name>.py.
Nothing here changes when a cell, a mix or a metric is added.
"""

from __future__ import annotations

import importlib.util
import json
import os
import sys
from dataclasses import dataclass, field
from types import ModuleType

BENCH_DIR = os.path.dirname(os.path.abspath(__file__))
REPO_ROOT = os.path.dirname(BENCH_DIR)
# compared by whole top-level module name: the port's name begins with the
# JAX package's, so a prefix test would be wrong
FORBIDDEN_MODULES = ("jax", "jaxlib", "flax", "knnsvc_tpu", "bench", "chip_smoke")
SPAN_PREFIX = "knnsvc."


class BenchError(Exception):
    """A run that cannot give a result: printed on stderr, exit code 2."""


def load_json(path: str) -> dict:
    with open(path) as f:
        return json.load(f)


def load_module(path: str, name: str) -> ModuleType:
    """Import a file of the benchmark by its path (names may hold dots)."""
    if not os.path.isfile(path):
        raise BenchError(f"missing file {os.path.relpath(path, REPO_ROOT)}")
    spec = importlib.util.spec_from_file_location(name, path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


@dataclass
class Cell:
    """One workload of BENCHMARK.json with its files read."""

    name: str
    chips: int
    config: dict
    traffic: dict
    traffic_name: str
    end_to_end: list[dict]      # the cell's end-to-end metrics
    per_layer: list[dict]       # the cell's per-layer metrics
    limits: dict                # limits/<cell>.json: the compared numbers' limits
    root: str


def _applies(metric: dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def load_cell(name: str, root: str = REPO_ROOT) -> Cell:
    """The cell `name` of <root>/BENCHMARK.json, its configuration, traffic
    and limits, found by name."""
    bench = load_json(os.path.join(root, "BENCHMARK.json"))
    cells = {w["name"]: w for w in bench["workloads"]}
    if name not in cells:
        raise BenchError(f"no workload {name!r} in BENCHMARK.json: {sorted(cells)}")
    w = cells[name]
    configs = {c["name"]: c for c in bench["configs"]}
    config = load_json(os.path.join(root, configs[w["config"]]["file"]))
    bench_dir = os.path.join(root, os.path.basename(BENCH_DIR))
    traffic = load_json(os.path.join(bench_dir, "traffic", f"{w['traffic']}.json"))
    limits_path = os.path.join(bench_dir, "limits", f"{name}.json")
    limits = load_json(limits_path) if os.path.isfile(limits_path) else {}
    end_to_end = [m for m in bench["end_to_end"] if _applies(m, name)]
    per_layer = [m for m in bench["per_layer"] if _applies(m, name)]
    return Cell(name, int(w["chips"]), config, traffic, w["traffic"], end_to_end, per_layer,
                limits, root)


def driver_for(cell: Cell) -> ModuleType:
    return load_module(os.path.join(cell.root, os.path.basename(BENCH_DIR), "drivers",
                                    f"{cell.traffic['driver']}.py"),
                       f"h100_bench_driver_{cell.traffic['driver']}")


def metric_reader(cell: Cell, name: str) -> ModuleType:
    return load_module(os.path.join(cell.root, os.path.basename(BENCH_DIR), "metrics",
                                    f"{name}.py"),
                       "h100_bench_metric_" + name.replace(".", "_"))


def forbidden_loaded() -> list[str]:
    """Modules of JAX, flax, the JAX package or the old benchmark that this
    process holds, by whole top-level name."""
    tops = {m.split(".", 1)[0] for m in list(sys.modules)}
    return sorted(t for t in tops if t in FORBIDDEN_MODULES)


@dataclass
class RunContext:
    """What the command line and the harness give a driver."""

    seed: int
    seconds: float
    trace: bool
    device: str
    tmpdir: str                 # the run's own temporary directory
    start_wall: float           # time.time() when the process started


@dataclass
class RunResult:
    """What a driver gives back: counts, the end-to-end values by metric
    name, every reading and the compared ones beside their limits, the peak
    device memory and, when traced, the reduced trace."""

    attempted: int
    failed: int
    end_to_end: dict
    readings: dict
    checks: list
    memory_peak_bytes: int
    view: "TraceView | None" = None


# ------------------------------------------------------------------ traces

@dataclass
class TraceView:
    """A traced stretch of a run, reduced: per knnsvc.* span its host time
    and the device time launched from it (each device event charged to the
    innermost span open at its launch), device time by kernel name, the
    device's busy time, the stretch's wall time, and what the driver knows
    of each traced unit (a request or a step); and of the untraced window
    that the traced units follow, its units and its wall seconds on the
    host's clock."""

    window_s: float
    busy_s: float
    n_device_events: int
    span_host_us: dict[str, float] = field(default_factory=dict)
    span_device_us: dict[str, float] = field(default_factory=dict)
    kernel_us: dict[str, float] = field(default_factory=dict)
    kernel_count: dict[str, int] = field(default_factory=dict)
    idle_gaps: list = field(default_factory=list)     # [[span name, seconds], ...]
    units: list[dict] = field(default_factory=list)
    window_units: list[dict] = field(default_factory=list)
    window_wall_s: float = 0.0
    config: dict = field(default_factory=dict)
    traffic: dict = field(default_factory=dict)

    @property
    def has_device(self) -> bool:
        return self.n_device_events > 0 and self.busy_s > 0

    def host_ms(self, span: str) -> float:
        return self.span_host_us.get(span, 0.0) / 1e3

    def device_ms(self, span: str) -> float:
        return self.span_device_us.get(span, 0.0) / 1e3

    def kernel_ms(self, substring: str) -> float:
        return sum(us for k, us in self.kernel_us.items() if substring in k) / 1e3

    def launches(self, substring: str) -> int:
        return sum(n for k, n in self.kernel_count.items() if substring in k)

    def device_ops(self, top: int = 10) -> list:
        return [[k, us / 1e6] for k, us in
                sorted(self.kernel_us.items(), key=lambda kv: -kv[1])[:top]]


def start_tracer(cuda: bool):
    """A started torch.profiler. Its first unit, a request or a step ended by
    `step()`, warms the tracer up and is left out of the trace; what follows
    is recorded until `stop()`."""
    from torch.profiler import ProfilerActivity, profile, schedule

    activities = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda else [])
    prof = profile(activities=activities, schedule=schedule(wait=0, warmup=1, active=10**6))
    prof.start()
    return prof


def _device_events(events):
    """Kernels and copies on the card, not the device-side copies of the
    record_function spans (chip_smoke.py:3628-3634)."""
    from torch.autograd import DeviceType

    return [e for e in events if e.device_type == DeviceType.CUDA
            and not getattr(e, "is_user_annotation", False)
            and not e.name.startswith(SPAN_PREFIX)]


def reduce_trace(events, window_s: float) -> TraceView:
    """Reduce torch.profiler's events. A device event carries the
    correlation id of the host runtime call that launched it; that call is
    charged to the innermost knnsvc.* span above it (chip_smoke.py:3600-3625).
    A launch from another thread (autograd's backward) has no such parent:
    it goes to the innermost span open at its launch time on any thread
    (chip_smoke.py:3575-3586)."""
    from torch.autograd import DeviceType

    spans, runtime = [], {}
    view = TraceView(window_s=window_s, busy_s=0.0, n_device_events=0)
    for e in events:
        if e.device_type != DeviceType.CPU:
            continue
        if e.name.startswith(SPAN_PREFIX):
            name = e.name[len(SPAN_PREFIX):]
            view.span_host_us[name] = view.span_host_us.get(name, 0.0) + e.time_range.elapsed_us()
            spans.append((e.time_range.start, e.time_range.end, name))
        elif e.name.startswith("cu"):
            runtime[e.id] = e
    spans.sort()

    def innermost_at(t):
        best = None
        for s, end, name in spans:
            if s > t:
                break
            if s <= t <= end and (best is None or s >= best[0]):
                best = (s, name)
        return None if best is None else best[1]

    dev = _device_events(events)
    view.n_device_events = len(dev)
    intervals = []
    for e in dev:
        us = e.time_range.elapsed_us()
        view.kernel_us[e.name] = view.kernel_us.get(e.name, 0.0) + us
        view.kernel_count[e.name] = view.kernel_count.get(e.name, 0) + 1
        intervals.append((e.time_range.start, e.time_range.end))
        launch = runtime.get(e.id)
        p = launch
        while p is not None and not p.name.startswith(SPAN_PREFIX):
            p = p.cpu_parent
        if p is not None:
            name = p.name[len(SPAN_PREFIX):]
        else:
            t = launch.time_range.start if launch is not None else e.time_range.start
            name = innermost_at(t) or "unattributed"
        view.span_device_us[name] = view.span_device_us.get(name, 0.0) + us
    intervals.sort()
    gaps = []
    if intervals:
        busy, (lo, hi) = 0.0, intervals[0]
        for s, end in intervals[1:]:
            if s > hi:
                busy += hi - lo
                gaps.append((hi, s))
                lo = s
            hi = max(hi, end)
        busy += hi - lo
        view.busy_s = busy / 1e6
    gaps.sort(key=lambda g: g[0] - g[1])
    # a gap is named by the innermost span open at its middle ("none": the
    # host was outside every span, in the benchmark's own code)
    view.idle_gaps = [[innermost_at((a + b) / 2) or "none", (b - a) / 1e6] for a, b in gaps[:10]]
    return view


# ------------------------------------------------------------------ output

def emit(result: dict, checks: list[tuple[str, float, float]]) -> None:
    """The checks on stderr's last lines and the result as stdout's last
    line, with the checks under the key that comes last."""
    for name, value, limit in checks:
        ok = value <= limit
        print(f"check {name} = {value!r} limit {limit!r} {'ok' if ok else 'FAILED'}",
              file=sys.stderr)
    result = dict(result)
    result["checks"] = {name: {"value": value, "limit": limit} for name, value, limit in checks}
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
