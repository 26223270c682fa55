"""The benchmark of knnsvc_torch on one NVIDIA H100.

    python3 h100_bench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Runs one cell of BENCHMARK.json on the card this process sees and prints,
as the last line of standard output, one JSON object: `correct`,
`attempted`, `failed`, `metrics` (the cell's end-to-end metrics, or with
--trace 1 its per-layer ones), `device`, with --trace 1 `breakdown`, and
last `checks`, each compared number beside its limit (also the last lines
of standard error). Exits non-zero with no result when torch sees fewer
CUDA devices than the cell asks for, or when JAX, flax or the JAX package
is loaded once the window has closed.
"""

from __future__ import annotations

import time

START_WALL = time.time()

import argparse  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
import tempfile  # noqa: E402
import traceback  # noqa: E402

REPO_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if REPO_ROOT not in sys.path:
    sys.path.insert(0, REPO_ROOT)

from h100_bench.harness import (BenchError, RunContext, driver_for,  # noqa: E402
                                emit, forbidden_loaded, load_cell, metric_reader)


def process_start_wall() -> float:
    """Wall time at which this process started (Linux /proc), or when this
    module was first imported."""
    try:
        with open("/proc/self/stat") as f:
            start_ticks = int(f.read().rsplit(")", 1)[1].split()[19])
        with open("/proc/uptime") as f:
            uptime = float(f.read().split()[0])
        return time.time() - (uptime - start_ticks / os.sysconf("SC_CLK_TCK"))
    except (OSError, ValueError, IndexError):
        return START_WALL


def parse(argv=None) -> argparse.Namespace:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def device_info(device: str, chips: int, peak: int) -> dict:
    import torch

    if device == "cuda":
        return {"platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": chips,
                "memory_peak_bytes": peak}
    return {"platform": "cpu", "kind": "cpu", "count": 1, "memory_peak_bytes": peak}


def main(argv=None, root: str = REPO_ROOT, device: str = "cuda") -> int:
    """One run. `device='cpu'` skips the look for a card (the CPU tests)."""
    args = parse(argv)
    cell = load_cell(args.workload, root)
    if device == "cuda":
        import torch

        if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
            raise BenchError(f"{cell.name} needs {cell.chips} CUDA device(s); torch sees "
                             f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}")
    driver = driver_for(cell)
    with tempfile.TemporaryDirectory(prefix="h100_bench_") as tmp:
        ctx = RunContext(seed=args.seed, seconds=args.seconds, trace=bool(args.trace),
                         device=device, tmpdir=tmp, start_wall=process_start_wall())
        res = driver.run(cell, ctx)

    metrics = {}
    if args.trace:
        for m in cell.per_layer:
            value = metric_reader(cell, m["name"]).read(res.view)
            if value is not None:
                metrics[m["name"]] = {"value": float(value), "unit": m["unit"]}
    else:
        for m in cell.end_to_end:
            if m["name"] not in res.end_to_end:
                raise BenchError(f"the driver gave no {m['name']}")
            metrics[m["name"]] = {"value": res.end_to_end[m["name"]], "unit": m["unit"]}
    dev_info = device_info(device, cell.chips, res.memory_peak_bytes)
    result = {"correct": bool(res.checks) and res.failed == 0
              and all(v <= lim for _, v, lim in res.checks),
              "attempted": res.attempted, "failed": res.failed, "metrics": metrics,
              "device": dev_info}
    if args.trace:
        view = res.view
        dev_info["busy_s"] = view.busy_s
        dev_info["window_s"] = view.window_s
        result["breakdown"] = {"device_ops": view.device_ops(), "idle_gaps": view.idle_gaps}
    for name, value in sorted(res.readings.items()):
        print(f"reading {name} = {value!r}", file=sys.stderr)
    found = forbidden_loaded()
    if found:
        print(f"h100_bench: loaded once the window closed: {', '.join(found)}", file=sys.stderr)
        return 3
    emit(result, res.checks)
    return 0


if __name__ == "__main__":
    try:
        sys.exit(main())
    except BenchError as e:
        print(f"h100_bench: {e}", file=sys.stderr)
        sys.exit(2)
    except Exception:  # noqa: BLE001 - any fault ends the run without a result
        traceback.print_exc()
        sys.exit(1)
