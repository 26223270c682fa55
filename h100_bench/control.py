"""Readings of the compared numbers over many seeds in one process, from
which limits/<cell>.json is set (the benchmark's own runs do not run this):

    python3 h100_bench/control.py --workload <cell> --seeds 1,2,3 [--program] [--control]

--program: the program's readings, what the timed path produced (the
sampled requests, or a training cell's first steps) held to the plain
reference. --control: the control's, the reference computed in the nearest
precision below the configuration's (TF32 for float32) put in the program's
place. --half-batch (training cells): the reference with half of each batch
left out in the program's place. One JSON line per seed and side.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import tempfile
import time

REPO_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if REPO_ROOT not in sys.path:
    sys.path.insert(0, REPO_ROOT)

from h100_bench.harness import RunContext, driver_for, load_cell  # noqa: E402


def readings(workload: str, seed: int, side: str, device: str = "cuda",
             root: str = REPO_ROOT) -> dict[str, float]:
    """One seed's readings: side 'program', 'control' (the reference in
    TF32) or 'reference' (the reference in float32 against itself)."""
    cell = load_cell(workload, root)
    driver = driver_for(cell)
    with tempfile.TemporaryDirectory(prefix="h100_bench_control_") as tmp:
        ctx = RunContext(seed=seed, seconds=0.0, trace=False, device=device, tmpdir=tmp,
                         start_wall=time.time())
        if side == "program":
            return driver.program_readings(cell, ctx)
        if side == "half_batch":
            return driver.half_batch_readings(cell, ctx)
        return driver.control_readings(cell, ctx, control=side == "control")


def main(argv=None) -> int:
    p = argparse.ArgumentParser()
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True)
    p.add_argument("--program", action="store_true")
    p.add_argument("--control", action="store_true")
    p.add_argument("--half-batch", action="store_true",
                   help="training cells: the reference with half of each batch left out")
    args = p.parse_args(argv)
    sides = [s for s, on in (("program", args.program), ("control", args.control),
                             ("half_batch", args.half_batch)) if on]
    for seed in (int(s) for s in args.seeds.split(",")):
        for side in sides:
            t0 = time.time()
            r = readings(args.workload, seed, side)
            print(json.dumps({"workload": args.workload, "seed": seed, "side": side,
                              "seconds": time.time() - t0, "readings": r}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
