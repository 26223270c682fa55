"""Times the dense concat-cost kernel entry (knnsvc_torch.ops.concat_scan.
concat_cost_pair) of one or more checkouts on a CUDA card, to compare two
commits in turns on the same card:

    git archive PARENT | tar -x -C /some/ignored/dir
    python tools/concat_ab.py /some/ignored/dir . . /some/ignored/dir

Each checkout runs in a process of its own, which builds that checkout's
kernel. Per checkout and k in (4, 8): a seeded (1500, 1500, 1024) pool and
source (a 30-s pool at WavLM width), 3 warm-up calls, then the CUDA-event
mean over 30 (k = 4) or 8 (k = 8) calls.
"""

import os
import subprocess
import sys

T = P = 1500
D = 1024
RUNS = {4: 30, 8: 8}


def time_checkout(root: str) -> None:
    import numpy as np
    import torch

    sys.path.insert(0, root)
    os.chdir(root)
    from knnsvc_torch.ops.concat_scan import concat_cost_pair

    dev = torch.device("cuda", 0)
    rng = np.random.default_rng(4)
    for k, n in RUNS.items():
        to = lambda a: torch.from_numpy(a).to(dev)
        src = to(rng.standard_normal((T, D)).astype(np.float32))
        tgt = to(rng.standard_normal((P, D)).astype(np.float32))
        idx_u, idx_p = to(rng.integers(0, P, (T, k))), to(rng.integers(0, P, (T, k)))
        sf0 = to((80 + 300 * rng.random(T)).astype(np.float32))
        tf0 = to((80 + 300 * rng.random(P)).astype(np.float32))
        for _ in range(3):
            concat_cost_pair(idx_u, idx_p, src, tgt, sf0, tf0)
        torch.cuda.synchronize()
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(n):
            concat_cost_pair(idx_u, idx_p, src, tgt, sf0, tf0)
        end.record()
        torch.cuda.synchronize()
        print(f"AB {root} k={k} dense concat_cost_pair ({T},{P},{D}): "
              f"{start.elapsed_time(end) / n:.4f} ms", flush=True)


def main(argv: list[str]) -> int:
    if len(argv) == 2 and argv[0] == "--one":
        time_checkout(os.path.abspath(argv[1]))
        return 0
    if not argv:
        raise SystemExit(__doc__)
    for root in argv:
        subprocess.run([sys.executable, os.path.abspath(__file__), "--one", root], check=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main(sys.argv[1:]))
