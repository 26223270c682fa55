"""Times the f0 Viterbi kernel (knnsvc_torch.ops.viterbi.f0_viterbi) of one
or more checkouts on a CUDA card, to compare two commits in turns on the
same card:

    git archive PARENT | tar -x -C /some/ignored/dir
    python tools/viterbi_ab.py /some/ignored/dir . . /some/ignored/dir

Each checkout runs in a process of its own, which builds that checkout's
kernel. Per checkout, device f0's costs of a seeded 30-s sung wav with a
silent first second (as chip_smoke.py's Viterbi phase makes them) at
(1501, 482), the main path's shape, and of its first streaming window at
(200, 482): the states checked against the checkout's plain version on
every frame, 3 warm-up calls, then the CUDA-event mean over 50 calls.
Prints one `AB` line per checkout and shape, then the card's name and
power limit.
"""

import os
import subprocess
import sys

SR, HOP = 16000, 320
SECONDS, HZ, SEED = 30.0, 190.0, 21
N_MAIN, N_WINDOW = 1501, 200
RUNS = 50


def sung_wav():
    import numpy as np

    rng = np.random.default_rng(SEED)
    t = np.arange(int(SR * SECONDS)) / SR
    phase = 2 * np.pi * np.cumsum(HZ * (1 + 0.04 * np.sin(2 * np.pi * 5 * t))) / SR
    wav = 0.3 * np.sin(phase) + 0.1 * np.sin(2 * phase) + 0.02 * rng.standard_normal(len(t))
    wav *= 0.5 + 0.5 * np.abs(np.sin(2 * np.pi * 0.7 * t))
    wav[:SR] = 0.0
    return np.clip(wav, -0.99, 0.99).astype(np.float32)


def time_checkout(root: str) -> None:
    import torch
    import torch.nn.functional as F

    sys.path.insert(0, root)
    os.chdir(root)
    from knnsvc_torch.dsp.f0_device import viterbi_inputs
    from knnsvc_torch.ops.viterbi import f0_viterbi, viterbi_plain

    dev = torch.device("cuda", 0)
    x = torch.from_numpy(sung_wav()).to(dev)
    shapes = {N_MAIN: viterbi_inputs(x, SR, N_MAIN),
              N_WINDOW: viterbi_inputs(F.pad(x[:N_WINDOW * HOP], (0, HOP)), SR, N_WINDOW)}
    for n, args in shapes.items():
        got = f0_viterbi(*args)
        torch.cuda.synchronize()
        equal = float((got == viterbi_plain(*args)).float().mean())
        for _ in range(3):
            f0_viterbi(*args)
        torch.cuda.synchronize()
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(RUNS):
            f0_viterbi(*args)
        end.record()
        torch.cuda.synchronize()
        ms = start.elapsed_time(end) / RUNS
        print(f"AB {root} f0_viterbi ({n}, {args[0].shape[1]}): {ms:.4f} ms, "
              f"{1e3 * ms / (n - 1):.4f} us per frame; states equal to the plain version on "
              f"{equal:.2%} of frames", flush=True)
        if equal != 1.0:
            raise SystemExit(f"{root}: f0_viterbi disagrees with its plain version at n={n}")


def main(argv: list[str]) -> int:
    if len(argv) == 2 and argv[0] == "--one":
        time_checkout(os.path.abspath(argv[1]))
        return 0
    if not argv:
        raise SystemExit(__doc__)
    for root in argv:
        subprocess.run([sys.executable, os.path.abspath(__file__), "--one", root], check=True)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True)
    print(smi.stdout.strip().splitlines()[0], flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
