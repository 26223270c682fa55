"""Compares the attention kernel's diagonal entry, and the served pair that
runs it, across checkouts on a CUDA card, in turns on the same card:

    git archive PARENT | tar -x -C /some/ignored/dir
    python tools/attention_ab.py /some/ignored/dir . . /some/ignored/dir

Each checkout runs in a process of its own, which builds that checkout's
kernel. Per checkout: the diagonal entry (`gated_bias_attention_diag`, or
`gated_bias_attention` in checkouts that predate the full-bias entry) on
seeded inputs at (16, 1500, 64), the main path's shape: the SHA-256 of its
output and the CUDA-event mean over 50 calls after 3 warm-up calls, and the
same for the full-bias entry on a seeded (16, 1500, 1500) bias where the
checkout has both entries; then
KnnSvc.random_init("mix", seed=0) converting a seeded 30-s sung pair
(convert_waveform, without and with post_opt_0.2): the SHA-256 of each
float waveform and the entry's launches. Prints one `AB` line per checkout
and measurement, then the card's name and power limit, and fails if the
checkouts' digests differ.
"""

import hashlib
import os
import subprocess
import sys
import tempfile

SR = 16000
SHAPE = (16, 1500, 64)
PAIR_SECONDS = 30.0
VOICES = ((190.0, 21), (265.0, 22))     # f0 in Hz, seed: the source, the target
RUNS = 50


def sung_wav(hz: float, seed: int):
    import numpy as np

    rng = np.random.default_rng(seed)
    t = np.arange(int(SR * PAIR_SECONDS)) / SR
    phase = 2 * np.pi * np.cumsum(hz * (1 + 0.04 * np.sin(2 * np.pi * 5 * t))) / SR
    wav = 0.3 * np.sin(phase) + 0.1 * np.sin(2 * phase) + 0.02 * rng.standard_normal(len(t))
    wav *= 0.5 + 0.5 * np.abs(np.sin(2 * np.pi * 0.7 * t))
    return np.clip(wav, -0.99, 0.99).astype(np.float32)


def digest(t) -> str:
    return hashlib.sha256(t.detach().cpu().numpy().tobytes()).hexdigest()[:16]


def run_checkout(root: str) -> None:
    import torch

    sys.path.insert(0, root)
    os.chdir(root)
    from knnsvc_torch.hub import KnnSvc
    from knnsvc_torch.io.audio import save_audio
    from knnsvc_torch.ops import attention
    from knnsvc_torch.precision import set_precision

    diag_entry = getattr(attention, "gated_bias_attention_diag", attention.gated_bias_attention)
    set_precision("highest")
    dev = torch.device("cuda", 0)
    gen = torch.Generator().manual_seed(1)
    H, T, d = SHAPE
    args = [torch.randn(shape, generator=gen).to(dev)
            for shape in ((H, T, d), (H, T, d), (H, T, d), (H, 2 * T - 1))]
    args.append((torch.rand(H, T, generator=gen) * 2).to(dev))
    out = diag_entry(*args)
    for _ in range(3):
        diag_entry(*args)
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(RUNS):
        diag_entry(*args)
    end.record()
    torch.cuda.synchronize()
    print(f"AB {root} {diag_entry.__name__} {SHAPE}: {start.elapsed_time(end) / RUNS:.4f} ms, "
          f"output sha256 {digest(out)}", flush=True)
    if diag_entry is not attention.gated_bias_attention:   # the full-bias entry too
        full_args = [*args[:3], torch.randn((H, T, T), generator=gen).to(dev), args[4]]
        full_out = attention.gated_bias_attention(*full_args)
        for _ in range(3):
            attention.gated_bias_attention(*full_args)
        torch.cuda.synchronize()
        start.record()
        for _ in range(RUNS):
            attention.gated_bias_attention(*full_args)
        end.record()
        torch.cuda.synchronize()
        print(f"AB {root} gated_bias_attention (full bias) {SHAPE}: "
              f"{start.elapsed_time(end) / RUNS:.4f} ms, output sha256 {digest(full_out)}",
              flush=True)

    knn = KnnSvc.random_init("mix", seed=0, device=dev)
    with tempfile.TemporaryDirectory() as tmp:
        paths = []
        for name, (hz, seed) in zip(("src", "ref"), VOICES):
            paths.append(os.path.join(tmp, f"{name}.wav"))
            save_audio(paths[-1], sung_wav(hz, seed), SR)
        for post_opt in ("no_post_opt", "post_opt_0.2"):
            diag_entry.launches = 0
            wav = knn.convert_waveform(*paths, post_opt=post_opt)
            torch.cuda.synchronize()
            print(f"AB {root} pair {post_opt}: {diag_entry.__name__} launches "
                  f"{diag_entry.launches}, {wav.shape[0]} samples, waveform sha256 "
                  f"{digest(wav)}", flush=True)


def main(argv: list[str]) -> int:
    if len(argv) == 2 and argv[0] == "--one":
        run_checkout(os.path.abspath(argv[1]))
        return 0
    if not argv:
        raise SystemExit(__doc__)
    digests = {}
    for root in argv:
        proc = subprocess.run([sys.executable, os.path.abspath(__file__), "--one", root],
                              check=True, capture_output=True, text=True)
        print(proc.stdout, end="", flush=True)
        digests[root] = [ln.split("sha256 ")[1] for ln in proc.stdout.splitlines()
                         if ln.startswith("AB ")]
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True)
    print(smi.stdout.strip().splitlines()[0], flush=True)
    if len({tuple(v) for v in digests.values()}) != 1:
        raise SystemExit(f"the checkouts' outputs differ: {digests}")
    print("AB digests equal across the checkouts", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
