#!/usr/bin/env python3
"""Smoke run of knnsvc_torch, the PyTorch/CUDA port, on one CUDA card.

    python3 chip_smoke.py          # from the repository root; needs one card

Phases (any failure exits non-zero, before the result line):
  1. build the CUDA kernel from knnsvc_torch/csrc (nvcc, sm_90a) and print
     ptxas's register / shared-memory / spill lines;
  2. each kernel against its plain PyTorch version on the card, at the main
     path's shape and at ragged shapes, with CUDA-event times of the kernel,
     the plain version and one PyTorch library call, beside the kernel's
     bound on an H100;
  3. the slice on the card against the slice on the CPU: one full-width
     KnnSvc.random_init("mix") (WavLM-Large, HiFi-GAN v1 config), the same
     weights on both, "highest" precision, a seeded 4-s synthetic singing
     pair with f0 sidecars: layer-6 features, top-32 kNN sets, pre-quantize
     waveforms;
  4. the main path at full size: KnnSvc.convert_pair(fast=True) on a seeded
     30-s pair, once cold, then warm on new pairs (host f0 extracted) and
     repeated (f0 read from its cache); each run must launch the attention
     kernel exactly 12 times (6 encoder layers x 2 pools); one traced run of
     each kind, split by stage from the knnsvc.* profiler spans;
  5. the card's name and power limit (nvidia-smi).
The line before the last is the kernels' JSON record; the last line is
{"ok": true, "device": {...}}. Without a CUDA device, or outside the
repository, it fails and prints no result.
"""

import json
import os
import shutil
import statistics
import subprocess
import sys
import tempfile
import time

# H100 SXM published peaks (NVIDIA data sheet), for the bounds
PEAK_FP32_FLOPS = 67e12          # fp32 outside the tensor cores
PEAK_BYTES_PER_S = 3.35e12       # HBM3

ATTN_MAIN = (16, 1500, 64)       # one WavLM-Large layer on a 30-s chunk
ATTN_RAGGED = [(4, 200, 64, 1.0), (4, 200, 64, 0.0), (4, 200, 64, -0.5)]
# kernel vs plain: fp32 sums of 1500 terms per score and per output, in
# another order than cuBLAS and torch.softmax
ATTN_ATOL_MAIN = 1e-4
ATTN_ATOL_RAGGED = 2e-5
# cuda vs cpu, fp32 with TF32 off: cuDNN/cuBLAS/cuFFT sum in other orders
# than the CPU kernels, ~1e-6 relative per op through 7 convs and 6 layers
FEAT_ATOL = 1e-3
KNN_SET_SHARE_MIN = 0.95         # frames whose top-32 sets agree exactly
WAV_REL_TOL = 3e-3               # max |dwav| / max |wav|: 10x the 3.2e-4 the
                                 # card and the CPU have shown on this input
SLICE_SECONDS = 4.0
FULL_SECONDS = 30.0
WARM_RUNS = 20                   # repeat conversions (f0 read from its cache)
FRESH_RUNS = 5                   # conversions of pairs never seen (f0 extracted)
LAUNCHES_PER_PAIR = 12           # 6 early-exit layers x 2 pools x one 30-s chunk


def fail(msg: str) -> None:
    print(f"chip_smoke: FAIL: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def log(msg: str) -> None:
    print(msg, flush=True)


def cuda_ms(fn, iters: int = 20, warmup: int = 3) -> float:
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def attention_bound_ms(H: int, T: int, d: int) -> tuple[float, str]:
    """Least time for the work on an H100: 2 flops per multiply-add of the
    two products (4*H*T^2*d) plus 5 per score (scale-and-gate, max, exp,
    sum); bytes = q, k, v, bias, gate read once and out written once."""
    ops = 4 * H * T * T * d + 5 * H * T * T
    nbytes = 4 * (4 * H * T * d + H * T * T + H * T)
    t_ops, t_bytes = ops / PEAK_FP32_FLOPS, nbytes / PEAK_BYTES_PER_S
    return 1e3 * max(t_ops, t_bytes), ("operations" if t_ops >= t_bytes else "bytes")


def sung_wav(seconds: float, hz: float, seed: int):
    """A seeded synthetic singing voice (5 Hz vibrato, two harmonics, noise,
    phrasing) and its f0 track on the 20-ms frame grid (T//320 + 1 frames,
    as the extractors emit)."""
    import numpy as np

    def f0_at(t):
        return hz * (1 + 0.04 * np.sin(2 * np.pi * 5 * t))

    rng = np.random.default_rng(seed)
    t = np.arange(int(16000 * seconds)) / 16000
    phase = 2 * np.pi * np.cumsum(f0_at(t)) / 16000
    wav = 0.3 * np.sin(phase) + 0.1 * np.sin(2 * phase) + 0.02 * rng.standard_normal(len(t))
    wav *= 0.5 + 0.5 * np.abs(np.sin(2 * np.pi * 0.7 * t))
    frames = np.arange(len(t) // 320 + 1) * 320 / 16000
    return (np.clip(wav, -0.99, 0.99).astype(np.float32),
            f0_at(frames).astype(np.float32))


def phase_build():
    from knnsvc_torch.ops.build import build_kernel

    t0 = time.perf_counter()
    b = build_kernel("gated_bias_attention")
    log(f"[build] {b.name} in {time.perf_counter() - t0:.1f} s: {b.library.name}")
    for line in b.ptxas:
        log(f"[build] {b.name}: {line}")


def phase_kernels(dev):
    import torch
    import torch.nn.functional as F

    from knnsvc_torch.ops.attention import gated_bias_attention, reference_attention

    gen = torch.Generator().manual_seed(1)

    def inputs(H, T, d, gate_value=None):
        q, k, v = (torch.randn(H, T, d, generator=gen) for _ in range(3))
        bias = torch.randn(H, T, T, generator=gen)
        gate = (torch.rand(H, T, generator=gen) * 2 if gate_value is None
                else torch.full((H, T), gate_value))
        return [t.to(dev) for t in (q, k, v, bias, gate)]

    for H, T, d, g in ATTN_RAGGED:
        args = inputs(H, T, d, g)
        err = float((gated_bias_attention(*args) - reference_attention(*args)).abs().max())
        torch.cuda.synchronize()
        log(f"[kernel] gated_bias_attention ({H},{T},{d}) gate={g}: max_abs_err={err:.3e} "
            f"(atol {ATTN_ATOL_RAGGED})")
        if not err <= ATTN_ATOL_RAGGED:
            fail(f"gated_bias_attention disagrees at ({H},{T},{d}) gate={g}: {err}")

    H, T, d = ATTN_MAIN
    args = inputs(H, T, d)
    out = gated_bias_attention(*args)
    torch.cuda.synchronize()
    err = float((out - reference_attention(*args)).abs().max())
    log(f"[kernel] gated_bias_attention ({H},{T},{d}): max_abs_err={err:.3e} "
        f"(atol {ATTN_ATOL_MAIN})")
    if not (err <= ATTN_ATOL_MAIN and bool(torch.isfinite(out).all())):
        fail(f"gated_bias_attention disagrees at the main shape: {err}")

    q, k, v, bias, gate = args
    ms = cuda_ms(lambda: gated_bias_attention(*args))
    plain_ms = cuda_ms(lambda: reference_attention(*args))
    library_ms = cuda_ms(lambda: F.scaled_dot_product_attention(
        q[None], k[None], v[None], attn_mask=(gate[..., None] * bias)[None]))
    bound_ms, bound_by = attention_bound_ms(H, T, d)
    log(f"[kernel] gated_bias_attention ({H},{T},{d}): kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, "
        f"library (sdpa + mask product) {library_ms:.4f} ms, bound {bound_ms:.4f} ms "
        f"({bound_by}); roofline share {bound_ms / ms:.1%}")
    return {"name": "gated_bias_attention", "route": "cuda",
            "source": "knnsvc_torch/csrc/gated_bias_attention.cu",
            "replaces": "knnsvc_tpu/ops/attention.py:82",
            "launches": None, "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": bound_ms, "bound_by": bound_by, "library_ms": library_ms}


def write_pair(root: str, seconds: float, sidecars: bool):
    from knnsvc_torch.dsp.f0 import save_f0_sidecar
    from knnsvc_torch.io.audio import save_audio

    paths = []
    for name, hz, seed in (("src", 190.0, 21), ("ref", 265.0, 22)):
        wav, f0 = sung_wav(seconds, hz, seed)
        path = os.path.join(root, f"{name}_{int(seconds)}s.wav")
        save_audio(path, wav, 16000)
        if sidecars:
            save_f0_sidecar(path, f0)
        paths.append(path)
    return paths


def phase_slice_cpu_vs_cuda(root: str, dev):
    import numpy as np
    import torch

    from knnsvc_torch import HOP_LENGTH
    from knnsvc_torch.hub import KnnSvc
    from knnsvc_torch.match.knn import knn_topk
    from knnsvc_torch.match.pool import load_utterance

    src, ref = write_pair(root, SLICE_SECONDS, sidecars=True)
    t0 = time.perf_counter()
    gpu = KnnSvc.random_init("mix", seed=0, device=dev)
    cpu = KnnSvc.random_init("mix", seed=0, device="cpu")
    log(f"[slice] random_init x2 (full width) in {time.perf_counter() - t0:.1f} s")

    feats = {}
    with torch.no_grad():
        for name, path in (("src", src), ("ref", ref)):
            wav = load_utterance(path)
            wav = np.pad(wav, (0, HOP_LENGTH - len(wav) % HOP_LENGTH))[None]
            a = cpu.wavlm.extract_layer(torch.from_numpy(wav), 6)[0]
            b = gpu.wavlm.extract_layer(torch.from_numpy(wav).to(dev), 6)[0].cpu()
            err = float((a - b).abs().max())
            log(f"[slice] layer-6 features {name} {tuple(a.shape)}: max_abs_err={err:.3e} "
                f"(max |feat| {float(a.abs().max()):.3f}, atol {FEAT_ATOL})")
            if not err <= FEAT_ATOL:
                fail(f"layer-6 features of {name} differ between cuda and cpu: {err}")
            feats[name] = (a, b)
    ia, _ = knn_topk(feats["src"][0], feats["ref"][0], k=32)
    ib, _ = knn_topk(feats["src"][1].to(dev), feats["ref"][1].to(dev), k=32)
    ia, ib = ia.sort(dim=1).values, ib.cpu().sort(dim=1).values
    share = float((ia == ib).all(dim=1).float().mean())
    log(f"[slice] top-32 kNN sets equal on {share:.1%} of frames (min {KNN_SET_SHARE_MIN:.0%})")
    if not share >= KNN_SET_SHARE_MIN:
        fail(f"top-32 kNN sets agree on only {share:.1%} of frames")

    wa = cpu.convert_waveform(src, ref).numpy()
    wb = gpu.convert_waveform(src, ref).cpu().numpy()
    peak = float(np.abs(wa).max())
    rel = float(np.abs(wa - wb).max()) / max(peak, 1e-30)
    log(f"[slice] pre-quantize waveform {wa.shape}: max |cpu| {peak:.3e}, "
        f"max |cuda - cpu| / max |cpu| = {rel:.3e} (tol {WAV_REL_TOL})")
    if not (wa.shape == wb.shape and np.isfinite(wb).all() and rel <= WAV_REL_TOL):
        fail(f"pre-quantize waveforms differ between cuda and cpu: rel {rel}")
    del cpu
    return gpu


def phase_full(root: str, knn, kernel_record):
    import numpy as np
    import torch

    from knnsvc_torch.io.audio import load_audio
    from knnsvc_torch.match.serve import quantize_int16
    from knnsvc_torch.models.wavlm.model import frame_count
    from knnsvc_torch.ops.attention import gated_bias_attention

    src, ref = write_pair(root, FULL_SECONDS, sidecars=False)
    out = os.path.join(root, "converted.wav")
    n_frames = frame_count(knn.wavlm_cfg, int(16000 * FULL_SECONDS) + 320)

    def run(s, r):
        gated_bias_attention.launches = 0
        t0 = time.perf_counter()
        path = knn.convert_pair(s, r, fast=True, output_path=out)
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        launches = gated_bias_attention.launches
        if launches != LAUNCHES_PER_PAIR:
            fail(f"convert_pair launched the attention kernel {launches} times, "
                 f"expected {LAUNCHES_PER_PAIR}")
        return dt, launches, path

    def new_pair(tag):
        """The same audio under new names: no f0 sidecar, so the
        conversion extracts f0 on the host as for a pair never seen."""
        paths = [os.path.join(root, f"{tag}_{name}.wav") for name in ("src", "ref")]
        for a, b in zip((src, ref), paths):
            shutil.copyfile(a, b)
        return paths

    def summary(times):
        med = statistics.median(times)
        return (f"{', '.join(f'{t:.4f}' for t in times)}; median {med:.4f} s, "
                f"min {min(times):.4f} s, max {max(times):.4f} s, "
                f"{FULL_SECONDS / med:.2f} audio-s/s")

    cold_s, launches, path = run(src, ref)
    kernel_record["launches"] = launches
    log(f"[full] cold convert_pair(fast=True) on a {FULL_SECONDS:.0f}-s pair: {cold_s:.3f} s "
        f"(first conversion in the process; includes the native f0 build when the "
        f"checkout has none, and f0 extraction)")
    torch.cuda.reset_peak_memory_stats()
    fresh = [run(*new_pair(f"new{i}"))[0] for i in range(FRESH_RUNS)]
    log(f"[full] warm latency, new pair (f0 extracted) s ({FRESH_RUNS} runs): {summary(fresh)}")
    cached = [run(src, ref)[0] for _ in range(WARM_RUNS)]
    log(f"[full] warm latency, repeat conversion (f0 cached) s ({WARM_RUNS} runs): "
        f"{summary(cached)}")
    log(f"[full] peak device memory {torch.cuda.max_memory_allocated() / 2 ** 30:.3f} GiB")
    log(f"kernels: gated_bias_attention={launches}")

    y, sr = load_audio(path)
    if not (sr == 16000 and y.shape[-1] == n_frames * 320 and np.isfinite(y).all()):
        fail(f"output wav: sr {sr}, length {y.shape[-1]} (want {n_frames * 320})")
    wav = knn.convert_waveform(src, ref)
    torch.cuda.synchronize()
    peak = float(wav.abs().max())
    if not (wav.shape[0] == n_frames * 320 and bool(torch.isfinite(wav).all()) and peak > 0):
        fail(f"pre-quantize waveform: shape {tuple(wav.shape)}, finite "
             f"{bool(torch.isfinite(wav).all())}, peak {peak}")
    log(f"[full] output {n_frames} frames = {y.shape[-1]} samples; pre-quantize peak {peak:.3e}, "
        f"non-zero int16 codes {int((quantize_int16(wav) != 0).sum())}")

    phase_profile(knn, *new_pair("traced"), out, "new pair (f0 extracted)")
    phase_profile(knn, src, ref, out, "repeat conversion (f0 cached)")


def stage_times(events) -> dict[str, list[float]]:
    """Per stage of convert_pair (the knnsvc.* record_function spans):
    [host ms inside the spans, device ms launched from them]. A device
    event carries the correlation id of the host runtime call that launched
    it (cudaLaunchKernel, cudaMemcpyAsync, ...); that call is charged to the
    innermost knnsvc.* span above it. Device time of no span is listed as
    unattributed. Kernels may overlap on the card, so the device column can
    add up to more than the busy time."""
    from torch.autograd import DeviceType

    stages: dict[str, list[float]] = {}
    runtime = {}
    for e in events:
        if e.device_type != DeviceType.CPU:
            continue
        if e.name.startswith("knnsvc."):
            stages.setdefault(e.name[7:], [0.0, 0.0])[0] += e.time_range.elapsed_us() / 1e3
        elif e.name.startswith("cu"):
            runtime[e.id] = e
    for e in device_events(events):
        p = runtime.get(e.id)
        while p is not None and not p.name.startswith("knnsvc."):
            p = p.cpu_parent
        name = p.name[7:] if p is not None else "unattributed"
        stages.setdefault(name, [0.0, 0.0])[1] += e.time_range.elapsed_us() / 1e3
    return stages


def device_events(events):
    """Kernels and copies on the card (not the device-side copies of the
    record_function spans)."""
    from torch.autograd import DeviceType

    return [e for e in events if e.device_type == DeviceType.CUDA
            and not getattr(e, "is_user_annotation", False) and not e.name.startswith("knnsvc.")]


def phase_profile(knn, src: str, ref: str, out: str, label: str) -> None:
    """One more warm convert_pair traced with torch.profiler (CUPTI): the
    device busy share, device time by kernel, and the per-stage split read
    from the knnsvc.* spans. A trace without device events is reported as
    not measured."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        knn.convert_pair(src, ref, fast=True, output_path=out)
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    events = prof.events()
    spans = sorted((e.time_range.start, e.time_range.end, e.name) for e in device_events(events))
    if not spans:
        log(f"[profile] {label}: the trace holds no device events: busy share not measured")
        return
    busy, (lo, hi) = 0.0, spans[0][:2]
    by_name: dict[str, list] = {}
    for s, e, name in spans:
        if s > hi:
            busy, lo = busy + hi - lo, s
        hi = max(hi, e)
        acc = by_name.setdefault(name, [0.0, 0])
        acc[0] += e - s
        acc[1] += 1
    busy += hi - lo
    log(f"[profile] {label}: traced warm convert_pair: wall {wall_us / 1e3:.2f} ms, device busy "
        f"{busy / 1e3:.2f} ms ({busy / wall_us:.1%}), idle share {1 - busy / wall_us:.1%}, "
        f"{len(spans)} device events adding up to {sum(e - s for s, e, _ in spans) / 1e3:.2f} ms")
    stages = stage_times(events)
    log(f"[profile] {label}: stages (host ms in span, device kernel ms) " + json.dumps(
        {k: [round(h, 3), round(d, 3)] for k, (h, d) in stages.items()}))
    attn = sum(v[0] for k, v in by_name.items() if "gated_bias_attention" in k)
    log(f"[profile] {label}: gated_bias_attention {attn / 1e3:.2f} ms "
        f"({attn / busy:.1%} of device busy)")
    for name, (us, n) in sorted(by_name.items(), key=lambda kv: -kv[1][0])[:10]:
        log(f"[profile]   {us / 1e3:8.3f} ms x{n:<4d} {name[:100]}")


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        fail("torch sees no CUDA device; this smoke run needs one card")
    repo = os.path.dirname(os.path.abspath(__file__))
    if not os.path.isdir(os.path.join(repo, "knnsvc_torch")):
        fail("knnsvc_torch not found beside chip_smoke.py: run it from the repository")
    sys.path.insert(0, repo)
    import knnsvc_torch  # noqa: F401
    from knnsvc_torch.precision import set_precision

    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    set_precision("highest")
    log(f"[env] torch {torch.__version__} cuda {torch.version.cuda} on "
        f"{torch.cuda.get_device_name(0)} x{torch.cuda.device_count()}")

    t_all = time.perf_counter()
    phase_build()
    record = phase_kernels(dev)
    root = tempfile.mkdtemp(prefix="knnsvc_smoke_")
    try:
        knn = phase_slice_cpu_vs_cuda(root, dev)
        phase_full(root, knn, record)
    finally:
        shutil.rmtree(root, ignore_errors=True)

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60)
    if smi.returncode != 0 or not smi.stdout.strip():
        fail(f"nvidia-smi failed: {smi.stderr.strip()}")
    log(f"[done] all phases in {time.perf_counter() - t_all:.1f} s")
    print(smi.stdout.strip().splitlines()[0], flush=True)
    print(json.dumps({"kernels": [record]}), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
