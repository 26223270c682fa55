"""Pair conversions in a closed loop with one client: a singer or producer
converting one sung phrase or verse into a target singer's voice and
waiting for each result.

Each request is `KnnSvc.convert_pair(fast=True)` on a source and a target
WAV file, timed on the host from the call until its int16 output is
downloaded and written. Set-up writes n seeded sources and n seeded targets
(`Requests`: the same lengths for every seed, the pairs sent in a seeded
order) and converts each source and each target once, so every shape the
window uses is warm. The window closes with the first request that ends
after `seconds` (and not before the sampled requests below are done); the
rate takes all its requests and all its time.

Correctness: a sample of the window's first n requests, drawn from the
seed with the longest source in it, keeps what the timed path produced
(both pools' features and f0, the matched features, the waveform and its
int16 codes), read by wrapping the program's functions; after the window
the plain reference (reference/pipeline.py) converts the same files with
the same weights, and compare.py holds the two to the cell's limits.
"""

from __future__ import annotations

import logging
import os
import sys
import time

import numpy as np

from h100_bench import compare, inputs
from h100_bench.harness import RunResult, reduce_trace, start_tracer

HOP = 320
CHUNK_SAMPLES = 30 * 16000
MIN_CHUNK_SAMPLES = int(0.02 * 16000)


def chunk_samples(n_samples: int) -> list[int]:
    """Samples of each 30-s chunk of an utterance as the pool build pads and
    uploads them (knnsvc_torch/match/pool.py:402-411)."""
    out = []
    for start in range(0, n_samples, CHUNK_SAMPLES):
        n = min(CHUNK_SAMPLES, n_samples - start)
        if n <= MIN_CHUNK_SAMPLES:
            break
        out.append(n + HOP - n % HOP)
    return out


def chunk_frames(n_samples: int, conv_layers) -> list[int]:
    """Feature rows of each chunk: the conv frontend's valid lengths."""
    frames = []
    for t in chunk_samples(n_samples):
        for _, kernel, stride in conv_layers:
            t = (t - kernel) // stride + 1
        frames.append(t)
    return frames


class Tap:
    """Keeps, for the requests the check samples, what the timed path
    produced, by wrapping the program's stage functions; every request's
    written waveform length is read too. The wrappers call the program's
    own functions and change nothing they return."""

    def __init__(self):
        import knnsvc_torch.hub as hub
        import knnsvc_torch.match.pool as pool
        import knnsvc_torch.match.serve as serve

        self.keep = None            # the dict of the sampled request in flight
        self.written: list[int] = []
        self._saved = [(pool, "build_device_pool"), (serve, "match_core"),
                       (serve, "match_core_post_opt"), (serve, "convert_pools"),
                       (hub, "save_audio")]
        self._orig = {(m, n): getattr(m, n) for m, n in self._saved}

        def pools(*a, **kw):
            p = self._orig[(pool, "build_device_pool")](*a, **kw)
            if self.keep is not None:
                self.keep.setdefault("pools", []).append(p)
            return p

        def matched(name):
            def f(*a, **kw):
                r = self._orig[(serve, name)](*a, **kw)
                if self.keep is not None:
                    self.keep["out"], self.keep["harm"] = r[0], r[2]
                return r
            return f

        def converted(*a, **kw):
            r = self._orig[(serve, "convert_pools")](*a, **kw)
            if self.keep is not None:
                self.keep["wave"] = r[0]
            return r

        def written(path, waveform, sr):
            self.written.append(len(waveform))
            if self.keep is not None:
                self.keep["pred"] = np.array(waveform, copy=True)
            return self._orig[(hub, "save_audio")](path, waveform, sr)

        self._wrappers = {(pool, "build_device_pool"): pools,
                          (serve, "match_core"): matched("match_core"),
                          (serve, "match_core_post_opt"): matched("match_core_post_opt"),
                          (serve, "convert_pools"): converted, (hub, "save_audio"): written}

    def __enter__(self):
        for key, fn in self._wrappers.items():
            setattr(*key, fn)
        return self

    def __exit__(self, *exc):
        for key, fn in self._orig.items():
            setattr(*key, fn)


def _host(kept: dict) -> dict:
    """A sampled request's results as numpy arrays (waits for the card)."""
    src, tgt = kept["pools"][0], kept["pools"][1]
    np_ = lambda t: None if t is None else t.detach().float().cpu().numpy()
    pred = kept["pred"].astype(np.float64)
    return {"src_feats": np_(src.matching), "tgt_feats": np_(tgt.matching),
            "src_f0": np_(src.f0), "tgt_f0": np_(tgt.f0), "out": np_(kept["out"]),
            "harm": np_(kept["harm"]), "wave": np_(kept["wave"]),
            "codes": np.round(pred * 32768.0).astype(np.int32).astype(np.int16)}


def _reference_readings(cell, ctx, weights, requests) -> list[dict]:
    """The plain reference over each (src, tgt, program results) -> numbers."""
    import torch

    from h100_bench.reference import pipeline
    from h100_bench.reference.config import HiFiGANConfig, WavLMConfig

    cfg, tr = cell.config, cell.traffic
    dev = torch.device(ctx.device)
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    wavlm = pipeline.build_wavlm(weights[0], WavLMConfig.from_dict(cfg["wavlm"]), dev,
                                 cfg["encoder_layers_run"])
    vocoder = pipeline.build_vocoder(weights[1], HiFiGANConfig.from_dict(cfg["hifigan"]),
                                     cfg["ckpt_type"], dev)
    readings = []
    for src, tgt, prog in requests:
        ref = pipeline.convert(src, tgt, wavlm, vocoder, cfg["ckpt_type"], tr["post_opt"],
                               tr["topk"], dev)
        ref = {k: None if v is None else v.detach().cpu().numpy() for k, v in ref.items()}
        readings.append(compare.pair_numbers(prog, ref))
    return readings


class Requests:
    """The cell's files and the order of its requests. File j of n has the
    j-th of the evenly spread lengths (the same set for every seed); pair j
    is (source j, target (stride j + offset) mod n). Request i sends pair
    order[i mod n], `order` a seeded permutation: every seed sends the same
    pairs in its own order. The check samples `check_requests` of the first
    n requests, drawn from the seed, the one with the longest source among
    them."""

    def __init__(self, tr: dict, seed: int, root: str, conv_layers):
        n = self.n = tr["n_files"]
        self.tr = tr
        self.srcs, self.src_s = inputs.write_files(root, "src", *tr["source_s"], n, seed, 1)
        self.tgts, self.tgt_s = inputs.write_files(root, "tgt", *tr["target_s"], n, seed, 2)
        self.src_n = [int(16000 * s) for s in self.src_s]
        self.tgt_n = [int(16000 * s) for s in self.tgt_s]
        self.conv = conv_layers
        rng = np.random.default_rng([seed, 3])
        self.order = rng.permutation(n)
        longest = int(np.flatnonzero(self.order == int(np.argmax(self.src_s)))[0])
        rest = [i for i in range(n) if i != longest]
        self.sampled = sorted([longest, *rng.choice(rest, size=tr["check_requests"] - 1,
                                                    replace=False).tolist()])

    def pair(self, i: int) -> tuple[int, int]:
        j = int(self.order[i % self.n])
        return j, (self.tr["pair_stride"] * j + self.tr["pair_offset"]) % self.n

    def unit(self, i: int, wall_s: float) -> dict:
        """What the trace readers need of request i: lengths and chunks."""
        s, t = self.pair(i)
        return {"src_s": self.src_s[s], "tgt_s": self.tgt_s[t], "wall_s": wall_s,
                "src_chunks": chunk_frames(self.src_n[s], self.conv),
                "tgt_chunks": chunk_frames(self.tgt_n[t], self.conv),
                "chunk_samples": chunk_samples(self.src_n[s]) + chunk_samples(self.tgt_n[t])}

    def out_samples(self, i: int) -> int:
        return HOP * sum(chunk_frames(self.src_n[self.pair(i)[0]], self.conv))


def _service(cfg: dict, tr: dict, weights, dev):
    from knnsvc_torch.config import HiFiGANConfig, WavLMConfig
    from knnsvc_torch.hub import KnnSvc
    from knnsvc_torch.precision import set_precision

    set_precision(cfg["precision"])
    svc = KnnSvc(weights[0], WavLMConfig.from_dict(cfg["wavlm"]), weights[1],
                 HiFiGANConfig.from_dict(cfg["hifigan"]), cfg["ckpt_type"], device=dev)
    svc.f0_method = tr["f0_method"]
    return svc


def _log(msg: str) -> None:
    print(f"[pair] {msg}", file=sys.stderr, flush=True)


class StepCount(logging.Handler):
    """Adds up the smoothness optimizer's steps, which the program logs at
    DEBUG on knnsvc_torch.match.smoothness (printed, not a metric)."""

    def __init__(self):
        super().__init__(logging.DEBUG)
        self.steps = self.calls = 0

    def emit(self, record):
        if isinstance(record.args, tuple) and record.args:
            self.steps += int(record.args[0])
            self.calls += 1

    def __enter__(self):
        self._logger = logging.getLogger("knnsvc_torch.match.smoothness")
        self._level = self._logger.level
        self._logger.setLevel(logging.DEBUG)
        self._logger.addHandler(self)
        return self

    def __exit__(self, *exc):
        self._logger.removeHandler(self)
        self._logger.setLevel(self._level)


def run(cell, ctx) -> RunResult:
    import torch

    from knnsvc_torch.config import WavLMConfig

    cfg, tr = cell.config, cell.traffic
    dev = torch.device(ctx.device)
    cuda = dev.type == "cuda"
    sync = torch.cuda.synchronize if cuda else (lambda: None)
    t = time.perf_counter()
    weights = inputs.serving_weights(cfg, ctx.seed, dev)
    svc = _service(cfg, tr, weights, dev)
    _log(f"weights drawn and the model built in {time.perf_counter() - t:.3f} s")
    t = time.perf_counter()
    req = Requests(tr, ctx.seed, ctx.tmpdir, WavLMConfig.from_dict(cfg["wavlm"]).conv_layers)
    _log(f"{2 * req.n} files written in {time.perf_counter() - t:.3f} s")
    out_dir = os.path.join(ctx.tmpdir, "out")
    os.makedirs(out_dir)
    kw = dict(topk=tr["topk"], matcher=tr["matcher"], fast=True,
              upload_dtype=tr["upload_dtype"])

    # warm-up: every source and every target length once, then the cell's
    # own post_opt on a few pairs
    t = time.perf_counter()
    for j in range(req.n):
        svc.convert_pair(req.srcs[j], req.tgts[j], post_opt=tr["warm_post_opt"], **kw,
                         output_path=os.path.join(out_dir, "warm.wav"))
    for i in range(tr["warm_requests"]):
        s, g = req.pair(i)
        svc.convert_pair(req.srcs[s], req.tgts[g], post_opt=tr["post_opt"], **kw,
                         output_path=os.path.join(out_dir, "warm.wav"))
    sync()
    _log(f"warm-up in {time.perf_counter() - t:.3f} s")
    if cuda:
        torch.cuda.reset_peak_memory_stats(dev)
    kept: dict[int, tuple] = {}
    latencies, audio_s, units, done = [], [], [], set()
    failed = 0
    setup_s = time.time() - ctx.start_wall
    with Tap() as tap, StepCount() as steps:

        def send(i: int) -> float:
            """Request i, timed; its output checked and, if sampled, kept."""
            nonlocal failed
            s, g = req.pair(i)
            tap.keep = {} if i in req.sampled else None
            n_written = len(tap.written)
            path = os.path.join(out_dir, f"slot{i % tr['output_slots']}.wav")
            r0 = time.perf_counter()
            try:
                svc.convert_pair(req.srcs[s], req.tgts[g], post_opt=tr["post_opt"], **kw,
                                 output_path=path)
            except Exception as e:  # noqa: BLE001 - a failed request is counted, not fatal
                _log(f"request {i} failed: {e!r}")
                failed += 1
            r1 = time.perf_counter()
            done.add(i)
            if len(tap.written) == n_written + 1 and tap.written[-1] != req.out_samples(i):
                failed += 1
            if tap.keep is not None and "pred" in tap.keep:
                kept[i] = (req.srcs[s], req.tgts[g], tap.keep)
            return r1 - r0

        t0 = time.perf_counter()
        i = 0
        # the window closes after `seconds`, and not before every sampled
        # request is done
        while not (time.perf_counter() - t0 >= ctx.seconds and done.issuperset(req.sampled)):
            latencies.append(send(i))
            audio_s.append(req.src_s[req.pair(i)[0]])
            i += 1
        window_s = time.perf_counter() - t0
        prof = None
        if ctx.trace:
            # the traced requests follow the window, so the window is timed
            # as in an untraced run; one request first warms the tracer up
            window_units = [req.unit(j, latencies[j]) for j in range(i)]
            prof = start_tracer(cuda)
            send(i)
            prof.step()
            trace_t0 = time.perf_counter()
            for j in range(i + 1, i + 1 + tr["trace_requests"]):
                units.append(req.unit(j, send(j)))
                if j == i + tr["trace_requests"]:
                    sync()
                    trace_window = time.perf_counter() - trace_t0
                prof.step()
            prof.stop()
        tap.keep = None
    peak = torch.cuda.max_memory_allocated(dev) if cuda else 0
    _log(f"window: {len(latencies)} requests in {window_s:.3f} s, {sum(audio_s):.3f} audio-s, "
         f"{steps.steps} smoothness steps in {steps.calls} runs")

    view = None
    if prof is not None:
        t = time.perf_counter()
        view = reduce_trace(prof.events(), trace_window)
        view.units, view.config, view.traffic = units, cfg, tr
        view.window_units, view.window_wall_s = window_units, window_s
        del prof
        _log(f"trace of {len(units)} requests read in {time.perf_counter() - t:.3f} s")
    # the program's results to the host, its state freed, then the reference
    checked = [(src, tgt, _host(k)) for _, (src, tgt, k) in sorted(kept.items())]
    failed += len(set(req.sampled) - set(kept))     # a sampled request with no output
    del svc, kept
    if cuda:
        torch.cuda.empty_cache()
    t = time.perf_counter()
    readings = compare.worst(_reference_readings(cell, ctx, weights, checked)) if checked else {}
    _log(f"reference over {len(checked)} requests in {time.perf_counter() - t:.3f} s")
    return RunResult(
        attempted=len(latencies) + (len(units) + 1 if units else 0), failed=failed,
        end_to_end={"pair_p95_s": float(np.percentile(latencies, 95)),
                    tr["rate_metric"]: float(sum(audio_s) / window_s),
                    "setup_s": float(setup_s)},
        readings=readings, checks=compare.checks(readings, cell.limits) if checked else [],
        memory_peak_bytes=int(peak), view=view)


def program_readings(cell, ctx) -> dict[str, float]:
    """The compared numbers of the sampled requests alone, sent in turn by
    one client through the timed path, with no window: the program's
    readings of one seed."""
    import torch

    from knnsvc_torch.config import WavLMConfig

    cfg, tr = cell.config, cell.traffic
    dev = torch.device(ctx.device)
    weights = inputs.serving_weights(cfg, ctx.seed, dev)
    svc = _service(cfg, tr, weights, dev)
    req = Requests(tr, ctx.seed, ctx.tmpdir, WavLMConfig.from_dict(cfg["wavlm"]).conv_layers)
    kept = []
    with Tap() as tap:
        for i in req.sampled:
            s, g = req.pair(i)
            tap.keep = {}
            svc.convert_pair(req.srcs[s], req.tgts[g], post_opt=tr["post_opt"], topk=tr["topk"],
                             matcher=tr["matcher"], fast=True, upload_dtype=tr["upload_dtype"],
                             output_path=os.path.join(ctx.tmpdir, "out.wav"))
            kept.append((req.srcs[s], req.tgts[g], tap.keep))
        tap.keep = None
    checked = [(s, g, _host(k)) for s, g, k in kept]
    del svc, kept
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    return compare.worst(_reference_readings(cell, ctx, weights, checked))


def control_readings(cell, ctx, control: bool) -> dict[str, float]:
    """The compared numbers with the reference in the program's place: the
    sampled requests of the cell's traffic converted by the reference in
    TF32 (control=True, the nearest precision below the configuration's
    float32) or in float32, against the reference in float32."""
    import torch

    from h100_bench.reference import pipeline
    from h100_bench.reference.config import HiFiGANConfig, WavLMConfig

    cfg, tr = cell.config, cell.traffic
    dev = torch.device(ctx.device)
    weights = inputs.serving_weights(cfg, ctx.seed, dev)
    req = Requests(tr, ctx.seed, ctx.tmpdir, WavLMConfig.from_dict(cfg["wavlm"]).conv_layers)
    wavlm = pipeline.build_wavlm(weights[0], WavLMConfig.from_dict(cfg["wavlm"]), dev,
                                 cfg["encoder_layers_run"])
    vocoder = pipeline.build_vocoder(weights[1], HiFiGANConfig.from_dict(cfg["hifigan"]),
                                     cfg["ckpt_type"], dev)
    readings = []
    for i in req.sampled:
        s, g = req.pair(i)
        runs = []
        for tf32 in (control, False):
            torch.backends.cuda.matmul.allow_tf32 = tf32
            torch.backends.cudnn.allow_tf32 = tf32
            r = pipeline.convert(req.srcs[s], req.tgts[g], wavlm, vocoder, cfg["ckpt_type"],
                                 tr["post_opt"], tr["topk"], dev)
            runs.append({k: None if v is None else v.detach().cpu().numpy()
                         for k, v in r.items()})
        readings.append(compare.pair_numbers(*runs))
    return compare.worst(readings)
