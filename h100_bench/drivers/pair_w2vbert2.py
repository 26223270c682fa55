"""Pair conversions through w2v-BERT 2.0 in a closed loop with one client:
drivers/pair.py's traffic, window and check, with the configuration's
content encoder w2v-BERT 2.0 (its `w2vbert` group: HF's config keys) run to
its `feature_layer` in place of WavLM.

What differs from drivers/pair.py: the encoder's weights (a state dict
under HF's names, the first `encoder_layers_run` layers, drawn from the seed
on the card), the frame count of a chunk (the stacked fbank's), the plain
reference (reference/pipeline_w2vbert2.py) and, in a traced run, each
traced request's change of the program's counters `w2vbert.chunks` and
`w2vbert.layers_run` (utils/profiling.counters()), kept in its unit.
"""

from __future__ import annotations

import os
import time

import numpy as np

from h100_bench import compare, inputs
from h100_bench.drivers.pair import Requests, StepCount, Tap, _host, _log
from h100_bench.harness import RunResult, reduce_trace, start_tracer

# a chunk's rows as drivers/pair.py's chunk_frames counts them, from (_,
# kernel, stride) steps: the 400-sample fbank frames every 160 samples, then
# pairs of frames stacked (ceil(F / 2) = (F - 1) // 2 + 1)
FBANK_FRAMES = ((0, 400, 160), (0, 1, 2))


def _uniform_std(fan_in: int) -> float:
    return (1.0 / fan_in) ** 0.5 / 3 ** 0.5


def w2vbert_spec(w: dict, n_layers: int) -> dict:
    """The first n_layers layers' state dict under HF's names, as a spec of
    inputs.draw_tree: HF's `_init_weights` distributions (Linear N(0,
    0.02), convs N(0, 2 / fan_in), the distance tables N(0, 1)), the
    projection's U(-k, k) drawn as a normal of its standard deviation."""
    D, F, K = w["hidden_size"], w["intermediate_size"], w["conv_depthwise_kernel_size"]
    P = w["left_max_position_embeddings"] + w["right_max_position_embeddings"] + 1
    d, Din = D // w["num_attention_heads"], w["num_mel_bins"] * w["stride"]
    N, Z, O = inputs._normal, inputs._zeros, inputs._ones

    def ln(prefix, dim):
        return {f"{prefix}.weight": O(dim), f"{prefix}.bias": Z(dim)}

    def lin(prefix, din, dout):
        return {f"{prefix}.weight": N((dout, din), 0.02), f"{prefix}.bias": Z(dout)}

    spec = {**ln("feature_projection.layer_norm", Din),
            "feature_projection.projection.weight": N((D, Din), _uniform_std(Din)),
            "feature_projection.projection.bias": N((D,), _uniform_std(Din))}
    for i in range(n_layers):
        p = f"encoder.layers.{i}"
        for ffn in ("ffn1", "ffn2"):
            spec.update(ln(f"{p}.{ffn}_layer_norm", D))
            spec.update(lin(f"{p}.{ffn}.intermediate_dense", D, F))
            spec.update(lin(f"{p}.{ffn}.output_dense", F, D))
        spec.update(ln(f"{p}.self_attn_layer_norm", D))
        for name in ("linear_q", "linear_k", "linear_v", "linear_out"):
            spec.update(lin(f"{p}.self_attn.{name}", D, D))
        spec[f"{p}.self_attn.distance_embedding.weight"] = N((P, d), 1.0)
        spec.update(ln(f"{p}.conv_module.layer_norm", D))
        spec[f"{p}.conv_module.pointwise_conv1.weight"] = N((2 * D, D, 1), (2 / D) ** 0.5)
        spec[f"{p}.conv_module.depthwise_conv.weight"] = N((D, 1, K), (2 / K) ** 0.5)
        spec.update(ln(f"{p}.conv_module.depthwise_layer_norm", D))
        spec[f"{p}.conv_module.pointwise_conv2.weight"] = N((D, D, 1), (2 / D) ** 0.5)
        spec.update(ln(f"{p}.final_layer_norm", D))
    return spec


def serving_weights(cfg: dict, seed: int, device):
    """(encoder state dict, vocoder pytree) of the configuration."""
    family = "mix" if cfg["family"] == "mix" else "f0_only"
    encoder = inputs.draw_tree(w2vbert_spec(cfg["w2vbert"], cfg["encoder_layers_run"]), seed,
                               device)
    vocoder = inputs.draw_tree(inputs.generator_spec(cfg["hifigan"], family), seed + 1, device)
    return encoder, vocoder


def _service(cfg: dict, tr: dict, weights, dev):
    from knnsvc_torch.config import HiFiGANConfig, W2VBertConfig
    from knnsvc_torch.hub import KnnSvc
    from knnsvc_torch.precision import set_precision

    set_precision(cfg["precision"])
    svc = KnnSvc(weights[0], W2VBertConfig.from_dict(cfg["w2vbert"]), weights[1],
                 HiFiGANConfig.from_dict(cfg["hifigan"]), cfg["ckpt_type"], device=dev)
    svc.f0_method = tr["f0_method"]
    return svc


def _reference(cell, ctx, weights):
    """(encoder, vocoder) of the plain reference, TF32 left as the caller set it."""
    import torch

    from h100_bench.reference import pipeline_w2vbert2 as pipeline
    from h100_bench.reference.config import HiFiGANConfig

    cfg = cell.config
    dev = torch.device(ctx.device)
    encoder = pipeline.build_encoder(weights[0], cfg["w2vbert"], dev, cfg["encoder_layers_run"])
    vocoder = pipeline.build_vocoder(weights[1], HiFiGANConfig.from_dict(cfg["hifigan"]),
                                     cfg["ckpt_type"], dev)
    return encoder, vocoder


def _reference_readings(cell, ctx, weights, requests) -> list[dict]:
    """The plain reference over each (src, tgt, program results) -> numbers."""
    import torch

    from h100_bench.reference import pipeline_w2vbert2 as pipeline

    cfg, tr = cell.config, cell.traffic
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    encoder, vocoder = _reference(cell, ctx, weights)
    readings = []
    for src, tgt, prog in requests:
        ref = pipeline.convert(src, tgt, encoder, vocoder, cfg["ckpt_type"], tr["post_opt"],
                               tr["topk"], torch.device(ctx.device))
        ref = {k: None if v is None else v.detach().cpu().numpy() for k, v in ref.items()}
        readings.append(compare.pair_numbers(prog, ref))
    return readings


def _counted() -> tuple[int, int]:
    from knnsvc_torch.utils.profiling import counters

    c = counters()
    return c["w2vbert.chunks"], c["w2vbert.layers_run"]


def run(cell, ctx) -> RunResult:
    import torch

    # first, so that a program without the encoder fails at once
    from knnsvc_torch.config import W2VBertConfig  # noqa: F401

    cfg, tr = cell.config, cell.traffic
    dev = torch.device(ctx.device)
    cuda = dev.type == "cuda"
    sync = torch.cuda.synchronize if cuda else (lambda: None)
    t = time.perf_counter()
    weights = serving_weights(cfg, ctx.seed, dev)
    svc = _service(cfg, tr, weights, dev)
    _log(f"weights drawn and the model built in {time.perf_counter() - t:.3f} s")
    t = time.perf_counter()
    req = Requests(tr, ctx.seed, ctx.tmpdir, FBANK_FRAMES)
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
                before = _counted()
                wall = send(j)
                after = _counted()
                units.append({**req.unit(j, wall), "w2vbert_chunks": after[0] - before[0],
                              "w2vbert_layers_run": after[1] - before[1]})
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

    cfg, tr = cell.config, cell.traffic
    dev = torch.device(ctx.device)
    weights = serving_weights(cfg, ctx.seed, dev)
    svc = _service(cfg, tr, weights, dev)
    req = Requests(tr, ctx.seed, ctx.tmpdir, FBANK_FRAMES)
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
    sampled requests converted by the reference in TF32 (control=True, the
    nearest precision below the configuration's float32) or in float32,
    against the reference in float32."""
    import torch

    from h100_bench.reference import pipeline_w2vbert2 as pipeline

    cfg, tr = cell.config, cell.traffic
    dev = torch.device(ctx.device)
    weights = serving_weights(cfg, ctx.seed, dev)
    req = Requests(tr, ctx.seed, ctx.tmpdir, FBANK_FRAMES)
    encoder, vocoder = _reference(cell, ctx, weights)
    readings = []
    for i in req.sampled:
        s, g = req.pair(i)
        runs = []
        for tf32 in (control, False):
            torch.backends.cuda.matmul.allow_tf32 = tf32
            torch.backends.cudnn.allow_tf32 = tf32
            r = pipeline.convert(req.srcs[s], req.tgts[g], encoder, vocoder, cfg["ckpt_type"],
                                 tr["post_opt"], tr["topk"], dev)
            runs.append({k: None if v is None else v.detach().cpu().numpy()
                         for k, v in r.items()})
        readings.append(compare.pair_numbers(*runs))
    return compare.worst(readings)
