#!/usr/bin/env python3
"""Smoke run of knnsvc_torch, the PyTorch/CUDA port, on one CUDA card.

    python3 chip_smoke.py          # from the repository root; needs one card

Phases (any failure exits non-zero, before the result line):
  1. build the CUDA kernels from knnsvc_torch/csrc (one nvcc per source,
     started together; sm_90a) and print ptxas's register / shared-memory /
     spill lines;
  2. each kernel against its plain PyTorch version on the card, with
     CUDA-event times of the kernel, the plain version and (where one
     exists) one PyTorch library call, beside the kernel's bound on an
     H100: the attention kernel's diagonal entry (bias given as its
     (H, 2T-1) diagonal table) at the main path's shape and at ragged
     shapes, and its one-pass TF32 instance ("fastest" precision) at the
     main shape; its full-bias entry (a random (H, T, T) bias, the TPU
     kernel's form) at the ragged, main and streaming shapes and in one
     TF32 pass, and a Toeplitz bias through it bit-equal to the diagonal
     entry; the
     concat-cost kernel exactly equal at (37, 53, 128), on
     random ids and on ids at row P-1 with duplicate candidates, at k = 4
     and k in CONCAT_KS, and at (300, 400, 1024) with k = 8 (its rows read
     from L2), the share of equal frames per lane (all of them) at the
     main path's (1500, 1500, 1024) with k = 4 and k = 8, and the time of
     its pre-pass alone; its carried (streaming) entry against the plain
     carried cores, picks and the weight after each frame, at (37, 53,
     128) for k in CARRIED_KS with a carried weight of 0.2 and 0, and at a
     streaming chunk (150 + 1 carried frames, 1500, 1024) with k = 4 and 8,
     10 chained chunks against the whole-utterance kernel, and its time;
     the f0 Viterbi kernel equal on every frame at
     (1501, 482) on random costs, costs with injected ties, constant rows
     and the real costs of a sung 30-s wav, timed against its plain
     version, with ptxas's registers and spills for it (a spill fails the
     run); device f0
     on the card against the CPU on that wav, and the time of one 30-s
     device_f0_tensor with its Viterbi share; the attention kernel and the
     Viterbi also at a streaming window's shape (T = 200); the concat
     kernel's shard-table entries (a pool split into S = 1, 2, 4 logical
     shards of the card) against the plain version reading the same shards
     at (1500, 1499, 1024), k = 4 and 8, pair and single lane, and S = 1
     against the dense entry, each timed;
     [reach], the shapes the JAX package serves beside the main path's:
     both attention entries at head dims 8, 12, 16, 32, 48, 96, 128, 200
     and 256 (H d ~ 1024; T = 1500 at 32 and 128, else 200) under
     "highest" and "fastest", a Toeplitz bias through the full entry
     bit-equal to the diagonal entry, each timed beside its bound; the
     port's WavLM at head dims 16 and 8 on the card against the CPU (one
     launch a layer); the concat kernel at (1500, 1500, D) for D = 1022,
     1023, 1021 and k = 4, 8, dense, on 2 logical shards and carried, equal
     to the plain version on every frame, timed; the Viterbi at (1501, C)
     for C = 963, 2406, 4812 (5-, 2- and 1-cent grids), states equal on
     every frame, timed, with every instance's ptxas spills held to 0; and
     device f0 at grid_cents 5 on a 30-s sung wav, card against CPU;
  3. the slice on the card against the slice on the CPU: one full-width
     KnnSvc.random_init("mix") (WavLM-Large, HiFi-GAN v1 config), the same
     weights on both, "highest" precision, a seeded 4-s synthetic singing
     pair with f0 sidecars: layer-6 features, top-32 kNN sets, pre-quantize
     waveforms without post_opt and with post_opt_0.2 (the concat-cost
     picks of both lanes and both optimizers' step counts on each side);
     then streaming on a 4-s pair: one chunk covering it is
     convert_pair(fast=True) bit for bit, and 1-s chunks with post_opt_0.2
     (windowed and cached encoders) on the card against the CPU
     (pre-quantize waveforms, the carried concat picks);
  4. the main path at full size: KnnSvc.convert_pair(fast=True) on a seeded
     30-s pair, without post_opt (once cold, then warm on new pairs, host
     f0 extracted, and repeated, f0 read from its cache) and with
     post_opt_0.2 (new and repeated); each run must launch the attention
     kernel exactly 12 times (6 encoder layers x 2 pools) and, with
     post_opt, the concat-cost kernel once; one post_opt conversion with
     topk=8; one wavlm_only post_opt conversion; traced runs (new and
     repeated pairs, without and with post_opt) split by stage from the
     knnsvc.* profiler spans; then with f0_method='device' and int16
     uploads (2 Viterbi launches per pair, no host f0), new-pair and repeat
     medians beside the host-f0 ones and a traced new pair; one
     wavlm_only_original conversion, its vocoder against the CPU;
     then [mp3], mp3 inputs on the same model: the committed fixtures of
     tools/make_mp3_fixtures.py (a 30-s 16-kHz mono source, a 30-s
     44.1-kHz joint-stereo target with a LAME tag) decoded by the port's
     decoder, built from csrc/mp3dec.cc (host times, PCM digests held to
     the recorded ones); convert_pair(fast=True) on the mp3 pair as a new
     pair, then without and with post_opt_0.2 in turns with its 16-bit WAV
     twins (12 attention launches, 1 concat with post_opt; waveforms
     bit-equal); one fast bulk_convert over 2 singers whose folders mix
     .mp3 and .wav, bit-equal to the all-WAV twin;
     then [orbax], orbax checkpoints without orbax (io/orbax_ckpt.py, its
     zstd and CRC-32C codecs built from csrc/orbax_io.cc): the committed
     JAX-written checkpoint of tools/make_orbax_fixtures.py restored, every
     leaf's SHA-256 held to the JAX package's restore; a directory holding
     only orbax/ (a full-width mix TrainState) served by KnnSvc.load through
     convert_pair(fast=True, post_opt_0.2) (12 attention launches, 1 concat
     launch), bit-equal to its .knnsvc.pkl twin; phase 7 adds the rest;
  5. the host-pool and bulk paths at full width (the same mix model, random
     weights from seed 0, "highest"): convert_pair(fast=False) against
     convert_pair(fast=True) on a 30-s pair with f0 sidecars (12 attention
     launches each; waveforms within one int16 step plus 2e-5); a seeded
     dataset of 2 singers x 3 utterances (6, 12 and 35 s, the last across a
     30-s chunk boundary) through bulk_convert's three loops (host, fast,
     fast with data_batch=2; 6 conversions each, the same files, finite and
     non-silent before the quantize, 6 attention launches per chunk
     encoded, the fast and batched outputs within one int16 step, audio-s
     per s of each warm pass) and a traced host pass split by the
     knnsvc.speaker_pool / bulk_match / vocode_batch spans; one post_opt_0.2
     fast bulk loop (one concat launch per conversion) and the concat
     kernel's picks against its plain version at a bulk target pool (P >
     1500) and a bucket-padded query; the int8 kNN card against CPU at
     (1500, 9000, 1024) (int32 dots and indices equal) and one int8 host
     pair with post_opt (two single-lane concat launches); knn_topk at
     (1500, 180000, 1024), an hour of target, against torch.topk on the same
     distances;
  6. streaming at full size: a 30-s source against a 30-s target through
     stream_convert_chunks at the CLI's defaults (2-s chunks, 1 s of
     context), windowed and cached, without and with post_opt_0.2, and
     windowed with device f0, each once cold and once warm: 15 chunks, the
     length within 2 hops, per chunk 6 attention launches (windowed) or 0
     (cached), 1 concat launch with post_opt, 1 Viterbi with device f0;
     per-chunk times, audio-s per s, peak memory; the cached encoder's step
     and its plain attention; the live settings (0.5-s chunks, 1 s before,
     0.1 s after) through stream_session pushed 20 ms at a time, the wall
     time of each push that emits, its output bit-identical to the file
     stream (cached and windowed); one traced live session by span;
  7. vocoder training (knnsvc_torch.train) at full width: a seeded sung
     dataset (train: 2 singers x 3 utterances of ~6 s; valid: 1 x 2)
     prematched through cli.prematch with the random-init WavLM-Large (6
     attention launches per 30-s chunk; wall time per utterance, smoothness
     steps), one singer prematched on the CPU against the card (equal
     nearest-neighbour rows, weight difference); one train step
     (HiFiGANConfig(), full MPD and MSD) on the card against the CPU from
     the same state and batch of 2; 20 warm steps at the real config
     (batch 16, segment 7040) under "highest", "fastest" (TF32) and
     compute_dtype=bfloat16: median and p90 step ms, steps/s, audio-s per
     s, peak memory; one warm step traced per precision, split by the
     knnsvc.d_step / g_step spans; train() for 11 steps with validation every 5 (best-val
     retention), resume_from continuing the step count, and the trained g_
     served by KnnSvc.load(ckpt_dir, "mix") with convert_pair(fast=True);
     [orbax] the real-config TrainState after the warm steps written with
     save_train_state and read back bit-equal (bytes, GB/s each way), then
     train(resume_from=, checkpoint_backend='orbax') from it: the restored
     state bit-equal to the written one, and one step with finite metrics;
  8. the multi-device matchers (knnsvc_torch/parallel) on logical shards of
     the card, the same model: an hour-scale pool (180 000 x 1024, seeded)
     at 1 and 4 shards, sharded_knn_topk against knn_topk and
     match_utterance(matcher='sharded', post_opt_0.2) against 'exact'
     (shares of equal rows and concat picks, largest feature difference,
     times); convert_pair(fast=True) on a 30-s pair with 'sharded'
     (no_post_opt, post_opt_0.2) and 'sharded_int8' on the default pool
     mesh and on 4 shards (launches checked; waveforms against the exact
     matcher's, and the int8 one against the host-pool int8 pair; warm
     medians beside the dense ones) and convert_pair(fast=False,
     matcher='sharded'); bulk_convert on phase 5's dataset: the host loop
     with 'sharded', the dense fast loop on a (2, 1) data mesh, the fast
     loop with 'sharded_int8' serial, with data_batch=2 and with
     data_batch=2 on a 2 x 2 mesh, each against its dense or serial twin,
     audio-s/s each; a windowed 30-s 'sharded'
     stream against the 'exact' one and a live 'sharded_int8'
     stream_session against its file stream;
  9. [rest], the modules beside the served and trained paths: after phase
     8, the eval harnesses over phase 5's bulk output (generate_pair_lists,
     compute_speaker_similarity with mfcc_stats_embedder on the card and on
     the CPU: EERs equal, embeddings within EMBED_ATOL; spectral_distance
     and max_waveform_deviation between phase 3's card and CPU waveforms),
     the harm head, sss_loss, stft_magnitude and harmonic_synth_zero_phase
     on the card against the CPU, a StageTimer with format_mfu_table
     around one 30-s pair, and the last slice's surface: six layers of
     ops.gated_bias_attention with full biases at (16, 1500, 64) (its
     launches counted there), weighted_cosine_distance,
     knn_cosine_similarity, compute_shift and interp_f0_candidates at a
     30-s pair's shape card vs CPU; after phase 7, data-parallel training at its
     full-width config on a (2, 1) logical mesh of the card against the
     one-device step over 3 steps: in float64 at rtol 1e-4 (metrics) and
     1e-5 (parameters), in float32 the metrics at rtol 1e-4 and the
     parameters' spread measured; 10 fp32 steps of each timed; then one
     step under initialize_distributed on a world of 1 over NCCL (the
     all-reduces on the card);
 10. the card's name and power limit (nvidia-smi).
A "kernels:" line lists each entry's launches on its path; the line
before the last is the kernels' JSON record; the last line is
{"ok": true, "device": {...}}. Without a CUDA device, or outside the
repository, it fails and prints no result.
"""

import json
import logging
import math
import os
import re
import shutil
import statistics
import subprocess
import sys
import tempfile
import time

# H100 SXM published peaks (NVIDIA data sheet), for the bounds
PEAK_FP32_FLOPS = 67e12          # fp32 outside the tensor cores
PEAK_TF32_FLOPS = 495e12         # TF32 on the tensor cores, dense
PEAK_BYTES_PER_S = 3.35e12       # HBM3

KERNELS = ("gated_bias_attention", "concat_cost_pair", "f0_viterbi")
ATTN_MAIN = (16, 1500, 64)       # one WavLM-Large layer on a 30-s chunk
ATTN_STREAM = (16, 200, 64)      # one layer on a streaming window (2 s + 1 s each side)
ATTN_RAGGED = [(4, 200, 64, 1.0), (4, 200, 64, 0.0), (4, 200, 64, -0.5)]
# kernel vs plain: fp32 sums of 1500 terms per score and per output, in
# another order than cuBLAS and torch.softmax, the products in 3 TF32
# tensor-core passes (fp32-grade)
ATTN_ATOL_MAIN = 1e-4
ATTN_ATOL_RAGGED = 2e-5
# the one-pass TF32 instance ("fastest") vs the fp32 plain version: 10
# mantissa bits per operand; ~3x the 7.9e-4 it shows at the main shape
ATTN_ATOL_TF32 = 2.5e-3
# cuda vs cpu, fp32 with TF32 off: cuDNN/cuBLAS/cuFFT sum in other orders
# than the CPU kernels, ~1e-6 relative per op through 7 convs and 6 layers
FEAT_ATOL = 1e-3
KNN_SET_SHARE_MIN = 0.95         # frames whose top-32 sets agree exactly
WAV_REL_TOL = 3e-3               # max |dwav| / max |wav|: 10x the 3.2e-4 the
                                 # card and the CPU have shown on this input
                                 # (3.5e-4 with post_opt_0.2, where both sides
                                 # take the same picks and step counts)
SLICE_SECONDS = 4.0
FULL_SECONDS = 30.0
WARM_RUNS = 20                   # repeat conversions (f0 read from its cache)
FRESH_RUNS = 5                   # conversions of pairs never seen (f0 extracted)
LAUNCHES_PER_PAIR = 12           # 6 early-exit layers x 2 pools x one 30-s chunk
VOICES = (("src", 190.0, 21), ("ref", 265.0, 22))   # name, f0 in Hz, seed

CONCAT_SMALL = (37, 53, 128)     # (T, P, D) of tests/test_ops.py's Pallas check
CONCAT_KS = (2, 8, 32)           # top-k beside the reference's 4, up to the kNN width
CONCAT_L2 = (300, 400, 1024, 8)  # (T, P, D, k): rows too many for shared memory
CONCAT_MAIN = (1500, 1500, 1024) # a 30-s source against a 30-s pool, WavLM width
CONCAT_SHARE_MIN = 1.0           # frames whose picks equal the plain version's
CONCAT_PLAIN_RUNS = 3            # the plain version is a Python loop over frames
POST_OPT = "post_opt_0.2"        # the paper's CAT + OPT, the README's first command
PICK_SHARE_MIN = 0.95            # card vs CPU: frames whose concat picks agree
PO_FRESH_RUNS = 3                # post_opt conversions of new pairs
PO_WARM_RUNS = 10                # post_opt repeat conversions
TOPK_WIDE = 8                    # a --topk beside the reference's 4

VITERBI_MAIN = (1501, 482)       # frames of a 30-s chunk, f0 candidates 65-1047 Hz
VITERBI_STREAM = 200             # frames of a streaming window at the CLI defaults
VITERBI_FLOPS_PER_STATE = 10     # fp32 adds, subtracts and compares per state and frame
F0_VOICING_SHARE_MIN = 0.995     # card vs CPU: frames of equal voicing
F0_CENTS = 1.0                   # card vs CPU: voiced f0 within this many cents ...
F0_CENTS_SHARE_MIN = 0.99        # ... on this share of the frames voiced in both
DEV_FRESH_RUNS = 5               # device-f0 + int16-upload conversions of new pairs
DEV_WARM_RUNS = 10               # and of the same pair again

BULK_SINGERS = (("alto", 230.0, 31), ("tenor", 160.0, 41))   # name, f0 in Hz, seed
BULK_SECONDS = (6.0, 12.0, 35.0)                            # each singer's utterances
BULK_LOOPS = (("host", {}), ("fast", {"fast": True}),
              ("fast_batch2", {"fast": True, "data_batch": 2}))
INT16_STEP = 1 / 32768
HOST_VS_FAST_ATOL = INT16_STEP + 2e-5   # tests/test_pipeline.py's 2e-5, plus the quantize
HOST_PAIR_RUNS = 3                      # warm host-pool pair conversions
INT8_SHAPE = (1500, 9000, 1024)         # (Q, P, D): a 30-s query, a 3-min pool
KNN_HOUR = (1500, 180_000, 1024)        # (Q, P, D): a 30-s query, an hour of target
# the multi-device matchers (knnsvc_torch/parallel) on logical shards of the card
SHARD_COUNTS = (1, 2, 4)                # pool shards of the concat kernel's pointer table
SHARD_KS = (4, 8)                       # k = 8 reads its rows from L2
SHARDED_POOL = 1499                     # a true_len that 2 and 4 do not divide
HOUR_SHARDS = (1, 4)
SHARDED_PAIR_RUNS = (5, 3)              # warm runs without and with post_opt

# [reach]: the shapes the JAX package serves beside the main path's
REACH_ATTENTION = ((128, 200, 8), (85, 200, 12), (64, 200, 16), (32, 1500, 32), (21, 200, 48),
                   (11, 200, 96), (8, 1500, 128), (5, 200, 200), (4, 200, 256))  # H d ~ 1024
REACH_WIDTHS = (1022, 1023, 1021)       # concat rows that are no multiple of 4 floats
REACH_STATES = ((963, 5.0), (2406, 2.0), (4812, 1.0))   # voiced states of a grid in cents
REACH_GRID_CENTS = 5.0                  # device f0 on a finer grid than the 10-cent default
REACH_ENCODER_SECONDS = 4.0
# the JAX package's test encoder (tests/test_wavlm.py: head dim 16) and the
# port's tiny training-world one (tests/test_torch_common.py: head dim 8)
REACH_WAVLMS = {
    16: dict(extractor_mode="layer_norm", encoder_layers=3, encoder_embed_dim=64,
             encoder_ffn_embed_dim=128, encoder_attention_heads=4, layer_norm_first=True,
             conv_feature_layers="[(32,10,5)] + [(32,3,2)] + [(32,2,2)]", conv_bias=False,
             conv_pos=16, conv_pos_groups=4, relative_position_embedding=True, num_buckets=32,
             max_distance=64, gru_rel_pos=True),
    8: dict(extractor_mode="layer_norm", encoder_layers=2, encoder_embed_dim=16,
            encoder_ffn_embed_dim=32, encoder_attention_heads=2, layer_norm_first=True,
            conv_feature_layers="[(16,10,5)] + [(16,4,4)] + [(16,4,4)] + [(16,4,4)]",
            conv_bias=True, conv_pos=8, conv_pos_groups=2, relative_position_embedding=True,
            num_buckets=16, max_distance=32, gru_rel_pos=True),
}

# the carried (streaming) concat-cost entry
CARRIED_KS = (2, 4, 8, 32)              # at CONCAT_SMALL, random ids and ids at P-1
CARRIED_STREAM = (150, 1500, 1024)      # (T, P, D): a 2-s chunk + 1-s lookahead
CHAIN_CHUNKS = 10                       # chunks of CONCAT_MAIN[0] / 10 frames, k = 4
# streaming conversion (KnnSvc.stream_convert_chunks / stream_session)
STREAM_SLICE = dict(chunk_s=1.0, context_s=0.5, post_opt=POST_OPT, matcher="exact")
STREAM_CLI = dict(chunk_s=2.0, context_s=1.0, matcher="exact")   # the CLI's defaults
STREAM_RUNS = (("a", "windowed, no_post_opt, host f0", {}, "fast"),
               ("b", f"windowed, {POST_OPT}, host f0", {"post_opt": POST_OPT}, "fast"),
               ("c", "cached, no_post_opt", {"encoder": "cached"}, "fast"),
               ("d", f"cached, {POST_OPT}", {"encoder": "cached", "post_opt": POST_OPT}, "fast"),
               ("e", "windowed, no_post_opt, device f0", {}, "device"))
STREAM_CHUNKS = 15                      # 30 s in 2-s chunks
LIVE = dict(chunk_s=0.5, context_s=1.0, right_context_s=0.1, matcher="exact")
PUSH_SAMPLES = 320                      # 20 ms, a mic callback
# vocoder training (knnsvc_torch.train)
TRAIN_SINGERS = (("soprano", 262.0, 61), ("baritone", 131.0, 71))  # the train split
VALID_SINGERS = (("mezzo", 196.0, 81),)                            # the valid split
TRAIN_SECONDS = (5.6, 6.0, 6.4)         # each train singer's utterances (~6 s)
VALID_SECONDS = (5.8, 6.2)
PREMATCH_SEED = 123                     # cli.prematch's default --seed: its random WavLM
CPU_BATCH = 2                           # (b): one full-width step, card vs CPU
# card vs CPU metrics after one step: fp32 sums of the same terms in other
# orders (cuDNN, cuFFT), ~1e-6 relative per op through G, MPD and MSD
TRAIN_METRIC_RTOL = 1e-3
STEP_RUNS = (("highest", "highest", None), ("fastest (TF32)", "fastest", None),
             ("bf16", "highest", "bfloat16"))      # (label, precision, compute dtype)
TRAIN_WARMUP = 3
TRAIN_WARM_STEPS = 20
LOOP_BATCH = 2                          # 6 train utterances: 3 steps an epoch
LOOP_STEPS = 10                         # steps 0..10
LOOP_VALIDATION = 5                     # validations at steps 0, 5, 10
DP_COMPARE_STEPS = 3                    # data-parallel vs one-device steps from one state
DP_TIMED_STEPS = 10
DP_METRIC_RTOL = 1e-4                   # tests/test_training.py:101-120's bounds
DP_PARAM_ATOL = 1e-5
DP_GRAD_RTOL = 1e-6                     # float64 gradients, summed in another order
EMBED_ATOL = 1e-4                       # mfcc_stats embeddings, card vs CPU
HARM_HIDDEN = 256                       # the harm head's hidden width
SURFACE_LAYERS = 6                      # full-bias attention layers in the [rest] surface drive
SURFACE_ATOL = 1e-5                     # card vs CPU: fp32 sums of D = 1024 terms, other orders


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


def attention_bound_ms(H: int, T: int, d: int, passes: int = 3,
                       full: bool = False) -> tuple[float, str]:
    """Least time for the kernel's work on an H100: `passes` TF32
    tensor-core passes of the two products (2 flops per multiply-add,
    4*H*T^2*d each); bytes = q, k, v, the bias (its (H, 2T-1) diagonal, or
    the (H, T, T) tensor when full) and gate read once and out written
    once."""
    ops = passes * 4 * H * T * T * d
    nbytes = 4 * (4 * H * T * d + (H * T * T if full else H * (2 * T - 1)) + H * T)
    t_ops, t_bytes = ops / PEAK_TF32_FLOPS, nbytes / PEAK_BYTES_PER_S
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


def phase_build() -> dict[str, list[str]]:
    """Builds every kernel; returns each one's ptxas lines."""
    from concurrent.futures import ThreadPoolExecutor

    from knnsvc_torch.ops.build import build_kernel

    t0 = time.perf_counter()
    with ThreadPoolExecutor(len(KERNELS)) as pool:
        builds = list(pool.map(build_kernel, KERNELS))
    log(f"[build] {len(builds)} kernels, one nvcc each in parallel, in "
        f"{time.perf_counter() - t0:.1f} s")
    for b in builds:
        log(f"[build] {b.name}: {b.library.name}")
        for line in b.ptxas:
            log(f"[build] {b.name}: {line}")
    return {b.name: b.ptxas for b in builds}


def ptxas_usage(name: str, lines: list[str], function: str) -> tuple[int, int, int]:
    """(registers, spill-store bytes, spill-load bytes) that ptxas reported
    for `function` of csrc/<name>.cu. A build that reused a library printed
    nothing: the source is then compiled again into a temporary directory
    for the report."""
    from knnsvc_torch.ops import build

    if not lines:
        with tempfile.TemporaryDirectory() as d:
            proc = subprocess.run([build._nvcc(), *build.NVCC_FLAGS, "-o",
                                   os.path.join(d, f"lib{name}.so"),
                                   str(build.CSRC_DIR / f"{name}.cu")],
                                  capture_output=True, text=True, timeout=build.BUILD_TIMEOUT_S)
        lines = (proc.stdout + proc.stderr).splitlines()
    regs = spills = None
    mine = False
    for ln in lines:
        if "entry function" in ln or "Function properties for" in ln:
            mine = function in ln
        elif mine and (m := re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", ln)):
            spills = int(m[1]), int(m[2])
        elif mine and (m := re.search(r"Used (\d+) registers", ln)):
            regs = int(m[1])
    if regs is None or spills is None:
        fail(f"ptxas reported no registers or spills for {function} in {name}.cu")
    return regs, *spills


def attention_inputs(gen, dev, H, T, d, gate_value=None, full=False):
    """q, k, v, the bias (its (H, 2T-1) diagonal table, or with full a random
    (H, T, T) bias, not Toeplitz), gate"""
    import torch

    q, k, v = (torch.randn(H, T, d, generator=gen) for _ in range(3))
    bias = torch.randn((H, T, T) if full else (H, 2 * T - 1), generator=gen)
    gate = (torch.rand(H, T, generator=gen) * 2 if gate_value is None
            else torch.full((H, T), gate_value))
    return [t.to(dev) for t in (q, k, v, bias, gate)]


def phase_kernels(dev):
    """The attention kernel's diagonal entry (the served encoder's)."""
    import torch
    import torch.nn.functional as F

    from knnsvc_torch.ops.attention import (gated_bias_attention_diag,
                                            reference_attention, toeplitz_bias)
    from knnsvc_torch.precision import set_precision

    gen = torch.Generator().manual_seed(1)

    def inputs(H, T, d, gate_value=None):
        return attention_inputs(gen, dev, H, T, d, gate_value)

    for H, T, d, g in ATTN_RAGGED:
        args = inputs(H, T, d, g)
        err = float((gated_bias_attention_diag(*args) - reference_attention(*args)).abs().max())
        torch.cuda.synchronize()
        log(f"[kernel] gated_bias_attention_diag ({H},{T},{d}) gate={g}: max_abs_err={err:.3e} "
            f"(atol {ATTN_ATOL_RAGGED})")
        if not err <= ATTN_ATOL_RAGGED:
            fail(f"gated_bias_attention_diag disagrees at ({H},{T},{d}) gate={g}: {err}")

    H, T, d = ATTN_MAIN
    args = inputs(H, T, d)
    out = gated_bias_attention_diag(*args)
    torch.cuda.synchronize()
    want = reference_attention(*args)
    err = float((out - want).abs().max())
    log(f"[kernel] gated_bias_attention_diag ({H},{T},{d}): max_abs_err={err:.3e} "
        f"(atol {ATTN_ATOL_MAIN})")
    if not (err <= ATTN_ATOL_MAIN and bool(torch.isfinite(out).all())):
        fail(f"gated_bias_attention_diag disagrees at the main shape: {err}")

    q, k, v, diag, gate = args
    bias = toeplitz_bias(diag).contiguous()      # the library call's mask, expanded untimed
    ms = cuda_ms(lambda: gated_bias_attention_diag(*args))
    plain_ms = cuda_ms(lambda: reference_attention(*args))
    library_ms = cuda_ms(lambda: F.scaled_dot_product_attention(
        q[None], k[None], v[None], attn_mask=(gate[..., None] * bias)[None]))
    bound_ms, bound_by = attention_bound_ms(H, T, d)
    log(f"[kernel] gated_bias_attention_diag ({H},{T},{d}), 3xTF32: kernel {ms:.4f} ms, plain "
        f"{plain_ms:.4f} ms, library (sdpa + mask product) {library_ms:.4f} ms, bound "
        f"{bound_ms:.4f} ms ({bound_by}); roofline share {bound_ms / ms:.1%}")

    set_precision("fastest")
    try:
        tf32_out = gated_bias_attention_diag(*args)
        torch.cuda.synchronize()
        tf32_ms = cuda_ms(lambda: gated_bias_attention_diag(*args))
    finally:
        set_precision("highest")
    tf32_err = float((tf32_out - want).abs().max())
    tf32_bound_ms, _ = attention_bound_ms(H, T, d, passes=1)
    log(f"[kernel] gated_bias_attention_diag ({H},{T},{d}), one TF32 pass (fastest): "
        f"max_abs_err={tf32_err:.3e} (atol {ATTN_ATOL_TF32}), kernel {tf32_ms:.4f} ms, bound "
        f"{tf32_bound_ms:.4f} ms; roofline share {tf32_bound_ms / tf32_ms:.1%}")
    if not (tf32_err <= ATTN_ATOL_TF32 and bool(torch.isfinite(tf32_out).all())):
        fail(f"gated_bias_attention_diag's TF32 instance disagrees at the main shape: {tf32_err}")
    # a streaming window's shape (encoder='windowed' at the CLI defaults)
    H, T, d = ATTN_STREAM
    sargs = inputs(H, T, d)
    s_err = float((gated_bias_attention_diag(*sargs) - reference_attention(*sargs)).abs().max())
    torch.cuda.synchronize()
    q, k, v, diag, gate = sargs
    s_bias = toeplitz_bias(diag).contiguous()
    s_ms = cuda_ms(lambda: gated_bias_attention_diag(*sargs), iters=50)
    s_plain_ms = cuda_ms(lambda: reference_attention(*sargs), iters=50)
    s_library_ms = cuda_ms(lambda: F.scaled_dot_product_attention(
        q[None], k[None], v[None], attn_mask=(gate[..., None] * s_bias)[None]), iters=50)
    s_bound_ms, s_bound_by = attention_bound_ms(H, T, d)
    log(f"[kernel] gated_bias_attention_diag {ATTN_STREAM} (a streaming window), 3xTF32: "
        f"max_abs_err={s_err:.3e} (atol {ATTN_ATOL_RAGGED}); kernel {s_ms:.4f} ms, plain "
        f"{s_plain_ms:.4f} ms, library (sdpa + mask product) {s_library_ms:.4f} ms, bound "
        f"{s_bound_ms:.4f} ms ({s_bound_by}); roofline share {s_bound_ms / s_ms:.1%}")
    if not s_err <= ATTN_ATOL_RAGGED:
        fail(f"gated_bias_attention_diag disagrees at the streaming shape: {s_err}")
    return {"name": "gated_bias_attention_diag", "route": "cuda",
            "source": "knnsvc_torch/csrc/gated_bias_attention.cu",
            "replaces": "knnsvc_tpu/ops/attention.py:82",
            "launches": None, "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": bound_ms, "bound_by": bound_by, "library_ms": library_ms,
            "tf32_ms": tf32_ms, "tf32_max_abs_err": tf32_err, "tf32_bound_ms": tf32_bound_ms,
            "stream_shape": list(ATTN_STREAM), "stream_max_abs_err": s_err, "stream_ms": s_ms,
            "stream_plain_ms": s_plain_ms, "stream_library_ms": s_library_ms,
            "stream_bound_ms": s_bound_ms, "stream_bound_by": s_bound_by}


def phase_attention_full(dev):
    """The attention kernel's full-bias entry (the TPU kernel's own form, a
    random (H, T, T) bias): against the plain version at the ragged, main
    and streaming shapes, one TF32 pass at the main shape, a Toeplitz bias
    against the diagonal entry (one inner loop: bit-equal), and times beside
    the plain version, the library call and the bound."""
    import torch
    import torch.nn.functional as F

    from knnsvc_torch.ops.attention import (gated_bias_attention, gated_bias_attention_diag,
                                            reference_attention, toeplitz_bias)
    from knnsvc_torch.precision import set_precision

    gen = torch.Generator().manual_seed(2)
    card = card_label()
    for H, T, d, g in ATTN_RAGGED:
        args = attention_inputs(gen, dev, H, T, d, g, full=True)
        err = float((gated_bias_attention(*args) - reference_attention(*args)).abs().max())
        torch.cuda.synchronize()
        log(f"[kernel] gated_bias_attention (full bias) ({H},{T},{d}) gate={g}: "
            f"max_abs_err={err:.3e} (atol {ATTN_ATOL_RAGGED})")
        if not err <= ATTN_ATOL_RAGGED:
            fail(f"gated_bias_attention disagrees at ({H},{T},{d}) gate={g}: {err}")

    rec = {"name": "gated_bias_attention", "route": "cuda",
           "source": "knnsvc_torch/csrc/gated_bias_attention.cu",
           "replaces": "knnsvc_tpu/ops/attention.py:82", "launches": None}
    for label, shape, atol, iters in (("", ATTN_MAIN, ATTN_ATOL_MAIN, 20),
                                      ("stream_", ATTN_STREAM, ATTN_ATOL_RAGGED, 50)):
        H, T, d = shape
        args = attention_inputs(gen, dev, H, T, d, full=True)
        out = gated_bias_attention(*args)
        torch.cuda.synchronize()
        want = reference_attention(*args)
        err = float((out - want).abs().max())
        q, k, v, bias, gate = args
        ms = cuda_ms(lambda: gated_bias_attention(*args), iters=iters)
        plain_ms = cuda_ms(lambda: reference_attention(*args), iters=iters)
        library_ms = cuda_ms(lambda: F.scaled_dot_product_attention(
            q[None], k[None], v[None], attn_mask=(gate[..., None] * bias)[None]), iters=iters)
        bound_ms, bound_by = attention_bound_ms(H, T, d, full=True)
        log(f"[kernel] gated_bias_attention (full bias) {shape}, 3xTF32: max_abs_err={err:.3e} "
            f"(atol {atol}); kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, library (sdpa + mask "
            f"product) {library_ms:.4f} ms, bound {bound_ms:.4f} ms ({bound_by}); roofline "
            f"share {bound_ms / ms:.1%}; card {card}")
        if not (err <= atol and bool(torch.isfinite(out).all())):
            fail(f"gated_bias_attention disagrees at {shape}: {err}")
        rec.update({f"{label}max_abs_err": err, f"{label}ms": ms, f"{label}plain_ms": plain_ms,
                    f"{label}bound_ms": bound_ms, f"{label}bound_by": bound_by,
                    f"{label}library_ms": library_ms})
        if not label:
            main_args, main_want = args, want
    rec["stream_shape"] = list(ATTN_STREAM)

    H, T, d = ATTN_MAIN
    set_precision("fastest")
    try:
        tf32_out = gated_bias_attention(*main_args)
        torch.cuda.synchronize()
        tf32_ms = cuda_ms(lambda: gated_bias_attention(*main_args))
    finally:
        set_precision("highest")
    tf32_err = float((tf32_out - main_want).abs().max())
    tf32_bound_ms, tf32_bound_by = attention_bound_ms(H, T, d, passes=1, full=True)
    log(f"[kernel] gated_bias_attention (full bias) {ATTN_MAIN}, one TF32 pass (fastest): "
        f"max_abs_err={tf32_err:.3e} (atol {ATTN_ATOL_TF32}), kernel {tf32_ms:.4f} ms, bound "
        f"{tf32_bound_ms:.4f} ms ({tf32_bound_by}); roofline share "
        f"{tf32_bound_ms / tf32_ms:.1%}; card {card}")
    if not (tf32_err <= ATTN_ATOL_TF32 and bool(torch.isfinite(tf32_out).all())):
        fail(f"gated_bias_attention's TF32 instance disagrees at the main shape: {tf32_err}")
    rec.update({"tf32_ms": tf32_ms, "tf32_max_abs_err": tf32_err, "tf32_bound_ms": tf32_bound_ms})

    # a Toeplitz bias through the full entry against the diagonal entry
    for mode in ("highest", "fastest"):
        set_precision(mode)
        try:
            for shape in (ATTN_MAIN, ATTN_STREAM):
                q, k, v, diag, gate = attention_inputs(gen, dev, *shape)
                full = gated_bias_attention(q, k, v, toeplitz_bias(diag).contiguous(), gate)
                diagonal = gated_bias_attention_diag(q, k, v, diag, gate)
                torch.cuda.synchronize()
                diff = float((full - diagonal).abs().max())
                log(f"[kernel] gated_bias_attention {shape} {mode}: a Toeplitz bias through the "
                    f"full entry vs the diagonal entry: max |diff| {diff:.3e}, bit-equal "
                    f"{torch.equal(full, diagonal)}")
                if not torch.equal(full, diagonal):
                    fail(f"the full entry differs from the diagonal entry on a Toeplitz bias at "
                         f"{shape} ({mode}): {diff}")
        finally:
            set_precision("highest")
    return rec


def concat_bound_ms(T: int, P: int, D: int, lanes: int, k: int) -> tuple[float, str]:
    """Least time for the work on an H100: per frame and lane 2k^2 + 2k
    dots of D multiply-adds (k x 2k cross dots against the picks, 2k source
    dots), plus the P pool norms once, 2 flops each; bytes = source and pool
    rows, ids, f0 tracks and baselines read once and the picks written once."""
    ops = (lanes * (T - 1) * (2 * k * k + 2 * k) + P) * 2 * D
    nbytes = 4 * (T * D + P * D + 2 * T * lanes * k + (T - 1) + T + P)
    t_ops, t_bytes = ops / PEAK_FP32_FLOPS, nbytes / PEAK_BYTES_PER_S
    return 1e3 * max(t_ops, t_bytes), ("operations" if t_ops >= t_bytes else "bytes")


def concat_inputs(T: int, P: int, D: int, seed: int, dev, clamp_and_duplicates=False, k=4):
    """Random ids and features with a smooth source stretch (baselines under
    0.08, so the pitched lane's weight latches part way through); optionally
    ids at row P-1 and own candidates equal to each other and to prev + 1."""
    import numpy as np
    import torch

    rng = np.random.default_rng(seed)
    src = rng.standard_normal((T, D)).astype(np.float32)
    src[12:20] = src[12] + 0.01 * rng.standard_normal((8, D)).astype(np.float32)
    tgt = rng.standard_normal((P, D)).astype(np.float32)
    idx_u, idx_p = rng.integers(0, P, (T, k)), rng.integers(0, P, (T, k))
    if clamp_and_duplicates:
        idx_u[::3, 0] = P - 1
        idx_p[::4, 1 % k] = P - 1
        idx_u[1::2, 2 % k] = idx_u[1::2, 1 % k]
        idx_p[1:, 3 % k] = np.minimum(idx_p[:-1, 0] + 1, P - 1)
    sf0 = (80 + 300 * rng.random(T)).astype(np.float32)
    sf0[::5] = 0.0
    tf0 = (80 + 300 * rng.random(P)).astype(np.float32)
    return [torch.from_numpy(a).to(dev) for a in (idx_u, idx_p, src, tgt, sf0, tf0)]


def phase_concat_kernel(dev):
    import torch

    from knnsvc_torch.match.concat_cost import knn_with_concat_cost_pair, scan_inputs
    from knnsvc_torch.ops.concat_scan import (concat_cost_pair, concat_cost_prepass,
                                              concat_cost_single)

    max_err = 0
    cases = [(*CONCAT_SMALL, k, dup) for k in (4, *CONCAT_KS) for dup in (False, True)]
    for T, P, D, k, dup in [*cases, (*CONCAT_L2, False)]:
        args = concat_inputs(T, P, D, 3, dev, clamp_and_duplicates=dup, k=k)
        got = [*concat_cost_pair(*args), concat_cost_single(args[0], *args[2:4])]
        want = knn_with_concat_cost_pair(*args)
        want = [*want, want[0]]
        torch.cuda.synchronize()
        err = max(int((g - w).abs().max()) for g, w in zip(got, want))
        max_err = max(max_err, err)
        log(f"[kernel] concat_cost_pair ({T}, {P}, {D}) k={k} "
            f"{'ids at P-1, duplicates' if dup else 'random ids'}: pair and single lane "
            f"equal to the plain version: {err == 0} (max |id diff| {err})")
        if err != 0:
            fail(f"concat_cost_pair disagrees with its plain version at ({T}, {P}, {D}) k={k}")

    def equal_shares(args, k):
        """Frames whose picks equal the plain version's, per lane; fails
        below CONCAT_SHARE_MIN."""
        got = concat_cost_pair(*args)
        want = knn_with_concat_cost_pair(*args)
        shares = [float((g == w).all(dim=1).float().mean()) for g, w in zip(got, want)]
        log(f"[kernel] concat_cost_pair {CONCAT_MAIN} k={k}: frames equal to the plain "
            f"version, unpitched {shares[0]:.2%}, pitched {shares[1]:.2%} "
            f"(min {CONCAT_SHARE_MIN:.0%})")
        if not min(shares) >= CONCAT_SHARE_MIN:
            fail(f"concat_cost_pair agrees with its plain version on only {min(shares):.2%} "
                 f"of frames at the main shape, k={k}")
        return min(shares)

    T, P, D = CONCAT_MAIN
    args = concat_inputs(T, P, D, 4, dev)
    share = equal_shares(args, 4)
    ms = cuda_ms(lambda: concat_cost_pair(*args))
    idx = torch.stack(args[:2], dim=1).to(torch.int32).contiguous()
    svn = scan_inputs(args[2], None, None)[0]
    prepass_ms = cuda_ms(lambda: concat_cost_prepass(idx, svn, args[3]))
    plain_ms = cuda_ms(lambda: knn_with_concat_cost_pair(*args), iters=CONCAT_PLAIN_RUNS,
                       warmup=1)
    bound_ms, bound_by = concat_bound_ms(T, P, D, lanes=2, k=4)
    log(f"[kernel] concat_cost_pair {CONCAT_MAIN} k=4: kernel {ms:.4f} ms "
        f"({1e3 * ms / (T - 1):.3f} us per frame), plain {plain_ms:.4f} ms, library none, "
        f"bound {bound_ms:.4f} ms ({bound_by}); roofline share {bound_ms / ms:.2%}")
    log(f"[kernel] concat_cost_pair {CONCAT_MAIN} k=4: of which the pre-pass alone "
        f"(pool norms, own source dots) {prepass_ms:.4f} ms")
    wide = concat_inputs(T, P, D, 5, dev, k=TOPK_WIDE)
    share = min(share, equal_shares(wide, TOPK_WIDE))
    wide_ms = cuda_ms(lambda: concat_cost_pair(*wide), iters=5, warmup=1)
    wide_bound_ms, wide_by = concat_bound_ms(T, P, D, lanes=2, k=TOPK_WIDE)
    log(f"[kernel] concat_cost_pair {CONCAT_MAIN} k={TOPK_WIDE} (rows in L2): kernel "
        f"{wide_ms:.4f} ms ({1e3 * wide_ms / (T - 1):.3f} us per frame), bound "
        f"{wide_bound_ms:.4f} ms ({wide_by})")
    record = {"name": "concat_cost_pair", "route": "cuda",
              "source": "knnsvc_torch/csrc/concat_cost_pair.cu",
              "replaces": "knnsvc_tpu/ops/concat_scan.py:182",
              "launches": None, "max_abs_err": float(max_err), "equal_share": share,
              "ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms, "bound_by": bound_by,
              "library_ms": None, "us_per_frame": 1e3 * ms / (T - 1), "prepass_ms": prepass_ms,
              "launch_note": "one launch per call: the pre-pass kernel, then the chain kernel"}
    record.update(phase_concat_carried(dev, args))
    return record


def carried_args(T: int, P: int, D: int, seed: int, dev, k: int, weight: float,
                 clamp_and_duplicates=False):
    """Inputs of the carried entry, T frames through the kernel with the
    carry: T - 1 frames of concat_inputs from frame 13, inside its smooth
    stretch (baselines under 0.08 until frame 20, so a carried weight of
    0.2 holds a few frames, then latches), the previous frame's source row
    and a random carry (2, k) with `weight`."""
    import torch

    s = 13
    idx_u, idx_p, src, tgt, sf0, tf0 = concat_inputs(T + s - 1, P, D, seed, dev,
                                                     clamp_and_duplicates, k)
    carry = torch.randint(0, P, (2, k), generator=torch.Generator().manual_seed(seed)).to(dev)
    if clamp_and_duplicates:
        carry[0, 0] = P - 1
    return (idx_u[s:], idx_p[s:], src[s - 1], src[s:], tgt, sf0[s:], tf0, carry,
            torch.tensor(weight, device=dev))


def phase_concat_carried(dev, main_args) -> dict:
    """The kernel's carried entry (a streaming chunk: the carry as frame 0,
    the pitched lanes from the carried weight) against the plain carried
    cores, picks and the weight after each frame; chunks chained through it
    against the whole-utterance kernel; its time at a streaming chunk."""
    import torch

    from knnsvc_torch.match.concat_cost import (concat_cost_pair_stream_core,
                                                concat_cost_stream_core)
    from knnsvc_torch.ops.concat_scan import (concat_cost_pair, concat_cost_pair_stream,
                                              concat_cost_single_stream)

    def check(args, label):
        got = concat_cost_pair_stream(*args)
        got_s = concat_cost_single_stream(args[0], *args[2:5], args[7][0], args[8])
        want = concat_cost_pair_stream_core(*args)
        want_s = concat_cost_stream_core(args[0], *args[2:5], args[7][0], args[8])
        torch.cuda.synchronize()
        picks = [float((g == w).all(dim=1).float().mean()) for g, w in
                 ((got[0], want[0]), (got[1], want[1]), (got_s[0], want_s[0]))]
        weights = torch.equal(got[2], want[2]) and torch.equal(got_s[1], want_s[1])
        log(f"[kernel] concat_cost_pair carried {label}: frames with equal picks, pair "
            f"unpitched {picks[0]:.2%}, pitched {picks[1]:.2%}, single {picks[2]:.2%}; weights "
            f"after each frame equal {weights} (pitched latched to 0 from frame "
            f"{int((got[2] == 0).float().argmax()) if bool((got[2] == 0).any()) else None})")
        if min(picks) != 1.0 or not weights:
            fail(f"the carried concat entry disagrees with its plain version at {label}")

    for k in CARRIED_KS:
        for weight in (0.2, 0.0):
            for dup in (False, True):
                check(carried_args(*CONCAT_SMALL, 23, dev, k, weight, dup),
                      f"{CONCAT_SMALL} k={k} weight={weight} "
                      f"{'ids at P-1, duplicates' if dup else 'random ids'}")
    T, P, D = CARRIED_STREAM
    for k in (4, TOPK_WIDE):
        check(carried_args(T + 1, P, D, 24, dev, k, 0.2), f"({T}+1, {P}, {D}) k={k}")

    # chaining: chunk 0 through the whole-utterance entry, the rest carried
    idx_u, idx_p, src, tgt, sf0, tf0 = main_args
    whole = concat_cost_pair(*main_args)
    n = CONCAT_MAIN[0] // CHAIN_CHUNKS
    u, p = concat_cost_pair(idx_u[:n], idx_p[:n], src[:n], tgt, sf0[:n], tf0)
    us, ps = [u], [p]
    svn = src[:n] / torch.linalg.norm(src[:n], dim=1, keepdim=True)
    weight = 0.2 * float(torch.prod(((2 * (1 - (svn[:-1] * svn[1:]).sum(1))) < 0.08).float()))
    for a in range(n, CONCAT_MAIN[0], n):
        u, p, w = concat_cost_pair_stream(idx_u[a:a + n], idx_p[a:a + n], src[a - 1],
                                          src[a:a + n], tgt, sf0[a:a + n], tf0,
                                          torch.stack([us[-1][-1], ps[-1][-1]]), weight)
        us.append(u)
        ps.append(p)
        weight = w[-1]
    torch.cuda.synchronize()
    chained = [float((torch.cat(x) == w).all(dim=1).float().mean()) for x, w in
               ((us, whole[0]), (ps, whole[1]))]
    log(f"[kernel] concat_cost_pair: {CHAIN_CHUNKS} chunks of {n} frames chained through the "
        f"carried entry against the whole-utterance kernel at {CONCAT_MAIN} k=4: frames equal, "
        f"unpitched {chained[0]:.2%}, pitched {chained[1]:.2%}")
    if min(chained) != 1.0:
        fail(f"chained carried chunks differ from the whole-utterance kernel: {chained}")

    args = carried_args(T + 1, P, D, 25, dev, 4, 0.2)
    c_ms = cuda_ms(lambda: concat_cost_pair_stream(*args), iters=50)
    c_plain_ms = cuda_ms(lambda: concat_cost_pair_stream_core(*args), iters=3, warmup=1)
    c_bound_ms, c_bound_by = concat_bound_ms(T + 1, P, D, lanes=2, k=4)
    log(f"[kernel] concat_cost_pair carried ({T}+1, {P}, {D}) k=4 (a streaming chunk): kernel "
        f"{c_ms:.4f} ms ({1e3 * c_ms / T:.3f} us per frame, the weights' torch ops included), "
        f"plain {c_plain_ms:.4f} ms, library none, bound {c_bound_ms:.4f} ms ({c_bound_by})")
    return {"carried_shape": [T + 1, P, D], "carried_ms": c_ms, "carried_plain_ms": c_plain_ms,
            "carried_bound_ms": c_bound_ms, "carried_bound_by": c_bound_by,
            "chained_equal_share": min(chained)}


def viterbi_bound_ms(N: int, C: int) -> tuple[float, str]:
    """Least time for the recursion on an H100: the (N, C) and (N,) costs
    read once and the (N,) states written once at the HBM rate; per frame
    and state ~VITERBI_FLOPS_PER_STATE fp32 operations at the fp32 peak."""
    nbytes = 4 * (N * C + N + N)
    ops = VITERBI_FLOPS_PER_STATE * (N - 1) * (C + 1)
    t_ops, t_bytes = ops / PEAK_FP32_FLOPS, nbytes / PEAK_BYTES_PER_S
    return 1e3 * max(t_ops, t_bytes), ("operations" if t_ops >= t_bytes else "bytes")


def phase_viterbi_kernel(dev, ptxas: list[str]):
    import numpy as np
    import torch
    import torch.nn.functional as F

    from knnsvc_torch.dsp.f0_device import device_f0, device_f0_tensor, viterbi_inputs
    from knnsvc_torch.ops.viterbi import f0_viterbi, viterbi_plain

    N, C = VITERBI_MAIN
    wav, _ = sung_wav(FULL_SECONDS, VOICES[0][1], VOICES[0][2])
    wav[:16000] = 0.0                     # a silent second: 1e3 rows, ties
    x = torch.from_numpy(wav).to(dev)
    real = viterbi_inputs(x, 16000, N)
    lam_s, switch = real[2:]
    rng = np.random.default_rng(6)
    cv = rng.standard_normal((N, C)).astype(np.float32)
    cu = (0.5 * rng.standard_normal(N)).astype(np.float32)
    tied_v, tied_u = cv.copy(), cu.copy()
    tied_v[::3] = 1e3
    tied_v[1::4, 200:] = tied_v[1::4, 200:201]
    tied_v[2::5] = np.round(tied_v[2::5])
    tied_u[::7] = 1e3
    const_v = np.repeat(cv[:, :1], C, axis=1)    # every row one value: the argmin ties at every level
    cases = {"random": (cv, cu), "ties": (tied_v, tied_u), "constant rows": (const_v, cu),
             "sung 30-s wav": real[:2]}
    max_err = 0
    for name, (a, b) in cases.items():
        a, b = torch.as_tensor(a).to(dev), torch.as_tensor(b).to(dev)
        got = f0_viterbi(a, b, lam_s, switch)
        torch.cuda.synchronize()
        want = viterbi_plain(a, b, lam_s, switch)
        equal = float((got == want).float().mean())
        max_err = max(max_err, int((got - want).abs().max()))
        log(f"[kernel] f0_viterbi ({N}, {C}) {name}: states equal to the plain version on "
            f"{equal:.2%} of frames; unvoiced share {float((want == C).float().mean()):.1%}")
        if equal != 1.0:
            fail(f"f0_viterbi disagrees with its plain version on {name} costs: {equal:.4%}")

    cost_v, cost_u = real[:2]
    ms = cuda_ms(lambda: f0_viterbi(cost_v, cost_u, lam_s, switch))
    plain_ms = cuda_ms(lambda: viterbi_plain(cost_v, cost_u, lam_s, switch), iters=1, warmup=0)
    bound_ms, bound_by = viterbi_bound_ms(N, C)
    ptr_bound_ms = 1e3 * (4 * (N * C + 2 * N) + 2 * 2 * (N - 1) * (C + 1)) / PEAK_BYTES_PER_S
    regs, spill_st, spill_ld = ptxas_usage("f0_viterbi", ptxas, "f0_viterbi_kernelILi4E")
    log(f"[kernel] f0_viterbi ({N}, {C}) sung costs: kernel {ms:.4f} ms "
        f"({1e3 * ms / (N - 1):.4f} us per frame; ptxas: {regs} registers, {spill_st} bytes "
        f"spill stores, {spill_ld} bytes spill loads), plain {plain_ms:.1f} ms (one run), library "
        f"none, bound {bound_ms:.4f} ms ({bound_by}; {ptr_bound_ms:.4f} ms with the int16 "
        f"pointers written and read back); latency-bound in fact: a chain of {N - 1} "
        f"dependent frames")
    if spill_st or spill_ld:
        fail(f"f0_viterbi_kernel<4> spills: {spill_st} bytes stored, {spill_ld} loaded")

    # device f0 on the card against the CPU, on the same wav
    card = device_f0(wav, 16000, device=dev)
    cpu = device_f0(wav, 16000, device="cpu")
    voicing = float(((card > 0) == (cpu > 0)).mean())
    both = (card > 0) & (cpu > 0)
    within = float((np.abs(1200 * np.log2(card[both] / cpu[both])) <= F0_CENTS).mean())
    log(f"[f0] device_f0 card vs cpu on the sung {FULL_SECONDS:.0f}-s wav ({len(card)} frames, "
        f"{both.mean():.1%} voiced in both): voicing equal on {voicing:.2%} (min "
        f"{F0_VOICING_SHARE_MIN:.1%}), f0 within {F0_CENTS} cent on {within:.2%} (min "
        f"{F0_CENTS_SHARE_MIN:.0%}); max {float(np.abs(1200 * np.log2(card[both] / cpu[both])).max()):.4f} cents")
    if not (voicing >= F0_VOICING_SHARE_MIN and within >= F0_CENTS_SHARE_MIN and both.mean() > 0.5):
        fail(f"device f0 differs between card and cpu: voicing {voicing}, within {within}")
    tensor_ms = cuda_ms(lambda: device_f0_tensor(x, 16000, N), iters=10)
    log(f"[f0] one {FULL_SECONDS:.0f}-s device_f0_tensor on the card: {tensor_ms:.4f} ms, of which "
        f"the Viterbi kernel {ms:.4f} ms ({ms / tensor_ms:.1%})")
    # a streaming window's Viterbi (encoder='windowed', f0_method='device')
    n_win = VITERBI_STREAM
    # the window's 200 frames of audio and build_device_pool's hop of padding
    win = viterbi_inputs(F.pad(x[:n_win * 320], (0, 320)), 16000, n_win)
    got = f0_viterbi(*win)
    torch.cuda.synchronize()
    if not torch.equal(got, viterbi_plain(*win)):
        fail(f"f0_viterbi disagrees with its plain version at ({n_win}, {C})")
    w_ms = cuda_ms(lambda: f0_viterbi(*win), iters=50)
    w_plain_ms = cuda_ms(lambda: viterbi_plain(*win), iters=1, warmup=0)
    w_bound_ms, w_bound_by = viterbi_bound_ms(n_win, C)
    log(f"[kernel] f0_viterbi ({n_win}, {C}) (a streaming window): states equal to the plain "
        f"version; kernel {w_ms:.4f} ms ({1e3 * w_ms / (n_win - 1):.3f} us per frame), plain "
        f"{w_plain_ms:.1f} ms, bound {w_bound_ms:.4f} ms ({w_bound_by})")
    return {"name": "f0_viterbi", "route": "cuda", "source": "knnsvc_torch/csrc/f0_viterbi.cu",
            "replaces": "knnsvc_tpu/dsp/f0_device.py:204 (_viterbi, an XLA lax.scan, not a "
                        "Pallas kernel)",
            "launches": None, "max_abs_err": float(max_err), "ms": ms, "plain_ms": plain_ms,
            "bound_ms": bound_ms, "bound_by": bound_by, "library_ms": None,
            "us_per_frame": 1e3 * ms / (N - 1), "device_f0_ms": tensor_ms,
            "registers": regs, "spill_bytes": spill_st + spill_ld,
            "stream_shape": [n_win, C], "stream_ms": w_ms, "stream_plain_ms": w_plain_ms,
            "stream_bound_ms": w_bound_ms, "stream_bound_by": w_bound_by}


def write_pair(root: str, seconds: float, sidecars: bool):
    from knnsvc_torch.dsp.f0 import save_f0_sidecar
    from knnsvc_torch.io.audio import save_audio

    paths = []
    for name, hz, seed in VOICES:
        wav, f0 = sung_wav(seconds, hz, seed)
        path = os.path.join(root, f"{name}_{int(seconds)}s.wav")
        save_audio(path, wav, 16000)
        if sidecars:
            save_f0_sidecar(path, f0)
        paths.append(path)
    return paths


class OptimizerSteps(logging.Handler):
    """Collects the step counts that the smoothness optimizer logs (DEBUG,
    one record per optimization) while the context is open."""

    def emit(self, record) -> None:
        self.steps.append(int(record.args[0]))

    def __enter__(self):
        self.steps: list[int] = []
        self.logger = logging.getLogger("knnsvc_torch.match.smoothness")
        self.level = self.logger.level
        self.logger.setLevel(logging.DEBUG)
        self.logger.addHandler(self)
        return self

    def __exit__(self, *exc):
        self.logger.removeHandler(self)
        self.logger.setLevel(self.level)


def concat_picks(q, pool, qf0, pool_f0):
    """The post_opt match up to the concat-cost reselection, through the
    port's public functions: (unpitched, pitched) picks (T, 4) on the CPU."""
    from knnsvc_torch.match.f0_logic import (shift_f0_to_target_register,
                                             sort_by_f0_compatibility)
    from knnsvc_torch.match.knn import knn_topk
    from knnsvc_torch.ops.concat_scan import concat_cost_pair

    nearest, _ = knn_topk(q, pool, k=32)
    shifted = shift_f0_to_target_register(qf0, pool_f0)
    pitched = sort_by_f0_compatibility(shifted, pool_f0, nearest)[:, :4]
    return [x.cpu() for x in concat_cost_pair(nearest[:, :4], pitched, q, pool, shifted,
                                              pool_f0)]


def phase_slice_cpu_vs_cuda(root: str, dev):
    import numpy as np
    import torch

    from knnsvc_torch import HOP_LENGTH
    from knnsvc_torch.hub import KnnSvc
    from knnsvc_torch.io.audio import save_audio
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
    # kept for the eval phase's regression metrics (PCM_32: the 6e-5 peaks
    # of random weights keep ~17 bits)
    save_audio(os.path.join(root, "slice_cpu.wav"), wa, 16000)
    save_audio(os.path.join(root, "slice_card.wav"), wb, 16000)
    peak = float(np.abs(wa).max())
    rel = float(np.abs(wa - wb).max()) / max(peak, 1e-30)
    log(f"[slice] pre-quantize waveform {wa.shape}: max |cpu| {peak:.3e}, "
        f"max |cuda - cpu| / max |cpu| = {rel:.3e} (tol {WAV_REL_TOL})")
    if not (wa.shape == wb.shape and np.isfinite(wb).all() and rel <= WAV_REL_TOL):
        fail(f"pre-quantize waveforms differ between cuda and cpu: rel {rel}")

    # post_opt: the concat-cost picks of each side from its own features and
    # the f0 sidecars, then the whole conversion with the optimizer
    f0 = {name: sung_wav(SLICE_SECONDS, hz, seed)[1] for name, hz, seed in VOICES}
    picks = []
    for side, device in ((0, torch.device("cpu")), (1, dev)):
        q, pool = feats["src"][side].to(device), feats["ref"][side].to(device)
        qf0 = torch.from_numpy(f0["src"][:q.shape[0]].copy()).to(device)
        pf0 = torch.from_numpy(f0["ref"][:pool.shape[0]].copy()).to(device)
        picks.append(concat_picks(q, pool, qf0, pf0))
    shares = [float((a == b).all(dim=1).float().mean()) for a, b in zip(*picks)]
    log(f"[slice] {POST_OPT} concat-cost picks equal on cuda and cpu: unpitched "
        f"{shares[0]:.1%}, pitched {shares[1]:.1%} of {picks[0][0].shape[0]} frames "
        f"(min {PICK_SHARE_MIN:.0%})")
    if not min(shares) >= PICK_SHARE_MIN:
        fail(f"concat-cost picks agree on only {min(shares):.1%} of frames")
    with OptimizerSteps() as cpu_steps:
        wa = cpu.convert_waveform(src, ref, post_opt=POST_OPT).numpy()
    with OptimizerSteps() as gpu_steps:
        wb = gpu.convert_waveform(src, ref, post_opt=POST_OPT).cpu().numpy()
    peak = float(np.abs(wa).max())
    rel = float(np.abs(wa - wb).max()) / max(peak, 1e-30)
    log(f"[slice] {POST_OPT} optimizer steps (wavlm, harmonics): cpu {cpu_steps.steps}, "
        f"cuda {gpu_steps.steps}")
    log(f"[slice] {POST_OPT} pre-quantize waveform {wa.shape}: max |cpu| {peak:.3e}, "
        f"max |cuda - cpu| / max |cpu| = {rel:.3e} (tol {WAV_REL_TOL})")
    if not (wa.shape == wb.shape and np.isfinite(wb).all() and rel <= WAV_REL_TOL
            and len(gpu_steps.steps) == 2):
        fail(f"{POST_OPT} waveforms differ between cuda and cpu: rel {rel}")
    return gpu, cpu


def phase_full(root: str, knn, records, dev):
    import numpy as np
    import torch

    from knnsvc_torch.hub import KnnSvc
    from knnsvc_torch.io.audio import load_audio
    from knnsvc_torch.match.serve import quantize_int16
    from knnsvc_torch.models.wavlm.model import frame_count
    from knnsvc_torch.ops.attention import gated_bias_attention_diag
    from knnsvc_torch.ops.concat_scan import concat_cost_pair
    from knnsvc_torch.ops.viterbi import f0_viterbi

    src, ref = write_pair(root, FULL_SECONDS, sidecars=False)
    out = os.path.join(root, "converted.wav")
    n_frames = frame_count(knn.wavlm_cfg, int(16000 * FULL_SECONDS) + 320)

    def run(s, r, post_opt="no_post_opt", model=knn, topk=4, upload_dtype="float32"):
        """One convert_pair, its counts set to 0 just before and read just
        after: 12 attention launches, one concat-cost launch with post_opt,
        and one Viterbi launch per pool with device f0."""
        gated_bias_attention_diag.launches = 0
        concat_cost_pair.launches = 0
        f0_viterbi.launches = 0
        t0 = time.perf_counter()
        path = model.convert_pair(s, r, topk=topk, fast=True, post_opt=post_opt,
                                  output_path=out, upload_dtype=upload_dtype)
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        launches = (gated_bias_attention_diag.launches, concat_cost_pair.launches,
                    f0_viterbi.launches)
        want = (LAUNCHES_PER_PAIR, 0 if post_opt == "no_post_opt" else 1,
                2 if model.f0_method == "device" else 0)
        if launches != want:
            fail(f"convert_pair({model.ckpt_type}, {post_opt}, f0 {model.f0_method}) launched "
                 f"(attention, concat, viterbi) {launches} times, expected {want}")
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
    log(f"[full] cold convert_pair(fast=True) on a {FULL_SECONDS:.0f}-s pair: {cold_s:.3f} s "
        f"(first conversion in the process; includes the native f0 build when the "
        f"checkout has none, and f0 extraction)")
    torch.cuda.reset_peak_memory_stats()
    fresh_np = [run(*new_pair(f"new{i}"))[0] for i in range(FRESH_RUNS)]
    log(f"[full] warm latency, new pair (f0 extracted) s ({FRESH_RUNS} runs): "
        f"{summary(fresh_np)}")
    cached_np = [run(src, ref)[0] for _ in range(WARM_RUNS)]
    log(f"[full] warm latency, repeat conversion (f0 cached) s ({WARM_RUNS} runs): "
        f"{summary(cached_np)}")
    log(f"[full] peak device memory {torch.cuda.max_memory_allocated() / 2 ** 30:.3f} GiB")

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

    # post_opt_0.2, the paper's CAT + OPT
    first_s, _, _ = run(src, ref, POST_OPT)
    log(f"[post_opt] first convert_pair(fast=True, post_opt={POST_OPT!r}) in the process: "
        f"{first_s:.3f} s (f0 cached)")
    torch.cuda.reset_peak_memory_stats()
    with OptimizerSteps() as steps:
        fresh = [run(*new_pair(f"po_new{i}"), POST_OPT)[0] for i in range(PO_FRESH_RUNS)]
        cached = []
        for _ in range(PO_WARM_RUNS):
            dt, launches, path = run(src, ref, POST_OPT)
            cached.append(dt)
    log(f"[post_opt] warm latency, new pair (f0 extracted) s ({PO_FRESH_RUNS} runs): "
        f"{summary(fresh)}")
    log(f"[post_opt] warm latency, repeat conversion (f0 cached) s ({PO_WARM_RUNS} runs): "
        f"{summary(cached)}")
    pairs = sorted({tuple(steps.steps[i:i + 2]) for i in range(0, len(steps.steps), 2)})
    log(f"[post_opt] optimizer steps per conversion (wavlm, harmonics): {pairs}")
    log(f"[post_opt] peak device memory {torch.cuda.max_memory_allocated() / 2 ** 30:.3f} GiB")
    records["gated_bias_attention_diag"]["launches"] = launches[0]
    records["concat_cost_pair"]["launches"] = launches[1]
    log(f"kernels: gated_bias_attention_diag={launches[0]} concat_cost_pair={launches[1]} "
        f"f0_viterbi={launches[2]} (one {POST_OPT} mix conversion, host f0)")
    y, sr = load_audio(path)
    wav = knn.convert_waveform(src, ref, post_opt=POST_OPT)
    torch.cuda.synchronize()
    peak = float(wav.abs().max())
    if not (sr == 16000 and y.shape[-1] == n_frames * 320 and wav.shape[0] == y.shape[-1]
            and bool(torch.isfinite(wav).all()) and peak > 0):
        fail(f"{POST_OPT} output: sr {sr}, length {y.shape[-1]}, peak {peak}")
    log(f"[post_opt] output {y.shape[-1]} samples; pre-quantize peak {peak:.3e}")

    wide_s, wide_launches, _ = run(src, ref, POST_OPT, topk=TOPK_WIDE)
    wav = knn.convert_waveform(src, ref, topk=TOPK_WIDE, post_opt=POST_OPT)
    torch.cuda.synchronize()
    peak = float(wav.abs().max())
    if not (wav.shape[0] == n_frames * 320 and bool(torch.isfinite(wav).all()) and peak > 0):
        fail(f"{POST_OPT} topk={TOPK_WIDE}: shape {tuple(wav.shape)}, peak {peak}")
    log(f"[post_opt] convert_pair(topk={TOPK_WIDE}, post_opt={POST_OPT!r}) in {wide_s:.4f} s; "
        f"launches (attention, concat) {wide_launches}; pre-quantize peak {peak:.3e}, finite")

    # device f0 and int16 uploads: no host f0 on a new pair
    knn.f0_method = "device"
    try:
        first_s, _, _ = run(src, ref, upload_dtype="int16")
        torch.cuda.reset_peak_memory_stats()
        dev_fresh = [run(*new_pair(f"dev_new{i}"), upload_dtype="int16")[0]
                     for i in range(DEV_FRESH_RUNS)]
        dev_cached, launches = [], None
        for _ in range(DEV_WARM_RUNS):
            dt, launches, path = run(src, ref, upload_dtype="int16")
            dev_cached.append(dt)
        records["f0_viterbi"]["launches"] = launches[2]
        log(f"[device_f0] first convert_pair(fast=True, f0_method='device', "
            f"upload_dtype='int16') in the process: {first_s:.3f} s")
        log(f"[device_f0] warm latency, new pair s ({DEV_FRESH_RUNS} runs): {summary(dev_fresh)}")
        log(f"[device_f0] warm latency, repeat conversion s ({DEV_WARM_RUNS} runs): "
            f"{summary(dev_cached)}")
        log(f"[device_f0] beside host f0 in this run: new pair median "
            f"{statistics.median(fresh_np):.4f} s, repeat median "
            f"{statistics.median(cached_np):.4f} s")
        log(f"[device_f0] peak device memory {torch.cuda.max_memory_allocated() / 2 ** 30:.3f} GiB")
        log(f"kernels: gated_bias_attention_diag={launches[0]} concat_cost_pair={launches[1]} "
            f"f0_viterbi={launches[2]} (one no_post_opt mix conversion, device f0, int16 uploads)")
        y, sr = load_audio(path)
        wav = knn.convert_waveform(src, ref, upload_dtype="int16")
        torch.cuda.synchronize()
        peak = float(wav.abs().max())
        if not (sr == 16000 and y.shape[-1] == n_frames * 320 and wav.shape[0] == y.shape[-1]
                and bool(torch.isfinite(wav).all()) and peak > 0):
            fail(f"device-f0 output: sr {sr}, length {y.shape[-1]}, peak {peak}")
        log(f"[device_f0] output {y.shape[-1]} samples; pre-quantize peak {peak:.3e}, finite")
        phase_profile(knn, *new_pair("dev_traced"), out, "device f0 + int16 new pair",
                      upload_dtype="int16")
    finally:
        knn.f0_method = "fast"

    phase_original(src, ref, out, run, dev)

    wknn = KnnSvc.random_init("wavlm_only", seed=0, device=dev)
    with OptimizerSteps() as wsteps:
        w_times = [run(src, ref, POST_OPT, model=wknn)[0] for _ in range(2)]
    log(f"[post_opt] wavlm_only convert_pair({POST_OPT!r}) s: first {w_times[0]:.4f}, "
        f"second {w_times[1]:.4f}; launches (attention, concat) "
        f"({LAUNCHES_PER_PAIR}, 1) each; optimizer steps {wsteps.steps}")


    phase_profile(knn, *new_pair("traced"), out, "new pair (f0 extracted)")
    phase_profile(knn, src, ref, out, "repeat conversion (f0 cached)")
    phase_profile(knn, src, ref, out, f"mix {POST_OPT} repeat", POST_OPT)
    phase_profile(knn, *new_pair("po_traced"), out, f"mix {POST_OPT} new pair (f0 extracted)",
                  POST_OPT)
    phase_profile(wknn, src, ref, out, f"wavlm_only {POST_OPT} repeat", POST_OPT)


def phase_original(src: str, ref: str, out: str, run, dev) -> None:
    """One wavlm_only_original conversion on the card (plain HiFi-GAN v1 on
    the matched features, no f0): a finite, non-silent waveform; then its
    vocoder against the same vocoder on the CPU, on the same features."""
    import copy

    import numpy as np
    import torch

    from knnsvc_torch.hub import KnnSvc

    oknn = KnnSvc.random_init("wavlm_only_original", seed=0, device=dev)
    dt, launches, _ = run(src, ref, model=oknn)
    wav = oknn.convert_waveform(src, ref)
    torch.cuda.synchronize()
    peak = float(wav.abs().max())
    if not (bool(torch.isfinite(wav).all()) and peak > 0 and wav.dtype == torch.float32):
        fail(f"wavlm_only_original: finite {bool(torch.isfinite(wav).all())}, peak {peak}")
    feats = torch.from_numpy(np.random.default_rng(7).standard_normal(
        (1, 200, oknn.h.hubert_dim)).astype(np.float32))
    cpu_voc = copy.deepcopy(oknn.vocoder).to("cpu")
    with torch.no_grad():
        a = cpu_voc(feats).numpy()
        b = oknn.vocoder(feats.to(dev)).cpu().numpy()
    rel = float(np.abs(a - b).max() / max(float(np.abs(a).max()), 1e-30))
    log(f"[original] wavlm_only_original convert_pair in {dt:.4f} s, launches (attention, "
        f"concat, viterbi) {launches}; pre-quantize peak {peak:.3e}, finite; vocoder cuda vs "
        f"cpu on 200 frames of the same features: max |d| / max |cpu| = {rel:.3e} "
        f"(tol {WAV_REL_TOL})")
    if not rel <= WAV_REL_TOL:
        fail(f"wavlm_only_original vocoder differs between cuda and cpu: rel {rel}")
    del oknn, cpu_voc


MP3_FIXTURES = os.path.join("tests", "torch_data", "mp3_fixtures.json")
MP3_DECODE_RUNS = 5                     # timed decodes of each fixture
MP3_PAIR_RUNS = 3                       # no_post_opt mp3 pairs and WAV twins, in turns


def write_wav16(path: str, pcm, sr: int) -> None:
    """A 16-bit PCM WAV of int16 (channels, T): load_audio reads it back as
    pcm / 32768, the floats decode_mp3 gives for the same samples."""
    import struct

    import numpy as np

    body = np.ascontiguousarray(pcm.T).astype("<i2").tobytes()
    ch = pcm.shape[0]
    with open(path, "wb") as f:
        f.write(b"RIFF" + struct.pack("<I", 36 + len(body)) + b"WAVE" + b"fmt "
                + struct.pack("<IHHIIHH", 16, 1, ch, sr, sr * ch * 2, ch * 2, 16)
                + b"data" + struct.pack("<I", len(body)) + body)


def phase_mp3(root: str, knn, repo: str) -> None:
    """[mp3] The committed mp3 fixtures (tools/make_mp3_fixtures.py: a 30-s
    16-kHz mono source, a 30-s 44.1-kHz joint-stereo target with a LAME tag)
    decoded by the port's decoder (built from csrc/mp3dec.cc), their PCM
    digests held to the ones recorded where they were made;
    convert_pair(fast=True) on the mp3 pair without and with post_opt,
    counted (12 attention launches, 1 concat launch with post_opt) and
    bit-equal to the same call on 16-bit WAVs of the decode; one fast
    bulk_convert over speaker folders that mix .mp3 and .wav, bit-equal to
    the all-WAV twin; where libmp3lame loads, an .mp3 output decoded back."""
    import glob
    import hashlib

    import numpy as np
    import torch

    from knnsvc_torch.io.audio import load_audio
    from knnsvc_torch.io.mp3 import decode_mp3
    from knnsvc_torch.ops.attention import gated_bias_attention_diag
    from knnsvc_torch.ops.build import build_host_library
    from knnsvc_torch.ops.concat_scan import concat_cost_pair

    t_phase = time.perf_counter()
    t0 = time.perf_counter()
    lib = build_host_library("mp3dec")
    log(f"[mp3] decoder {lib.name} ready in {time.perf_counter() - t0:.2f} s (c++ -O2, "
        f"built at first use)")
    with open(os.path.join(repo, MP3_FIXTURES)) as f:
        fixtures = json.load(f)
    mp3_dir, wav_dir = os.path.join(root, "mp3"), os.path.join(root, "mp3_wav")
    os.makedirs(mp3_dir)
    os.makedirs(wav_dir)
    paths = {}
    for key, rec in fixtures.items():
        src = os.path.join(repo, rec["file"])
        x, sr = decode_mp3(src, normalize=False)
        pcm = x.astype(np.int16)
        times = []
        for _ in range(MP3_DECODE_RUNS):
            t0 = time.perf_counter()
            decode_mp3(src)
            times.append(time.perf_counter() - t0)
        digest = hashlib.sha256(pcm.tobytes()).hexdigest()
        if (sr, pcm.shape[0], pcm.shape[1], digest) != (
                rec["sample_rate"], rec["channels"], rec["samples"], rec["pcm_sha256"]):
            fail(f"mp3 {rec['file']}: {sr} Hz x {pcm.shape[0]}, {pcm.shape[1]} samples, PCM "
                 f"sha256 {digest}; recorded {rec}")
        med = statistics.median(times)
        log(f"[mp3] decode {rec['file']} ({sr} Hz x {pcm.shape[0]}, "
            f"{pcm.shape[1] / sr:.2f} s): host median {1e3 * med:.1f} ms, min "
            f"{1e3 * min(times):.1f} ms ({MP3_DECODE_RUNS} runs), {pcm.shape[1] / sr / med:.0f} "
            f"audio-s/s; PCM sha256 equal to the recorded one")
        paths[key] = shutil.copy(src, os.path.join(mp3_dir, f"{key}.mp3"))
        write_wav16(os.path.join(wav_dir, f"{key}.wav"), pcm, sr)

    def pair(d, ext, post_opt):
        """convert_pair with the kernels' counts set to 0 just before and
        read just after."""
        gated_bias_attention_diag.launches = 0
        concat_cost_pair.launches = 0
        t0 = time.perf_counter()
        out = knn.convert_pair(os.path.join(d, f"src.{ext}"), os.path.join(d, f"ref.{ext}"),
                               fast=True, post_opt=post_opt,
                               output_path=os.path.join(d, f"out_{post_opt}.wav"))
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        launches = (gated_bias_attention_diag.launches, concat_cost_pair.launches)
        want = (LAUNCHES_PER_PAIR, 0 if post_opt == "no_post_opt" else 1)
        if launches != want:
            fail(f"convert_pair on the {ext} pair ({post_opt}) launched (attention, concat) "
                 f"{launches} times, expected {want}")
        y, sr = load_audio(out)
        if sr != 16000 or not np.isfinite(y).all():
            fail(f"convert_pair on the {ext} pair ({post_opt}): sr {sr}, finite "
                 f"{bool(np.isfinite(y).all())}")
        return dt, launches, y

    # the mp3 pair as a new pair: its f0 is extracted (and cached beside it);
    # the same tracks then serve the WAV twins
    new_s, launches, first = pair(mp3_dir, "mp3", "no_post_opt")
    for side in glob.glob(os.path.join(mp3_dir, "*_f0*.npy")):
        shutil.copy(side, wav_dir)
    log(f"[mp3] convert_pair(fast=True) on the mp3 pair as a new pair (f0 extracted) in "
        f"{new_s:.3f} s; launches (attention, concat) {launches}")
    for post_opt, runs in (("no_post_opt", MP3_PAIR_RUNS), (POST_OPT, 1)):
        times, outs = {"mp3": [], "wav": []}, {}
        for _ in range(runs):  # in turns, f0 cached
            for d, ext in ((mp3_dir, "mp3"), (wav_dir, "wav")):
                dt, launches, outs[ext] = pair(d, ext, post_opt)
                times[ext].append(dt)
        got, want = outs["mp3"], outs["wav"]
        if got.shape != want.shape or not np.array_equal(got, want) or (
                post_opt == "no_post_opt" and not np.array_equal(first, want)):
            fail(f"convert_pair on the mp3 pair ({post_opt}): waveform {got.shape} differs "
                 f"from the WAV twins' {want.shape}")
        log(f"[mp3] convert_pair(fast=True, {post_opt!r}), f0 cached, s ({runs} in turns): "
            f"mp3 pair {', '.join(f'{t:.4f}' for t in times['mp3'])} (median "
            f"{statistics.median(times['mp3']):.4f}), WAV twins "
            f"{', '.join(f'{t:.4f}' for t in times['wav'])} (median "
            f"{statistics.median(times['wav']):.4f}); launches (attention, concat) "
            f"{launches} each; waveform bit-equal to the WAV twins'")

    # speaker folders that mix .mp3 and .wav, and their all-WAV twin
    trees = {}
    for tag, src_dir, ext in (("mixed", mp3_dir, "mp3"), ("wav", wav_dir, "wav")):
        data = os.path.join(root, f"mp3_bulk_{tag}")
        for key, (name, hz, seed) in zip(("src", "ref"), BULK_SINGERS):
            os.makedirs(os.path.join(data, name))
            shutil.copy(os.path.join(src_dir, f"{key}.{ext}"), os.path.join(data, name))
            for side in glob.glob(os.path.join(src_dir, f"{key}_f0*.npy")):
                shutil.copy(side, os.path.join(data, name))
            wav, f0 = sung_wav(BULK_SECONDS[0], hz, seed)
            save_path = os.path.join(data, name, f"{name}_0.wav")
            write_wav16(save_path, np.round(wav * 32767).astype(np.int16)[None], 16000)
            np.save(os.path.splitext(save_path)[0] + "_f0.npy", f0)
        out_dir = os.path.join(root, f"mp3_bulk_out_{tag}")
        gated_bias_attention_diag.launches = 0
        t0 = time.perf_counter()
        written = knn.bulk_convert(data, data, out_dir, fast=True)
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        if len(written) != 4 or gated_bias_attention_diag.launches == 0:
            fail(f"bulk_convert over the {tag} folders wrote {len(written)} files (want 4) "
                 f"with {gated_bias_attention_diag.launches} attention launches")
        trees[tag] = read_tree(out_dir)
        log(f"[mp3] bulk_convert(fast=True) over 2 singers x (one 30-s {ext}, one "
            f"{BULK_SECONDS[0]:.0f}-s wav): {len(written)} conversions in {dt:.3f} s, "
            f"{gated_bias_attention_diag.launches} attention launches")
    if trees["mixed"].keys() != trees["wav"].keys() or any(
            not np.array_equal(trees["mixed"][k], trees["wav"][k]) for k in trees["wav"]):
        fail("bulk_convert over the mixed mp3/wav folders differs from the all-WAV twin")
    log("[mp3] bulk_convert outputs bit-equal to the all-WAV twin's")

    try:
        from knnsvc_torch.io.mp3 import _load_lame

        _load_lame()
    except NotImplementedError:
        log("[mp3] libmp3lame is not on this host: no .mp3 output written")
    else:
        out = knn.convert_pair(paths["src"], paths["ref"], fast=True,
                               output_path=os.path.join(root, "converted.mp3"))
        y, sr = decode_mp3(out)
        log(f"[mp3] convert_pair wrote {out}, decoded back: {sr} Hz, {y.shape}")
    log(f"[mp3] phase in {time.perf_counter() - t_phase:.1f} s")


# orbax checkpoints (knnsvc_torch/io/orbax_ckpt.py)
ORBAX_FIXTURE = os.path.join("tests", "torch_data", "orbax_tiny")
ORBAX_FIXTURES = os.path.join("tests", "torch_data", "orbax_fixtures.json")
ORBAX_RESUME_DIR = "orbax_resume"        # (c)'s checkpoint, which (e) resumes
ORBAX_DECODE_PASSES = 20                 # (b): the decoder's rate on orbax's frames


def path_leaves(tree, prefix: str = "") -> list:
    """[(dotted path, leaf)] of a tree's array leaves (None leaves and empty
    dicts have none), in key order."""
    out = []
    if isinstance(tree, dict):
        for k in sorted(tree):
            out += path_leaves(tree[k], f"{prefix}{k}.")
    elif isinstance(tree, (list, tuple)):
        for i, sub in enumerate(tree):
            out += path_leaves(sub, f"{prefix}{i}.")
    elif tree is not None:
        out.append((prefix[:-1], tree))
    return out


def leaf_digests(tree) -> dict:
    """{dotted path: {dtype, shape, sha256}} of a tree's array leaves, as
    tools/make_orbax_fixtures.py records them."""
    import hashlib

    import numpy as np

    out = {}
    for path, leaf in path_leaves(tree):
        a = np.ascontiguousarray(np.asarray(leaf))
        out[path] = {"dtype": str(a.dtype), "shape": list(a.shape),
                     "sha256": hashlib.sha256(a.tobytes()).hexdigest()}
    return out


def trees_bit_equal(a, b) -> bool:
    """The same array leaves at the same paths, of the same dtypes, shapes
    and bytes."""
    import numpy as np

    la, lb = path_leaves(a), path_leaves(b)
    if [p for p, _ in la] != [p for p, _ in lb]:
        return False
    for (_, x), (_, y) in zip(la, lb):
        x, y = np.ascontiguousarray(np.asarray(x)), np.ascontiguousarray(np.asarray(y))
        if x.dtype != y.dtype or x.shape != y.shape or x.tobytes() != y.tobytes():
            return False
    return True


def phase_orbax(root: str, repo: str, dev) -> None:
    """[orbax] Orbax checkpoints without orbax (io/orbax_ckpt.py, its codecs
    in csrc/orbax_io.cc):
    (a) the codec library built with the host compiler, timed;
    (b) the committed JAX-written checkpoint (tools/make_orbax_fixtures.py:
        a tiny TrainState and a multi-block leaf, written by the JAX
        package's save_train_state) restored on this host, every leaf's
        SHA-256 equal to the one the JAX package's restore gave; and the
        zstd decoder's rate on its level-1 frames, in memory;
    (d) a directory holding only orbax/: the full-width mix TrainState
        (init_train_state at HiFiGANConfig()) written by save_train_state,
        served by KnnSvc.load(dir, "mix") through convert_pair(fast=True,
        post_opt_0.2) on a 30-s pair (12 attention launches, 1 concat
        launch), its waveform bit-equal to the same generator loaded from a
        .knnsvc.pkl.
    (c) and (e) run in the training phase, on its real-config TrainState."""
    import numpy as np
    import torch

    from knnsvc_torch.config import HiFiGANConfig, ModelFamily, WavLMConfig
    from knnsvc_torch.hub import KnnSvc
    from knnsvc_torch.io.checkpoints import save_params
    from knnsvc_torch.io import ocdbt, zarr2
    from knnsvc_torch.io.jax_params import train_state_to_numpy
    from knnsvc_torch.io.orbax_ckpt import restore_train_state, save_train_state
    from knnsvc_torch.models.wavlm.model import init_wavlm_params
    from knnsvc_torch.ops.attention import gated_bias_attention_diag
    from knnsvc_torch.ops.build import build_host_library
    from knnsvc_torch.ops.concat_scan import concat_cost_pair
    from knnsvc_torch.train.trainer import init_train_state

    t_phase = time.perf_counter()
    # (a)
    t0 = time.perf_counter()
    lib = build_host_library("orbax_io")
    log(f"[orbax] (a) codecs {lib.name} ready in {time.perf_counter() - t0:.2f} s (c++ -O2, "
        f"built at first use)")
    # (b)
    with open(os.path.join(repo, ORBAX_FIXTURES)) as f:
        record = json.load(f)
    t0 = time.perf_counter()
    tree, step, epoch = restore_train_state(os.path.join(repo, ORBAX_FIXTURE))
    read_s = time.perf_counter() - t0
    digests = leaf_digests(tree)
    n_bytes = sum(np.asarray(v).nbytes for _, v in path_leaves(tree))
    if (step, epoch) != (record["step"], record["epoch"]) or digests != record["leaves"]:
        bad = sorted(k for k in record["leaves"] if digests.get(k) != record["leaves"][k])
        fail(f"orbax fixture: step {step}, epoch {epoch} (recorded {record['step']}, "
             f"{record['epoch']}); {len(bad)} leaves differ, e.g. {bad[:3]}; "
             f"{len(digests)} leaves read, {len(record['leaves'])} recorded")
    log(f"[orbax] (b) the JAX-written fixture {ORBAX_FIXTURE} (step {step}, epoch {epoch}): "
        f"{len(digests)} array leaves, {n_bytes} bytes, restored in {read_s:.3f} s; every "
        f"leaf's SHA-256 equal to the JAX package's restore")
    # the decoder alone on orbax's own (entropy-coded, level-1) frames: every
    # chunk of the fixture, already in memory, decoded ORBAX_DECODE_PASSES times
    db = ocdbt.Database(os.path.join(repo, ORBAX_FIXTURE, str(step), "default"))
    frames = []
    for key in db.keys():
        if key.endswith(b"/.zarray"):
            meta = zarr2.parse_zarray(db.read(key))
            size = math.prod(meta["chunks"]) * (2 if meta["dtype"] == zarr2.BFLOAT16
                                                else np.dtype(meta["dtype"]).itemsize)
            name = key[: -len(b"/.zarray")]
            frames += [(db.read(k), np.empty(size, np.uint8)) for k in db.keys()
                       if k.startswith(name + b"/") and k != key]
    t0 = time.perf_counter()
    for _ in range(ORBAX_DECODE_PASSES):
        for frame, out in frames:
            ocdbt.zstd_decode_into(frame, out)
    decode_s = time.perf_counter() - t0
    coded, decoded = sum(len(f) for f, _ in frames), sum(o.nbytes for _, o in frames)
    log(f"[orbax] (b) the zstd decoder on the fixture's level-1 frames ({len(frames)} frames, "
        f"{coded} bytes coded, {decoded} decoded; in memory, one thread, "
        f"{ORBAX_DECODE_PASSES} passes): {decode_s:.3f} s = "
        f"{ORBAX_DECODE_PASSES * decoded / decode_s / 1e9:.3f} GB/s decoded")
    # (d) an orbax-only directory served, against its .knnsvc.pkl twin
    h = HiFiGANConfig()
    state = train_state_to_numpy(init_train_state(h.seed, h, ModelFamily.MIX, device="cpu"))
    serve_dir = os.path.join(root, "orbax_serve")
    t0 = time.perf_counter()
    save_train_state(os.path.join(serve_dir, "only", "orbax"), 0, state)
    write_s = time.perf_counter() - t0
    os.makedirs(os.path.join(serve_dir, "pkl"))
    save_params(os.path.join(serve_dir, "pkl", "g_mix_00000000.knnsvc.pkl"),
                {"generator": state["g_params"]})
    wavlm_pkl = os.path.join(serve_dir, "wavlm.knnsvc.pkl")
    save_params(wavlm_pkl, {"cfg": {}, "model": init_wavlm_params(
        WavLMConfig(), torch.Generator().manual_seed(0))})
    src, ref = write_pair(serve_dir, FULL_SECONDS, sidecars=True)
    t0 = time.perf_counter()
    served = KnnSvc.load(os.path.join(serve_dir, "only"), "mix", wavlm_ckpt=wavlm_pkl, device=dev)
    load_s = time.perf_counter() - t0
    twin = KnnSvc.load(os.path.join(serve_dir, "pkl"), "mix", wavlm_ckpt=wavlm_pkl, device=dev)
    gated_bias_attention_diag.launches = 0
    concat_cost_pair.launches = 0
    out = served.convert_pair(src, ref, fast=True, post_opt=POST_OPT,
                              output_path=os.path.join(serve_dir, "served.wav"))
    torch.cuda.synchronize()
    launches = (gated_bias_attention_diag.launches, concat_cost_pair.launches)
    if launches != (LAUNCHES_PER_PAIR, 1):
        fail(f"KnnSvc.load on an orbax-only directory: convert_pair launched (attention, "
             f"concat) {launches} times, expected ({LAUNCHES_PER_PAIR}, 1)")
    waves = [m.convert_waveform(src, ref, post_opt=POST_OPT).cpu().numpy() for m in (served, twin)]
    if not (np.isfinite(waves[0]).all() and np.abs(waves[0]).max() > 0
            and waves[0].tobytes() == waves[1].tobytes() and os.path.getsize(out) > 44):
        fail("the orbax-served model's waveform differs from its .knnsvc.pkl twin's")
    log(f"[orbax] (d) a full-width mix TrainState ({len(path_leaves(state))} array leaves) "
        f"written in {write_s:.2f} s; KnnSvc.load on the directory holding only orbax/ in "
        f"{load_s:.2f} s; convert_pair(fast=True, {POST_OPT!r}) on the {FULL_SECONDS:.0f}-s pair: "
        f"launches (attention, concat) {launches}; pre-quantize waveform {waves[0].shape}, peak "
        f"{np.abs(waves[0]).max():.3e}, bit-equal to the .knnsvc.pkl twin's")
    del served, twin, state
    shutil.rmtree(serve_dir, ignore_errors=True)
    log(f"[orbax] phase in {time.perf_counter() - t_phase:.1f} s")


def phase_orbax_train_state(root: str, state) -> None:
    """[orbax] (c) The training phase's real-config TrainState (HiFiGANConfig(),
    full MPD and MSD, after its warm steps: live moments) written with
    save_train_state and read back bit-equal, the bytes and GB/s of each
    way (host: to and from the card's machine's temporary directory)."""
    import numpy as np

    from knnsvc_torch.io.jax_params import train_state_to_numpy
    from knnsvc_torch.io.orbax_ckpt import restore_train_state, save_train_state

    t0 = time.perf_counter()
    tree = train_state_to_numpy(state)
    host_s = time.perf_counter() - t0
    leaves = path_leaves(tree)
    n_bytes = sum(np.asarray(v).nbytes for _, v in leaves)
    directory = os.path.join(root, ORBAX_RESUME_DIR, "orbax")
    step = int(state.steps)
    t0 = time.perf_counter()
    save_train_state(directory, step, tree)
    write_s = time.perf_counter() - t0
    on_disk = sum(os.path.getsize(os.path.join(d, n)) for d, _, names in os.walk(directory)
                  for n in names)
    t0 = time.perf_counter()
    back, got_step, epoch = restore_train_state(directory)
    read_s = time.perf_counter() - t0
    if not (got_step == step and epoch == 0 and trees_bit_equal(back, tree)):
        fail(f"orbax: the real-config TrainState does not read back bit-equal (step {got_step})")
    log(f"[orbax] (c) the real-config TrainState at step {step}: {len(leaves)} array leaves, "
        f"{n_bytes} bytes ({n_bytes / 1e9:.3f} GB; {on_disk} on disk), taken off the card in "
        f"{host_s:.2f} s; save_train_state {write_s:.2f} s = {n_bytes / write_s / 1e9:.2f} GB/s, "
        f"restore_train_state {read_s:.2f} s = {n_bytes / read_s / 1e9:.2f} GB/s; bit-equal")


def phase_orbax_resume(root: str, h, roots_kw: dict, dev) -> None:
    """[orbax] (e) train(..., resume_from=, checkpoint_backend='orbax') from
    (c)'s directory at the real config: the restored state (parameters,
    moments, AdamW step counts, learning rates, steps) bit-equal to what was
    written, then one step with finite metrics."""
    import numpy as np

    from knnsvc_torch.io.jax_params import train_state_to_numpy
    from knnsvc_torch.io.orbax_ckpt import restore_train_state
    from knnsvc_torch.train.loop import train

    resume = os.path.join(root, ORBAX_RESUME_DIR)
    written, step, _ = restore_train_state(os.path.join(resume, "orbax"))
    kw = dict(training_epochs=1000, validation_interval=1000, summary_interval=1,
              stdout_interval=1000, device=dev, resume_from=resume,
              checkpoint_backend="orbax", **roots_kw)
    t0 = time.perf_counter()
    state = train(h, checkpoint_path=os.path.join(root, "orbax_run0"), max_steps=step, **kw)
    restore_s = time.perf_counter() - t0
    if not trees_bit_equal(train_state_to_numpy(state), written):
        fail("train(resume_from=, checkpoint_backend='orbax'): the restored state differs from "
             "the one written")
    del state
    t0 = time.perf_counter()
    state = train(h, checkpoint_path=os.path.join(root, "orbax_run1"), max_steps=step + 1, **kw)
    step_s = time.perf_counter() - t0
    with open(os.path.join(root, "orbax_run1", "logs", "train_log.jsonl")) as fh:
        logged = [json.loads(line) for line in fh]
    metrics = [s for s in logged if "loss_gen_total" in s]
    if not (len(metrics) == 1 and metrics[0]["step"] == step + 1 and state.steps == step + 1
            and all(np.isfinite(v) for k, v in metrics[0].items() if k != "step")):
        fail(f"train() resumed from orbax: logged {metrics}, state.steps {state.steps}")
    log(f"[orbax] (e) train(resume_from=, checkpoint_backend='orbax') from step {step}: the "
        f"restored state bit-equal to the written one (parameters, moments, AdamW counts, "
        f"learning rates, steps; train() call {restore_s:.2f} s), then step {step + 1} in a "
        f"{step_s:.2f}-s train() call: {json.dumps({k: v for k, v in metrics[0].items()})}")
    del state


def chunks_of(n_samples: int) -> int:
    """30-s encoder chunks of a waveform (a last one of <= 320 samples is
    dropped, ref ddsp_prematch_dataset.py:279)."""
    return sum(1 for start in range(0, n_samples, 480_000) if n_samples - start > 320)


def write_bulk_dataset(root: str):
    """BULK_SINGERS x BULK_SECONDS sung utterances with f0 sidecars under
    root/<singer>/. -> (dataset root, chunks per singer, audio seconds)."""
    from knnsvc_torch.dsp.f0 import save_f0_sidecar
    from knnsvc_torch.io.audio import save_audio

    data = os.path.join(root, "bulk")
    chunks = {}
    for name, hz, seed in BULK_SINGERS:
        os.makedirs(os.path.join(data, name))
        chunks[name] = 0
        for i, seconds in enumerate(BULK_SECONDS):
            wav, f0 = sung_wav(seconds, hz * (1 + 0.05 * i), seed + i)
            path = os.path.join(data, name, f"{name}_{i}.wav")
            save_audio(path, wav, 16000)
            save_f0_sidecar(path, f0)
            chunks[name] += chunks_of(len(wav))
    return data, chunks, len(BULK_SINGERS) * sum(BULK_SECONDS)


class PeakSpy:
    """Records the largest |x| handed to match.serve.quantize_int16 while
    open: the fast loops' waveforms before their int16 quantize; with
    keep=True, the waveforms themselves (on the host)."""

    def __init__(self, keep: bool = False):
        self.keep = keep
        self.waves = []

    def __enter__(self):
        from knnsvc_torch.match import serve

        self.serve, self.real, self.peak = serve, serve.quantize_int16, 0.0

        def spy(wav):
            self.peak = max(self.peak, float(wav.abs().max()))
            if self.keep:
                self.waves.append(wav.detach().float().cpu().numpy())
            return self.real(wav)

        serve.quantize_int16 = spy
        return self

    def __exit__(self, *exc):
        self.serve.quantize_int16 = self.real


def read_tree(out_dir: str) -> dict:
    import numpy as np

    from knnsvc_torch.io.audio import load_audio

    tree = {}
    for d, _, files in os.walk(out_dir):
        for f in files:
            y, sr = load_audio(os.path.join(d, f))
            if sr != 16000 or not np.isfinite(y).all():
                fail(f"bulk output {f}: sr {sr}, finite {bool(np.isfinite(y).all())}")
            tree[os.path.relpath(os.path.join(d, f), out_dir)] = y[0]
    return tree


def phase_bulk(root: str, knn, records, dev):
    import numpy as np
    import torch

    from knnsvc_torch.io.audio import load_audio
    from knnsvc_torch.match.concat_cost import knn_with_concat_cost_pair
    from knnsvc_torch.match.distance import cosine_distance
    from knnsvc_torch.match.f0_logic import (shift_f0_to_target_register,
                                             sort_by_f0_compatibility)
    from knnsvc_torch.match.knn import knn_topk
    from knnsvc_torch.match.quantized_pool import (int8_dot, knn_topk_quantized,
                                                   quantize_pool, quantize_rows)
    from knnsvc_torch.ops.attention import gated_bias_attention_diag
    from knnsvc_torch.ops.concat_scan import concat_cost_pair

    t_phase = time.perf_counter()

    def counted(fn):
        """fn() with both kernels' counts set to 0 just before and read just
        after: (wall s, result, (attention, concat) launches)."""
        gated_bias_attention_diag.launches = 0
        concat_cost_pair.launches = 0
        t0 = time.perf_counter()
        result = fn()
        torch.cuda.synchronize()
        return (time.perf_counter() - t0, result,
                (gated_bias_attention_diag.launches, concat_cost_pair.launches))

    # the host-pool pair against the fast pair, both on the f0 sidecars
    pair_dir = os.path.join(root, "pair6")
    os.makedirs(pair_dir)
    src, ref = write_pair(pair_dir, FULL_SECONDS, sidecars=True)
    outs = {}
    for fast in (False, True):
        times = []
        for i in range(1 + (HOST_PAIR_RUNS if not fast else 1)):
            out = os.path.join(pair_dir, f"fast_{fast}.wav")
            dt, _, launches = counted(lambda: knn.convert_pair(src, ref, fast=fast,
                                                               output_path=out))
            if launches != (LAUNCHES_PER_PAIR, 0):
                fail(f"convert_pair(fast={fast}) launched (attention, concat) {launches}, "
                     f"expected ({LAUNCHES_PER_PAIR}, 0)")
            times.append(dt)
        outs[fast] = load_audio(out)[0][0]
        log(f"[host_pool] convert_pair(fast={fast}) on a {FULL_SECONDS:.0f}-s pair with f0 "
            f"sidecars: first {times[0]:.4f} s, warm {', '.join(f'{t:.4f}' for t in times[1:])} s; "
            f"attention launches {LAUNCHES_PER_PAIR} each")
    host, fast_out = outs[False], outs[True]
    diff = float(np.abs(host - fast_out).max()) if host.shape == fast_out.shape else np.inf
    log(f"[host_pool] host-pool vs fast waveform {host.shape}: max |diff| {diff:.3e} (tol "
        f"{HOST_VS_FAST_ATOL:.3e}), host peak {float(np.abs(host).max()):.3e}, finite "
        f"{bool(np.isfinite(host).all())}")
    if not (diff <= HOST_VS_FAST_ATOL and np.isfinite(host).all() and np.abs(host).max() > 0):
        fail(f"host-pool and fast pair conversions differ: {diff}")

    # the three bulk loops over the same dataset root (self pairs skipped)
    data, chunks, audio_s = write_bulk_dataset(root)
    n_conv = len(BULK_SINGERS) * len(BULK_SECONDS) * (len(BULK_SINGERS) - 1)
    # host loop: each singer's pool built as a source and as a target; fast
    # loops: each target pool once, each source utterance once
    want_attention = 6 * 2 * sum(chunks.values())
    trees = {}
    for name, kwargs in BULK_LOOPS:
        runs = []
        for p in range(2):
            out_dir = os.path.join(root, f"bulk_{name}_{p}")
            with PeakSpy() as spy:
                dt, written, launches = counted(
                    lambda: knn.bulk_convert(data, data, out_dir, **kwargs))
            runs.append(dt)
        tree = read_tree(out_dir)
        peak = (max(float(np.abs(y).max()) for y in tree.values()) if name == "host"
                else spy.peak)
        log(f"[bulk] {name}: {len(written)} conversions of {audio_s:.0f} s of audio; first pass "
            f"{runs[0]:.3f} s, warm pass {runs[1]:.3f} s = {audio_s / runs[1]:.2f} audio-s/s; "
            f"launches (attention, concat) {launches}, expected ({want_attention}, 0); "
            f"pre-quantize peak {peak:.3e}")
        if not (len(written) == len(tree) == n_conv and launches == (want_attention, 0)
                and peak > 0):
            fail(f"bulk loop {name}: {len(written)} written, {len(tree)} files, launches "
                 f"{launches}, peak {peak}")
        trees[name] = tree
    records["gated_bias_attention_diag"]["bulk_launches"] = want_attention
    if not (set(trees["host"]) == set(trees["fast"]) == set(trees["fast_batch2"])):
        fail("the bulk loops wrote different files")
    diff = max(float(np.abs(trees["fast"][k] - trees["fast_batch2"][k]).max())
               for k in trees["fast"])
    host_diff = max(float(np.abs(trees["fast"][k] - trees["host"][k]).max()) for k in trees["fast"])
    log(f"[bulk] fast vs fast_batch2: max |diff| {diff:.3e} (tol one int16 step "
        f"{INT16_STEP:.3e}); fast vs host loop (other f0 path and pad handling, not "
        f"checked): {host_diff:.3e}")
    if not diff <= INT16_STEP:
        fail(f"the fast and batched bulk loops differ by {diff}")
    traced_dir = os.path.join(root, "bulk_traced")
    phase_bulk_profile(lambda: knn.bulk_convert(data, data, traced_dir, batch_vocode=True),
                       "host loop, batch_vocode")

    # post_opt_0.2 through the fast bulk loop: one concat launch per conversion
    dt, written, launches = counted(lambda: knn.bulk_convert(
        data, data, os.path.join(root, "bulk_po"), fast=True, post_opt=POST_OPT))
    log(f"[bulk] fast {POST_OPT}: {len(written)} conversions in {dt:.3f} s = "
        f"{audio_s / dt:.2f} audio-s/s; launches (attention, concat) {launches}")
    if launches != (want_attention, n_conv) or len(written) != n_conv:
        fail(f"fast {POST_OPT} bulk loop launched {launches}, expected "
             f"({want_attention}, {n_conv})")
    records["concat_cost_pair"]["bulk_launches"] = launches[1]

    # the concat kernel at a bulk target pool, on the longest query (two
    # chunks) and on a bucket-padded one (edge-replicated frames, zero f0)
    names = [n for n, _, _ in BULK_SINGERS]
    pool = knn._device_pool_for_files(
        sorted(os.path.join(data, names[1], f) for f in os.listdir(os.path.join(data, names[1]))
               if f.endswith(".wav")))
    queries = knn._HostQueryCache(knn)
    for i in (len(BULK_SECONDS) - 1, 1):
        m, qf0, T = knn._bucket_pad_query(
            *queries.get(os.path.join(data, names[0], f"{names[0]}_{i}.wav")))
        q, qf0 = torch.from_numpy(m).to(dev), torch.from_numpy(qf0).to(dev)
        with torch.no_grad():
            nearest, _ = knn_topk(q, pool.matching, k=32)
            shifted = shift_f0_to_target_register(qf0, pool.f0)
            pitched = sort_by_f0_compatibility(shifted, pool.f0, nearest)[:, :4]
            args = (nearest[:, :4], pitched, q, pool.matching, shifted, pool.f0)
            got = concat_cost_pair(*args)
            want = knn_with_concat_cost_pair(*args)
        torch.cuda.synchronize()
        shares = [float((g == w).all(dim=1).float().mean()) for g, w in zip(got, want)]
        Tb, P, D = q.shape[0], pool.matching.shape[0], q.shape[1]
        timing = ""
        if i == len(BULK_SECONDS) - 1:
            bulk_ms = cuda_ms(lambda: concat_cost_pair(*args), iters=5, warmup=1)
            bound_ms, bound_by = concat_bound_ms(Tb, P, D, lanes=2, k=4)
            timing = (f"; kernel {bulk_ms:.4f} ms ({1e3 * bulk_ms / (Tb - 1):.3f} us per "
                      f"frame), bound {bound_ms:.4f} ms ({bound_by})")
            records["concat_cost_pair"].update(bulk_shape=[Tb, P, D], bulk_ms=bulk_ms,
                                               bulk_bound_ms=bound_ms)
        log(f"[bulk] concat_cost_pair at a bulk target pool ({Tb} query frames of which {T} "
            f"real, P={P}, D={D}) k=4: frames equal to the plain version, unpitched "
            f"{shares[0]:.2%}, pitched {shares[1]:.2%}{timing}")
        if not (P > 1500 and Tb % 250 == 0 and min(shares) == 1.0):
            fail(f"concat_cost_pair at the bulk shape: P={P}, T={Tb}, equal shares {shares}")
    if T == Tb:
        fail("the concat check at the bulk shape saw no bucket-padded query")
    del pool, q, nearest, args, got, want

    # the int8 kNN, card against CPU; then one int8 host pair with post_opt
    Q, P, D = INT8_SHAPE
    rng = np.random.default_rng(8)
    pool_np = rng.standard_normal((P, D)).astype(np.float32)
    query = torch.from_numpy(rng.standard_normal((Q, D)).astype(np.float32))
    cpu_pool, card_pool = quantize_pool(pool_np, device="cpu"), quantize_pool(pool_np, dev)
    q8, _ = quantize_rows(query)
    q8_card, _ = quantize_rows(query.to(dev))
    dots_equal = bool(torch.equal(int8_dot(q8_card, card_pool.values).cpu(),
                                  int8_dot(q8, cpu_pool.values)))
    got, _ = knn_topk_quantized(query.to(dev), card_pool)
    want, _ = knn_topk_quantized(query, cpu_pool)
    idx_equal = bool(torch.equal(got.cpu(), want)) and bool(torch.equal(q8_card.cpu(), q8))
    qd, pool_d = query.to(dev), torch.from_numpy(pool_np).to(dev)
    int8_ms = cuda_ms(lambda: knn_topk_quantized(qd, card_pool), iters=5)
    fp32_ms = cuda_ms(lambda: knn_topk(qd, pool_d), iters=5)
    log(f"[int8] knn_topk_quantized {INT8_SHAPE} card vs cpu: int32 dots equal {dots_equal}, "
        f"query bytes and indices equal {idx_equal}; card {int8_ms:.4f} ms (torch._int_mm) "
        f"against the fp32 knn_topk's {fp32_ms:.4f} ms")
    if not (dots_equal and idx_equal):
        fail("the int8 kNN differs between card and cpu")
    del card_pool, pool_d
    dt, path, launches = counted(lambda: knn.convert_pair(
        src, ref, matcher="int8", post_opt=POST_OPT,
        output_path=os.path.join(pair_dir, "int8.wav")))
    y = load_audio(path)[0][0]
    log(f"[int8] convert_pair(fast=False, matcher='int8', post_opt={POST_OPT!r}) in {dt:.3f} s; "
        f"launches (attention, concat) {launches}; peak {float(np.abs(y).max()):.3e}, finite "
        f"{bool(np.isfinite(y).all())}")
    if not (launches == (LAUNCHES_PER_PAIR, 2) and np.isfinite(y).all() and np.abs(y).max() > 0):
        fail(f"int8 host pair: launches {launches}, peak {float(np.abs(y).max())}")

    # knn_topk at an hour of target: its stable full sort against torch.topk
    Q, P, D = KNN_HOUR
    gen = torch.Generator(device=dev).manual_seed(9)
    hour = torch.randn(P, D, device=dev, generator=gen)
    qh = torch.randn(Q, D, device=dev, generator=gen)
    q_chunk = max(1, (64 * 1024 * 1024) // P)
    dists = cosine_distance(qh[:q_chunk], hour)
    sort_ms = cuda_ms(lambda: torch.sort(dists, dim=1, stable=True)[1][:, :32], iters=5)
    topk_ms = cuda_ms(lambda: torch.topk(dists, 32, dim=1, largest=False), iters=5)
    dist_ms = cuda_ms(lambda: cosine_distance(qh[:q_chunk], hour), iters=5)
    same = float((torch.sort(dists, dim=1, stable=True)[1][:, :32]
                  == torch.topk(dists, 32, dim=1, largest=False)[1]).all(dim=1).float().mean())
    del dists
    knn_ms = cuda_ms(lambda: knn_topk(qh, hour), iters=3, warmup=1)
    n_tiles = -(-Q // q_chunk)
    log(f"[knn] knn_topk {KNN_HOUR} (an hour of target; {n_tiles} tiles of {q_chunk} query "
        f"rows): {knn_ms:.3f} ms; per tile: distances {dist_ms:.3f} ms, stable sort + cut "
        f"{sort_ms:.3f} ms, torch.topk {topk_ms:.3f} ms on the same distances (same top-32 on "
        f"{same:.2%} of rows)")
    del hour, qh
    log(f"[bulk] phase 6 in {time.perf_counter() - t_phase:.1f} s")
    return data, want_attention, audio_s, n_conv


class PickSpy:
    """Records, while open, the concat-cost picks of the streaming match:
    the (Ts, 2, k) output of both entries as match/pipeline calls them."""

    NAMES = ("concat_cost_pair", "concat_cost_pair_stream")

    def __enter__(self):
        import torch

        from knnsvc_torch.match import pipeline

        self.pipeline, self.picks = pipeline, []
        self.real = {name: getattr(pipeline, name) for name in self.NAMES}
        for name, fn in self.real.items():
            def spy(*args, _fn=fn, **kwargs):
                out = _fn(*args, **kwargs)
                self.picks.append(torch.stack([out[0], out[1]], dim=1).cpu())
                return out
            setattr(pipeline, name, spy)
        return self

    def __exit__(self, *exc):
        for name, fn in self.real.items():
            setattr(self.pipeline, name, fn)


def int16_codes(x):
    import numpy as np

    return np.round(np.asarray(x, np.float64) * 32768).astype(np.int64)


def phase_stream_slice(root: str, gpu, cpu) -> None:
    """Streaming on a 4-s pair: one chunk covering the input is the fast
    pair path on the card bit for bit; and the stream on the card against
    the stream on the CPU (the same weights), windowed and cached, with
    post_opt: pre-quantize waveforms within WAV_REL_TOL of the peak, the
    concat-cost picks equal on PICK_SHARE_MIN of the frames."""
    import numpy as np
    import torch

    from knnsvc_torch.io.audio import load_audio

    t0 = time.perf_counter()
    sdir = os.path.join(root, "stream_slice")
    os.makedirs(sdir)
    src, ref = write_pair(sdir, SLICE_SECONDS, sidecars=False)
    for post_opt in ("no_post_opt", POST_OPT):
        out = gpu.convert_pair(src, ref, fast=True, post_opt=post_opt,
                               output_path=os.path.join(sdir, "pair.wav"))
        want = int16_codes(load_audio(out)[0][0])
        chunks = list(gpu.stream_convert_chunks(src, ref, chunk_s=5.0, context_s=1.0,
                                                matcher="exact", post_opt=post_opt))
        equal = len(chunks) == 1 and np.array_equal(int16_codes(chunks[0]), want)
        log(f"[stream] one chunk (chunk_s=5.0) over the {SLICE_SECONDS:.0f}-s source, {post_opt}: "
            f"{len(chunks)} chunk, bit-identical to convert_pair(fast=True) on the card: {equal} "
            f"({int((want != 0).sum())} non-zero int16 codes)")
        if not equal:
            fail(f"a single-chunk stream differs from convert_pair(fast=True), {post_opt}")
    for encoder in ("windowed", "cached"):
        sides = []
        for model in (cpu, gpu):
            with PeakSpy(keep=True) as waves, PickSpy() as picks:
                chunks = list(model.stream_convert_chunks(src, ref, encoder=encoder,
                                                          **STREAM_SLICE))
            sides.append((np.concatenate(waves.waves), torch.cat(picks.picks), len(chunks)))
        (wa, pa, na), (wb, pb, nb) = sides
        peak = float(np.abs(wa).max())
        rel = (float(np.abs(wa - wb).max()) / max(peak, 1e-30) if wa.shape == wb.shape
               else np.inf)
        shares = ([float((pa[:, lane] == pb[:, lane]).all(dim=1).float().mean()) for lane in (0, 1)]
                  if pa.shape == pb.shape else [0.0, 0.0])
        log(f"[stream] {encoder} {STREAM_SLICE} card vs cpu: {nb} and {na} chunks; pre-quantize "
            f"waveform {wa.shape}: max |cpu| {peak:.3e}, max |cuda - cpu| / max |cpu| = "
            f"{rel:.3e} (tol {WAV_REL_TOL}); concat-cost picks equal on unpitched {shares[0]:.1%}, "
            f"pitched {shares[1]:.1%} of {pa.shape[0]} window frames (min {PICK_SHARE_MIN:.0%})")
        if not (na == nb and rel <= WAV_REL_TOL and min(shares) >= PICK_SHARE_MIN
                and np.isfinite(wb).all() and peak > 0):
            fail(f"the {encoder} stream differs between card and cpu: rel {rel}, picks {shares}")
    log(f"[stream] card vs cpu and single-chunk checks in {time.perf_counter() - t0:.1f} s")


def stream_counted(knn, src: str, ref: str, kw: dict):
    """stream_convert_chunks with the kernels' counts set to 0 before each
    chunk and read after it: (chunks, host seconds per chunk, (attention,
    concat, viterbi) launches per chunk). Chunk 0 includes the target pool's
    build; each chunk ends with its int16 download, a sync."""
    from knnsvc_torch.ops.attention import gated_bias_attention_diag
    from knnsvc_torch.ops.concat_scan import concat_cost_pair
    from knnsvc_torch.ops.viterbi import f0_viterbi

    gen = knn.stream_convert_chunks(src, ref, **kw)
    chunks, times, launches = [], [], []
    while True:
        gated_bias_attention_diag.launches = concat_cost_pair.launches = f0_viterbi.launches = 0
        t0 = time.perf_counter()
        chunk = next(gen, None)
        if chunk is None:
            return chunks, times, launches
        times.append(time.perf_counter() - t0)
        launches.append((gated_bias_attention_diag.launches, concat_cost_pair.launches,
                         f0_viterbi.launches))
        chunks.append(chunk)


def spread(times) -> str:
    import numpy as np

    return (f"median {1e3 * float(np.median(times)):.2f} ms, p90 "
            f"{1e3 * float(np.percentile(times, 90)):.2f} ms, max {1e3 * max(times):.2f} ms")


def phase_stream(root: str, knn, records, dev) -> None:
    """Streaming at full size: a 30-s source against a 30-s target at the
    CLI's defaults (2-s chunks, 1 s of context), STREAM_RUNS each once cold
    and once warm, with the launches of every chunk checked; the cached
    encoder's step and its attention; the live settings through
    stream_session, pushed 20 ms at a time, against the file stream; one
    traced live session split by the knnsvc.* spans."""
    import numpy as np
    import torch

    from knnsvc_torch import HOP_LENGTH
    from knnsvc_torch.match.pool import load_utterance

    t_phase = time.perf_counter()
    sdir = os.path.join(root, "stream")
    os.makedirs(sdir)
    src, ref = write_pair(sdir, FULL_SECONDS, sidecars=False)
    n_src = len(load_utterance(src))
    for tag, label, kw, f0_method in STREAM_RUNS:
        kw = {**STREAM_CLI, **kw}
        knn.f0_method = f0_method
        try:
            cold = stream_counted(knn, src, ref, kw)
            torch.cuda.reset_peak_memory_stats()
            t0 = time.perf_counter()
            warm = stream_counted(knn, src, ref, kw)
            wall = time.perf_counter() - t0
            peak = torch.cuda.max_memory_allocated()
        finally:
            knn.f0_method = "fast"
        per_chunk = (0 if kw.get("encoder") == "cached" else 6,
                     0 if kw.get("post_opt", "no_post_opt") == "no_post_opt" else 1,
                     1 if f0_method == "device" else 0)
        # chunk 0 also builds the target pool: 6 attention launches, device f0's Viterbi
        first = (per_chunk[0] + 6, per_chunk[1], per_chunk[2] * 2)
        for name, (chunks, times, launches) in (("cold", cold), ("warm", warm)):
            total = sum(len(c) for c in chunks)
            ok = (len(chunks) == STREAM_CHUNKS and abs(total - n_src) <= 2 * HOP_LENGTH
                  and launches[0] == first and all(n == per_chunk for n in launches[1:])
                  and all(np.isfinite(c).all() for c in chunks))
            if not ok:
                fail(f"stream ({tag}) {label}, {name}: {len(chunks)} chunks, {total} samples for "
                     f"{n_src}, launches (attention, concat, viterbi) per chunk {launches}, "
                     f"expected {first} then {per_chunk}")
        _, times, launches = warm
        log(f"[stream] ({tag}) {label}, {FULL_SECONDS:.0f} s at {STREAM_CLI}: {len(times)} "
            f"chunks; warm chunks 1-{len(times) - 1}: {spread(times[1:])} per 2-s chunk; first "
            f"chunk (target pool built) cold {1e3 * cold[1][0]:.2f} ms, warm "
            f"{1e3 * times[0]:.2f} ms; warm stream {wall:.3f} s = {FULL_SECONDS / wall:.2f} "
            f"audio-s/s; peak device memory {peak / 2 ** 30:.3f} GiB; launches (attention, "
            f"concat, viterbi) chunk 0 {launches[0]}, then {launches[1]} per chunk")
        rec = {"a": ("gated_bias_attention_diag", 0), "b": ("concat_cost_pair", 1),
               "e": ("f0_viterbi", 2)}.get(tag)
        if rec is not None:
            records[rec[0]]["stream_launches_per_chunk"] = launches[1][rec[1]]

    phase_cached_step(knn, src, dev)

    wav = load_utterance(src)
    for encoder in ("cached", "windowed"):
        kw = dict(LIVE, encoder=encoder)
        want = np.concatenate(list(knn.stream_convert_chunks(src, ref, **kw)))
        sess = knn.stream_session(ref, **kw)
        outs, emits = [], []
        for i in range(0, len(wav), PUSH_SAMPLES):
            t0 = time.perf_counter()
            out = sess.push(wav[i:i + PUSH_SAMPLES])
            if len(out):
                emits.append(time.perf_counter() - t0)
            outs.append(out)
        outs.append(sess.flush())
        live = np.concatenate(outs)
        equal = live.shape == want.shape and np.array_equal(live, want)
        latency = LIVE["chunk_s"] + LIVE["right_context_s"]
        log(f"[live] stream_session({encoder}, {LIVE}) pushed {PUSH_SAMPLES} samples at a time: "
            f"{len(emits)} pushes emitted a chunk, their wall time {spread(emits)} (algorithmic "
            f"latency {latency:.2f} s before it); output bit-identical to "
            f"stream_convert_chunks: {equal}")
        if not (equal and len(emits) > 0):
            fail(f"the {encoder} live session differs from the file stream")
    phase_stream_profile(knn, ref, wav, dict(LIVE, encoder="cached"))
    log(f"[stream] streaming phase in {time.perf_counter() - t_phase:.1f} s")


def phase_cached_step(knn, src: str, dev) -> None:
    """One step of the cached encoder at the live settings (25 new frames,
    5 of lookahead, a 200-frame cache filled) and its cached attention
    alone, in plain PyTorch: CUDA-event times and the attention's share."""
    import torch

    from knnsvc_torch.match.pool import load_utterance
    from knnsvc_torch.models.wavlm.streaming import (WavLMStreamEncoder, _cached_attention,
                                                     stream_position_bias)

    F_, CR = int(LIVE["chunk_s"] * 50), int(LIVE["right_context_s"] * 50)
    enc = WavLMStreamEncoder(knn.wavlm, 6, chunk_frames=F_, lookahead_frames=CR,
                             cache_frames=200)
    wav = load_utterance(src)
    steps = [wav[g * 320: g * 320 + enc.sample_len] for g in range(0, 300, F_)]
    with torch.no_grad():
        for x in steps:                          # fill the cache
            enc.step(x)
        step_ms = cuda_ms(lambda: enc.step(steps[-1]), iters=20)
        layer = knn.wavlm.encoder.layers[0]
        x = torch.randn(F_ + CR, knn.wavlm_cfg.encoder_embed_dim, device=dev)
        bias = stream_position_bias(knn.wavlm, 200, F_ + CR)
        invalid = torch.zeros(200 + F_ + CR, dtype=torch.bool, device=dev)
        kc, vc = enc.state.k_cache[0], enc.state.v_cache[0]
        attn_ms = cuda_ms(lambda: _cached_attention(x, layer.attn, bias, kc, vc, invalid),
                          iters=50)
        # the conv frontend alone, on the step's samples and on a 200-frame
        # window (the windowed encoder's at the CLI defaults), beside the
        # window's whole 6-layer encode
        step_x = torch.from_numpy(steps[-1]).to(dev)[None]
        win_x = torch.from_numpy(wav[:200 * 320 + 320]).to(dev)[None]
        front_step_ms = cuda_ms(lambda: knn.wavlm.feature_extractor(step_x), iters=20)
        front_win_ms = cuda_ms(lambda: knn.wavlm.feature_extractor(win_x), iters=20)
        win_ms = cuda_ms(lambda: knn.wavlm.extract_layer(win_x, 6), iters=20)
    log(f"[stream] cached encoder step ({F_}+{CR} frames over a 200-frame cache, 6 layers, "
        f"plain PyTorch attention): {step_ms:.4f} ms per step; one layer's cached attention "
        f"(q/k/v/out projections, gate, masked softmax) {attn_ms:.4f} ms, x6 = "
        f"{6 * attn_ms / step_ms:.1%} of the step; the conv frontend alone {front_step_ms:.4f} "
        f"ms on the step's {step_x.shape[1]} samples, {front_win_ms:.4f} ms on a 200-frame "
        f"window's {win_x.shape[1]}, whose whole 6-layer encode takes {win_ms:.4f} ms")


def phase_stream_profile(knn, ref: str, wav, kw: dict) -> None:
    """One warm live session traced: wall, device busy and idle share, and
    the split by the knnsvc.* spans (stream_chunk, stream_encode,
    cached_attention, stream_f0, match, concat_cost, smoothness, vocode,
    quantize_download)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    sess = knn.stream_session(ref, **kw)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for i in range(0, len(wav), PUSH_SAMPLES):
            sess.push(wav[i:i + PUSH_SAMPLES])
        sess.flush()
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    events = prof.events()
    spans = sorted((e.time_range.start, e.time_range.end, e.name) for e in device_events(events))
    if not spans:
        log("[profile] live session: the trace holds no device events: busy share not measured")
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
    log(f"[profile] live session {kw}: wall {wall_us / 1e3:.2f} ms, device busy {busy / 1e3:.2f} "
        f"ms, idle share {1 - busy / wall_us:.1%}; stages (host ms in span, device kernel ms; "
        f"the others nest in stream_chunk, cached_attention in stream_encode) "
        + json.dumps({k: [round(h, 3), round(d, 3)] for k, (h, d) in stage_times(events).items()}))
    for name, (us, n) in sorted(by_name.items(), key=lambda kv: -kv[1][0])[:10]:
        log(f"[profile]   {us / 1e3:8.3f} ms x{n:<5d} {name[:100]}")


def phase_bulk_profile(fn, label: str) -> None:
    """One bulk pass traced: device busy share and the split by the
    knnsvc.speaker_pool / bulk_match / vocode_batch spans."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    events = prof.events()
    spans = sorted((e.time_range.start, e.time_range.end) for e in device_events(events))
    if not spans:
        log(f"[profile] bulk {label}: the trace holds no device events: busy share not measured")
        return
    busy, (lo, hi) = 0.0, spans[0]
    for s, e in spans:
        if s > hi:
            busy, lo = busy + hi - lo, s
        hi = max(hi, e)
    busy += hi - lo
    log(f"[profile] bulk {label}: wall {wall_us / 1e3:.2f} ms, device busy {busy / 1e3:.2f} ms, "
        f"idle share {1 - busy / wall_us:.1%}; stages (host ms in span, device kernel ms) "
        + json.dumps({k: [round(h, 3), round(d, 3)] for k, (h, d) in stage_times(events).items()}))


# ------------------------------------------------------------ multi-device matchers


def logical_mesh(dev, n_data: int, n_pool: int):
    """A (n_data, n_pool) mesh of logical shards, every one on `dev`."""
    from knnsvc_torch.parallel import make_mesh

    return make_mesh(n_data, n_pool, devices=[dev] * (n_data * n_pool))


def phase_concat_sharded(dev) -> dict:
    """The concat kernel's shard-table entries against the plain version
    reading the same shards (parallel/mesh.gather_rows) at (1500, 1499,
    1024): S in SHARD_COUNTS logical shards, k in SHARD_KS, pair and single
    lane; S = 1 also against the dense entry. -> the record's times."""
    import torch

    from knnsvc_torch.match.concat_cost import knn_with_concat_cost, knn_with_concat_cost_pair
    from knnsvc_torch.ops.concat_scan import (concat_cost_pair, concat_cost_pair_sharded,
                                              concat_cost_single, concat_cost_single_sharded)
    from knnsvc_torch.parallel.mesh import gather_rows, shard_rows

    T, _, D = CONCAT_MAIN
    P = SHARDED_POOL
    times = {}
    for k in SHARD_KS:
        idx_u, idx_p, src, tgt, sf0, tf0 = concat_inputs(T, P, D, 6 + k, dev, k=k)
        dense = [*concat_cost_pair(idx_u, idx_p, src, tgt, sf0, tf0),
                 concat_cost_single(idx_u, src, tgt)]
        for S in SHARD_COUNTS:
            shards = shard_rows(tgt, logical_mesh(dev, 1, S))[0]
            got = [*concat_cost_pair_sharded(idx_u, idx_p, src, shards, P, sf0, tf0),
                   concat_cost_single_sharded(idx_u, src, shards, P)]
            rows = lambda ids, sh=shards: gather_rows(sh, ids)
            want = [*knn_with_concat_cost_pair(idx_u, idx_p, src, rows, sf0, tf0, pool_len=P),
                    knn_with_concat_cost(idx_u, src, rows, pool_len=P)]
            torch.cuda.synchronize()
            shares = [float((g == w).all(dim=1).float().mean()) for g, w in zip(got, want)]
            as_dense = all(bool(torch.equal(g, w)) for g, w in zip(got, dense))
            iters = 10 if k <= 4 else 3
            pair_ms = cuda_ms(lambda: concat_cost_pair_sharded(idx_u, idx_p, src, shards, P, sf0,
                                                               tf0), iters=iters, warmup=1)
            single_ms = cuda_ms(lambda: concat_cost_single_sharded(idx_u, src, shards, P),
                                iters=iters, warmup=1)
            log(f"[sharded] concat_cost_pair_sharded ({T}, {P} in {S} shards of "
                f"{shards[0].shape[0]}, {D}) k={k}: frames equal to the plain sharded version, "
                f"unpitched {shares[0]:.2%}, pitched {shares[1]:.2%}, single lane "
                f"{shares[2]:.2%}; equal to the dense entry: {as_dense}; kernel pair "
                f"{pair_ms:.4f} ms ({1e3 * pair_ms / (T - 1):.3f} us per frame), single "
                f"{single_ms:.4f} ms")
            if min(shares) < CONCAT_SHARE_MIN or (S == 1 and not as_dense):
                fail(f"the sharded concat entry disagrees at S={S}, k={k}: shares {shares}, "
                     f"equal to the dense entry {as_dense}")
            times[f"S{S}_k{k}"] = {"pair_ms": pair_ms, "single_ms": single_ms,
                                   "equal_to_dense": as_dense}
    return {"sharded_shape": [T, P, D], "sharded": times}


def phase_reach(dev, ptxas: list[str], records) -> None:
    """[reach] the kernels at the shapes the JAX package serves beside the
    main path's: each against its plain version on the card, timed beside
    its bound. Adds each shape's numbers to its entry's record."""
    phase_reach_attention(dev, records)
    phase_reach_encoder(dev)
    phase_reach_concat(dev, records)
    phase_reach_viterbi(dev, ptxas, records)


def phase_reach_attention(dev, records) -> None:
    """Both attention entries at head dims other than 64 (REACH_ATTENTION),
    under "highest" and "fastest", against the plain version on a random
    full bias and on the diagonal table, and a Toeplitz bias through the
    full entry bit-equal to the diagonal entry."""
    import torch

    from knnsvc_torch.ops.attention import (gated_bias_attention, gated_bias_attention_diag,
                                            reference_attention, toeplitz_bias)
    from knnsvc_torch.precision import set_precision

    gen = torch.Generator().manual_seed(16)
    card = card_label()
    rows = {"gated_bias_attention_diag": [], "gated_bias_attention": []}
    for H, T, d in REACH_ATTENTION:
        atol = ATTN_ATOL_MAIN if T > 200 else ATTN_ATOL_RAGGED
        q, k, v, diag, gate = attention_inputs(gen, dev, H, T, d)
        bias = torch.randn((H, T, T), generator=gen).to(dev)
        errs = {}
        for mode, bound in (("highest", atol), ("fastest", ATTN_ATOL_TF32)):
            set_precision(mode)
            try:
                got_diag = gated_bias_attention_diag(q, k, v, diag, gate)
                got_full = gated_bias_attention(q, k, v, bias, gate)
                toeplitz = gated_bias_attention(q, k, v, toeplitz_bias(diag).contiguous(), gate)
                torch.cuda.synchronize()
            finally:
                set_precision("highest")
            errs[mode] = [float((got_diag - reference_attention(q, k, v, diag, gate)).abs().max()),
                          float((got_full - reference_attention(q, k, v, bias, gate)).abs().max())]
            log(f"[reach] attention ({H},{T},{d}) {mode}: max_abs_err diagonal entry "
                f"{errs[mode][0]:.3e}, full entry {errs[mode][1]:.3e} (atol {bound}); a Toeplitz "
                f"bias through the full entry bit-equal to the diagonal entry: "
                f"{torch.equal(toeplitz, got_diag)}")
            if not (max(errs[mode]) <= bound and bool(torch.isfinite(got_diag).all())
                    and bool(torch.isfinite(got_full).all())):
                fail(f"the attention kernel disagrees at ({H},{T},{d}) under {mode}: {errs[mode]}")
            if not torch.equal(toeplitz, got_diag):
                fail(f"the full entry differs from the diagonal entry on a Toeplitz bias at "
                     f"({H},{T},{d}) under {mode}")
        for i, (name, fn, b, full) in enumerate((
                ("gated_bias_attention_diag", gated_bias_attention_diag, diag, False),
                ("gated_bias_attention", gated_bias_attention, bias, True))):
            iters = 20 if T > 200 else 50
            ms = cuda_ms(lambda: fn(q, k, v, b, gate), iters=iters)
            plain_ms = cuda_ms(lambda: reference_attention(q, k, v, b, gate), iters=5, warmup=1)
            bound_ms, bound_by = attention_bound_ms(H, T, d, full=full)
            log(f"[reach] {name} ({H},{T},{d}), 3xTF32: kernel {ms:.4f} ms, plain "
                f"{plain_ms:.4f} ms, bound {bound_ms:.4f} ms ({bound_by}); roofline share "
                f"{bound_ms / ms:.1%}; card {card}")
            rows[name].append({"shape": [H, T, d], "max_abs_err": errs["highest"][i],
                               "tf32_max_abs_err": errs["fastest"][i], "ms": ms,
                               "plain_ms": plain_ms, "bound_ms": bound_ms, "bound_by": bound_by})
    for name, r in rows.items():
        records[name]["head_dims"] = r


def phase_reach_encoder(dev) -> None:
    """The port's WavLM at head dims 16 (the JAX package's test encoder) and
    8 (the port's tiny one) on the card against the CPU, with the attention
    kernel's launches counted: one per layer."""
    import torch

    from knnsvc_torch.config import WavLMConfig
    from knnsvc_torch.io.jax_params import wavlm_from_numpy
    from knnsvc_torch.models.wavlm.model import init_wavlm_params
    from knnsvc_torch.ops.attention import gated_bias_attention_diag

    wav, _ = sung_wav(REACH_ENCODER_SECONDS, VOICES[0][1], VOICES[0][2])
    x = torch.from_numpy(wav)[None]
    for head_dim, spec in REACH_WAVLMS.items():
        cfg = WavLMConfig.from_dict(spec)
        params = init_wavlm_params(cfg, torch.Generator().manual_seed(head_dim))
        card, cpu = wavlm_from_numpy(params, cfg, dev), wavlm_from_numpy(params, cfg, "cpu")
        before = gated_bias_attention_diag.launches
        with torch.no_grad():
            got = card.extract_all_layers(x.to(dev))
            torch.cuda.synchronize()
            launches = gated_bias_attention_diag.launches - before
            want = cpu.extract_all_layers(x)
        err = float((got.cpu() - want).abs().max())
        log(f"[reach] WavLM at head dim {head_dim} ({cfg.encoder_embed_dim} wide, "
            f"{cfg.encoder_attention_heads} heads, {cfg.encoder_layers} layers) on "
            f"{REACH_ENCODER_SECONDS:.0f} s: {tuple(got.shape)} layers, card vs cpu max |diff| "
            f"{err:.3e} (atol {FEAT_ATOL}), {launches} attention launches")
        if launches != cfg.encoder_layers or not err <= FEAT_ATOL:
            fail(f"the head-dim-{head_dim} encoder: {launches} launches, card vs cpu {err}")


def phase_reach_concat(dev, records) -> None:
    """The concat kernel at row widths that are no multiple of 4
    (REACH_WIDTHS) at a 30-s pool, k = 4 (rows in shared memory) and 8 (in
    L2): the dense pair, the pair on 2 logical shards and the carried entry
    against the plain version on every frame; the dense pair timed."""
    import torch

    from knnsvc_torch.match.concat_cost import (concat_cost_pair_stream_core,
                                                knn_with_concat_cost_pair)
    from knnsvc_torch.ops.concat_scan import (concat_cost_pair, concat_cost_pair_sharded,
                                              concat_cost_pair_stream)
    from knnsvc_torch.parallel.mesh import shard_rows

    card = card_label()
    T, P, _ = CONCAT_MAIN
    rows = []
    for D in REACH_WIDTHS:
        for k in (4, TOPK_WIDE):
            idx_u, idx_p, src, tgt, sf0, tf0 = args = concat_inputs(T, P, D, D + k, dev, k=k)
            dense = concat_cost_pair(*args)
            shards = shard_rows(tgt, logical_mesh(dev, 1, 2))[0]
            sharded = concat_cost_pair_sharded(idx_u, idx_p, src, shards, P, sf0, tf0)
            want = knn_with_concat_cost_pair(*args)
            c_args = carried_args(CARRIED_STREAM[0] + 1, P, D, D + k + 1, dev, k, 0.2)
            carried = concat_cost_pair_stream(*c_args)
            c_want = concat_cost_pair_stream_core(*c_args)
            torch.cuda.synchronize()
            equal = {"dense": all(bool(torch.equal(g, w)) for g, w in zip(dense, want)),
                     "2 shards": all(bool(torch.equal(g, w)) for g, w in zip(sharded, want)),
                     "carried": all(bool(torch.equal(g, w)) for g, w in zip(carried, c_want))}
            ms = cuda_ms(lambda: concat_cost_pair(*args), iters=10 if k <= 4 else 3, warmup=1)
            bound_ms, bound_by = concat_bound_ms(T, P, D, lanes=2, k=k)
            log(f"[reach] concat_cost_pair ({T}, {P}, {D}) k={k}: picks equal to the plain "
                f"version on every frame, {', '.join(f'{n} {e}' for n, e in equal.items())} "
                f"(carried: {CARRIED_STREAM[0]}+1 frames, the weights too); kernel {ms:.4f} ms "
                f"({1e3 * ms / (T - 1):.3f} us per frame), bound {bound_ms:.4f} ms "
                f"({bound_by}); card {card}")
            if not all(equal.values()):
                fail(f"concat_cost_pair disagrees with its plain version at D={D}, k={k}: "
                     f"{equal}")
            rows.append({"shape": [T, P, D], "k": k, "ms": ms, "bound_ms": bound_ms,
                         "bound_by": bound_by, "us_per_frame": 1e3 * ms / (T - 1)})
    records["concat_cost_pair"]["widths"] = rows


def phase_reach_viterbi(dev, ptxas: list[str], records) -> None:
    """The Viterbi past 511 voiced states (REACH_STATES: grids of 5, 2 and
    1 cents) at a 30-s chunk's frames, states equal to the plain version on
    every frame, timed; every instance's ptxas registers and spills (a
    spill fails the run); device f0 at grid_cents 5 on a 30-s sung wav, the
    card against the CPU."""
    import numpy as np
    import torch

    from knnsvc_torch.dsp.f0_device import DeviceF0Params, device_f0, device_f0_tensor
    from knnsvc_torch.ops.viterbi import f0_viterbi, viterbi_plain

    card = card_label()
    for function in ("f0_viterbi_kernelILi4E", "f0_viterbi_kernelILi8E",
                     *(f"f0_viterbi_smem_kernelILi{p}E" for p in (4, 8, 16, 32))):
        regs, spill_st, spill_ld = ptxas_usage("f0_viterbi", ptxas, function)
        log(f"[reach] f0_viterbi ptxas {function}: {regs} registers, {spill_st} bytes spill "
            f"stores, {spill_ld} bytes spill loads")
        if spill_st or spill_ld:
            fail(f"{function} spills: {spill_st} bytes stored, {spill_ld} loaded")
    N = VITERBI_MAIN[0]
    rows = []
    for C, grid_cents in REACH_STATES:
        rng = np.random.default_rng(C)
        cv = rng.standard_normal((N, C)).astype(np.float32)
        cu = (0.5 * rng.standard_normal(N)).astype(np.float32)
        cv[::3] = 1e3                                  # silent frames
        cv[1::4, C // 2:] = cv[1::4, C // 2:C // 2 + 1]  # flat runs
        cu[::7] = 1e3
        cost_v, cost_u = torch.from_numpy(cv).to(dev), torch.from_numpy(cu).to(dev)
        lam_s = float(np.float32(0.753) * np.float32(grid_cents / 1200.0))
        switch = float(np.float32(0.291))
        got = f0_viterbi(cost_v, cost_u, lam_s, switch)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        want = viterbi_plain(cost_v, cost_u, lam_s, switch)
        torch.cuda.synchronize()
        plain_ms = 1e3 * (time.perf_counter() - t0)
        equal = float((got == want).float().mean())
        ms = cuda_ms(lambda: f0_viterbi(cost_v, cost_u, lam_s, switch), iters=10)
        bound_ms, bound_by = viterbi_bound_ms(N, C)
        log(f"[reach] f0_viterbi ({N}, {C}) (a {grid_cents:g}-cent grid): states equal to the plain version on {equal:.2%} "
            f"of frames (unvoiced share {float((want == C).float().mean()):.1%}); kernel "
            f"{ms:.4f} ms ({1e3 * ms / (N - 1):.4f} us per frame), plain {plain_ms:.1f} ms "
            f"(one run), bound {bound_ms:.4f} ms ({bound_by}); card {card}")
        if equal != 1.0:
            fail(f"f0_viterbi disagrees with its plain version at ({N}, {C}): {equal:.4%}")
        rows.append({"shape": [N, C], "ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
                     "bound_by": bound_by, "us_per_frame": 1e3 * ms / (N - 1)})
    records["f0_viterbi"]["states"] = rows

    params = DeviceF0Params(grid_cents=REACH_GRID_CENTS)
    wav, _ = sung_wav(FULL_SECONDS, VOICES[1][1], VOICES[1][2])
    wav[:16000] = 0.0
    before = f0_viterbi.launches
    card_f0 = device_f0(wav, 16000, params=params, device=dev)
    launches = f0_viterbi.launches - before
    cpu_f0 = device_f0(wav, 16000, params=params, device="cpu")
    voicing = float(((card_f0 > 0) == (cpu_f0 > 0)).mean())
    both = (card_f0 > 0) & (cpu_f0 > 0)
    cents = np.abs(1200 * np.log2(card_f0[both] / cpu_f0[both]))
    within = float((cents <= F0_CENTS).mean())
    x = torch.from_numpy(wav).to(dev)
    tensor_ms = cuda_ms(lambda: device_f0_tensor(x, 16000, N, params=params), iters=5)
    log(f"[reach] device_f0 at grid_cents {REACH_GRID_CENTS} ({len(card_f0)} frames, "
        f"{both.mean():.1%} voiced in both, {launches} Viterbi launch): card vs cpu voicing "
        f"equal on {voicing:.2%} (min {F0_VOICING_SHARE_MIN:.1%}), f0 within {F0_CENTS} cent "
        f"on {within:.2%} (min {F0_CENTS_SHARE_MIN:.0%}), max {float(cents.max()):.4f} cents; "
        f"one 30-s device_f0_tensor {tensor_ms:.4f} ms; card {card}")
    if not (launches == 1 and voicing >= F0_VOICING_SHARE_MIN and within >= F0_CENTS_SHARE_MIN
            and both.mean() > 0.5):
        fail(f"device f0 at grid_cents {REACH_GRID_CENTS}: {launches} launches, voicing "
             f"{voicing}, within {within}")
    records["f0_viterbi"]["grid_cents_5_device_f0_ms"] = tensor_ms


def phase_sharded(root: str, knn, records, dev, bulk) -> None:
    """The multi-device matchers at full width on logical shards of the
    card: (b) an hour-scale pool, (c) the 30-s pair, (d) the bulk loops on
    phase 6's dataset, (e) streaming."""
    t_phase = time.perf_counter()
    phase_sharded_hour(knn, dev)
    phase_sharded_pair(root, knn, records, dev)
    phase_sharded_bulk(root, knn, dev, *bulk)
    phase_sharded_stream(root, knn, dev)
    log(f"[sharded] phase in {time.perf_counter() - t_phase:.1f} s")


def phase_sharded_hour(knn, dev) -> None:
    """(b) A seeded KNN_HOUR pool (random rows, f0 and harmonics, made on
    the card) at 1 and 4 shards: sharded_knn_topk against knn_topk, then
    match_utterance(matcher='sharded', post_opt_0.2) against 'exact': the
    shares of equal rows and picks, the largest feature difference, times."""
    import torch

    from knnsvc_torch.config import PostOpt
    from knnsvc_torch.match.f0_logic import shift_f0_to_target_register, sort_by_f0_compatibility
    from knnsvc_torch.match.knn import knn_topk
    from knnsvc_torch.match.pipeline import match_utterance
    from knnsvc_torch.ops.concat_scan import concat_cost_pair, concat_cost_pair_sharded
    from knnsvc_torch.parallel import sharded_knn_topk
    from knnsvc_torch.parallel.sharded_match import shard_speaker_pool

    Q, P, D = KNN_HOUR
    gen = torch.Generator(device=dev).manual_seed(10)
    matching = torch.randn(P, D, device=dev, generator=gen)
    synth = torch.randn(P, D, device=dev, generator=gen)
    harm = torch.rand(P, 49, device=dev, generator=gen)
    f0 = 100 + 300 * torch.rand(P, device=dev, generator=gen)
    f0[torch.rand(P, device=dev, generator=gen) < 0.15] = 0.0
    q = torch.randn(Q, D, device=dev, generator=gen)
    qf0 = 100 + 200 * torch.rand(Q, device=dev, generator=gen)
    qf0[torch.rand(Q, device=dev, generator=gen) < 0.15] = 0.0
    popt = PostOpt.parse(POST_OPT)

    def timed(fn):
        concat_cost_pair.launches = 0
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        return time.perf_counter() - t0, out, concat_cost_pair.launches

    dense_idx = knn_topk(q, matching, k=32)[0]
    dense_ms = cuda_ms(lambda: knn_topk(q, matching, k=32), iters=3, warmup=1)
    shifted = shift_f0_to_target_register(qf0, f0)
    pitched = sort_by_f0_compatibility(shifted, f0, dense_idx)[:, :4]
    dense_picks = concat_cost_pair(dense_idx[:, :4], pitched, q, matching, shifted, f0)
    timed(lambda: match_utterance(q, qf0, matching, synth, f0, harm, "mix", popt,
                                  matcher="exact", as_numpy=False))   # first call
    dense_s, dense, launches = timed(lambda: match_utterance(
        q, qf0, matching, synth, f0, harm, "mix", popt, matcher="exact", as_numpy=False))
    log(f"[sharded] hour pool {KNN_HOUR}: dense knn_topk {dense_ms:.3f} ms; dense "
        f"match_utterance(exact, {POST_OPT}) {dense_s:.3f} s, concat launches {launches}")
    for S in HOUR_SHARDS:
        mesh = logical_mesh(dev, 1, S)
        sp = shard_speaker_pool(matching, synth, f0, harm, mesh)
        idx = sharded_knn_topk(q, sp.matching, P, mesh, k=32)[0]
        rows_equal = float((idx == dense_idx).all(dim=1).float().mean())
        knn_ms = cuda_ms(lambda: sharded_knn_topk(q, sp.matching, P, mesh, k=32), iters=3,
                         warmup=1)
        pitched_s = sort_by_f0_compatibility(shifted, f0, idx)[:, :4]
        picks = concat_cost_pair_sharded(idx[:, :4], pitched_s, q, sp.matching[0], P, shifted, f0)
        picks_equal = float(torch.stack([(a == b).all(dim=1) for a, b in zip(picks, dense_picks)])
                            .all(dim=0).float().mean())
        timed(lambda: match_utterance(q, qf0, None, None, None, None, "mix", popt,
                                      matcher="sharded", sharded=sp, as_numpy=False))
        sharded_s, got, launches = timed(lambda: match_utterance(
            q, qf0, None, None, None, None, "mix", popt, matcher="sharded", sharded=sp,
            as_numpy=False))
        diff = max(float((a - b).abs().max()) for a, b in (
            (got.out_feats_weighted, dense.out_feats_weighted),
            (got.harmonics_out_feats_weighted, dense.harmonics_out_feats_weighted)))
        finite = bool(torch.isfinite(got.out_feats_weighted).all())
        log(f"[sharded] hour pool, {S} shard(s) of {sp.matching[0][0].shape[0]} rows: "
            f"sharded_knn_topk {knn_ms:.3f} ms (dense {dense_ms:.3f}), top-32 rows equal to "
            f"knn_topk's on {rows_equal:.2%} of queries; match_utterance(sharded, {POST_OPT}) "
            f"{sharded_s:.3f} s (exact {dense_s:.3f} s), concat launches {launches}, frames "
            f"whose concat picks (both lanes) equal exact's {picks_equal:.2%}, largest feature "
            f"difference {diff:.3e}")
        if not (finite and launches == 1 and rows_equal >= KNN_SET_SHARE_MIN
                and picks_equal >= PICK_SHARE_MIN):
            fail(f"the sharded match at an hour of target, S={S}: rows {rows_equal}, picks "
                 f"{picks_equal}, launches {launches}, finite {finite}")
        del sp, got
    del matching, synth, harm, dense


def phase_sharded_pair(root: str, knn, records, dev) -> None:
    """(c) convert_pair on the 30-s pair with f0 sidecars: 'sharded'
    (no_post_opt, post_opt_0.2) and 'sharded_int8' (no_post_opt), on the
    default pool mesh and on 4 logical shards, launches checked; the
    pre-quantize waveform against the 'exact' matcher's (sharded), the
    written one against the host-pool int8 pair's (sharded_int8); warm
    medians beside the dense matcher's; convert_pair(fast=False,
    matcher='sharded') once against the host exact pair."""
    import numpy as np
    import torch

    from knnsvc_torch.io.audio import load_audio
    from knnsvc_torch.ops.attention import gated_bias_attention_diag
    from knnsvc_torch.ops.concat_scan import concat_cost_pair

    pair_dir = os.path.join(root, "sharded_pair")
    os.makedirs(pair_dir)
    src, ref = write_pair(pair_dir, FULL_SECONDS, sidecars=True)
    mesh4 = logical_mesh(dev, 1, 4)

    def run(name, **kw):
        out = os.path.join(pair_dir, f"{name}.wav")
        gated_bias_attention_diag.launches = concat_cost_pair.launches = 0
        t0 = time.perf_counter()
        knn.convert_pair(src, ref, output_path=out, **kw)
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        po = kw.get("post_opt", "no_post_opt")
        launches = (gated_bias_attention_diag.launches, concat_cost_pair.launches)
        want = (LAUNCHES_PER_PAIR, 0 if po == "no_post_opt" else 1)
        if launches != want:
            fail(f"convert_pair({kw}) launched (attention, concat) {launches}, expected {want}")
        return dt, load_audio(out)[0][0], launches

    def medians(name, **kw):
        n = SHARDED_PAIR_RUNS[kw.get("post_opt", "no_post_opt") != "no_post_opt"]
        first, _, _ = run(name, **kw)
        times = [run(name, **kw)[0] for _ in range(n)]
        return first, statistics.median(times), min(times), max(times)

    dense = {po: medians(f"exact_{po}", fast=True, post_opt=po)
             for po in ("no_post_opt", POST_OPT)}
    exact_wave = {po: knn.convert_waveform(src, ref, post_opt=po).cpu().numpy()
                  for po in dense}
    _, int8_host, _ = run("int8_host", fast=False, matcher="int8")
    for po, (first, med, lo, hi) in dense.items():
        log(f"[sharded] pair exact {po} (dense): first {first:.4f} s, warm median {med:.4f} s "
            f"(min {lo:.4f}, max {hi:.4f})")
    for matcher, po in (("sharded", "no_post_opt"), ("sharded", POST_OPT),
                        ("sharded_int8", "no_post_opt")):
        for mesh_name, mesh in (("default mesh", None), ("4 logical shards", mesh4)):
            kw = dict(fast=True, matcher=matcher, post_opt=po, mesh=mesh)
            first, med, lo, hi = medians(f"{matcher}_{po}", **kw)
            _, written, launches = run(f"{matcher}_{po}", **kw)
            wave = knn.convert_waveform(src, ref, post_opt=po, matcher=matcher,
                                        mesh=mesh).cpu().numpy()
            peak = float(np.abs(exact_wave[po]).max())
            rel = float(np.abs(wave - exact_wave[po]).max()) / max(peak, 1e-30)
            check = f"vs exact {rel:.3e} of the peak (tol {WAV_REL_TOL})"
            ok = np.isfinite(wave).all() and wave.shape == exact_wave[po].shape
            if matcher == "sharded_int8":
                host = float(np.abs(written - int8_host).max())
                check = (f"vs exact {rel:.3e} of the peak (other picks: int8 search); written "
                         f"vs the host-pool int8 pair {host:.3e} (tol {HOST_VS_FAST_ATOL:.3e})")
                ok = ok and host <= HOST_VS_FAST_ATOL
            else:
                ok = ok and rel <= WAV_REL_TOL
            log(f"[sharded] pair {matcher} {po}, {mesh_name}: first {first:.4f} s, warm median "
                f"{med:.4f} s (min {lo:.4f}, max {hi:.4f}; dense {dense[po][1]:.4f}); launches "
                f"(attention, concat) {launches}; pre-quantize waveform {check}")
            if not ok:
                fail(f"convert_pair({matcher}, {po}, {mesh_name}) disagrees: {check}")
            if matcher == "sharded" and po == POST_OPT and mesh is None:
                records["concat_cost_pair"]["sharded_launches"] = launches[1]
    phase_profile(knn, src, ref, os.path.join(pair_dir, "traced.wav"),
                  f"sharded {POST_OPT}, 4 logical shards, repeat", POST_OPT, matcher="sharded",
                  mesh=mesh4)
    _, host_sharded, launches = run("sharded_host", fast=False, matcher="sharded")
    _, host_exact, _ = run("exact_host", fast=False)
    rel = float(np.abs(host_sharded - host_exact).max()) / max(float(np.abs(host_exact).max()),
                                                               1e-30)
    log(f"[sharded] convert_pair(fast=False, matcher='sharded'): launches {launches}; vs the "
        f"host exact pair {rel:.3e} of the peak (tol {WAV_REL_TOL})")
    if not rel <= WAV_REL_TOL:
        fail(f"the sharded host-pool pair differs from the exact one: {rel}")


def phase_sharded_bulk(root: str, knn, dev, data: str, want_attention: int, audio_s: float,
                       n_conv: int) -> None:
    """(d) bulk_convert on phase 5's dataset: the host loop with 'sharded'
    against phase 5's host loop; the dense fast loop on a (2, 1) data mesh
    against phase 5's data_batch=2 loop; the fast loop with 'sharded_int8'
    serial, with data_batch=2, and with data_batch=2 on a 2 x 2 mesh, each
    against the next. One pass each (pools built inside), attention
    launches checked, audio-s/s."""
    import numpy as np
    import torch

    from knnsvc_torch.ops.attention import gated_bias_attention_diag
    from knnsvc_torch.ops.concat_scan import concat_cost_pair

    loops = (("host sharded", {"matcher": "sharded"}),
             ("fast exact, (2, 1) data mesh", {"fast": True, "mesh": logical_mesh(dev, 2, 1)}),
             ("fast sharded_int8", {"fast": True, "matcher": "sharded_int8"}),
             ("fast sharded_int8, data_batch=2",
              {"fast": True, "matcher": "sharded_int8", "data_batch": 2}),
             ("fast sharded_int8, 2 x 2 mesh, data_batch=2",
              {"fast": True, "matcher": "sharded_int8", "data_batch": 2,
               "mesh": logical_mesh(dev, 2, 2)}))
    # phase 5's warm passes of the dense loops
    trees = {f"{name} (phase 5)": read_tree(os.path.join(root, f"bulk_{name}_1"))
             for name, _ in BULK_LOOPS}
    for i, (name, kw) in enumerate(loops):
        out_dir = os.path.join(root, f"bulk_sharded_{i}")
        gated_bias_attention_diag.launches = concat_cost_pair.launches = 0
        t0 = time.perf_counter()
        written = knn.bulk_convert(data, data, out_dir, **kw)
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        launches = (gated_bias_attention_diag.launches, concat_cost_pair.launches)
        trees[name] = read_tree(out_dir)
        log(f"[sharded] bulk {name}: {len(written)} conversions of {audio_s:.0f} s in {dt:.3f} s "
            f"= {audio_s / dt:.2f} audio-s/s (pools built in the pass); launches (attention, "
            f"concat) {launches}")
        if not (len(written) == n_conv and launches == (want_attention, 0)):
            fail(f"bulk {name}: {len(written)} written, launches {launches}")
    for a, b, tol in (("host sharded", "host (phase 5)", INT16_STEP),
                      ("fast exact, (2, 1) data mesh", "fast_batch2 (phase 5)", INT16_STEP),
                      ("fast sharded_int8, 2 x 2 mesh, data_batch=2",
                       "fast sharded_int8, data_batch=2", INT16_STEP),
                      ("fast sharded_int8, data_batch=2", "fast sharded_int8", INT16_STEP),
                      ("fast sharded_int8", "fast (phase 5)", None)):
        if set(trees[a]) != set(trees[b]):
            fail(f"bulk {a} and {b} wrote different files")
        diff = max(float(np.abs(trees[a][k] - trees[b][k]).max()) for k in trees[a])
        log(f"[sharded] bulk {a} vs {b}: max |diff| {diff:.3e}"
            + (f" (tol {tol:.3e})" if tol else " (other picks: int8 search; not checked)"))
        if tol is not None and not diff <= tol:
            fail(f"bulk {a} differs from {b} by {diff}")


def phase_sharded_stream(root: str, knn, dev) -> None:
    """(e) A windowed 30-s stream at the CLI defaults with 'sharded'
    against the same stream with 'exact' (per-chunk launches checked), and
    a live stream_session with 'sharded_int8' pushed 20 ms at a time against
    its file stream."""
    import numpy as np

    from knnsvc_torch.match.pool import load_utterance

    sdir = os.path.join(root, "stream")
    src, ref = (os.path.join(sdir, f"{name}_{int(FULL_SECONDS)}s.wav") for name, _, _ in VOICES)
    streams = {}
    for matcher in ("exact", "sharded"):
        kw = dict(STREAM_CLI, matcher=matcher)
        stream_counted(knn, src, ref, kw)      # cold
        chunks, times, launches = stream_counted(knn, src, ref, kw)
        per_window = LAUNCHES_PER_PAIR // 2          # one 30-s-or-less window encoded
        if not (len(chunks) == STREAM_CHUNKS and launches[0] == (2 * per_window, 0, 0)
                and all(n == (per_window, 0, 0) for n in launches[1:])):
            fail(f"stream {matcher}: {len(chunks)} chunks, launches {launches}")
        streams[matcher] = np.concatenate(chunks)
        log(f"[sharded] stream (windowed, {kw}): {len(chunks)} chunks; warm "
            f"chunks 1-{len(times) - 1}: {spread(times[1:])} per 2-s chunk; launches "
            f"(attention, concat, viterbi) chunk 0 {launches[0]}, then {launches[1]}")
    a, b = streams["sharded"], streams["exact"]
    rel = float(np.abs(a - b).max()) / max(float(np.abs(b).max()), 1e-30)
    log(f"[sharded] stream sharded vs exact: bit-identical {np.array_equal(a, b)}, max |diff| "
        f"{rel:.3e} of the peak (tol {WAV_REL_TOL})")
    if not (a.shape == b.shape and rel <= WAV_REL_TOL):
        fail(f"the sharded stream differs from the exact one: {rel}")
    kw = dict(LIVE, encoder="cached", matcher="sharded_int8")
    want = np.concatenate(list(knn.stream_convert_chunks(src, ref, **kw)))
    wav = load_utterance(src)
    sess = knn.stream_session(ref, **kw)
    outs, emits = [], []
    for i in range(0, len(wav), PUSH_SAMPLES):
        t0 = time.perf_counter()
        out = sess.push(wav[i:i + PUSH_SAMPLES])
        if len(out):
            emits.append(time.perf_counter() - t0)
        outs.append(out)
    outs.append(sess.flush())
    live = np.concatenate(outs)
    equal = live.shape == want.shape and np.array_equal(live, want)
    log(f"[sharded] live stream_session({kw}): {len(emits)} pushes "
        f"emitted a chunk, their wall time {spread(emits)}; bit-identical to the file "
        f"stream: {equal}")
    if not (equal and emits):
        fail("the sharded_int8 live session differs from its file stream")


# ------------------------------------------------------------ vocoder training


def write_train_dataset(root: str) -> dict[str, str]:
    """TRAIN_SINGERS x TRAIN_SECONDS (the train split) and VALID_SINGERS x
    VALID_SECONDS (the valid split) sung utterances, no f0 sidecars (the
    prematch extracts f0). -> {split: dataset root}."""
    from knnsvc_torch.io.audio import save_audio

    roots = {}
    for split, singers, seconds in (("train", TRAIN_SINGERS, TRAIN_SECONDS),
                                    ("valid", VALID_SINGERS, VALID_SECONDS)):
        roots[split] = os.path.join(root, "train_data", split)
        for name, hz, seed in singers:
            os.makedirs(os.path.join(roots[split], name))
            for i, s in enumerate(seconds):
                wav, _ = sung_wav(s, hz * (1 + 0.04 * i), seed + i)
                save_audio(os.path.join(roots[split], name, f"{name}_{i}.wav"), wav, 16000)
    return roots


def _leaves(tree):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _leaves(tree[k])
    elif isinstance(tree, list):
        for v in tree:
            yield from _leaves(v)
    else:
        yield tree


def phase_train(root: str, records, dev) -> None:
    """Vocoder training on the card (knnsvc_torch.train):
    (a) prematch of a seeded sung dataset through cli.prematch.main with the
        random-init WavLM-Large (6 attention launches per 30-s chunk), its
        wall time per utterance and smoothness steps, and one singer
        prematched on the CPU against the card;
    (b) one full-width train step (HiFiGANConfig(), full MPD and MSD) on the
        card against the CPU from the same state and batch of 2;
    (c) TRAIN_WARM_STEPS warm steps at the real config (batch 16, segment
        7040) under "highest", "fastest" and compute_dtype=bfloat16;
    (d) train() end to end with validation every LOOP_VALIDATION steps,
        best-val retention, resume_from, and the trained g_ served by
        KnnSvc.load(ckpt_dir, "mix") on the card;
    (e) one warm full-width step traced per precision, split by the
        knnsvc.d_step / knnsvc.g_step spans."""
    import dataclasses
    import pickle

    import numpy as np
    import torch

    from knnsvc_torch.cli import prematch as prematch_cli
    from knnsvc_torch.config import HiFiGANConfig, ModelFamily, WavLMConfig
    from knnsvc_torch.hub import KnnSvc
    from knnsvc_torch.io.checkpoints import save_params
    from knnsvc_torch.io.jax_params import tree_from_module
    from knnsvc_torch.models.wavlm.model import init_wavlm_params
    from knnsvc_torch.ops.attention import gated_bias_attention_diag
    from knnsvc_torch.precision import set_precision
    from knnsvc_torch.train import prematch as prematch_mod
    from knnsvc_torch.train.dataset import BATCH_KEYS, MelDataset
    from knnsvc_torch.train.loop import train
    from knnsvc_torch.train.trainer import init_train_state, make_train_step
    from knnsvc_torch.utils.layer_weights import generate_matrix_from_index

    t_phase = time.perf_counter()
    roots = write_train_dataset(root)
    feats = {split: os.path.join(root, "train_data", f"cached_{split}") for split in roots}
    n_utts = {"train": len(TRAIN_SINGERS) * len(TRAIN_SECONDS),
              "valid": len(VALID_SINGERS) * len(VALID_SECONDS)}

    # (a) prematch through the CLI, each speaker's extraction timed
    speaker_s = []
    real_extract = prematch_mod._extract_speaker

    def timed_extract(*args, **kwargs):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        real_extract(*args, **kwargs)
        torch.cuda.synchronize()
        speaker_s.append(time.perf_counter() - t0)

    prematch_mod._extract_speaker = timed_extract
    try:
        for split in ("train", "valid"):
            speaker_s.clear()
            gated_bias_attention_diag.launches = 0
            with OptimizerSteps() as opt:
                t0 = time.perf_counter()
                rc = prematch_cli.main(["--librispeech_path", roots[split], "--out_path",
                                        feats[split], "--prematch", "--seed", str(PREMATCH_SEED),
                                        "--device", dev.type])
                wall = time.perf_counter() - t0
            launches, want = gated_bias_attention_diag.launches, 6 * n_utts[split]
            per_utt = [s / len(TRAIN_SECONDS if split == "train" else VALID_SECONDS)
                       for s in speaker_s]
            log(f"[train] (a) prematch {split}: {n_utts[split]} utterances of "
                f"{TRAIN_SECONDS if split == 'train' else VALID_SECONDS} s through cli.prematch "
                f"(random-init WavLM-Large, layer 6) in {wall:.3f} s with the WavLM init; per "
                f"speaker {', '.join(f'{s:.3f}' for s in speaker_s)} s = per utterance "
                f"{', '.join(f'{s:.3f}' for s in per_utt)} s; attention launches {launches} "
                f"(want {want}: 6 per 30-s chunk); smoothness steps {opt.steps}")
            if not (rc == 0 and launches == want and len(opt.steps) == n_utts[split]):
                fail(f"prematch {split}: rc {rc}, {launches} attention launches (want {want}), "
                     f"{len(opt.steps)} optimizations")
            if split == "train":
                records["gated_bias_attention_diag"]["prematch_launches"] = launches
    finally:
        prematch_mod._extract_speaker = real_extract

    # one singer on the CPU (its f0 sidecars copied: the same host f0)
    singer = TRAIN_SINGERS[0][0]
    cpu_root = os.path.join(root, "train_data", "cpu_one")
    shutil.copytree(os.path.join(roots["train"], singer), os.path.join(cpu_root, singer))
    wcfg = WavLMConfig()
    wparams = init_wavlm_params(wcfg, torch.Generator().manual_seed(PREMATCH_SEED))
    w6 = generate_matrix_from_index(6)
    t0 = time.perf_counter()
    prematch_mod.per_spk_extract(cpu_root, os.path.join(root, "train_data", "cached_cpu"),
                                 wparams, wcfg, w6, w6, device="cpu")
    cpu_s = time.perf_counter() - t0
    rows = same_rows = same_prio = 0
    w_diff = 0.0
    for i in range(len(TRAIN_SECONDS)):
        fds = []
        for base in (feats["train"], os.path.join(root, "train_data", "cached_cpu")):
            with open(os.path.join(base, singer, f"{singer}_{i}.pt"), "rb") as fh:
                fds.append(pickle.load(fh))
        a, b = fds
        rows += len(a["nearest_nbrs"])
        same_rows += int(np.all(a["nearest_nbrs"] == b["nearest_nbrs"], axis=1).sum())
        same_prio += int(np.all(a["nearest_nbrs_f0_priority"][:, :4]
                                == b["nearest_nbrs_f0_priority"][:, :4], axis=1).sum())
        w_diff = max(w_diff, float(np.abs(a["harmonics_best_weight_para"]
                                          - b["harmonics_best_weight_para"]).max()))
        if not (np.isfinite(a["harmonics_best_weight_para"]).all()
                and np.allclose(a["harmonics_best_weight_para"].sum(1), 1, atol=1e-5)):
            fail(f"prematch weights of {singer}_{i} are not convex")
    log(f"[train] (a) prematch card vs CPU, {singer} ({len(TRAIN_SECONDS)} utterances, CPU "
        f"{cpu_s:.2f} s): nearest_nbrs rows equal {same_rows}/{rows} = {same_rows / rows:.1%}, "
        f"top-4 f0-priority rows equal {same_prio / rows:.1%}, max |weight diff| {w_diff:.3e}")
    if same_rows / rows < KNN_SET_SHARE_MIN:
        fail(f"prematch card vs CPU: {same_rows}/{rows} nearest-neighbour rows equal")

    # (b) one full-width step, card vs CPU, same state and batch of 2
    h = HiFiGANConfig()
    trainset = MelDataset(h, roots["train"], feats["train"], split=True, seed=h.seed)
    items = [trainset[i % len(trainset)] for i in range(2 * h.batch_size)]
    host_batches = [{k: np.stack([it[k] for it in items[j * h.batch_size:(j + 1) * h.batch_size]])
                     for k in BATCH_KEYS} for j in range(2)]
    results = []
    for device in (dev, torch.device("cpu")):
        state = init_train_state(h.seed, h, ModelFamily.MIX, device=device)
        step = make_train_step(h, ModelFamily.MIX)
        t0 = time.perf_counter()
        m = step(state, {k: torch.from_numpy(v[:CPU_BATCH]).to(device)
                         for k, v in host_batches[0].items()})
        m = {k: float(v) for k, v in m.items()}
        results.append((m, time.perf_counter() - t0, [
            tree_from_module(state.generator), tree_from_module(state.mpd),
            tree_from_module(state.msd)]))
        del state
    (card_m, card_s, card_t), (cpu_m, cpu_s, cpu_t) = results
    diffs = np.concatenate([np.abs(a - b).ravel() for a, b in zip(_leaves(card_t), _leaves(cpu_t))])
    rel = max(abs(card_m[k] - cpu_m[k]) / abs(cpu_m[k]) for k in card_m)
    log(f"[train] (b) one full-width step (HiFiGANConfig(), MPD x5, MSD x3), batch "
        f"{CPU_BATCH}, card vs CPU: card {json.dumps(card_m)} ({card_s:.2f} s, first step), "
        f"CPU {json.dumps(cpu_m)} ({cpu_s:.2f} s); max relative metric diff {rel:.3e} (tol "
        f"{TRAIN_METRIC_RTOL}); parameters after the step: max |diff| {diffs.max():.3e} over "
        f"{diffs.size} (bound 2 lr = {2 * h.learning_rate:.1e}: Adam's first step moves each "
        f"weight by lr * sign(grad)), {np.mean(diffs <= 1e-6):.4%} within 1e-6")
    if not (rel <= TRAIN_METRIC_RTOL and diffs.max() <= 2 * h.learning_rate * 1.001 + 1e-6
            and all(np.isfinite(v) for v in card_m.values())):
        fail(f"the full-width train step differs card vs CPU: metrics {rel}, params {diffs.max()}")
    del results, card_t, cpu_t, diffs

    # (c) warm steps at the real config
    state = init_train_state(h.seed, h, ModelFamily.MIX, device=dev)
    batches = [{k: torch.from_numpy(v).to(dev) for k, v in b.items()} for b in host_batches]
    audio_s = h.batch_size * h.segment_size / h.sampling_rate
    for label, precision, compute_dtype in STEP_RUNS:
        set_precision(precision)
        try:
            step = make_train_step(h, ModelFamily.MIX, compute_dtype=compute_dtype and getattr(
                torch, compute_dtype))
            for i in range(TRAIN_WARMUP):
                step(state, batches[i % 2])
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            times, ms = [], []
            for i in range(TRAIN_WARM_STEPS):
                t0 = time.perf_counter()
                m = step(state, batches[i % 2])
                torch.cuda.synchronize()
                times.append(time.perf_counter() - t0)
                ms.append({k: float(v) for k, v in m.items()})
            peak = torch.cuda.max_memory_allocated()
        finally:
            set_precision("highest")
        med, p90 = statistics.median(times), float(np.percentile(times, 90))
        d_losses = [m["loss_disc_total"] for m in ms]
        log(f"[train] (c) {label}: {TRAIN_WARM_STEPS} warm steps at batch {h.batch_size}, segment "
            f"{h.segment_size}: step median {1e3 * med:.2f} ms, p90 {1e3 * p90:.2f} ms, min "
            f"{1e3 * min(times):.2f} ms; {1 / med:.3f} steps/s = {audio_s / med:.2f} audio-s/s "
            f"({audio_s:.2f} s of audio per step); peak device memory {peak / 2 ** 30:.3f} GiB; "
            f"losses first {json.dumps(ms[0])}, last {json.dumps(ms[-1])}")
        if not (all(np.isfinite(v) for m in ms for v in m.values()) and len(set(d_losses)) > 1):
            fail(f"training ({label}): non-finite losses or a D loss that never changes")

    # (e) one warm full-width step traced per precision (the top 10 under "highest")
    for label, precision, compute_dtype in STEP_RUNS:
        set_precision(precision)
        try:
            phase_train_profile(state, h, batches, label, compute_dtype and getattr(
                torch, compute_dtype), top=label == "highest")
        finally:
            set_precision("highest")
    phase_orbax_train_state(root, state)
    del state, batches
    phase_dp_train(host_batches, dev)

    # (d) train() end to end, then resume, then serve the trained g_
    h_loop = dataclasses.replace(h, batch_size=LOOP_BATCH)
    ckpt = os.path.join(root, "train_ckpt")
    roots_kw = dict(audio_root_train=roots["train"], feat_root_train=feats["train"],
                    audio_root_valid=roots["valid"], feat_root_valid=feats["valid"])
    t0 = time.perf_counter()
    state = train(h_loop, checkpoint_path=ckpt, training_epochs=1000,
                  validation_interval=LOOP_VALIDATION, summary_interval=1, stdout_interval=1000,
                  max_steps=LOOP_STEPS, device=dev, val_artifacts=1, **roots_kw)
    loop_s = time.perf_counter() - t0
    with open(os.path.join(ckpt, "logs", "train_log.jsonl")) as fh:
        scalars = [json.loads(line) for line in fh]
    steps = [s["step"] for s in scalars if "loss_gen_total" in s]
    vals = [(s["validation/mel_spec_error"], s["step"]) for s in scalars
            if "validation/mel_spec_error" in s]
    improved = [v for i, v in enumerate(vals) if v[0] < min([u[0] for u in vals[:i]] + [np.inf])]
    pairs = sorted(os.path.basename(p) for p in os.listdir(ckpt) if p.endswith(".knnsvc.pkl"))
    best = min(vals)[1]
    log(f"[train] (d) train() batch {LOOP_BATCH}, full width: {len(steps)} steps in {loop_s:.2f} s "
        f"(with {len(vals)} validations and checkpoint writes); validations (mel err, step) "
        f"{vals}; new bests at steps {[v[1] for v in improved]}; files left {pairs}")
    if not (steps == list(range(LOOP_STEPS + 1)) and state.steps == LOOP_STEPS + 1
            and pairs == [f"do_mix_{best:08d}.knnsvc.pkl", f"g_mix_{best:08d}.knnsvc.pkl"]):
        fail(f"train(): steps {steps}, state.steps {state.steps}, files {pairs}, best {best}")
    del state
    state = train(h_loop, checkpoint_path=os.path.join(root, "train_ckpt2"), training_epochs=1000,
                  validation_interval=1000, summary_interval=1, stdout_interval=1000,
                  max_steps=best + 3, device=dev, resume_from=ckpt, **roots_kw)
    with open(os.path.join(root, "train_ckpt2", "logs", "train_log.jsonl")) as fh:
        resumed = [json.loads(line)["step"] for line in fh]
    log(f"[train] (d) resume_from the step-{best} pair: steps {resumed}, state.steps {state.steps}")
    if not (resumed == [best + 1, best + 2, best + 3] and state.steps == best + 3):
        fail(f"resume did not continue the step count: {resumed}, {state.steps}")
    del state
    wavlm_pkl = os.path.join(root, "train_data", "wavlm.knnsvc.pkl")
    save_params(wavlm_pkl, {"cfg": {}, "model": wparams})
    knn = KnnSvc.load(ckpt, "mix", wavlm_ckpt=wavlm_pkl, device=dev)
    src = os.path.join(roots["valid"], VALID_SINGERS[0][0], f"{VALID_SINGERS[0][0]}_0.wav")
    ref = os.path.join(roots["train"], singer, f"{singer}_1.wav")
    gated_bias_attention_diag.launches = 0
    wav = knn.convert_waveform(src, ref)
    torch.cuda.synchronize()
    out = os.path.join(root, "train_data", "served.wav")
    knn.convert_pair(src, ref, fast=True, output_path=out)
    log(f"[train] (d) KnnSvc.load(ckpt_dir, 'mix') on the trained g_: convert_pair(fast=True) "
        f"wrote {os.path.getsize(out)} bytes; pre-quantize waveform {tuple(wav.shape)}, peak "
        f"{float(wav.abs().max()):.3e}, attention launches {gated_bias_attention_diag.launches} "
        f"for two conversions")
    if not (bool(torch.isfinite(wav).all()) and float(wav.abs().max()) > 0
            and gated_bias_attention_diag.launches == 2 * LAUNCHES_PER_PAIR):
        fail("the trained checkpoint does not serve")
    del knn
    phase_orbax_resume(root, h_loop, roots_kw, dev)
    log(f"[train] training phase in {time.perf_counter() - t_phase:.1f} s")


def _dp_run(h, batches, dev, mesh, double: bool):
    """DP_COMPARE_STEPS train steps from init_train_state(h.seed) on `dev`
    (mesh None) or `mesh`, the modules and batch in float64 when double.
    -> (state, step, metrics per step, first-step gradients, parameters,
    buffers), the arrays on the host in parameters() / buffers() order."""
    import torch

    from knnsvc_torch.config import ModelFamily
    from knnsvc_torch.train.trainer import init_train_state, make_train_step

    state = init_train_state(h.seed, h, ModelFamily.MIX, device=dev)
    modules = (state.generator, state.mpd, state.msd)
    if double:
        batches = [{k: v.double() for k, v in b.items()} for b in batches]
        for m in modules:
            m.double()
    step = make_train_step(h, ModelFamily.MIX, mesh=mesh)
    host = lambda ts: [t.detach().double().cpu().numpy() for t in ts]  # noqa: E731
    metrics = [{k: float(v) for k, v in step(state, batches[0]).items()}]
    grads = host(p.grad for m in modules for p in m.parameters())
    metrics += [{k: float(v) for k, v in step(state, batches[i % 2]).items()}
                for i in range(1, DP_COMPARE_STEPS)]
    return (state, step, metrics, grads, host(p for m in modules for p in m.parameters()),
            host(b for m in modules for b in m.buffers()))


def _dp_compare(one, dp):
    """(metrics, gradients, parameters, buffers) of two runs -> (max
    relative metric diff, max over tensors of the first-step gradient diff
    over the tensor's largest |grad|, parameter |diff|s flattened, max
    buffer |diff|)."""
    import numpy as np

    (one_m, one_g, one_p, one_b), (dp_m, dp_g, dp_p, dp_b) = one, dp
    rel = max(abs(a[k] - b[k]) / abs(b[k]) for a, b in zip(dp_m, one_m) for k in a)
    grad_rel = max(float(np.abs(a - b).max()) / max(float(np.abs(b).max()), 1e-30)
                   for a, b in zip(dp_g, one_g))
    diffs = np.concatenate([np.abs(a - b).ravel() for a, b in zip(dp_p, one_p)])
    buf = max(float(np.abs(a - b).max()) for a, b in zip(dp_b, one_b))
    return rel, grad_rel, diffs, buf


def phase_dp_train(host_batches, dev) -> None:
    """[rest] Data-parallel training at the full-width config of phase 7
    (HiFiGANConfig(), batch 16 x 7040): DP_COMPARE_STEPS steps from one
    seeded state of the one-device step and of the step on a (2, 1)
    logical mesh of the card (two replicas, 8 utterances each):
    (a) in float64, held to tests/test_training.py:101-120's bounds: the
        metrics at DP_METRIC_RTOL, every parameter and spectral-norm buffer
        at DP_PARAM_ATOL, and the first step's gradients at DP_GRAD_RTOL of
        each tensor's largest;
    (b) in float32 under "highest": the metrics at DP_METRIC_RTOL, and the
        parameters within Adam's 2 lr a step, their share past
        DP_PARAM_ATOL and the first-step gradients' difference printed. In
        fp32 the step's own rounding moves the weight-norm gradients of the
        residual convs by ~1e-2 of their largest entry (their values are
        ~1e-6, differences of much larger terms; the one-device step is that
        far from its float64 value too), and Adam's first steps move a
        weight by ~lr * sign(grad), so another summation order parts some
        weights by up to 2 lr a step: the float64 run is the check of the
        data-parallel arithmetic;
    then DP_TIMED_STEPS timed fp32 steps of each, and one step under
    initialize_distributed on a world of 1 over NCCL at 127.0.0.1 (the
    gradient and metric all-reduces on the card) against the plain step,
    the group torn down after."""
    import socket

    import numpy as np
    import torch

    from knnsvc_torch.config import HiFiGANConfig, ModelFamily
    from knnsvc_torch.parallel.mesh import initialize_distributed
    from knnsvc_torch.train.trainer import init_train_state, make_train_step

    t_phase = time.perf_counter()
    h = HiFiGANConfig()
    batches = [{k: torch.from_numpy(v).to(dev) for k, v in b.items()} for b in host_batches]
    audio_s = h.batch_size * h.segment_size / h.sampling_rate
    mesh = logical_mesh(dev, 2, 1)

    t0 = time.perf_counter()
    one = _dp_run(h, batches, dev, None, double=True)[2:]
    dp = _dp_run(h, batches, dev, mesh, double=True)[2:]
    rel, grad_rel, diffs, buf = _dp_compare(one, dp)
    log(f"[rest] dp_train float64, (2, 1) mesh vs one device after {DP_COMPARE_STEPS} steps "
        f"({time.perf_counter() - t0:.1f} s): max relative metric diff {rel:.3e} (tol "
        f"{DP_METRIC_RTOL}); first-step gradients max |diff| / max |grad| per tensor "
        f"{grad_rel:.3e} (tol {DP_GRAD_RTOL}); parameters max |diff| {diffs.max():.3e} over "
        f"{diffs.size} (tol {DP_PARAM_ATOL}); spectral-norm buffers {buf:.3e}")
    if not (rel <= DP_METRIC_RTOL and grad_rel <= DP_GRAD_RTOL and diffs.max() <= DP_PARAM_ATOL
            and buf <= DP_PARAM_ATOL):
        fail(f"the float64 data-parallel step differs from the one-device step: metrics {rel}, "
             f"gradients {grad_rel}, parameters {diffs.max()}, buffers {buf}")
    exact_grads = one[1]          # the one-device step's first gradients in float64
    del one, dp, diffs

    runs = {}
    for name, m in (("one device", None), ("(2, 1) mesh", mesh)):
        state, step, *rest = _dp_run(h, batches, dev, m, double=False)
        torch.cuda.synchronize()
        times = []
        for i in range(DP_TIMED_STEPS):
            t0 = time.perf_counter()
            step(state, batches[i % 2])
            torch.cuda.synchronize()
            times.append(time.perf_counter() - t0)
        runs[name] = (rest, times)
        med = statistics.median(times)
        log(f"[rest] dp_train {name}: {DP_TIMED_STEPS} steps at batch {h.batch_size} x "
            f"{h.segment_size} after {DP_COMPARE_STEPS}: median {1e3 * med:.2f} ms, p90 "
            f"{1e3 * float(np.percentile(times, 90)):.2f} ms, min {1e3 * min(times):.2f} ms = "
            f"{audio_s / med:.2f} audio-s/s; metrics after step {DP_COMPARE_STEPS} "
            f"{json.dumps(rest[0][-1])}")
        del state, step
    (one, one_times), (dp, dp_times) = runs.values()
    one_m = one[0]
    rel, grad_rel, diffs, buf = _dp_compare(one, dp)
    # each fp32 run's first gradients against the float64 one-device step's
    own_err = [max(float(np.abs(a - b).max()) / max(float(np.abs(b).max()), 1e-30)
                   for a, b in zip(run[1], exact_grads)) for run in (one, dp)]
    step_bound = 2 * h.learning_rate * DP_COMPARE_STEPS
    far = diffs > DP_PARAM_ATOL
    log(f"[rest] dp_train float32, (2, 1) mesh vs one device after {DP_COMPARE_STEPS} steps: max "
        f"relative metric diff {rel:.3e} (tol {DP_METRIC_RTOL}); first-step gradients max |diff| "
        f"/ max |grad| per tensor {grad_rel:.3e}, against the float64 step's: one device "
        f"{own_err[0]:.3e}, mesh {own_err[1]:.3e}; parameters max |diff| {diffs.max():.3e} over "
        f"{diffs.size} (bound 2 lr x steps = {step_bound:.1e}), {int(far.sum())} "
        f"({far.mean():.4%}) past {DP_PARAM_ATOL}; spectral-norm buffers {buf:.3e}; step median "
        f"{1e3 * statistics.median(dp_times):.2f} ms against "
        f"{1e3 * statistics.median(one_times):.2f} ms on one device")
    if not (rel <= DP_METRIC_RTOL and diffs.max() <= step_bound * 1.001):
        fail(f"the float32 data-parallel step differs from the one-device step: metrics {rel}, "
             f"parameters {diffs.max()}")
    del runs, one, dp, diffs, exact_grads

    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        port = sock.getsockname()[1]
    t0 = time.perf_counter()
    initialize_distributed(f"127.0.0.1:{port}", 1, 0)
    try:
        init_s = time.perf_counter() - t0
        backend = torch.distributed.get_backend()
        state = init_train_state(h.seed, h, ModelFamily.MIX, device=dev)
        step = make_train_step(h, ModelFamily.MIX)
        t0 = time.perf_counter()
        m = {k: float(v) for k, v in step(state, batches[0]).items()}
        torch.cuda.synchronize()
        nccl_s = time.perf_counter() - t0
        del state, step
    finally:
        torch.distributed.destroy_process_group()
    rel = max(abs(m[k] - one_m[0][k]) / abs(one_m[0][k]) for k in m)
    log(f"[rest] dp_train initialize_distributed(127.0.0.1, world 1): backend {backend}, up in "
        f"{init_s:.2f} s; one step with the all-reduces in {1e3 * nccl_s:.2f} ms (first step "
        f"of its state); metrics {json.dumps(m)}, max relative diff to the plain first step "
        f"{rel:.3e}; group torn down: {not torch.distributed.is_initialized()}")
    if not (backend == "nccl" and rel <= DP_METRIC_RTOL
            and not torch.distributed.is_initialized()):
        fail(f"the NCCL world-1 step: backend {backend}, metrics {rel}")
    log(f"[rest] dp_train phase in {time.perf_counter() - t_phase:.1f} s")


def phase_rest(root: str, knn, records, dev, bulk) -> None:
    """[rest] The modules the JAX package has beside the served and trained
    paths, on the card: the eval harnesses over phase 5's bulk output, the
    training-side modules against the CPU, the StageTimer / MFU table
    around a 30-s pair, and the public functions of the last slice."""
    t_phase = time.perf_counter()
    phase_eval(root, dev, bulk[0])
    phase_side_modules(dev)
    phase_stage_timer(root, knn, dev)
    phase_surface(records, dev)
    log(f"[rest] serving-side phase in {time.perf_counter() - t_phase:.1f} s")


def phase_eval(root: str, dev, data: str) -> None:
    """generate_pair_lists over phase 5's bulk dataset and its fast-loop
    output tree, compute_speaker_similarity with mfcc_stats_embedder on the
    card and on the CPU (EERs equal, every embedding within EMBED_ATOL),
    and spectral_distance / max_waveform_deviation between the card's and
    the CPU's waveforms of phase 3's pair."""
    import functools

    import numpy as np
    import torch

    from knnsvc_torch.eval.pairs import generate_pair_lists
    from knnsvc_torch.eval.regression import max_waveform_deviation, spectral_distance
    from knnsvc_torch.eval.speaker_sim import _load_16k, compute_speaker_similarity
    from knnsvc_torch.eval.speaker_sim import mfcc_stats_embedder

    from pathlib import Path

    out_tree = os.path.join(root, "bulk_fast_1")
    flat = os.path.join(root, "eval", "converted")
    for src_spk in sorted(os.listdir(out_tree)):
        for utt in sorted(os.listdir(os.path.join(out_tree, src_spk))):
            os.makedirs(os.path.join(flat, utt))
            for f in os.listdir(os.path.join(out_tree, src_spk, utt)):
                os.symlink(os.path.join(out_tree, src_spk, utt, f), os.path.join(flat, utt, f))
    t0 = time.perf_counter()
    sim_csv, intelli = generate_pair_lists(data, data, os.path.join(root, "eval", "splits"))
    pairs_s = time.perf_counter() - t0
    with open(sim_csv) as fh:
        n_rows = len(fh.read().splitlines()) - 1
    results = []
    for label, device in (("card", dev), ("cpu", torch.device("cpu"))):
        res_dir = os.path.join(root, "eval", label)
        os.makedirs(res_dir)
        t0 = time.perf_counter()
        sim = compute_speaker_similarity(sim_csv, flat, data,
                                         functools.partial(mfcc_stats_embedder, device=device),
                                         result_dir=res_dir)
        results.append((sim, time.perf_counter() - t0))
    (card, card_s), (cpu, cpu_s) = results
    wavs = sorted(str(p) for p in Path(data).rglob("*.wav")) + sorted(
        str(p) for p in Path(flat).rglob("*.wav"))
    emb = max(float(np.abs(mfcc_stats_embedder(x, device=dev)
                           - mfcc_stats_embedder(x, device="cpu")).max())
              for x in (_load_16k(Path(w).with_suffix("")) for w in wavs))
    eers_equal = bool(np.array_equal(card.to_numpy(), cpu.to_numpy(), equal_nan=True))
    log(f"[rest] eval: generate_pair_lists over the bulk dataset in {1e3 * pairs_s:.2f} ms "
        f"({n_rows} rows); compute_speaker_similarity (mfcc_stats_embedder) card "
        f"{card_s:.3f} s, CPU {cpu_s:.3f} s; EER mean/std card "
        f"{card.to_numpy().ravel().tolist()}, CPU {cpu.to_numpy().ravel().tolist()}, equal "
        f"{eers_equal}; embeddings of {len(wavs)} files card vs CPU max |diff| {emb:.3e} (tol "
        f"{EMBED_ATOL})")
    if not (eers_equal and emb <= EMBED_ATOL and n_rows > 0):
        fail(f"speaker similarity card vs CPU: EERs equal {eers_equal}, embeddings {emb}")
    a, b = os.path.join(root, "slice_card.wav"), os.path.join(root, "slice_cpu.wav")
    t0 = time.perf_counter()
    dev_dist = spectral_distance(a, b, device=dev)
    dist_s = time.perf_counter() - t0
    cpu_dist = spectral_distance(a, b, device="cpu")
    t0 = time.perf_counter()
    dev_max = max_waveform_deviation(a, b)
    max_s = time.perf_counter() - t0
    log(f"[rest] eval: phase 3's {SLICE_SECONDS:.0f}-s pair, card vs CPU output: spectral_distance "
        f"{dev_dist:.6e} on the card ({1e3 * dist_s:.2f} ms), {cpu_dist:.6e} on the CPU; "
        f"max_waveform_deviation {dev_max:.3e} ({1e3 * max_s:.2f} ms)")
    if not (np.isfinite(dev_dist) and abs(dev_dist - cpu_dist) <= 1e-4
            and dev_max <= WAV_REL_TOL):
        fail(f"regression metrics: spectral {dev_dist} / {cpu_dist}, max {dev_max}")


def phase_side_modules(dev) -> None:
    """The harm head, sss_loss, stft_magnitude and harmonic_synth_zero_phase
    on the card against the CPU at full size (a 30-s f0 track, 49
    harmonics, a training batch of 16 x 7040), each timed on the card."""
    import numpy as np
    import torch

    from knnsvc_torch.dsp.stft import stft_magnitude
    from knnsvc_torch.dsp.synth import harmonic_synth_zero_phase
    from knnsvc_torch.io.jax_params import generator_harm_from_numpy
    from knnsvc_torch.models.hifigan.harm_head import init_generator_harm_params
    from knnsvc_torch.train.spectral_losses import sss_loss

    rng = np.random.default_rng(12)
    f0 = sung_wav(FULL_SECONDS, VOICES[0][1], VOICES[0][2])[1][None].astype(np.float32)
    T = f0.shape[1]
    params = init_generator_harm_params(torch.Generator().manual_seed(0), HARM_HIDDEN, 49)
    params["net"]["proj"]["w"] = (rng.standard_normal(params["net"]["proj"]["w"].shape)
                                  * 0.02).astype(np.float32)
    heads = {d.type: generator_harm_from_numpy(params, d) for d in (torch.device("cpu"), dev)}
    harm = rng.standard_normal((1, HARM_HIDDEN, T)).astype(np.float32)
    amp = (rng.random((1, T, 49)) * 0.05).astype(np.float32)
    audio = (rng.standard_normal((2, 16, 7040)) * 0.1).astype(np.float32)
    wav = sung_wav(FULL_SECONDS, VOICES[1][1], VOICES[1][2])[0][None].astype(np.float32)
    cases = [
        ("harm_head", lambda d, x: heads[d.type](x[0][..., None], x[1]), (f0, harm), 2e-4),
        ("sss_loss n_fft=1024", lambda d, x: sss_loss(x[0][0], x[0][1], n_fft=1024), (audio,),
         1e-5),
        ("stft_magnitude 1024/256", lambda d, x: stft_magnitude(x[0], 1024, 256), (wav,), 1e-5),
        ("harmonic_synth_zero_phase", lambda d, x: harmonic_synth_zero_phase(x[0], x[1]),
         (f0, amp), 2e-4),
    ]
    with torch.no_grad():
        for name, fn, inputs, tol in cases:
            cpu_in = [torch.from_numpy(a) for a in inputs]
            dev_in = [a.to(dev) for a in cpu_in]
            want = fn(torch.device("cpu"), cpu_in)
            got = fn(dev, dev_in).cpu()
            scale = max(float(want.abs().max()), 1e-30)
            err = float((got - want).abs().max())
            bound = tol if name.startswith("harm") else tol * scale
            card_ms = cuda_ms(lambda: fn(dev, dev_in), iters=5, warmup=1)
            log(f"[rest] {name} {tuple(want.shape)} card vs CPU: max |diff| {err:.3e} (bound "
                f"{bound:.3e}; max |cpu| {scale:.3e}); card {card_ms:.4f} ms")
            if not (torch.isfinite(got).all() and err <= bound):
                fail(f"{name} differs card vs CPU: {err} > {bound}")


def phase_stage_timer(root: str, knn, dev) -> None:
    """StageTimer around one 30-s pair (the two layer-6 encodes, the
    vocoder on the source's frames, then the whole convert_pair), its
    report and JSON, and format_mfu_table: the encoder's and the
    vocoder's FLOPs (utils/flops.py) over their times against the card's
    fp32 peak (no tensor cores under "highest")."""
    import numpy as np
    import torch

    from knnsvc_torch import HOP_LENGTH
    from knnsvc_torch.match.pool import load_utterance
    from knnsvc_torch.ops.attention import gated_bias_attention_diag
    from knnsvc_torch.utils.flops import (conv_frontend_flops, format_mfu_table, hifigan_flops,
                                          wavlm_encoder_flops)
    from knnsvc_torch.utils.profiling import StageTimer

    pair_dir = os.path.join(root, "stage_timer")
    os.makedirs(pair_dir)
    src, ref = write_pair(pair_dir, FULL_SECONDS, sidecars=True)
    wavs = []
    for path in (src, ref):
        wav = load_utterance(path)
        wavs.append(torch.from_numpy(np.pad(wav, (0, HOP_LENGTH - len(wav) % HOP_LENGTH))[None])
                    .to(dev))
    out = os.path.join(pair_dir, "out.wav")
    knn.convert_pair(src, ref, fast=True, output_path=out)      # warm
    rng = np.random.default_rng(13)
    timer = StageTimer()
    gated_bias_attention_diag.launches = 0
    with torch.no_grad():
        feats = []
        for wav in wavs:
            with timer.stage("wavlm"):
                feats.append(timer.observe(knn.wavlm.extract_layer(wav, 6)))
        T = feats[0].shape[1]
        f0 = torch.from_numpy(sung_wav(FULL_SECONDS, VOICES[0][1], VOICES[0][2])[1][:T]
                              .astype(np.float32)).to(dev)[None, :, None]
        harm = torch.from_numpy((rng.random((1, T, 49)) * 0.05).astype(np.float32)).to(dev)
        for _ in range(2):
            with timer.stage("vocoder"):
                timer.observe(knn.vocoder(feats[0], f0, harm))
        with timer.stage("convert_pair"):
            knn.convert_pair(src, ref, fast=True, output_path=out)
    launches = gated_bias_attention_diag.launches
    cfg, h = knn.wavlm_cfg, knn.h
    enc = sum(conv_frontend_flops(cfg.conv_feature_layers, w.shape[1])[0]
              + wavlm_encoder_flops(cfg.encoder_embed_dim, cfg.encoder_ffn_embed_dim, 6,
                                    conv_frontend_flops(cfg.conv_feature_layers, w.shape[1])[1],
                                    cfg.conv_pos, cfg.conv_pos_groups) for w in wavs)
    voc = 2 * hifigan_flops(h, T, "mix")
    table = format_mfu_table([("wavlm (2 pools)", enc, timer.totals["wavlm"]),
                              ("vocoder (x2)", voc, timer.totals["vocoder"])],
                             PEAK_FP32_FLOPS / 1e12)
    log(f"[rest] StageTimer around a {FULL_SECONDS:.0f}-s pair (attention launches {launches}, "
        f"want {4 * 6}):\n{timer.report()}\n[rest] StageTimer JSON {timer.as_json()}")
    log(f"[rest] MFU against the {PEAK_FP32_FLOPS / 1e12:.0f}-TFLOPS fp32 peak (H100 SXM data "
        f"sheet; card {card_label()}):\n{table}")
    if not (launches == 4 * 6 and timer.counts["wavlm"] == 2 and timer.counts["vocoder"] == 2):
        fail(f"StageTimer pair: {launches} attention launches, counts {dict(timer.counts)}")


def phase_surface(records, dev) -> None:
    """The last slice's public functions on the card. Its path: six layers
    of `knnsvc_torch.ops.gated_bias_attention` with a general (H, T, T) bias
    each, at a 30-s chunk's shape, its count set to 0 just before and read
    just after, against the same chain of plain versions. Then, at a 30-s
    pair's shape card vs CPU: weighted_cosine_distance and
    knn_cosine_similarity (1500 x 1024 queries against a 1500-row pool,
    indices equal), compute_shift on the kNN's top 4 and
    interp_f0_candidates."""
    import numpy as np
    import torch

    from knnsvc_torch import ops
    from knnsvc_torch.match.distance import weighted_cosine_distance
    from knnsvc_torch.match.f0_logic import compute_shift, interp_f0_candidates
    from knnsvc_torch.match.knn import knn_cosine_similarity
    from knnsvc_torch.ops.attention import reference_attention

    gen = torch.Generator().manual_seed(3)
    H, T, d = ATTN_MAIN
    q, k, v, _, gate = attention_inputs(gen, dev, H, T, d)
    biases = [torch.randn(H, T, T, generator=gen).to(dev) for _ in range(SURFACE_LAYERS)]
    torch.cuda.synchronize()
    ops.gated_bias_attention.launches = 0
    t0 = time.perf_counter()
    xs = [q]
    for bias in biases:
        xs.append(ops.gated_bias_attention(xs[-1], k, v, bias, gate))
    torch.cuda.synchronize()
    wall_ms = 1e3 * (time.perf_counter() - t0)
    launches = ops.gated_bias_attention.launches
    # each layer against the plain version on the same input
    err = max(float((out - reference_attention(x, k, v, bias, gate)).abs().max())
              for x, out, bias in zip(xs, xs[1:], biases))
    log(f"[rest] surface: {SURFACE_LAYERS} layers of gated_bias_attention with a full bias at "
        f"{ATTN_MAIN}: {launches} launches in {wall_ms:.3f} ms; each layer against the plain "
        f"version max_abs_err={err:.3e} (atol {ATTN_ATOL_MAIN})")
    if not (launches == SURFACE_LAYERS and err <= ATTN_ATOL_MAIN
            and bool(torch.isfinite(xs[-1]).all())):
        fail(f"the full-bias attention path: {launches} launches, error {err}")
    records["gated_bias_attention"]["launches"] = launches

    rng = np.random.default_rng(15)
    Q, P, D = CONCAT_MAIN
    src = rng.standard_normal((Q, D)).astype(np.float32)
    pool = rng.standard_normal((P, D)).astype(np.float32)
    weights = rng.random((Q, D)).astype(np.float32)
    mask = (rng.random((Q, P)) < 0.9).astype(np.float32)
    query_f0 = sung_wav(FULL_SECONDS, VOICES[0][1], VOICES[0][2])[1][:Q].astype(np.float32)
    pool_f0 = sung_wav(FULL_SECONDS, VOICES[1][1], VOICES[1][2])[1][:P].astype(np.float32)
    xp = np.sort(rng.random((Q, 8)) * 900 + 60, axis=1).astype(np.float32)
    fp = rng.standard_normal((Q, 8, 4)).astype(np.float32)
    # the kNN's inputs: a 1/8 grid plus noise under fp16's half step there,
    # which the fp16 rounding removes; every product and sum is then exact in
    # fp32 on both sides, so the indices must be equal, ties included
    grid_src, grid_pool = (np.round(a * 16) / 8 for a in (src, pool))
    noisy_src, noisy_pool = ((g + (g != 0) * rng.uniform(-1e-5, 1e-5, g.shape)).astype(np.float32)
                             for g in (grid_src, grid_pool))
    cases = [
        ("weighted_cosine_distance", weighted_cosine_distance, (src, pool, weights)),
        ("weighted_cosine_distance (no weights)", weighted_cosine_distance, (src, pool)),
        ("knn_cosine_similarity", lambda a, b, m: knn_cosine_similarity(a, b, m, k=32),
         (noisy_src, noisy_pool, mask)),
        ("interp_f0_candidates", interp_f0_candidates, (query_f0, xp, fp)),
    ]
    results = {}
    with torch.no_grad():
        for name, fn, inputs in cases:
            cpu_in = [torch.from_numpy(a) for a in inputs]
            dev_in = [a.to(dev) for a in cpu_in]
            want, got = fn(*cpu_in), fn(*dev_in)
            card_ms = cuda_ms(lambda: fn(*dev_in), iters=5, warmup=1)
            if name == "knn_cosine_similarity":
                results[name] = got
                same = bool(torch.equal(got[0].cpu(), want[0]))
                err = float((got[1].cpu() - want[1]).abs().max())
                log(f"[rest] surface: {name} {tuple(want[0].shape)} card vs CPU: indices equal "
                    f"{same}, distances max |diff| {err:.3e} (bound {SURFACE_ATOL}); card "
                    f"{card_ms:.4f} ms")
                ok = same and err <= SURFACE_ATOL
            else:
                err = float((got.cpu() - want).abs().max())
                scale = float(want.abs().max())
                log(f"[rest] surface: {name} {tuple(want.shape)} card vs CPU: max |diff| "
                    f"{err:.3e} (bound {SURFACE_ATOL * max(scale, 1.0):.3e}); card "
                    f"{card_ms:.4f} ms")
                ok = bool(torch.isfinite(got).all()) and err <= SURFACE_ATOL * max(scale, 1.0)
            if not ok:
                fail(f"{name} differs card vs CPU")
        idx = results["knn_cosine_similarity"][0][:, :4]
        args = [torch.from_numpy(query_f0), torch.from_numpy(pool_f0), idx.cpu()]
        want = compute_shift(*args)
        got = compute_shift(*(a.to(dev) for a in args))
        rel = abs(float(got) - float(want)) / abs(float(want))
        log(f"[rest] surface: compute_shift over the kNN's top 4 card vs CPU: {float(got):.7f} "
            f"vs {float(want):.7f} (relative {rel:.2e}, bound 1e-5)")
        if not rel <= 1e-5:
            fail(f"compute_shift differs card vs CPU: {float(got)} vs {float(want)}")


def card_label() -> str:
    """nvidia-smi's name and power limit of the card."""
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60)
    return smi.stdout.strip().splitlines()[0] if smi.returncode == 0 else "nvidia-smi failed"


def phase_train_profile(state, h, batches, label: str, compute_dtype, top: bool) -> None:
    """One warm full-width train step traced with torch.profiler: device
    busy share, the device time launched from the knnsvc.d_step and
    knnsvc.g_step spans (by launch time: the backward's kernels are
    launched from autograd's thread while the span is open), and with top
    the 10 device ops that take the most time."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from knnsvc_torch.config import ModelFamily
    from knnsvc_torch.train.trainer import make_train_step

    step = make_train_step(h, ModelFamily.MIX, compute_dtype=compute_dtype)
    step(state, batches[0])
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        step(state, batches[1])
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    events = prof.events()
    dev_events = device_events(events)
    if not dev_events:
        log(f"[profile] train step ({label}): the trace holds no device events: busy share "
            "not measured")
        return
    spans = sorted((e.time_range.start, e.time_range.end, e.name) for e in dev_events)
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
    windows = {name: [(e.time_range.start, e.time_range.end) for e in events
                      if e.device_type == DeviceType.CPU and e.name == f"knnsvc.{name}"]
               for name in ("d_step", "g_step")}
    runtime = {e.id: e for e in events if e.device_type == DeviceType.CPU and e.name.startswith("cu")}
    split = {"d_step": 0.0, "g_step": 0.0, "other": 0.0}
    for e in dev_events:
        launch = runtime.get(e.id)
        t = launch.time_range.start if launch is not None else e.time_range.start
        name = next((n for n, ws in windows.items() if any(a <= t <= b for a, b in ws)), "other")
        split[name] += e.time_range.elapsed_us()
    total = sum(split.values())
    log(f"[profile] train step ({label}, full width, batch {h.batch_size}): wall "
        f"{wall_us / 1e3:.2f} ms, device busy {busy / 1e3:.2f} ms ({busy / wall_us:.1%}), idle "
        f"share {1 - busy / wall_us:.1%}, {len(spans)} device events; device ms by span "
        + json.dumps({k: [round(v / 1e3, 3), round(v / total, 4)] for k, v in split.items()}))
    for name, (us, n) in sorted(by_name.items(), key=lambda kv: -kv[1][0])[:10 if top else 0]:
        log(f"[profile]   {us / 1e3:8.3f} ms x{n:<5d} {name[:100]}")


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


def phase_profile(knn, src: str, ref: str, out: str, label: str,
                  post_opt: str = "no_post_opt", upload_dtype: str = "float32",
                  **pair_kw) -> None:
    """One more warm convert_pair traced with torch.profiler (CUPTI): the
    device busy share, device time by kernel, and the per-stage split read
    from the knnsvc.* spans. A trace without device events is reported as
    not measured."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        knn.convert_pair(src, ref, fast=True, post_opt=post_opt, output_path=out,
                         upload_dtype=upload_dtype, **pair_kw)
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
    log(f"[profile] {label}: stages (host ms in span, device kernel ms; concat_cost, "
        f"smoothness, sharded_knn and shard_gather nest in match, f0_device (and f0_viterbi "
        f"in it) in pool_build, whose host ms include theirs) " + json.dumps(
        {k: [round(h, 3), round(d, 3)] for k, (h, d) in stages.items()}))
    for kernel in ("gated_bias_attention", "concat_cost", "f0_viterbi"):
        us = sum(v[0] for k, v in by_name.items() if kernel in k)
        log(f"[profile] {label}: {kernel} {us / 1e3:.2f} ms ({us / busy:.1%} of device busy)")
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
    ptxas = phase_build()
    records = {"gated_bias_attention_diag": phase_kernels(dev),
               "gated_bias_attention": phase_attention_full(dev),
               "concat_cost_pair": phase_concat_kernel(dev),
               "f0_viterbi": phase_viterbi_kernel(dev, ptxas["f0_viterbi"])}
    records["concat_cost_pair"].update(phase_concat_sharded(dev))
    phase_reach(dev, ptxas["f0_viterbi"], records)
    root = tempfile.mkdtemp(prefix="knnsvc_smoke_")
    try:
        knn, cpu = phase_slice_cpu_vs_cuda(root, dev)
        phase_stream_slice(root, knn, cpu)
        del cpu
        phase_full(root, knn, records, dev)
        phase_mp3(root, knn, repo)
        phase_orbax(root, repo, dev)
        bulk = phase_bulk(root, knn, records, dev)
        phase_stream(root, knn, records, dev)
        phase_sharded(root, knn, records, dev, bulk)
        phase_rest(root, knn, records, dev, bulk)
        del knn
        phase_train(root, records, dev)
    finally:
        shutil.rmtree(root, ignore_errors=True)

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60)
    if smi.returncode != 0 or not smi.stdout.strip():
        fail(f"nvidia-smi failed: {smi.stderr.strip()}")
    log("kernels: " + " ".join(f"{r['name']}={r['launches']}" for r in records.values())
        + " (each on its path: the diagonal and concat entries on one post_opt pair, the "
        "Viterbi on one device-f0 pair, the full-bias entry on the [rest] surface drive)")
    for r in records.values():
        if not r["launches"]:
            fail(f"{r['name']} was not launched on its path")
    log(f"[done] all phases in {time.perf_counter() - t_all:.1f} s")
    print(smi.stdout.strip().splitlines()[0], flush=True)
    print(json.dumps({"kernels": list(records.values())}), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
