"""Conversion CLI of the port (counterpart of knnsvc_tpu/cli/inference.py;
the reference's ddsp_inference.py surface):

  python -m knnsvc_torch.cli.inference SRC TGT --ckpt_dir D --ckpt_type mix \
      --post_opt post_opt_0.2 --topk 4 [--fast true] [--device cuda]

Both positionals are files (pair mode: WAV or FLAC, written to --out or next
to the source) or both are dataset roots of speaker folders (folder mode:
written under <tgt parent>/[duration_limit_N_]<src>_to_<tgt>_<ckpt_type>_
post_opt_<post_opt>/, ref ddsp_inference.py:79-103). --fast false (the
default) is the host-pool path, --fast true the device-resident one, and
--stream_chunk_s S (pair mode) the streaming path (KnnSvc.stream_convert:
--stream_context_s, --stream_right_context_s, --stream_encoder
windowed|cached, --stream_cache_s, --f0_method); every --ckpt_type; matcher
exact, approx (both exact search here), int8 (host-pool path), sharded or
sharded_int8 (every mode: the target pool sharded over every visible card,
or the CPU; sharded_int8 serves no_post_opt only); .pt or .knnsvc.pkl
checkpoints. Runs on --device cuda (the default; no card -> error, never a
silent CPU run) or --device cpu.
"""

from __future__ import annotations

import argparse
import os
import sys

STREAM_DEFAULTS = {"stream_chunk_s": None, "stream_context_s": 1.0,
                   "stream_right_context_s": None, "stream_encoder": "windowed",
                   "stream_cache_s": 4.0}


def str2bool(v: str) -> bool:
    v = v.lower()
    if v in ("yes", "true", "t", "1", "y"):
        return True
    if v in ("no", "false", "f", "0", "n"):
        return False
    raise argparse.ArgumentTypeError("boolean value expected")


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(
        description="kNN-SVC inference (PyTorch/CUDA port): file or folder mode")
    parser.add_argument("src", help="content source: audio file OR dataset root of speaker folders")
    parser.add_argument("tgt", help="style target: audio file OR dataset root of speaker folders")
    parser.add_argument("--ckpt_dir", type=str, default=None,
                        help="directory holding the HiFi-GAN checkpoint (g_*.pt or .knnsvc.pkl)")
    parser.add_argument("--wavlm_ckpt", type=str, default=None,
                        help="WavLM .pt or .knnsvc.pkl file (default: <ckpt_dir>/WavLM-Large.pt)")
    parser.add_argument("--config", type=str, default=None, help="HiFi-GAN config json")
    parser.add_argument("--ckpt_type", type=str, default="mix",
                        help="mix, mix_harm_no_amp_*, mix_no_harm_no_amp_*, wavlm_only, "
                             "wavlm_only_original")
    parser.add_argument("--post_opt", type=str, default="no_post_opt",
                        help="no_post_opt, post_opt_<w> (concat weight w + smoothness "
                             "optimizer), post_opt_extra (w = 0.3) or no_post_opt_<w> "
                             "(concat only)")
    parser.add_argument("--required_subset_file", type=str, default=None,
                        help="folder mode: CSV of the (source utterance, target speaker) "
                             "pairs to convert")
    parser.add_argument("--topk", type=int, default=4)
    parser.add_argument("--prioritize_f0", type=str2bool, default=True,
                        help="must stay true (the reference asserts it)")
    parser.add_argument("--dur_limit", type=int, default=None,
                        help="folder mode: duration limit (s) of each target pool")
    parser.add_argument("--resume", type=str2bool, default=False,
                        help="folder mode: skip outputs that already exist")
    parser.add_argument("--pool_cache_dir", type=str, default=None,
                        help="folder mode, --fast false: on-disk speaker-pool cache")
    parser.add_argument("--matcher", type=str, default="exact",
                        choices=["exact", "approx", "int8", "sharded", "sharded_int8"],
                        help="kNN candidate search: exact, approx (exact search on a GPU), "
                             "int8 (quantized pool, --fast false, no streaming), sharded (the "
                             "target pool sharded over every visible card), sharded_int8 (int8 "
                             "matching rows AND sharded: P/(4n) bytes per card; no_post_opt)")
    parser.add_argument("--precision", type=str, default="highest",
                        choices=["highest", "high", "fastest"],
                        help="highest = fp32 with TF32 off in cuBLAS and cuDNN; high = TF32 "
                             "allowed, the attention kernel kept at 3xTF32; fastest = TF32 "
                             "allowed")
    parser.add_argument("--tgt_loudness_db", type=float, default=-16)
    parser.add_argument("--apply_loudness", type=str2bool, default=False,
                        help="normalize the output to --tgt_loudness_db (the reference keeps "
                             "it disabled)")
    parser.add_argument("--f0_method", default="fast",
                        choices=["fast", "harvest", "dio", "yin", "device"],
                        help="--fast true and --stream_chunk_s: f0 extractor. 'fast' = "
                             "native budget Harvest on a background host thread; 'device' = "
                             "the extractor on the card inside the pool build (no host "
                             "work; the cached stream encoder takes 'fast' per window). "
                             "--fast false takes Harvest")
    parser.add_argument("--upload_depth", choices=["float32", "int16"], default="float32",
                        help="--fast true pair mode: int16 halves the waveform uploads "
                             "(lossless for 16-bit-sourced audio)")
    parser.add_argument("--fast", type=str2bool, default=False,
                        help="device-resident path (pools, match and vocode on the device, "
                             "int16 downloads); false = the host-pool path")
    parser.add_argument("--random_init", type=str2bool, default=False,
                        help="random full-size weights (smoke tests; no checkpoints needed)")
    parser.add_argument("--out", type=str, default=None,
                        help="pair mode: output path (default: next to the source file, "
                             "ref ddsp_matcher.py:1013-1023)")
    parser.add_argument("--device", type=str, default="cuda", help="cuda or cpu")
    parser.add_argument("--stream_chunk_s", type=float, default=None,
                        help="pair mode only: convert through the streaming path in chunks of "
                             "this many seconds (KnnSvc.stream_convert)")
    parser.add_argument("--stream_context_s", type=float, default=1.0,
                        help="streaming: context before (and, by default, after) each chunk")
    parser.add_argument("--stream_right_context_s", type=float, default=None,
                        help="streaming: lookahead after each chunk, the only context that "
                             "adds latency (default: --stream_context_s)")
    parser.add_argument("--stream_encoder", default="windowed", choices=("windowed", "cached"),
                        help="streaming: 'windowed' encodes each context window, 'cached' only "
                             "each chunk's new frames over a K/V cache")
    parser.add_argument("--stream_cache_s", type=float, default=4.0,
                        help="streaming, cached encoder: seconds of final frames kept as "
                             "attention context")
    return parser


def _warn_ignored(flag: str, path: str) -> None:
    print(f"warning: {flag} is ignored by {path}", file=sys.stderr)


def _check_args(args) -> str:
    """Argument checks before the model load, and one warning line on stderr
    for each flag that the chosen path ignores. -> 'pair', 'stream' or
    'folder'."""
    streaming = args.stream_chunk_s is not None
    if streaming:
        # the JAX CLI's own checks (knnsvc_tpu/cli/inference.py:121-133)
        if args.matcher not in ("exact", "approx", "sharded", "sharded_int8"):
            raise SystemExit(f"--stream_chunk_s supports --matcher "
                             f"exact|approx|sharded|sharded_int8, not {args.matcher!r}")
        if args.matcher == "sharded_int8" and args.post_opt != "no_post_opt":
            raise SystemExit("--matcher sharded_int8 streams no_post_opt configs only "
                             "(concat/smoothness read fp32 matching rows; use --matcher "
                             "sharded)")
        if os.path.isdir(args.src) or os.path.isdir(args.tgt):
            raise SystemExit("--stream_chunk_s applies to pair (file-file) mode only; bulk "
                             "mode converts whole utterances")
    if os.path.isfile(args.src) and os.path.isfile(args.tgt):
        mode = "stream" if streaming else "pair"
    elif os.path.isdir(args.src) and os.path.isdir(args.tgt):
        mode = "folder"
    else:
        raise SystemExit("Both inputs must be files or both must be folders.")
    # a flag that the chosen path ignores is read and ignored, as the JAX CLI
    # does (knnsvc_tpu/cli/inference.py:145-170), with one warning line
    set_stream = [f"--{k}" for k, v in STREAM_DEFAULTS.items() if getattr(args, k) != v]
    if set_stream and not streaming:
        _warn_ignored(", ".join(set_stream), "every path but streaming (no --stream_chunk_s)")
    if not (args.fast or streaming) and args.f0_method != "fast":
        _warn_ignored(f"--f0_method {args.f0_method}", "the host-pool path (--fast false), "
                      "which takes Harvest f0 or its _f0.npy sidecar")
    if args.upload_depth != "float32" and (not args.fast or mode != "pair"):
        path = ("the streaming path" if mode == "stream" else "folder mode"
                if mode == "folder" else "the host-pool path (--fast false)")
        _warn_ignored(f"--upload_depth {args.upload_depth}", path)
    return mode


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    mode = _check_args(args)

    from knnsvc_torch.hub import KnnSvc
    from knnsvc_torch.precision import set_precision

    set_precision(args.precision)
    if args.random_init:
        knn = KnnSvc.random_init(args.ckpt_type, device=args.device)
    else:
        if args.ckpt_dir is None:
            raise SystemExit("--ckpt_dir is required unless --random_init true")
        knn = KnnSvc.load(args.ckpt_dir, args.ckpt_type, args.wavlm_ckpt, args.config,
                          device=args.device)
    knn.f0_method = args.f0_method
    loudness = args.tgt_loudness_db if args.apply_loudness else None

    if mode == "stream":
        out = knn.stream_convert(
            args.src, args.tgt, output_path=args.out, tgt_loudness_db=loudness,
            chunk_s=args.stream_chunk_s, context_s=args.stream_context_s, topk=args.topk,
            prioritize_f0=args.prioritize_f0, post_opt=args.post_opt, matcher=args.matcher,
            right_context_s=args.stream_right_context_s, encoder=args.stream_encoder,
            cache_s=args.stream_cache_s)
        print("->", out)
        return 0
    if mode == "pair":
        out = knn.convert_pair(args.src, args.tgt, topk=args.topk,
                               prioritize_f0=args.prioritize_f0, post_opt=args.post_opt,
                               tgt_loudness_db=loudness, matcher=args.matcher, fast=args.fast,
                               output_path=args.out, upload_dtype=args.upload_depth)
        print("->", out)
        return 0

    tgt_parent = f"{os.path.dirname(os.path.abspath(args.tgt))}/"
    converted_audio_dir = (f"{tgt_parent}{os.path.basename(args.src)}_to_"
                           f"{os.path.basename(args.tgt)}_{args.ckpt_type}_post_opt_"
                           f"{args.post_opt}/")
    if args.dur_limit is not None:
        converted_audio_dir = converted_audio_dir.replace(
            tgt_parent, tgt_parent + f"duration_limit_{args.dur_limit}_")
    written = knn.bulk_convert(
        src_dataset_path=args.src, tgt_dataset_path=args.tgt,
        converted_audio_dir=converted_audio_dir, topk=args.topk,
        prioritize_f0=args.prioritize_f0, post_opt=args.post_opt,
        required_subset_file=args.required_subset_file, duration_limit=args.dur_limit,
        tgt_loudness_db=loudness, resume=args.resume, pool_cache_dir=args.pool_cache_dir,
        matcher=args.matcher, fast=args.fast)
    print(f"wrote {len(written)} files under {converted_audio_dir}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
