"""Conversion CLI of the port, pair mode (counterpart of
knnsvc_tpu/cli/inference.py; the reference's ddsp_inference.py surface):

  python -m knnsvc_torch.cli.inference SRC.wav TGT.wav --fast true \
      --ckpt_dir D --ckpt_type mix --topk 4 --out OUT.wav [--device cuda]

Runs on --device cuda (the default; no card -> error, never a silent CPU
run) or --device cpu. Ported so far: file -> file (WAV or FLAC) with --fast
true, every --ckpt_type, matcher exact/approx, with or without --post_opt
(e.g. post_opt_0.2), --f0_method device, --upload_depth int16, and
--tgt_loudness_db with --apply_loudness true; .pt or .knnsvc.pkl
checkpoints. Bulk (folder) mode, the host-pool path and the streaming path
are still to port and exit with a message.
"""

from __future__ import annotations

import argparse
import os


def str2bool(v: str) -> bool:
    v = v.lower()
    if v in ("yes", "true", "t", "1", "y"):
        return True
    if v in ("no", "false", "f", "0", "n"):
        return False
    raise argparse.ArgumentTypeError("boolean value expected")


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(description="kNN-SVC inference (PyTorch/CUDA port), pair mode")
    parser.add_argument("src", help="content source audio file (WAV or FLAC)")
    parser.add_argument("tgt", help="style target audio file (WAV or FLAC)")
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
    parser.add_argument("--topk", type=int, default=4)
    parser.add_argument("--matcher", type=str, default="exact",
                        choices=["exact", "approx", "int8", "sharded", "sharded_int8"],
                        help="kNN candidate search; exact and approx (both exact on a GPU) "
                             "are ported")
    parser.add_argument("--precision", type=str, default="highest",
                        choices=["highest", "fastest"],
                        help="highest = fp32 with TF32 off in cuBLAS and cuDNN; "
                             "fastest = TF32 allowed")
    parser.add_argument("--tgt_loudness_db", type=float, default=-16)
    parser.add_argument("--apply_loudness", type=str2bool, default=False,
                        help="normalize the output to --tgt_loudness_db (the reference keeps "
                             "it disabled)")
    parser.add_argument("--f0_method", default="fast",
                        choices=["fast", "harvest", "dio", "yin", "device"],
                        help="f0 extractor of the --fast path: 'fast' = native budget Harvest "
                             "on a background host thread; 'device' = the extractor on the "
                             "card inside the pool build (no host work)")
    parser.add_argument("--upload_depth", choices=["float32", "int16"], default="float32",
                        help="--fast: int16 halves the waveform uploads (lossless for "
                             "16-bit-sourced audio)")
    parser.add_argument("--fast", type=str2bool, default=False,
                        help="device-resident serving path (the only one ported so far)")
    parser.add_argument("--random_init", type=str2bool, default=False,
                        help="random full-size weights (smoke tests; no checkpoints needed)")
    parser.add_argument("--out", type=str, default=None,
                        help="output path (default: next to the source file, "
                             "ref ddsp_matcher.py:1013-1023)")
    parser.add_argument("--device", type=str, default="cuda", help="cuda or cpu")
    return parser


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    if not (os.path.isfile(args.src) and os.path.isfile(args.tgt)):
        raise SystemExit("knnsvc_torch converts file -> file pairs; bulk (folder) mode "
                         "is still to port")

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
    out = knn.convert_pair(args.src, args.tgt, topk=args.topk, post_opt=args.post_opt,
                           tgt_loudness_db=args.tgt_loudness_db if args.apply_loudness else None,
                           matcher=args.matcher, fast=args.fast, output_path=args.out,
                           upload_dtype=args.upload_depth)
    print("->", out)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
