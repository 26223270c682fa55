"""Vocoder training CLI of the port (counterpart of knnsvc_tpu/cli/train.py;
the reference's `python -m hifigan.ddsp_train` surface, ref
hifigan/ddsp_train.py:394-440):

  python -m knnsvc_torch.cli.train --audio_root_path_train ... \
      --feature_root_path_train ... --audio_root_path_valid ... \
      --feature_root_path_valid ... --checkpoint_path ... \
      --config config_v1_wavlm.json --fine_tuning [--device cuda]

One device: --device cuda (the default; no card -> error) or --device cpu.
--precision highest | high | fastest (precision.py) replaces the
reference's fp16 GradScaler flags.
"""

from __future__ import annotations

import argparse


def main(argv=None) -> int:
    parser = argparse.ArgumentParser()
    parser.add_argument("--group_name", default=None)
    parser.add_argument("--audio_root_path_train", required=True)
    parser.add_argument("--audio_root_path_valid", required=True)
    parser.add_argument("--feature_root_path_train", required=True)
    parser.add_argument("--feature_root_path_valid", required=True)
    parser.add_argument("--checkpoint_path", default="cp_hifigan")
    parser.add_argument("--config", default=None)
    parser.add_argument("--training_epochs", default=1800, type=int)
    parser.add_argument("--stdout_interval", default=25, type=int)
    parser.add_argument("--summary_interval", default=25, type=int)
    parser.add_argument("--validation_interval", default=1000, type=int)
    parser.add_argument("--fine_tuning", action="store_true",
                        help="accepted for compatibility (fine-tuning is the only mode, as in "
                             "the reference)")
    parser.add_argument("--precision", type=str, default="highest",
                        choices=["highest", "high", "fastest"])
    parser.add_argument("--resume_from", type=str, default=None,
                        help="checkpoint dir with g_/do_ pairs to restore from "
                             "(the reference scans but force-disables this, ddsp_train.py:118)")
    parser.add_argument("--device", type=str, default="cuda", help="cuda (default) or cpu")
    args = parser.parse_args(argv)

    from knnsvc_torch.precision import set_precision

    set_precision(args.precision)

    from knnsvc_torch.config import HiFiGANConfig
    from knnsvc_torch.train.loop import train

    h = HiFiGANConfig() if args.config is None else HiFiGANConfig.from_json(args.config)
    train(
        h,
        audio_root_train=args.audio_root_path_train,
        feat_root_train=args.feature_root_path_train,
        audio_root_valid=args.audio_root_path_valid,
        feat_root_valid=args.feature_root_path_valid,
        checkpoint_path=args.checkpoint_path,
        training_epochs=args.training_epochs,
        validation_interval=args.validation_interval,
        summary_interval=args.summary_interval,
        stdout_interval=args.stdout_interval,
        resume_from=args.resume_from,
        device=args.device,
    )
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
