"""Offline prematch extraction CLI of the port (counterpart of
knnsvc_tpu/cli/prematch.py; the reference's `python ddsp_prematch_dataset.py`
surface, ref :1797-1811):

  python -m knnsvc_torch.cli.prematch --librispeech_path DATA --out_path OUT \
      --matching_layer 6 --synthesis_layer 6 --prematch [--device cuda]

Runs on --device cuda (the default; no card -> error) or --device cpu. The
WavLM weights come from --wavlm_ckpt (a torch WavLM-Large.pt or a
.knnsvc.pkl) or, without it, a random init from --seed.
"""

from __future__ import annotations

import argparse


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(
        description="Compute prematched wavlm features for a dataset of speaker folders")
    parser.add_argument("--librispeech_path", required=True, type=str)
    parser.add_argument("--seed", default=123, type=int)
    parser.add_argument("--out_path", required=True, type=str)
    parser.add_argument("--device", default="cuda", type=str, help="cuda (default) or cpu")
    parser.add_argument("--topk", type=int, default=4)
    parser.add_argument("--matching_layer", type=int, default=6)
    parser.add_argument("--synthesis_layer", type=int, default=6)
    parser.add_argument("--prematch", action="store_true")
    parser.add_argument("--resume", action="store_true")
    parser.add_argument("--wavlm_ckpt", type=str, default=None,
                        help="WavLM-Large.pt (torch) or .knnsvc.pkl pytree; random init if omitted")
    args = parser.parse_args(argv)

    import numpy as np
    import torch

    from knnsvc_torch.config import WavLMConfig
    from knnsvc_torch.hub import resolve_device
    from knnsvc_torch.train.prematch import per_spk_extract
    from knnsvc_torch.utils.layer_weights import generate_matrix_from_index

    resolve_device(args.device)
    match_w = generate_matrix_from_index(args.matching_layer)
    synth_w = generate_matrix_from_index(args.synthesis_layer)
    print(f"Matching weightings: {match_w}\nSynthesis weightings: {synth_w}")

    if args.wavlm_ckpt is None:
        from knnsvc_torch.models.wavlm.model import init_wavlm_params

        cfg = WavLMConfig()
        params = init_wavlm_params(cfg, torch.Generator().manual_seed(args.seed))
        print("WARNING: random-init WavLM (no --wavlm_ckpt given)")
    elif args.wavlm_ckpt.endswith(".knnsvc.pkl"):
        from knnsvc_torch.io.checkpoints import load_params

        payload = load_params(args.wavlm_ckpt)
        if isinstance(payload, dict) and "model" in payload:
            # {'cfg': dict, 'model': params}, the torch checkpoint's own shape
            params, cfg = payload["model"], WavLMConfig.from_dict(payload.get("cfg") or {})
        else:
            params, cfg = payload, WavLMConfig()
    else:
        from knnsvc_torch.io.checkpoints import load_wavlm_checkpoint

        params, cfg = load_wavlm_checkpoint(args.wavlm_ckpt)

    np.random.seed(args.seed)
    per_spk_extract(args.librispeech_path, args.out_path, params, cfg, match_w, synth_w,
                    save_pool_only=not args.prematch, topk=args.topk, device=args.device)
    print("All done!", flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
