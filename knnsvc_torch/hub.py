"""Model wrapper + factory (counterpart of knnsvc_tpu/hub.py::KnnSvc; the
reference's KNeighborsVC / ddsp_hubconf surface, ref ddsp_matcher.py:303-1156).

Ported so far: the constructor, `random_init`, `load` for `.knnsvc.pkl`
payloads, and `convert_pair(fast=True)` — the single-pair serving path for
the MIX and F0_ONLY families without post_opt. Everything runs on
device="cuda" unless the caller passes device="cpu".
"""

from __future__ import annotations

import glob
import os
from pathlib import Path

import numpy as np
import torch
from torch.profiler import record_function

from knnsvc_torch import HOP_LENGTH, SPEAKER_INFORMATION_LAYER
from knnsvc_torch.config import (HiFiGANConfig, PostOpt, WavLMConfig,
                                 model_family_for_ckpt_type)
from knnsvc_torch.io.audio import save_audio
from knnsvc_torch.io.jax_params import generator_from_numpy, load_params, wavlm_from_numpy
from knnsvc_torch.precision import apply_precision
from knnsvc_torch.utils.layer_weights import generate_matrix_from_index


def resolve_device(device: str | torch.device) -> torch.device:
    """The device to run on; a CUDA request without a card raises instead of
    falling back to the CPU."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "knnsvc_torch: device='cuda' was requested but torch sees no CUDA "
            "device; pass device='cpu' to run on the CPU")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"knnsvc_torch runs on 'cuda' or 'cpu', not {dev}")
    return dev


class KnnSvc:
    """kNN-SVC conversion engine (ref KNeighborsVC). Takes the JAX package's
    parameter pytrees (numpy) and builds the port's modules on `device`."""

    def __init__(self, wavlm_params, wavlm_cfg: WavLMConfig, hifigan_params,
                 hifigan_cfg: HiFiGANConfig, ckpt_type: str = "mix",
                 device: str | torch.device = "cuda"):
        self.device = resolve_device(device)
        apply_precision()
        self.wavlm_cfg = wavlm_cfg
        self.h = hifigan_cfg
        self.ckpt_type = ckpt_type
        self.family = model_family_for_ckpt_type(ckpt_type)
        self.wavlm = wavlm_from_numpy(wavlm_params, wavlm_cfg, self.device)
        self.vocoder = generator_from_numpy(hifigan_params, hifigan_cfg, self.family,
                                            self.device)
        self.sr = hifigan_cfg.sampling_rate
        self.hop_length = HOP_LENGTH
        self.weighting = generate_matrix_from_index(SPEAKER_INFORMATION_LAYER)
        # the fast path's host f0 extractor: 'fast' (native budget Harvest on
        # a background thread), or 'harvest' / 'dio' / 'yin'
        self.f0_method = "fast"

    # ------------------------------------------------------------- factory

    @classmethod
    def load(cls, ckpt_dir: str, ckpt_type: str = "mix", wavlm_ckpt: str | None = None,
             config_path: str | None = None, device: str | torch.device = "cuda") -> "KnnSvc":
        """Build from `.knnsvc.pkl` files (pickled numpy pytrees written by
        the JAX package): the HiFi-GAN file is the latest match of
        `*<ckpt_type>*` in ckpt_dir that is not a `do_` (discriminator) file
        and dispatches to the same model family; the WavLM file is
        `wavlm_ckpt`. Torch `.pt` checkpoints and orbax directories are not
        ported yet."""
        h = HiFiGANConfig() if config_path is None else HiFiGANConfig.from_json(config_path)
        family = model_family_for_ckpt_type(ckpt_type)
        matches = [p for p in glob.glob(os.path.join(ckpt_dir, f"*{ckpt_type}*"))
                   if not os.path.basename(p).startswith("do_")
                   and model_family_for_ckpt_type(os.path.basename(p)) == family]
        cp_g = sorted(matches)[-1] if matches else None
        if cp_g is None:
            raise FileNotFoundError(f"no checkpoint matching *{ckpt_type}* in {ckpt_dir}")
        if not cp_g.endswith(".knnsvc.pkl"):
            raise NotImplementedError(
                f"{cp_g}: loading torch .pt and orbax checkpoints is still to port "
                "(ROADMAP.md, Queue 1 item 1); convert to .knnsvc.pkl with the JAX package")
        payload = load_params(cp_g)
        # trained g_ checkpoints wrap the params as {'generator': ...}
        hifigan_params = payload.get("generator", payload)

        if wavlm_ckpt is None:
            wavlm_ckpt = os.path.join(ckpt_dir, "WavLM-Large.pt")
        if not wavlm_ckpt.endswith(".knnsvc.pkl"):
            raise NotImplementedError(
                f"{wavlm_ckpt}: loading torch .pt checkpoints is still to port "
                "(ROADMAP.md, Queue 1 item 1); pass a .knnsvc.pkl WavLM file")
        payload = load_params(wavlm_ckpt)
        if isinstance(payload, dict) and "model" in payload:
            # {'cfg': dict, 'model': params}, the torch checkpoint's own shape
            wavlm_params = payload["model"]
            wavlm_cfg = WavLMConfig.from_dict(payload.get("cfg") or {})
        else:
            wavlm_params, wavlm_cfg = payload, WavLMConfig()
        return cls(wavlm_params, wavlm_cfg, hifigan_params, h, ckpt_type, device=device)

    @classmethod
    def random_init(cls, ckpt_type: str = "mix", seed: int = 0,
                    device: str | torch.device = "cuda") -> "KnnSvc":
        """Random weights at full architecture size (WavLM-Large, HiFi-GAN v1
        config), drawn on the CPU from a torch.Generator seeded with `seed`,
        so every device gets the same weights."""
        resolve_device(device)
        from knnsvc_torch.models.hifigan.generator import init_generator_params
        from knnsvc_torch.models.wavlm.model import init_wavlm_params

        wavlm_cfg, h = WavLMConfig(), HiFiGANConfig()
        gen = torch.Generator().manual_seed(seed)
        wavlm_params = init_wavlm_params(wavlm_cfg, gen)
        hifigan_params = init_generator_params(h, model_family_for_ckpt_type(ckpt_type), gen)
        return cls(wavlm_params, wavlm_cfg, hifigan_params, h, ckpt_type, device=device)

    # ------------------------------------------------------------- conversion

    def _default_output_path(self, src_wav_file: str, ref_wav_file: str, suffix: str) -> str:
        """Reference naming: <src_dir>/<src>_to_<ref>_knn_<ckpt>_<suffix>.wav
        (ref ddsp_matcher.py:1013-1015)."""
        src_id = os.path.basename(src_wav_file).split(".")[0]
        ref_id = os.path.basename(ref_wav_file).split(".")[0]
        return os.path.join(str(Path(src_wav_file).parent),
                            f"{src_id}_to_{ref_id}_knn_{self.ckpt_type}_{suffix}.wav")

    def convert_waveform(self, src_wav_file: str, ref_wav_file: str, topk: int = 4,
                         post_opt: str = "no_post_opt", matcher: str = "exact") -> torch.Tensor:
        """The fast path up to the vocoder: both device pools, the match and
        the vocode. Returns the (T*hop,) float32 waveform on the device,
        before the int16 quantize."""
        from knnsvc_torch.match.pool import build_device_pool, load_utterance
        from knnsvc_torch.match.serve import convert_pools

        if matcher in ("sharded", "sharded_int8"):
            raise NotImplementedError(
                f"matcher {matcher!r}: the multi-device matchers are still to port "
                "(ROADMAP.md, Queue 1 item 11)")
        if matcher not in ("exact", "approx"):
            raise ValueError(f"--fast supports matcher 'exact' or 'approx', not {matcher!r} "
                             "(the dense int8 pool is host-prepared)")
        # record_function spans name the stages in a torch.profiler trace
        pools = []
        for path in (src_wav_file, ref_wav_file):
            with record_function("knnsvc.load_wav"):
                wav = load_utterance(path, self.sr)
            with record_function("knnsvc.pool_build"):
                pools.append(build_device_pool(wav, self.wavlm, self.weighting, self.weighting,
                                               self.sr, f0_method=self.f0_method,
                                               audio_path=str(path)))
        wav, _ = convert_pools(self.vocoder, self.ckpt_type, pools[0], pools[1],
                               PostOpt.parse(post_opt), topk=topk, matcher=matcher, sr=self.sr)
        return wav

    def convert_pair(self, src_wav_file: str, ref_wav_file: str, topk: int = 4,
                     prioritize_f0: bool = True, post_opt: str = "no_post_opt",
                     tgt_loudness_db: float | None = None,
                     output_path: str | None = None, matcher: str = "exact",
                     fast: bool = False) -> str:
        """Single file -> single file (ref special_match :937-1023). Writes
        `<src_dir>/<src>_to_<ref>_knn_<ckpt_type>_<post_opt>.wav` unless
        output_path is given; returns the output path.

        fast=True is the device-resident serving path: pools, match and
        vocode stay on the device, f0 comes from the host extractor (or its
        sidecar), and the output is quantized to int16 on the device and
        downloaded once. The host-pool path (fast=False), post_opt and
        loudness normalization are still to port and raise."""
        if not fast:
            raise NotImplementedError(
                "convert_pair(fast=False), the host-pool path, is still to port "
                "(ROADMAP.md, Queue 1 item 9); pass fast=True")
        if not prioritize_f0:
            raise ValueError("prioritize_f0 is mandatory on the reference live path (ref :1375)")
        if tgt_loudness_db is not None:
            raise NotImplementedError("loudness normalization (io/loudness.py) is still "
                                      "to port; pass tgt_loudness_db=None")
        from knnsvc_torch.match.serve import quantize_int16

        wav = self.convert_waveform(src_wav_file, ref_wav_file, topk=topk,
                                    post_opt=post_opt, matcher=matcher)
        with record_function("knnsvc.quantize_download"):
            pred = quantize_int16(wav).cpu().numpy().astype(np.float32) / 32768.0
        if output_path is None:
            output_path = self._default_output_path(src_wav_file, ref_wav_file, post_opt)
        with record_function("knnsvc.write_wav"):
            save_audio(output_path, pred, self.sr)
        return output_path
