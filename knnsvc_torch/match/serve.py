"""Serving core of the fast path: harmonics gather + kNN match (+ post_opt)
+ HiFi-GAN vocode (`convert_pools`) and the int16 quantize
(`quantize_int16`) — counterpart of knnsvc_tpu/match/serve.py:
_convert_core and convert_pools_fused.

The JAX package fuses these into one compiled program; PyTorch runs them
eagerly on the pools' device, and the caller downloads the int16 result once.
"""

from __future__ import annotations

import torch
from torch.profiler import record_function

from knnsvc_torch import SAMPLE_RATE
from knnsvc_torch.config import ModelFamily, PostOpt, uses_harmonics
from knnsvc_torch.match.pipeline import match_core, match_core_post_opt
from knnsvc_torch.match.pool import DevicePool, harmonic_amplitudes


def quantize_int16(wav: torch.Tensor) -> torch.Tensor:
    """[-1, 1] float wave -> int16 codes, clip(round(w * 32768))."""
    return torch.clamp(torch.round(wav * 32768.0), -32768, 32767).to(torch.int16)


@torch.no_grad()
def convert_pools(vocoder, ckpt_type: str, src: DevicePool, ref: DevicePool,
                  post_opt: PostOpt, topk: int = 4, matcher: str = "exact",
                  sr: int = SAMPLE_RATE) -> tuple[torch.Tensor, torch.Tensor]:
    """Convert src -> ref: joins both pools' background f0, then matches and
    vocodes on the pools' device. Returns (waveform (T*hop,) float32 before
    quantization, shifted f0 (T,))."""
    if matcher not in ("exact", "approx"):
        raise ValueError(f"the fast path supports matcher 'exact' or 'approx', not {matcher!r}")
    use_harm = uses_harmonics(ckpt_type)
    # record_function spans name the stages in a torch.profiler trace
    with record_function("knnsvc.f0_join"):
        src_f0 = src.f0     # joins the background f0 threads
        ref_f0 = ref.f0
    with record_function("knnsvc.match"):
        harm_pool = harmonic_amplitudes(ref.spec, ref_f0, sr) if use_harm else None
        args = (src.matching, ref.matching, ref.synth, ref_f0, harm_pool, src_f0, None)
        if not post_opt.enabled and post_opt.concat_weight == -1.0:
            out, shifted, harm = match_core(*args, topk=topk, use_harmonics=use_harm)
        else:
            # spans knnsvc.concat_cost and knnsvc.smoothness nest in this one
            out, shifted, harm = match_core_post_opt(
                *args, topk=topk, use_harmonics=use_harm,
                concat_weight=post_opt.concat_weight, opt_enabled=post_opt.enabled)
    with record_function("knnsvc.vocode"):
        if vocoder.family == ModelFamily.ORIGINAL:
            wav = vocoder(out[None])      # plain HiFi-GAN: features only
        else:
            wav = vocoder(out[None], shifted.reshape(1, -1, 1),
                          None if harm is None else harm[None])
    return wav[0], shifted
