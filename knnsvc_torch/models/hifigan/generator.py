"""HiFi-GAN generator variants as nn.Modules (counterpart of
knnsvc_tpu/models/hifigan/generator.py).

- MIX ("mix*"): additive-harmonic DDSP excitation; a down-branch of strided
  convs (channels n_harm*2^i) mirrors the upsample rates in reverse and
  caches a skip feature per scale, concatenated into the ConvTranspose
  trunk at each scale (ref hifigan/ddsp_models.py:108-233, 405-493).
- F0_ONLY ("wavlm_only" / "*no_harm_no_amp*"): the same topology on a bare
  sine at f0, down-branch at a constant n_harm+2 channels
  (ref hifigan/ddsp_models_f0.py:106-381).
The ORIGINAL family (plain HiFi-GAN v1) is not ported yet.
"""

from __future__ import annotations

from typing import Any

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from knnsvc_torch.config import HiFiGANConfig, ModelFamily
from knnsvc_torch.dsp.synth import harmonic_synth, sine_excitation
from knnsvc_torch.models.hifigan.layers import LRELU_SLOPE, ResBlock1, ResBlock3

Params = dict[str, Any]


def _down_channels(h: HiFiGANConfig, family: ModelFamily) -> list[tuple[int, int]]:
    """(in, out) channels of each down-branch conv."""
    n = len(h.upsample_rates)
    if family == ModelFamily.MIX:
        return [(h.n_harmonic * 2 ** i, h.n_harmonic * 2 ** (i + 1)) for i in range(n)]
    return [(h.n_harmonic + 2, h.n_harmonic + 2) for _ in range(n)]


def _check_supported(h: HiFiGANConfig, family: ModelFamily) -> None:
    if family == ModelFamily.ORIGINAL:
        raise NotImplementedError(
            "the ORIGINAL (wavlm_only_original) vocoder family is still to port "
            "(ROADMAP.md, Queue 1 item 5)")
    if h.resblock != "1":
        raise NotImplementedError(f"resblock {h.resblock!r}: only ResBlock1 is ported")


class Generator(nn.Module):
    """The `dec` trunk: feats (B, T, hubert_dim) + excitation condition
    (B, C_exc, T*hop) -> (B, 1, T*hop) waveform in [-1, 1]."""

    def __init__(self, h: HiFiGANConfig, family: ModelFamily):
        super().__init__()
        _check_supported(h, family)
        self.h = h
        rates, kernels = h.upsample_rates, h.upsample_kernel_sizes
        n = len(rates)
        uic = h.upsample_initial_channel
        downs_ch = _down_channels(h, family)
        res_ch = [downs_ch[0][0]] + [oc for _, oc in downs_ch]

        self.lin_pre = nn.Linear(h.hubert_dim, h.hifi_dim)
        self.conv_pre = nn.Conv1d(h.hifi_dim, uic, 7, padding=3)
        self.downs = nn.ModuleList(
            nn.Conv1d(ic, oc, kernels[n - 1 - i], stride=rates[n - 1 - i],
                      padding=kernels[n - 1 - i] // 2)
            for i, (ic, oc) in enumerate(downs_ch))
        self.resblocks_downs = nn.ModuleList(ResBlock3(oc) for _, oc in downs_ch)
        self.concat_pre = nn.Conv1d(uic + res_ch[n], uic, 3, padding=1)
        self.ups = nn.ModuleList(
            nn.ConvTranspose1d(uic // 2 ** i, uic // 2 ** (i + 1), kernels[i],
                               stride=rates[i], padding=(kernels[i] - rates[i]) // 2)
            for i in range(n))
        self.concat_conv = nn.ModuleList(
            nn.Conv1d(uic // 2 ** (i + 1) + res_ch[n - 1 - i], uic // 2 ** (i + 1), 3,
                      padding=1, bias=False)
            for i in range(n))
        self.resblocks = nn.ModuleList(
            ResBlock1(uic // 2 ** (i + 1), k, d)
            for i in range(n)
            for k, d in zip(h.resblock_kernel_sizes, h.resblock_dilation_sizes))
        self.conv_post = nn.Conv1d(uic // 2 ** n, 1, 7, padding=3, bias=False)

    def forward(self, feats: torch.Tensor, ddsp: torch.Tensor) -> torch.Tensor:
        rates = self.h.upsample_rates
        n = len(rates)
        n_res = len(self.h.resblock_kernel_sizes)
        x = self.conv_pre(self.lin_pre(feats).transpose(1, 2))

        # DDSP down-branch: strided convs over the excitation, rates reversed
        # (ref ddsp_models.py:123-143,184-195); crop to in_size // u
        se = ddsp
        res_features = [se]
        for i in range(n):
            in_size = se.shape[-1]
            se = self.resblocks_downs[i](self.downs[i](se))
            se = se[:, :, : in_size // rates[n - 1 - i]]
            res_features.append(se)
        x = self.concat_pre(torch.cat([x, se], dim=1))

        for i in range(n):
            x = self.ups[i](F.leaky_relu(x, LRELU_SLOPE))
            x = self.concat_conv[i](torch.cat([x, res_features[n - 1 - i]], dim=1))
            acc = None
            for j in range(n_res):
                y = self.resblocks[i * n_res + j](x)
                acc = y if acc is None else acc + y
            x = acc / n_res

        x = F.leaky_relu(x, 0.01)  # bare F.leaky_relu default (ref ddsp_models.py:229)
        return torch.tanh(self.conv_post(x))


class Synthesizer(nn.Module):
    """Excitation + sin_prenet + generator; calling it is the JAX package's
    `vocode` for the MIX and F0_ONLY families (ref ddsp_matcher.py:374-406)."""

    def __init__(self, h: HiFiGANConfig, family: ModelFamily):
        super().__init__()
        _check_supported(h, family)
        self.h = h
        self.family = family
        self.sin_prenet = nn.Conv1d(1, _down_channels(h, family)[0][0], 3, padding=1)
        self.dec = Generator(h, family)

    def forward(self, feats: torch.Tensor, f0: torch.Tensor,
                harmonics: torch.Tensor | None = None) -> torch.Tensor:
        """feats (B, T, hubert_dim), f0 (B, T, 1), harmonics (B, T, 49)
        (MIX only) -> waveform (B, T*hop)."""
        h = self.h
        if self.family == ModelFamily.MIX:
            if harmonics is None:
                raise ValueError("mix-family vocoding needs harmonic amplitudes (B, T, 49)")
            exc = harmonic_synth(f0, harmonics, h.sampling_rate, h.hop_size).transpose(1, 2)
        else:
            exc = sine_excitation(f0, h.sampling_rate, h.hop_size)
        return self.dec(feats, self.sin_prenet(exc))[:, 0, :]


def init_generator_params(h: HiFiGANConfig, family: ModelFamily,
                          generator: torch.Generator) -> Params:
    """Random weights (folded weight norm) in the JAX package's pytree layout,
    from the same distributions as its init_generator_params."""
    _check_supported(h, family)
    rates, kernels = h.upsample_rates, h.upsample_kernel_sizes
    n = len(rates)

    def conv(out_c, in_c, k, bias=True, std=0.01):
        p: Params = {"w": (torch.randn((out_c, in_c, k), generator=generator) * std).numpy()}
        if bias:
            p["b"] = np.zeros(out_c, np.float32)
        return p

    def conv_t(in_c, out_c, k, std=0.01):
        return {"w": (torch.randn((in_c, out_c, k), generator=generator) * std).numpy(),
                "b": np.zeros(out_c, np.float32)}

    uic = h.upsample_initial_channel
    downs_ch = _down_channels(h, family)
    exc_ch = downs_ch[0][0]
    res_ch = [exc_ch] + [oc for _, oc in downs_ch]
    dec: Params = {
        "conv_pre": conv(uic, h.hifi_dim, 7),
        "ups": [conv_t(uic // 2 ** i, uic // 2 ** (i + 1), kernels[i]) for i in range(n)],
        "resblocks": [
            {"convs1": [conv(uic // 2 ** (i + 1), uic // 2 ** (i + 1), k) for _ in d],
             "convs2": [conv(uic // 2 ** (i + 1), uic // 2 ** (i + 1), k) for _ in d]}
            for i in range(n)
            for k, d in zip(h.resblock_kernel_sizes, h.resblock_dilation_sizes)],
        "conv_post": conv(1, uic // 2 ** n, 7, bias=False),
        "lin_pre": {"w": (torch.randn((h.hubert_dim, h.hifi_dim), generator=generator)
                          * 0.02).numpy(),
                    "b": np.zeros(h.hifi_dim, np.float32)},
        "downs": [conv(oc, ic, kernels[n - 1 - i]) for i, (ic, oc) in enumerate(downs_ch)],
        "resblocks_downs": [{"convs": [conv(oc, oc, 3)]} for _, oc in downs_ch],
        "concat_pre": conv(uic, uic + res_ch[n], 3),
        "concat_conv": [conv(uic // 2 ** (i + 1), uic // 2 ** (i + 1) + res_ch[n - 1 - i], 3,
                             bias=False) for i in range(n)],
    }
    return {"dec": dec, "sin_prenet": conv(exc_ch, 1, 3)}
