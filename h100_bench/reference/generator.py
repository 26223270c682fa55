"""A frozen copy of knnsvc_torch/models/hifigan/generator.py, plain PyTorch; nothing of the port is
imported. The original's description:

HiFi-GAN generator variants as nn.Modules (counterpart of
knnsvc_tpu/models/hifigan/generator.py).

- MIX ("mix*"): additive-harmonic DDSP excitation; a down-branch of strided
  convs (channels n_harm*2^i) mirrors the upsample rates in reverse and
  caches a skip feature per scale, concatenated into the ConvTranspose
  trunk at each scale (ref hifigan/ddsp_models.py:108-233, 405-493).
- F0_ONLY ("wavlm_only" / "*no_harm_no_amp*"): the same topology on a bare
  sine at f0, down-branch at a constant n_harm+2 channels
  (ref hifigan/ddsp_models_f0.py:106-381).
- ORIGINAL ("wavlm_only_original"): the plain HiFi-GAN v1 generator on the
  features alone: no lin_pre, no excitation, features straight into
  conv_pre (the JAX package's reconstruction; the reference dispatches to a
  hifigan/models.py that its repository lacks).
Both residual block types of the config (`resblock` "1" and "2") are built.
"""

from __future__ import annotations


import torch
import torch.nn as nn
import torch.nn.functional as F

from .config import HiFiGANConfig, ModelFamily
from .synth import harmonic_synth, sine_excitation
from .layers import LRELU_SLOPE, ResBlock1, ResBlock2, ResBlock3



def _down_channels(h: HiFiGANConfig, family: ModelFamily) -> list[tuple[int, int]]:
    """(in, out) channels of each down-branch conv."""
    n = len(h.upsample_rates)
    if family == ModelFamily.MIX:
        return [(h.n_harmonic * 2 ** i, h.n_harmonic * 2 ** (i + 1)) for i in range(n)]
    return [(h.n_harmonic + 2, h.n_harmonic + 2) for _ in range(n)]


class Generator(nn.Module):
    """The `dec` trunk: feats (B, T, hubert_dim) + excitation condition
    (B, C_exc, T*hop; None for ORIGINAL) -> (B, 1, T*hop) waveform in
    [-1, 1]."""

    def __init__(self, h: HiFiGANConfig, family: ModelFamily):
        super().__init__()
        if h.resblock not in ("1", "2"):
            raise ValueError(f"resblock must be '1' or '2', not {h.resblock!r}")
        self.h = h
        self.original = family == ModelFamily.ORIGINAL
        rates, kernels = h.upsample_rates, h.upsample_kernel_sizes
        n = len(rates)
        uic = h.upsample_initial_channel
        if self.original:
            self.conv_pre = nn.Conv1d(h.hubert_dim, uic, 7, padding=3)
        else:
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
            self.concat_conv = nn.ModuleList(
                nn.Conv1d(uic // 2 ** (i + 1) + res_ch[n - 1 - i], uic // 2 ** (i + 1), 3,
                          padding=1, bias=False)
                for i in range(n))
        self.ups = nn.ModuleList(
            nn.ConvTranspose1d(uic // 2 ** i, uic // 2 ** (i + 1), kernels[i],
                               stride=rates[i], padding=(kernels[i] - rates[i]) // 2)
            for i in range(n))
        block = ResBlock1 if h.resblock == "1" else ResBlock2
        self.resblocks = nn.ModuleList(
            block(uic // 2 ** (i + 1), k, d)
            for i in range(n)
            for k, d in zip(h.resblock_kernel_sizes, h.resblock_dilation_sizes))
        self.conv_post = nn.Conv1d(uic // 2 ** n, 1, 7, padding=3, bias=False)

    def forward(self, feats: torch.Tensor, ddsp: torch.Tensor | None) -> torch.Tensor:
        rates = self.h.upsample_rates
        n = len(rates)
        n_res = len(self.h.resblock_kernel_sizes)
        if self.original:
            x = self.conv_pre(feats.transpose(1, 2))
        else:
            x = self.conv_pre(self.lin_pre(feats).transpose(1, 2))
            # DDSP down-branch: strided convs over the excitation, rates
            # reversed (ref ddsp_models.py:123-143,184-195); crop to in_size // u
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
            if not self.original:
                x = self.concat_conv[i](torch.cat([x, res_features[n - 1 - i]], dim=1))
            acc = None
            for j in range(n_res):
                y = self.resblocks[i * n_res + j](x)
                acc = y if acc is None else acc + y
            x = acc / n_res

        x = F.leaky_relu(x, 0.01)  # bare F.leaky_relu default (ref ddsp_models.py:229)
        return torch.tanh(self.conv_post(x))


class Synthesizer(nn.Module):
    """Excitation + sin_prenet + generator (the generator alone for
    ORIGINAL); calling it is the JAX package's `vocode`
    (ref ddsp_matcher.py:374-406)."""

    def __init__(self, h: HiFiGANConfig, family: ModelFamily):
        super().__init__()
        self.h = h
        self.family = family
        if family != ModelFamily.ORIGINAL:
            self.sin_prenet = nn.Conv1d(1, _down_channels(h, family)[0][0], 3, padding=1)
        self.dec = Generator(h, family)

    def forward(self, feats: torch.Tensor, f0: torch.Tensor | None = None,
                harmonics: torch.Tensor | None = None) -> torch.Tensor:
        """feats (B, T, hubert_dim), f0 (B, T, 1) (not ORIGINAL), harmonics
        (B, T, 49) (MIX only) -> waveform (B, T*hop)."""
        h = self.h
        if self.family == ModelFamily.ORIGINAL:
            return self.dec(feats, None)[:, 0, :]
        if f0 is None:
            raise ValueError(f"{self.family.value}-family vocoding needs f0 (B, T, 1)")
        if self.family == ModelFamily.MIX:
            if harmonics is None:
                raise ValueError("mix-family vocoding needs harmonic amplitudes (B, T, 49)")
            exc = harmonic_synth(f0, harmonics, h.sampling_rate, h.hop_size).transpose(1, 2)
        else:
            exc = sine_excitation(f0, h.sampling_rate, h.hop_size)
        # the excitation is fp32 (f0 stays fp32); convs compute in their
        # weight's dtype, as the JAX package's conv1d casts its input
        return self.dec(feats, self.sin_prenet(exc.to(self.sin_prenet.weight.dtype)))[:, 0, :]
