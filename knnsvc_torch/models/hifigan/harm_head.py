"""Learned harmonic-amplitude head, Generator_Harm (counterpart of
knnsvc_tpu/models/hifigan/harm_head.py).

The reference defines this module (hifigan/ddsp_models.py:245-333,
duplicated in ddsp_models_f0.py) but it is dead code there: it calls an
undefined `scale_function` and is never instantiated (ref :311,412). The
JAX package reconstructs it as a working component, and this is that
component as an nn.Module: prenet Conv1d -> ConvReluNorm stack -> postnet
projecting to n_harmonic+1 amplitudes, the DDSP exp-sigmoid scale, Nyquist
masking, normalization by the total amplitude, and additive sines at the
upsampled pitch. Parameter names follow the JAX package's pytree
(io/jax_params.py: `generator_harm_from_numpy`).
"""

from __future__ import annotations

import math
from typing import Any

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from knnsvc_torch.dsp.synth import (_phase_step, remove_above_nyquist, upsample_nearest,
                                    wrapped_phase_cumsum)

Params = dict[str, Any]


def scale_function(x: torch.Tensor) -> torch.Tensor:
    """DDSP exp-sigmoid amplitude nonlinearity: 2 * sigmoid(x)^log(10) + 1e-7."""
    return 2.0 * torch.sigmoid(x) ** math.log(10.0) + 1e-7


class ConvReluNorm(nn.Module):
    """(ref ddsp_models.py:245-281): conv -> channel LayerNorm -> relu, then
    residual-averaged conv blocks, and a zero-initialized 1x1 projection."""

    def __init__(self, hidden: int, n_layers: int, kernel_size: int):
        super().__init__()
        pad = kernel_size // 2
        self.convs = nn.ModuleList(nn.Conv1d(hidden, hidden, kernel_size, padding=pad)
                                   for _ in range(n_layers))
        self.norms = nn.ModuleList(nn.LayerNorm(hidden) for _ in range(n_layers))
        self.proj = nn.Conv1d(hidden, hidden, 1)

    @staticmethod
    def _norm_relu(x: torch.Tensor, norm: nn.LayerNorm) -> torch.Tensor:
        return F.relu(norm(x.transpose(1, 2)).transpose(1, 2))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = self._norm_relu(self.convs[0](x), self.norms[0])
        for conv, norm in zip(self.convs[1:], self.norms[1:]):
            x = (x + self._norm_relu(conv(x), norm)) / 2
        return self.proj(x)


class GeneratorHarm(nn.Module):
    """f0 (B, T, 1) and hidden features harm (B, C, T) -> the per-harmonic
    sine bank (B, n_harmonic, T*hop) (ref ddsp_models.py:301-333)."""

    def __init__(self, hidden: int, n_harmonic: int, n_layers: int = 8, kernel_size: int = 3):
        super().__init__()
        self.prenet = nn.Conv1d(hidden, hidden, 3, padding=1)
        self.net = ConvReluNorm(hidden, n_layers, kernel_size)
        self.postnet = nn.Conv1d(hidden, n_harmonic + 1, 3, padding=1)

    def forward(self, f0: torch.Tensor, harm: torch.Tensor, sample_rate: int = 16000,
                hop_size: int = 320) -> torch.Tensor:
        param = scale_function(self.postnet(self.net(self.prenet(harm))).transpose(1, 2))
        total_amp = param[..., :1]
        amplitudes = remove_above_nyquist(param[..., 1:], f0, sample_rate)
        amplitudes = amplitudes / torch.sum(amplitudes, dim=-1, keepdim=True) * total_amp
        amp_up = upsample_nearest(amplitudes, hop_size)
        pitch_up = upsample_nearest(f0, hop_size)
        phase = 2.0 * math.pi * wrapped_phase_cumsum(_phase_step(pitch_up, sample_rate), dim=1)
        k = torch.arange(1, amp_up.shape[-1] + 1, dtype=phase.dtype, device=phase.device)
        return (torch.sin(phase * k) * amp_up).transpose(1, 2)


def generator_harm_apply(model: GeneratorHarm, f0: torch.Tensor, harm: torch.Tensor,
                         sample_rate: int = 16000, hop_size: int = 320,
                         kernel_size: int = 3) -> torch.Tensor:
    """The JAX package's functional form of calling a GeneratorHarm. The
    module carries its ConvReluNorm kernel size; kernel_size must agree."""
    if model.net.convs[0].kernel_size[0] != kernel_size:
        raise ValueError(f"the GeneratorHarm's kernel size is "
                         f"{model.net.convs[0].kernel_size[0]}, called with {kernel_size}")
    return model(f0, harm, sample_rate, hop_size)


def init_generator_harm_params(generator: torch.Generator, hidden: int, n_harmonic: int,
                               n_layers: int = 8, kernel_size: int = 3) -> Params:
    """Random parameters in the JAX package's layout (numpy): convs N(0,
    0.02) from `generator`, zero biases, unit LayerNorms, a zero projection
    (ref :267-268). io/jax_params.generator_harm_from_numpy builds the
    module."""

    def conv(out_c, in_c, k, zero=False):
        w = (np.zeros((out_c, in_c, k), np.float32) if zero
             else (torch.randn((out_c, in_c, k), generator=generator) * 0.02).numpy())
        return {"w": w, "b": np.zeros((out_c,), np.float32)}

    def ln(c):
        return {"scale": np.ones((c,), np.float32), "bias": np.zeros((c,), np.float32)}

    return {
        "prenet": conv(hidden, hidden, 3),
        "net": {
            "convs": [conv(hidden, hidden, kernel_size) for _ in range(n_layers)],
            "norms": [ln(hidden) for _ in range(n_layers)],
            "proj": conv(hidden, hidden, 1, zero=True),
        },
        "postnet": conv(n_harmonic + 1, hidden, 3),
    }
