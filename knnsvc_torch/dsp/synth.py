"""Additive-harmonic DDSP synthesis (counterpart of knnsvc_tpu/dsp/synth.py).

Reference semantics (ref ddsp_prematch_dataset.py:131-267, consumed by the
vocoder at hifigan/ddsp_models.py:432 and hifigan/ddsp_models_f0.py:344-352):

- f0 is upsampled x hop (nearest), amplitudes x hop (bicubic, torch
  align_corners=False);
- phase = 2*pi*(cumsum(f0/sr) - round(cumsum(f0/sr))), the cumsum in fp64
  as the reference does (the JAX package uses an fp32 associative
  wrap-scan instead, because fp64 is emulated on a TPU). The per-sample
  step f0/sr is taken as f0 * fl32(1/sr): that is what XLA compiles the
  JAX package's division to, and what CUDA does with a division by a host
  scalar. The two roundings differ by up to half an ulp of the step per
  sample, which the cumsum accumulates (at 300 Hz over 30 s, 9000 cycles
  x 2^-24 ~ 5e-4 cycles, times k for harmonic k), so the same steps on
  every device and in both packages matter more than the cumsum's
  precision (tests/test_torch_dsp.py holds the excitations to 2e-4);
- harmonic k phase = k*phase; amplitudes masked above Nyquist (+1e-7 floor);
  signal = sum_k sin(k*phase)*amp_k.
"""

from __future__ import annotations

import functools
import math

import numpy as np
import torch
import torch.nn.functional as F


def upsample_nearest(signal: torch.Tensor, factor: int) -> torch.Tensor:
    """(B, T, C) -> (B, T*factor, C), each frame repeated `factor` times."""
    return torch.repeat_interleave(signal, factor, dim=1)


@functools.lru_cache(maxsize=8)
def _bicubic_tap_matrix(factor: int) -> np.ndarray:
    """5-tap filter bank W (factor, 5): out[t, p] = sum_d x[clip(t+d-2)] *
    W[p, d] — the cubic-convolution weights (a=-0.75, align_corners=False)
    of torch's bicubic upsampling, re-indexed onto the fixed window t-2..t+2
    (same derivation as the JAX package's _bicubic_tap_matrix)."""
    a = -0.75

    def cubic(x):
        x = np.abs(x)
        return np.where(x <= 1, ((a + 2) * x - (a + 3)) * x * x + 1,
                        np.where(x < 2, (((x - 5) * x + 8) * x - 4) * a, 0.0))

    p = np.arange(factor, dtype=np.float64)
    src = (p + 0.5) / factor - 0.5
    frac = src - np.floor(src)
    w4 = cubic(np.array([-1.0, 0.0, 1.0, 2.0])[None, :] - frac[:, None])
    src_floor = np.floor(src).astype(int)                 # -1 or 0
    W = np.zeros((factor, 5))
    for pp in range(factor):
        for k in range(4):
            W[pp, src_floor[pp] - 1 + k + 2] += w4[pp, k]
    return W


def upsample_bicubic(signal: torch.Tensor, factor: int) -> torch.Tensor:
    """(B, T, C) -> (B, T*factor, C): torch F.interpolate(mode='bicubic',
    align_corners=False) on a height-1 image (ref
    ddsp_prematch_dataset.py:135-141), as 5 shifted copies and one product.
    Border replication == torch's neighbour-index clamping."""
    B, T, C = signal.shape
    W = torch.as_tensor(_bicubic_tap_matrix(factor), dtype=signal.dtype,
                        device=signal.device)                        # (factor, 5)
    padded = F.pad(signal.transpose(1, 2), (2, 2), mode="replicate")  # (B, C, T+4)
    shifts = torch.stack([padded[:, :, d:d + T] for d in range(5)], dim=-1)  # (B, C, T, 5)
    out = torch.matmul(shifts, W.T)                                  # (B, C, T, factor)
    return out.reshape(B, C, T * factor).transpose(1, 2)


def remove_above_nyquist(amplitudes: torch.Tensor, pitch: torch.Tensor,
                         sampling_rate: int) -> torch.Tensor:
    """Zero (to 1e-7) harmonics above Nyquist. amplitudes (..., n_harm),
    pitch broadcastable to (..., 1). Ref ddsp_prematch_dataset.py:146-156."""
    n_harm = amplitudes.shape[-1]
    k = torch.arange(1, n_harm + 1, dtype=pitch.dtype, device=pitch.device)
    aa = (pitch * k < sampling_rate / 2).to(amplitudes.dtype) + 1e-7
    return amplitudes * aa


def wrapped_phase_cumsum(step: torch.Tensor, dim: int = 1) -> torch.Tensor:
    """cumsum(step) - round(cumsum(step)) in fp64 (the reference's way),
    returned in step's dtype."""
    s = torch.cumsum(step.double(), dim=dim)
    return (s - torch.round(s)).to(step.dtype)


def _phase_step(f0_up: torch.Tensor, sample_rate: int) -> torch.Tensor:
    """Cycles per sample, f0 * fl32(1/sr) in float32 (see the module note)."""
    return f0_up.float() * float(np.float32(1.0 / sample_rate))


def harmonic_synth(f0: torch.Tensor, amp: torch.Tensor, sample_rate: int = 16000,
                   hop_size: int = 320) -> torch.Tensor:
    """Additive harmonic synthesis == ref get_bulk_dsp_choral
    (ddsp_prematch_dataset.py:165-208). f0 (B, T, 1), amp (B, T, n_harm) ->
    (B, T*hop_size, 1)."""
    f0_up = upsample_nearest(f0, hop_size)            # (B, Tw, 1)
    amp_up = upsample_bicubic(amp, hop_size)          # (B, Tw, n_harm)
    n_harm = amp_up.shape[-1]
    phase = 2.0 * math.pi * wrapped_phase_cumsum(_phase_step(f0_up, sample_rate), dim=1)
    k = torch.arange(1, n_harm + 1, dtype=phase.dtype, device=phase.device)
    amp_masked = remove_above_nyquist(amp_up, f0_up, sample_rate)
    return torch.sum(torch.sin(phase * k) * amp_masked, dim=-1, keepdim=True)


def sine_excitation(f0: torch.Tensor, sample_rate: int = 16000,
                    hop_size: int = 320) -> torch.Tensor:
    """Pure-sine excitation of the f0-only vocoder
    (ref hifigan/ddsp_models_f0.py:344-352). f0 (B, T, 1) -> (B, 1, T*hop)."""
    f0_up = upsample_nearest(f0, hop_size)
    phase = wrapped_phase_cumsum(_phase_step(f0_up, sample_rate), dim=1)
    return torch.sin(2.0 * math.pi * phase).transpose(1, 2)
