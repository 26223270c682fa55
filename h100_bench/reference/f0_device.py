"""Device f0 (the JAX package's device extractor): a frozen copy of knnsvc_torch/dsp/f0_device.py
in which the Viterbi is the plain serial recursion (viterbi.py), run on the
host one frame a step, instead of the CUDA kernel.
"""

from __future__ import annotations

import functools
from dataclasses import dataclass

import numpy as np
import torch
import torch.nn.functional as F

from .viterbi import viterbi_plain

F0_FLOOR = 65.0
F0_CEIL = 1047.0
F0_ZERO_BELOW = 80.0
DEFAULT_HOP = 320

# (f0_lo, f0_hi, analysis window): each candidate's comb reads the spectrum
# of the window spanning ~4 of its periods (pitch-adaptive analysis)
BANDS = ((65.0, 130.0, 1024), (130.0, 260.0, 512), (260.0, 1200.0, 256))

_BUCKET = 256
_INV_LN10_F32 = float(np.float32(1.0 / np.log(10.0)))
_INV_LN2_F32 = float(np.float32(1.0 / np.log(2.0)))


@dataclass(frozen=True)
class DeviceF0Params:
    """Comb-shape fields (window..neg_weight) fix M; the economics fields
    (unvoiced_cost..subharm3) are the tuned knobs of the JAX package
    (tools/tune_f0_device.py there), used as their fp32 values."""

    window: int = 1024
    nfft: int = 4096
    n_harmonics: int = 8
    grid_cents: float = 10.0
    neg_weight: float = 0.45        # half-harmonic negative evidence
    unvoiced_cost: float = 0.796    # voicing knee on per-frame contrast
    switch_cost: float = 0.291      # voiced<->unvoiced transition
    lam: float = 0.753              # transition cost per |delta log2 f0|
    energy_floor_db: float = -68.1  # absolute silence gate (vs file peak)
    refine_gate_cents: float = 115.7
    subharm2: float = 0.030         # super-harmonic suppression (c/2, c/3)
    subharm3: float = 0.082

    def static_key(self) -> "DeviceF0Params":
        """The comb identity: economics zeroed out."""
        return DeviceF0Params(self.window, self.nfft, self.n_harmonics,
                              self.grid_cents, self.neg_weight)

    def knob_vector(self) -> np.ndarray:
        return np.array([self.unvoiced_cost, self.switch_cost, self.lam,
                         self.energy_floor_db, self.refine_gate_cents,
                         self.subharm2, self.subharm3],
                        dtype=np.float32)


def _candidate_grid(p: DeviceF0Params) -> np.ndarray:
    n = int(np.floor(1200.0 * np.log2(F0_CEIL / F0_FLOOR) / p.grid_cents)) + 1
    return (F0_FLOOR * 2.0 ** (np.arange(n) * p.grid_cents / 1200.0)).astype(
        np.float32)


@functools.lru_cache(maxsize=4)
def _comb_matrix(
        sr: int, p: DeviceF0Params
) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """(C, n_bands*F) harmonic-comb interpolation stencils, the (C,)
    candidate grid, and the (C,) int32 spectrum-segment offset of each
    candidate's band. Row c sums |S| at bins k*f_c (1/k weights) in its
    band's segment and subtracts neg_weight * the same comb at (k-0.5)*f_c."""
    grid = _candidate_grid(p)
    n_bins = p.nfft // 2 + 1
    bin_hz = sr / p.nfft
    band_idx = np.zeros(len(grid), dtype=np.int64)
    for b, (lo_hz, hi_hz, _) in enumerate(BANDS):
        band_idx[(grid >= lo_hz) & (grid < hi_hz)] = b
    M = np.zeros((len(grid), len(BANDS) * n_bins), dtype=np.float32)
    wsum = np.zeros(len(grid), dtype=np.float32)
    seg = band_idx * n_bins
    for k in range(1, p.n_harmonics + 1):
        w = 1.0 / k
        for sign, mul, ww in ((1.0, float(k), w),
                              (-p.neg_weight, k - 0.5, w)):
            pos = grid * mul / bin_hz
            lo = np.floor(pos).astype(np.int64)
            frac = (pos - lo).astype(np.float32)
            ok = pos < n_bins - 1
            idx = np.where(ok, lo, 0) + seg
            np.add.at(M, (np.arange(len(grid)), idx),
                      np.where(ok, sign * ww * (1 - frac), 0.0))
            np.add.at(M, (np.arange(len(grid)),
                          np.minimum(idx + 1, seg + n_bins - 1)),
                      np.where(ok, sign * ww * frac, 0.0))
        wsum += np.where(grid * k / bin_hz < n_bins - 1, w, 0.0)
    # normalize each row by its live positive weight so low/high candidates
    # (fewer in-band harmonics) are comparable
    M /= np.maximum(wsum, 1e-6)[:, None]
    return M, grid, (seg).astype(np.int32)


@functools.lru_cache(maxsize=8)
def _device_tables(sr: int, p: DeviceF0Params, device: torch.device):
    """M, the grid and the segment offsets on `device`, uploaded once."""
    M, grid, seg = _comb_matrix(sr, p)
    return (torch.from_numpy(M).to(device), torch.from_numpy(grid).to(device),
            torch.from_numpy(seg.astype(np.int64)).to(device))


def _frame(x: torch.Tensor, n_frames: int, window: int, hop: int) -> torch.Tensor:
    """(T,) -> (N, window+1) frames centered at i*hop (one extra sample for
    the unit-delay IF pair). Frames past the end read zeros, as the JAX
    gather's clamped indices read its zero padding."""
    half = window // 2
    right = max(half + window, (n_frames - 1) * hop + window + 1 - half - x.shape[0])
    xp = F.pad(x, (half, right))
    return xp.unfold(0, window + 1, hop)[:n_frames]


def _features(frames: torch.Tensor, sr: int, p: DeviceF0Params):
    """Knob-independent per-frame features: contrast-normalized salience
    (N, C), frame energy (N,), band-concatenated sqrt-magnitude
    (N, n_bands*F), instantaneous frequency per bin (N, n_bands*F)."""
    M, _, seg = _device_tables(sr, p.static_key(), frames.device)
    n_bins = p.nfft // 2 + 1
    half0 = p.window // 2

    A_parts, inst_parts, norms = [], [], []
    # silence gate energy: the widest analysis span (first band's window)
    w0 = BANDS[0][2]
    c0 = frames[:, half0 - w0 // 2: half0 + w0 // 2]
    energy = torch.mean(c0 * c0, dim=1)
    for _, _, w in BANDS:
        # each band's frames are the CENTER w(+1) samples of the max-window
        # frame: the same 20 ms centers, a shorter analysis span
        off = half0 - w // 2
        win = torch.from_numpy(np.hanning(w).astype(np.float32)).to(frames.device)
        f1 = frames[:, off: off + w] * win
        f2 = frames[:, off + 1: off + w + 1] * win
        S1 = torch.fft.rfft(f1, n=p.nfft, dim=1)
        S2 = torch.fft.rfft(f2, n=p.nfft, dim=1)
        Ab = torch.sqrt(torch.abs(S1) + 1e-12)
        A_parts.append(Ab)
        phase = torch.angle(S2 * torch.conj(S1))           # rad/sample
        inst_parts.append(phase * (sr / (2.0 * np.pi)))    # Hz per bin
        norms.append(torch.mean(Ab, dim=1) + 1e-9)

    A = torch.cat(A_parts, dim=1)                           # (N, n_bands*F)
    inst = torch.cat(inst_parts, dim=1)
    sal = A @ M.T                                           # (N, C)
    # each candidate normalized by ITS band's mean sqrt-magnitude
    band_of = seg // n_bins
    norm = torch.stack(norms, dim=1)                        # (N, n_bands)
    sal_n = sal / norm[:, band_of]
    # contrast normalization: the per-frame candidate mean is the noise floor
    sal_c = sal_n - torch.mean(sal_n, dim=1, keepdim=True)
    return sal_c, energy, A, inst


def _emissions(sal_c: torch.Tensor, energy: torch.Tensor, p: DeviceF0Params,
               n_valid: int) -> tuple[torch.Tensor, torch.Tensor]:
    """The Viterbi's (N, C) voiced and (N,) unvoiced costs: -contrast after
    super-harmonic suppression, 1e3 on silent and padding frames; -knee."""
    knee, _, _, floor_db, _, sub2, sub3 = (float(v) for v in p.knob_vector())
    N, C = sal_c.shape

    # super-harmonic suppression: subtract the (relu'd) salience of the
    # candidate an octave / a twelfth below
    def shifted(steps: int) -> torch.Tensor:
        return F.pad(torch.clamp_min(sal_c, 0.0), (steps, 0))[:, :C]

    s2 = int(round(1200.0 / p.grid_cents))
    s3 = int(round(1200.0 * np.log2(3.0) / p.grid_cents))
    sal_c = sal_c - sub2 * shifted(s2) - sub3 * shifted(s3)

    # absolute silence gate (vs the utterance's own peak frame energy)
    frame = torch.arange(N, device=sal_c.device)
    peak = torch.max(torch.where(frame < n_valid, energy, 0.0)) + 1e-12
    silent = 10.0 * (torch.log(energy / peak + 1e-12) * _INV_LN10_F32) < floor_db
    cost_v = torch.where((silent | (frame >= n_valid))[:, None], 1e3, -sal_c).contiguous()
    cost_u = torch.full((N,), -knee, dtype=sal_c.dtype, device=sal_c.device)
    return cost_v, cost_u


def _transition(p: DeviceF0Params) -> tuple[float, float]:
    """(cost per grid step, voicing switch cost) as fp32 values: lam * (10 /
    1200) rounded once, as the JAX package's fp32 product is."""
    _, switch, lam = (float(v) for v in p.knob_vector()[:3])
    return float(np.float32(lam) * np.float32(p.grid_cents / 1200.0)), switch


def _decode(sal_c: torch.Tensor, energy: torch.Tensor, A: torch.Tensor,
            inst: torch.Tensor, sr: int, p: DeviceF0Params, n_valid: int) -> torch.Tensor:
    """Features -> (N,) f0. Every knob-dependent step; the knobs are the
    fp32 values of p.knob_vector()."""
    gate = float(p.knob_vector()[4])
    _, grid, seg_of = _device_tables(sr, p.static_key(), sal_c.device)
    N, C = sal_c.shape
    dev = sal_c.device
    cost_v, cost_u = _emissions(sal_c, energy, p, n_valid)
    # the serial recursion runs on the host: one frame a step
    states = viterbi_plain(cost_v.cpu(), cost_u.cpu(), *_transition(p)).to(dev).long()

    voiced = states < C
    sel = torch.clamp(states, max=C - 1)
    cand = grid[sel]

    # --- instantaneous-frequency refinement ------------------------------
    # bins read from the selected candidate's own band segment
    seg = seg_of[sel]
    bin_hz = sr / p.nfft
    ks = torch.arange(1, p.n_harmonics + 1, dtype=cand.dtype, device=dev)
    bins = torch.round(cand[:, None] * ks[None, :] / bin_hz).to(torch.int64)
    bins = torch.clamp(bins, 0, p.nfft // 2) + seg[:, None]
    fi = torch.gather(inst, 1, bins) / ks[None, :]                  # (N, K)
    mag = torch.gather(A, 1, bins)
    cents_off = 1200.0 * torch.abs(
        torch.log(torch.abs(fi) / torch.clamp_min(cand[:, None], 1e-6) + 1e-9) * _INV_LN2_F32)
    w = mag * (1.0 / ks[None, :]) * (cents_off < gate)
    w = w * (fi > 0)
    wsum = torch.sum(w, dim=1)
    refined = torch.sum(w * fi, dim=1) / torch.clamp_min(wsum, 1e-9)
    f0 = torch.where(wsum > 1e-9, refined, cand)
    f0 = torch.clamp(f0, 0.0, F0_CEIL)

    f0 = torch.where(voiced, f0, 0.0)
    f0 = torch.where(f0 < F0_ZERO_BELOW, 0.0, f0)   # ref zeroing contract
    return f0.to(torch.float32)


@torch.no_grad()
def device_f0_tensor(x: torch.Tensor, sr: int, n_frames: int, hop: int = DEFAULT_HOP,
                     params: DeviceF0Params | None = None) -> torch.Tensor:
    """The pool build's variant (device_f0_jax there): x (T,) float32 on its
    device -> (n_frames,) f0 on the same device, exactly n_frames frames
    (no bucket)."""
    p = params or DeviceF0Params()
    frames = _frame(x, n_frames, p.window, hop)
    sal_c, energy, A, inst = _features(frames, int(sr), p)
    return _decode(sal_c, energy, A, inst, int(sr), p, n_frames)
