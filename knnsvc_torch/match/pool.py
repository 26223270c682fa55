"""Device-resident speaker pools for the serving path (counterpart of
knnsvc_tpu/match/pool.py: load_utterance, harmonic_amplitudes_jax,
_encode_and_spec, DevicePool, build_device_pool).

A pool of one utterance holds, on the device: WavLM layer features for
matching and synthesis (T, 1024), the linear spectrogram (T, 200) and f0
(T,). Kept from the JAX package, frame for frame:
- WavLM runs on 30-s chunks, each padded to a hop multiple with a FULL
  extra hop when already aligned (ref ddsp_prematch_dataset.py:284);
- each chunk's spectrogram is sliced at offset min(chunk_index, spare rows)
  to line up with its feature rows (pool.py:438-450 there);
- host f0 (sidecar / native Harvest / YIN) runs on a background thread
  started before the encodes, joined at first `.f0` access; device f0
  (f0_method='device', dsp/f0_device.py) runs per chunk on the uploaded
  chunk, with no thread and no sidecar;
- upload_dtype='int16' quantizes each chunk on the host and dequantizes it
  on the device as x / 32768.
"""

from __future__ import annotations

import functools
import logging
import threading
from concurrent.futures import Future, ThreadPoolExecutor
from pathlib import Path

import numpy as np
import torch
from torch.profiler import record_function

from knnsvc_torch import HOP_LENGTH, SAMPLE_RATE
from knnsvc_torch.dsp.f0 import get_f0
from knnsvc_torch.dsp.f0_device import device_f0_tensor
from knnsvc_torch.dsp.stft import linear_spectrogram
from knnsvc_torch.io.audio import load_audio, resample, to_mono
from knnsvc_torch.utils.layer_weights import one_hot_layer

CHUNK_SECONDS = 30                            # ref :277
MIN_CHUNK_SECONDS = 0.02                      # ref :279
N_HARMONICS = 49                              # ref :391 (arange(1, 50))
HARMONIC_SCALE = 0.0108                       # ref :404
SPEC_INTERP_FACTOR = 8                        # ref :395


def load_utterance(path: str | Path, target_sr: int = SAMPLE_RATE) -> np.ndarray:
    """Load -> mono -> resample to 16 kHz. Returns (T,) float32 (ref :332-341)."""
    x, sr = load_audio(path)
    x = to_mono(x)
    if sr != target_sr:
        x = resample(x, sr, target_sr)
    return np.asarray(x[0], dtype=np.float32)


def harmonic_amplitudes(spec: torch.Tensor, f0: torch.Tensor,
                        sr: int = SAMPLE_RATE) -> torch.Tensor:
    """(T, 200) linear spec + (T,) f0 -> (T, 49) harmonic magnitudes
    (ref :391-404): the 8x linearly interpolated spectrum read at the bins of
    k*f0 (only those 49 points are interpolated); unvoiced rows get
    [max spec bin, 0, ..., 0]; x0.0108. float32 throughout with the
    operation order `harmonics * 2 * L / sr`, so bins round as in the
    reference (round half to even, like jnp.round)."""
    T, n_bins = spec.shape
    L = n_bins * SPEC_INTERP_FACTOR
    harmonics = f0[:, None] * torch.arange(1, N_HARMONICS + 1, device=f0.device)[None, :]
    # a tensor divisor: CUDA turns division by a host scalar into a product
    # with its reciprocal, which can move a bin across a .5 boundary
    sr_t = torch.tensor(float(sr), dtype=harmonics.dtype, device=f0.device)
    idx = torch.round(torch.clamp(harmonics * 2 * L / sr_t, max=L)).to(torch.int64)

    in_range = idx < L
    g = torch.where(in_range, idx, 0)
    out_pos = (g + 0.5) / SPEC_INTERP_FACTOR - 0.5
    lo = torch.clamp(torch.floor(out_pos).to(torch.int64), 0, n_bins - 1)
    hi = torch.clamp(lo + 1, 0, n_bins - 1)
    frac = torch.clamp(out_pos - torch.floor(out_pos), 0.0, 1.0)
    frac = torch.where(out_pos < 0, 0.0, frac)
    gathered = torch.gather(spec, 1, lo) * (1 - frac) + torch.gather(spec, 1, hi) * frac
    gathered = torch.where(in_range, gathered, 0.0)

    first = torch.cat([spec.max(dim=1, keepdim=True).values,
                       spec.new_zeros(T, N_HARMONICS - 1)], dim=1)
    gathered = torch.where((f0 == 0)[:, None], first, gathered)
    return (HARMONIC_SCALE * gathered).to(torch.float32)


@functools.lru_cache(maxsize=1)
def _f0_executor() -> ThreadPoolExecutor:
    return ThreadPoolExecutor(max_workers=1, thread_name_prefix="native-f0")


class DevicePool:
    """Device-resident pools of one utterance. `f0` is either given (device
    f0) or DEFERRED: the host extractor runs on a background thread (the
    ctypes call releases the GIL, so it overlaps the encodes); first access
    joins it and moves the f0 to the pool's device."""

    def __init__(self, matching: torch.Tensor, synth: torch.Tensor, spec: torch.Tensor,
                 f0: torch.Tensor | None = None, f0_future: Future | None = None):
        if (f0 is None) == (f0_future is None):
            raise ValueError("a DevicePool takes exactly one of f0 and f0_future")
        self.matching = matching   # (T, D)
        self.synth = synth         # (T, D)
        self.spec = spec           # (T, 200)
        self._f0 = f0
        self._f0_future = f0_future
        self._lock = threading.Lock()

    @property
    def f0(self) -> torch.Tensor:
        # the lock keeps concurrent first accesses from both joining; the
        # future is dropped only after f0 is set, so a failed extraction
        # re-raises its own error on every access
        with self._lock:
            if self._f0 is None:
                f0_np = np.asarray(self._f0_future.result(), dtype=np.float32)
                T = self.matching.shape[0]
                if len(f0_np) < T:
                    raise ValueError(f"f0 shorter than pool: len(f0)={len(f0_np)} < T={T} "
                                     "(truncated/mismatched sidecar?)")
                self._f0 = torch.from_numpy(f0_np[:T].copy()).to(self.matching.device)
                self._f0_future = None
            return self._f0


def _log_f0_failure(f: Future) -> None:
    if not f.cancelled() and f.exception() is not None:
        logging.getLogger(__name__).warning("background f0 extraction failed: %r",
                                            f.exception())


@torch.no_grad()
def build_device_pool(wav: np.ndarray, wavlm, match_weights: np.ndarray,
                      synth_weights: np.ndarray, sr: int = SAMPLE_RATE,
                      f0_method: str = "fast", audio_path: str | None = None,
                      upload_dtype: str = "float32") -> DevicePool:
    """Single-utterance pool on the encoder's device (one-hot layer
    weightings only — the serving path).

    f0: host methods run on the host waveform on a background thread, with
    the reference's sidecar contract when `audio_path` is given.
    f0_method='device' runs the device extractor on each uploaded 30-s chunk
    (the Viterbi per chunk, as in the JAX package), reads and writes no
    sidecar and needs sr = 16000.

    upload_dtype='int16' halves the upload: each chunk is quantized on the
    host as clip(round(x * 32768)) and dequantized on the device as x /
    32768 (lossless for 16-bit-sourced audio). 'float32' uploads as is."""
    m_hot = one_hot_layer(match_weights)
    s_hot = one_hot_layer(synth_weights)
    if m_hot is None or s_hot is None or min(m_hot, s_hot) < 1:
        raise ValueError("the device pool needs one-hot weightings of encoder layers >= 1")
    if upload_dtype not in ("float32", "int16"):
        raise ValueError(f"upload_dtype must be 'float32' or 'int16', not {upload_dtype!r}")
    on_device_f0 = f0_method == "device"
    if on_device_f0 and sr != SAMPLE_RATE:
        raise ValueError(f"f0_method='device' runs on the {SAMPLE_RATE}-Hz path, got sr={sr}")
    layers = sorted({m_hot, s_hot})
    device = next(wavlm.parameters()).device

    f0_future = None
    if not on_device_f0:
        f0_future = _f0_executor().submit(
            get_f0, wav, sr, audio_path=audio_path, method=f0_method,
            use_sidecar=audio_path is not None, write_sidecar=audio_path is not None)
        # a failure of a pool whose f0 is never read would otherwise go unseen
        f0_future.add_done_callback(_log_f0_failure)

    feats: dict[int, list[torch.Tensor]] = {l: [] for l in layers}
    specs, f0s = [], []
    chunk_len = CHUNK_SECONDS * sr
    start = 0
    chunk_index = 0
    while start < len(wav):
        chunk = wav[start:start + chunk_len]
        if len(chunk) <= MIN_CHUNK_SECONDS * sr:
            break
        n_pad = HOP_LENGTH - (len(chunk) % HOP_LENGTH)  # ref :284 pad quirk
        chunk = np.pad(chunk, (0, n_pad))
        if upload_dtype == "int16":
            chunk = np.clip(np.round(chunk * 32768.0), -32768, 32767).astype(np.int16)
        x = torch.from_numpy(chunk).to(device)[None]       # the upload
        if x.dtype == torch.int16:
            x = x.float() / 32768
        for l in layers:
            feats[l].append(wavlm.extract_layer(x, output_layer=l)[0])
        # pool row k of chunk c lines up with continuous spectrogram row
        # (chunk start frame) + k + c: slice each chunk's spectrogram at that
        # offset, clamped to its spare rows
        Tc = feats[layers[0]][-1].shape[0]
        spec_c = linear_spectrogram(x[0])
        off = min(chunk_index, spec_c.shape[0] - Tc)
        specs.append(spec_c[off:off + Tc])
        if on_device_f0:
            # the f0 grid (frame i at sample i*hop) is the 20-ms grid of the
            # encoder's stride-320 frontend: one f0 per feature row
            with record_function("knnsvc.f0_device"):
                f0s.append(device_f0_tensor(x[0], sr, n_frames=Tc))
        start += chunk_len
        chunk_index += 1

    matching = torch.cat(feats[m_hot])
    synth = matching if s_hot == m_hot else torch.cat(feats[s_hot])
    spec = torch.cat(specs)
    if spec.shape[0] != matching.shape[0]:
        raise AssertionError((spec.shape, matching.shape))
    if on_device_f0:
        return DevicePool(matching, synth, spec, f0=torch.cat(f0s)[:matching.shape[0]])
    return DevicePool(matching, synth, spec, f0_future=f0_future)
