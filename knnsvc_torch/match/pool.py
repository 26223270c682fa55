"""Speaker pools (counterpart of knnsvc_tpu/match/pool.py).

Host pools (the host-pool and bulk paths: UtterancePools, SpeakerPool,
list_speaker_utterances, chunked_wavlm_features, host_harmonic_amplitudes
(the JAX package's numpy `harmonic_amplitudes`), build_speaker_pool, its
.npz save/load and on-disk cache): the encoder runs on its device, and the
pool's six aligned arrays per utterance are host numpy, as in the JAX
package — the bulk loop's memory design (a FIFO of target pools in host
RAM, uploaded once per use by match/pipeline._prepare_ref_pool) rests on
it. Unlike the device pool, each utterance takes ONE linear spectrogram of
the whole waveform, sliced to the feature rows (ref :361-366).

Device pools (the serving path: harmonic_amplitudes (harmonic_amplitudes_jax
there), DevicePool, build_device_pool). A pool of one utterance holds, on
the device: WavLM layer features for
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

import dataclasses
import functools
import hashlib
import logging
import os
import threading
from concurrent.futures import Future, ThreadPoolExecutor
from pathlib import Path
from typing import Callable

import numpy as np
import torch
from torch.profiler import record_function

from knnsvc_torch import HOP_LENGTH, SAMPLE_RATE
from knnsvc_torch.dsp.f0 import get_f0
from knnsvc_torch.dsp.f0_device import device_f0_tensor
from knnsvc_torch.dsp.stft import linear_spectrogram
from knnsvc_torch.io.audio import load_audio, resample, to_mono
from knnsvc_torch.utils.layer_weights import one_hot_layer

AUDIO_EXTENSIONS = {".flac", ".wav", ".mp3"}  # ref ddsp_prematch_dataset.py:313
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


@dataclasses.dataclass
class UtterancePools:
    """Six frame-aligned host pools of one utterance (ref :343-404)."""

    matching: np.ndarray    # (T, D) layer-weighted WavLM features for the kNN
    synth: np.ndarray       # (T, D) layer-weighted WavLM features for synthesis
    audio: np.ndarray       # (T, 320) waveform frames
    spec: np.ndarray        # (T, 200) linear |STFT| frames
    f0: np.ndarray          # (T,) Hz, 0 = unvoiced
    harmonics: np.ndarray   # (T, 49) harmonic amplitudes


@dataclasses.dataclass
class SpeakerPool:
    """Per-utterance pools plus concatenated views (ref :1143-1168); each
    view concatenates anew on access."""

    utterances: dict[str, UtterancePools]

    def _cat(self, field: str) -> np.ndarray:
        return np.concatenate([getattr(u, field) for u in self.utterances.values()], axis=0)

    matching = property(lambda self: self._cat("matching"))
    synth = property(lambda self: self._cat("synth"))
    audio = property(lambda self: self._cat("audio"))
    spec = property(lambda self: self._cat("spec"))
    f0 = property(lambda self: self._cat("f0"))
    harmonics = property(lambda self: self._cat("harmonics"))

    @property
    def utterance_start_indices(self) -> list[int]:
        starts = [0]
        for u in self.utterances.values():
            starts.append(starts[-1] + len(u.matching))
        return starts


def list_speaker_utterances(path: str | Path) -> list[Path]:
    """A single audio file, or every audio file under a folder, sorted
    (ref :313-323)."""
    path = Path(path)
    if path.is_file() and path.suffix.lower() in AUDIO_EXTENSIONS:
        return [path]
    utts = sorted(p for p in path.rglob("**/*") if p.suffix.lower() in AUDIO_EXTENSIONS)
    if not utts:
        raise FileNotFoundError(f"directory not containing any audio {path}")
    return utts


@torch.no_grad()
def chunked_wavlm_features(wav: np.ndarray, wavlm, match_weights: np.ndarray,
                           synth_weights: np.ndarray, sr: int = SAMPLE_RATE,
                           encode_mode: str = "exact") -> tuple[np.ndarray, np.ndarray]:
    """(T_samples,) -> host (matching (T, D), synth (T, D)) over 30-s chunks
    on the encoder's device (ref get_full_wavlm_features :269-296). Each
    chunk is padded by the reference's hop quirk. One-hot weightings run the
    early-exit encoder (`encode_mode='bucketed'`: its masked bucketed form);
    any other weighting the weighted sum of the all-layer stack."""
    if encode_mode not in ("exact", "bucketed"):
        raise ValueError(f"encode_mode must be 'exact' or 'bucketed', not {encode_mode!r}")
    m_hot, s_hot = one_hot_layer(match_weights), one_hot_layer(synth_weights)
    device = next(wavlm.parameters()).device
    extract = wavlm.extract_layer_bucketed if encode_mode == "bucketed" else wavlm.extract_layer
    matching_chunks, synth_chunks = [], []
    chunk_len = CHUNK_SECONDS * sr
    for start in range(0, len(wav), chunk_len):
        chunk = wav[start:start + chunk_len]
        if len(chunk) <= MIN_CHUNK_SECONDS * sr:
            break
        n_pad = HOP_LENGTH - (len(chunk) % HOP_LENGTH)  # full hop when aligned (ref :284)
        x = torch.from_numpy(np.pad(chunk, (0, n_pad))).to(device)[None]
        if m_hot is not None and s_hot is not None:
            if min(m_hot, s_hot) < 1:
                raise ValueError("a layer-0 one-hot weighting selects the transformer input: "
                                 "pass it as a non-one-hot weighting")
            feats = {l: extract(x, output_layer=l)[0].cpu().numpy()
                     for l in sorted({m_hot, s_hot}, reverse=True)}
            matching_chunks.append(feats[m_hot])
            synth_chunks.append(feats[s_hot])
        else:
            stack = wavlm.extract_all_layers(x)[:, 0]                  # (L+1, T, D)
            for w, out in ((match_weights, matching_chunks), (synth_weights, synth_chunks)):
                w = torch.from_numpy(np.asarray(w, np.float32).reshape(-1, 1, 1)).to(device)
                out.append((stack * w).sum(0).cpu().numpy())
    return np.concatenate(matching_chunks), np.concatenate(synth_chunks)


def host_harmonic_amplitudes(spec: np.ndarray, f0: np.ndarray,
                             sr: int = SAMPLE_RATE) -> np.ndarray:
    """The JAX package's numpy `harmonic_amplitudes`, copied: (T, 200) linear
    spec + (T,) f0 -> (T, 49) harmonic magnitudes (ref :391-404), the 8x
    linearly interpolated spectrum read at the bins of k*f0; unvoiced rows
    get [max spec bin, 0, ..., 0]; x0.0108. float32 bin math with true
    division (`harmonics * 2 * L / sr`): an int64 arange would promote to
    float64 and flip boundary bins."""
    T, n_bins = spec.shape
    L = n_bins * SPEC_INTERP_FACTOR
    harmonics = f0[:, None] * np.arange(1, N_HARMONICS + 1, dtype=np.float32)[None, :]
    idx = np.round(np.clip(harmonics * 2 * L / sr, a_min=None, a_max=L)).astype(int)

    # torch F.interpolate(mode='linear', align_corners=False) at 8x grid
    # point g: source position (g + 0.5)/8 - 0.5 between bins
    in_range = idx < L                                   # == L hit the ref's zero pad column
    g = np.where(in_range, idx, 0)
    out_pos = (g + 0.5) / SPEC_INTERP_FACTOR - 0.5
    lo = np.clip(np.floor(out_pos).astype(int), 0, n_bins - 1)
    hi = np.clip(lo + 1, 0, n_bins - 1)
    frac = np.clip(out_pos - np.floor(out_pos), 0.0, 1.0)
    frac = np.where(out_pos < 0, 0.0, frac)
    rows = np.arange(T)[:, None]
    gathered = spec[rows, lo] * (1 - frac) + spec[rows, hi] * frac
    gathered = np.where(in_range, gathered, 0.0)

    unvoiced = f0 == 0
    gathered[unvoiced, 1:] = 0.0
    gathered[unvoiced, 0] = spec[unvoiced].max(axis=1) if unvoiced.any() else 0.0
    return (HARMONIC_SCALE * gathered).astype(np.float32)


def build_speaker_pool(path: str | Path, wavlm, match_weights: np.ndarray,
                       synth_weights: np.ndarray, duration_limit: float | None = None,
                       f0_fn: Callable[[np.ndarray, int, str], np.ndarray] | None = None,
                       sr: int = SAMPLE_RATE, encode_mode: str = "exact") -> SpeakerPool:
    """Host pools of a speaker's utterances (ref get_complete_spk_pool
    :301-414): features on the encoder's device, one whole-utterance linear
    spectrogram there, f0 from `f0_fn(wav, sr, path)` or else the host
    extractor's default method ('harvest', its `<stem>_f0.npy` sidecar
    first), everything else on the host. duration_limit (seconds) stops
    after the utterance that crosses it (ref :408-411)."""
    device = next(wavlm.parameters()).device
    utterances: dict[str, UtterancePools] = {}
    accumulated = 0.0
    for pth in list_speaker_utterances(path):
        wav = load_utterance(pth, sr)
        matching, synth = chunked_wavlm_features(wav, wavlm, match_weights, synth_weights,
                                                 sr, encode_mode=encode_mode)
        T = len(matching)
        if len(wav) < HOP_LENGTH * T:
            raise ValueError(f"{pth}: {len(wav)} samples for {T} feature frames")
        audio_frames = wav[: HOP_LENGTH * T].reshape(T, HOP_LENGTH)
        with torch.no_grad():
            spec = linear_spectrogram(torch.from_numpy(wav).to(device)).cpu().numpy()
        if spec.shape[0] < T:
            raise ValueError(f"{pth}: {spec.shape[0]} spectrogram frames for {T} feature frames")
        spec = spec[:T]
        f0 = get_f0(wav, sr, audio_path=str(pth)) if f0_fn is None else f0_fn(wav, sr, str(pth))
        if not (abs(len(f0) - T) <= 1 and len(f0) >= T):
            raise ValueError(f"{pth}: f0 has {len(f0)} frames for {T} feature frames "
                             "(truncated or mismatched sidecar?)")
        f0 = np.asarray(f0[:T], dtype=np.float32)
        utterances[str(pth)] = UtterancePools(
            matching=matching, synth=synth, audio=audio_frames.astype(np.float32),
            spec=spec.astype(np.float32), f0=f0,
            harmonics=host_harmonic_amplitudes(spec, f0, sr))
        accumulated += T * HOP_LENGTH / sr
        if duration_limit is not None and accumulated >= duration_limit:
            break
    return SpeakerPool(utterances)


_POOL_FIELDS = ("matching", "synth", "audio", "spec", "f0", "harmonics")


def save_speaker_pool(pool: SpeakerPool, path: str | Path) -> None:
    """One .npz per pool: keys <idx>|<field> and the utterance paths
    (`__paths__`), the JAX package's layout."""
    arrays: dict[str, np.ndarray] = {"__paths__": np.array(list(pool.utterances.keys()))}
    for i, utt in enumerate(pool.utterances.values()):
        for field in _POOL_FIELDS:
            arrays[f"{i}|{field}"] = getattr(utt, field)
    np.savez(path, **arrays)


def load_speaker_pool(path: str | Path) -> SpeakerPool:
    data = np.load(path, allow_pickle=False)
    return SpeakerPool({
        str(p): UtterancePools(**{field: data[f"{i}|{field}"] for field in _POOL_FIELDS})
        for i, p in enumerate(data["__paths__"])})


def build_speaker_pool_cached(path: str | Path, wavlm, match_weights: np.ndarray,
                              synth_weights: np.ndarray, cache_dir: str | Path | None = None,
                              **kwargs) -> SpeakerPool:
    """build_speaker_pool with an optional on-disk cache (the reference's
    force-disabled one, ref ddsp_prematch_dataset.py:1086-1138), keyed by
    the speaker path, both weightings, duration_limit, encode_mode and a
    fingerprint of the encoder (its relative-position table and first
    LayerNorm scale, the parameters the JAX package fingerprints)."""
    if cache_dir is None:
        return build_speaker_pool(path, wavlm, match_weights, synth_weights, **kwargs)
    os.makedirs(cache_dir, exist_ok=True)
    fp = hashlib.sha1()
    for probe in (getattr(wavlm.encoder, "rel_attn_bias", None), wavlm.layer_norm.weight):
        if probe is not None:
            fp.update(probe.detach().cpu().numpy().tobytes())
    key_src = (str(Path(path).resolve())
               + "|" + np.asarray(match_weights).tobytes().hex()
               + "|" + np.asarray(synth_weights).tobytes().hex()
               + "|" + str(kwargs.get("duration_limit"))
               + "|" + kwargs.get("encode_mode", "exact")
               + "|" + fp.hexdigest())
    key = hashlib.sha1(key_src.encode()).hexdigest()[:16]
    cache_file = Path(cache_dir) / f"{Path(path).name}_{key}.pool.npz"
    if cache_file.is_file():
        return load_speaker_pool(cache_file)
    pool = build_speaker_pool(path, wavlm, match_weights, synth_weights, **kwargs)
    save_speaker_pool(pool, cache_file)
    return pool


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
                 f0: torch.Tensor | None = None, f0_future: Future | None = None,
                 sr: int = SAMPLE_RATE):
        if (f0 is None) == (f0_future is None):
            raise ValueError("a DevicePool takes exactly one of f0 and f0_future")
        self.matching = matching   # (T, D)
        self.synth = synth         # (T, D)
        self.spec = spec           # (T, 200)
        self.sr = sr
        self._f0 = f0
        self._f0_future = f0_future
        self._harmonics = None
        self._lock = threading.Lock()

    @property
    def harmonics(self) -> torch.Tensor:
        """(T, 49) harmonic amplitudes of the pool's spectrogram and f0,
        gathered on first access and kept (the bulk loops' target pools; the
        serving core gathers them inline instead)."""
        if self._harmonics is None:
            self._harmonics = harmonic_amplitudes(self.spec, self.f0, self.sr)
        return self._harmonics

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
        return DevicePool(matching, synth, spec, f0=torch.cat(f0s)[:matching.shape[0]], sr=sr)
    return DevicePool(matching, synth, spec, f0_future=f0_future, sr=sr)
