"""The plain reference of one pair conversion, `KnnSvc.convert_pair(fast=True)`
with device f0 and int16 uploads, from the WAV files and the weights' pytree
alone.

The stages are frozen copies of the port's plain code (knnsvc_torch/match/
pool.py `build_device_pool` and `harmonic_amplitudes`, match/pipeline.py
`match_core` and `match_core_post_opt`, match/serve.py `convert_pools` and
`quantize_int16`, io/jax_params.py's pytree loader), with each hand-written
kernel replaced by its plain version: attention as einsums and a softmax
(wavlm.py), the f0 Viterbi and the concat-cost scan as serial loops on the
host. Nothing here imports the port.
"""

from __future__ import annotations

import wave

import numpy as np
import torch
import torch.nn as nn

from .concat_cost import knn_with_concat_cost, knn_with_concat_cost_pair
from .config import HiFiGANConfig, PostOpt, WavLMConfig, model_family_for_ckpt_type, uses_harmonics
from .f0_device import device_f0_tensor
from .f0_logic import shift_f0_to_target_register, sort_by_f0_compatibility
from .generator import Synthesizer
from .knn import knn_topk
from .smoothness import HARMONICS_LOSS_SCALE, WAVLM_LOSS_SCALE, optimize_smoothness_weights
from .stft import linear_spectrogram
from .wavlm import WavLM

SAMPLE_RATE = 16000
HOP_LENGTH = 320
LAYER = 6                      # the matching and synthesis layer (ref ddsp_matcher.py:88)
CHUNK_SECONDS = 30
MIN_CHUNK_SECONDS = 0.02
N_HARMONICS = 49
HARMONIC_SCALE = 0.0108
SPEC_INTERP_FACTOR = 8
KNN_CANDIDATES = 32


# ---------------------------------------------------------------- weights

_RENAME = {"w": "weight", "b": "bias", "scale": "weight"}


def _fold_weight_norm(p: dict) -> dict:
    v = np.asarray(p["v"], np.float32)
    norm = np.sqrt(np.sum(v * v, axis=tuple(range(1, v.ndim)), keepdims=True))
    folded = {k: x for k, x in p.items() if k not in ("g", "v")}
    folded["w"] = np.asarray(p["g"], np.float32) * v / norm
    return folded


def _state_items(tree, prefix: str = ""):
    """Pytree -> (state-dict name, tensor): a 2-D `w` is a Linear's (in,
    out) weight and is transposed; a {"g", "v"} weight norm is folded."""
    if isinstance(tree, dict):
        if "g" in tree and "v" in tree:
            tree = _fold_weight_norm(tree)
        for key, sub in tree.items():
            yield from _state_items(sub, f"{prefix}{_RENAME.get(key, key)}.")
    elif isinstance(tree, (list, tuple)):
        for i, sub in enumerate(tree):
            yield from _state_items(sub, f"{prefix}{i}.")
    else:
        a = np.asarray(tree, np.float32)
        name = prefix[:-1]
        if name.endswith(".weight") and a.ndim == 2:
            a = a.T
        yield name, torch.from_numpy(np.array(a, dtype=np.float32, order="C"))


def build_module(module: nn.Module, tree, device) -> nn.Module:
    module.load_state_dict(dict(_state_items(tree)), strict=True)
    return module.to(device).eval()


def build_wavlm(params: dict, cfg: WavLMConfig, device, n_layers: int = LAYER) -> WavLM:
    """The first `n_layers` encoder layers (the only ones a layer-6 encode
    runs) of the stacked pytree."""
    cfg = WavLMConfig(**{**cfg.__dict__, "encoder_layers": n_layers})
    stacked = params["encoder"]["layers"]

    def take(tree, i):
        if isinstance(tree, dict):
            return {k: take(v, i) for k, v in tree.items()}
        return np.asarray(tree)[i]

    encoder = {**params["encoder"], "layers": [take(stacked, i) for i in range(n_layers)]}
    return build_module(WavLM(cfg), {**params, "encoder": encoder}, device)


def build_vocoder(params: dict, h: HiFiGANConfig, ckpt_type: str, device) -> Synthesizer:
    return build_module(Synthesizer(h, model_family_for_ckpt_type(ckpt_type)), params, device)


# ---------------------------------------------------------------- audio

def read_wav(path: str) -> np.ndarray:
    """A 16-bit PCM mono WAV at 16 kHz -> (T,) float32 in [-1, 1)."""
    with wave.open(path, "rb") as f:
        if (f.getnchannels(), f.getsampwidth(), f.getframerate()) != (1, 2, SAMPLE_RATE):
            raise ValueError(f"{path}: expected 16-bit mono at {SAMPLE_RATE} Hz")
        pcm = np.frombuffer(f.readframes(f.getnframes()), dtype="<i2")
    return (pcm.astype(np.float32) / 2.0 ** 15).astype(np.float32)


# ---------------------------------------------------------------- pools

@torch.no_grad()
def build_pool(wav: np.ndarray, wavlm: WavLM, device):
    """30-s chunks (each padded by the reference's hop quirk and uploaded as
    int16 codes), layer-6 features, the linear spectrogram rows aligned to
    them, and device f0 per chunk -> (features (T, D), spec (T, 200), f0 (T,))."""
    feats, specs, f0s = [], [], []
    chunk_len = CHUNK_SECONDS * SAMPLE_RATE
    for index, start in enumerate(range(0, len(wav), chunk_len)):
        chunk = wav[start:start + chunk_len]
        if len(chunk) <= MIN_CHUNK_SECONDS * SAMPLE_RATE:
            break
        chunk = np.pad(chunk, (0, HOP_LENGTH - (len(chunk) % HOP_LENGTH)))
        codes = np.clip(np.round(chunk * 32768.0), -32768, 32767).astype(np.int16)
        x = torch.from_numpy(codes).to(device)[None].float() / 32768
        f = wavlm.extract_layer(x, output_layer=LAYER)[0]
        spec = linear_spectrogram(x[0])
        off = min(index, spec.shape[0] - f.shape[0])
        feats.append(f)
        specs.append(spec[off:off + f.shape[0]])
        f0s.append(device_f0_tensor(x[0], SAMPLE_RATE, n_frames=f.shape[0]))
    feats = torch.cat(feats)
    return feats, torch.cat(specs), torch.cat(f0s)[:feats.shape[0]]


def harmonic_amplitudes(spec: torch.Tensor, f0: torch.Tensor) -> torch.Tensor:
    """(T, 200) spectrum + (T,) f0 -> (T, 49) amplitudes at k*f0 of the 8x
    interpolated spectrum; unvoiced rows [max bin, 0, ...]; x0.0108."""
    T, n_bins = spec.shape
    L = n_bins * SPEC_INTERP_FACTOR
    harmonics = f0[:, None] * torch.arange(1, N_HARMONICS + 1, device=f0.device)[None, :]
    sr_t = torch.tensor(float(SAMPLE_RATE), dtype=harmonics.dtype, device=f0.device)
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


# ---------------------------------------------------------------- match

def _weighted(pool, idx, opt_enabled: bool, scale: float):
    if not opt_enabled:
        return pool[idx].mean(dim=1)
    w = optimize_smoothness_weights(idx, pool, scale=scale)
    return (pool[idx] * w[..., None]).sum(dim=1)


@torch.no_grad()
def match(q, q_f0, pool, pool_spec, pool_f0, ckpt_type: str, post_opt: PostOpt, topk: int):
    """kNN top-32, register shift, pitched re-rank; the concat-cost
    reselection on the host (post_opt); the smoothness weights or uniform
    means -> (out (T, D), shifted f0 (T,), harm (T, 49) or None)."""
    use_harm = uses_harmonics(ckpt_type)
    harm_pool = harmonic_amplitudes(pool_spec, pool_f0) if use_harm else None
    nearest, _ = knn_topk(q, pool, k=KNN_CANDIDATES)
    shifted = shift_f0_to_target_register(q_f0, pool_f0, None)
    target_idx = nearest[:, :topk]
    pitched_idx = (sort_by_f0_compatibility(shifted, pool_f0, nearest)[:, :topk]
                   if use_harm else None)
    plain = not post_opt.enabled and post_opt.concat_weight == -1.0
    if not plain and post_opt.concat_weight != -1.0:
        cpu = lambda t: t.cpu()
        if use_harm:
            target_idx, pitched_idx = knn_with_concat_cost_pair(
                cpu(target_idx), cpu(pitched_idx), cpu(q), cpu(pool), cpu(shifted),
                cpu(pool_f0), concat_weight=post_opt.concat_weight)
            pitched_idx = pitched_idx.to(q.device)
        else:
            target_idx = knn_with_concat_cost(cpu(target_idx), cpu(q), cpu(pool),
                                              concat_weight=post_opt.concat_weight)
        target_idx = target_idx.to(q.device)
    opt = post_opt.enabled and not plain
    out = _weighted(pool, target_idx, opt, WAVLM_LOSS_SCALE)
    harm = None if pitched_idx is None else _weighted(harm_pool, pitched_idx, opt,
                                                      HARMONICS_LOSS_SCALE)
    return out, shifted, harm


@torch.no_grad()
def convert(src_path: str, tgt_path: str, wavlm: WavLM, vocoder: Synthesizer, ckpt_type: str,
            post_opt: str, topk: int, device) -> dict[str, torch.Tensor]:
    """One request, every stage's result: the features and f0 of both pools,
    the matched features, the float waveform and its int16 codes."""
    src_feats, _, src_f0 = build_pool(read_wav(src_path), wavlm, device)
    tgt_feats, tgt_spec, tgt_f0 = build_pool(read_wav(tgt_path), wavlm, device)
    out, shifted, harm = match(src_feats, src_f0, tgt_feats, tgt_spec, tgt_f0, ckpt_type,
                               PostOpt.parse(post_opt), topk)
    wav = vocoder(out[None], shifted.reshape(1, -1, 1),
                  None if harm is None else harm[None])[0]
    codes = torch.clamp(torch.round(wav * 32768.0), -32768, 32767).to(torch.int16)
    return {"src_feats": src_feats, "tgt_feats": tgt_feats, "src_f0": src_f0,
            "tgt_f0": tgt_f0, "out": out, "harm": harm, "wave": wav, "codes": codes}
