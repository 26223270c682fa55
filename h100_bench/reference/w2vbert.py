"""w2v-BERT 2.0 (facebook/w2v-bert-2.0; arXiv 2312.05187) in plain PyTorch,
written from HF's equations and independent of the port: the frontend of
transformers/models/seamless_m4t/feature_extraction_seamless_m4t.py (with
audio_utils.spectrogram, mel_filter_bank, window_function) and the encoder
of transformers/models/wav2vec2_bert/modeling_wav2vec2_bert.py
(Wav2Vec2BertModel at inference: no mask, no SpecAugment, no adapter),
over a state dict under HF's names. Nothing here imports the port, JAX or
transformers.

Departures, none of which moves a number: the fbank's frames are cut and
transformed at once rather than in a loop; the relative-key term, HF's
einsum over the (T, T, d) gathered distance table, is computed in blocks of
query rows so that a 30-s chunk fits on the card. TF32 is the caller's to
set (the benchmark sets it off, its control on).
"""

from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F

# the extractor's settings (feature_extraction_seamless_m4t.py)
FRAME_LENGTH = 400
HOP_LENGTH = 160
FFT_LENGTH = 512
PREEMPHASIS = 0.97
MEL_FLOOR = 1.192092955078125e-07
MIN_FREQUENCY = 20
QUERY_BLOCK = 128


# ---------------------------------------------------------------- frontend

def _kaldi_mel(f):
    return 1127.0 * np.log(1.0 + np.asarray(f, dtype=np.float64) / 700.0)


def mel_filters(num_mel_filters: int = 80, sampling_rate: int = 16000) -> np.ndarray:
    """mel_filter_bank(257, n, 20, sr // 2, sr, norm=None, mel_scale="kaldi",
    triangularize_in_mel_space=True): (257, n) float64."""
    num_frequency_bins = FFT_LENGTH // 2 + 1
    mel_freqs = np.linspace(_kaldi_mel(MIN_FREQUENCY), _kaldi_mel(sampling_rate // 2),
                            num_mel_filters + 2)
    fft_bin_width = sampling_rate / ((num_frequency_bins - 1) * 2)
    fft_freqs = _kaldi_mel(fft_bin_width * np.arange(num_frequency_bins))
    filter_diff = np.diff(mel_freqs)
    slopes = np.expand_dims(mel_freqs, 0) - np.expand_dims(fft_freqs, 1)
    down_slopes = -slopes[:, :-2] / filter_diff[:-1]
    up_slopes = slopes[:, 2:] / filter_diff[1:]
    return np.maximum(np.zeros(1), np.minimum(down_slopes, up_slopes))


def fbank(waveform: torch.Tensor, num_mel_bins: int = 80) -> torch.Tensor:
    """_extract_fbank_features: (N,) float waveform in [-1, 1) -> (F,
    num_mel_bins) float32 log mel energies of waveform * 2^15, in float64
    with the FFT stored as complex64, as spectrogram() does."""
    device = waveform.device
    x = (waveform * (2 ** 15)).to(torch.float64)
    window = torch.from_numpy(np.power(np.hanning(FRAME_LENGTH), 0.85)).to(device)
    filters = torch.from_numpy(mel_filters(num_mel_bins)).to(device)
    num_frames = int(1 + (x.numel() - FRAME_LENGTH) // HOP_LENGTH)
    starts = torch.arange(num_frames, device=device)[:, None] * HOP_LENGTH
    buffer = x[starts + torch.arange(FRAME_LENGTH, device=device)[None, :]]
    buffer = buffer - buffer.mean(dim=1, keepdim=True)                   # remove_dc_offset
    first = buffer[:, :1] * (1 - PREEMPHASIS)
    buffer = torch.cat([first, buffer[:, 1:] - PREEMPHASIS * buffer[:, :-1]], dim=1)
    buffer = buffer * window
    spectrum = torch.fft.rfft(buffer, n=FFT_LENGTH).to(torch.complex64)
    power = spectrum.to(torch.complex128).abs() ** 2.0
    mel = torch.clamp(power @ filters, min=MEL_FLOOR)
    return torch.log(mel).to(torch.float32)


def input_features(waveform: torch.Tensor, num_mel_bins: int = 80, stride: int = 2) -> torch.Tensor:
    """The extractor's __call__ on one waveform: fbank, each bin normalised
    by its mean and variance (ddof 1) over the frames, padded to a
    multiple of `stride` frames with zeros, frames stacked -> (F', 160)."""
    x = fbank(waveform, num_mel_bins)
    x = (x - x.mean(0, keepdim=True)) / torch.sqrt(x.var(0, correction=1, keepdim=True) + 1e-7)
    rem = -x.shape[0] % stride
    if rem:
        x = torch.cat([x, x.new_zeros(rem, x.shape[1])])
    return x.reshape(x.shape[0] // stride, x.shape[1] * stride)


# ---------------------------------------------------------------- encoder

def layer_norm(x, state, prefix, eps):
    return F.layer_norm(x, x.shape[-1:], state[f"{prefix}.weight"], state[f"{prefix}.bias"], eps)


def linear(x, state, prefix, bias=True):
    return F.linear(x, state[f"{prefix}.weight"], state[f"{prefix}.bias"] if bias else None)


def feed_forward(x, state, prefix):
    h = F.silu(linear(x, state, f"{prefix}.intermediate_dense"))
    return linear(h, state, f"{prefix}.output_dense")


def self_attention(x, state, prefix, heads, left, right):
    """Wav2Vec2BertSelfAttention with position_embeddings_type relative_key,
    one sequence: x (T, D)."""
    T, D = x.shape
    d = D // heads
    q, k, v = (linear(x, state, f"{prefix}.linear_{n}").view(T, heads, d).transpose(0, 1)
               for n in ("q", "k", "v"))
    table = state[f"{prefix}.distance_embedding.weight"]
    out = torch.empty_like(q)
    keys = torch.arange(T, device=x.device)
    for s in range(0, T, QUERY_BLOCK):
        rows = keys[s:s + QUERY_BLOCK]
        qb = q[:, rows]
        scores = torch.matmul(qb, k.transpose(-2, -1)) / math.sqrt(d)
        distance = torch.clamp(keys[None, :] - rows[:, None], -left, right)
        positional = table[distance + left]                              # (b, T, d)
        rel = torch.einsum("hld,lrd->hlr", qb, positional)
        scores = scores + rel / math.sqrt(d)
        out[:, rows] = torch.matmul(torch.softmax(scores, dim=-1), v)
    return linear(out.transpose(0, 1).reshape(T, D), state, f"{prefix}.linear_out")


def convolution_module(x, state, prefix, eps):
    """Wav2Vec2BertConvolutionModule: x (T, D)."""
    h = layer_norm(x, state, f"{prefix}.layer_norm", eps).T[None]        # (1, D, T)
    h = F.conv1d(h, state[f"{prefix}.pointwise_conv1.weight"])
    h = F.glu(h, dim=1)
    w = state[f"{prefix}.depthwise_conv.weight"]
    h = F.pad(h, (w.shape[-1] - 1, 0))
    h = F.conv1d(h, w, groups=w.shape[0])
    h = layer_norm(h.transpose(1, 2), state, f"{prefix}.depthwise_layer_norm", eps).transpose(1, 2)
    h = F.silu(h)
    h = F.conv1d(h, state[f"{prefix}.pointwise_conv2.weight"])
    return h[0].T


def encoder_layer(x, state, prefix, cfg):
    """Wav2Vec2BertEncoderLayer (the Conformer block)."""
    eps = cfg["layer_norm_eps"]
    residual = x
    x = feed_forward(layer_norm(x, state, f"{prefix}.ffn1_layer_norm", eps), state,
                     f"{prefix}.ffn1")
    x = x * 0.5 + residual
    residual = x
    x = self_attention(layer_norm(x, state, f"{prefix}.self_attn_layer_norm", eps), state,
                       f"{prefix}.self_attn", cfg["num_attention_heads"],
                       cfg["left_max_position_embeddings"], cfg["right_max_position_embeddings"])
    x = x + residual
    residual = x
    x = residual + convolution_module(x, state, f"{prefix}.conv_module", eps)
    residual = x
    x = feed_forward(layer_norm(x, state, f"{prefix}.ffn2_layer_norm", eps), state,
                     f"{prefix}.ffn2")
    x = x * 0.5 + residual
    return layer_norm(x, state, f"{prefix}.final_layer_norm", eps)


DEFAULTS = {"num_attention_heads": 16, "left_max_position_embeddings": 64,
            "right_max_position_embeddings": 8, "layer_norm_eps": 1e-5, "num_mel_bins": 80,
            "stride": 2}


class W2VBertReference:
    """The first `n_layers` layers of the encoder from a state dict (HF's
    names; numpy arrays or tensors), on `device` in float32."""

    def __init__(self, state: dict, cfg: dict, n_layers: int, device):
        self.cfg = {**DEFAULTS, **cfg}
        self.n_layers = n_layers
        self.state = {}
        for name, value in state.items():
            parts = name.split(".")
            if parts[:2] == ["encoder", "layers"] and int(parts[2]) >= n_layers:
                continue
            t = value if isinstance(value, torch.Tensor) else torch.from_numpy(np.asarray(value))
            self.state[name] = t.detach().to(device=device, dtype=torch.float32)

    @torch.no_grad()
    def hidden_states(self, waveform: torch.Tensor) -> list[torch.Tensor]:
        """(N,) waveform -> [the projected input, layer 1, ..., layer
        n_layers], each (T, D): HF's hidden_states[0..n_layers]."""
        cfg, state = self.cfg, self.state
        x = input_features(waveform, cfg["num_mel_bins"], cfg["stride"])
        x = linear(layer_norm(x, state, "feature_projection.layer_norm", cfg["layer_norm_eps"]),
                   state, "feature_projection.projection")
        out = [x]
        for i in range(self.n_layers):
            x = encoder_layer(x, state, f"encoder.layers.{i}", cfg)
            out.append(x)
        return out

    def extract_layer(self, waveform: torch.Tensor, output_layer: int) -> torch.Tensor:
        """(1, N) -> (1, T, D): hidden_states[output_layer]."""
        if output_layer != self.n_layers:
            raise ValueError(f"built with {self.n_layers} layers, asked for {output_layer}")
        return self.hidden_states(waveform[0])[-1][None]
