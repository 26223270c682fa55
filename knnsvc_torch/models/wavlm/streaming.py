"""Incremental streaming WavLM encoder with a K/V cache (counterpart of
knnsvc_tpu/models/wavlm/streaming.py).

The windowed streaming mode (hub.stream_convert_chunks, encoder='windowed')
re-encodes [chunk - context, chunk + lookahead] every chunk. This encoder
encodes only each step's new frames:

- the conv frontend runs on the step's samples alone: frame t depends only
  on samples [t*hop, t*hop + receptive_field), and WavLM-Large's
  'layer_norm' extractor normalizes per frame, so a step's frames equal the
  batch encode's (the 'default' mode's GroupNorm takes the step's frames
  as its statistics, as a window does);
- the positional conv reads a cache of the last conv_pos // 2 projected
  frames on the left and zeros past the lookahead on the right;
- each layer attends the step's frames over [cache || new] keys: the cache
  holds the last `cache_frames` final frames' keys and values per layer,
  computed when those frames were final. Cache slots fill from the back;
  slot j is masked (-inf) while j < cache_frames - valid.

The whole state (the K/V ring, the positional-conv cache, the fill count)
stays on the encoder's device between steps; a step uploads its samples
and nothing else. The cached attention is rectangular (Tn queries over
Tc + Tn keys) and key-masked, which the attention kernel does not take: it
runs in plain PyTorch (span `knnsvc.cached_attention`), as the JAX package
runs it in XLA einsums (streaming.py:121-151 there), reusing each layer's
q/k/v/out Linears and gate, so no weight is copied. A step runs in the
span `knnsvc.stream_encode`.
"""

from __future__ import annotations

from typing import NamedTuple

import torch
import torch.nn.functional as F
from torch.profiler import record_function

from knnsvc_torch.config import WavLMConfig
from knnsvc_torch.models.wavlm.model import (MultiheadAttention, WavLM, frame_count,
                                             relative_position_bucket)


def conv_receptive_field(cfg: WavLMConfig) -> int:
    """Samples of input one frame of the conv frontend depends on
    (WavLM-Large: 400 at hop 320)."""
    rf = 1
    for _, kernel, stride in reversed(cfg.conv_layers):
        rf = (rf - 1) * stride + kernel
    return rf


def step_sample_len(cfg: WavLMConfig, n_frames: int) -> int:
    """Samples a step of `n_frames` new frames takes: (n_frames - 1) * hop
    + receptive_field."""
    n = (n_frames - 1) * cfg.total_stride + conv_receptive_field(cfg)
    if frame_count(cfg, n) != n_frames:
        raise AssertionError((n, n_frames))
    return n


class WavLMStreamState(NamedTuple):
    """The encoder's carry, on its device."""

    k_cache: torch.Tensor      # (L, H, Tc, head_dim) per-layer key cache
    v_cache: torch.Tensor      # (L, H, Tc, head_dim)
    feat_cache: torch.Tensor   # (conv_pos // 2, C) projected frames for the positional conv
    valid: torch.Tensor        # () int32: filled cache slots, the last `valid`


def init_stream_state(cfg: WavLMConfig, n_layers: int, cache_frames: int,
                      device: str | torch.device = "cpu") -> WavLMStreamState:
    """A fresh state: the cache empty and fully masked."""
    D = cfg.encoder_embed_dim
    H = cfg.encoder_attention_heads
    kv = (n_layers, H, cache_frames, D // H)
    return WavLMStreamState(
        k_cache=torch.zeros(kv, device=device),
        v_cache=torch.zeros(kv, device=device),
        feat_cache=torch.zeros((cfg.conv_pos // 2, D), device=device),
        valid=torch.zeros((), dtype=torch.int32, device=device))


def _stream_position_bias(table: torch.Tensor, t_cache: int, t_new: int, num_buckets: int,
                          max_distance: int) -> torch.Tensor:
    """(H, Tn, Tc+Tn) bias from the (num_buckets, H) table. Key slot j sits
    j - Tc frames from the step's first frame (cache slots are older), query
    i at +i: the offsets are local and the same every step, so the bias is
    a diagonal table of Tc + 2 Tn - 1 offsets, expanded. The buckets are
    computed on the CPU, so every device gets the same ones."""
    offsets = torch.arange(-(t_cache + t_new - 1), t_new)                # j - Tc - i
    buckets = relative_position_bucket(offsets, num_buckets, max_distance)
    diag = table[buckets.to(device=table.device, dtype=torch.long)]       # (Tc+2Tn-1, H)
    i = torch.arange(t_new)
    j = torch.arange(t_cache + t_new)
    idx = (j[None, :] - t_cache - i[:, None]) + (t_cache + t_new - 1)
    return diag[idx.to(table.device)].permute(2, 0, 1).contiguous()      # (H, Tn, Tc+Tn)


def stream_position_bias(wavlm: WavLM, t_cache: int, t_new: int) -> torch.Tensor | None:
    """_stream_position_bias of the encoder's table, cached per (Tc, Tn)
    beside WavLM.position_bias's per-T diagonals; None without a table."""
    cfg = wavlm.cfg
    return wavlm._cached_bias(("stream", t_cache, t_new), lambda table: _stream_position_bias(
        table, t_cache, t_new, cfg.num_buckets, cfg.max_distance))


def _cached_attention(x: torch.Tensor, attn: MultiheadAttention,
                      pos_bias: torch.Tensor | None, k_cache: torch.Tensor,
                      v_cache: torch.Tensor, key_invalid: torch.Tensor):
    """Self-attention of Tn query frames over [cache || new] keys, in plain
    PyTorch. x (Tn, C); k_cache, v_cache (H, Tc, hd); key_invalid (Tc+Tn,)
    bool. -> (out (Tn, C), k_new (H, Tn, hd), v_new (H, Tn, hd))."""
    Tn, C = x.shape
    H = attn.num_heads
    hd = C // H

    def heads(t):
        return t.view(Tn, H, hd).transpose(0, 1)                          # (H, Tn, hd)

    with record_function("knnsvc.cached_attention"):
        q = heads(attn.q(x)) * hd ** -0.5
        k_new, v_new = heads(attn.k(x)), heads(attn.v(x))
        k = torch.cat([k_cache, k_new], dim=1)                            # (H, Tc+Tn, hd)
        v = torch.cat([v_cache, v_new], dim=1)
        logits = torch.einsum("hqd,hkd->hqk", q, k)
        if pos_bias is not None:
            logits = logits + attn.gate_values(x[None])[0] * pos_bias     # gate (H, Tn, 1)
        logits = logits.masked_fill(key_invalid[None, None, :], -torch.inf)
        out = torch.einsum("hqk,hkd->hqd", torch.softmax(logits, dim=-1), v)
        return attn.out(out.transpose(0, 1).reshape(Tn, C)), k_new, v_new


@torch.no_grad()
def _stream_step(wavlm: WavLM, samples: torch.Tensor, state: WavLMStreamState,
                 output_layer: int, n_final: int):
    """One step. samples (step_sample_len(cfg, Tn),) on the encoder's device
    cover frames [t0, t0 + Tn); the first `n_final` are final (their K/V
    and projected frames enter the caches), the rest are lookahead that a
    later step presents again. -> (features (Tn, C) at layer
    `output_layer`, new state)."""
    cfg = wavlm.cfg
    enc = wavlm.encoder
    Tc = state.k_cache.shape[2]
    feats = wavlm.layer_norm(wavlm.feature_extractor(samples[None]).transpose(1, 2))[0]
    if hasattr(wavlm, "post_extract_proj"):
        feats = wavlm.post_extract_proj(feats)
    Tn = feats.shape[0]

    # positional conv over [cached left | new | zero right], no built-in
    # padding: output i reads frames [t0 - K/2 + i, t0 + i + K/2 - 1], the
    # batch encode's SamePad arithmetic with real left context
    K = cfg.conv_pos
    xin = torch.cat([state.feat_cache, feats, feats.new_zeros(K - 1 - K // 2, feats.shape[1])])
    pos = F.conv1d(xin.T[None], enc.pos_conv.weight, enc.pos_conv.bias,
                   groups=cfg.conv_pos_groups)[0].T
    x = feats + F.gelu(pos)
    if not cfg.layer_norm_first:
        x = enc.layer_norm(x)

    pos_bias = stream_position_bias(wavlm, Tc, Tn)
    key_invalid = torch.cat([torch.arange(Tc, device=x.device) < Tc - state.valid,
                             torch.zeros(Tn, dtype=torch.bool, device=x.device)])
    k_fin, v_fin = [], []
    for layer, kc, vc in zip(enc.layers[:output_layer], state.k_cache, state.v_cache):
        if cfg.layer_norm_first:
            attn, k_new, v_new = _cached_attention(layer.ln1(x), layer.attn, pos_bias, kc, vc,
                                                   key_invalid)
            x = x + attn
            x = x + layer.fc2(F.gelu(layer.fc1(layer.ln2(x))))
        else:
            attn, k_new, v_new = _cached_attention(x, layer.attn, pos_bias, kc, vc, key_invalid)
            x = layer.ln1(x + attn)
            x = layer.ln2(x + layer.fc2(F.gelu(layer.fc1(x))))
        # only the final frames' K/V are cached: the lookahead is encoded again
        k_fin.append(k_new[:, :n_final])
        v_fin.append(v_new[:, :n_final])
    # the early exit skips the final encoder LayerNorm (ref wavlm/WavLM.py:567)
    new_state = WavLMStreamState(
        k_cache=torch.cat([state.k_cache, torch.stack(k_fin)], dim=2)[:, :, -Tc:],
        v_cache=torch.cat([state.v_cache, torch.stack(v_fin)], dim=2)[:, :, -Tc:],
        feat_cache=torch.cat([state.feat_cache, feats[:n_final]])[-(K // 2):],
        valid=torch.clamp(state.valid + n_final, max=Tc))
    return x, new_state


class WavLMStreamEncoder:
    """Feeds fixed-size sample steps through the encoder's first
    `output_layer` layers and keeps the state on the encoder's device."""

    def __init__(self, wavlm: WavLM, output_layer: int, chunk_frames: int,
                 lookahead_frames: int = 0, cache_frames: int = 200):
        if cache_frames < 1:
            raise ValueError("cache_frames must be >= 1")
        self.wavlm = wavlm
        self.device = next(wavlm.parameters()).device
        self.output_layer = output_layer
        self.n_final = chunk_frames
        self.n_frames = chunk_frames + lookahead_frames
        self.sample_len = step_sample_len(wavlm.cfg, self.n_frames)
        self.state = init_stream_state(wavlm.cfg, output_layer, cache_frames, self.device)

    def step(self, samples) -> torch.Tensor:
        """samples (sample_len,), numpy or a tensor: frames [t0, t0 +
        chunk + lookahead), t0 advancing by chunk_frames per call (the
        caller sends the lookahead's samples again). -> (chunk + lookahead,
        C) features on the device; the first chunk_frames rows are final."""
        x = torch.as_tensor(samples, dtype=torch.float32)
        if tuple(x.shape) != (self.sample_len,):
            raise ValueError(f"step needs exactly {self.sample_len} samples "
                             f"(got {tuple(x.shape)}); zero-pad the tail")
        with record_function("knnsvc.stream_encode"):
            out, self.state = _stream_step(self.wavlm, x.to(self.device), self.state,
                                           self.output_layer, self.n_final)
        return out
