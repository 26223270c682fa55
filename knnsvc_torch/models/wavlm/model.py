"""WavLM encoder as nn.Modules (counterpart of knnsvc_tpu/models/wavlm/model.py).

Architecture (ref wavlm/WavLM.py, wavlm/modules.py), as in the JAX package:

- conv frontend: strided Conv1d blocks, total stride 320; 'layer_norm' mode
  = LayerNorm on every block, 'default' = GroupNorm(C, C) on block 0 only;
  exact (erf) GELU throughout;
- positional conv: Conv1d(k=128, groups=16), weight norm folded at load,
  SamePad trims 1, GELU;
- transformer: T5-bucketed relative position bias computed once from the
  shared (num_buckets, H) table and reused by every layer; each layer gates
  it per query with gru_rel_pos values computed from the layer's post-LN
  attention input (not from q);
- early exit: `extract_layer(wav, L)` runs only the first L layers and skips
  the final encoder LayerNorm (ref WavLM.py:567).

Attention with the position bias goes through
ops.attention.gated_bias_attention, one call per batch row — the CUDA
kernel on a card, in both precision modes (the JAX package keeps its
HIGHEST mode off the Pallas kernel only because MXU dots are bf16). The
bucketed/masked encoder is not ported yet.
"""

from __future__ import annotations

import math
from typing import Any

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from knnsvc_torch.config import WavLMConfig
from knnsvc_torch.ops.attention import gated_bias_attention

Params = dict[str, Any]


def frame_count(cfg: WavLMConfig, n_samples: int) -> int:
    """Output frames of the conv frontend for a given sample count."""
    t = n_samples
    for _, kernel, stride in cfg.conv_layers:
        t = (t - kernel) // stride + 1
    return t


def relative_position_bucket(relative_position: torch.Tensor, num_buckets: int,
                             max_distance: int) -> torch.Tensor:
    """Bidirectional T5 bucketing (ref wavlm/modules.py:417-442). The log
    math is float32, as in the reference and the JAX package: float64 flips
    bucket boundaries."""
    num_buckets = num_buckets // 2
    relative_buckets = (relative_position > 0).to(torch.int32) * num_buckets
    rel = relative_position.abs()
    max_exact = num_buckets // 2
    is_small = rel < max_exact
    rel_if_large = max_exact + (
        torch.log(rel.to(torch.float32) / max_exact)
        / math.log(max_distance / max_exact)
        * (num_buckets - max_exact)
    ).to(torch.int32)
    rel_if_large = torch.clamp(rel_if_large, max=num_buckets - 1)
    return relative_buckets + torch.where(is_small, rel.to(torch.int32), rel_if_large)


def compute_position_bias(rel_attn_bias: torch.Tensor, seq_len: int, num_buckets: int,
                          max_distance: int) -> torch.Tensor:
    """(num_buckets, H) table -> (H, T, T) bias, gathered from the 2T-1
    distinct offsets. The bucket indices are computed on the CPU, so every
    device gets the same ones."""
    offsets = torch.arange(-(seq_len - 1), seq_len)                     # j - i
    buckets = relative_position_bucket(offsets, num_buckets, max_distance)
    diag = rel_attn_bias[buckets.to(device=rel_attn_bias.device, dtype=torch.long)].T  # (H, 2T-1)
    i = torch.arange(seq_len, device=rel_attn_bias.device)
    idx = (seq_len - 1) + (i[None, :] - i[:, None])                     # (T, T)
    return diag[:, idx].contiguous()


class ConvFrontend(nn.Module):
    """(B, T_samples) -> (B, C, T_frames). Ref wavlm/WavLM.py:378-504."""

    def __init__(self, cfg: WavLMConfig):
        super().__init__()
        self.mode = cfg.extractor_mode
        self.layers = nn.ModuleList()
        in_d = 1
        for i, (dim, kernel, stride) in enumerate(cfg.conv_layers):
            blk = nn.Module()
            blk.conv = nn.Conv1d(in_d, dim, kernel, stride=stride, bias=cfg.conv_bias)
            if self.mode == "layer_norm":
                blk.norm = nn.LayerNorm(dim)
            elif self.mode == "default" and i == 0:
                blk.norm = nn.GroupNorm(dim, dim)
            self.layers.append(blk)
            in_d = dim

    def forward(self, wav: torch.Tensor) -> torch.Tensor:
        x = wav[:, None, :]
        for blk in self.layers:
            x = blk.conv(x)
            if self.mode == "layer_norm":
                x = blk.norm(x.transpose(1, 2)).transpose(1, 2)
            elif hasattr(blk, "norm"):
                x = blk.norm(x)
            x = F.gelu(x)
        return x


class MultiheadAttention(nn.Module):
    """Self-attention with the gated relative position bias
    (ref wavlm/modules.py:520-563)."""

    def __init__(self, cfg: WavLMConfig):
        super().__init__()
        D, H = cfg.encoder_embed_dim, cfg.encoder_attention_heads
        self.num_heads = H
        self.q, self.k, self.v, self.out = (nn.Linear(D, D) for _ in range(4))
        if cfg.gru_rel_pos:
            self.grep = nn.Linear(D // H, 8)
            self.grep_a = nn.Parameter(torch.ones(H))

    def gate_values(self, x: torch.Tensor) -> torch.Tensor:
        """gate per (B, H, T, 1), from the post-LN attention input x."""
        B, T, C = x.shape
        H = self.num_heads
        if not hasattr(self, "grep"):
            return x.new_ones(B, H, T, 1)
        g = self.grep(x.view(B, T, H, C // H).transpose(1, 2))
        gate_a, gate_b = torch.sigmoid(g.view(B, H, T, 2, 4).sum(-1)).chunk(2, dim=-1)
        return gate_a * (gate_b * self.grep_a.view(1, H, 1, 1) - 1.0) + 2.0

    def forward(self, x: torch.Tensor, pos_bias: torch.Tensor | None) -> torch.Tensor:
        B, T, C = x.shape
        H = self.num_heads

        def heads(t):
            return t.view(B, T, H, C // H).transpose(1, 2)     # (B, H, T, hd)

        q, k, v = heads(self.q(x)), heads(self.k(x)), heads(self.v(x))
        if pos_bias is None:
            out = F.scaled_dot_product_attention(q, k, v)
        else:
            # one launch per batch row: the bias is shared across the batch
            gate = self.gate_values(x)[..., 0]                     # (B, H, T)
            out = torch.stack([
                gated_bias_attention(q[b].contiguous(), k[b].contiguous(), v[b].contiguous(),
                                     pos_bias, gate[b].contiguous())
                for b in range(B)])
        return self.out(out.transpose(1, 2).reshape(B, T, C))


class EncoderLayer(nn.Module):
    """One transformer layer (ref wavlm/WavLM.py:677-742)."""

    def __init__(self, cfg: WavLMConfig):
        super().__init__()
        D = cfg.encoder_embed_dim
        self.layer_norm_first = cfg.layer_norm_first
        self.attn = MultiheadAttention(cfg)
        self.ln1 = nn.LayerNorm(D)
        self.fc1 = nn.Linear(D, cfg.encoder_ffn_embed_dim)
        self.fc2 = nn.Linear(cfg.encoder_ffn_embed_dim, D)
        self.ln2 = nn.LayerNorm(D)

    def forward(self, x: torch.Tensor, pos_bias: torch.Tensor | None) -> torch.Tensor:
        if self.layer_norm_first:
            x = x + self.attn(self.ln1(x), pos_bias)
            return x + self.fc2(F.gelu(self.fc1(self.ln2(x))))
        x = self.ln1(x + self.attn(x, pos_bias))
        return self.ln2(x + self.fc2(F.gelu(self.fc1(x))))


class Encoder(nn.Module):
    def __init__(self, cfg: WavLMConfig):
        super().__init__()
        D = cfg.encoder_embed_dim
        self.pos_conv = nn.Conv1d(D, D, cfg.conv_pos, padding=cfg.conv_pos // 2,
                                  groups=cfg.conv_pos_groups)
        self.layer_norm = nn.LayerNorm(D)
        self.layers = nn.ModuleList(EncoderLayer(cfg) for _ in range(cfg.encoder_layers))
        if cfg.relative_position_embedding:
            self.rel_attn_bias = nn.Parameter(
                torch.zeros(cfg.num_buckets, cfg.encoder_attention_heads))


class WavLM(nn.Module):
    """WavLM encoder; parameter names follow the JAX package's pytree
    (io/jax_params.py carries them across)."""

    def __init__(self, cfg: WavLMConfig):
        super().__init__()
        self.cfg = cfg
        c0 = cfg.conv_layers[-1][0]
        self.feature_extractor = ConvFrontend(cfg)
        self.layer_norm = nn.LayerNorm(c0)
        if c0 != cfg.encoder_embed_dim:
            self.post_extract_proj = nn.Linear(c0, cfg.encoder_embed_dim)
        self.encoder = Encoder(cfg)
        self._bias_cache: dict[int, torch.Tensor] = {}
        self._bias_key = None

    def _prelude(self, wav: torch.Tensor) -> torch.Tensor:
        """wav (B, T_samples) -> transformer input (B, T, C)."""
        feats = self.layer_norm(self.feature_extractor(wav).transpose(1, 2))
        if hasattr(self, "post_extract_proj"):
            feats = self.post_extract_proj(feats)
        h = self.encoder.pos_conv(feats.transpose(1, 2))
        if self.cfg.conv_pos % 2 == 0:
            h = h[:, :, :-1]  # SamePad (ref wavlm/modules.py:72-83)
        x = feats + F.gelu(h.transpose(1, 2))
        if not self.cfg.layer_norm_first:
            x = self.encoder.layer_norm(x)
        return x

    def position_bias(self, seq_len: int) -> torch.Tensor | None:
        """The (H, T, T) bias depends only on (table, T): cached per T (both
        pools and every 30-s chunk share it), dropped when the table changes
        or moves."""
        if not self.cfg.relative_position_embedding:
            return None
        table = self.encoder.rel_attn_bias
        key = (table.device, table.data_ptr(), table._version)
        if key != self._bias_key or len(self._bias_cache) > 16:
            self._bias_cache = {}
            self._bias_key = key
        if seq_len not in self._bias_cache:
            with torch.no_grad():
                self._bias_cache[seq_len] = compute_position_bias(
                    table.detach(), seq_len, self.cfg.num_buckets, self.cfg.max_distance)
        return self._bias_cache[seq_len]

    def extract_layer(self, wav: torch.Tensor, output_layer: int) -> torch.Tensor:
        """Features at encoder layer `output_layer` (1-based, as the
        reference's extract_features(output_layer=L)). (B, T_samples) ->
        (B, T, C). Only the first `output_layer` layers run."""
        x = self._prelude(wav)
        pos_bias = self.position_bias(x.shape[1])
        for layer in self.encoder.layers[:output_layer]:
            x = layer(x, pos_bias)
        return x


def init_wavlm_params(cfg: WavLMConfig, generator: torch.Generator) -> Params:
    """Random weights in the JAX package's pytree layout (numpy; the layers
    stacked on a leading axis), drawn from the same distributions as its
    init_wavlm_params — for tests and benchmarks."""
    D = cfg.encoder_embed_dim
    n_layers = cfg.encoder_layers

    def normal(shape, std):
        return (torch.randn(shape, generator=generator) * std).numpy()

    def zeros(*shape):
        return np.zeros(shape, np.float32)

    def ones(*shape):
        return np.ones(shape, np.float32)

    fe_layers = []
    in_d = 1
    for i, (dim, kernel, _) in enumerate(cfg.conv_layers):
        blk: Params = {"conv": {"w": normal((dim, in_d, kernel), 0.05)}}
        if cfg.conv_bias:
            blk["conv"]["b"] = zeros(dim)
        if cfg.extractor_mode == "layer_norm" or (cfg.extractor_mode == "default" and i == 0):
            blk["norm"] = {"scale": ones(dim), "bias": zeros(dim)}
        fe_layers.append(blk)
        in_d = dim

    def stacked_lin(din, dout):
        return {"w": normal((n_layers, din, dout), 0.02), "b": zeros(n_layers, dout)}

    def stacked_ln(dim):
        return {"scale": ones(n_layers, dim), "bias": zeros(n_layers, dim)}

    layers: Params = {
        "attn": {name: stacked_lin(D, D) for name in ("q", "k", "v", "out")},
        "ln1": stacked_ln(D),
        "fc1": stacked_lin(D, cfg.encoder_ffn_embed_dim),
        "fc2": stacked_lin(cfg.encoder_ffn_embed_dim, D),
        "ln2": stacked_ln(D),
    }
    if cfg.gru_rel_pos:
        layers["attn"]["grep"] = stacked_lin(D // cfg.encoder_attention_heads, 8)
        layers["attn"]["grep_a"] = ones(n_layers, cfg.encoder_attention_heads)

    c0 = cfg.conv_layers[-1][0]
    params: Params = {
        "feature_extractor": {"layers": fe_layers},
        "layer_norm": {"scale": ones(c0), "bias": zeros(c0)},
        "encoder": {
            "pos_conv": {"w": normal((D, D // cfg.conv_pos_groups, cfg.conv_pos), 0.01),
                         "b": zeros(D)},
            "layer_norm": {"scale": ones(D), "bias": zeros(D)},
            "layers": layers,
        },
    }
    if c0 != D:
        params["post_extract_proj"] = {"w": normal((c0, D), 0.02), "b": zeros(D)}
    if cfg.relative_position_embedding:
        params["encoder"]["rel_attn_bias"] = normal(
            (cfg.num_buckets, cfg.encoder_attention_heads), 0.02)
    return params
