"""WavLM (ref wavlm/WavLM.py): a frozen copy of knnsvc_torch/models/wavlm/model.py in which attention with
the gated relative position bias is plain PyTorch (`plain_attention`: einsums
and a softmax over the expanded (H, T, T) bias) instead of the CUDA kernel.
The reference builds it with only the layers a layer-6 encode runs.
"""

from __future__ import annotations

import math

import torch
import torch.nn as nn
import torch.nn.functional as F

from .config import WavLMConfig


def toeplitz_bias(diag: torch.Tensor) -> torch.Tensor:
    """(..., 2T-1) diagonal table -> (..., T, T) bias with
    bias[..., i, j] = diag[..., T-1 + j - i]."""
    T = (diag.shape[-1] + 1) // 2
    i = torch.arange(T, device=diag.device)
    return diag[..., (T - 1) + (i[None, :] - i[:, None])]


def plain_attention(q, k, v, pos_diag, gate):
    """softmax(q k^T d^-1/2 + gate * bias) v in plain PyTorch: q, k, v (H, T, d),
    gate (H, T), pos_diag the (H, 2T-1) diagonal table of the bias."""
    s = torch.einsum("htd,hsd->hts", q, k) * (q.shape[-1] ** -0.5)
    s = s + gate[..., None] * toeplitz_bias(pos_diag)
    return torch.einsum("hts,hsd->htd", torch.softmax(s, dim=-1), v)


# sample-length buckets of the bucketed encoder: ~1/2/4/8/16/30 s, aligned to
# the pool builder's hop + 1 padding (the JAX package's ENCODE_BUCKETS_SAMPLES)
ENCODE_BUCKETS_SAMPLES = tuple(s * 16000 + 320 for s in (1, 2, 4, 8, 16, 30))


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


def compute_position_diag(rel_attn_bias: torch.Tensor, seq_len: int, num_buckets: int,
                          max_distance: int) -> torch.Tensor:
    """(num_buckets, H) table -> (H, 2T-1) diagonal table: entry T-1 + j - i
    is the bias of query i and key j. The bucket indices are computed on the
    CPU, so every device gets the same ones."""
    offsets = torch.arange(-(seq_len - 1), seq_len)                     # j - i
    buckets = relative_position_bucket(offsets, num_buckets, max_distance)
    return rel_attn_bias[buckets.to(device=rel_attn_bias.device, dtype=torch.long)].T.contiguous()


def compute_position_bias(rel_attn_bias: torch.Tensor, seq_len: int, num_buckets: int,
                          max_distance: int) -> torch.Tensor:
    """(num_buckets, H) table -> (H, T, T) bias: the plain expansion of
    `compute_position_diag`."""
    return toeplitz_bias(compute_position_diag(rel_attn_bias, seq_len, num_buckets,
                                               max_distance)).contiguous()


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

    def forward(self, x: torch.Tensor, pos_diag: torch.Tensor | None,
                padding_mask: torch.Tensor | None = None) -> torch.Tensor:
        """pos_diag: the (H, 2T-1) diagonal table of the position bias, or
        None; padding_mask: (B, T) bool, True at padded frames, or None."""
        B, T, C = x.shape
        H = self.num_heads

        def heads(t):
            return t.view(B, T, H, C // H).transpose(1, 2)     # (B, H, T, hd)

        q, k, v = heads(self.q(x)), heads(self.k(x)), heads(self.v(x))
        if padding_mask is not None:
            gate = None if pos_diag is None else self.gate_values(x)
            out = masked_attention(q, k, v, pos_diag, gate, padding_mask)
        elif pos_diag is None:
            out = F.scaled_dot_product_attention(q, k, v)
        else:
            # one launch per batch row: the bias is shared across the batch
            gate = self.gate_values(x)[..., 0]                     # (B, H, T)
            out = torch.stack([
                plain_attention(q[b].contiguous(), k[b].contiguous(),
                                          v[b].contiguous(), pos_diag, gate[b].contiguous())
                for b in range(B)])
        return self.out(out.transpose(1, 2).reshape(B, T, C))


def masked_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                     pos_diag: torch.Tensor | None, gate: torch.Tensor | None,
                     padding_mask: torch.Tensor) -> torch.Tensor:
    """Attention with padded keys masked out, in plain PyTorch (the JAX
    package's einsum branch of multihead_attention): logits q k^T / sqrt(d)
    + gate * bias, -inf at padded keys, softmax, times v. q, k, v (B, H, T,
    d); gate (B, H, T, 1); padding_mask (B, T)."""
    logits = torch.einsum("bhqd,bhkd->bhqk", q * q.shape[-1] ** -0.5, k)
    if pos_diag is not None:
        logits = logits + gate * toeplitz_bias(pos_diag)[None]
    logits = logits.masked_fill(padding_mask[:, None, None, :], -torch.inf)
    return torch.einsum("bhqk,bhkd->bhqd", torch.softmax(logits, dim=-1), v)


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

    def forward(self, x: torch.Tensor, pos_diag: torch.Tensor | None,
                padding_mask: torch.Tensor | None = None) -> torch.Tensor:
        if self.layer_norm_first:
            x = x + self.attn(self.ln1(x), pos_diag, padding_mask)
            return x + self.fc2(F.gelu(self.fc1(self.ln2(x))))
        x = self.ln1(x + self.attn(x, pos_diag, padding_mask))
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
        self._bias_cache: dict = {}
        self._bias_key = None

    def _prelude(self, wav: torch.Tensor,
                 padding_mask: torch.Tensor | None = None) -> torch.Tensor:
        """wav (B, T_samples) -> transformer input (B, T, C). Padded frames
        are zeroed before the positional conv (ref WavLM.py:574-577), so its
        128-tap kernel cannot carry them into real frames."""
        feats = self.layer_norm(self.feature_extractor(wav).transpose(1, 2))
        if hasattr(self, "post_extract_proj"):
            feats = self.post_extract_proj(feats)
        if padding_mask is not None:
            feats = feats.masked_fill(padding_mask[:, :, None], 0.0)
        h = self.encoder.pos_conv(feats.transpose(1, 2))
        if self.cfg.conv_pos % 2 == 0:
            h = h[:, :, :-1]  # SamePad (ref wavlm/modules.py:72-83)
        x = feats + F.gelu(h.transpose(1, 2))
        if not self.cfg.layer_norm_first:
            x = self.encoder.layer_norm(x)
        return x

    def position_bias(self, seq_len: int) -> torch.Tensor | None:
        """The position bias as its (H, 2T-1) diagonal table, which depends
        only on (table, T): cached per T (both pools and every 30-s chunk
        share it), dropped when the table changes or moves."""
        return self._cached_bias(seq_len, lambda table: compute_position_diag(
            table, seq_len, self.cfg.num_buckets, self.cfg.max_distance))

    def _cached_bias(self, key, make) -> torch.Tensor | None:
        """make(table) memoized under `key`; the memo is dropped when the
        table changes or moves. None without a relative position table."""
        if not self.cfg.relative_position_embedding:
            return None
        table = self.encoder.rel_attn_bias
        table_key = (table.device, table.data_ptr(), table._version)
        if table_key != self._bias_key or len(self._bias_cache) > 16:
            self._bias_cache = {}
            self._bias_key = table_key
        if key not in self._bias_cache:
            with torch.no_grad():
                self._bias_cache[key] = make(table.detach())
        return self._bias_cache[key]

    def extract_layer(self, wav: torch.Tensor, output_layer: int,
                      padding_mask: torch.Tensor | None = None) -> torch.Tensor:
        """Features at encoder layer `output_layer` (1-based, as the
        reference's extract_features(output_layer=L)). (B, T_samples) ->
        (B, T, C). Only the first `output_layer` layers run. padding_mask
        (B, T) marks padded frames (masked attention, no kernel)."""
        x = self._prelude(wav, padding_mask)
        pos_diag = self.position_bias(x.shape[1])
        for layer in self.encoder.layers[:output_layer]:
            x = layer(x, pos_diag, padding_mask)
        return x
