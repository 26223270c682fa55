"""w2v-BERT 2.0 encoder as nn.Modules: the speech encoder of Seamless (arXiv
2312.05187; facebook/w2v-bert-2.0), following HF's Wav2Vec2BertModel
(transformers/models/wav2vec2_bert/modeling_wav2vec2_bert.py) at inference,
without padding masks, SpecAugment or adapter.

- frontend (dsp/fbank.py): the 80-bin Kaldi fbank of the waveform, two
  frames stacked, 160 values at 50 fps; then LayerNorm(160) and
  Linear(160 -> hidden);
- Conformer layers, each in order: a half-step swish FFN, self-attention
  with a relative-key term, the convolution module (LN, pointwise to twice
  the width, GLU, causal depthwise conv, LN, swish, pointwise), a second
  half-step FFN and a final LayerNorm;
- relative-key attention: score_ij = (q_i . k_j + q_i . E[clamp(j - i, -L,
  R) + L]) / sqrt(d), with E a (L + R + 1, d) table per layer shared by the
  heads. The relative term reaches the attention kernel's full-bias entry
  (ops.attention.gated_bias_attention) under a unit gate: the (H, T, L + R +
  1) products q E^T / sqrt(d), gathered into the (H, T, T) bias. One launch
  per layer and batch row on a card; CPU tensors take the plain version;
- early exit: `extract_layer(wav, L)` runs the first L layers; only the
  configuration's `feature_layer` layers are built.

Parameter names are HF's, so a Wav2Vec2BertModel state dict loads as it is
(`w2vbert_from_state_dict`). Each convolution module runs under the span
knnsvc.conformer_conv and the frontend under knnsvc.fbank, so a trace
charges their device time to them; `W2VBert.chunks` and
`W2VBert.layers_run` count the waveforms encoded and the layers run.
"""

from __future__ import annotations

import math
from typing import Any, Mapping

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F
from torch.profiler import record_function

from knnsvc_torch.config import W2VBertConfig
from knnsvc_torch.dsp.fbank import w2vbert_input_features
from knnsvc_torch.ops.attention import gated_bias_attention

ENCODER_NAME = "w2v-BERT 2.0"
# keys of HF's checkpoint that inference does not read
UNUSED_KEYS = ("masked_spec_embed",)


def relative_index(T: int, left: int, right: int, device) -> torch.Tensor:
    """(T, T) row of E for query i and key j: clamp(j - i, -left, right) + left."""
    i = torch.arange(T, device=device)
    return torch.clamp(i[None, :] - i[:, None], -left, right) + left


def relative_key_bias(q: torch.Tensor, table: torch.Tensor, index: torch.Tensor) -> torch.Tensor:
    """q (H, T, d), table (P, d), index (T, T) -> the (H, T, T) bias
    q_i . table[index_ij] / sqrt(d): the (H, T, P) products, then gathered."""
    H, T, d = q.shape
    products = torch.matmul(q, table.T) / math.sqrt(d)
    return torch.gather(products, 2, index.expand(H, T, T))


class FeatureProjection(nn.Module):
    def __init__(self, cfg: W2VBertConfig):
        super().__init__()
        self.layer_norm = nn.LayerNorm(cfg.feature_projection_input_dim, eps=cfg.layer_norm_eps)
        self.projection = nn.Linear(cfg.feature_projection_input_dim, cfg.hidden_size)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.projection(self.layer_norm(x))


class FeedForward(nn.Module):
    def __init__(self, cfg: W2VBertConfig):
        super().__init__()
        self.intermediate_dense = nn.Linear(cfg.hidden_size, cfg.intermediate_size)
        self.output_dense = nn.Linear(cfg.intermediate_size, cfg.hidden_size)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.output_dense(F.silu(self.intermediate_dense(x)))


class ConvolutionModule(nn.Module):
    """LN, pointwise D -> 2D, GLU, causal depthwise conv (kernel K, K - 1
    frames of left padding), LN, swish, pointwise D -> D. The pointwise
    convs (kernel 1, no bias) run as matmuls on (B, T, C) rows."""

    def __init__(self, cfg: W2VBertConfig):
        super().__init__()
        D, K = cfg.hidden_size, cfg.conv_depthwise_kernel_size
        self.layer_norm = nn.LayerNorm(D, eps=cfg.layer_norm_eps)
        self.pointwise_conv1 = nn.Conv1d(D, 2 * D, 1, bias=False)
        self.depthwise_conv = nn.Conv1d(D, D, K, groups=D, bias=False)
        self.depthwise_layer_norm = nn.LayerNorm(D, eps=cfg.layer_norm_eps)
        self.pointwise_conv2 = nn.Conv1d(D, D, 1, bias=False)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = F.glu(F.linear(self.layer_norm(x), self.pointwise_conv1.weight[:, :, 0]), dim=-1)
        K = self.depthwise_conv.kernel_size[0]
        h = F.conv1d(F.pad(h.transpose(1, 2), (K - 1, 0)), self.depthwise_conv.weight,
                     groups=self.depthwise_conv.groups)
        h = F.silu(self.depthwise_layer_norm(h.transpose(1, 2)))
        return F.linear(h, self.pointwise_conv2.weight[:, :, 0])


class RelativeKeyAttention(nn.Module):
    def __init__(self, cfg: W2VBertConfig):
        super().__init__()
        D = cfg.hidden_size
        self.num_heads = cfg.num_attention_heads
        self.linear_q, self.linear_k, self.linear_v, self.linear_out = (
            nn.Linear(D, D) for _ in range(4))
        self.distance_embedding = nn.Embedding(
            cfg.left_max_position_embeddings + cfg.right_max_position_embeddings + 1,
            D // cfg.num_attention_heads)

    def forward(self, x: torch.Tensor, index: torch.Tensor) -> torch.Tensor:
        """x (B, T, D); index (T, T) rows of the distance table."""
        B, T, D = x.shape
        H = self.num_heads

        def heads(t):
            return t.view(B, T, H, D // H).transpose(1, 2)      # (B, H, T, d)

        q, k, v = heads(self.linear_q(x)), heads(self.linear_k(x)), heads(self.linear_v(x))
        gate = x.new_ones(H, T)
        out = []
        for b in range(B):
            qb = q[b].contiguous()
            bias = relative_key_bias(qb, self.distance_embedding.weight, index)
            out.append(gated_bias_attention(qb, k[b].contiguous(), v[b].contiguous(), bias, gate))
        return self.linear_out(torch.stack(out).transpose(1, 2).reshape(B, T, D))


class ConformerLayer(nn.Module):
    def __init__(self, cfg: W2VBertConfig):
        super().__init__()
        D, eps = cfg.hidden_size, cfg.layer_norm_eps
        self.ffn1_layer_norm = nn.LayerNorm(D, eps=eps)
        self.ffn1 = FeedForward(cfg)
        self.self_attn_layer_norm = nn.LayerNorm(D, eps=eps)
        self.self_attn = RelativeKeyAttention(cfg)
        self.conv_module = ConvolutionModule(cfg)
        self.ffn2_layer_norm = nn.LayerNorm(D, eps=eps)
        self.ffn2 = FeedForward(cfg)
        self.final_layer_norm = nn.LayerNorm(D, eps=eps)

    def forward(self, x: torch.Tensor, index: torch.Tensor) -> torch.Tensor:
        x = self.ffn1(self.ffn1_layer_norm(x)) * 0.5 + x
        x = self.self_attn(self.self_attn_layer_norm(x), index) + x
        with record_function("knnsvc.conformer_conv"):
            x = x + self.conv_module(x)
        x = self.ffn2(self.ffn2_layer_norm(x)) * 0.5 + x
        return self.final_layer_norm(x)


class W2VBert(nn.Module):
    """The encoder's first `cfg.feature_layer` layers with the frontend."""

    chunks = 0          # waveforms encoded (batch rows), process-wide
    layers_run = 0      # layers run over them

    def __init__(self, cfg: W2VBertConfig):
        super().__init__()
        self.cfg = cfg
        self.feature_projection = FeatureProjection(cfg)
        self.encoder = nn.Module()
        self.encoder.layers = nn.ModuleList(ConformerLayer(cfg) for _ in range(cfg.layers_built))

    def input_features(self, wav: torch.Tensor) -> torch.Tensor:
        """(B, T_samples) -> (B, T, 160): the stacked fbank of each row."""
        cfg = self.cfg
        return torch.stack([w2vbert_input_features(w, cfg.num_mel_bins, cfg.stride)
                            for w in wav])

    def extract_layer(self, wav: torch.Tensor, output_layer: int) -> torch.Tensor:
        """Features at layer `output_layer` (1-based: HF's hidden_states[L]).
        (B, T_samples) float waveform in [-1, 1) -> (B, T, D). Only the first
        `output_layer` layers run."""
        if not 1 <= output_layer <= len(self.encoder.layers):
            raise ValueError(f"{ENCODER_NAME} holds layers 1..{len(self.encoder.layers)}, "
                             f"not {output_layer}")
        x = self.feature_projection(self.input_features(wav))
        cfg = self.cfg
        index = relative_index(x.shape[1], cfg.left_max_position_embeddings,
                               cfg.right_max_position_embeddings, x.device)
        for layer in self.encoder.layers[:output_layer]:
            x = layer(x, index)
        W2VBert.chunks += wav.shape[0]
        W2VBert.layers_run += wav.shape[0] * output_layer
        return x

    def extract_layer_bucketed(self, wav: torch.Tensor, output_layer: int) -> torch.Tensor:
        raise NotImplementedError(f"the bucketed encoder serves WavLM only, not {ENCODER_NAME}")

    def extract_all_layers(self, wav: torch.Tensor) -> torch.Tensor:
        raise NotImplementedError(f"the all-layer encoder serves WavLM only, not {ENCODER_NAME}")


def w2vbert_from_state_dict(state: Mapping[str, Any], cfg: W2VBertConfig,
                            device) -> W2VBert:
    """A Wav2Vec2BertModel state dict (HF's names; tensors or arrays) ->
    the encoder on `device`, eval mode, holding copies of the values. Layers
    past `cfg.feature_layer` and the keys inference does not read are
    dropped; every other key must be there, with its shape. The modules are
    built on the meta device, so no parameter is initialised only to be
    overwritten."""
    kept = {}
    for name, value in state.items():
        parts = name.split(".")
        if name in UNUSED_KEYS or (parts[:2] == ["encoder", "layers"]
                                   and int(parts[2]) >= cfg.layers_built):
            continue
        t = value if isinstance(value, torch.Tensor) else torch.from_numpy(np.asarray(value))
        kept[name] = t.detach().to(device=device, dtype=torch.float32, copy=True)
    with torch.device("meta"):
        model = W2VBert(cfg)
    model.load_state_dict(kept, strict=True, assign=True)
    return model.eval()


def init_w2vbert_params(cfg: W2VBertConfig, generator: torch.Generator) -> dict[str, np.ndarray]:
    """Random weights of the built layers under HF's names (numpy), from HF's
    `_init_weights` distributions: Linear N(0, 0.02) with zero biases, the
    projection U(-k, k) with k = 160^-1/2, convs Kaiming-normal
    (N(0, 2 / fan_in)), LayerNorms ones and zeros, the distance tables
    N(0, 1) (nn.Embedding's own)."""
    D, Fd, K = cfg.hidden_size, cfg.intermediate_size, cfg.conv_depthwise_kernel_size
    P, d = cfg.left_max_position_embeddings + cfg.right_max_position_embeddings + 1, \
        D // cfg.num_attention_heads
    Din = cfg.feature_projection_input_dim

    def normal(shape, std):
        return (torch.randn(shape, generator=generator) * std).numpy()

    def ln(prefix, dim):
        return {f"{prefix}.weight": np.ones(dim, np.float32),
                f"{prefix}.bias": np.zeros(dim, np.float32)}

    def lin(prefix, din, dout):
        return {f"{prefix}.weight": normal((dout, din), 0.02),
                f"{prefix}.bias": np.zeros(dout, np.float32)}

    k = Din ** -0.5
    params = {**ln("feature_projection.layer_norm", Din),
              "feature_projection.projection.weight":
                  ((torch.rand((D, Din), generator=generator) * 2 - 1) * k).numpy(),
              "feature_projection.projection.bias":
                  ((torch.rand((D,), generator=generator) * 2 - 1) * k).numpy()}
    for i in range(cfg.layers_built):
        p = f"encoder.layers.{i}"
        for ffn in ("ffn1", "ffn2"):
            params.update(ln(f"{p}.{ffn}_layer_norm", D))
            params.update(lin(f"{p}.{ffn}.intermediate_dense", D, Fd))
            params.update(lin(f"{p}.{ffn}.output_dense", Fd, D))
        params.update(ln(f"{p}.self_attn_layer_norm", D))
        for name in ("linear_q", "linear_k", "linear_v", "linear_out"):
            params.update(lin(f"{p}.self_attn.{name}", D, D))
        params[f"{p}.self_attn.distance_embedding.weight"] = normal((P, d), 1.0)
        params.update(ln(f"{p}.conv_module.layer_norm", D))
        params[f"{p}.conv_module.pointwise_conv1.weight"] = normal((2 * D, D, 1), (2 / D) ** 0.5)
        params[f"{p}.conv_module.depthwise_conv.weight"] = normal((D, 1, K), (2 / K) ** 0.5)
        params.update(ln(f"{p}.conv_module.depthwise_layer_norm", D))
        params[f"{p}.conv_module.pointwise_conv2.weight"] = normal((D, D, 1), (2 / D) ** 0.5)
        params.update(ln(f"{p}.final_layer_norm", D))
    return params
