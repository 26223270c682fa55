"""Typed configuration tree (the port's own copy of knnsvc_tpu/config.py —
the port imports nothing from the JAX package).

Replaces the reference's stringly-typed flags with enums + dataclasses while
keeping the exact dispatch semantics:

- ``ckpt_type`` substring dispatch (ref ddsp_hubconf.py:45-60,
  ddsp_prematch_dataset.py:1430,1453-1459): "wavlm_only*" / "*no_harm_no_amp*"
  -> f0-only SynthesizerTrn; "wavlm_only_original" -> plain HiFi-GAN v1
  generator; anything else ("mix*") -> mix SynthesizerTrn with harmonics.
- ``post_opt`` suffix encoding (ref ddsp_prematch_dataset.py:1273-1279):
  trailing float -> concat weight; trailing "extra" -> 0.3; otherwise disabled
  (-1). "no_post_opt" anywhere disables the smoothness optimizer
  (ref :1356,1437).
"""

from __future__ import annotations

import dataclasses
import enum
import json
from typing import Any, Sequence


class ModelFamily(enum.Enum):
    """Which vocoder architecture a checkpoint type maps to."""

    MIX = "mix"                      # DDSP harmonic excitation + mel trunk (ddsp_models.py)
    F0_ONLY = "f0_only"              # sine-only excitation (ddsp_models_f0.py)
    ORIGINAL = "original"            # plain HiFi-GAN v1 generator (missing hifigan/models.py in ref)


def model_family_for_ckpt_type(ckpt_type: str) -> ModelFamily:
    """Reference dispatch order: ddsp_hubconf.py:45-60."""
    if "wavlm_only" in ckpt_type or "no_harm_no_amp" in ckpt_type:
        if "wavlm_only_original" in ckpt_type:
            return ModelFamily.ORIGINAL
        return ModelFamily.F0_ONLY
    return ModelFamily.MIX


def uses_harmonics(ckpt_type: str) -> bool:
    """Whether the conversion pipeline must produce harmonic-amplitude features
    (ref ddsp_prematch_dataset.py:1430,1453-1459)."""
    return "wavlm_only" not in ckpt_type and "no_harm_no_amp" not in ckpt_type


@dataclasses.dataclass(frozen=True)
class PostOpt:
    """Parsed ``post_opt`` string."""

    raw: str
    enabled: bool          # run the smoothness (OPT) optimizer
    concat_weight: float   # -1.0 = concat-cost reselection disabled

    @staticmethod
    def parse(post_opt: str) -> "PostOpt":
        tail = post_opt.split("_")[-1]
        try:
            concat_weight = float(tail)
        except ValueError:
            concat_weight = 0.3 if tail == "extra" else -1.0
        return PostOpt(
            raw=post_opt,
            enabled="no_post_opt" not in post_opt,
            concat_weight=concat_weight,
        )


@dataclasses.dataclass(frozen=True)
class WavLMConfig:
    """WavLM hyper-parameters (ref wavlm/WavLM.py:162-217). Defaults here are
    the *Large* checkpoint values (the dataclass defaults in the reference are
    Base; Large overrides them via the ckpt's cfg dict)."""

    extractor_mode: str = "layer_norm"        # "default" | "layer_norm"
    encoder_layers: int = 24
    encoder_embed_dim: int = 1024
    encoder_ffn_embed_dim: int = 4096
    encoder_attention_heads: int = 16
    activation_fn: str = "gelu"
    layer_norm_first: bool = True
    conv_feature_layers: str = "[(512,10,5)] + [(512,3,2)] * 4 + [(512,2,2)] * 2"
    conv_bias: bool = False
    normalize: bool = True
    conv_pos: int = 128
    conv_pos_groups: int = 16
    relative_position_embedding: bool = True
    num_buckets: int = 320
    max_distance: int = 1280
    gru_rel_pos: bool = True
    feature_layer: int = 6                    # the matching and synthesis layer (ref ddsp_matcher.py:88)

    @property
    def conv_layers(self) -> Sequence[tuple[int, int, int]]:
        # the string is a python list literal of (dim, kernel, stride) triples
        layers = eval(self.conv_feature_layers)  # noqa: S307 - trusted config
        return tuple(tuple(l) for l in layers)

    @property
    def total_stride(self) -> int:
        s = 1
        for _, _, stride in self.conv_layers:
            s *= stride
        return s

    @staticmethod
    def from_dict(cfg: dict[str, Any]) -> "WavLMConfig":
        fields = {f.name for f in dataclasses.fields(WavLMConfig)}
        return WavLMConfig(**{k: v for k, v in cfg.items() if k in fields})


@dataclasses.dataclass(frozen=True)
class W2VBertConfig:
    """w2v-BERT 2.0 (facebook/w2v-bert-2.0, the speech encoder of Seamless,
    arXiv 2312.05187) under the key names of HF's Wav2Vec2BertConfig, whose
    defaults are the published model: a Kaldi fbank of `num_mel_bins` bins,
    `stride` frames stacked, LayerNorm + Linear to `hidden_size`, then
    Conformer layers with relative-key attention over the window
    [-left_max_position_embeddings, right_max_position_embeddings]. Only the
    first `feature_layer` layers are built and run: layer 17 gives the
    semantic features MaskGCT and IndexTTS2 take."""

    hidden_size: int = 1024
    num_hidden_layers: int = 24
    num_attention_heads: int = 16
    intermediate_size: int = 4096
    feature_projection_input_dim: int = 160
    conv_depthwise_kernel_size: int = 31
    left_max_position_embeddings: int = 64
    right_max_position_embeddings: int = 8
    num_mel_bins: int = 80
    stride: int = 2
    layer_norm_eps: float = 1e-5
    feature_layer: int = 17

    @property
    def layers_built(self) -> int:
        return min(self.feature_layer, self.num_hidden_layers)

    @staticmethod
    def from_dict(cfg: dict[str, Any]) -> "W2VBertConfig":
        """From HF's config.json keys. A key that would change the layer
        equations away from the published model's raises; others are
        ignored."""
        fixed = {"hidden_act": ("swish", "silu"), "position_embeddings_type": ("relative_key",),
                 "add_adapter": (False,), "use_intermediate_ffn_before_adapter": (False,)}
        for key, allowed in fixed.items():
            if key in cfg and cfg[key] not in allowed:
                raise ValueError(f"w2v-BERT 2.0 takes {key} in {allowed}, not {cfg[key]!r}")
        fields = {f.name for f in dataclasses.fields(W2VBertConfig)}
        return W2VBertConfig(**{k: v for k, v in cfg.items() if k in fields})


@dataclasses.dataclass(frozen=True)
class HiFiGANConfig:
    """Vocoder/trainer hyper-parameters (ref hifigan/config_v1_wavlm.json)."""

    resblock: str = "1"
    batch_size: int = 16
    learning_rate: float = 2e-4
    adam_b1: float = 0.8
    adam_b2: float = 0.99
    lr_decay: float = 0.999
    seed: int = 1234
    upsample_rates: tuple[int, ...] = (10, 8, 2, 2)
    upsample_kernel_sizes: tuple[int, ...] = (20, 16, 4, 4)
    upsample_initial_channel: int = 512
    resblock_kernel_sizes: tuple[int, ...] = (3, 7, 11)
    resblock_dilation_sizes: tuple[tuple[int, ...], ...] = ((1, 3, 5), (1, 3, 5), (1, 3, 5))
    n_harmonic: int = 32
    with_amp_ratio: bool = False
    with_harm: bool = True
    hubert_dim: int = 1024
    hifi_dim: int = 512
    segment_size: int = 7040
    num_mels: int = 80
    n_fft: int = 1024
    hop_size: int = 320
    win_size: int = 1024
    sampling_rate: int = 16000
    fmin: float = 0.0
    fmax: float = 8000.0
    num_workers: int = 12

    @staticmethod
    def from_json(path: str) -> "HiFiGANConfig":
        with open(path) as f:
            data = json.load(f)
        return HiFiGANConfig.from_dict(data)

    @staticmethod
    def from_dict(data: dict[str, Any]) -> "HiFiGANConfig":
        fields = {f.name for f in dataclasses.fields(HiFiGANConfig)}
        kwargs: dict[str, Any] = {}
        for k, v in data.items():
            if k not in fields:
                continue
            if isinstance(v, list):
                v = tuple(tuple(x) if isinstance(x, list) else x for x in v)
            kwargs[k] = v
        return HiFiGANConfig(**kwargs)
