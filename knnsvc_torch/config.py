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
