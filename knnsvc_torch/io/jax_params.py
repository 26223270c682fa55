"""Carries the JAX package's parameter pytrees (nested dicts and lists of
numpy arrays, as its init functions and `.knnsvc.pkl` files hold them) into
the port's nn.Modules.

The layouts differ in three ways only:
- a Linear's `w` is stored (in, out) and becomes `weight = w.T` — every 2-D
  `w` in both models is a Linear (conv weights are 3-D, already in torch's
  (out, in/groups, k) layout; ConvTranspose1d's (in, out, k) likewise);
- WavLM's encoder layers are stacked on a leading axis and become a
  ModuleList;
- a live weight norm {"g", "v"} is folded to w = g * v / ||v|| (norm over
  every dim but 0, torch's weight_norm default); checkpoints usually arrive
  folded already ({"w"}).
Module attribute names follow the pytree keys, so the rest is renaming
(w -> weight, b -> bias, LayerNorm scale -> weight).
"""

from __future__ import annotations

import pickle
from typing import Any, Iterator

import numpy as np
import torch
import torch.nn as nn

from knnsvc_torch.config import HiFiGANConfig, ModelFamily, WavLMConfig

_RENAME = {"w": "weight", "b": "bias", "scale": "weight"}


def _fold_weight_norm(p: dict) -> dict:
    v = np.asarray(p["v"], np.float32)
    norm = np.sqrt(np.sum(v * v, axis=tuple(range(1, v.ndim)), keepdims=True))
    folded = {k: x for k, x in p.items() if k not in ("g", "v")}
    folded["w"] = np.asarray(p["g"], np.float32) * v / norm
    return folded


def _state_items(tree, prefix: str = "") -> Iterator[tuple[str, torch.Tensor]]:
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


def _build(module_cls, args: tuple, tree, device) -> nn.Module:
    """Construct without allocating or initializing weights, then take
    copies of the arrays of `tree` as the parameters."""
    with torch.device("meta"):
        module = module_cls(*args)
    module.load_state_dict(dict(_state_items(tree)), strict=True, assign=True)
    return module.to(device).eval()


def _unstack_layers(params: dict, cfg: WavLMConfig) -> dict:
    stacked = params["encoder"]["layers"]

    def take(tree, i):
        if isinstance(tree, dict):
            return {k: take(v, i) for k, v in tree.items()}
        return np.asarray(tree)[i]

    n = np.asarray(stacked["ln1"]["scale"]).shape[0]
    if n < cfg.encoder_layers:
        raise ValueError(f"params hold {n} encoder layers, config wants {cfg.encoder_layers}")
    encoder = dict(params["encoder"])
    encoder["layers"] = [take(stacked, i) for i in range(cfg.encoder_layers)]
    return {**params, "encoder": encoder}


def wavlm_from_numpy(params: dict[str, Any], cfg: WavLMConfig,
                     device: str | torch.device = "cpu") -> nn.Module:
    """The JAX package's WavLM pytree -> models.wavlm.WavLM on `device`."""
    from knnsvc_torch.models.wavlm.model import WavLM

    return _build(WavLM, (cfg,), _unstack_layers(params, cfg), device)


def generator_from_numpy(params: dict[str, Any], h: HiFiGANConfig, family: ModelFamily,
                         device: str | torch.device = "cpu") -> nn.Module:
    """The JAX package's HiFi-GAN pytree ({"dec": ..., "sin_prenet": ...})
    -> models.hifigan.Synthesizer on `device`."""
    from knnsvc_torch.models.hifigan.generator import Synthesizer

    return _build(Synthesizer, (h, family), params, device)


def load_params(path: str) -> Any:
    """Read a `.knnsvc.pkl` parameter file (pickled numpy pytree) written by
    the JAX package's save_params. Unpickling runs code: load only files
    this program family wrote."""
    with open(path, "rb") as f:
        return pickle.load(f)
