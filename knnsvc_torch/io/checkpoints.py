"""PyTorch checkpoint -> parameter pytree conversion (the port's own copy of
knnsvc_tpu/io/checkpoints.py's converters).

Converts the reference's released checkpoints (WavLM-Large.pt with {'cfg',
'model'}, HiFi-GAN g_*.pt with {'generator'}; ref ddsp_hubconf.py:113-121,
hifigan/utils.py:41-46) and its discriminators' state dicts into the numpy
pytrees that io/jax_params.py turns into the port's modules, key for key
the JAX package's layout.

Weight norm (g·v/||v||) is folded into plain weights at conversion time,
so inference never pays for the re-normalization. `torch.load` unpickles:
load only checkpoints from a trusted source.

`save_params` / `load_params` read and write the `.knnsvc.pkl` format of
both packages: a pickled tree of dicts, lists and numpy arrays, so a
`g_<type>_<steps>.knnsvc.pkl` written by either package loads in both.
`load_numpy_params` reads one with an unpickler that admits numpy and
builtins only, and, by name, the optax state NamedTuples that a JAX-written
`do_` file holds: each becomes a plain stand-in NamedTuple with optax's
fields (the port neither has nor imports optax), which
io/jax_params.adamw_from_optax reads.
"""

from __future__ import annotations

import pickle
from collections import namedtuple
from typing import Any, Mapping

import numpy as np
import torch

from knnsvc_torch.config import HiFiGANConfig, ModelFamily, WavLMConfig

Params = dict[str, Any]


def _np(t) -> np.ndarray:
    """torch tensor -> float32 numpy."""
    return t.detach().cpu().float().numpy()


def fold_weight_norm(g: np.ndarray, v: np.ndarray, dim: int) -> np.ndarray:
    """weight = g * v / ||v|| with the norm over all dims except `dim`
    (torch.nn.utils.weight_norm semantics)."""
    axes = tuple(i for i in range(v.ndim) if i != dim)
    norm = np.sqrt(np.sum(v.astype(np.float64) ** 2, axis=axes, keepdims=True))
    return (g * v / norm).astype(np.float32)


def _lin(sd: Mapping[str, Any], prefix: str) -> Params:
    """torch Linear (out,in) -> {'w': (in,out), 'b': (out,)}."""
    p: Params = {"w": np.ascontiguousarray(_np(sd[prefix + ".weight"]).T)}
    if prefix + ".bias" in sd:
        p["b"] = _np(sd[prefix + ".bias"])
    return p


def _ln(sd: Mapping[str, Any], prefix: str) -> Params:
    return {"scale": _np(sd[prefix + ".weight"]), "bias": _np(sd[prefix + ".bias"])}


# ------------------------------------------------------------------ WavLM


def convert_wavlm_state_dict(sd: Mapping[str, Any], cfg: WavLMConfig) -> Params:
    """Reference WavLM state_dict -> pytree (see io/jax_params.py)."""
    fe_layers = []
    for i, _ in enumerate(cfg.conv_layers):
        pre = f"feature_extractor.conv_layers.{i}"
        blk: Params = {"conv": {"w": _np(sd[f"{pre}.0.weight"])}}
        if f"{pre}.0.bias" in sd:
            blk["conv"]["b"] = _np(sd[f"{pre}.0.bias"])
        if cfg.extractor_mode == "layer_norm":
            # Sequential(TransposeLast, Fp32LayerNorm, TransposeLast) at idx 2
            blk["norm"] = _ln(sd, f"{pre}.2.1")
        elif cfg.extractor_mode == "default" and i == 0:
            blk["norm"] = _ln(sd, f"{pre}.2")  # Fp32GroupNorm at idx 2
        fe_layers.append(blk)

    pos_w = fold_weight_norm(
        _np(sd["encoder.pos_conv.0.weight_g"]), _np(sd["encoder.pos_conv.0.weight_v"]), dim=2
    )

    n_layers = cfg.encoder_layers

    def stack_lin(fmt: str) -> Params:
        ws, bs = [], []
        for i in range(n_layers):
            p = _lin(sd, fmt.format(i))
            ws.append(p["w"])
            if "b" in p:
                bs.append(p["b"])
        out: Params = {"w": np.stack(ws)}
        if bs:
            out["b"] = np.stack(bs)
        return out

    def stack_ln(fmt: str) -> Params:
        return {
            "scale": np.stack([_np(sd[fmt.format(i) + ".weight"]) for i in range(n_layers)]),
            "bias": np.stack([_np(sd[fmt.format(i) + ".bias"]) for i in range(n_layers)]),
        }

    layers: Params = {
        "attn": {
            "q": stack_lin("encoder.layers.{}.self_attn.q_proj"),
            "k": stack_lin("encoder.layers.{}.self_attn.k_proj"),
            "v": stack_lin("encoder.layers.{}.self_attn.v_proj"),
            "out": stack_lin("encoder.layers.{}.self_attn.out_proj"),
        },
        "ln1": stack_ln("encoder.layers.{}.self_attn_layer_norm"),
        "fc1": stack_lin("encoder.layers.{}.fc1"),
        "fc2": stack_lin("encoder.layers.{}.fc2"),
        "ln2": stack_ln("encoder.layers.{}.final_layer_norm"),
    }
    if cfg.gru_rel_pos:
        layers["attn"]["grep"] = stack_lin("encoder.layers.{}.self_attn.grep_linear")
        layers["attn"]["grep_a"] = np.stack(
            [_np(sd[f"encoder.layers.{i}.self_attn.grep_a"]).reshape(-1) for i in range(n_layers)]
        )

    params: Params = {
        "feature_extractor": {"layers": fe_layers},
        "layer_norm": _ln(sd, "layer_norm"),
        "encoder": {
            "pos_conv": {"w": pos_w, "b": _np(sd["encoder.pos_conv.0.bias"])},
            "layer_norm": _ln(sd, "encoder.layer_norm"),
            "layers": layers,
        },
    }
    if "post_extract_proj.weight" in sd:
        params["post_extract_proj"] = _lin(sd, "post_extract_proj")
    if cfg.relative_position_embedding:
        params["encoder"]["rel_attn_bias"] = _np(
            sd["encoder.layers.0.self_attn.relative_attention_bias.weight"]
        )
    return params


def load_wavlm_checkpoint(path: str) -> tuple[Params, WavLMConfig]:
    """Load a WavLM-Large.pt torch checkpoint ({'cfg': dict, 'model':
    state_dict}; ref ddsp_hubconf.py:113-121)."""
    ckpt = torch.load(path, map_location="cpu", weights_only=False)
    cfg = WavLMConfig.from_dict(ckpt["cfg"])
    return convert_wavlm_state_dict(ckpt["model"], cfg), cfg


# ------------------------------------------------------------------ HiFi-GAN


def _conv(sd: Mapping[str, Any], prefix: str, fold: bool = True) -> Params:
    """Plain or weight-normed torch conv -> pytree. Weight norm is folded to
    {'w'} when fold else kept live as {'g','v'}."""
    p: Params = {}
    if prefix + ".weight" in sd:
        p["w"] = _np(sd[prefix + ".weight"])
    else:
        g, v = _np(sd[prefix + ".weight_g"]), _np(sd[prefix + ".weight_v"])
        if fold:
            p["w"] = fold_weight_norm(g, v, dim=0)
        else:
            p["g"], p["v"] = g, v
    if prefix + ".bias" in sd:
        p["b"] = _np(sd[prefix + ".bias"])
    return p


def convert_hifigan_state_dict(sd: Mapping[str, Any], h: HiFiGANConfig, family: ModelFamily,
                               fold: bool = True) -> Params:
    """Reference SynthesizerTrn / Generator state_dict -> pytree (see
    models/hifigan/generator.py): every family, ResBlock1 and ResBlock2."""
    n_up = len(h.upsample_rates)
    n_k = len(h.resblock_kernel_sizes)
    original = family == ModelFamily.ORIGINAL
    pre = "" if original else "dec."

    dec: Params = {
        "conv_pre": _conv(sd, pre + "conv_pre", fold),
        "ups": [_conv(sd, f"{pre}ups.{i}", fold) for i in range(n_up)],
        "conv_post": _conv(sd, pre + "conv_post", fold),
    }
    resblocks = []
    for i in range(n_up * n_k):
        if (f"{pre}resblocks.{i}.convs1.0.weight_v" in sd
                or f"{pre}resblocks.{i}.convs1.0.weight" in sd):
            resblocks.append({
                "convs1": [_conv(sd, f"{pre}resblocks.{i}.convs1.{j}", fold) for j in range(3)],
                "convs2": [_conv(sd, f"{pre}resblocks.{i}.convs2.{j}", fold) for j in range(3)],
            })
        else:  # ResBlock2
            resblocks.append({
                "convs": [_conv(sd, f"{pre}resblocks.{i}.convs.{j}", fold) for j in range(2)],
            })
    dec["resblocks"] = resblocks

    if original:
        return {"dec": dec}

    dec["lin_pre"] = _lin(sd, "dec.lin_pre")
    dec["downs"] = [_conv(sd, f"dec.downs.{i}", fold) for i in range(n_up)]
    dec["resblocks_downs"] = [
        {"convs": [_conv(sd, f"dec.resblocks_downs.{i}.convs.0", fold)]} for i in range(n_up)
    ]
    dec["concat_pre"] = _conv(sd, "dec.concat_pre", fold)
    dec["concat_conv"] = [_conv(sd, f"dec.concat_conv.{i}", fold) for i in range(n_up)]
    return {"dec": dec, "sin_prenet": _conv(sd, "sin_prenet", fold)}


def load_hifigan_checkpoint(path: str, h: HiFiGANConfig, family: ModelFamily,
                            fold: bool = True) -> Params:
    """Load a reference g_*.pt ({'generator': state_dict};
    hifigan/utils.py:41-46, ddsp_hubconf.py:93-94)."""
    ckpt = torch.load(path, map_location="cpu", weights_only=False)
    sd = ckpt["generator"] if "generator" in ckpt else ckpt
    return convert_hifigan_state_dict(sd, h, family, fold)


def _conv_sn(sd: Mapping[str, Any], prefix: str) -> Params:
    """Spectral-normed torch conv -> {'v_sn', 'u', 'v_pow', 'b'}."""
    p: Params = {
        "v_sn": _np(sd[prefix + ".weight_orig"]),
        "u": _np(sd[prefix + ".weight_u"]),
        "v_pow": _np(sd[prefix + ".weight_v"]),
    }
    if prefix + ".bias" in sd:
        p["b"] = _np(sd[prefix + ".bias"])
    return p


def convert_mpd_state_dict(sd: Mapping[str, Any], fold: bool = False) -> Params:
    """MultiPeriodDiscriminator (ref ddsp_models.py:532-541): 5 period discs
    of 5 weight-normed Conv2d + conv_post. fold=False keeps the weight norms
    live ({'g', 'v'}), the training form that
    io/jax_params.discriminators_from_numpy builds."""
    discs = []
    for i in range(5):
        discs.append({
            "convs": [_conv(sd, f"discriminators.{i}.convs.{j}", fold) for j in range(5)],
            "conv_post": _conv(sd, f"discriminators.{i}.conv_post", fold),
        })
    return {"discriminators": discs}


def convert_msd_state_dict(sd: Mapping[str, Any], fold: bool = False) -> Params:
    """MultiScaleDiscriminator (ref ddsp_models.py:587-598): disc 0 is
    spectral-normed (its weight_orig, weight_u and weight_v become
    {'v_sn', 'u', 'v_pow'}), discs 1-2 weight-normed."""
    discs = []
    for i in range(3):
        cv = []
        for j in range(7):
            prefix = f"discriminators.{i}.convs.{j}"
            cv.append(_conv_sn(sd, prefix) if i == 0 else _conv(sd, prefix, fold))
        post_prefix = f"discriminators.{i}.conv_post"
        post = _conv_sn(sd, post_prefix) if i == 0 else _conv(sd, post_prefix, fold)
        discs.append({"convs": cv, "conv_post": post})
    return {"discriminators": discs}


# ------------------------------------------------------------------ pytree io


def _to_numpy(tree):
    if isinstance(tree, dict):
        return {k: _to_numpy(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_to_numpy(v) for v in tree)
    if tree is None or isinstance(tree, (bool, int, float, str, bytes)):
        return tree
    return np.asarray(tree)


def save_params(path: str, params: Any) -> None:
    """Persist a parameter tree as pickled numpy (the JAX package's format)."""
    with open(path, "wb") as f:
        pickle.dump(_to_numpy(params), f, protocol=pickle.HIGHEST_PROTOCOL)


def load_params(path: str) -> Any:
    """Read a `.knnsvc.pkl` parameter file (pickled numpy pytree) written by
    either package's save_params. Unpickling runs code: load only files
    this program family wrote."""
    with open(path, "rb") as f:
        return pickle.load(f)


class ForeignPickleError(ValueError):
    """The pickle names a class from outside numpy and the builtins."""


# the optax classes in a do_ pickle of the JAX package's training loop (its
# inject_hyperparams(adamw) state), each with its fields
_OPTAX_STATES = {
    ("optax.schedules._inject", "InjectStatefulHyperparamsState"):
        ("count", "hyperparams", "hyperparams_states", "inner_state"),
    ("optax._src.transform", "ScaleByAdamState"): ("count", "mu", "nu"),
    ("optax._src.base", "EmptyState"): (),
}
_STAND_INS = {key: namedtuple(key[1], fields) for key, fields in _OPTAX_STATES.items()}


class _NumpyUnpickler(pickle.Unpickler):
    def find_class(self, module: str, name: str):
        if module.split(".")[0] in ("numpy", "builtins", "collections", "copyreg"):
            return super().find_class(module, name)
        if (module, name) in _STAND_INS:
            return _STAND_INS[(module, name)]
        raise ForeignPickleError(f"{module}.{name}")


def load_numpy_params(path: str) -> Any:
    """load_params that admits only numpy arrays, builtin containers and
    stand-ins for optax's AdamW state classes; any other class raises
    ForeignPickleError (a ValueError) naming it."""
    with open(path, "rb") as f:
        return _NumpyUnpickler(f).load()
