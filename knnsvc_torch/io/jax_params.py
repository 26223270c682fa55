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

The training form keeps the norms live instead (`live=True`): {"g", "v"}
becomes torch's weight-norm parametrization (dim 0; g = original0, v =
original1) and the spectral-normed {"v_sn", "u", "v_pow"} the
discriminators' SpectralNorm parametrization (v_sn = original, u and v_pow
its buffers). `tree_from_module` maps the training modules back, so a
trained generator is saved in the JAX package's layout, and
`train_state_from_numpy` carries a whole JAX TrainState across (parameters,
spectral-norm buffers, optionally optax's Adam moments).
"""

from __future__ import annotations

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


# the training form's leaf names: live weight norm and spectral norm
_LIVE = {"g": "parametrizations.weight.original0", "v": "parametrizations.weight.original1",
         "v_sn": "parametrizations.weight.original", "u": "parametrizations.weight.0.u",
         "v_pow": "parametrizations.weight.0.v_pow"}


def _state_items(tree, prefix: str = "", live: bool = False
                 ) -> Iterator[tuple[str, torch.Tensor]]:
    if isinstance(tree, dict):
        if "g" in tree and "v" in tree and not live:
            tree = _fold_weight_norm(tree)
        for key, sub in tree.items():
            name = _LIVE[key] if live and key in _LIVE else _RENAME.get(key, key)
            yield from _state_items(sub, f"{prefix}{name}.", live)
    elif isinstance(tree, (list, tuple)):
        for i, sub in enumerate(tree):
            yield from _state_items(sub, f"{prefix}{i}.", live)
    else:
        a = np.asarray(tree, np.float32)
        name = prefix[:-1]
        if name.endswith(".weight") and a.ndim == 2:
            a = a.T
        yield name, torch.from_numpy(np.array(a, dtype=np.float32, order="C"))


def _attach_norms(module: nn.Module, tree, path: str = "") -> None:
    """Register the parametrizations of the live norms that `tree` holds on
    the matching submodules of `module`."""
    from torch.nn.utils import parametrize
    from torch.nn.utils.parametrizations import weight_norm

    from knnsvc_torch.models.hifigan.discriminator import SpectralNorm

    if isinstance(tree, dict):
        if "g" in tree and "v" in tree:
            weight_norm(module.get_submodule(path), dim=0)
        elif "v_sn" in tree:
            sub = module.get_submodule(path)
            parametrize.register_parametrization(sub, "weight", SpectralNorm(sub.weight))
        else:
            for key, s in tree.items():
                _attach_norms(module, s, f"{path}.{key}" if path else key)
    elif isinstance(tree, (list, tuple)):
        for i, s in enumerate(tree):
            _attach_norms(module, s, f"{path}.{i}" if path else str(i))


def _build(module_cls, args: tuple, tree, device, live: bool = False) -> nn.Module:
    """Construct without allocating or initializing weights, then take
    copies of the arrays of `tree` as the parameters. live=True keeps the
    norms of `tree` as parametrizations and returns the module in train
    mode."""
    with torch.device("meta"):
        module = module_cls(*args)
        if live:
            _attach_norms(module, tree)
    module.load_state_dict(dict(_state_items(tree, live=live)), strict=True, assign=True)
    module = module.to(device)
    return module.train() if live else module.eval()


def _tree_key(name: str) -> tuple[list[str], str]:
    """A training module's state-dict name -> (path in the pytree, leaf key)."""
    for key, suffix in _LIVE.items():
        if name.endswith("." + suffix):
            return name[: -len(suffix) - 1].split("."), key
    *path, leaf = name.split(".")
    return path, {"weight": "w", "bias": "b"}[leaf]


def _listify(tree):
    if isinstance(tree, dict):
        if tree and all(k.isdigit() for k in tree):
            return [_listify(tree[str(i)]) for i in range(len(tree))]
        return {k: _listify(v) for k, v in tree.items()}
    return tree


def tree_from_tensors(named: dict[str, torch.Tensor]) -> dict[str, Any]:
    """{state-dict name: tensor} of a training module (or tensors keyed the
    same way, such as Adam moments) -> numpy pytree in the JAX package's
    layout (float32, a Linear's weight back to (in, out))."""
    tree: dict[str, Any] = {}
    for name, t in named.items():
        path, key = _tree_key(name)
        a = t.detach().float().cpu().numpy()
        if key == "w" and a.ndim == 2:
            a = np.ascontiguousarray(a.T)
        node = tree
        for p in path:
            node = node.setdefault(p, {})
        node[key] = a
    return _listify(tree)


def tree_from_module(module: nn.Module) -> dict[str, Any]:
    """Training module -> numpy pytree (parameters and spectral-norm
    buffers), the layout of the JAX package's TrainState trees."""
    return tree_from_tensors(module.state_dict())


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


def generator_train_from_numpy(params: dict[str, Any], h: HiFiGANConfig, family: ModelFamily,
                               device: str | torch.device = "cpu") -> nn.Module:
    """The training form of generator_from_numpy: the weight norms of
    `params` ({"g", "v"}, as init_generator_params(weight_norm_parametrized=
    True) and trained checkpoints hold them) stay live."""
    from knnsvc_torch.models.hifigan.generator import Synthesizer

    return _build(Synthesizer, (h, family), params, device, live=True)


def discriminators_from_numpy(mpd_params: dict[str, Any], msd_params: dict[str, Any],
                              device: str | torch.device = "cpu") -> tuple[nn.Module, nn.Module]:
    """The JAX package's MPD and MSD trees -> (MultiPeriodDiscriminator,
    MultiScaleDiscriminator) on `device`, their norms live. Widths and the
    numbers of periods and scales are read from the trees."""
    from knnsvc_torch.models.hifigan.discriminator import (MultiPeriodDiscriminator,
                                                           MultiScaleDiscriminator)

    mpd_discs, msd_discs = mpd_params["discriminators"], msd_params["discriminators"]
    post = mpd_discs[0]["conv_post"]
    top = np.asarray(post.get("v", post.get("w"))).shape[1]
    mpd = _build(MultiPeriodDiscriminator, (1024 // top, len(mpd_discs)), mpd_params, device,
                 live=True)
    post = msd_discs[0]["conv_post"]
    top = np.asarray(post.get("v_sn", post.get("v", post.get("w")))).shape[1]
    msd = _build(MultiScaleDiscriminator, (1024 // top, len(msd_discs)), msd_params, device,
                 live=True)
    return mpd, msd


def generator_harm_from_numpy(params: dict[str, Any],
                              device: str | torch.device = "cpu") -> nn.Module:
    """The JAX package's harm-head pytree (init_generator_harm_params) ->
    models.hifigan.harm_head.GeneratorHarm on `device`; hidden width,
    harmonic count, depth and kernel size are read from the tree."""
    from knnsvc_torch.models.hifigan.harm_head import GeneratorHarm

    convs = params["net"]["convs"]
    hidden, _, kernel_size = np.asarray(convs[0]["w"]).shape
    n_harmonic = np.asarray(params["postnet"]["w"]).shape[0] - 1
    return _build(GeneratorHarm, (hidden, n_harmonic, len(convs), kernel_size), params, device)


def _adam_state(optimizer: torch.optim.Optimizer, modules: dict[str, nn.Module],
                mu: dict[str, Any], nu: dict[str, Any], count: int) -> None:
    """Set `optimizer`'s AdamW moments from optax Adam trees keyed like
    `modules` (spectral-norm buffers are not parameters and have none)."""
    for prefix, module in modules.items():
        mu_items = dict(_state_items(mu[prefix], live=True))
        nu_items = dict(_state_items(nu[prefix], live=True))
        for name, p in module.named_parameters():
            optimizer.state[p] = {
                "step": torch.tensor(float(count)),
                "exp_avg": mu_items[name].to(p.device).reshape(p.shape).clone(),
                "exp_avg_sq": nu_items[name].to(p.device).reshape(p.shape).clone()}


def train_state_from_numpy(g_params: dict[str, Any], mpd_params: dict[str, Any],
                           msd_params: dict[str, Any], h: HiFiGANConfig, family: ModelFamily,
                           device: str | torch.device = "cpu", adam_g: dict | None = None,
                           adam_d: dict | None = None, steps: int = 0):
    """A JAX TrainState as numpy trees -> train.trainer.TrainState on
    `device`: g_params with live {"g", "v"}, mpd_params, msd_params with the
    spectral-norm u / v_pow, and optionally optax's Adam state of each
    optimizer as {"mu", "nu", "count"} (for the D optimizer mu and nu are
    JAX's (mpd, msd) pair)."""
    from knnsvc_torch.train.trainer import TrainState, make_optimizers

    generator = generator_train_from_numpy(g_params, h, family, device)
    mpd, msd = discriminators_from_numpy(mpd_params, msd_params, device)
    opt_g, opt_d = make_optimizers(h, generator, mpd, msd)
    if adam_g is not None:
        _adam_state(opt_g, {"g": generator}, {"g": adam_g["mu"]}, {"g": adam_g["nu"]},
                    int(adam_g["count"]))
    if adam_d is not None:
        mu, nu = adam_d["mu"], adam_d["nu"]
        _adam_state(opt_d, {"mpd": mpd, "msd": msd}, {"mpd": mu[0], "msd": mu[1]},
                    {"mpd": nu[0], "msd": nu[1]}, int(adam_d["count"]))
    return TrainState(generator, mpd, msd, opt_g, opt_d, family, steps)


# ------------------------------------------------- optax's AdamW state, both ways

_OPTAX_HYPERPARAMS = ("b1", "b2", "eps", "eps_root", "learning_rate", "weight_decay")


def optax_tree(state):
    """optax state as plain containers: a NamedTuple (or a pickle's stand-in
    for one) becomes a dict of its fields, an empty one (EmptyState) None, a
    tuple a list — the form orbax restores without a template."""
    if hasattr(state, "_fields"):
        return {f: optax_tree(getattr(state, f)) for f in state._fields} if state._fields \
            else None
    if isinstance(state, dict):
        return {k: optax_tree(v) for k, v in state.items()}
    if isinstance(state, (list, tuple)):
        return [optax_tree(v) for v in state]
    return state


def adamw_from_optax(state) -> dict[str, Any]:
    """optax.inject_hyperparams(optax.adamw) state (count, hyperparams
    {b1, b2, eps, eps_root, learning_rate, weight_decay}, hyperparams_states,
    inner_state = (ScaleByAdamState(count, mu, nu), EmptyState(),
    EmptyState())), as NamedTuples or plain containers -> {"mu", "nu",
    "count", "learning_rate", "b1", "b2", "eps", "weight_decay"}."""
    tree = optax_tree(state)
    if not isinstance(tree, dict) or not {"count", "hyperparams", "inner_state"} <= set(tree):
        raise ValueError("not an optax inject_hyperparams state")
    hyper = tree["hyperparams"]
    missing = set(_OPTAX_HYPERPARAMS) - set(hyper)
    if missing:
        raise ValueError(f"optax state lacks the AdamW hyperparameters {sorted(missing)}")
    inner = tree["inner_state"]
    if not isinstance(inner, list) or not isinstance(inner[0], dict) \
            or not {"count", "mu", "nu"} <= set(inner[0]) or any(s is not None for s in inner[1:]):
        raise ValueError("optax state is not adamw's (scale_by_adam, then two stateless "
                         "transforms)")
    if float(np.asarray(hyper["eps_root"])) != 0.0:
        raise ValueError("optax AdamW with eps_root != 0 has no torch AdamW equivalent")
    out = {k: float(np.asarray(hyper[k])) for k in _OPTAX_HYPERPARAMS if k != "eps_root"}
    return {"mu": inner[0]["mu"], "nu": inner[0]["nu"], "count": int(np.asarray(inner[0]["count"])),
            **out}


def _set_hyperparams(optimizer: torch.optim.Optimizer, adam: dict[str, Any]) -> None:
    """optax keeps the hyperparameters as float32: a stored value that is
    the float32 rounding of the optimizer's own (the config's) keeps the
    config's value, so a saved and restored state steps as one never saved;
    any other stored value is taken as it is."""
    def pick(current: float, stored: float) -> float:
        return current if np.float32(current) == np.float32(stored) else stored

    for group in optimizer.param_groups:
        b1, b2 = group["betas"]
        group.update(lr=pick(group["lr"], adam["learning_rate"]),
                     betas=(pick(b1, adam["b1"]), pick(b2, adam["b2"])),
                     eps=pick(group["eps"], adam["eps"]),
                     weight_decay=pick(group["weight_decay"], adam["weight_decay"]))


def _check_buffer_moments(tree, path: str = "") -> None:
    """The spectral-norm buffers u / v_pow get no gradient in the JAX step,
    so their Adam moments stay 0; torch's AdamW keeps none for buffers."""
    if isinstance(tree, dict):
        for k, v in tree.items():
            if k in ("u", "v_pow") and np.any(np.asarray(v)):
                raise ValueError(f"optax state: nonzero Adam moment of the buffer {path}{k}")
            _check_buffer_moments(v, f"{path}{k}.")
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            _check_buffer_moments(v, f"{path}{i}.")


def train_state_from_jax(tree: dict[str, Any], h: HiFiGANConfig, family: ModelFamily,
                         device: str | torch.device = "cpu"):
    """The JAX package's TrainState as a tree ({"g_params", "mpd_params",
    "msd_params", "opt_g", "opt_d", "steps"}, the optimizer states optax's
    inject_hyperparams(adamw)) -> train.trainer.TrainState on `device`, with
    the Adam moments, the AdamW step count, learning rate and
    hyperparameters, and the global step count."""
    adam_g, adam_d = adamw_from_optax(tree["opt_g"]), adamw_from_optax(tree["opt_d"])
    for adam in (adam_g, adam_d):
        for moment in (adam["mu"], adam["nu"]):
            _check_buffer_moments(moment)
    state = train_state_from_numpy(tree["g_params"], tree["mpd_params"], tree["msd_params"], h,
                                   family, device, adam_g=adam_g, adam_d=adam_d,
                                   steps=int(np.asarray(tree["steps"])))
    _set_hyperparams(state.opt_g, adam_g)
    _set_hyperparams(state.opt_d, adam_d)
    return state


def _moments(module: nn.Module, optimizer: torch.optim.Optimizer, key: str) -> dict[str, Any]:
    """An Adam moment of each parameter of `module` as a JAX-layout tree;
    the spectral-norm buffers, which optax's tree holds too but which never
    receive a gradient, are zeros, as in every state the JAX step makes."""
    params = dict(module.named_parameters())
    named = {}
    for name, t in module.state_dict().items():
        st = optimizer.state.get(params[name]) if name in params else None
        named[name] = st[key] if st else torch.zeros_like(t)
    return tree_from_tensors(named)


def _optax_adamw(optimizer: torch.optim.Optimizer, modules: list[nn.Module]) -> dict[str, Any]:
    group = optimizer.param_groups[0]
    steps = [float(s["step"]) for s in optimizer.state.values() if "step" in s]
    count = np.asarray(int(steps[0]) if steps else 0, np.int32)
    mu = [_moments(m, optimizer, "exp_avg") for m in modules]
    nu = [_moments(m, optimizer, "exp_avg_sq") for m in modules]
    f32 = lambda v: np.asarray(v, np.float32)  # noqa: E731
    return {"count": count.copy(),
            "hyperparams": {"b1": f32(group["betas"][0]), "b2": f32(group["betas"][1]),
                            "eps": f32(group["eps"]), "eps_root": f32(0.0),
                            "learning_rate": f32(group["lr"]),
                            "weight_decay": f32(group["weight_decay"])},
            "hyperparams_states": {},
            "inner_state": [{"count": count.copy(), "mu": mu[0] if len(mu) == 1 else mu,
                             "nu": nu[0] if len(nu) == 1 else nu}, None, None]}


def train_state_to_numpy(state) -> dict[str, Any]:
    """The inverse of train_state_from_jax: the port's TrainState -> the JAX
    package's TrainState as a tree of numpy arrays (g_params with live
    {"g", "v"}, the discriminators with their spectral-norm u / v_pow, each
    optimizer as optax's inject_hyperparams(adamw) state, the D optimizer's
    moments as JAX's (mpd, msd) pair, steps as int32), the tree that the JAX
    package's restore_train_state takes under its init_train_state
    template."""
    return {"g_params": tree_from_module(state.generator),
            "mpd_params": tree_from_module(state.mpd),
            "msd_params": tree_from_module(state.msd),
            "opt_g": _optax_adamw(state.opt_g, [state.generator]),
            "opt_d": _optax_adamw(state.opt_d, [state.mpd, state.msd]),
            "steps": np.asarray(state.steps, np.int32)}
