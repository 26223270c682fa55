"""Orbax checkpoints without orbax (counterpart of knnsvc_tpu/io/orbax_ckpt.py):
the whole TrainState (parameters, optimizer state, step) with best-only
retention, in the layout of orbax's CheckpointManager, so a directory that
either package writes restores in the other.

    <directory>/<step>/_CHECKPOINT_METADATA      JSON: the item handler, times
    <directory>/<step>/default/_METADATA         JSON: the tree, one entry a leaf
    <directory>/<step>/default/manifest.ocdbt    an OCDBT database (io/ocdbt.py)
                                                 of zarr v2 arrays (io/zarr2.py)

A leaf's tree path is a tuple of keys; each key's type is 1 for a sequence
index and 2 for a dict key or NamedTuple field; its array is named by the
dot-joined path. `None` leaves and empty dicts have a value type of their
own and no array. The saved tree is {"state": state, "epoch": epoch}; a bare
state (the layout before the epoch rode along) restores with epoch 0.

`state` is a JAX-layout tree of dicts, lists or tuples, None, numpy arrays or
scalars (torch tensors are taken too, bfloat16 ones as zarr "bfloat16").
"""

from __future__ import annotations

import ast
import json
import os
import shutil
import time
from concurrent.futures import ThreadPoolExecutor
from typing import Any

import numpy as np
import torch

from knnsvc_torch.io import ocdbt, zarr2

ITEM = "default"
_HANDLER = "orbax.checkpoint._src.handlers.standard_checkpoint_handler.StandardCheckpointHandler"
_SEQUENCE, _MAPPING = 1, 2
_ARRAY_TYPES = ("np.ndarray", "jax.Array")
_TMP_MARK = ".orbax-checkpoint-tmp-"
_THREADS = min(8, os.cpu_count() or 1)     # leaves read at once (the codecs drop the GIL)


def checkpoint_steps(directory: str) -> list[int]:
    """The committed steps under `directory`, ascending."""
    if not os.path.isdir(directory):
        return []
    return sorted(int(n) for n in os.listdir(directory)
                  if n.isdigit() and os.path.isdir(os.path.join(directory, n)))


# ------------------------------------------------------------------ tree


def _flatten(tree, path: tuple = ()) -> list[tuple[tuple, Any]]:
    """[(path of (key, key_type) pairs, leaf)] in orbax's order; a leaf is an
    array, a scalar, None, or an empty dict."""
    if isinstance(tree, dict):
        if not tree:
            return [(path, tree)]
        out = []
        for k in sorted(tree):
            if not isinstance(k, str):
                raise TypeError(f"checkpoint dict keys must be str, not {k!r}")
            out += _flatten(tree[k], path + ((k, _MAPPING),))
        return out
    if isinstance(tree, (list, tuple)):
        if not tree:
            raise TypeError(f"empty {type(tree).__name__} at {_dotted(path)} has no orbax leaf")
        out = []
        for i, sub in enumerate(tree):
            out += _flatten(sub, path + ((str(i), _SEQUENCE),))
        return out
    return [(path, tree)]


def _dotted(path: tuple) -> str:
    return ".".join(k for k, _ in path)


def _value_type(leaf) -> str:
    if leaf is None:
        return "None"
    if isinstance(leaf, dict):
        return "Dict"
    if isinstance(leaf, (bool, int, float)):
        return "scalar"
    if isinstance(leaf, (np.ndarray, np.generic, torch.Tensor)):
        return "np.ndarray"
    raise TypeError(f"cannot checkpoint a {type(leaf).__name__}")


def _unflatten(leaves: dict[tuple, Any]):
    """Rebuild dicts and lists from {path of (key, key_type): leaf}."""
    if list(leaves) == [()]:
        return leaves[()]
    groups: dict[tuple[str, int], dict[tuple, Any]] = {}
    for path, leaf in leaves.items():
        groups.setdefault(path[0], {})[path[1:]] = leaf
    kinds = {kt for _, kt in groups}
    if len(kinds) != 1:
        raise ValueError("orbax metadata mixes sequence and dict keys in one node")
    if kinds == {_SEQUENCE}:
        index = sorted(int(k) for k, _ in groups)
        if index != list(range(len(index))):
            raise ValueError(f"orbax metadata: sequence indices {index}")
        return [_unflatten(groups[(str(i), _SEQUENCE)]) for i in index]
    return {k: _unflatten(sub) for (k, _), sub in groups.items()}


# ------------------------------------------------------------------ write


def _write_item(item_dir: str, tree) -> None:
    flat = _flatten(tree)
    tree_meta, values = {}, {}
    for path, leaf in flat:
        vt = _value_type(leaf)
        tree_meta[repr(tuple(k for k, _ in path))] = {
            "key_metadata": [{"key": k, "key_type": kt} for k, kt in path],
            "value_metadata": {"value_type": vt, "skip_deserialize": vt in ("None", "Dict")}}
        if vt == "scalar":
            leaf = np.asarray(leaf, np.float64 if isinstance(leaf, float) else np.int64)
        if vt in ("scalar", "np.ndarray"):
            values.update({k.encode(): v for k, v in
                           zarr2.array_values(_dotted(path), leaf).items()})
    os.makedirs(item_dir)
    ocdbt.write_database(item_dir, values)
    with open(os.path.join(item_dir, "_METADATA"), "w") as f:
        json.dump({"tree_metadata": tree_meta, "use_ocdbt": True, "use_zarr3": False,
                   "store_array_data_equal_to_fill_value": True, "custom_metadata": None}, f)


def save_train_state(directory: str, step: int, state: Any, keep: int = 1,
                     epoch: int = 0) -> None:
    """Write {"state": state, "epoch": epoch} as step `step` of the
    checkpoint directory, then keep only the `keep` newest steps. The step
    is written under a temporary name and renamed when complete."""
    directory = str(directory)
    os.makedirs(directory, exist_ok=True)
    final = os.path.join(directory, str(int(step)))
    if os.path.exists(final):
        raise FileExistsError(f"checkpoint step {step} already exists under {directory}")
    init_ns = time.time_ns()
    tmp = f"{final}{_TMP_MARK}{init_ns}"
    try:
        _write_item(os.path.join(tmp, ITEM), {"state": state, "epoch": int(epoch)})
        with open(os.path.join(tmp, "_CHECKPOINT_METADATA"), "w") as f:
            json.dump({"item_handlers": {ITEM: _HANDLER}, "metrics": {},
                       "performance_metrics": {}, "init_timestamp_nsecs": init_ns,
                       "commit_timestamp_nsecs": time.time_ns(), "custom_metadata": {}}, f)
        os.replace(tmp, final)
    except BaseException:
        shutil.rmtree(tmp, ignore_errors=True)
        raise
    for old in checkpoint_steps(directory)[:-keep] if keep > 0 else []:
        shutil.rmtree(os.path.join(directory, str(old)))


# ------------------------------------------------------------------ read


def _read_item(item_dir: str, prefixes: tuple[tuple[str, ...], ...] | None = None):
    """The tree of one item; with `prefixes`, only the leaves under one of
    those key paths."""
    with open(os.path.join(item_dir, "_METADATA")) as f:
        meta = json.load(f)
    if meta.get("use_zarr3"):
        raise NotImplementedError(f"{item_dir}: zarr v3 arrays (only zarr v2 is read)")
    if not meta.get("use_ocdbt", False):
        raise NotImplementedError(f"{item_dir}: arrays outside OCDBT (only OCDBT is read)")
    db = ocdbt.Database(item_dir)

    def get(key: str) -> bytes | None:
        k = key.encode()
        return db.read(k) if k in db else None

    entries = []
    for name, entry in meta["tree_metadata"].items():
        path = tuple((km["key"], km["key_type"]) for km in entry["key_metadata"])
        if tuple(k for k, _ in path) != ast.literal_eval(name):
            raise ValueError(f"{item_dir}: tree entry {name} disagrees with its keys")
        keys = tuple(k for k, _ in path)
        if prefixes is None or any(keys[:len(p)] == p for p in prefixes):
            entries.append((path, entry["value_metadata"]["value_type"]))
    if not entries:
        raise ValueError(f"{item_dir}: no leaf under {prefixes}")

    def load(item):
        path, vt = item
        if vt == "None":
            return None
        if vt == "Dict":
            return {}
        if vt not in _ARRAY_TYPES + ("scalar",):
            raise NotImplementedError(f"{item_dir}: leaf {_dotted(path)} of type {vt!r}")
        name = _dotted(path)
        zarray = get(f"{name}/.zarray")
        if zarray is None:
            raise ValueError(f"{item_dir}: no array {name}")
        arr = zarr2.read_array(get, name, zarr2.parse_zarray(zarray))
        return arr.item() if vt == "scalar" else arr

    with ThreadPoolExecutor(_THREADS) as pool:
        leaves = list(pool.map(load, entries))
    return _unflatten({path: leaf for (path, _), leaf in zip(entries, leaves)})


def _check_template(tree, template, path: str = "state"):
    """`tree` in the containers of `template`, checked leaf for leaf: the
    same paths, shapes and dtypes; ValueError on a mismatch."""
    if isinstance(template, dict):
        if not isinstance(tree, dict) or sorted(tree) != sorted(template):
            got = sorted(tree) if isinstance(tree, dict) else type(tree).__name__
            raise ValueError(f"checkpoint {path}: keys {got} where the template has "
                             f"{sorted(template)}")
        return {k: _check_template(tree[k], template[k], f"{path}.{k}") for k in template}
    if isinstance(template, (list, tuple)):
        if not isinstance(tree, list) or len(tree) != len(template):
            raise ValueError(f"checkpoint {path}: not a sequence of {len(template)}, as the "
                             "template has")
        return type(template)(_check_template(t, s, f"{path}.{i}")
                              for i, (t, s) in enumerate(zip(tree, template)))
    if template is None or tree is None:
        if template is not tree:
            raise ValueError(f"checkpoint {path}: {tree!r} where the template has {template!r}")
        return None
    if isinstance(template, (bool, int, float)):
        if isinstance(tree, (np.ndarray, torch.Tensor)):
            raise ValueError(f"checkpoint {path}: an array where the template has a scalar")
        return tree
    want_shape = tuple(template.shape)
    want_dtype = str(template.dtype)
    got_dtype = str(tree.dtype) if hasattr(tree, "dtype") else type(tree).__name__
    if tuple(getattr(tree, "shape", ())) != want_shape or got_dtype != want_dtype:
        raise ValueError(f"checkpoint {path}: {got_dtype}{list(getattr(tree, 'shape', ()))} "
                         f"where the template has {want_dtype}{list(want_shape)}")
    return tree


def _step_dir(directory: str, step: int | None) -> tuple[str, int]:
    steps = checkpoint_steps(directory)
    if step is None:
        if not steps:
            raise FileNotFoundError(f"no orbax checkpoints under {directory}")
        step = steps[-1]
    elif int(step) not in steps:
        raise FileNotFoundError(f"no orbax checkpoint of step {step} under {directory}")
    return os.path.join(directory, str(int(step)), ITEM), int(step)


def restore_params(directory: str, name: str = "g_params",
                   step: int | None = None) -> tuple[Any, int]:
    """One field of the newest (or the given) step's TrainState, such as the
    generator's parameters, reading only its arrays -> (tree, step)."""
    item_dir, step = _step_dir(str(directory), step)
    tree = _read_item(item_dir, (("state", name), (name,)))
    return (tree["state"] if "state" in tree else tree)[name], step


def restore_train_state(directory: str, template: Any = None,
                        step: int | None = None) -> tuple[Any, int, int]:
    """Restore the newest (or the given) step under `directory` ->
    (state, step, epoch). Sequences come back as lists, or in the template's
    containers when a template is given, which is checked leaf for leaf.
    FileNotFoundError when there is no checkpoint."""
    item_dir, step = _step_dir(str(directory), step)
    tree = _read_item(item_dir)
    if isinstance(tree, dict) and set(tree) == {"state", "epoch"}:
        state, epoch = tree["state"], int(tree["epoch"])
    else:
        state, epoch = tree, 0     # legacy layout: the bare state
    if template is not None:
        state = _check_template(state, template)
    return state, step, epoch
