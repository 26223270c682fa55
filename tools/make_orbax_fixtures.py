#!/usr/bin/env python3
"""Writes the orbax checkpoint that chip_smoke.py's [orbax] phase reads to
tests/torch_data/, with the JAX package's own save_train_state, and records
beside it what the JAX package's restore gives for each leaf.

    python tools/make_orbax_fixtures.py

The card's machine has neither JAX nor orbax nor tensorstore, so the
checkpoint is made on a host that has them and committed:
- orbax_tiny/3/: {"train_state": a TrainState, "multi_block": an array},
  epoch 2. The TrainState is knnsvc_tpu.train.trainer.init_train_state's at
  the CPU tests' tiny generator (tests/test_torch_common.py TINY_H, mix) with
  disc_width_scale=8, disc_periods=1 and disc_scales=1. So that orbax's
  zstd level 1 keeps the directory under 1 MB, a float leaf of more than
  4096 values holds its first 1024 random values over and over, and every
  float leaf keeps 4 significant bits (its low 20 bits zero). A seeded Adam
  state (nonzero moments for the generator, count 7, learning rate 1.25e-4)
  and steps 7. "multi_block" is a float32 array of
  96 000 values (384 000 bytes, three zstd blocks): a seeded 1000-value
  pattern, repeated with a drift every period, so that libzstd codes it
  with long matches, repeat offsets and Huffman-coded literals.
- orbax_fixtures.json: the step, the epoch and, for each array leaf (named
  by its dot-joined path), its dtype, shape and the SHA-256 of its bytes
  (C order, little-endian) as knnsvc_tpu.io.orbax_ckpt.restore_train_state
  returns it.
"""

from __future__ import annotations

import hashlib
import json
import os
import shutil
import sys

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
OUT_DIR = os.path.join(REPO, "tests", "torch_data")
CKPT = "orbax_tiny"
RECORD = "orbax_fixtures.json"
STEP, EPOCH = 3, 2


def leaf_digests(tree, prefix: str = "") -> dict[str, dict]:
    """{dotted path: {dtype, shape, sha256}} of the array leaves of a tree of
    dicts and lists (None leaves and empty dicts have no entry)."""
    out: dict[str, dict] = {}
    if isinstance(tree, dict):
        for k in sorted(tree):
            out.update(leaf_digests(tree[k], f"{prefix}{k}."))
    elif isinstance(tree, (list, tuple)):
        for i, sub in enumerate(tree):
            out.update(leaf_digests(sub, f"{prefix}{i}."))
    elif tree is not None:
        a = np.ascontiguousarray(np.asarray(tree))
        a = a.astype(a.dtype.newbyteorder("<"), copy=False)
        out[prefix[:-1]] = {"dtype": str(a.dtype), "shape": list(a.shape),
                            "sha256": hashlib.sha256(a.tobytes()).hexdigest()}
    return out


def main() -> int:
    sys.path.insert(0, REPO)
    sys.path.insert(0, os.path.join(REPO, "tests"))
    import jax

    jax.config.update("jax_platforms", "cpu")
    from test_torch_common import TINY_H

    from knnsvc_tpu.config import HiFiGANConfig, ModelFamily
    from knnsvc_tpu.io.orbax_ckpt import restore_train_state, save_train_state
    from knnsvc_tpu.train.trainer import init_train_state

    h = HiFiGANConfig.from_dict(TINY_H)
    state = jax.device_get(init_train_state(jax.random.PRNGKey(14), h, ModelFamily.MIX,
                                            disc_width_scale=8, disc_periods=1, disc_scales=1))

    def coarse(a):
        a = np.asarray(a)
        if a.dtype != np.float32 or a.ndim == 0:
            return a
        if a.size > 4096:
            a = np.resize(a.reshape(-1)[:1024], a.shape)
        return (a.view(np.uint32) & np.uint32(0xFFF00000)).view(np.float32)

    rng = np.random.default_rng(14)
    state = jax.tree.map(coarse, state)
    adam = state.opt_g.inner_state[0]
    moment = lambda scale: jax.tree.map(  # noqa: E731
        lambda p: coarse(scale * np.abs(rng.standard_normal(p.shape)).astype(np.float32)),
        adam.mu)
    count = np.asarray(7, np.int32)
    opt_g = state.opt_g._replace(
        count=count, inner_state=(adam._replace(count=count, mu=moment(1e-3), nu=moment(1e-6)),)
        + tuple(state.opt_g.inner_state[1:]))
    opt_g.hyperparams["learning_rate"] = np.asarray(1.25e-4, np.float32)
    state = state._replace(opt_g=opt_g, steps=np.asarray(7, np.int32))
    period = rng.standard_normal(1000).astype(np.float32)
    multi_block = np.concatenate([period + np.float32(i) for i in range(96)])

    target = os.path.join(OUT_DIR, CKPT)
    shutil.rmtree(target, ignore_errors=True)
    save_train_state(target, STEP, {"train_state": state, "multi_block": multi_block}, epoch=EPOCH)
    template = {"train_state": state, "multi_block": multi_block}
    restored, step, epoch = restore_train_state(target, template)
    restored = {"train_state": {f: getattr(restored["train_state"], f)
                                for f in restored["train_state"]._fields},
                "multi_block": restored["multi_block"]}

    def plain(tree):
        # optax's NamedTuples as dicts of their fields (orbax's own keys)
        if hasattr(tree, "_fields"):
            return {f: plain(getattr(tree, f)) for f in tree._fields} if tree._fields else None
        if isinstance(tree, dict):
            return {k: plain(v) for k, v in tree.items()}
        if isinstance(tree, (list, tuple)):
            return [plain(v) for v in tree]
        return tree

    record = {"step": step, "epoch": epoch, "leaves": leaf_digests(plain(restored))}
    with open(os.path.join(OUT_DIR, RECORD), "w") as f:
        json.dump(record, f, indent=1, sort_keys=True)
        f.write("\n")
    total = sum(os.path.getsize(os.path.join(d, n)) for d, _, names in os.walk(target)
                for n in names)
    print(f"{target}: {total} bytes, {len(record['leaves'])} array leaves")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
