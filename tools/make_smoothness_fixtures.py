#!/usr/bin/env python3
"""Writes what the JAX package's smoothness optimizer gives on two
numpy-made problems to tests/torch_data/smoothness_fixtures.npz, which the
card tests of the port's smoothness kernel
(tests/test_torch_smoothness_kernel.py) hold the kernel to.

    python tools/make_smoothness_fixtures.py

The card's machine has no JAX, so the JAX results are made on a host that
has it (on its CPU) and committed. Each case is a 30-s source, T = 1500
frames and k = 4 ids into a pool of 3T rows of width D, made from a seed
by numpy's default_rng (pool = standard_normal((3T, D)) in float32, times
std in float32, then ids = integers(0, 3T, (T, k)), as the card tests make
theirs):
- "wavlm": D = 1024, std 1, at WAVLM_LOSS_SCALE;
- "harmonics": D = 49, std 3e-3, at HARMONICS_LOSS_SCALE: harmonic
  amplitudes at the served pairs' scale, whose losses fall at 3e-3..3e-2.
For each, the file holds the recipe (T, k, D, seed, std, scale), the
SHA-256 of the ids (int64) and pool (float32) bytes, so that a test knows
it rebuilt the same inputs, JAX's weights (T, k) float32, its step count
and the loss of its weights (JAX's `_loss_fn`).
"""

from __future__ import annotations

import hashlib
import os
import sys
import time

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
OUT = os.path.join(REPO, "tests", "torch_data", "smoothness_fixtures.npz")

# name: T, k, D, seed, std, scale
CASES = {"wavlm": (1500, 4, 1024, 2528, 1.0, 0.1),
         "harmonics": (1500, 4, 49, 1553, 3e-3, 1e3)}


def problem(T: int, k: int, D: int, seed: int, std: float):
    """-> ids (T, k) int64, pool (3T, D) float32, the SHA-256 of both."""
    rng = np.random.default_rng(seed)
    pool = rng.standard_normal((3 * T, D)).astype(np.float32)
    pool *= np.float32(std)
    idx = rng.integers(0, 3 * T, (T, k)).astype(np.int64)
    return idx, pool, hashlib.sha256(idx.tobytes() + pool.tobytes()).hexdigest()


def main() -> int:
    import jax

    jax.config.update("jax_platforms", "cpu")
    import jax.numpy as jnp

    sys.path.insert(0, REPO)
    from knnsvc_tpu.match import smoothness as jsm

    out = {}
    for name, (T, k, D, seed, std, scale) in CASES.items():
        idx, pool, digest = problem(T, k, D, seed, std)
        t0 = time.perf_counter()
        w, steps = jsm.optimize_smoothness_weights(jnp.asarray(idx, jnp.int32), jnp.asarray(pool),
                                                   scale=scale, return_steps=True)
        w = np.asarray(w, np.float32)
        surrounding = jsm._gather_surrounding(jnp.asarray(idx, jnp.int32), jnp.asarray(pool),
                                              None)
        loss = float(jsm._loss_fn(jnp.log(jnp.asarray(w)), surrounding, scale))
        print(f"{name}: {int(steps)} steps, loss {loss:.9g}, "
              f"{time.perf_counter() - t0:.1f} s", flush=True)
        out.update({f"{name}.recipe": np.array([T, k, D, seed, std, scale], np.float64),
                    f"{name}.sha256": np.array(digest), f"{name}.weights": w,
                    f"{name}.steps": np.array(int(steps)), f"{name}.loss": np.array(loss)})
    np.savez_compressed(OUT, **out)
    print(f"wrote {OUT} ({os.path.getsize(OUT)} bytes)")
    return 0


if __name__ == "__main__":
    sys.exit(main())
