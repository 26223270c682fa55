"""Layer-weight helpers (ref knnvc_utils.py:3-11); the port's own copy of
knnsvc_tpu/utils/layer_weights.py.

WavLM exposes 25 per-layer outputs (the post-frontend input plus 24 encoder
layers). The matching/synthesis features are a weighted sum over these; the
reference always uses a one-hot weighting at layer 6.
"""

import numpy as np

N_LAYER_OUTPUTS = 25  # input + 24 encoder layers


def generate_matrix_from_index(index: int, size: int = N_LAYER_OUTPUTS) -> np.ndarray:
    """One-hot weight vector selecting layer `index`."""
    weights = np.zeros(size, dtype=np.float32)
    weights[index] = 1.0
    return weights


def retrieve_index_from_matrix(weights: np.ndarray) -> int:
    """Inverse of generate_matrix_from_index for one-hot vectors."""
    return int(np.argmax(np.asarray(weights)))


def one_hot_layer(weights: np.ndarray) -> int | None:
    """If `weights` is exactly one-hot, return the hot index, else None.

    Used to short-circuit the encoder: a one-hot weighting at layer L only
    needs L encoder layers, not all 24 (the reference always runs all 24 —
    ref ddsp_prematch_dataset.py:289 — which wastes 4x compute for L=6).
    """
    w = np.asarray(weights).reshape(-1)
    hot = np.flatnonzero(w != 0.0)
    if hot.size == 1 and w[hot[0]] == 1.0:
        return int(hot[0])
    return None
