"""Span masking for self-supervised training (counterpart of
knnsvc_tpu/models/wavlm/masking.py; ref wavlm/WavLM.py:35-159
compute_mask_indices + :271-309 apply_mask — training-only, unused at
inference in the reference too).

Mask sampling is host numpy (data-pipeline work), so a seeded
np.random.Generator gives the JAX package's mask; the substitution of the
masked frames runs on the features' device.
"""

from __future__ import annotations

import numpy as np
import torch


def compute_mask_indices(
    shape: tuple[int, int],
    padding_mask: np.ndarray | None,
    mask_prob: float,
    mask_length: int,
    mask_type: str = "static",
    mask_other: float = 0.0,
    min_masks: int = 0,
    rng: np.random.Generator | None = None,
) -> np.ndarray:
    """Random span masks, (B, T) bool. Span starts sampled without
    replacement; every row trimmed to the batch-min masked count
    (ref :151-157)."""
    if rng is None:
        rng = np.random.default_rng()
    bsz, all_sz = shape
    mask = np.zeros((bsz, all_sz), dtype=bool)

    all_num_mask = max(min_masks, int(mask_prob * all_sz / float(mask_length) + rng.random()))

    mask_idcs = []
    for i in range(bsz):
        if padding_mask is not None:
            sz = int(all_sz - padding_mask[i].sum())
            num_mask = max(min_masks, int(mask_prob * sz / float(mask_length) + rng.random()))
        else:
            sz, num_mask = all_sz, all_num_mask

        if mask_type == "static":
            lengths = np.full(num_mask, mask_length)
        elif mask_type == "uniform":
            lengths = rng.integers(mask_other, mask_length * 2 + 1, size=num_mask)
        elif mask_type == "normal":
            lengths = np.maximum(1, np.round(rng.normal(mask_length, mask_other,
                                                        size=num_mask))).astype(int)
        elif mask_type == "poisson":
            lengths = np.round(rng.poisson(mask_length, size=num_mask)).astype(int)
        else:
            raise ValueError(f"unknown mask selection {mask_type}")

        if lengths.sum() == 0:
            lengths[0] = min(mask_length, sz - 1)

        min_len = int(lengths.min())
        if sz - min_len <= num_mask:
            min_len = sz - num_mask - 1
        starts = rng.choice(sz - min_len, num_mask, replace=False)
        idc = np.asarray([s + off for s, l in zip(starts, lengths) for off in range(l)])
        mask_idcs.append(np.unique(idc[idc < sz]))

    min_count = min(len(m) for m in mask_idcs)
    for i, idc in enumerate(mask_idcs):
        if len(idc) > min_count:
            idc = rng.choice(idc, min_count, replace=False)
        mask[i, idc] = True
    return mask


def apply_mask(features: torch.Tensor, mask_emb, mask_indices) -> torch.Tensor:
    """Replace masked frames with the learned mask embedding
    (ref WavLM.py:271-287). features (B, T, C), mask (B, T) bool (numpy or
    tensor) -> (B, T, C) on the features' device."""
    m = torch.as_tensor(mask_indices, dtype=torch.bool, device=features.device)[..., None]
    emb = torch.as_tensor(mask_emb, dtype=features.dtype, device=features.device)
    return torch.where(m, emb[None, None, :], features)
