"""Offline prematch feature extraction, the training data prep (counterpart
of knnsvc_tpu/train/prematch.py; the reference's per_spk_extract + CLI main,
ddsp_prematch_dataset.py:1464-1812).

For every speaker (an audio-holding leaf folder): build the speaker's pools,
save the synthesis pool (`pool.npy`, rounded through fp16 as ref :1510) and
the harmonics pool (`pool_harmonics.npy`); then for each utterance the
self-speaker kNN (k = 32) with the utterance's own slice forced to
distance 1 (ref :1623-1624), the f0-priority re-sort, the spec-L1
amplitude ratio (ref :1672-1675) and the amp-weighted smoothness weights
(ref :1681), pickled per utterance as a `.pt` dict {slice, nearest_nbrs
(int64), nearest_nbrs_f0_priority, harmonics_best_weight_para, amp_ratio,
f0} of numpy arrays, merged into an existing file (ref :1581-1593). The
layout is the JAX package's byte for byte, so either package's prematch
feeds either trainer. The encodes, the kNN and the smoothness optimizer run
on `device`; the pools live on the host as the JAX package keeps them.
"""

from __future__ import annotations

import os
import pickle
from pathlib import Path

import numpy as np
import torch
from torch.profiler import record_function

from knnsvc_torch.config import WavLMConfig
from knnsvc_torch.match.distance import cosine_distance
from knnsvc_torch.match.f0_logic import sort_by_f0_compatibility
from knnsvc_torch.match.pool import build_speaker_pool
from knnsvc_torch.match.smoothness import HARMONICS_LOSS_SCALE, optimize_smoothness_weights

KNN_CANDIDATES = 32
TOPK = 4


def find_speaker_folders(root: str | Path) -> list[Path]:
    """Audio-containing leaf folders (ref :1467-1473)."""
    root = Path(root)
    audio_files = list(root.glob("**/*.wav")) + list(root.glob("**/*.flac"))
    return sorted(set(f.parent for f in audio_files))


def self_knn_with_mask(matching_pool: torch.Tensor, start: int, end: int,
                       query: torch.Tensor) -> np.ndarray:
    """Top-32 pool rows of each `query` row by cosine distance, with pool
    rows [start, end) (the utterance's own frames) forced to distance 1
    (ref :1612-1635). A stable sort keeps equal distances in pool order,
    as the JAX package's lax.top_k does. -> (Q, 32) int64 on the host."""
    dists = cosine_distance(query, matching_pool)
    dists[:, start:end] = 1.0
    idx = torch.sort(dists, dim=1, stable=True).indices[:, :KNN_CANDIDATES]
    return idx.cpu().numpy().astype(np.int64)


def per_spk_extract(dataset_root: str | Path, out_path: str | Path, wavlm_params,
                    wavlm_cfg: WavLMConfig, match_weights: np.ndarray,
                    synth_weights: np.ndarray, save_pool_only: bool = False, topk: int = TOPK,
                    device: str | torch.device = "cuda") -> None:
    """Prematch every speaker folder under `dataset_root` into `out_path`
    (same relative layout). wavlm_params: the JAX package's WavLM pytree
    (numpy), as its per_spk_extract takes it. Host f0 comes from each
    utterance's `<stem>_f0.npy` sidecar or native Harvest, as in the JAX
    package. Runs on device="cuda" unless the caller passes "cpu"."""
    from knnsvc_torch.hub import resolve_device
    from knnsvc_torch.io.jax_params import wavlm_from_numpy
    from knnsvc_torch.precision import apply_precision

    dev = resolve_device(device)
    apply_precision()
    wavlm = wavlm_from_numpy(wavlm_params, wavlm_cfg, dev)
    dataset_root, out_path = Path(dataset_root), Path(out_path)

    for i, spk_folder in enumerate(find_speaker_folders(dataset_root)):
        with record_function("knnsvc.prematch"):
            _extract_speaker(spk_folder, dataset_root, out_path, wavlm, match_weights,
                             synth_weights, save_pool_only, topk, dev)
        print(f"[prematch] {i}: {spk_folder}", flush=True)


@torch.no_grad()
def _extract_speaker(spk_folder: Path, dataset_root: Path, out_path: Path, wavlm,
                     match_weights, synth_weights, save_pool_only: bool, topk: int,
                     dev: torch.device) -> None:
    pool = build_speaker_pool(spk_folder, wavlm, match_weights, synth_weights)
    # the fp16 rounding baked into the reference's training pools (ref :1510)
    synth_list = pool.synth.astype(np.float16).astype(np.float32)
    matching_list = pool.matching.astype(np.float16).astype(np.float32)
    harmonics_list = pool.harmonics
    spec_list = pool.spec
    f0_list = pool.f0
    starts = pool.utterance_start_indices

    spk_cache_folder = out_path / spk_folder.relative_to(dataset_root)
    os.makedirs(spk_cache_folder, exist_ok=True)
    np.save(spk_cache_folder / "pool.npy", synth_list)
    np.save(spk_cache_folder / "pool_harmonics.npy", harmonics_list)
    if save_pool_only:
        np.save(spk_cache_folder / "pool_f0.npy", f0_list)
        np.save(spk_cache_folder / "pool_spec.npy", spec_list)

    matching_d = torch.from_numpy(matching_list).to(dev)
    harmonics_d = torch.from_numpy(harmonics_list).to(dev)
    f0_d = torch.from_numpy(f0_list).to(dev)

    for k, (item, utt) in enumerate(pool.utterances.items()):
        start, end = starts[k], starts[k + 1]
        target = (out_path / Path(item).relative_to(dataset_root)).with_suffix(".pt")
        os.makedirs(target.parent, exist_ok=True)
        if target.is_file():
            with open(target, "rb") as fh:
                existing = pickle.load(fh)
            if tuple(existing["slice"]) != (start, end):
                raise ValueError(f"{target}: slice {existing['slice']} != {(start, end)}; "
                                 "the speaker's utterances changed since it was written")
        else:
            existing = {"slice": (start, end)}

        if not save_pool_only:
            nearest_nbrs = self_knn_with_mask(matching_d, start, end, matching_d[start:end])
            nbrs_f0 = sort_by_f0_compatibility(
                torch.from_numpy(utt.f0).to(dev), f0_d,
                torch.from_numpy(nearest_nbrs).to(dev)).cpu().numpy().astype(np.int64)

            target_idx = nbrs_f0[:, :topk]
            # amp_ratio: per-frame L1 spec of the original over each selected
            # neighbour's L1 spec (ref :1672-1675)
            orig_l1 = np.abs(utt.spec).sum(axis=1)                       # (T,)
            knn_l1 = np.abs(spec_list[target_idx]).sum(axis=-1)           # (T, k)
            amp_ratio = (orig_l1[:, None] / (knn_l1 + 1e-5)).astype(np.float32)

            weights = optimize_smoothness_weights(
                torch.from_numpy(target_idx).to(dev), harmonics_d, scale=HARMONICS_LOSS_SCALE,
                amp_ratio=torch.from_numpy(amp_ratio).to(dev))

            existing["nearest_nbrs"] = nearest_nbrs
            existing["nearest_nbrs_f0_priority"] = nbrs_f0
            existing["harmonics_best_weight_para"] = weights.cpu().numpy()
            existing["amp_ratio"] = amp_ratio
            existing["f0"] = utt.f0  # the reference's validation reads it (its extractor does not write it)
            existing.pop("best_weights", None)

        with open(target, "wb") as fh:
            pickle.dump(existing, fh, protocol=pickle.HIGHEST_PROTOCOL)
