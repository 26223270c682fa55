"""Speaker-similarity (EER) evaluation harness (counterpart of
knnsvc_tpu/eval/speaker_sim.py).

Protocol == ref data_splits/speaker_similarity.py: pairs CSV with columns
(src_speaker, tgt_speaker, x_path, y_path, label); label 0 rows score a
converted utterance (x under converted_dir, layout `<utt>/<tgt_spk>`) against
a real target utterance; label 1 rows score two real target utterances.
Cosine *distance* between speaker embeddings; per-target-speaker EER; report
mean +- std; write `<converted_dir basename>_sim_result.txt` with all scores.

Embedder backend: pluggable `embed_fn(wav_16k: np.ndarray) -> np.ndarray`.
The reference uses speechbrain's x-vector (spkrec-xvect-voxceleb; its
hyperparams ship in the reference's pretrained_models/ but the weights — and
speechbrain itself — are not in this image). Pass any embedding callable;
`mfcc_stats_embedder` is a dependency-free fallback for pipeline smoke tests
(NOT a substitute for x-vectors in reported numbers); it computes its
log-mels on a `device` that defaults to the card."""

from __future__ import annotations

import argparse
import functools
import os
from pathlib import Path
from typing import Callable

import numpy as np
import pandas as pd
import torch

from knnsvc_torch.eval.metrics import eer
from knnsvc_torch.io.audio import load_audio, resample, to_mono


def cosine_distance_vec(a: np.ndarray, b: np.ndarray) -> float:
    a = np.asarray(a, dtype=np.float64).reshape(-1)
    b = np.asarray(b, dtype=np.float64).reshape(-1)
    return float(1.0 - (a @ b) / (np.linalg.norm(a) * np.linalg.norm(b) + 1e-12))


def mfcc_stats_embedder(wav: np.ndarray, sr: int = 16000,
                        device: str | torch.device = "cuda") -> np.ndarray:
    """Mean+std of log-mel frames — a crude speaker statistic for smoke
    tests. The log-mel runs on `device` (a CUDA request without a card
    raises); the statistics are taken on the host, as the JAX package does."""
    from knnsvc_torch.dsp.stft import log_mel_spectrogram
    from knnsvc_torch.hub import resolve_device

    x = torch.from_numpy(np.ascontiguousarray(wav, dtype=np.float32)).to(resolve_device(device))
    with torch.no_grad():
        mel = log_mel_spectrogram(x[None])[0].cpu().numpy()  # (80, T)
    return np.concatenate([mel.mean(axis=1), mel.std(axis=1)])


def _load_16k(path: Path) -> np.ndarray:
    for suffix in (".flac", ".wav"):
        p = path.with_suffix(suffix)
        if p.is_file():
            x, sr = load_audio(p)
            x = to_mono(x)[0]
            if sr != 16000:
                x = resample(x, sr, 16000)
            return x
    raise FileNotFoundError(f"{path} (.flac/.wav)")


def compute_speaker_similarity(
    eval_set: str,
    converted_dir: str,
    ground_truth_dir: str,
    embed_fn: Callable[[np.ndarray], np.ndarray] = mfcc_stats_embedder,
    result_dir: str | None = None,
) -> pd.DataFrame:
    """Returns the per-target-speaker EER aggregate (mean/std), mirrors
    ref speaker_similarity.py:23-149."""
    pairs = pd.read_csv(eval_set)
    converted = pairs[pairs.label == 0]
    ground_truth = pairs[pairs.label == 1]

    cache: dict[str, np.ndarray] = {}

    def embed_path(path: Path) -> np.ndarray:
        key = str(path)
        if key not in cache:
            cache[key] = embed_fn(_load_16k(path))
        return cache[key]

    scores = []
    for _, (src, tgt, x_path, y_path, label) in converted.iterrows():
        short_x = str(x_path).split("/")[0]
        short_y = str(y_path).split("/")[-1]
        x = embed_path(Path(converted_dir) / x_path)
        y = embed_path(Path(ground_truth_dir) / y_path)
        scores.append((src, tgt, short_x, short_y, cosine_distance_vec(x, y), label))

    for _, (src, tgt, x_path, y_path, label) in ground_truth.iterrows():
        short_x = str(x_path).split("/")[-1]
        short_y = str(y_path).split("/")[-1]
        x = embed_path(Path(ground_truth_dir) / x_path)
        y = embed_path(Path(ground_truth_dir) / y_path)
        scores.append((src, tgt, short_x, short_y, cosine_distance_vec(x, y), label))

    scores_df = pd.DataFrame(
        scores, columns=["src_speaker", "tgt_speaker", "src_path", "tgt_path", "score", "label"]
    )
    sim = (
        scores_df.groupby("tgt_speaker")
        .apply(lambda g: eer(g.label.to_numpy(), g.score.to_numpy()), include_groups=False)
        .reset_index(name="eer")
    )

    out_dir = result_dir or os.path.dirname(os.path.abspath(converted_dir))
    scores_df.to_csv(
        os.path.join(out_dir, f"{os.path.basename(converted_dir.rstrip('/'))}_sim_result.txt")
    )
    return sim.agg(mean=("eer", "mean"), std=("eer", "std"))


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description="Evaluate speaker similarity (EER).")
    parser.add_argument("eval_set", type=Path)
    parser.add_argument("converted_dir", type=Path)
    parser.add_argument("ground_truth_dir", type=Path)
    parser.add_argument("--embedder", type=str, default="mfcc_stats",
                        help="'mfcc_stats' (smoke) or a module:function path of an embedding callable")
    parser.add_argument("--device", type=str, default="cuda",
                        help="where mfcc_stats computes its log-mels (cuda or cpu)")
    args = parser.parse_args(argv)

    if args.embedder == "mfcc_stats":
        fn = functools.partial(mfcc_stats_embedder, device=args.device)
        print("WARNING: mfcc_stats embedder is a smoke-test fallback, not an x-vector.")
    else:
        import importlib

        mod, name = args.embedder.split(":")
        fn = getattr(importlib.import_module(mod), name)

    sim = compute_speaker_similarity(
        str(args.eval_set), str(args.converted_dir), str(args.ground_truth_dir), fn
    )
    print(sim)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
