"""Training dataset for vocoder fine-tuning on prematched features
(counterpart of knnsvc_tpu/train/dataset.py; the reference's MelDataset,
hifigan/ddsp_meldataset.py:332-593, fine-tuning mode):

- pairs the audio tree with the prematch feature tree by relative path
  (ref :340-389);
- item: features = mean of pool.npy[nearest_nbrs[:, :4]] (mmap, ref :482),
  harmonics = pool_harmonics[nearest_nbrs_f0_priority[:, :4]] with ONE
  randomly picked candidate per frame times its amp_ratio (ref :498-499);
- a random crop of segment_size samples / ceil(seg/hop) frames
  (ref :512-518); f0 extracted on the crop by the host extractor (native
  Harvest, no sidecar); mel_loss = the port's log-mel of the crop, on the
  CPU;
- validation (split=False): full utterances, f0 read from the prematch
  pickle, priority utterances first (ref :358-376).

Randomness: each item draws its harmonic pick, then its crop start, from
the dataset's one numpy generator, in the JAX package's order, so the
items equal the JAX package's item for item when drawn in the same order.
`batch_iterator` draws on the calling thread in batch order and hands the
rest of each item (pool gathers, f0, mel) to its worker threads, so the
batches of a seed are the same for any number of workers.
"""

from __future__ import annotations

import math
import os
import pickle
from collections import deque
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import numpy as np
import torch

from knnsvc_torch import HOP_LENGTH
from knnsvc_torch.config import HiFiGANConfig
from knnsvc_torch.dsp.f0 import get_f0
from knnsvc_torch.dsp.stft import log_mel_spectrogram
from knnsvc_torch.io.audio import load_audio, to_mono

TOPK = 4
BATCH_KEYS = ("feats", "audio", "mel_loss", "f0", "harmonics")


class MelDataset:
    def __init__(self, h: HiFiGANConfig, audio_root_path: str | Path,
                 feat_root_path: str | Path, split: bool = True, shuffle: bool = True,
                 seed: int = 1234,
                 priority_substrings: tuple[str, ...] = ("Cantoria_EJB2_S_resampled_16000.pt",)):
        self.h = h
        self.split = split
        self.segment_size = h.segment_size
        self.frames_per_seg = math.ceil(h.segment_size / h.hop_size)
        self.audio_root = Path(audio_root_path)
        self.feat_root = Path(feat_root_path)

        # pair by relative stem path, so mixed .flac/.wav trees pair right
        audio_paths = sorted(
            (os.path.relpath(p, self.audio_root)
             for ext in (".flac", ".wav")
             for p in self.audio_root.rglob("*" + ext)),
            key=lambda rp: os.path.splitext(rp)[0])
        if not audio_paths:
            raise FileNotFoundError(f"no audio under {self.audio_root}")
        feat_paths = sorted(
            (os.path.relpath(p, self.feat_root) for p in self.feat_root.rglob("*.pt")),
            key=lambda rp: os.path.splitext(rp)[0])
        if ([os.path.splitext(a)[0] for a in audio_paths]
                != [os.path.splitext(f)[0] for f in feat_paths]):
            raise ValueError(f"the audio tree {self.audio_root} and the feature tree "
                             f"{self.feat_root} must mirror each other by relative path")

        if not split and priority_substrings:
            # the reference's pinned validation utterance(s) first (ref :358-376)
            def is_priority(fp):
                return any(s in fp for s in priority_substrings)

            order = sorted(range(len(feat_paths)),
                           key=lambda i: (not is_priority(feat_paths[i]), i))
            feat_paths = [feat_paths[i] for i in order]
            audio_paths = [audio_paths[i] for i in order]

        self.rows = list(zip(audio_paths, feat_paths))
        if shuffle:
            rng = np.random.default_rng(seed)
            rng.shuffle(self.rows)
        self._rng = np.random.default_rng(seed)
        self._pool_cache: dict[Path, tuple[np.ndarray, np.ndarray]] = {}

    def __len__(self) -> int:
        return len(self.rows)

    def _pools(self, feat_path: Path):
        folder = feat_path.parent
        if folder not in self._pool_cache:
            self._pool_cache[folder] = (
                np.load(folder / "pool.npy", mmap_mode="r"),
                np.load(folder / "pool_harmonics.npy", mmap_mode="r"))
        return self._pool_cache[folder]

    def draw(self, index: int) -> dict:
        """Read item `index`'s waveform and prematch pickle and make its
        random draws (harmonic pick, then crop start) from the dataset's
        generator. Cheap; must run in the order items are consumed."""
        audio_rel, feat_rel = self.rows[index]
        x, sr = load_audio(self.audio_root / audio_rel)
        if sr != self.h.sampling_rate:
            raise ValueError(f"{audio_rel}: {sr} Hz, the config trains at {self.h.sampling_rate}")
        audio = to_mono(x)[0].astype(np.float32)
        feat_path = self.feat_root / feat_rel
        with open(feat_path, "rb") as fh:
            fd = pickle.load(fh)
        T = len(fd["nearest_nbrs"])
        pick = self._rng.integers(0, TOPK, size=T)
        start = 0
        if self.split and audio.shape[0] >= self.segment_size and T > self.frames_per_seg + 1:
            start = int(self._rng.integers(0, T - self.frames_per_seg - 1))
        return {"audio_rel": audio_rel, "feat_path": feat_path, "audio": audio, "fd": fd,
                "pick": pick, "start": start}

    def finish(self, drawn: dict) -> dict[str, np.ndarray]:
        """The rest of an item from its draws: pool gathers, crop, f0, mel."""
        audio, fd, pick, start = drawn["audio"], drawn["fd"], drawn["pick"], drawn["start"]
        nearest_nbrs = np.asarray(fd["nearest_nbrs"])
        nbrs_f0 = np.asarray(fd["nearest_nbrs_f0_priority"])
        amp_ratio = np.asarray(fd["amp_ratio"], dtype=np.float32)

        pool, pool_harm = self._pools(drawn["feat_path"])
        feats = np.asarray(pool[nearest_nbrs[:, :TOPK]]).mean(axis=1)       # (T, 1024)
        harm_cands = np.asarray(pool_harm[nbrs_f0[:, :TOPK]])               # (T, k, 49)
        ar = np.arange(len(harm_cands))
        harmonics = harm_cands[ar, pick] * amp_ratio[ar, pick][:, None]     # (T, 49)

        if self.split:
            fps = self.frames_per_seg
            feats = feats[start: start + fps]
            harmonics = harmonics[start: start + fps]
            audio = audio[start * HOP_LENGTH: (start + fps) * HOP_LENGTH]
            if feats.shape[0] < fps:  # a short utterance: pad
                pad_f = fps - feats.shape[0]
                feats = np.pad(feats, ((0, pad_f), (0, 0)))
                harmonics = np.pad(harmonics, ((0, pad_f), (0, 0)))
                audio = np.pad(audio, (0, self.segment_size - audio.shape[0]))
            f0 = get_f0(audio, self.h.sampling_rate, audio_path=None, use_sidecar=False,
                        write_sidecar=False)
        else:
            f0 = np.asarray(fd["f0"], dtype=np.float32)

        T = feats.shape[0]
        f0 = np.asarray(f0[:T], dtype=np.float32)
        if len(f0) < T:
            f0 = np.pad(f0, (0, T - len(f0)))

        h = self.h
        with torch.no_grad():
            mel_loss = log_mel_spectrogram(
                torch.from_numpy(np.ascontiguousarray(audio))[None], n_fft=h.n_fft,
                num_mels=h.num_mels, sampling_rate=h.sampling_rate, hop_size=h.hop_size,
                win_size=h.win_size, fmin=h.fmin, fmax=h.fmax)[0].numpy()
        return {
            "feats": feats.astype(np.float32),
            "audio": audio.astype(np.float32),
            "mel_loss": mel_loss.astype(np.float32),
            "f0": f0[:, None],
            "harmonics": harmonics.astype(np.float32),
            "path": str(drawn["audio_rel"]),
        }

    def __getitem__(self, index: int) -> dict[str, np.ndarray]:
        return self.finish(self.draw(index))


def batch_iterator(dataset: MelDataset, batch_size: int, shuffle: bool = True, seed: int = 0,
                   drop_last: bool = True, prefetch: int = 2, num_workers: int = 4):
    """Yield stacked numpy batches (the reference's DataLoader(num_workers=12),
    ref ddsp_train.py:52-56) with `prefetch` batches in flight.

    Each item's draws are made on the calling thread in batch order; the
    rest of the item (mmap gathers, the native f0 extractor over ctypes,
    the CPU mel, all of which release the GIL) runs on `num_workers`
    threads, 0 meaning the calling thread. Batches are assembled in
    submission order, so a seed gives the same batches for any num_workers.
    A worker's exception re-raises where its batch is consumed."""
    order = np.arange(len(dataset))
    if shuffle:
        np.random.default_rng(seed).shuffle(order)
    n_batches = len(order) // batch_size if drop_last else math.ceil(len(order) / batch_size)
    pool = (ThreadPoolExecutor(max_workers=num_workers, thread_name_prefix="melds")
            if num_workers > 0 else None)
    pending: deque = deque()

    def submit(b: int) -> None:
        drawn = [dataset.draw(int(i)) for i in order[b * batch_size: (b + 1) * batch_size]]
        if pool is None:
            pending.append([dataset.finish(d) for d in drawn])
        else:
            pending.append([pool.submit(dataset.finish, d) for d in drawn])

    try:
        next_b = min(prefetch, n_batches)
        for b in range(next_b):
            submit(b)
        while pending:
            items = [f if pool is None else f.result() for f in pending.popleft()]
            if next_b < n_batches:
                submit(next_b)
                next_b += 1
            batch = {k: np.stack([it[k] for it in items]) for k in BATCH_KEYS}
            batch["paths"] = [it["path"] for it in items]
            yield batch
    finally:
        if pool is not None:
            pool.shutdown(wait=False, cancel_futures=True)
