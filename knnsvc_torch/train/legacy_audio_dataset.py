"""Legacy DDSP audio dataset (counterpart of
knnsvc_tpu/train/legacy_audio_dataset.py; ref hifigan/knn_data_cnpop.py —
orphaned in the reference: imported by nothing, uses pw.dio). A plain
(audio, f0) segment loader for DDSP-style vocoder experiments, on the
port's own audio I/O and host f0 extractor."""

from __future__ import annotations

import os
from pathlib import Path

import numpy as np

from knnsvc_torch.dsp.f0 import get_f0
from knnsvc_torch.io.audio import load_audio, to_mono


def traverse_dir(root_dir, extension=".wav", amount=None, str_include=None,
                 str_exclude=None, is_pure=False, is_sort=False, is_ext=True):
    """Recursive file listing with the reference's filter knobs
    (ref knn_data_cnpop.py traverse_dir)."""
    out = []
    for cur, _dirs, files in os.walk(root_dir):
        for f in files:
            if not f.endswith(extension):
                continue
            path = os.path.join(cur, f)
            pure = os.path.relpath(path, root_dir) if is_pure else path
            if str_include is not None and str_include not in pure:
                continue
            if str_exclude is not None and str_exclude in pure:
                continue
            if not is_ext:
                pure = pure[: -len(extension)]
            out.append(pure)
            if amount is not None and len(out) >= amount:
                return sorted(out) if is_sort else out
    return sorted(out) if is_sort else out


class AudioDataset:
    """Waveform segments + frame-rate f0 (ref knn_data_cnpop.AudioDataset)."""

    def __init__(self, root_dir: str, waveform_sec: float = 2.0, hop_size: int = 320,
                 sample_rate: int = 16000, extensions: tuple[str, ...] = ("wav",),
                 seed: int = 0):
        self.root = Path(root_dir)
        self.paths: list[str] = []
        for ext in extensions:
            self.paths += traverse_dir(root_dir, "." + ext, is_sort=True)
        self.n_samples = int(waveform_sec * sample_rate)
        self.hop = hop_size
        self.sr = sample_rate
        self._rng = np.random.default_rng(seed)

    def __len__(self) -> int:
        return len(self.paths)

    def __getitem__(self, idx: int) -> dict[str, np.ndarray]:
        x, sr = load_audio(self.paths[idx])
        assert sr == self.sr, (sr, self.sr)
        wav = to_mono(x)[0]
        if len(wav) > self.n_samples:
            # hop-aligned random crop so f0 frames line up
            max_start = (len(wav) - self.n_samples) // self.hop
            start = int(self._rng.integers(0, max_start + 1)) * self.hop
            wav = wav[start: start + self.n_samples]
        else:
            wav = np.pad(wav, (0, self.n_samples - len(wav)))
        f0 = get_f0(wav, self.sr, audio_path=None, use_sidecar=False, write_sidecar=False)
        return {"audio": wav.astype(np.float32), "f0": f0[: len(wav) // self.hop + 1],
                "name": os.path.basename(self.paths[idx])}
