"""Evaluation pair-list generation (counterpart of knnsvc_tpu/eval/pairs.py;
ref data_splits/file_list_generator.py).

Generates, for a (src dataset, tgt dataset) pair of speaker-folder roots:
- `<src>_to_<tgt>.txt` speaker-sim CSV: for each source utterance x up to 3
  shuffled target speakers, a label-0 row (converted `<utt>/<tgt_spk>` vs a
  round-robin real target utterance) and a label-1 row (two distinct real
  target utterances, round-robin with growing offset);
- `<src>_intelli.txt`: up to 300 source utterances spread evenly across
  source speakers.
"""

from __future__ import annotations

import os
import random
from pathlib import Path


def _audio_files(folder: Path) -> list[Path]:
    return sorted(list(folder.glob("**/*.wav")) + list(folder.glob("**/*.flac")))


def _no_ext_rel(path: Path, root: Path) -> str:
    return ".".join(os.path.relpath(path, root).split(".")[:-1])


def generate_pair_lists(
    src_dataset_path: str,
    tgt_dataset_path: str,
    output_folder: str,
    targets_per_source: int = 3,
    intelli_total: int = 300,
    seed: int = 0,
) -> tuple[str, str]:
    """Returns (sim_csv_path, intelli_txt_path)."""
    src_root, tgt_root = Path(src_dataset_path), Path(tgt_dataset_path)
    src_spks = sorted(p for p in src_root.iterdir() if p.is_dir())
    tgt_spks = sorted(p for p in tgt_root.iterdir() if p.is_dir())
    assert src_spks and tgt_spks

    rng = random.Random(seed)
    sim_rows: list[list] = []
    intelli_rows: list[str] = []

    for src_spk in src_spks:
        src_files = _audio_files(src_spk)
        intelli_rows += [
            os.path.relpath(p, src_root) for p in src_files[: intelli_total // len(src_spks)]
        ]

        shuffled_tgts = list(tgt_spks)
        rng.shuffle(shuffled_tgts)
        tgt_count = 0
        for tgt_spk in shuffled_tgts:
            if src_spk == tgt_spk:
                continue
            if tgt_count == targets_per_source:
                break
            tgt_count += 1
            tgt_files = _audio_files(tgt_spk)
            gt_idx, offset = 0, 1
            for src_file in src_files:
                utt = ".".join(os.path.basename(src_file).split(".")[:-1])
                tgt_name, src_name = os.path.basename(tgt_spk), os.path.basename(src_spk)
                sim_rows.append([src_name, tgt_name, f"{utt}/{tgt_name}",
                                 _no_ext_rel(tgt_files[gt_idx], tgt_root), 0])
                other = (gt_idx + offset) % len(tgt_files)
                sim_rows.append([tgt_name, tgt_name,
                                 _no_ext_rel(tgt_files[gt_idx], tgt_root),
                                 _no_ext_rel(tgt_files[other], tgt_root), 1])
                if gt_idx == len(tgt_files) - 1:
                    gt_idx, offset = 0, offset + 1
                else:
                    gt_idx += 1

    os.makedirs(output_folder, exist_ok=True)
    base_src = os.path.basename(str(src_root).rstrip("/"))
    base_tgt = os.path.basename(str(tgt_root).rstrip("/"))
    sim_file = os.path.join(output_folder, f"{base_src}_to_{base_tgt}.txt")
    intelli_file = os.path.join(output_folder, f"{base_src}_intelli.txt")

    with open(sim_file, "w") as fh:
        fh.write("src_speaker,tgt_speaker,x_path,y_path,label\n")
        for row in sim_rows:
            fh.write(",".join(str(x) for x in row) + "\n")
    with open(intelli_file, "w") as fh:
        for row in intelli_rows:
            fh.write(row + "\n")
    return sim_file, intelli_file


def compare_score_csvs(csv_a: str, csv_b: str, k: int = 5) -> dict:
    """Pairwise score diff between two eval runs; best/worst k
    (ref load_and_compare_csv.py:20-38). Returns {'best': [...], 'worst': [...]}."""
    import csv

    import numpy as np

    def read(path):
        with open(path) as fh:
            return [row for row in csv.reader(fh)][1:]

    rows_a, rows_b = read(csv_a), read(csv_b)
    a = np.array([float(r[-2]) for r in rows_a])
    b = np.array([float(r[-2]) for r in rows_b])
    diff = a - b
    worst = [(int(i), float(diff[i]), rows_a[i][3:5]) for i in np.argsort(diff)[:k]]
    best = [(int(i), float(diff[i]), rows_a[i][3:5]) for i in np.argsort(diff)[-k:]]
    return {"best": best, "worst": worst}
