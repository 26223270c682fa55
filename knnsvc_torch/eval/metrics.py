"""Evaluation metrics (counterpart of knnsvc_tpu/eval/metrics.py, pure
numpy): WER/CER (jiwer-equivalent), number normalization
(num2words-equivalent for cardinals), and EER.

jiwer/num2words are not installed in this environment, so the subset the
reference uses is implemented natively:
- text cleaning == jiwer.Compose([ToLowerCase, RemoveWhiteSpace(replace_by
  _space), RemoveMultipleSpaces, RemovePunctuation, ReduceToListOfList
  Of{Words,Chars}]) (ref data_splits/eval_intelligibility.py:178-194)
- compute_measures returns the same keys jiwer does (wer, mer, wil, hits,
  substitutions, deletions, insertions)
- eer == roc_curve + brentq interpolation on 1-score
  (ref data_splits/speaker_similarity.py:18-21); roc_curve is
  scikit-learn's binary ROC (with its drop_intermediate default) in numpy,
  so the port needs no scikit-learn
"""

from __future__ import annotations

import re
import string

import numpy as np

_ONES = ["zero", "one", "two", "three", "four", "five", "six", "seven", "eight",
         "nine", "ten", "eleven", "twelve", "thirteen", "fourteen", "fifteen",
         "sixteen", "seventeen", "eighteen", "nineteen"]
_TENS = ["", "", "twenty", "thirty", "forty", "fifty", "sixty", "seventy",
         "eighty", "ninety"]
_SCALES = [(10 ** 9, "billion"), (10 ** 6, "million"), (10 ** 3, "thousand"),
           (100, "hundred")]


def _num_to_words(n: int) -> str:
    """English cardinal words (num2words-compatible for cardinals, with its
    'and' convention, hyphens replaced by spaces as the reference does)."""
    if n < 0:
        return "minus " + _num_to_words(-n)
    if n < 20:
        return _ONES[n]
    if n < 100:
        tens, rem = divmod(n, 10)
        return _TENS[tens] + (" " + _ONES[rem] if rem else "")
    for scale, name in _SCALES:
        if n >= scale:
            head, rem = divmod(n, scale)
            out = _num_to_words(head) + " " + name
            if rem:
                joiner = " and " if rem < 100 and scale == 100 else (
                    " and " if rem < 100 else " ")
                out += joiner + _num_to_words(rem)
            return out
    return _ONES[0]


def numbers_to_words(text: str) -> str:
    """Replace standalone integers with words (ref eval_intelligibility.py:37-42)."""
    return re.sub(r"\b\d+\b", lambda m: _num_to_words(int(m.group())), text)


_PUNCT_TABLE = str.maketrans("", "", string.punctuation)


def clean_to_words(text: str) -> list[str]:
    text = text.lower().translate(_PUNCT_TABLE)
    return text.split()


def clean_to_chars(text: str) -> list[str]:
    text = text.lower().translate(_PUNCT_TABLE)
    return list(" ".join(text.split()))


def _edit_ops(ref: list, hyp: list) -> tuple[int, int, int, int]:
    """(hits, substitutions, deletions, insertions) via Levenshtein DP."""
    m, n = len(ref), len(hyp)
    # dp of (cost, hits, subs, dels, ins)
    prev = [(j, 0, 0, 0, j) for j in range(n + 1)]
    for i in range(1, m + 1):
        cur = [(i, 0, 0, i, 0)] + [None] * n
        for j in range(1, n + 1):
            if ref[i - 1] == hyp[j - 1]:
                c, h, s, d, ins = prev[j - 1]
                cur[j] = (c, h + 1, s, d, ins)
            else:
                sub = prev[j - 1]
                dele = prev[j]
                insr = cur[j - 1]
                best = min(sub[0], dele[0], insr[0])
                if best == sub[0]:
                    cur[j] = (sub[0] + 1, sub[1], sub[2] + 1, sub[3], sub[4])
                elif best == dele[0]:
                    cur[j] = (dele[0] + 1, dele[1], dele[2], dele[3] + 1, dele[4])
                else:
                    cur[j] = (insr[0] + 1, insr[1], insr[2], insr[3], insr[4] + 1)
        prev = cur
    _, h, s, d, ins = prev[n]
    return h, s, d, ins


def compute_measures(truths: list[str], hypotheses: list[str],
                     unit: str = "words") -> dict:
    """jiwer.compute_measures equivalent over a corpus (summed counts)."""
    clean = clean_to_words if unit == "words" else clean_to_chars
    H = S = D = I = N = 0
    for t, p in zip(truths, hypotheses):
        rt, rp = clean(t), clean(p)
        h, s, d, i = _edit_ops(rt, rp)
        H += h
        S += s
        D += d
        I += i
        N += len(rt)
    wer_val = (S + D + I) / max(N, 1)
    mer = (S + D + I) / max(H + S + D + I, 1)
    wil = 1.0 - (H / max(H + S + D, 1)) * (H / max(H + S + I, 1))
    return {
        "wer": wer_val, "mer": mer, "wil": wil,
        "hits": H, "substitutions": S, "deletions": D, "insertions": I,
    }


def wer(truths: list[str], hypotheses: list[str]) -> float:
    return compute_measures(truths, hypotheses, "words")["wer"]


def cer(truths: list[str], hypotheses: list[str]) -> float:
    return compute_measures(truths, hypotheses, "chars")["wer"]


def roc_curve(labels: np.ndarray, scores: np.ndarray, pos_label=1):
    """(fpr, tpr, thresholds) of a binary classifier, as
    sklearn.metrics.roc_curve(labels, scores, pos_label=pos_label) computes
    them: thresholds at the distinct scores in decreasing order, collinear
    points dropped, (0, 0) prepended at threshold inf."""
    y_true = np.asarray(labels).ravel() == pos_label
    y_score = np.asarray(scores).ravel()
    order = np.argsort(y_score, kind="mergesort")[::-1]
    y_score, y_true = y_score[order], y_true[order]
    threshold_idxs = np.r_[np.where(np.diff(y_score))[0], y_true.size - 1]
    tps = np.cumsum(y_true, dtype=np.float64)[threshold_idxs]
    fps = 1 + threshold_idxs - tps
    thresholds = y_score[threshold_idxs]
    if len(fps) > 2:
        keep = np.where(np.r_[True, np.logical_or(np.diff(fps, 2), np.diff(tps, 2)), True])[0]
        fps, tps, thresholds = fps[keep], tps[keep], thresholds[keep]
    tps, fps = np.r_[0, tps], np.r_[0, fps]
    thresholds = np.r_[np.inf, thresholds]
    return fps / fps[-1], tps / tps[-1], thresholds


def eer(labels: np.ndarray, scores: np.ndarray) -> float:
    """Equal error rate: point where FPR == FNR on the ROC of (label, 1-score),
    matching ref speaker_similarity.py:18-21 (scores are cosine *distances*,
    label 1 = same-speaker ground truth pairs)."""
    from scipy.interpolate import interp1d
    from scipy.optimize import brentq

    fpr, tpr, _ = roc_curve(labels, 1 - np.asarray(scores), pos_label=1)
    return float(brentq(lambda x: 1.0 - x - interp1d(fpr, tpr)(x), 0.0, 1.0))
