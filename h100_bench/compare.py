"""The numbers that decide `correct`: each compares what the program
produced with what the plain reference produced from the same inputs, and
is held to its limit from limits/<cell>.json. A number the limits file does
not name is printed as a reading and decides nothing."""

from __future__ import annotations

import numpy as np

FRAME = 320     # samples per 20-ms frame of the waveform


def _rows_rel(p: np.ndarray, r: np.ndarray) -> np.ndarray:
    """Per row ||p - r|| / ||r|| (rows of (T, D) arrays)."""
    num = np.linalg.norm((p - r).astype(np.float64), axis=-1)
    den = np.linalg.norm(r.astype(np.float64), axis=-1)
    return num / np.maximum(den, 1e-30)


def pair_numbers(prog: dict, ref: dict) -> dict[str, float]:
    """prog and ref each hold src_feats, tgt_feats (T, D); src_f0, tgt_f0
    (T,); out (T, D); harm (T, 49) or None; wave (N,) float; codes (N,)
    int16, as numpy arrays. A shape that differs reads inf."""
    out: dict[str, float] = {}
    feats = []
    for key in ("src_feats", "tgt_feats"):
        if prog[key].shape != ref[key].shape:
            return {"shape_mismatch": float("inf")}
        feats.append(_rows_rel(prog[key], ref[key]))
    out["feat_rel_max"] = float(max(f.max() for f in feats))
    out["feat_rel_median"] = float(np.median(np.concatenate(feats)))

    mismatch, cents = [], [0.0]
    for key in ("src_f0", "tgt_f0"):
        p, r = prog[key].astype(np.float64), ref[key].astype(np.float64)
        if p.shape != r.shape:
            return {"shape_mismatch": float("inf")}
        mismatch.append((p > 0) != (r > 0))
        both = (p > 0) & (r > 0)
        if both.any():
            cents.append(float(np.max(np.abs(1200.0 * np.log2(p[both] / r[both])))))
    out["f0_voicing_mismatch"] = float(np.concatenate(mismatch).mean())
    out["f0_cents_max"] = max(cents)

    for key in ("out", "harm"):
        if prog.get(key) is None:
            continue
        if prog[key].shape != ref[key].shape:
            return {"shape_mismatch": float("inf")}
        rel = _rows_rel(prog[key], ref[key])
        out[f"{key}_rel_median"] = float(np.median(rel))
        out[f"{key}_rel_p90"] = float(np.quantile(rel, 0.9))

    pw, rw = prog["wave"], ref["wave"]
    if pw.shape != rw.shape or prog["codes"].shape != ref["codes"].shape:
        return {"shape_mismatch": float("inf")}
    n = len(rw) // FRAME * FRAME
    frames = _rows_rel(pw[:n].reshape(-1, FRAME), rw[:n].reshape(-1, FRAME))
    out["wave_rel_median"] = float(np.median(frames))
    out["wave_rel_p90"] = float(np.quantile(frames, 0.9))
    out["code_diff_share"] = float(np.mean(prog["codes"] != ref["codes"]))
    return out


def worst(readings: list[dict[str, float]]) -> dict[str, float]:
    """The largest reading of each number over the checked requests."""
    keys = sorted({k for r in readings for k in r})
    return {k: max(r.get(k, float("inf")) for r in readings) for k in keys}


def checks(readings: dict[str, float], limits: dict) -> list[tuple[str, float, float]]:
    """(name, reading, limit) of each number the limits name; a reading the
    run did not produce counts as inf."""
    return [(name, readings.get(name, float("inf")), float(limit))
            for name, limit in limits.get("limits", {}).items()]


def leaf_gaps(prog: dict[str, float], ref: dict[str, float]) -> np.ndarray:
    """Per leaf |prog norm - ref norm| over the larger of the reference's
    norm of that leaf and of the median leaf."""
    names = sorted(ref)
    r = np.array([ref[n] for n in names], np.float64)
    p = np.array([prog.get(n, np.inf) for n in names], np.float64)
    return np.abs(p - r) / np.maximum(r, np.median(r))


def train_numbers(prog: dict, ref: dict) -> dict[str, float]:
    """prog and ref each hold `losses` [(loss_gen_total, loss_disc_total)]
    of every step compared (prog's `setup_steps` of them taken in set-up,
    the rest in the window), `grad_norms` {leaf: norm of the first
    gradient} and `change_norms` {leaf: norm of its change over the
    window's checked steps}. No leaf is left out of the change: none has a
    reference gradient that is zero to rounding."""
    lp, lr = np.array(prog["losses"], np.float64), np.array(ref["losses"], np.float64)
    if lp.shape != lr.shape:
        return {"loss_gap": float("inf")}
    rel = np.abs(lp - lr) / np.abs(lr)
    k = prog["setup_steps"]
    out = {"loss_gap": float(rel.max()), "loss_gap_setup": float(rel[:k].max()),
           "loss_gap_window": float(rel[k:].max())}
    g = leaf_gaps(prog["grad_norms"], ref["grad_norms"])
    out["grad_gap"] = float(g.max())
    out["grad_gap_median"] = float(np.median(g))
    c = leaf_gaps(prog["change_norms"], ref["change_norms"])
    out["change_gap"] = float(c.max())
    out["change_gap_median"] = float(np.median(c))
    return out
