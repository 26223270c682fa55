"""The harness end to end on the CPU at a tiny size: the result line, the
files found by name, a cell and a metric added by new files alone, the
checks failing on a broken timed path, and no result without a card."""

from __future__ import annotations

import json
import os
import shutil
import subprocess
import sys

import pytest

from h100_bench import run
from h100_bench.harness import forbidden_loaded, load_cell

CELLS = ["mix.pair_new", "mix.pair_post_opt", "wavlm_only.pair_new", "mix.train_step"]


def _run(capsys, root, workload, trace, seed=5_000_000_123):
    rc = run.main(["--workload", workload, "--seed", str(seed), "--seconds", "0.5",
                   "--trace", str(trace)], root=str(root), device="cpu")
    out, err = capsys.readouterr()
    assert rc == 0, err[-3000:]
    return json.loads(out.strip().splitlines()[-1]), err


@pytest.mark.parametrize("workload", CELLS)
def test_result_line(capsys, tiny_root, workload):
    result, err = _run(capsys, tiny_root, workload, trace=0)
    assert list(result)[:5] == ["correct", "attempted", "failed", "metrics", "device"]
    assert list(result)[-1] == "checks" and result["checks"]
    assert result["correct"] is True and result["failed"] == 0 and result["attempted"] >= 1
    cell = load_cell(workload, str(tiny_root))
    assert set(result["metrics"]) == {m["name"] for m in cell.end_to_end}
    assert all(v["value"] > 0 for v in result["metrics"].values())
    # the compared numbers are the last lines of stderr, beside their limits
    tail = err.strip().splitlines()[-len(result["checks"]):]
    assert all(line.startswith("check ") and " limit " in line for line in tail)


def test_traced_result_line(capsys, tiny_root):
    result, _ = _run(capsys, tiny_root, "mix.pair_new", trace=1)
    assert result["correct"] is True
    assert {"busy_s", "window_s"} <= set(result["device"])
    assert set(result["breakdown"]) == {"device_ops", "idle_gaps"}
    cell = load_cell("mix.pair_new", str(tiny_root))
    # no card: the device readers find nothing, the host-span one reads
    assert set(result["metrics"]) <= {m["name"] for m in cell.per_layer}
    assert "f0_device_host_ms" in result["metrics"]
    assert "device_idle_pct" not in result["metrics"]


def test_cell_and_metric_added_by_new_files(capsys, tiny_root):
    """A later change adds a traffic mix, a cell and a per-layer metric as
    new files and entries, and edits no file of the harness."""
    bench_dir = tiny_root / "h100_bench"
    traffic = json.loads((bench_dir / "traffic" / "pair_new.json").read_text())
    traffic.update(source_s=[0.5, 0.8], n_files=3, check_requests=2)
    (bench_dir / "traffic" / "pair_short.json").write_text(json.dumps(traffic))
    (bench_dir / "metrics" / "requests_traced.py").write_text(
        "def read(view):\n    return float(len(view.units)) if view.units else None\n")
    shutil.copy(bench_dir / "limits" / "mix.pair_new.json",
                bench_dir / "limits" / "mix.pair_short.json")
    bench = json.loads((tiny_root / "BENCHMARK.json").read_text())
    bench["workloads"].append({"name": "mix.pair_short", "config": "knnsvc-mix",
                               "traffic": "pair_short", "chips": 1, "why": "a test cell"})
    for m in bench["end_to_end"]:
        if "workloads" in m and "mix.pair_new" in m["workloads"]:
            m["workloads"].append("mix.pair_short")
    bench["per_layer"].append({"name": "requests_traced", "unit": "requests",
                               "better": "higher", "source": "program_counter",
                               "layer": "hub.KnnSvc.convert_pair", "moves": "pair_p95_s",
                               "workloads": ["mix.pair_short"]})
    (tiny_root / "BENCHMARK.json").write_text(json.dumps(bench))
    result, _ = _run(capsys, tiny_root, "mix.pair_short", trace=1)
    assert result["metrics"]["requests_traced"]["value"] >= 1
    result, _ = _run(capsys, tiny_root, "mix.pair_short", trace=0)
    assert result["correct"] is True and "pair_p95_s" in result["metrics"]


def test_broken_timed_path_is_not_correct(capsys, tiny_root, monkeypatch):
    """An answer altered where it is produced (the waveform of every
    conversion, scaled as it leaves the vocoder) makes `correct` false."""
    import knnsvc_torch.match.serve as serve

    orig = serve.convert_pools

    def altered(*a, **kw):
        wav, shifted = orig(*a, **kw)
        return wav * 1.5, shifted

    monkeypatch.setattr(serve, "convert_pools", altered)
    result, err = _run(capsys, tiny_root, "mix.pair_new", trace=0)
    assert result["correct"] is False
    assert result["checks"]["wave_rel_median"]["value"] > result["checks"]["wave_rel_median"]["limit"]


def test_no_result_without_the_card():
    """This machine has no card: the run exits non-zero and prints no result."""
    import torch

    if torch.cuda.is_available():
        pytest.skip("a card is present")
    p = subprocess.run([sys.executable, "h100_bench/run.py", "--workload", "mix.pair_new",
                        "--seed", "1", "--seconds", "1", "--trace", "0"],
                       cwd=run.REPO_ROOT, capture_output=True, text=True, timeout=120)
    assert p.returncode != 0 and "correct" not in p.stdout


def test_no_result_with_the_benchmark_alone(tmp_path):
    """A directory with only BENCHMARK.json and the benchmark's files."""
    shutil.copy(os.path.join(run.REPO_ROOT, "BENCHMARK.json"), tmp_path)
    shutil.copytree(os.path.join(run.REPO_ROOT, "h100_bench"), tmp_path / "h100_bench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    p = subprocess.run([sys.executable, "h100_bench/run.py", "--workload", "mix.pair_new",
                        "--seed", "1", "--seconds", "1", "--trace", "0"],
                       cwd=tmp_path, capture_output=True, text=True, timeout=120,
                       env={k: v for k, v in os.environ.items() if k != "PYTHONPATH"})
    assert p.returncode != 0 and "correct" not in p.stdout


def test_forbidden_modules_by_whole_top_level_name(monkeypatch):
    for name in ("jax", "jax.numpy", "knnsvc_tpu.hub", "knnsvc_tpux", "jaxlibx"):
        monkeypatch.setitem(sys.modules, name, type(sys)(name))
    assert forbidden_loaded() == ["jax", "knnsvc_tpu"]


def _train_fault(monkeypatch, wrap):
    import knnsvc_torch.train.trainer as trainer

    orig = trainer.make_train_step

    def make(*a, **kw):
        return wrap(orig(*a, **kw))

    monkeypatch.setattr(trainer, "make_train_step", make)


def test_train_step_left_unchanged_is_not_correct(capsys, tiny_root, monkeypatch):
    """A step that returns its state unchanged."""
    import torch

    def wrap(step):
        def unchanged(state, batch):
            kept = [p.detach().clone() for m in (state.generator, state.mpd, state.msd)
                    for p in m.parameters()]
            metrics = step(state, batch)
            with torch.no_grad():
                for p, k in zip((p for m in (state.generator, state.mpd, state.msd)
                                 for p in m.parameters()), kept):
                    p.copy_(k)
            return metrics
        return unchanged

    _train_fault(monkeypatch, wrap)
    result, _ = _run(capsys, tiny_root, "mix.train_step", trace=0)
    assert result["correct"] is False


def test_train_window_step_left_unchanged_is_not_correct(capsys, tiny_root, monkeypatch):
    """The set-up steps sound and every step of the window returning its
    state unchanged: the window's own steps are what is compared."""
    import torch

    warm = load_cell("mix.train_step", str(tiny_root)).traffic["warm_steps"]

    def wrap(step):
        calls = [0]

        def unchanged_after_setup(state, batch):
            calls[0] += 1
            if calls[0] <= warm:
                return step(state, batch)
            params = [p for m in (state.generator, state.mpd, state.msd) for p in m.parameters()]
            kept = [p.detach().clone() for p in params]
            metrics = step(state, batch)
            with torch.no_grad():
                for p, k in zip(params, kept):
                    p.copy_(k)
            return metrics
        return unchanged_after_setup

    _train_fault(monkeypatch, wrap)
    result, _ = _run(capsys, tiny_root, "mix.train_step", trace=0)
    assert result["correct"] is False
    assert result["checks"]["change_gap"]["value"] > result["checks"]["change_gap"]["limit"]


def test_traced_train_reads_its_share_of_the_peak(capsys, tiny_root):
    """train_mfu_pct is read from the steps after the tracer stopped."""
    result, _ = _run(capsys, tiny_root, "mix.train_step", trace=1)
    assert result["correct"] is True
    assert result["metrics"]["train_mfu_pct"]["value"] > 0


def test_train_half_batch_left_out_is_not_correct(capsys, tiny_root, monkeypatch):
    """Half of the batch left out, the mean taken over the rest."""
    def wrap(step):
        def half(state, batch):
            n = batch["audio"].shape[0] // 2
            return step(state, {k: v[:n] for k, v in batch.items()})
        return half

    _train_fault(monkeypatch, wrap)
    result, _ = _run(capsys, tiny_root, "mix.train_step", trace=0)
    assert result["correct"] is False
