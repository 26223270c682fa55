"""knnsvc_torch's multi-process training on the CPU: two processes joined
by initialize_distributed over gloo (tests/torch_dp_worker.py), each taking
half of the batch, against the one-process step on the whole batch (loss at
rtol 1e-4, parameters at atol 1e-5); a one-process group, in which the step
all-reduces as it does over NCCL on a card; and train() on a [cpu] * 2 mesh
and in two gloo processes against train() on one device over a tiny
prematched world."""

import json
import os
import pickle
import socket
import subprocess
import sys

import numpy as np
import pytest
import torch

from knnsvc_torch.config import HiFiGANConfig, ModelFamily, WavLMConfig
from knnsvc_torch.io.jax_params import tree_from_module
from knnsvc_torch.parallel.mesh import initialize_distributed, make_mesh
from knnsvc_torch.train import trainer
from knnsvc_torch.train.loop import train
from knnsvc_torch.train.prematch import per_spk_extract
from knnsvc_torch.utils.layer_weights import generate_matrix_from_index

from test_torch_common import (DISC_WIDTH_SCALE, TINY_H, TINY_WAVLM, tiny_batch,
                               tiny_wavlm_params, write_sung_dataset)
from test_torch_common import one_torch_thread  # noqa: F401  (autouse)
from test_torch_train_common import METRICS, assert_tree_close

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CUT = dict(disc_periods=1, disc_scales=1)


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _one_process(batch: dict, n_steps: int):
    h = HiFiGANConfig.from_dict(TINY_H)
    state = trainer.init_train_state(0, h, ModelFamily.MIX, disc_width_scale=DISC_WIDTH_SCALE,
                                     device="cpu", **CUT)
    step = trainer.make_train_step(h, ModelFamily.MIX)
    tb = {k: torch.from_numpy(v) for k, v in batch.items()}
    metrics = [{k: float(v) for k, v in step(state, tb).items()} for _ in range(n_steps)]
    return metrics, [tree_from_module(m) for m in (state.generator, state.mpd, state.msd)]


def test_one_process_group_all_reduces_as_the_plain_step():
    """initialize_distributed with a coordinator and a world of 1 brings a
    gloo group up (a second call is a no-op); the step then runs its
    all-reduces and gives the plain step's numbers."""
    h = HiFiGANConfig.from_dict(TINY_H)
    batch = tiny_batch(h, 2, seed=4)
    want_metrics, want_trees = _one_process(batch, 2)
    initialize_distributed(device="cpu")           # one process, no coordinator: no-op
    assert not torch.distributed.is_initialized()
    initialize_distributed(f"127.0.0.1:{_free_port()}", 1, 0, device="cpu")
    try:
        assert torch.distributed.is_initialized() and torch.distributed.get_world_size() == 1
        initialize_distributed("127.0.0.1:1", 1, 0, device="cpu")   # already up: no-op
        assert trainer.distributed()
        got_metrics, got_trees = _one_process(batch, 2)
    finally:
        torch.distributed.destroy_process_group()
    for k in METRICS:
        np.testing.assert_allclose([m[k] for m in got_metrics], [m[k] for m in want_metrics],
                                   rtol=1e-6, err_msg=k)
    assert_tree_close(got_trees, want_trees, 1e-6)


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    root = tmp_path_factory.mktemp("dpworld")
    _, params = tiny_wavlm_params()
    w = generate_matrix_from_index(1, size=3)
    for split, notes in (("train", [(200.0, 51), (240.0, 52), (300.0, 53), (260.0, 54)]),
                         ("valid", [(220.0, 55)])):
        write_sung_dataset(root / split, {"spk0": notes})
        per_spk_extract(root / split, root / f"cached_{split}", params,
                        WavLMConfig.from_dict(TINY_WAVLM), w, w, device="cpu")
    return root


TRAIN_H = {**TINY_H, "num_workers": 1}


def _train_kw(world) -> dict:
    return dict(audio_root_train=str(world / "train"), feat_root_train=str(world / "cached_train"),
                audio_root_valid=str(world / "valid"), feat_root_valid=str(world / "cached_valid"),
                training_epochs=3, validation_interval=100, summary_interval=1,
                stdout_interval=100, with_harm=True, max_steps=2, max_val_items=1, device="cpu",
                seed=0, disc_width_scale=DISC_WIDTH_SCALE, val_artifacts=0)


def _losses(ckpt) -> list[dict]:
    with open(ckpt / "logs" / "train_log.jsonl") as fh:
        return [json.loads(line) for line in fh if "loss_gen_total" in line]


@pytest.fixture(scope="module")
def one_device_train(world, tmp_path_factory):
    """train() on one CPU device: (state, logged losses)."""
    ckpt = tmp_path_factory.mktemp("one")
    state = train(HiFiGANConfig.from_dict(TRAIN_H), checkpoint_path=str(ckpt), **_train_kw(world))
    return state, _losses(ckpt)


@pytest.fixture(scope="module")
def two_ranks(world, tmp_path_factory):
    """tests/torch_dp_worker.py as ranks 0 and 1 of a gloo group: three
    steps on half of a batch each, then train() on half of every batch
    each. -> (what rank 0 wrote, the batch, the ranks' checkpoint dirs)."""
    root = tmp_path_factory.mktemp("ranks")
    batch = tiny_batch(HiFiGANConfig.from_dict(TINY_H), 2, seed=3)
    ckpts = [root / f"rank{r}" for r in range(2)]
    job, out = root / "job.pkl", root / "out.pkl"
    with open(job, "wb") as fh:
        pickle.dump({"h": TINY_H, "seed": 0, "disc_width_scale": DISC_WIDTH_SCALE,
                     "batch": batch, "n_steps": 3, "train_h": TRAIN_H, "train": _train_kw(world),
                     "checkpoint_paths": [str(c) for c in ckpts], **CUT}, fh)
    port = _free_port()
    env = {**os.environ, "PYTHONPATH": REPO + os.pathsep + os.environ.get("PYTHONPATH", "")}
    procs = [subprocess.Popen([sys.executable, os.path.join(REPO, "tests", "torch_dp_worker.py"),
                               str(rank), "2", str(port), str(job), str(out)], env=env,
                              stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
             for rank in range(2)]
    try:
        logs = [p.communicate(timeout=180)[0] for p in procs]
    finally:
        for p in procs:
            p.kill()
    assert [p.returncode for p in procs] == [0, 0], logs
    with open(out, "rb") as fh:
        return pickle.load(fh), batch, ckpts


def test_two_gloo_ranks_match_one_process(two_ranks):
    got, batch, _ = two_ranks
    want_metrics, want_trees = _one_process(batch, 3)
    for k in METRICS:
        np.testing.assert_allclose([m[k] for m in got["metrics"]], [m[k] for m in want_metrics],
                                   rtol=1e-4, err_msg=k)
    assert assert_tree_close(got["trees"], want_trees, 1e-5) > 50


def test_train_on_two_gloo_ranks_matches_one_process(two_ranks, one_device_train):
    """train() in two processes, each on its half of every batch: the
    generator ends where one process's does, and only rank 0 writes the
    log and the checkpoints."""
    got, _, (rank0, rank1) = two_ranks
    one, log_one = one_device_train
    assert_tree_close(got["train_trees"][0], tree_from_module(one.generator), 1e-5)
    assert [r["step"] for r in _losses(rank0)] == [r["step"] for r in log_one] == [0, 1, 2]
    assert not (rank1 / "logs" / "train_log.jsonl").stat().st_size
    assert not any(p.name.endswith(".knnsvc.pkl") for p in rank1.iterdir())
    assert any(p.name.endswith(".knnsvc.pkl") for p in rank0.iterdir())


def test_train_on_a_mesh_matches_one_device(world, one_device_train, tmp_path):
    """train(mesh=[cpu] * 2) and train(device='cpu') (whose default mesh is
    one device) log the same losses and end on the same generator."""
    one, log_one = one_device_train
    mesh = make_mesh(2, 1, devices=[torch.device("cpu")] * 2)
    two = train(HiFiGANConfig.from_dict(TRAIN_H), checkpoint_path=str(tmp_path), mesh=mesh,
                **_train_kw(world))
    log_two = _losses(tmp_path)
    assert one.steps == two.steps == 3 and [r["step"] for r in log_two] == [0, 1, 2]
    for k in METRICS:
        np.testing.assert_allclose([r[k] for r in log_two], [r[k] for r in log_one], rtol=1e-4,
                                   err_msg=k)
    assert_tree_close(tree_from_module(two.generator), tree_from_module(one.generator), 1e-5)
