"""knnsvc_torch's training loop and train CLI end to end on the CPU, on a
tiny world (tests/test_train_loop.py's WavLM, TINY_H, sung audio,
prematched by the port): the JSONL log lines, validation artifacts,
best-val retention (the one pair left is the best validation's), resume
that continues the step count, resume from a JAX-written g_/do_ pair, the
orbax backend with the bf16 step and its export to a g_/do_ pair, a port-trained g_
served by the port's KnnSvc.load(device="cpu") and by the JAX package's
KnnSvc.load (the same waveform at 2e-4), and the train CLI with
--precision high."""

import glob
import json

import numpy as np
import pytest

from knnsvc_torch.config import HiFiGANConfig, WavLMConfig
from knnsvc_torch.io.checkpoints import load_params, save_params
from knnsvc_torch.train.loop import export_servable_checkpoint, train
from knnsvc_torch.train.prematch import per_spk_extract
from knnsvc_torch.utils.layer_weights import generate_matrix_from_index

from test_torch_common import (DISC_WIDTH_SCALE, TINY_H, TINY_WAVLM, tiny_wavlm_params,
                               write_sung_dataset)
from test_torch_common import one_torch_thread  # noqa: F401  (autouse)

NOTES = [(200.0, 51), (240.0, 52), (300.0, 53)]


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    root = tmp_path_factory.mktemp("trainworld")
    _, params = tiny_wavlm_params()
    w = generate_matrix_from_index(1, size=3)
    for split, notes in (("train", NOTES), ("valid", NOTES[:2])):
        write_sung_dataset(root / split, {"spk0": notes})
        per_spk_extract(root / split, root / f"cached_{split}", params,
                        WavLMConfig.from_dict(TINY_WAVLM), w, w, device="cpu")
    save_params(str(root / "wavlm.knnsvc.pkl"), {"cfg": TINY_WAVLM, "model": params})
    (root / "config.json").write_text(json.dumps(TINY_H))
    return root


def _roots(root):
    return dict(audio_root_train=str(root / "train"), feat_root_train=str(root / "cached_train"),
                audio_root_valid=str(root / "valid"), feat_root_valid=str(root / "cached_valid"))


def _log(ckpt_dir):
    return [json.loads(line) for line in
            open(ckpt_dir / "logs" / "train_log.jsonl").read().strip().split("\n")]


@pytest.fixture(scope="module")
def trained(world, tmp_path_factory):
    """Four steps, validation and a summary at each."""
    ckpt_dir = tmp_path_factory.mktemp("ckpts")
    h = HiFiGANConfig.from_dict({**TINY_H, "num_workers": 2})
    state = train(h, checkpoint_path=str(ckpt_dir), training_epochs=4, validation_interval=1,
                  summary_interval=1, stdout_interval=100, with_harm=True, max_steps=3,
                  max_val_items=1, device="cpu", disc_width_scale=DISC_WIDTH_SCALE,
                  val_artifacts=1, **_roots(world))
    return h, state, ckpt_dir


def test_train_loop_logs_and_keeps_best(trained):
    h, state, ckpt_dir = trained
    assert state.steps == 4
    scalars = _log(ckpt_dir)
    steps = [s["step"] for s in scalars if "loss_gen_total" in s]
    vals = [(s["validation/mel_spec_error"], s["step"]) for s in scalars
            if "validation/mel_spec_error" in s]
    assert steps == [0, 1, 2, 3] and [v[1] for v in vals] == [0, 1, 2, 3]
    assert all(np.isfinite(s[k]) for s in scalars for k in s if k != "step")
    # best-val retention: one pair, the best validation's
    gs = glob.glob(str(ckpt_dir / "g_mix_*.knnsvc.pkl"))
    dos = glob.glob(str(ckpt_dir / "do_mix_*.knnsvc.pkl"))
    best_step = min(vals)[1]
    assert len(gs) == len(dos) == 1 and gs[0].endswith(f"g_mix_{best_step:08d}.knnsvc.pkl")
    do = load_params(dos[0])
    assert {"mpd", "msd", "optim_g", "optim_d", "steps", "epoch"} <= set(do)
    assert do["steps"] == best_step and do["optim_g"]["format"] == "knnsvc_torch.adamw"
    assert glob.glob(str(ckpt_dir / "logs" / "val_*_0.wav"))
    mel = np.load(sorted(glob.glob(str(ckpt_dir / "logs" / "val_*_0_mel.npy")))[0])
    assert mel.ndim == 2 and np.isfinite(mel).all()


def test_resume_continues_steps(world, trained, tmp_path):
    h, _, ckpt_dir = trained
    do = load_params(glob.glob(str(ckpt_dir / "do_*.knnsvc.pkl"))[0])
    out = tmp_path / "resumed"
    state = train(h, checkpoint_path=str(out), training_epochs=8, validation_interval=1000,
                  summary_interval=1, stdout_interval=1000, with_harm=True,
                  max_steps=do["steps"] + 2, max_val_items=1, device="cpu",
                  disc_width_scale=DISC_WIDTH_SCALE, resume_from=str(ckpt_dir), **_roots(world))
    logged = [s["step"] for s in _log(out) if "loss_gen_total" in s]
    assert logged == [do["steps"] + 1, do["steps"] + 2]
    assert state.steps == do["steps"] + 2


def test_resume_from_jax_do_raises(world, tmp_path):
    """A g_/do_ pair as the JAX package's loop writes it (optax's
    inject_hyperparams(adamw) state in the do_, its NamedTuples pickled)
    resumes in the port: the state is train_state_from_numpy(..., adam_g=,
    adam_d=) of the same trees, with the JAX state's step count and
    learning rate. (The name is kept from when the port refused such a
    pair with a ValueError.)"""
    import jax
    import torch

    from knnsvc_tpu.config import HiFiGANConfig as JaxHiFiGANConfig
    from knnsvc_tpu.io.checkpoints import save_params as jax_save_params
    from knnsvc_tpu.train.trainer import make_optimizers
    from knnsvc_torch.config import ModelFamily
    from knnsvc_torch.io.jax_params import train_state_from_numpy
    from knnsvc_torch.models.hifigan.discriminator import init_mpd_params, init_msd_params
    from knnsvc_torch.models.hifigan.generator import init_generator_params

    from test_torch_common import adam_moments

    h = HiFiGANConfig.from_dict(TINY_H)
    gen = torch.Generator().manual_seed(0)
    g = init_generator_params(h, ModelFamily.MIX, gen, weight_norm_parametrized=True)
    mpd = init_mpd_params(gen, width_scale=DISC_WIDTH_SCALE)
    msd = init_msd_params(gen, width_scale=DISC_WIDTH_SCALE)
    # the JAX trainer's optimizer states after 4 steps, as its loop pickles them
    rng = np.random.default_rng(3)

    def stepped(opt, params, lr):
        state = jax.device_get(jax.jit(opt.init)(params))
        adam = state.inner_state[0]
        moment = lambda path, p: np.zeros_like(p) if {"u", "v_pow"} & {  # noqa: E731
            getattr(k, "key", None) for k in path} else (
            1e-3 * np.abs(rng.standard_normal(p.shape))).astype(np.float32)
        count = np.asarray(4, np.int32)
        state = state._replace(count=count, inner_state=(adam._replace(
            count=count, mu=jax.tree_util.tree_map_with_path(moment, adam.mu),
            nu=jax.tree_util.tree_map_with_path(moment, adam.nu)),) + state.inner_state[1:])
        state.hyperparams["learning_rate"] = np.asarray(lr, np.float32)
        return state

    opt_g, opt_d = make_optimizers(JaxHiFiGANConfig.from_dict(TINY_H))
    optim_g, optim_d = stepped(opt_g, g, 1.5e-4), stepped(opt_d, (mpd, msd), 1.5e-4)
    jax_save_params(str(tmp_path / "g_mix_00000004.knnsvc.pkl"), {"generator": g})
    jax_save_params(str(tmp_path / "do_mix_00000004.knnsvc.pkl"), {
        "mpd": mpd, "msd": msd, "optim_g": optim_g, "optim_d": optim_d, "steps": 4,
        "epoch": 0})
    # max_steps below the next step: the restored state, no step taken
    state = train(h, checkpoint_path=str(tmp_path / "out"), max_steps=4, device="cpu",
                  disc_width_scale=DISC_WIDTH_SCALE, resume_from=str(tmp_path), **_roots(world))
    want = train_state_from_numpy(g, mpd, msd, h, ModelFamily.MIX, "cpu",
                                  adam_g=adam_moments(optim_g), adam_d=adam_moments(optim_d),
                                  steps=4)
    assert state.steps == want.steps == 4
    for key in ("generator", "mpd", "msd"):
        got_sd, want_sd = getattr(state, key).state_dict(), getattr(want, key).state_dict()
        assert got_sd.keys() == want_sd.keys()
        assert all(torch.equal(got_sd[k], want_sd[k]) for k in want_sd)
    for got_opt, want_opt in ((state.opt_g, want.opt_g), (state.opt_d, want.opt_d)):
        got_params = [p for grp in got_opt.param_groups for p in grp["params"]]
        want_params = [p for grp in want_opt.param_groups for p in grp["params"]]
        assert len(got_params) == len(want_params)
        for p, q in zip(got_params, want_params):
            a, b = got_opt.state[p], want_opt.state[q]
            assert float(a["step"]) == float(b["step"]) == 4.0
            assert torch.equal(a["exp_avg"], b["exp_avg"])
            assert torch.equal(a["exp_avg_sq"], b["exp_avg_sq"])
        assert got_opt.param_groups[0]["lr"] == float(np.float32(1.5e-4))


def test_torch_backend_bf16_and_export(world, tmp_path):
    """The port's checkpoint_backend='orbax' with the bf16 step: fp32
    parameters, one checkpoint kept, a resume from it that continues the
    steps, and its export to a g_/do_ pair that resumes and serves. (The
    name is kept from the port's torch.save backend, which orbax replaced.)"""
    from knnsvc_torch.hub import KnnSvc
    from knnsvc_torch.io.orbax_ckpt import checkpoint_steps

    h = HiFiGANConfig.from_dict(TINY_H)
    kw = dict(validation_interval=1, summary_interval=1, stdout_interval=100, with_harm=True,
              max_val_items=1, device="cpu", disc_width_scale=DISC_WIDTH_SCALE, val_artifacts=0,
              checkpoint_backend="orbax", **_roots(world))
    run1 = tmp_path / "run1"
    state = train(h, checkpoint_path=str(run1), training_epochs=2, max_steps=1,
                  compute_dtype="bfloat16", **kw)
    assert all(p.dtype.is_floating_point and p.dtype.itemsize == 4
               for p in state.generator.parameters())
    assert len(checkpoint_steps(str(run1 / "orbax"))) == 1
    assert not glob.glob(str(run1 / "g_*"))
    state2 = train(h, checkpoint_path=str(tmp_path / "run2"), training_epochs=4,
                   max_steps=3, resume_from=str(run1), **kw)
    saved_step = checkpoint_steps(str(run1 / "orbax"))[0]
    assert [s["step"] for s in _log(tmp_path / "run2") if "loss_gen_total" in s][0] == saved_step + 1
    assert state2.steps > saved_step

    g_path, do_path = export_servable_checkpoint(str(run1), h, with_harm=True,
                                                 out_dir=str(tmp_path / "exported"))
    assert "g_mix_" in g_path and {"mpd", "msd", "optim_g", "optim_d", "steps", "epoch"} <= set(
        load_params(do_path))
    train(h, checkpoint_path=str(tmp_path / "run3"), training_epochs=4, max_steps=saved_step + 1,
          resume_from=str(tmp_path / "exported"), **{**kw, "checkpoint_backend": "pickle"})
    assert [s["step"] for s in _log(tmp_path / "run3") if "loss_gen_total" in s] == [saved_step + 1]
    with pytest.raises(FileNotFoundError):
        export_servable_checkpoint(str(tmp_path / "run3"), h, with_harm=True)
    knn = KnnSvc.load(str(tmp_path / "exported"), "mix", wavlm_ckpt=str(world / "wavlm.knnsvc.pkl"),
                      config_path=str(world / "config.json"), device="cpu")
    y = knn.vocode(np.zeros((6, 16), np.float32), np.full(6, 200.0, np.float32),
                   np.full((6, 49), 0.01, np.float32))
    assert y.shape == (6 * 320,) and np.isfinite(y).all()


def test_port_trained_checkpoint_serves_in_both(world, trained, tmp_path):
    from knnsvc_tpu.hub import KnnSvc as JaxKnnSvc
    from knnsvc_torch.hub import KnnSvc
    from knnsvc_torch.io.audio import load_audio

    _, _, ckpt_dir = trained
    kw = dict(wavlm_ckpt=str(world / "wavlm.knnsvc.pkl"), config_path=str(world / "config.json"))
    port = KnnSvc.load(str(ckpt_dir), "mix", device="cpu", **kw)
    ref = JaxKnnSvc.load(str(ckpt_dir), "mix", **kw)
    rng = np.random.default_rng(11)
    feats = rng.standard_normal((12, 16)).astype(np.float32)
    f0 = np.full(12, 220.0, np.float32)
    harm = (rng.random((12, 49)) * 0.05).astype(np.float32)
    want = ref.vocode(feats, f0, harm)
    assert np.abs(want).max() > 0
    np.testing.assert_allclose(port.vocode(feats, f0, harm), want, atol=2e-4)

    port.weighting = generate_matrix_from_index(1, size=3)
    out = tmp_path / "served.wav"
    assert port.convert_pair(str(world / "train" / "spk0" / "utt0.wav"),
                             str(world / "valid" / "spk0" / "utt1.wav"), fast=True,
                             output_path=str(out)) == str(out)
    y, sr = load_audio(out)
    assert sr == 16000 and np.isfinite(y).all() and np.abs(y).max() <= 1.0


def test_train_cli_high_precision(world, tmp_path):
    """cli.train accepts --precision high (TF32 in cuBLAS and cuDNN, the
    attention kernel's three passes) and trains at full discriminator
    width on the tiny generator."""
    from knnsvc_torch.cli.train import main
    from knnsvc_torch.precision import get_precision, set_precision

    try:
        assert main(["--audio_root_path_train", str(world / "train"),
                     "--audio_root_path_valid", str(world / "valid"),
                     "--feature_root_path_train", str(world / "cached_train"),
                     "--feature_root_path_valid", str(world / "cached_valid"),
                     "--checkpoint_path", str(tmp_path / "cli"), "--config",
                     str(world / "config.json"), "--training_epochs", "1",
                     "--validation_interval", "1", "--summary_interval", "1",
                     "--fine_tuning", "--precision", "high", "--device", "cpu"]) == 0
        assert get_precision() == "high"
    finally:
        set_precision("highest")
    assert len(glob.glob(str(tmp_path / "cli" / "g_mix_00000000.knnsvc.pkl"))) == 1
    scalars = _log(tmp_path / "cli")
    assert any("loss_gen_total" in s for s in scalars)


def test_training_entry_points_default_to_cuda(monkeypatch, world, tmp_path):
    """train, per_spk_extract and both CLIs default to device='cuda' and
    raise without a card; none falls back to the CPU."""
    import torch

    from knnsvc_torch.cli.prematch import main as prematch_main
    from knnsvc_torch.cli.train import main as train_main

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    _, params = tiny_wavlm_params()
    w = generate_matrix_from_index(1, size=3)
    roots = _roots(world)
    calls = [
        lambda: train(HiFiGANConfig.from_dict(TINY_H), checkpoint_path=str(tmp_path / "t"),
                      **roots),
        lambda: per_spk_extract(world / "train", tmp_path / "p", params,
                                WavLMConfig.from_dict(TINY_WAVLM), w, w),
        lambda: prematch_main(["--librispeech_path", str(world / "train"), "--out_path",
                               str(tmp_path / "c"), "--prematch"]),
        lambda: train_main(["--audio_root_path_train", roots["audio_root_train"],
                            "--audio_root_path_valid", roots["audio_root_valid"],
                            "--feature_root_path_train", roots["feat_root_train"],
                            "--feature_root_path_valid", roots["feat_root_valid"],
                            "--checkpoint_path", str(tmp_path / "ct")]),
    ]
    for call in calls:
        with pytest.raises(RuntimeError, match="no CUDA device"):
            call()
    assert not (tmp_path / "p").exists() and not (tmp_path / "c").exists()
