"""Training loop (counterpart of knnsvc_tpu/train/loop.py; the reference's
hifigan/ddsp_train.py:29-440 train()), around the train step on a device
mesh (one device, or the batch sharded over the mesh's 'data' axis).

- per-epoch ExponentialLR decay: lr * decay^epoch, set before the epoch's
  first step (ref :149-150,387-388); the steps > max_steps cap (1e6,
  ref :172);
- validation at step 0 and every validation_interval steps on full
  utterances zero-padded to frame buckets (masked error); best-val-only
  retention that deletes the previous best pair (ref :344-372);
- checkpoints: g_<type>_<steps>.knnsvc.pkl {generator} and
  do_<type>_<steps>.knnsvc.pkl {mpd, msd, optim_g, optim_d, steps, epoch}
  in the JAX package's layout (the trees; the optimizer states are the
  port's AdamW moments as plain numpy dicts), so a g_ written by either
  package serves in both; checkpoint_backend="orbax" instead saves the whole
  TrainState as an orbax checkpoint under <checkpoint_path>/orbax, in the
  JAX package's TrainState layout (io/orbax_ckpt.py, which needs neither
  orbax nor JAX), so either package resumes the other's, and
  export_servable_checkpoint turns it into the g_/do_ pair;
- metrics go to logs/train_log.jsonl with the reference's scalars
  (ref :281-284,336), and the first val_artifacts validation utterances'
  audio and mel to logs/.
Resuming from a g_/do_ pair keeps the step count continuous; a do_ written
by the JAX package holds optax's AdamW state, which maps onto the port's
AdamW (io/jax_params.adamw_from_optax).
Under torch.distributed (parallel/mesh.initialize_distributed) every process
draws the same global batches and trains on its rank's contiguous part of
each (the step averages the gradients over the processes); process 0 alone
writes the log and the checkpoints.
"""

from __future__ import annotations

import glob
import json
import os
import time
from pathlib import Path

import numpy as np
import torch

from knnsvc_torch.config import HiFiGANConfig, ModelFamily
from knnsvc_torch.io.checkpoints import load_numpy_params, save_params
from knnsvc_torch.io.jax_params import (train_state_from_jax, train_state_from_numpy,
                                        train_state_to_numpy, tree_from_module)
from knnsvc_torch.io.orbax_ckpt import restore_train_state, save_train_state
from knnsvc_torch.train.dataset import BATCH_KEYS, MelDataset, batch_iterator
from knnsvc_torch.train.trainer import (TrainState, distributed, eval_bucket, eval_step_padded,
                                        init_train_state, make_train_step, set_learning_rate)

MAX_STEPS = 1_000_000  # ref ddsp_train.py:172
OPTIM_FORMAT = "knnsvc_torch.adamw"
ORBAX_DIR = "orbax"


def _family(h: HiFiGANConfig, with_harm: bool | None) -> ModelFamily:
    return ModelFamily.MIX if (h.with_harm if with_harm is None else with_harm) \
        else ModelFamily.F0_ONLY


def _param_names(state: TrainState) -> tuple[list[str], list[str]]:
    """Names of each optimizer's parameters, in its order."""
    return ([n for n, _ in state.generator.named_parameters()],
            [f"mpd.{n}" for n, _ in state.mpd.named_parameters()]
            + [f"msd.{n}" for n, _ in state.msd.named_parameters()])


def optimizer_to_numpy(opt_state: dict, names: list[str]) -> dict:
    """An AdamW state_dict -> plain numpy dicts keyed by parameter name."""
    out = {"format": OPTIM_FORMAT, "lr": float(opt_state["param_groups"][0]["lr"]),
           "step": {}, "exp_avg": {}, "exp_avg_sq": {}}
    for i, name in enumerate(names):
        st = opt_state["state"].get(i)
        if st:
            out["step"][name] = float(st["step"])
            out["exp_avg"][name] = st["exp_avg"].detach().cpu().numpy()
            out["exp_avg_sq"][name] = st["exp_avg_sq"].detach().cpu().numpy()
    return out


def _optimizer_from_numpy(opt: torch.optim.Optimizer, names: list[str], data: dict) -> None:
    params = [p for g in opt.param_groups for p in g["params"]]
    for p, name in zip(params, names):
        if name in data["exp_avg"]:
            opt.state[p] = {
                "step": torch.tensor(data["step"][name], dtype=torch.float32),
                "exp_avg": torch.from_numpy(data["exp_avg"][name]).to(p.device).clone(),
                "exp_avg_sq": torch.from_numpy(data["exp_avg_sq"][name]).to(p.device).clone()}


def _save_pair(out_dir: str, ckpt_type: str, steps: int, epoch: int, g_tree, mpd_tree,
               msd_tree, optim_g: dict, optim_d: dict) -> list[str]:
    paths = [os.path.join(out_dir, f"g_{ckpt_type}_{steps:08d}.knnsvc.pkl"),
             os.path.join(out_dir, f"do_{ckpt_type}_{steps:08d}.knnsvc.pkl")]
    save_params(paths[0], {"generator": g_tree})
    save_params(paths[1], {"mpd": mpd_tree, "msd": msd_tree, "optim_g": optim_g,
                           "optim_d": optim_d, "steps": steps, "epoch": epoch})
    return paths


def _latest(pattern: str) -> str | None:
    matches = sorted(glob.glob(pattern))
    return matches[-1] if matches else None


def _resume_pair(resume_from: str, h: HiFiGANConfig, family: ModelFamily,
                 dev: torch.device) -> tuple[TrainState, int, int] | None:
    """Restore a TrainState from the latest g_/do_ pair in resume_from
    (ref ddsp_train.py:113-133) -> (state, start_steps, start_epoch), or
    None when the directory holds no pair."""
    cp_g, cp_do = _latest(os.path.join(resume_from, "*g_*")), _latest(
        os.path.join(resume_from, "*do_*"))
    if not (cp_g and cp_do):
        return None
    do = load_numpy_params(cp_do)
    g = load_numpy_params(cp_g)["generator"]
    steps = int(do.get("steps", 0))
    jax_written = "optim_g" in do and not (isinstance(do["optim_g"], dict)
                                           and do["optim_g"].get("format") == OPTIM_FORMAT)
    if jax_written:
        # the JAX loop's pair: optax's inject_hyperparams(adamw) states
        state = train_state_from_jax({"g_params": g, "mpd_params": do["mpd"],
                                      "msd_params": do["msd"], "opt_g": do["optim_g"],
                                      "opt_d": do["optim_d"], "steps": steps}, h, family, dev)
    else:
        state = train_state_from_numpy(g, do["mpd"], do["msd"], h, family, dev, steps=steps)
        names_g, names_d = _param_names(state)
        for key, opt, names in (("optim_g", state.opt_g, names_g),
                                ("optim_d", state.opt_d, names_d)):
            if key in do:
                _optimizer_from_numpy(opt, names, do[key])
    print(f"restored from {cp_g} / {cp_do} at step {steps + 1}", flush=True)
    return state, steps + 1, int(do.get("epoch", -1)) + 1


def train(h: HiFiGANConfig, audio_root_train: str, feat_root_train: str, audio_root_valid: str,
          feat_root_valid: str, checkpoint_path: str, training_epochs: int = 1800,
          validation_interval: int = 1000, summary_interval: int = 25,
          stdout_interval: int = 25, with_harm: bool | None = None,
          max_steps: int = MAX_STEPS, max_val_items: int | None = None,
          device: str | torch.device = "cuda", seed: int | None = None,
          resume_from: str | None = None, compute_dtype: str | None = None,
          checkpoint_backend: str = "pickle", val_artifacts: int = 2,
          ckpt_type: str | None = None, disc_width_scale: int = 1,
          mesh=None) -> TrainState:
    """Fine-tune the vocoder on prematched features; returns the final
    TrainState. Runs on device="cuda" unless the caller passes "cpu".
    mesh: a parallel.mesh.Mesh whose 'data' axis shards each batch (the
    state lives on mesh.first); by default, as in the JAX package, the
    largest number of `device`'s devices (every visible card for "cuda",
    this process's card under torch.distributed) that divides the batch
    size.
    compute_dtype='bfloat16' runs the bf16 step (the reference's fp16 AMP
    analogue, ref ddsp_train.py:153-155). checkpoint_backend='orbax' keeps
    the best-val TrainState as an orbax checkpoint under
    <checkpoint_path>/orbax (the JAX package's layout: either package
    resumes the other's) instead of the g_/do_ pair. val_artifacts:
    the first N validation utterances' generated audio and mel go to logs/
    at each validation (ref ddsp_train.py:320-336)."""
    from knnsvc_torch.dsp.stft import log_mel_spectrogram
    from knnsvc_torch.hub import resolve_device
    from knnsvc_torch.io.audio import save_audio
    from knnsvc_torch.parallel.mesh import make_mesh
    from knnsvc_torch.precision import apply_precision

    if checkpoint_backend not in ("pickle", "orbax"):
        raise ValueError(f"checkpoint_backend must be 'pickle' or 'orbax', not "
                         f"{checkpoint_backend!r}")
    dev = resolve_device(device)
    world, rank = 1, 0
    if distributed():
        world, rank = torch.distributed.get_world_size(), torch.distributed.get_rank()
        if h.batch_size % world:
            raise ValueError(f"batch_size {h.batch_size} does not split over {world} processes")
    if mesh is None:
        if dev.type == "cuda" and dev.index is None and world == 1:
            devices = [torch.device("cuda", i) for i in range(torch.cuda.device_count())]
        else:
            devices = [dev]
        local = h.batch_size // world
        mesh = make_mesh(max(d for d in range(1, len(devices) + 1) if local % d == 0), 1, devices)
    dev = mesh.first
    apply_precision()
    family = _family(h, with_harm)
    # checkpoint names carry the ckpt_type, so KnnSvc.load(ckpt_dir,
    # ckpt_type) finds them (ref ddsp_hubconf.py:85)
    if ckpt_type is None:
        ckpt_type = "mix" if family == ModelFamily.MIX else "wavlm_only"
    os.makedirs(checkpoint_path, exist_ok=True)
    log_dir = Path(checkpoint_path) / "logs"
    os.makedirs(log_dir, exist_ok=True)

    state = init_train_state(h.seed if seed is None else seed, h, family,
                             disc_width_scale=disc_width_scale, device=dev)
    start_epoch, start_steps = 0, 0
    if resume_from is not None and checkpoint_backend == "orbax":
        try:
            tree, start_steps, ckpt_epoch = restore_train_state(
                os.path.join(resume_from, ORBAX_DIR), template=train_state_to_numpy(state))
        except FileNotFoundError:
            pass
        else:
            state = train_state_from_jax(tree, h, family, dev)
            start_steps += 1
            start_epoch = ckpt_epoch + 1
            print(f"restored orbax checkpoint at step {start_steps} (epoch {start_epoch})",
                  flush=True)
    elif resume_from is not None:
        resumed = _resume_pair(resume_from, h, family, dev)
        if resumed is not None:
            state, start_steps, start_epoch = resumed
    dtype = torch.bfloat16 if compute_dtype in ("bfloat16", "bf16") else None
    step_fn = make_train_step(h, family, compute_dtype=dtype, mesh=mesh)

    trainset = MelDataset(h, audio_root_train, feat_root_train, split=True, seed=h.seed)
    validset = MelDataset(h, audio_root_valid, feat_root_valid, split=False, shuffle=False)

    prev_min_val_err = float("inf")
    prev_min_val_err_step = -1
    cur_best_ckpts: list[str] = []
    steps = start_steps
    epoch = start_epoch

    with open(log_dir / "train_log.jsonl", "a") as log_file:

        def log(scalars: dict) -> None:
            if rank:
                return
            log_file.write(json.dumps({"step": steps, **scalars}) + "\n")
            log_file.flush()

        def fit(a, n, axis=0):
            # clip-then-pad to exactly n along axis (full-utterance audio and
            # mel can each run a hair past T*hop / T+1)
            sl = [slice(None)] * a.ndim
            sl[axis] = slice(0, n)
            a = a[tuple(sl)]
            widths = [(0, 0)] * a.ndim
            widths[axis] = (0, n - a.shape[axis])
            return torch.from_numpy(np.ascontiguousarray(np.pad(a, widths)))[None].to(dev)

        def run_validation():
            nonlocal prev_min_val_err, prev_min_val_err_step, cur_best_ckpts
            errs = []
            n_items = len(validset) if max_val_items is None else min(max_val_items, len(validset))
            for j in range(n_items):
                item = validset[j]
                T = item["feats"].shape[0]
                Tb = eval_bucket(T)
                mel_true = item["mel_loss"].shape[-1]
                batch = {"feats": fit(item["feats"], Tb),
                         "audio": fit(item["audio"], Tb * h.hop_size),
                         "mel_loss": fit(item["mel_loss"], Tb + 1, axis=-1),
                         "f0": fit(item["f0"], Tb), "harmonics": fit(item["harmonics"], Tb)}
                err, y_hat = eval_step_padded(state.generator, h, family, batch,
                                              min(mel_true, Tb + 1))
                errs.append(float(err))
                if j < val_artifacts and not rank:
                    wav = y_hat[0, 0, : T * h.hop_size].float().cpu()
                    save_audio(log_dir / f"val_{steps:08d}_{j}.wav", wav.numpy(), h.sampling_rate)
                    with torch.no_grad():
                        mel = log_mel_spectrogram(
                            wav[None], n_fft=h.n_fft, num_mels=h.num_mels,
                            sampling_rate=h.sampling_rate, hop_size=h.hop_size,
                            win_size=h.win_size, fmin=h.fmin, fmax=h.fmax)[0].numpy()
                    np.save(log_dir / f"val_{steps:08d}_{j}_mel.npy", mel)
                    try:
                        from knnsvc_torch.utils.plotting import save_mel_figure

                        save_mel_figure(log_dir / f"val_{steps:08d}_{j}_mel.png", mel)
                    except ImportError:
                        pass  # matplotlib absent: the .npy artifact remains
            val_err = float(np.mean(errs)) if errs else float("inf")
            log({"validation/mel_spec_error": val_err})
            print(f"validation at {steps}: mel err {val_err:.4f}", flush=True)

            if val_err < prev_min_val_err:
                prev_min_val_err, prev_min_val_err_step = val_err, steps
                if rank:
                    return
                if checkpoint_backend == "orbax":
                    save_train_state(os.path.join(checkpoint_path, ORBAX_DIR), steps,
                                     train_state_to_numpy(state), keep=1, epoch=epoch)
                    cur_best_ckpts = []
                else:
                    names_g, names_d = _param_names(state)
                    new_ckpts = _save_pair(
                        checkpoint_path, ckpt_type, steps, epoch,
                        tree_from_module(state.generator), tree_from_module(state.mpd),
                        tree_from_module(state.msd),
                        optimizer_to_numpy(state.opt_g.state_dict(), names_g),
                        optimizer_to_numpy(state.opt_d.state_dict(), names_d))
                    for old in cur_best_ckpts:
                        if os.path.exists(old):
                            os.remove(old)
                    cur_best_ckpts = new_ckpts

        for epoch in range(start_epoch, training_epochs):
            if steps > max_steps:
                break
            epoch_start = time.time()
            lr = h.learning_rate * (h.lr_decay ** epoch)
            set_learning_rate(state.opt_g, lr)
            set_learning_rate(state.opt_d, lr)

            for batch in batch_iterator(trainset, h.batch_size, shuffle=True,
                                        seed=h.seed + epoch, num_workers=h.num_workers):
                part = len(batch["audio"]) // world
                arrays = {k: torch.from_numpy(batch[k][rank * part:(rank + 1) * part]).to(dev)
                          for k in BATCH_KEYS}
                metrics = step_fn(state, arrays)

                if steps % summary_interval == 0:
                    log({k: float(v) for k, v in metrics.items()})
                if steps % stdout_interval == 0:
                    print(f"step {steps}: gen {float(metrics['loss_gen_total']):.3f} "
                          f"mel {float(metrics['mel_spec_error']):.3f} "
                          f"(best val {prev_min_val_err:.3f} @ {prev_min_val_err_step})",
                          flush=True)
                if steps % validation_interval == 0:
                    run_validation()
                steps += 1
                if steps > max_steps:
                    break

            print(f"epoch {epoch + 1} took {int(time.time() - epoch_start)}s", flush=True)
    return state


def export_servable_checkpoint(checkpoint_path: str, h: HiFiGANConfig,
                               with_harm: bool | None = None, ckpt_type: str | None = None,
                               out_dir: str | None = None) -> tuple[str, str]:
    """Turn the best-val TrainState of checkpoint_backend='orbax' (the
    newest step under <checkpoint_path>/orbax, whichever package wrote it)
    into the g_/do_ pair, servable by `KnnSvc.load(out_dir, ckpt_type)` and
    resumable by `train(resume_from=out_dir)` (the deploy artifact of
    ref ddsp_train.py:352-367). Returns (g_path, do_path); FileNotFoundError
    when orbax/ holds no step."""
    family = _family(h, with_harm)
    if ckpt_type is None:
        ckpt_type = "mix" if family == ModelFamily.MIX else "wavlm_only"
    out_dir = checkpoint_path if out_dir is None else out_dir
    tree, steps, epoch = restore_train_state(os.path.join(checkpoint_path, ORBAX_DIR))
    state = train_state_from_jax(tree, h, family, "cpu")
    names_g, names_d = _param_names(state)
    os.makedirs(out_dir, exist_ok=True)
    return tuple(_save_pair(
        out_dir, ckpt_type, steps, epoch, tree["g_params"], tree["mpd_params"],
        tree["msd_params"], optimizer_to_numpy(state.opt_g.state_dict(), names_g),
        optimizer_to_numpy(state.opt_d.state_dict(), names_d)))
