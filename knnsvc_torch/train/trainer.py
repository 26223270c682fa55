"""Vocoder GAN trainer (counterpart of knnsvc_tpu/train/trainer.py).

Reference recipe (hifigan/ddsp_train.py): AdamW(lr 2e-4, betas (0.8, 0.99)),
per-epoch ExponentialLR decay 0.999, a D step (MPD + MSD, LSGAN) then a G
step (adv + feature matching + 45 * L1 log-mel), batch 16, segment 7040
samples.

The JAX package runs this as one jitted step over a device mesh; here it is
that step, in the same order:
- y_hat from the pre-update generator, detached;
- one spectral-norm power-iteration step (MSD scale 0) on the pre-update
  weights, then the D loss and the D update;
- the generator forward again, against the UPDATED discriminators (as the
  reference's sequential optim_d.step() -> G forward); the G loss is adv +
  2 * feature matching + 45 * L1 of the fp32 log-mel of y_hat.
The discriminators' parameters are frozen through the G backward: only the
generator's gradient is taken, as the JAX step differentiates the
generator alone.

torch.optim.AdamW(lr, betas=(0.8, 0.99), eps=1e-8, weight_decay=0.01) is
optax's adamw with the same numbers: the decay is taken from the
pre-update weight and eps sits outside the square root. One optimizer
serves the generator, one the MPD and the MSD together; the spectral-norm
u / v_pow are buffers, so neither sees them (the JAX step's
_merge_sn_buffers).

Data parallelism (mesh=, parallel/mesh.py): the JAX step shards the batch
over the mesh's 'data' axis and XLA all-reduces the gradients. Here each
grid row's first device holds a replica of G, MPD and MSD and takes its
shard of the batch; the master modules (the TrainState's, on the mesh's
first device) are row 0's replica. Each phase (D, then G) starts by copying
the master's parameters and buffers to the replicas, so the G phase sees the
updated discriminators; each shard's loss, weighted by its share of the
batch, is backpropagated on its replica; the gradients are summed onto the
master, which alone steps its optimizer. The power iteration runs once, on
the master. When torch.distributed is initialized
(parallel/mesh.initialize_distributed), the summed gradients and the metrics
are then averaged over the processes by one all-reduce each, as DDP does:
each process feeds its own part of the global batch. With one shard and no
process group this is the one-device step.

compute_dtype=torch.bfloat16 is the JAX step's bf16 mode as a cast, not
autocast's per-op policy: each module runs on a bf16 copy of its
parameters and buffers (torch.func.functional_call), the batch except f0
and the mel target is cast to bf16, and the gradients reach the fp32
master weights through the cast; the optimizer state stays fp32.
"""

from __future__ import annotations

import copy
import dataclasses
import itertools

import torch
import torch.nn as nn
from torch.func import functional_call
from torch.profiler import record_function

from knnsvc_torch.config import HiFiGANConfig, ModelFamily
from knnsvc_torch.dsp.stft import log_mel_spectrogram
from knnsvc_torch.models.hifigan.discriminator import power_iterate
from knnsvc_torch.models.hifigan.losses import discriminator_loss, feature_loss, generator_loss

MEL_LOSS_WEIGHT = 45.0  # ref ddsp_train.py:240
VALID_BUCKET_FRAMES = 128  # ~2.5 s granularity at hop 320


@dataclasses.dataclass
class TrainState:
    """The generator (its weight norms live), the two discriminators, their
    optimizers and the global step count."""

    generator: nn.Module
    mpd: nn.Module
    msd: nn.Module
    opt_g: torch.optim.Optimizer
    opt_d: torch.optim.Optimizer
    family: ModelFamily
    steps: int = 0


def make_optimizers(h: HiFiGANConfig, generator: nn.Module, mpd: nn.Module, msd: nn.Module):
    """AdamW with torch's default weight decay 0.01 (ref ddsp_train.py:141-150):
    (generator optimizer, optimizer of the MPD and the MSD together)."""
    kw = dict(lr=h.learning_rate, betas=(h.adam_b1, h.adam_b2), eps=1e-8, weight_decay=0.01)
    return (torch.optim.AdamW(generator.parameters(), **kw),
            torch.optim.AdamW(itertools.chain(mpd.parameters(), msd.parameters()), **kw))


def set_learning_rate(optimizer: torch.optim.Optimizer, lr: float) -> None:
    for group in optimizer.param_groups:
        group["lr"] = lr


def init_train_state(seed: int, h: HiFiGANConfig, family: ModelFamily,
                     disc_width_scale: int = 1, disc_periods: int | None = None,
                     disc_scales: int | None = None,
                     device: str | torch.device = "cuda") -> TrainState:
    """Random generator (live weight norm), MPD and MSD, drawn on the CPU
    from one torch.Generator seeded with `seed`, so every device gets the
    same weights."""
    from knnsvc_torch.hub import resolve_device
    from knnsvc_torch.io.jax_params import train_state_from_numpy
    from knnsvc_torch.models.hifigan.discriminator import init_mpd_params, init_msd_params
    from knnsvc_torch.models.hifigan.generator import init_generator_params

    dev = resolve_device(device)
    gen = torch.Generator().manual_seed(seed)
    g = init_generator_params(h, family, gen, weight_norm_parametrized=True)
    mpd = init_mpd_params(gen, width_scale=disc_width_scale, n_periods=disc_periods)
    msd = init_msd_params(gen, width_scale=disc_width_scale, n_scales=disc_scales)
    return train_state_from_numpy(g, mpd, msd, h, family, dev)


def _call(module: nn.Module, dtype: torch.dtype | None, *args):
    """module(*args), on a `dtype` copy of its parameters and buffers when
    dtype is given (the gradient flows back through the cast)."""
    if dtype is None:
        return module(*args)
    tensors = {n: t.to(dtype) if t.is_floating_point() else t
               for n, t in itertools.chain(module.named_parameters(), module.named_buffers())}
    return functional_call(module, tensors, args)


def _generator_forward(generator: nn.Module, family: ModelFamily, batch: dict,
                       dtype: torch.dtype | None = None) -> torch.Tensor:
    """-> y_hat (B, 1, T_samples)."""
    harmonics = batch["harmonics"] if family == ModelFamily.MIX else None
    return _call(generator, dtype, batch["feats"], batch["f0"], harmonics)[:, None, :]


def _mel(h: HiFiGANConfig, wav: torch.Tensor) -> torch.Tensor:
    return log_mel_spectrogram(wav, n_fft=h.n_fft, num_mels=h.num_mels,
                               sampling_rate=h.sampling_rate, hop_size=h.hop_size,
                               win_size=h.win_size, fmin=h.fmin, fmax=h.fmax)


def _d_loss(mpd: nn.Module, msd: nn.Module, y: torch.Tensor, y_hat: torch.Tensor,
            dtype: torch.dtype | None) -> torch.Tensor:
    y_df_r, y_df_g, _, _ = _call(mpd, dtype, y, y_hat)
    loss_f = discriminator_loss(y_df_r, y_df_g)[0]
    y_ds_r, y_ds_g, _, _ = _call(msd, dtype, y, y_hat)
    loss_s = discriminator_loss(y_ds_r, y_ds_g)[0]
    return (loss_f + loss_s).float()


def _g_loss(h: HiFiGANConfig, family: ModelFamily, G: nn.Module, mpd: nn.Module, msd: nn.Module,
            batch: dict, y: torch.Tensor, dtype: torch.dtype | None):
    """-> (G total loss, the mel L1 times MEL_LOSS_WEIGHT)."""
    y_hat = _generator_forward(G, family, batch, dtype)
    # the mel loss in fp32 at least (a bf16 step's y_hat is promoted; a
    # float64 one stays float64)
    wav = y_hat[:, 0, :]
    y_hat_mel = _mel(h, wav if wav.dtype == torch.float64 else wav.float())
    loss_mel = torch.mean(torch.abs(batch["mel_loss"] - y_hat_mel)) * MEL_LOSS_WEIGHT
    _, y_df_g, fmap_f_r, fmap_f_g = _call(mpd, dtype, y, y_hat)
    _, y_ds_g, fmap_s_r, fmap_s_g = _call(msd, dtype, y, y_hat)
    loss_fm = feature_loss(fmap_f_r, fmap_f_g) + feature_loss(fmap_s_r, fmap_s_g)
    loss_gen_f = generator_loss(y_df_g)[0]
    loss_gen_s = generator_loss(y_ds_g)[0]
    return (loss_gen_f + loss_gen_s + loss_fm).float() + loss_mel, loss_mel


class _Replicas:
    """One (G, MPD, MSD) per grid row of the mesh on that row's device, row
    0 the TrainState's own modules (the master); rebuilt when the step is
    given another TrainState."""

    def __init__(self, state: TrainState, devices: list[torch.device]):
        self.state = state
        masters = (state.generator, state.mpd, state.msd)
        self.rows = [masters] + [tuple(copy.deepcopy(m).to(d) for m in masters)
                                 for d in devices[1:]]

    @torch.no_grad()
    def sync(self, which: slice) -> None:
        """Copy the master's parameters and buffers of modules[which] (of
        G, MPD, MSD) to every other row."""
        for row in self.rows[1:]:
            for master, rep in zip(self.rows[0][which], row[which]):
                for a, b in zip(itertools.chain(master.parameters(), master.buffers()),
                                itertools.chain(rep.parameters(), rep.buffers())):
                    b.copy_(a)

    def reduce_grads(self, which: slice) -> None:
        """Sum the gradients of modules[which] over the rows onto the
        master's (each row's loss is already weighted by its share of the
        batch); under torch.distributed, then average them over the
        processes in one all-reduce."""
        params = [p for m in self.rows[0][which] for p in m.parameters()]
        for row in self.rows[1:]:
            for p, r in zip(params, (r for m in row[which] for r in m.parameters())):
                if r.grad is not None:
                    g = r.grad.to(p.device)
                    p.grad = g if p.grad is None else p.grad.add_(g)
                    r.grad = None
        if distributed():
            grads = _all_reduce_mean([torch.zeros_like(p) if p.grad is None else p.grad
                                      for p in params])
            for p, g in zip(params, grads):
                p.grad = g


def distributed() -> bool:
    """Whether a torch.distributed process group is up."""
    return torch.distributed.is_available() and torch.distributed.is_initialized()


def _all_reduce_mean(tensors: list[torch.Tensor]) -> list[torch.Tensor]:
    """The tensors averaged over the processes, by one all-reduce of their
    concatenation."""
    from torch._utils import _flatten_dense_tensors, _unflatten_dense_tensors

    flat = _flatten_dense_tensors(tensors)
    torch.distributed.all_reduce(flat)
    flat.div_(torch.distributed.get_world_size())
    return list(_unflatten_dense_tensors(flat, tensors))


def make_train_step(h: HiFiGANConfig, family: ModelFamily,
                    compute_dtype: torch.dtype | None = None, mesh=None):
    """-> train_step(state, batch) -> metrics. batch: tensors on the state's
    device, feats (B, T, 1024), audio (B, T*hop), mel_loss (B, mels, T'),
    f0 (B, T, 1), harmonics (B, T, 49). The step updates `state` in place
    and returns 0-d tensors (no host sync): loss_gen_total, loss_disc_total,
    mel_spec_error. mesh: a parallel.mesh.Mesh whose 'data' axis shards the
    batch (B divisible by its size), the state on mesh.first; None runs on
    the state's device alone. Under torch.distributed, `batch` is this
    process's part of the global batch and the metrics are the global
    batch's."""
    from knnsvc_torch.parallel.mesh import data_sharding

    sharding = None if mesh is None or mesh.shape["data"] == 1 else data_sharding(mesh)
    cache: dict[str, _Replicas] = {}

    def train_step(state: TrainState, batch: dict) -> dict[str, torch.Tensor]:
        reps = cache.get("reps")
        if reps is None or reps.state is not state:
            reps = cache["reps"] = _Replicas(state, [] if sharding is None else sharding.devices)
        dev = next(state.generator.parameters()).device
        with record_function("knnsvc.train_step"):
            if compute_dtype is not None:
                # the loss target and f0 stay fp32: bf16 would put Hz on a
                # ~0.4% grid, a systematic pitch error in the excitation
                batch = {k: v if k in ("mel_loss", "f0") else v.to(compute_dtype)
                         for k, v in batch.items()}
            if sharding is None:
                shards = [batch]
            else:
                parts = {k: sharding.put(v) for k, v in batch.items()}
                shards = [{k: v[i] for k, v in parts.items()} for i in range(len(reps.rows))]
            # each shard's loss weighted by its share of the batch (a mean
            # over the batch is the weighted sum of the shards' means)
            n = batch["audio"].shape[0]
            weights = [None] if sharding is None else [s["audio"].shape[0] / n for s in shards]
            work = list(zip(reps.rows, shards, weights))
            weighted = lambda loss, w: loss if w is None else loss * w  # noqa: E731
            spread = len(reps.rows) > 1 or distributed()

            with record_function("knnsvc.d_step"):
                power_iterate(state.msd, compute_dtype)
                reps.sync(slice(0, 3))
                state.opt_d.zero_grad(set_to_none=True)
                d_losses = []
                for (G, mpd, msd), s, w in work:
                    with torch.no_grad():
                        y_hat = _generator_forward(G, family, s, compute_dtype)
                    d = weighted(_d_loss(mpd, msd, s["audio"][:, None, :], y_hat,
                                         compute_dtype), w)
                    d.backward()
                    d_losses.append(d.detach().to(dev))
                if spread:
                    reps.reduce_grads(slice(1, 3))
                state.opt_d.step()

            with record_function("knnsvc.g_step"):
                reps.sync(slice(1, 3))
                d_params = [p for row in reps.rows for m in row[1:] for p in m.parameters()]
                for p in d_params:
                    p.requires_grad_(False)
                try:
                    state.opt_g.zero_grad(set_to_none=True)
                    g_losses, mel_losses = [], []
                    for (G, mpd, msd), s, w in work:
                        g, mel = _g_loss(h, family, G, mpd, msd, s, s["audio"][:, None, :],
                                         compute_dtype)
                        g = weighted(g, w)
                        g.backward()
                        g_losses.append(g.detach().to(dev))
                        mel_losses.append(weighted(mel.detach(), w).to(dev))
                    if spread:
                        reps.reduce_grads(slice(0, 1))
                    state.opt_g.step()
                finally:
                    for p in d_params:
                        p.requires_grad_(True)
            state.steps += 1
            metrics = [sum(g_losses[1:], g_losses[0]), sum(d_losses[1:], d_losses[0]),
                       sum(mel_losses[1:], mel_losses[0]) / MEL_LOSS_WEIGHT]
            if distributed():
                metrics = _all_reduce_mean(metrics)
        return dict(zip(("loss_gen_total", "loss_disc_total", "mel_spec_error"), metrics))

    return train_step


@torch.no_grad()
def eval_step(generator: nn.Module, h: HiFiGANConfig, family: ModelFamily, batch: dict):
    """Validation mel error on a full utterance (ref ddsp_train.py:288-337).
    Returns (mel_err, y_hat (B, 1, T_samples))."""
    y_hat = _generator_forward(generator, family, batch)
    y_hat_mel = _mel(h, y_hat[:, 0, :])
    mel = batch["mel_loss"]
    # the generated mel can be one frame short of the reference's (the pad
    # fixup, ref :305-311): compare the overlap
    t = min(mel.shape[-1], y_hat_mel.shape[-1])
    return torch.mean(torch.abs(mel[..., :t] - y_hat_mel[..., :t])), y_hat


def eval_bucket(n_frames: int, bucket: int = VALID_BUCKET_FRAMES) -> int:
    return max(bucket, ((n_frames + bucket - 1) // bucket) * bucket)


@torch.no_grad()
def eval_step_padded(generator: nn.Module, h: HiFiGANConfig, family: ModelFamily,
                     batch: dict, true_mel_frames: int):
    """eval_step on an utterance zero-padded to a frame bucket, the mel
    error masked to the first `true_mel_frames` frames (the JAX package
    pads so it compiles once per bucket; the port keeps its shapes so the
    numbers agree). Returns (mel_err, y_hat over the padded length)."""
    y_hat = _generator_forward(generator, family, batch)
    y_hat_mel = _mel(h, y_hat[:, 0, :])
    mel = batch["mel_loss"]
    t = min(mel.shape[-1], y_hat_mel.shape[-1])
    mask = (torch.arange(t, device=mel.device) < true_mel_frames).to(mel.dtype)
    diff = torch.abs(mel[..., :t] - y_hat_mel[..., :t]) * mask
    denom = torch.clamp(mask.sum(), min=1.0) * mel.shape[0] * mel.shape[1]
    return diff.sum() / denom, y_hat
