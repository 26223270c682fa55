"""Vocoder GAN trainer (counterpart of knnsvc_tpu/train/trainer.py).

Reference recipe (hifigan/ddsp_train.py): AdamW(lr 2e-4, betas (0.8, 0.99)),
per-epoch ExponentialLR decay 0.999, a D step (MPD + MSD, LSGAN) then a G
step (adv + feature matching + 45 * L1 log-mel), batch 16, segment 7040
samples.

The JAX package runs this as one jitted step over a device mesh; here it is
that step on one device, in the same order:
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

compute_dtype=torch.bfloat16 is the JAX step's bf16 mode as a cast, not
autocast's per-op policy: each module runs on a bf16 copy of its
parameters and buffers (torch.func.functional_call), the batch except f0
and the mel target is cast to bf16, and the gradients reach the fp32
master weights through the cast; the optimizer state stays fp32.
"""

from __future__ import annotations

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


def make_train_step(h: HiFiGANConfig, family: ModelFamily,
                    compute_dtype: torch.dtype | None = None):
    """-> train_step(state, batch) -> metrics. batch: tensors on the state's
    device, feats (B, T, 1024), audio (B, T*hop), mel_loss (B, mels, T'),
    f0 (B, T, 1), harmonics (B, T, 49). The step updates `state` in place
    and returns 0-d tensors (no host sync): loss_gen_total, loss_disc_total,
    mel_spec_error."""

    def train_step(state: TrainState, batch: dict) -> dict[str, torch.Tensor]:
        G, mpd, msd = state.generator, state.mpd, state.msd
        with record_function("knnsvc.train_step"):
            if compute_dtype is not None:
                # the loss target and f0 stay fp32: bf16 would put Hz on a
                # ~0.4% grid, a systematic pitch error in the excitation
                batch = {k: v if k in ("mel_loss", "f0") else v.to(compute_dtype)
                         for k, v in batch.items()}
            y = batch["audio"][:, None, :]

            with record_function("knnsvc.d_step"):
                with torch.no_grad():
                    y_hat = _generator_forward(G, family, batch, compute_dtype)
                power_iterate(msd, compute_dtype)
                y_df_r, y_df_g, _, _ = _call(mpd, compute_dtype, y, y_hat)
                loss_f = discriminator_loss(y_df_r, y_df_g)[0]
                y_ds_r, y_ds_g, _, _ = _call(msd, compute_dtype, y, y_hat)
                loss_s = discriminator_loss(y_ds_r, y_ds_g)[0]
                d_total = (loss_f + loss_s).float()
                state.opt_d.zero_grad(set_to_none=True)
                d_total.backward()
                state.opt_d.step()

            with record_function("knnsvc.g_step"):
                d_params = [*mpd.parameters(), *msd.parameters()]
                for p in d_params:
                    p.requires_grad_(False)
                try:
                    y_hat = _generator_forward(G, family, batch, compute_dtype)
                    y_hat_mel = _mel(h, y_hat[:, 0, :].float())
                    loss_mel = torch.mean(torch.abs(batch["mel_loss"] - y_hat_mel)) * MEL_LOSS_WEIGHT
                    _, y_df_g, fmap_f_r, fmap_f_g = _call(mpd, compute_dtype, y, y_hat)
                    _, y_ds_g, fmap_s_r, fmap_s_g = _call(msd, compute_dtype, y, y_hat)
                    loss_fm = feature_loss(fmap_f_r, fmap_f_g) + feature_loss(fmap_s_r, fmap_s_g)
                    loss_gen_f = generator_loss(y_df_g)[0]
                    loss_gen_s = generator_loss(y_ds_g)[0]
                    g_total = (loss_gen_f + loss_gen_s + loss_fm).float() + loss_mel
                    state.opt_g.zero_grad(set_to_none=True)
                    g_total.backward()
                    state.opt_g.step()
                finally:
                    for p in d_params:
                        p.requires_grad_(True)
            state.steps += 1
        return {"loss_gen_total": g_total.detach(), "loss_disc_total": d_total.detach(),
                "mel_spec_error": loss_mel.detach() / MEL_LOSS_WEIGHT}

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
