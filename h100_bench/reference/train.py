"""The plain reference of the vocoder's training step (ref hifigan/
ddsp_train.py, the port's knnsvc_torch/train/trainer.py `make_train_step`
on one device), written functionally over the parameter trees:

- each leaf of the generator, MPD and MSD trees is a tensor; a weight norm
  {"g", "v"} is folded to g v / ||v|| and a spectral norm {"v_sn", "u",
  "v_pow"} divides by u . (W v_pow) inside every forward, so autograd
  reaches the leaves themselves;
- the D step: one power-iteration step of the spectral norms, y_hat from
  the generator without gradient, the LSGAN loss of the MPD and the MSD on
  y and y_hat, its gradient, AdamW;
- the G step against the updated discriminators: adversarial + 2 x
  feature matching + 45 x L1 of the log-mel of y_hat, the gradient in the
  generator's leaves alone, AdamW;
- AdamW as torch.optim.AdamW computes it (decoupled decay 0.01 from the
  pre-update weight, eps outside the square root), written out per leaf.
Nothing here imports the port.
"""

from __future__ import annotations

import torch
from torch.func import functional_call

from .config import HiFiGANConfig, model_family_for_ckpt_type
from .discriminator import (MultiPeriodDiscriminator, MultiScaleDiscriminator,
                            discriminator_loss, feature_loss, generator_loss)
from .generator import Synthesizer
from .stft import log_mel_spectrogram

MEL_LOSS_WEIGHT = 45.0
WEIGHT_DECAY = 0.01
EPS = 1e-8


def flatten(tree, prefix: str = "") -> dict:
    """Pytree -> {dotted path: array}."""
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(flatten(v, f"{prefix}{k}."))
        return out
    if isinstance(tree, (list, tuple)):
        out = {}
        for i, v in enumerate(tree):
            out.update(flatten(v, f"{prefix}{i}."))
        return out
    return {prefix[:-1]: tree}


def effective_weights(leaves: dict[str, torch.Tensor]) -> dict[str, torch.Tensor]:
    """Leaves -> the modules' state-dict entries: folded weight norms,
    spectral norms applied, a Linear's (in, out) `w` transposed."""
    out = {}
    for path, t in leaves.items():
        base, leaf = path.rsplit(".", 1)
        if leaf == "v":
            g = leaves[f"{base}.g"]
            norm = torch.sqrt(torch.sum(t * t, dim=tuple(range(1, t.dim())), keepdim=True))
            out[f"{base}.weight"] = g * t / norm
        elif leaf == "v_sn":
            w_mat = t.reshape(t.shape[0], -1)
            sigma = torch.dot(leaves[f"{base}.u"], torch.mv(w_mat, leaves[f"{base}.v_pow"]))
            out[f"{base}.weight"] = t / sigma
        elif leaf == "w":
            out[f"{base}.weight"] = t.T if t.dim() == 2 else t
        elif leaf == "b":
            out[f"{base}.bias"] = t
    return out


@torch.no_grad()
def power_iterate(leaves: dict[str, torch.Tensor]) -> None:
    """One power-iteration step of every spectral norm (eps 1e-12)."""
    for path, t in leaves.items():
        base, leaf = path.rsplit(".", 1)
        if leaf != "v_sn":
            continue
        w = t.reshape(t.shape[0], -1)
        v = torch.mv(w.T, leaves[f"{base}.u"])
        v = v / (torch.linalg.vector_norm(v) + 1e-12)
        u = torch.mv(w, v)
        u = u / (torch.linalg.vector_norm(u) + 1e-12)
        leaves[f"{base}.u"].copy_(u)
        leaves[f"{base}.v_pow"].copy_(v)


def trainable(path: str) -> bool:
    return path.rsplit(".", 1)[1] not in ("u", "v_pow")


class Reference:
    """The training state as leaves and the modules they are called with."""

    def __init__(self, g_tree, mpd_tree, msd_tree, h: HiFiGANConfig, ckpt_type: str, device,
                 disc_width_scale: int = 1):
        self.h = h
        self.family = model_family_for_ckpt_type(ckpt_type)
        with torch.device("meta"):
            self.G = Synthesizer(h, self.family)
            self.mpd = MultiPeriodDiscriminator(disc_width_scale)
            self.msd = MultiScaleDiscriminator(disc_width_scale)
        self.leaves = {}
        for prefix, tree in (("g", g_tree), ("mpd", mpd_tree), ("msd", msd_tree)):
            for path, a in flatten(tree).items():
                t = torch.tensor(a, dtype=torch.float32, device=device)
                self.leaves[f"{prefix}.{path}"] = t.requires_grad_(trainable(path))
        self.moments = {p: (torch.zeros_like(t), torch.zeros_like(t))
                        for p, t in self.leaves.items() if trainable(p)}
        self.steps = 0

    def _part(self, prefix: str) -> dict[str, torch.Tensor]:
        n = len(prefix) + 1
        return {p[n:]: t for p, t in self.leaves.items() if p.startswith(prefix + ".")}

    def generator(self, batch: dict) -> torch.Tensor:
        harm = batch["harmonics"] if self.family.value == "mix" else None
        wav = functional_call(self.G, effective_weights(self._part("g")),
                              (batch["feats"], batch["f0"], harm))
        return wav[:, None, :]

    def discriminators(self, y, y_hat):
        mpd = functional_call(self.mpd, effective_weights(self._part("mpd")), (y, y_hat))
        msd = functional_call(self.msd, effective_weights(self._part("msd")), (y, y_hat))
        return mpd, msd

    def _adamw(self, grads: dict[str, torch.Tensor]) -> None:
        h = self.h
        b1, b2, lr = h.adam_b1, h.adam_b2, h.learning_rate
        t = self.steps + 1
        with torch.no_grad():
            for p, g in grads.items():
                theta = self.leaves[p]
                m, v = self.moments[p]
                theta.mul_(1 - lr * WEIGHT_DECAY)
                m.mul_(b1).add_(g, alpha=1 - b1)
                v.mul_(b2).addcmul_(g, g, value=1 - b2)
                denom = (v.sqrt() / (1 - b2 ** t) ** 0.5).add_(EPS)
                theta.addcdiv_(m, denom, value=-lr / (1 - b1 ** t))

    def step(self, batch: dict) -> dict:
        """One D step then one G step -> {loss_gen_total, loss_disc_total,
        grads: {leaf: gradient as the optimizer got it}}."""
        y = batch["audio"][:, None, :]
        power_iterate(self.leaves)
        with torch.no_grad():
            y_hat = self.generator(batch)
        (mpd_r, mpd_g, _, _), (msd_r, msd_g, _, _) = self.discriminators(y, y_hat)
        loss_d = discriminator_loss(mpd_r, mpd_g)[0] + discriminator_loss(msd_r, msd_g)[0]
        d_params = {p: t for p, t in self.leaves.items()
                    if p.startswith(("mpd.", "msd.")) and trainable(p)}
        d_grads = dict(zip(d_params, torch.autograd.grad(loss_d, list(d_params.values()))))
        self._adamw(d_grads)

        y_hat = self.generator(batch)
        mel = log_mel_spectrogram(y_hat[:, 0, :], n_fft=self.h.n_fft, num_mels=self.h.num_mels,
                                  sampling_rate=self.h.sampling_rate, hop_size=self.h.hop_size,
                                  win_size=self.h.win_size, fmin=self.h.fmin, fmax=self.h.fmax)
        loss_mel = torch.mean(torch.abs(batch["mel_loss"] - mel)) * MEL_LOSS_WEIGHT
        # the gradient is taken in the generator's leaves alone
        (_, mpd_g, fm_r, fm_g), (_, msd_g, fs_r, fs_g) = self.discriminators(y, y_hat)
        loss_g = (generator_loss(mpd_g)[0] + generator_loss(msd_g)[0]
                  + feature_loss(fm_r, fm_g) + feature_loss(fs_r, fs_g) + loss_mel)
        g_params = {p: t for p, t in self.leaves.items() if p.startswith("g.")}
        g_grads = dict(zip(g_params, torch.autograd.grad(loss_g, list(g_params.values()))))
        self._adamw(g_grads)
        self.steps += 1
        return {"loss_gen_total": float(loss_g.detach()), "loss_disc_total": float(loss_d.detach()),
                "grads": {**d_grads, **g_grads}}
