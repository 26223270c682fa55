"""knnsvc_torch's training modules on the CPU against the JAX package, on the
same seeded numpy inputs and carried-across weights: the log-mel and its
filterbank (atol 1e-5), the three GAN losses (1e-6), the MPD and MSD
outputs and feature maps (1e-5) and the spectral-norm u / v_pow after one
power-iteration pass (1e-6), the live weight norm of the generator's
training form, smoothness with amp_ratio (and bit for bit unchanged without
it), and KnnSvc.mel_vocode (the waveform tolerance 2e-4)."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from knnsvc_tpu.dsp.stft import log_mel_spectrogram as jax_log_mel
from knnsvc_tpu.dsp.stft import mel_filterbank as jax_filterbank
from knnsvc_tpu.models.hifigan import (discriminator_loss as jax_d_loss,
                                       feature_loss as jax_fm_loss,
                                       generator_loss as jax_g_loss, mpd_apply, msd_apply)
from knnsvc_tpu.match.smoothness import optimize_smoothness_weights as jax_optimize
from knnsvc_torch.dsp.stft import log_mel_spectrogram, mel_filterbank
from knnsvc_torch.io.jax_params import (discriminators_from_numpy, generator_from_numpy,
                                        generator_train_from_numpy, tree_from_module)
from knnsvc_torch.match.smoothness import HARMONICS_LOSS_SCALE, optimize_smoothness_weights
from knnsvc_torch.models.hifigan.discriminator import (init_mpd_params, init_msd_params,
                                                       power_iterate)
from knnsvc_torch.models.hifigan.generator import init_generator_params
from knnsvc_torch.models.hifigan.losses import (discriminator_loss, feature_loss,
                                                generator_loss)

from test_torch_common import DISC_WIDTH_SCALE, TINY_H, small_generator, small_wavlm
from test_torch_common import one_torch_thread  # noqa: F401  (autouse)

WAV_ATOL = 2e-4  # COMPONENTS.md §2.3


@pytest.mark.parametrize("args", [(16000, 1024, 80, 0.0, 8000.0), (22050, 512, 40, 50.0, 9000.0)])
def test_mel_filterbank_matches_jax(args):
    np.testing.assert_allclose(mel_filterbank(*args), jax_filterbank(*args), atol=1e-5)


@pytest.mark.parametrize("shape", [(2, 7040), (3, 1280)])
def test_log_mel_matches_jax(shape):
    rng = np.random.default_rng(sum(shape))
    t = np.arange(shape[-1]) / 16000
    wav = (0.3 * np.sin(2 * np.pi * 220 * t) + 0.05 * rng.standard_normal(shape)).astype(np.float32)
    want = np.asarray(jax_log_mel(jnp.asarray(wav)))
    got = log_mel_spectrogram(torch.from_numpy(wav)).numpy()
    assert got.shape == want.shape == shape[:-1] + (80, (shape[-1] + 704 - 1024) // 320 + 1)
    np.testing.assert_allclose(got, want, atol=1e-5)


def test_losses_match_jax():
    rng = np.random.default_rng(3)
    outs = [[rng.standard_normal((2, n)).astype(np.float32) for n in (7, 11, 13)] for _ in range(2)]
    fmaps = [[[rng.standard_normal((2, 4, n)).astype(np.float32) for n in (5, 9)]
              for _ in range(3)] for _ in range(2)]
    t = lambda tree: [torch.from_numpy(a) if isinstance(a, np.ndarray) else t(a) for a in tree]
    j = lambda tree: [jnp.asarray(a) if isinstance(a, np.ndarray) else j(a) for a in tree]
    np.testing.assert_allclose(float(feature_loss(t(fmaps[0]), t(fmaps[1]))),
                               float(jax_fm_loss(j(fmaps[0]), j(fmaps[1]))), atol=1e-6)
    got, got_r, got_g = discriminator_loss(t(outs[0]), t(outs[1]))
    want, want_r, want_g = jax_d_loss(j(outs[0]), j(outs[1]))
    np.testing.assert_allclose(float(got), float(want), atol=1e-6)
    np.testing.assert_allclose([float(x) for x in got_r + got_g],
                               [float(x) for x in want_r + want_g], atol=1e-6)
    got, got_each = generator_loss(t(outs[1]))
    want, want_each = jax_g_loss(j(outs[1]))
    np.testing.assert_allclose(float(got), float(want), atol=1e-6)
    np.testing.assert_allclose([float(x) for x in got_each], [float(x) for x in want_each],
                               atol=1e-6)


def _assert_outputs_close(got, want, atol):
    for g_list, w_list in zip(got, want):          # y_d_rs, y_d_gs, fmap_rs, fmap_gs
        assert len(g_list) == len(w_list)
        for g, w in zip(g_list, w_list):
            if isinstance(g, list):
                for gg, ww in zip(g, w):
                    np.testing.assert_allclose(gg.detach().numpy(), np.asarray(ww), atol=atol)
            else:
                np.testing.assert_allclose(g.detach().numpy(), np.asarray(w), atol=atol)


def _settle_spectral_norm(msd_p, steps=20):
    """Power-iterate the init's random u / v_pow in float64 (as a trained
    layer's have settled), so sigma is the weight's top singular value and
    the outputs are O(1) rather than scaled by 1 / (u^T W v) of random
    vectors."""
    for conv in msd_p["discriminators"][0]["convs"] + [msd_p["discriminators"][0]["conv_post"]]:
        w = conv["v_sn"].reshape(len(conv["v_sn"]), -1).astype(np.float64)
        u = conv["u"].astype(np.float64)
        for _ in range(steps):
            v = w.T @ u
            v /= np.linalg.norm(v)
            u = w @ v
            u /= np.linalg.norm(u)
        conv["u"], conv["v_pow"] = u.astype(np.float32), v.astype(np.float32)
    return msd_p


def test_discriminators_match_jax():
    # the port's init draws the trees (JAX's eager init compiles an op per
    # conv shape); both packages apply the same numpy trees
    gen = torch.Generator().manual_seed(1)
    mpd_p = init_mpd_params(gen, width_scale=DISC_WIDTH_SCALE)
    msd_p = _settle_spectral_norm(init_msd_params(gen, width_scale=DISC_WIDTH_SCALE))
    rng = np.random.default_rng(4)
    y, y_hat = ((rng.standard_normal((2, 1, 1283)) * 0.3).astype(np.float32) for _ in range(2))
    mpd, msd = discriminators_from_numpy(mpd_p, msd_p)
    ty, ty_hat = torch.from_numpy(y), torch.from_numpy(y_hat)
    jy, jy_hat = jnp.asarray(y), jnp.asarray(y_hat)

    jit_msd = jax.jit(msd_apply, static_argnames="update_sn")   # one compile, not one per op
    _assert_outputs_close(mpd(ty, ty_hat), jax.jit(mpd_apply)(mpd_p, jy, jy_hat), 1e-5)
    _assert_outputs_close(msd(ty, ty_hat), jit_msd(msd_p, jy, jy_hat)[:4], 1e-5)

    # the D pass: one power-iteration step, then both inputs on the new u / v
    *want, msd_new = jit_msd(msd_p, jy, jy_hat, update_sn=True)
    power_iterate(msd)
    _assert_outputs_close(msd(ty, ty_hat), want, 1e-5)
    got_tree = tree_from_module(msd)
    for got_c, want_c in zip(got_tree["discriminators"][0]["convs"] + [
            got_tree["discriminators"][0]["conv_post"]],
            msd_new["discriminators"][0]["convs"] + [msd_new["discriminators"][0]["conv_post"]]):
        for key in ("u", "v_pow"):
            np.testing.assert_allclose(got_c[key], np.asarray(want_c[key]), atol=1e-6)
    # buffers, not parameters: no optimizer sees them
    assert not any(n.endswith((".u", ".v_pow")) for n, _ in msd.named_parameters())


def test_generator_training_form():
    """Live weight norm: g = ||v|| per first-axis row (ConvTranspose1d's
    (in, out, k) weight gets g of shape (in, 1, 1)), the training form
    computes the folded form's waveform, and its tree round-trips."""
    from knnsvc_torch.config import HiFiGANConfig, ModelFamily

    h = HiFiGANConfig.from_dict(TINY_H)
    live = init_generator_params(h, ModelFamily.MIX, torch.Generator().manual_seed(0),
                                 weight_norm_parametrized=True)
    folded = init_generator_params(h, ModelFamily.MIX, torch.Generator().manual_seed(0))
    up = live["dec"]["ups"][0]
    assert up["g"].shape == (up["v"].shape[0], 1, 1)
    np.testing.assert_allclose(up["g"][:, 0, 0], np.linalg.norm(up["v"].reshape(len(up["v"]), -1),
                                                               axis=1), rtol=1e-6)
    np.testing.assert_array_equal(up["v"], folded["dec"]["ups"][0]["w"])
    assert "w" in live["dec"]["concat_pre"] and "g" in live["dec"]["resblocks"][0]["convs1"][0]

    train_g = generator_train_from_numpy(live, h, ModelFamily.MIX)
    serve_g = generator_from_numpy(live, h, ModelFamily.MIX)
    rng = np.random.default_rng(5)
    feats = torch.from_numpy(rng.standard_normal((1, 6, 16)).astype(np.float32))
    f0 = torch.full((1, 6, 1), 180.0)
    harm = torch.from_numpy((rng.random((1, 6, 49)) * 0.05).astype(np.float32))
    with torch.no_grad():
        np.testing.assert_allclose(train_g(feats, f0, harm).numpy(),
                                   serve_g(feats, f0, harm).numpy(), atol=1e-6)
    back = tree_from_module(train_g)
    for a, b in zip(jax.tree.leaves(back), jax.tree.leaves(live)):
        np.testing.assert_array_equal(a, b)


def _amp_problem(T=30, P=90, D=49, seed=6):
    rng = np.random.default_rng(seed)
    pool = (rng.random((P, D)) * 0.05).astype(np.float32)
    idx = rng.integers(0, P, (T, 4)).astype(np.int32)
    amp = (0.5 + rng.random((T, 4))).astype(np.float32)
    return idx, pool, amp


def test_smoothness_amp_ratio_matches_jax():
    idx, pool, amp = _amp_problem()
    want, want_steps = jax_optimize(jnp.asarray(idx), jnp.asarray(pool), scale=HARMONICS_LOSS_SCALE,
                                    amp_ratio=jnp.asarray(amp), max_steps=50, return_steps=True)
    got, steps = optimize_smoothness_weights(
        torch.from_numpy(idx), torch.from_numpy(pool), scale=HARMONICS_LOSS_SCALE,
        amp_ratio=torch.from_numpy(amp), max_steps=50, return_steps=True)
    assert steps == int(want_steps) == 50
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5)
    want, want_steps = jax_optimize(jnp.asarray(idx), jnp.asarray(pool), scale=HARMONICS_LOSS_SCALE,
                                    amp_ratio=jnp.asarray(amp), return_steps=True)
    got, steps = optimize_smoothness_weights(
        torch.from_numpy(idx), torch.from_numpy(pool), scale=HARMONICS_LOSS_SCALE,
        amp_ratio=torch.from_numpy(amp), return_steps=True)
    assert steps == int(want_steps)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=3e-3)


def test_smoothness_without_amp_ratio_unchanged():
    """amp_ratio=None takes the unscaled rows: bit for bit what a ratio of
    ones gives (x * 1.0 == x), the results of the optimizer before it."""
    idx, pool, _ = _amp_problem(seed=7)
    ti, tp = torch.from_numpy(idx), torch.from_numpy(pool)
    plain, s1 = optimize_smoothness_weights(ti, tp, scale=HARMONICS_LOSS_SCALE, return_steps=True)
    ones, s2 = optimize_smoothness_weights(ti, tp, scale=HARMONICS_LOSS_SCALE,
                                           amp_ratio=torch.ones(idx.shape), return_steps=True)
    assert s1 == s2 and torch.equal(plain, ones)


def test_mel_vocode_matches_jax():
    from knnsvc_tpu.hub import KnnSvc as JaxKnnSvc
    from knnsvc_torch.hub import KnnSvc

    cfg, jcfg, wparams = small_wavlm()
    h, jh, _, _, params = small_generator("wavlm_only", overrides={"hubert_dim": 80})
    rng = np.random.default_rng(8)
    t = np.arange(8000) / 16000
    wav = (0.3 * np.sin(2 * np.pi * 200 * t) + 0.02 * rng.standard_normal(len(t))).astype(np.float32)
    f0 = np.full(26, 200.0, np.float32)
    want = JaxKnnSvc(wparams, jcfg, params, jh, "wavlm_only").mel_vocode(wav, f0)
    got = KnnSvc(wparams, cfg, params, h, "wavlm_only", device="cpu").mel_vocode(wav, f0)
    assert got.shape == want.shape and np.abs(want).max() > 1e-3
    np.testing.assert_allclose(got, want, atol=WAV_ATOL)
