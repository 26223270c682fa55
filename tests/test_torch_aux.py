"""knnsvc_torch's training-side modules and tools on the CPU against the JAX
package's, on the same seeded numpy inputs: stft_magnitude and hann_window
and the spectral losses at 1e-5 (rss_loss over the FFT sizes JAX draws;
the port draws its own from a torch.Generator, deterministically), the
zero-phase harmonic synth and the harm head at 2e-4 (waveforms,
COMPONENTS.md §2.3), span masks exactly for the same seed, the legacy
audio dataset, the MPD/MSD state-dict converters at 1e-6 after the port's
carry-over, the FLOP counts exactly, and the profiling utilities."""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_common import one_torch_thread  # noqa: F401  (autouse)

RNG = np.random.default_rng(20261017)
WAVES = (RNG.standard_normal((2, 4800)) * 0.2).astype(np.float32)
WAVES_B = (RNG.standard_normal((2, 4800)) * 0.2).astype(np.float32)


@pytest.mark.parametrize("kw", [
    dict(n_fft=512, hop_length=128),
    dict(n_fft=400, hop_length=100, win_length=300, power=2.0),
    dict(n_fft=256, hop_length=256, center=False),
    dict(n_fft=1024, hop_length=320, win_length=1024, pad_mode="constant"),
])
def test_stft_magnitude_matches_jax(kw):
    from knnsvc_tpu.dsp.stft import stft_magnitude as jax_stft
    from knnsvc_torch.dsp import stft_magnitude

    got = stft_magnitude(torch.from_numpy(WAVES), **kw).numpy()
    want = np.asarray(jax_stft(jnp.asarray(WAVES), **kw))
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


def test_hann_window_matches_jax():
    from knnsvc_tpu.dsp.stft import hann_window as jax_hann
    from knnsvc_torch.dsp.stft import hann_window

    for n in (300, 400, 1024):
        np.testing.assert_allclose(hann_window(n, device="cpu").numpy(),
                                   np.asarray(jax_hann(n)), atol=1e-6)


@pytest.mark.parametrize("dsp_type", ["sin", "cos"])
def test_harmonic_synth_zero_phase_matches_jax(dsp_type):
    from knnsvc_tpu.dsp.synth import harmonic_synth_zero_phase as jax_synth
    from knnsvc_torch.dsp.synth import harmonic_synth_zero_phase

    rng = np.random.default_rng(3)
    f0 = (rng.random((2, 30)) * 400 + 80).astype(np.float32)
    f0[:, 5:8] = 0.0
    amp = (rng.random((2, 30, 12)) * 0.1).astype(np.float32)
    got = harmonic_synth_zero_phase(torch.from_numpy(f0), torch.from_numpy(amp),
                                    dsp_type=dsp_type).numpy()
    want = np.asarray(jax_synth(jnp.asarray(f0), jnp.asarray(amp), dsp_type=dsp_type))
    assert got.shape == want.shape == (2, 30 * 320)
    np.testing.assert_allclose(got, want, atol=2e-4)
    assert np.abs(got[:, 5 * 320:8 * 320]).max() == 0.0
    with pytest.raises(NotImplementedError):
        harmonic_synth_zero_phase(torch.from_numpy(f0), torch.from_numpy(amp), dsp_type="saw")


@pytest.mark.parametrize("n_fft,overlap", [(256, 0.0), (512, 0.75), (1024, 0.0), (2000, 0.5)])
def test_sss_loss_matches_jax(n_fft, overlap):
    from knnsvc_tpu.train.spectral_losses import sss_loss as jax_sss
    from knnsvc_torch.train.spectral_losses import sss_loss

    for a, b in ((WAVES, WAVES_B), (WAVES, WAVES)):
        got = float(sss_loss(torch.from_numpy(a), torch.from_numpy(b), n_fft=n_fft,
                             overlap=overlap))
        want = float(jax_sss(jnp.asarray(a), jnp.asarray(b), n_fft=n_fft, overlap=overlap))
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


def test_rss_loss_against_jax_sizes_and_deterministic():
    """JAX's rss_loss against the port's mean of sss_loss over the sizes
    JAX's key draws; the port's own draw repeats for a seed."""
    from knnsvc_tpu.train.spectral_losses import rss_loss as jax_rss
    from knnsvc_torch.train.spectral_losses import rss_loss, sss_loss

    key = jax.random.PRNGKey(7)
    sizes = [int(s) for s in jax.random.randint(key, (3,), 256, 1024)]
    want = float(jax_rss(key, jnp.asarray(WAVES_B), jnp.asarray(WAVES), fft_min=256,
                         fft_max=1024, n_scale=3))
    a, b = torch.from_numpy(WAVES), torch.from_numpy(WAVES_B)
    got = float(sum(sss_loss(a, b, n_fft=n) for n in sizes) / 3)
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)

    draw = lambda seed: float(rss_loss(torch.Generator().manual_seed(seed), b, a,  # noqa: E731
                                       fft_min=256, fft_max=1024, n_scale=3))
    assert draw(11) == draw(11)
    own = torch.randint(256, 1024, (3,), generator=torch.Generator().manual_seed(11)).tolist()
    assert all(256 <= n < 1024 for n in own)
    np.testing.assert_allclose(draw(11), float(sum(sss_loss(a, b, n_fft=n) for n in own) / 3),
                               rtol=1e-6)


@pytest.mark.parametrize("mask_type,other", [("static", 0.0), ("uniform", 2.0),
                                             ("normal", 3.0), ("poisson", 0.0)])
def test_mask_indices_and_apply_mask_match_jax(mask_type, other):
    from knnsvc_tpu.models.wavlm.masking import apply_mask as jax_apply
    from knnsvc_tpu.models.wavlm.masking import compute_mask_indices as jax_mask
    from knnsvc_torch.models.wavlm.masking import apply_mask, compute_mask_indices

    pad = np.zeros((4, 120), bool)
    pad[1, 100:] = True
    pad[3, 90:] = True
    for padding in (None, pad):
        kw = dict(mask_prob=0.5, mask_length=8, mask_type=mask_type, mask_other=other,
                  min_masks=2)
        got = compute_mask_indices((4, 120), padding, rng=np.random.default_rng(5), **kw)
        want = jax_mask((4, 120), padding, rng=np.random.default_rng(5), **kw)
        np.testing.assert_array_equal(got, want)
    feats = np.random.default_rng(6).standard_normal((4, 120, 8)).astype(np.float32)
    emb = np.arange(8, dtype=np.float32)
    out = apply_mask(torch.from_numpy(feats), emb, got).numpy()
    np.testing.assert_array_equal(out, np.asarray(jax_apply(jnp.asarray(feats), emb, want)))


def test_harm_head_matches_jax():
    from knnsvc_tpu.models.hifigan.harm_head import generator_harm_apply as jax_apply
    from knnsvc_tpu.models.hifigan.harm_head import init_generator_harm_params as jax_init
    from knnsvc_torch.io.jax_params import generator_harm_from_numpy
    from knnsvc_torch.models.hifigan.harm_head import (generator_harm_apply,
                                                       init_generator_harm_params)

    hidden, n_harm, T = 16, 8, 12
    params = jax.tree.map(np.asarray, jax_init(jax.random.PRNGKey(0), hidden, n_harm,
                                               n_layers=3))
    # the zero-init projection would leave the stack out of the output
    params["net"]["proj"]["w"] = (np.random.default_rng(1).standard_normal(
        params["net"]["proj"]["w"].shape) * 0.1).astype(np.float32)
    rng = np.random.default_rng(0)
    f0 = (rng.random((2, T, 1)) * 300 + 80).astype(np.float32)
    f0[0, 4] = 7900.0                                  # every harmonic above Nyquist
    harm = rng.standard_normal((2, hidden, T)).astype(np.float32)
    model = generator_harm_from_numpy(params, "cpu")
    with torch.no_grad():
        got = generator_harm_apply(model, torch.from_numpy(f0), torch.from_numpy(harm)).numpy()
    want = np.asarray(jax.jit(jax_apply)(params, jnp.asarray(f0), jnp.asarray(harm)))
    assert got.shape == want.shape == (2, n_harm, T * 320)
    np.testing.assert_allclose(got, want, atol=2e-4)
    assert np.abs(got).max() > 1e-3

    ours = init_generator_harm_params(torch.Generator().manual_seed(0), hidden, n_harm)
    theirs = jax.tree.map(np.asarray, jax_init(jax.random.PRNGKey(0), hidden, n_harm))
    assert (jax.tree.structure(ours) == jax.tree.structure(theirs)
            and all(a.shape == b.shape and a.dtype == b.dtype
                    for a, b in zip(jax.tree.leaves(ours), jax.tree.leaves(theirs))))


def test_legacy_audio_dataset_matches_jax(tmp_path):
    from knnsvc_tpu.train.legacy_audio_dataset import AudioDataset as JaxDataset
    from knnsvc_tpu.train.legacy_audio_dataset import traverse_dir as jax_traverse
    from knnsvc_torch.io.audio import save_audio
    from knnsvc_torch.train.legacy_audio_dataset import AudioDataset, traverse_dir

    from test_torch_common import vibrato_wav

    for i, (seconds, hz) in enumerate(((1.6, 220.0), (0.6, 180.0))):
        d = tmp_path / f"spk{i}"
        d.mkdir()
        save_audio(d / f"u{i}.wav", vibrato_wav(seconds, hz, 40 + i), 16000)
    (tmp_path / "notes.txt").write_text("not audio")
    for kw in ({}, dict(is_pure=True, is_sort=True, is_ext=False), dict(str_include="spk1"),
               dict(str_exclude="spk1", amount=1)):
        assert traverse_dir(str(tmp_path), ".wav", **kw) == jax_traverse(str(tmp_path), ".wav",
                                                                         **kw)
    ours, theirs = AudioDataset(str(tmp_path), waveform_sec=1.0, seed=3), JaxDataset(
        str(tmp_path), waveform_sec=1.0, seed=3)
    assert len(ours) == len(theirs) == 2
    for i in range(2):
        a, b = ours[i], theirs[i]
        assert a["name"] == b["name"] and a["audio"].shape == (16000,)
        np.testing.assert_array_equal(a["audio"], b["audio"])
        np.testing.assert_allclose(a["f0"], b["f0"], atol=1e-3)
        assert a["f0"].shape == (16000 // 320 + 1,)


def _reference_state_dict(tree, rng, prefix=""):
    """A JAX-layout discriminator tree -> the reference's state dict: live
    weight norm as weight_g / weight_v (a random positive g), spectral norm
    as weight_orig / weight_u / weight_v."""
    sd = {}
    if isinstance(tree, list):
        for i, sub in enumerate(tree):
            sd.update(_reference_state_dict(sub, rng, f"{prefix}{i}."))
    elif "v" in tree or "v_sn" in tree:
        t = lambda a: torch.from_numpy(np.ascontiguousarray(a, np.float32))  # noqa: E731
        if "v" in tree:
            sd[prefix + "weight_g"] = t(rng.random(tree["g"].shape) + 0.5)
            sd[prefix + "weight_v"] = t(tree["v"])
        else:
            sd[prefix + "weight_orig"] = t(tree["v_sn"])
            sd[prefix + "weight_u"] = t(tree["u"])
            sd[prefix + "weight_v"] = t(tree["v_pow"])
        sd[prefix + "bias"] = t(rng.standard_normal(tree["b"].shape) * 0.1)
    else:
        for k, sub in tree.items():
            sd.update(_reference_state_dict(sub, rng, f"{prefix}{k}."))
    return sd


@pytest.mark.parametrize("fold", [False, True])
def test_mpd_msd_converters_match_jax(fold):
    from knnsvc_tpu.io.checkpoints import convert_mpd_state_dict as jax_mpd
    from knnsvc_tpu.io.checkpoints import convert_msd_state_dict as jax_msd
    from knnsvc_torch.io.checkpoints import convert_mpd_state_dict, convert_msd_state_dict
    from knnsvc_torch.io.jax_params import discriminators_from_numpy, tree_from_module
    from knnsvc_torch.models.hifigan.discriminator import init_mpd_params, init_msd_params

    from test_torch_train_common import assert_tree_close

    gen = torch.Generator().manual_seed(2)
    rng = np.random.default_rng(2)
    sd_mpd = _reference_state_dict(init_mpd_params(gen, width_scale=8), rng)
    sd_msd = _reference_state_dict(init_msd_params(gen, width_scale=8), rng)
    mpd_tree, msd_tree = convert_mpd_state_dict(sd_mpd, fold), convert_msd_state_dict(sd_msd, fold)
    mpd, msd = discriminators_from_numpy(mpd_tree, msd_tree, "cpu")
    n = assert_tree_close(tree_from_module(mpd), jax_mpd(sd_mpd, fold), 1e-6)
    n += assert_tree_close(tree_from_module(msd), jax_msd(sd_msd, fold), 1e-6)
    assert n == (5 * 6 + 3 * 8) * (2 if fold else 3) + 8 * (2 if fold else 1)
    y = torch.from_numpy(np.random.default_rng(4).standard_normal((1, 1, 900)).astype(np.float32))
    with torch.no_grad():
        assert all(torch.isfinite(o).all() for o in mpd(y, y)[0] + msd(y, y)[0])


def test_flop_counts_equal_jax():
    from knnsvc_tpu.config import HiFiGANConfig as JaxHiFiGANConfig
    from knnsvc_tpu.config import WavLMConfig as JaxWavLMConfig
    from knnsvc_tpu.utils import flops as jax_flops
    from knnsvc_torch.config import HiFiGANConfig, WavLMConfig
    from knnsvc_torch.utils import flops

    from test_torch_common import SMALL_HIFIGAN

    for n in (16000, 480320, 12345):
        cfg, jcfg = WavLMConfig(), JaxWavLMConfig()
        assert (flops.conv_frontend_flops(cfg.conv_feature_layers, n)
                == jax_flops.conv_frontend_flops(jcfg.conv_feature_layers, n))
    for args in ((1024, 4096, 6, 1500), (768, 3072, 12, 200, 64, 8)):
        assert flops.wavlm_encoder_flops(*args) == jax_flops.wavlm_encoder_flops(*args)
    for concat in (False, True):
        assert (flops.match_flops(1500, 1500, 1024, topk=4, concat=concat)
                == jax_flops.match_flops(1500, 1500, 1024, topk=4, concat=concat))
    for spec in ({}, SMALL_HIFIGAN, {"resblock": "2"}):
        h, jh = HiFiGANConfig.from_dict(dict(spec)), JaxHiFiGANConfig.from_dict(dict(spec))
        for family in ("mix", "f0", "original"):
            assert (flops.hifigan_flops(h, 1501, family)
                    == jax_flops.hifigan_flops(jh, 1501, family) > 0)
    rows = [("wavlm", 1.2e12, 0.0123), ("vocoder", 3.4e11, 0.0456)]
    assert flops.format_mfu_table(rows, 67.0) == jax_flops.format_mfu_table(rows, 67.0)


def test_profiling_utilities(tmp_path):
    from knnsvc_tpu.utils.profiling import StageTimer as JaxStageTimer
    from knnsvc_torch.utils.profiling import StageTimer, annotate, force_completion, trace

    timers = []
    for cls in (StageTimer, JaxStageTimer):
        t = cls(sync=True)
        for name in ("encode", "encode", "vocode"):
            with t.stage(name):
                t.observe({"x": [torch.ones(3)]} if cls is StageTimer else None)
        timers.append(t)
    ours, theirs = timers
    assert dict(ours.counts) == dict(theirs.counts) == {"encode": 2, "vocode": 1}
    assert [line.split()[0] for line in ours.report().splitlines()] == \
        [line.split()[0] for line in theirs.report().splitlines()]
    assert json.loads(ours.as_json()).keys() == json.loads(theirs.as_json()).keys()
    assert all(set(v) == {"seconds", "count"} for v in json.loads(ours.as_json()).values())

    tree = (torch.zeros(2), [torch.ones(1)], {"a": 1})
    assert force_completion(tree) is tree
    with trace(str(tmp_path / "prof")) as prof:
        with annotate("knnsvc.test_span"):
            torch.ones(4).sum()
    assert any(e.name == "knnsvc.test_span" for e in prof.events())
    assert (tmp_path / "prof" / "trace.json").stat().st_size > 0

