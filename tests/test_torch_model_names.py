"""The JAX package's functional model entry points, which the port's
models/wavlm and models/hifigan packages export over their nn.Modules, on
the CPU: each gives its module's call bit for bit (the modules themselves
are held to the JAX package in test_torch_wavlm.py, test_torch_slice.py
and test_torch_train_modules.py); msd_apply(update_sn=True) takes the
power-iteration step first."""

import numpy as np
import pytest
import torch

from test_torch_common import SMALL_HIFIGAN, SMALL_WAVLM
from test_torch_common import one_torch_thread  # noqa: F401  (autouse)


def test_wavlm_functional_names():
    from knnsvc_torch.config import WavLMConfig
    from knnsvc_torch.io.jax_params import wavlm_from_numpy
    from knnsvc_torch.models import wavlm

    cfg = WavLMConfig.from_dict(SMALL_WAVLM)
    model = wavlm_from_numpy(wavlm.init_wavlm_params(cfg, torch.Generator().manual_seed(0)), cfg)
    x = torch.from_numpy((np.random.default_rng(9).standard_normal((1, 8320)) * 0.1)
                         .astype(np.float32))
    with torch.no_grad():
        pairs = [(wavlm.wavlm_encode(model, x, 2), model.extract_layer(x, 2)),
                 (wavlm.wavlm_extract_layer(model, x, 3), model.extract_layer(x, 3)),
                 (wavlm.wavlm_encode(model, x), model.extract_all_layers(x)),
                 (wavlm.wavlm_extract_all_layers(model, x), model.extract_all_layers(x)),
                 (wavlm.wavlm_extract_layer_bucketed(model, x, 3),
                  model.extract_layer_bucketed(x, 3))]
    assert pairs[2][0].shape == (SMALL_WAVLM["encoder_layers"] + 1, 1, 25, 64)
    for got, want in pairs:
        assert torch.equal(got, want)


@pytest.mark.parametrize("ckpt_type", ["mix", "wavlm_only", "wavlm_only_original"])
def test_hifigan_functional_names(ckpt_type):
    from knnsvc_torch.config import HiFiGANConfig, ModelFamily
    from knnsvc_torch.io.jax_params import generator_from_numpy
    from knnsvc_torch.models import hifigan
    from knnsvc_torch.models.hifigan.generator import init_generator_params

    fam = {"mix": ModelFamily.MIX, "wavlm_only": ModelFamily.F0_ONLY,
           "wavlm_only_original": ModelFamily.ORIGINAL}[ckpt_type]
    h = HiFiGANConfig.from_dict(SMALL_HIFIGAN)
    synth = generator_from_numpy(init_generator_params(h, fam, torch.Generator().manual_seed(1)),
                                 h, fam)
    rng = np.random.default_rng(10)
    feats = torch.from_numpy(rng.standard_normal((1, 12, h.hubert_dim)).astype(np.float32))
    f0 = torch.from_numpy((rng.random((1, 12, 1)) * 200 + 120).astype(np.float32))
    harm = torch.from_numpy((rng.random((1, 12, 49)) * 0.05).astype(np.float32))
    args = {ModelFamily.MIX: (feats, f0, harm), ModelFamily.F0_ONLY: (feats, f0),
            ModelFamily.ORIGINAL: (feats,)}[fam]
    apply = {ModelFamily.MIX: hifigan.synthesizer_mix_apply,
             ModelFamily.F0_ONLY: hifigan.synthesizer_f0_apply,
             ModelFamily.ORIGINAL: hifigan.synthesizer_original_apply}[fam]
    with torch.no_grad():
        want = synth(*args)
        got = apply(synth, *args)
        assert got.shape == (1, 1, 12 * 320) and torch.equal(got[:, 0], want)
        assert torch.equal(hifigan.vocode(synth, *args), want)
        if fam == ModelFamily.ORIGINAL:
            assert torch.equal(hifigan.generator_apply(synth.dec, feats, None), got)
    with pytest.raises(ValueError, match="Synthesizer is not a"):
        if fam == ModelFamily.ORIGINAL:
            hifigan.synthesizer_mix_apply(synth, feats, f0, harm)
        else:
            hifigan.synthesizer_original_apply(synth, feats)


def test_discriminator_functional_names():
    """mpd_apply / msd_apply are the modules' calls; msd_apply(update_sn=
    True) takes the power-iteration step first and returns the module."""
    from knnsvc_torch.io.jax_params import discriminators_from_numpy
    from knnsvc_torch.models import hifigan
    from knnsvc_torch.models.hifigan.discriminator import power_iterate

    gen = torch.Generator().manual_seed(3)
    trees = (hifigan.init_mpd_params(gen, width_scale=8, n_periods=2),
             hifigan.init_msd_params(gen, width_scale=8, n_scales=2))
    mpd, msd = discriminators_from_numpy(*trees, "cpu")
    twin = discriminators_from_numpy(*trees, "cpu")[1]
    y = torch.from_numpy(np.random.default_rng(5).standard_normal((1, 1, 960)).astype(np.float32))
    with torch.no_grad():
        got = hifigan.mpd_apply(mpd, y, -y)
        want = mpd(y, -y)
        assert all(torch.equal(a, b) for a, b in zip(got[0], want[0]))
        *outs, module = hifigan.msd_apply(msd, y, -y, update_sn=True)
        power_iterate(twin)
        ref = twin(y, -y)
    assert module is msd and all(torch.equal(a, b) for a, b in zip(outs[0], ref[0]))
