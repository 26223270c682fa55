"""The ported slice end to end on the CPU: knnsvc_torch's
KnnSvc.convert_pair(fast=True) against the JAX package's on the same 1-s
synthetic pair, the same parameters and the same f0 sidecars (so both skip
the extractor)."""

import numpy as np
import pytest

import jax

from knnsvc_tpu.hub import KnnSvc as JaxKnnSvc
from knnsvc_torch.hub import KnnSvc
from knnsvc_torch.ops.attention import gated_bias_attention_diag
from knnsvc_torch.ops.concat_scan import concat_cost_pair
from knnsvc_torch.ops.viterbi import f0_viterbi
from knnsvc_torch.utils.layer_weights import generate_matrix_from_index

from test_torch_common import (int16_codes, small_generator, small_wavlm, write_pair,
                               write_vibrato_pair)

# int16 codes: well inside 2e-4 * 32768 = 6.6 codes (COMPONENTS.md §2.3's
# waveform bound); the two packages differ only in fp32 rounding
MAX_CODE_DIFF = 2
DEVICE_F0_REL = 1e-2


@pytest.fixture(scope="module")
def pair(tmp_path_factory):
    root = tmp_path_factory.mktemp("torch_slice")
    return root, write_pair(root)


@pytest.mark.parametrize("ckpt_type", ["mix", "wavlm_only", "wavlm_only_original"])
def test_convert_pair_fast_matches_jax(pair, ckpt_type):
    root, (src, ref) = pair
    cfg, jcfg, wavlm_params = small_wavlm()
    h, jh, _, _, gen_params = small_generator(ckpt_type)
    weighting = generate_matrix_from_index(2, size=cfg.encoder_layers + 1)

    jknn = JaxKnnSvc(jax.tree.map(np.asarray, wavlm_params), jcfg, gen_params, jh, ckpt_type)
    jknn.weighting = weighting
    want = int16_codes(jknn.convert_pair(src, ref, fast=True,
                                    output_path=str(root / f"jax_{ckpt_type}.wav")))

    knn = KnnSvc(wavlm_params, cfg, gen_params, h, ckpt_type, device="cpu")
    knn.weighting = weighting
    before = gated_bias_attention_diag.launches
    got = int16_codes(knn.convert_pair(src, ref, fast=True,
                                  output_path=str(root / f"torch_{ckpt_type}.wav")))
    assert gated_bias_attention_diag.launches == before   # CPU: the plain version

    assert got.shape == want.shape == (50 * 320,)
    assert np.abs(want).max() > 1000, "rescaled weights must give a real waveform"
    assert np.abs(got - want).max() <= MAX_CODE_DIFF


@pytest.mark.parametrize("ckpt_type", ["mix", "wavlm_only"])
def test_convert_pair_fast_post_opt_matches_jax(pair, ckpt_type):
    """post_opt_0.2: the concat-cost reselection (both lanes for mix, the
    unpitched one for wavlm_only) and the smoothness optimizer."""
    root, (src, ref) = pair
    cfg, jcfg, wavlm_params = small_wavlm()
    h, jh, _, _, gen_params = small_generator(ckpt_type)
    weighting = generate_matrix_from_index(2, size=cfg.encoder_layers + 1)

    jknn = JaxKnnSvc(jax.tree.map(np.asarray, wavlm_params), jcfg, gen_params, jh, ckpt_type)
    jknn.weighting = weighting
    want = int16_codes(jknn.convert_pair(src, ref, fast=True, post_opt="post_opt_0.2",
                                         output_path=str(root / f"jax_po_{ckpt_type}.wav")))

    knn = KnnSvc(wavlm_params, cfg, gen_params, h, ckpt_type, device="cpu")
    knn.weighting = weighting
    before = concat_cost_pair.launches
    got = int16_codes(knn.convert_pair(src, ref, fast=True, post_opt="post_opt_0.2",
                                       output_path=str(root / f"torch_po_{ckpt_type}.wav")))
    assert concat_cost_pair.launches == before   # CPU: the plain version

    assert got.shape == want.shape == (50 * 320,)
    assert np.abs(want).max() > 1000
    assert np.abs(got - want).max() <= MAX_CODE_DIFF


@pytest.mark.parametrize("ckpt_type", ["mix", "wavlm_only"])
def test_convert_pair_fast_device_f0_int16_matches_jax(pair, ckpt_type):
    """f0_method='device' and upload_dtype='int16', the JAX package's
    bench.py serving settings: f0 from the device extractor per chunk (no
    sidecar read or written), quantized uploads, on a vibrato pair.

    The two packages' device f0 differ by up to ~0.01 cents (FFT and
    matrix-product summation order; test_torch_f0_device.py), about 2e-6
    relative. The excitation integrates f0 into its phase, so that
    difference grows over the utterance (~2.4e-3 rad after 1 s at 190 Hz)
    and the rescaled random vocoder passes it on: the waveforms agree
    within DEVICE_F0_REL of their peak (3.3e-3 measured for wavlm_only);
    with the JAX package's f0 substituted, within 1 int16 code."""
    root, _ = pair
    src, ref = write_vibrato_pair(root)
    cfg, jcfg, wavlm_params = small_wavlm()
    h, jh, _, _, gen_params = small_generator(ckpt_type)
    weighting = generate_matrix_from_index(2, size=cfg.encoder_layers + 1)

    jknn = JaxKnnSvc(jax.tree.map(np.asarray, wavlm_params), jcfg, gen_params, jh, ckpt_type)
    jknn.weighting, jknn.f0_method = weighting, "device"
    want = int16_codes(jknn.convert_pair(src, ref, fast=True, upload_dtype="int16",
                                         output_path=str(root / f"jax_dev_{ckpt_type}.wav")))

    knn = KnnSvc(wavlm_params, cfg, gen_params, h, ckpt_type, device="cpu")
    knn.weighting, knn.f0_method = weighting, "device"
    before = f0_viterbi.launches
    got = int16_codes(knn.convert_pair(src, ref, fast=True, upload_dtype="int16",
                                       output_path=str(root / f"torch_dev_{ckpt_type}.wav")))
    assert f0_viterbi.launches == before      # CPU: the plain version
    assert not list(root.glob("vsrc_f0*")) and not list(root.glob("vref_f0*"))

    assert got.shape == want.shape == (50 * 320,)
    assert np.abs(want).max() > 1000
    assert np.abs(got - want).max() <= DEVICE_F0_REL * np.abs(want).max()
