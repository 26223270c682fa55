"""The ported slice end to end on the CPU: knnsvc_torch's
KnnSvc.convert_pair(fast=True) against the JAX package's on the same 1-s
synthetic pair, the same parameters and the same f0 sidecars (so both skip
the extractor)."""

import numpy as np
import pytest

import jax

from knnsvc_tpu.hub import KnnSvc as JaxKnnSvc
from knnsvc_torch.hub import KnnSvc
from knnsvc_torch.ops.attention import gated_bias_attention
from knnsvc_torch.utils.layer_weights import generate_matrix_from_index

from test_torch_common import int16_codes, small_generator, small_wavlm, write_pair

# int16 codes: well inside 2e-4 * 32768 = 6.6 codes (COMPONENTS.md §2.3's
# waveform bound); the two packages differ only in fp32 rounding
MAX_CODE_DIFF = 2


@pytest.fixture(scope="module")
def pair(tmp_path_factory):
    root = tmp_path_factory.mktemp("torch_slice")
    return root, write_pair(root)


@pytest.mark.parametrize("ckpt_type", ["mix", "wavlm_only"])
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
    before = gated_bias_attention.launches
    got = int16_codes(knn.convert_pair(src, ref, fast=True,
                                  output_path=str(root / f"torch_{ckpt_type}.wav")))
    assert gated_bias_attention.launches == before   # CPU: the plain version

    assert got.shape == want.shape == (50 * 320,)
    assert np.abs(want).max() > 1000, "rescaled weights must give a real waveform"
    assert np.abs(got - want).max() <= MAX_CODE_DIFF
