"""knnsvc_torch's streaming conversion (KnnSvc.stream_convert_chunks) against
the JAX package's on the CPU, on the same 1-s vibrato pair (no f0
sidecar: each window's f0 is extracted), the same parameters and settings:
the windowed encoder without and with post_opt_0.2 (the concat-cost carry
threading from chunk to chunk). test_torch_streaming_cached.py runs the
cached K/V encoder, test_torch_streaming_variants.py wavlm_only and device
f0 the same way (a file is one worker's unit: each stays near a minute). Chunks of 0.25 s with 0.25 s of
context: five chunks.
Tolerance: MAX_CODE_DIFF int16 codes (tests/test_torch_slice.py's), and
with device f0 DEVICE_F0_REL of the peak (test_torch_slice.py says why).
On the CPU no kernel counts a launch. The session, framing and entry-point
checks of the port alone are in test_torch_stream_session.py."""

import jax
import numpy as np
import pytest

from knnsvc_tpu.hub import KnnSvc as JaxKnnSvc
from knnsvc_torch.hub import KnnSvc
from knnsvc_torch.ops.attention import gated_bias_attention_diag
from knnsvc_torch.ops.concat_scan import concat_cost_pair
from knnsvc_torch.ops.viterbi import f0_viterbi
from knnsvc_torch.utils.layer_weights import generate_matrix_from_index

from test_torch_common import small_generator, small_wavlm, write_vibrato_pair
from test_torch_slice import DEVICE_F0_REL, MAX_CODE_DIFF

STREAM = dict(chunk_s=0.25, context_s=0.25, matcher="exact")


@pytest.fixture(scope="module")
def pair(tmp_path_factory):
    return write_vibrato_pair(tmp_path_factory.mktemp("torch_streaming"))


def _models(ckpt_type):
    cfg, jcfg, wavlm_params = small_wavlm()
    h, jh, _, _, gen_params = small_generator(ckpt_type)
    weighting = generate_matrix_from_index(2, size=cfg.encoder_layers + 1)
    jknn = JaxKnnSvc(jax.tree.map(np.asarray, wavlm_params), jcfg, gen_params, jh, ckpt_type)
    knn = KnnSvc(wavlm_params, cfg, gen_params, h, ckpt_type, device="cpu")
    jknn.weighting = knn.weighting = weighting
    return jknn, knn


def _codes(chunks):
    return np.round(np.concatenate(chunks).astype(np.float64) * 32768).astype(np.int64)


def check_stream_against_jax(pair, ckpt_type, kwargs, f0_method):
    src, ref = pair
    jknn, knn = _models(ckpt_type)
    jknn.f0_method = knn.f0_method = f0_method
    want = list(jknn.stream_convert_chunks(src, ref, **STREAM, **kwargs))
    before = (gated_bias_attention_diag.launches, concat_cost_pair.launches, f0_viterbi.launches)
    got = list(knn.stream_convert_chunks(src, ref, **STREAM, **kwargs))
    assert (gated_bias_attention_diag.launches, concat_cost_pair.launches,
            f0_viterbi.launches) == before          # CPU: the plain versions
    assert len(got) == len(want) == 5
    assert [len(c) for c in got] == [len(c) for c in want]
    assert all(c.dtype == np.float32 for c in got)
    got, want = _codes(got), _codes(want)
    assert np.abs(want).max() > 1000, "rescaled weights must give a real waveform"
    limit = (DEVICE_F0_REL * np.abs(want).max() if f0_method == "device" else MAX_CODE_DIFF)
    assert np.abs(got - want).max() <= limit


@pytest.mark.parametrize("post_opt", ["no_post_opt", "post_opt_0.2"])
def test_stream_convert_chunks_matches_jax(pair, post_opt):
    check_stream_against_jax(pair, "mix", dict(post_opt=post_opt), "fast")
