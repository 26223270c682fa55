"""knnsvc_torch's GAN train step on the CPU against the JAX package's, mix
family, from the same carried-across TrainState and batch
(tests/test_training.py's tiny config, disc_width_scale=8): one and three
steps, the metrics at rtol 1e-4 and every updated parameter, spectral-norm
buffer and Adam moment at atol 1e-5 (the bound tests/test_training.py holds
DP against; the moments, which reach ~850 here, also within rtol 1e-5); two
steps continued from JAX's state and Adam moments after its first;
eval_step and eval_step_padded against JAX at 1e-5; a JAX-trained g_
checkpoint served by the port. The F0_ONLY family is
test_torch_train_step_f0.py, the bf16 step test_torch_train_bf16.py."""

import json

import numpy as np
import pytest

from test_torch_common import TINY_H, TINY_WAVLM, tiny_wavlm_params, write_pair
from test_torch_common import one_torch_thread  # noqa: F401  (autouse)
from test_torch_train_common import (check_continue_from_adam_state, check_eval_steps,
                                     check_train_steps, jax_run)


@pytest.fixture(scope="module")
def run():
    return jax_run("mix")


@pytest.mark.parametrize("n_steps", [1, 3])
def test_train_steps_match_jax(run, n_steps):
    check_train_steps(run, n_steps)


def test_steps_continue_from_jax_adam_state(run):
    check_continue_from_adam_state(run)


def test_eval_steps_match_jax(run):
    check_eval_steps(run)


def test_jax_trained_checkpoint_serves_in_port(run, tmp_path):
    """A g_ written by the JAX package after three of its train steps (live
    {g, v} weights) loads in the port's KnnSvc, vocodes as the JAX
    package's KnnSvc does (2e-4), and serves convert_pair on the CPU."""
    from knnsvc_tpu.hub import KnnSvc as JaxKnnSvc
    from knnsvc_tpu.io.checkpoints import save_params as jax_save_params
    from knnsvc_torch.hub import KnnSvc
    from knnsvc_torch.io.audio import load_audio
    from knnsvc_torch.utils.layer_weights import generate_matrix_from_index

    jstate = run[3][-1][0]
    jax_save_params(str(tmp_path / "g_mix_00000003.knnsvc.pkl"), {"generator": jstate.g_params})
    _, wparams = tiny_wavlm_params()
    jax_save_params(str(tmp_path / "wavlm.knnsvc.pkl"), {"cfg": TINY_WAVLM, "model": wparams})
    (tmp_path / "config.json").write_text(json.dumps(TINY_H))
    kw = dict(wavlm_ckpt=str(tmp_path / "wavlm.knnsvc.pkl"),
              config_path=str(tmp_path / "config.json"))
    port = KnnSvc.load(str(tmp_path), "mix", device="cpu", **kw)
    ref = JaxKnnSvc.load(str(tmp_path), "mix", **kw)

    rng = np.random.default_rng(9)
    feats = rng.standard_normal((12, 16)).astype(np.float32)
    f0 = np.full(12, 190.0, np.float32)
    harm = (rng.random((12, 49)) * 0.05).astype(np.float32)
    np.testing.assert_allclose(port.vocode(feats, f0, harm), ref.vocode(feats, f0, harm),
                               atol=2e-4)

    port.weighting = generate_matrix_from_index(1, size=3)
    src, tgt = write_pair(tmp_path)
    out = tmp_path / "served.wav"
    assert port.convert_pair(src, tgt, fast=True, output_path=str(out)) == str(out)
    y, sr = load_audio(out)
    assert sr == 16000 and np.isfinite(y).all() and y.shape[1] > 0
