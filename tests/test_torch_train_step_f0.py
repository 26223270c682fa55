"""knnsvc_torch's GAN train step against the JAX package's for the F0_ONLY
(wavlm_only) family: the checks of test_torch_train_step.py (one and three
steps, continuing from JAX's Adam state, eval_step and eval_step_padded) on
the sine-excitation vocoder. The discriminators are the mix test's, so
they keep their first 2 periods (2, and 3 with its reflect pad) and 2
scales (spectral- and weight-normed, the avg-pool between): the JAX step
compiles in ~60% of the full topology's time."""

import pytest

from test_torch_common import one_torch_thread  # noqa: F401  (autouse)
from test_torch_train_common import (check_continue_from_adam_state, check_eval_steps,
                                     check_train_steps, jax_run)


@pytest.fixture(scope="module")
def run():
    return jax_run("f0_only", disc_periods=2, disc_scales=2)


@pytest.mark.parametrize("n_steps", [1, 3])
def test_train_steps_match_jax(run, n_steps):
    check_train_steps(run, n_steps)


def test_steps_continue_from_jax_adam_state(run):
    check_continue_from_adam_state(run)


def test_eval_steps_match_jax(run):
    check_eval_steps(run)
