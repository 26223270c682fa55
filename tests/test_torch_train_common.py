"""Shared helpers (no tests) of the train-step parity tests,
test_torch_train_step*.py: JAX's tiny train steps, their TrainStates
carried across to the port, and the checks both families run. The JAX
step compiles once per module (module-scoped fixtures in each file)."""

import numpy as np
import torch

import jax
import jax.numpy as jnp

from knnsvc_tpu.config import HiFiGANConfig as JaxHiFiGANConfig
from knnsvc_tpu.config import ModelFamily as JaxModelFamily
from knnsvc_tpu.models.hifigan import init_generator_params, init_mpd_params, init_msd_params
from knnsvc_tpu.train import trainer as jax_trainer
from knnsvc_torch.config import HiFiGANConfig, ModelFamily
from knnsvc_torch.io.jax_params import train_state_from_numpy, tree_from_module, tree_from_tensors
from knnsvc_torch.train import trainer

from test_torch_common import DISC_WIDTH_SCALE, TINY_H, adam_moments, tiny_batch

FAMILIES = {"mix": (ModelFamily.MIX, JaxModelFamily.MIX),
            "f0_only": (ModelFamily.F0_ONLY, JaxModelFamily.F0_ONLY)}
METRICS = ("loss_gen_total", "loss_disc_total", "mel_spec_error")
# the moments scale with the gradients, whose entries reach ~850 here (bias
# gradients of the 45x mel loss, sums over every output sample): past atol
# they are held to MOMENT_RTOL (the two packages sum each gradient in
# another order; 1.2e-6 relative seen)
MOMENT_RTOL = 1e-5


def np_tree(tree):
    return jax.tree.map(np.asarray, tree)


def carry(jstate, h, family, with_adam=False):
    """A JAX TrainState -> the port's, on the CPU."""
    kw = {}
    if with_adam:
        kw = {"adam_g": adam_moments(jstate.opt_g), "adam_d": adam_moments(jstate.opt_d)}
    return train_state_from_numpy(np_tree(jstate.g_params), np_tree(jstate.mpd_params),
                                  np_tree(jstate.msd_params), h, family, "cpu",
                                  steps=int(jstate.steps), **kw)


def jax_run(family: str, n_steps: int = 3, compute_dtype=None, disc_periods=None,
            disc_scales=None):
    """(port cfg, port family, initial JAX state, [(state, metrics) after
    each JAX step], numpy batch). disc_periods / disc_scales keep the first
    MPD periods / MSD scales (the JAX init's own cut, which the multichip
    dry run uses to bound compile time)."""
    fam, jfam = FAMILIES[family]
    h, jh = HiFiGANConfig.from_dict(TINY_H), JaxHiFiGANConfig.from_dict(TINY_H)
    opt_g, opt_d = jax_trainer.make_optimizers(jh)
    # jax_trainer.init_train_state(PRNGKey(0), ...) with its discriminator
    # inits and optimizer inits jitted: the same values, one compile each
    # instead of an eager op per conv shape (~28 s here)
    kg, kp, ks = jax.random.split(jax.random.PRNGKey(0), 3)
    g = init_generator_params(kg, jh, jfam, weight_norm_parametrized=True)
    mpd = jax.jit(init_mpd_params, static_argnames=("width_scale", "n_periods"))(
        kp, width_scale=DISC_WIDTH_SCALE, n_periods=disc_periods)
    msd = jax.jit(init_msd_params, static_argnames=("width_scale", "n_scales"))(
        ks, width_scale=DISC_WIDTH_SCALE, n_scales=disc_scales)
    state = jax_trainer.TrainState(g_params=g, mpd_params=mpd, msd_params=msd,
                                   opt_g=jax.jit(opt_g.init)(g),
                                   opt_d=jax.jit(opt_d.init)((mpd, msd)), steps=jnp.int32(0))
    step = jax_trainer.make_train_step(jh, jfam, opt_g, opt_d, compute_dtype=compute_dtype)
    batch = tiny_batch(jh, 2, seed=3)
    runs, s = [], state
    for _ in range(n_steps):
        s, m = step(s, {k: jnp.asarray(v) for k, v in batch.items()})
        runs.append((s, {k: float(v) for k, v in m.items()}))
    return h, fam, state, runs, batch


def port_steps(state, h, fam, batch, n, compute_dtype=None):
    step = trainer.make_train_step(h, fam, compute_dtype=compute_dtype)
    tb = {k: torch.from_numpy(v) for k, v in batch.items()}
    return [{k: float(v) for k, v in step(state, tb).items()} for _ in range(n)]


def assert_tree_close(got, want, atol, path="", rtol=0.0) -> int:
    """Every leaf of `got` against the same path in `want`; -> leaves seen."""
    if isinstance(got, dict):
        return sum(assert_tree_close(v, want[k], atol, f"{path}/{k}", rtol)
                   for k, v in got.items())
    if isinstance(got, list):
        return sum(assert_tree_close(v, want[i], atol, f"{path}/{i}", rtol)
                   for i, v in enumerate(got))
    np.testing.assert_allclose(got, np.asarray(want), atol=atol, rtol=rtol, err_msg=path)
    return 1


def _port_moments(state, key):
    """The port's AdamW moments as (generator, mpd, msd) trees."""
    return [tree_from_tensors({n: opt.state[p][key] for n, p in module.named_parameters()})
            for module, opt in ((state.generator, state.opt_g), (state.mpd, state.opt_d),
                                (state.msd, state.opt_d))]


def assert_state_close(pstate, jstate, atol=1e-5) -> int:
    """Parameters, spectral-norm buffers, Adam moments and the step count."""
    n = assert_tree_close(tree_from_module(pstate.generator), np_tree(jstate.g_params), atol)
    n += assert_tree_close(tree_from_module(pstate.mpd), np_tree(jstate.mpd_params), atol)
    n += assert_tree_close(tree_from_module(pstate.msd), np_tree(jstate.msd_params), atol)
    ag, ad = adam_moments(jstate.opt_g), adam_moments(jstate.opt_d)
    for key, jkey in (("exp_avg", "mu"), ("exp_avg_sq", "nu")):
        g, mpd, msd = _port_moments(pstate, key)
        n += assert_tree_close(g, ag[jkey], atol, rtol=MOMENT_RTOL)
        n += assert_tree_close(mpd, ad[jkey][0], atol, rtol=MOMENT_RTOL)
        n += assert_tree_close(msd, ad[jkey][1], atol, rtol=MOMENT_RTOL)
    assert pstate.steps == int(jstate.steps)
    return n


def check_train_steps(run, n_steps: int) -> None:
    """n port steps from JAX's initial state: metrics at rtol 1e-4, the
    state at atol 1e-5."""
    h, fam, jstate0, runs, batch = run
    pstate = carry(jstate0, h, fam)
    got = port_steps(pstate, h, fam, batch, n_steps)
    for k in METRICS:
        np.testing.assert_allclose([m[k] for m in got], [m[k] for _, m in runs[:n_steps]],
                                   rtol=1e-4, err_msg=k)
    assert assert_state_close(pstate, runs[n_steps - 1][0]) > 100


def check_continue_from_adam_state(run) -> None:
    """JAX's state after its first step, Adam moments and count included,
    carried across: two more port steps land on JAX's third."""
    h, fam, _, runs, batch = run
    pstate = carry(runs[0][0], h, fam, with_adam=True)
    got = port_steps(pstate, h, fam, batch, 2)
    for k in METRICS:
        np.testing.assert_allclose(got[-1][k], runs[2][1][k], rtol=1e-4, err_msg=k)
    assert_state_close(pstate, runs[2][0])


def _fit(a, n, axis=0):
    sl = [slice(None)] * a.ndim
    sl[axis] = slice(0, n)
    a = a[tuple(sl)]
    widths = [(0, 0)] * a.ndim
    widths[axis] = (0, n - a.shape[axis])
    return np.pad(a, widths)


def check_eval_steps(run) -> None:
    """eval_step and eval_step_padded (unpadded and padded) against JAX at
    1e-5; unpadded, the masked error is the exact one; padded, within the
    rtol 0.15 that tests/test_training.py allows the receptive-field edge."""
    h, fam, _, runs, _ = run
    jstate = runs[-1][0]
    pstate = carry(jstate, h, fam)
    jfam = JaxModelFamily.MIX if fam == ModelFamily.MIX else JaxModelFamily.F0_ONLY
    jh = JaxHiFiGANConfig.from_dict(TINY_H)
    item = {k: v[0] for k, v in tiny_batch(h, 1, seed=7).items()}
    T, mel_true = item["feats"].shape[0], item["mel_loss"].shape[-1]

    exact = {k: v[None] for k, v in item.items()}
    want_err, want_y = jax_trainer.eval_step(jstate.g_params, jh, jfam,
                                             {k: jnp.asarray(v) for k, v in exact.items()})
    got_err, got_y = trainer.eval_step(pstate.generator, h, fam,
                                       {k: torch.from_numpy(v) for k, v in exact.items()})
    np.testing.assert_allclose(float(got_err), float(want_err), atol=1e-5)
    np.testing.assert_allclose(got_y.numpy(), np.asarray(want_y), atol=1e-5)

    for Tb in (T, trainer.eval_bucket(T, bucket=T + 8)):
        padded = {"feats": _fit(item["feats"], Tb)[None],
                  "audio": _fit(item["audio"], Tb * h.hop_size)[None],
                  "mel_loss": _fit(item["mel_loss"], Tb + 1, axis=-1)[None],
                  "f0": _fit(item["f0"], Tb)[None], "harmonics": _fit(item["harmonics"], Tb)[None]}
        want_p, want_py = jax_trainer.eval_step_padded(
            jstate.g_params, jh, jfam, {k: jnp.asarray(v) for k, v in padded.items()},
            jnp.int32(mel_true))
        got_p, got_py = trainer.eval_step_padded(
            pstate.generator, h, fam, {k: torch.from_numpy(v) for k, v in padded.items()},
            mel_true)
        np.testing.assert_allclose(float(got_p), float(want_p), atol=1e-5)
        np.testing.assert_allclose(got_py.numpy(), np.asarray(want_py), atol=1e-5)
        if Tb == T:
            np.testing.assert_allclose(float(got_p), float(got_err), atol=1e-5)
        else:
            np.testing.assert_allclose(float(got_p), float(got_err), rtol=0.15)
