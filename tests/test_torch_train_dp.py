"""knnsvc_torch's data-parallel train step on the CPU: the batch sharded over
the 'data' axis of a logical mesh [cpu] * 2 (parallel/mesh.py), one replica
of G, MPD and MSD per shard, the gradients summed onto the master. The
state is the port's init (tests/test_training.py's tiny config,
disc_width_scale=8, the discriminators cut to MPD period 2 and MSD scale 0
to bound the JAX compile), carried into the JAX package. From it and the
same batch, the port's mesh-2 step is held to the JAX package's own mesh-2
step on conftest.py's virtual CPU devices and to the port's one-device
step: metrics at rtol 1e-4; parameters, spectral-norm buffers and Adam
moments at atol 1e-5 (tests/test_training.py:101-120's bounds)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from knnsvc_tpu.config import HiFiGANConfig as JaxHiFiGANConfig
from knnsvc_tpu.config import ModelFamily as JaxModelFamily
from knnsvc_tpu.parallel.mesh import data_sharding as jax_data_sharding
from knnsvc_tpu.parallel.mesh import make_mesh as jax_make_mesh
from knnsvc_tpu.parallel.mesh import replicated as jax_replicated
from knnsvc_tpu.train import trainer as jax_trainer
from knnsvc_torch.config import HiFiGANConfig, ModelFamily
from knnsvc_torch.io.jax_params import tree_from_module
from knnsvc_torch.parallel.mesh import data_sharding, make_mesh, replicated
from knnsvc_torch.train import trainer

from test_torch_common import DISC_WIDTH_SCALE, TINY_H, tiny_batch
from test_torch_common import one_torch_thread  # noqa: F401  (autouse)
from test_torch_train_common import METRICS, assert_state_close, assert_tree_close, carry

CPU2 = [torch.device("cpu")] * 2
CUT = dict(disc_periods=1, disc_scales=1)


@pytest.fixture(scope="module")
def mesh2_run():
    """A port-initialized TrainState carried into the JAX package (the
    port's init, with no JAX init to compile), and three JAX train steps
    from it with the state replicated and the batch sharded on a mesh of 2."""
    h = HiFiGANConfig.from_dict(TINY_H)
    fam = ModelFamily.MIX
    init = trainer.init_train_state(0, h, fam, disc_width_scale=DISC_WIDTH_SCALE, device="cpu",
                                    **CUT)
    g, mpd, msd = (jax.tree.map(jnp.asarray, tree_from_module(m))
                   for m in (init.generator, init.mpd, init.msd))
    jh = JaxHiFiGANConfig.from_dict(TINY_H)
    opt_g, opt_d = jax_trainer.make_optimizers(jh)
    jstate0 = jax_trainer.TrainState(g_params=g, mpd_params=mpd, msd_params=msd,
                                     opt_g=opt_g.init(g), opt_d=opt_d.init((mpd, msd)),
                                     steps=jnp.int32(0))
    batch = tiny_batch(h, 2, seed=3)
    step = jax_trainer.make_train_step(jh, JaxModelFamily.MIX, opt_g, opt_d)
    mesh = jax_make_mesh(n_data=2, n_pool=1)
    s = jax.device_put(jstate0, jax_replicated(mesh))
    b = {k: jax.device_put(jnp.asarray(v), jax_data_sharding(mesh)) for k, v in batch.items()}
    runs = []
    for _ in range(3):
        s, m = step(s, b)
        runs.append((s, {k: float(v) for k, v in m.items()}))
    return h, fam, jstate0, runs, batch


def _port_run(h, fam, jstate0, batch, mesh, n=3):
    state = carry(jstate0, h, fam)
    step = trainer.make_train_step(h, fam, mesh=mesh)
    tb = {k: torch.from_numpy(v) for k, v in batch.items()}
    return state, [{k: float(v) for k, v in step(state, tb).items()} for _ in range(n)]


@pytest.mark.parametrize("n_steps", [1, 3])
def test_dp_step_matches_jax_mesh2(mesh2_run, n_steps):
    h, fam, jstate0, runs, batch = mesh2_run
    state, got = _port_run(h, fam, jstate0, batch, make_mesh(2, 1, devices=CPU2), n_steps)
    for k in METRICS:
        np.testing.assert_allclose([m[k] for m in got], [m[k] for _, m in runs[:n_steps]],
                                   rtol=1e-4, err_msg=k)
    assert assert_state_close(state, runs[n_steps - 1][0]) > 50


def test_dp_step_matches_one_device_step(mesh2_run):
    """Mesh 2 against mesh None (the one-device step) on the same batch:
    the weighted shard gradients are the full batch's."""
    h, fam, jstate0, _, batch = mesh2_run
    one, m_one = _port_run(h, fam, jstate0, batch, None)
    two, m_two = _port_run(h, fam, jstate0, batch, make_mesh(2, 1, devices=CPU2))
    for k in METRICS:
        np.testing.assert_allclose([m[k] for m in m_two], [m[k] for m in m_one], rtol=1e-4,
                                   err_msg=k)
    n = sum(assert_tree_close(tree_from_module(a), tree_from_module(b), 1e-5)
            for a, b in ((two.generator, one.generator), (two.mpd, one.mpd),
                         (two.msd, one.msd)))
    assert n > 50


def test_dp_step_batch_of_four_over_two_shards(mesh2_run):
    """Two utterances per shard: mesh 2 against the one-device step, and
    the replicas left equal to the master after the G update is synced."""
    h, fam, jstate0, _, _ = mesh2_run
    batch = tiny_batch(h, 4, seed=5)
    one, m_one = _port_run(h, fam, jstate0, batch, None, n=2)
    two, m_two = _port_run(h, fam, jstate0, batch, make_mesh(2, 1, devices=CPU2), n=2)
    for k in METRICS:
        np.testing.assert_allclose([m[k] for m in m_two], [m[k] for m in m_one], rtol=1e-4,
                                   err_msg=k)
    assert_tree_close(tree_from_module(two.generator), tree_from_module(one.generator), 1e-5)
    assert two.steps == one.steps == 2


def test_shardings_place_parts_on_grid_rows():
    mesh = make_mesh(2, 1, devices=CPU2)
    x = torch.arange(12.0).reshape(4, 3)
    parts = data_sharding(mesh).put(x)
    assert [p.tolist() for p in parts] == [x[:2].tolist(), x[2:].tolist()]
    assert all(torch.equal(p, x) for p in replicated(mesh).put(x))
    assert data_sharding(mesh).devices == CPU2
    with pytest.raises(ValueError, match="does not split"):
        data_sharding(mesh).put(torch.zeros(3, 2))
