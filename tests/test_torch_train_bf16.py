"""knnsvc_torch's bf16 train step (compute_dtype=torch.bfloat16: a cast of
the parameters and the batch but f0 and the mel target, fp32 master
weights and optimizer state) against the JAX package's bf16 step from the
same carried-across state and batch: two steps, the metrics finite and at
rtol 2e-2. The discriminators keep their first 2 periods and 2 scales
(every code path of the full topology, ~60% of its JAX compile time)."""

import numpy as np
import torch

import jax.numpy as jnp

from test_torch_common import one_torch_thread  # noqa: F401  (autouse)
from test_torch_train_common import METRICS, carry, jax_run, port_steps


def test_bf16_step_matches_jax():
    h, fam, jstate0, runs, batch = jax_run("mix", 2, compute_dtype=jnp.bfloat16, disc_periods=2,
                                             disc_scales=2)
    pstate = carry(jstate0, h, fam)
    got = port_steps(pstate, h, fam, batch, 2, compute_dtype=torch.bfloat16)
    for (_, want), mine in zip(runs, got):
        for k in METRICS:
            assert np.isfinite(mine[k])
            np.testing.assert_allclose(mine[k], want[k], rtol=2e-2, err_msg=k)
    assert all(p.dtype == torch.float32 for p in pstate.generator.parameters())
    assert all(v.dtype == torch.float32 for st in pstate.opt_g.state.values()
               for k, v in st.items() if k != "step")
