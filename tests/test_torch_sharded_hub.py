"""The multi-device matchers through the port's pair entry point against the
JAX package on the CPU: convert_pair(fast=True and False) with matcher
'sharded' (no_post_opt and post_opt_0.2) and 'sharded_int8', the port on a
mesh of eight logical CPU shards and JAX on its eight virtual devices, the
same parameters and f0 sidecars. Waveforms within 2 int16 codes of JAX's
(tests/test_torch_slice.py's bound), and equal to the port's own dense
matcher's where one exists (exact for 'sharded', the host-pool int8 for
'sharded_int8'): the sharded searches pick the dense ones' rows."""

import jax
import numpy as np
import pytest
import torch

from knnsvc_tpu.hub import KnnSvc as JaxKnnSvc
from knnsvc_torch.hub import KnnSvc
from knnsvc_torch.parallel import make_mesh
from knnsvc_torch.utils.layer_weights import generate_matrix_from_index

from test_torch_common import int16_codes, small_generator, small_wavlm, write_pair

MAX_CODE_DIFF = 2


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    root = tmp_path_factory.mktemp("torch_sharded_hub")
    cfg, jcfg, params = small_wavlm()
    h, jh, _, _, gen = small_generator("mix")
    w = generate_matrix_from_index(2, size=cfg.encoder_layers + 1)
    jknn = JaxKnnSvc(jax.tree.map(np.asarray, params), jcfg, gen, jh, "mix")
    knn = KnnSvc(params, cfg, gen, h, "mix", device="cpu")
    jknn.weighting = knn.weighting = w
    return root, knn, jknn, write_pair(root)


@pytest.mark.parametrize("fast", [True, False], ids=["fast", "host"])
@pytest.mark.parametrize("matcher,post_opt", [("sharded", "no_post_opt"),
                                              ("sharded", "post_opt_0.2"),
                                              ("sharded_int8", "no_post_opt")])
def test_convert_pair_sharded_matches_jax(world, fast, matcher, post_opt):
    root, knn, jknn, (src, ref) = world
    tag = f"{matcher}_{post_opt}_{fast}"
    mesh = make_mesh(1, 8, devices=[torch.device("cpu")] * 8)
    want = int16_codes(jknn.convert_pair(src, ref, fast=fast, matcher=matcher, post_opt=post_opt,
                                         output_path=str(root / f"jax_{tag}.wav")))
    got = int16_codes(knn.convert_pair(src, ref, fast=fast, matcher=matcher, post_opt=post_opt,
                                       mesh=mesh, output_path=str(root / f"torch_{tag}.wav")))
    assert got.shape == want.shape == (50 * 320,)
    assert np.abs(want).max() > 1000
    assert np.abs(got - want).max() <= MAX_CODE_DIFF
    dense = {"sharded": "exact", "sharded_int8": "int8"}[matcher]
    if fast and dense == "int8":
        return                     # the dense int8 pool is host-prepared: no fast form
    want_dense = int16_codes(knn.convert_pair(src, ref, fast=fast, matcher=dense,
                                              post_opt=post_opt,
                                              output_path=str(root / f"dense_{tag}.wav")))
    np.testing.assert_array_equal(got, want_dense)
