"""The rest of the JAX package's public surface in the port, on the CPU: the
same seeded numpy inputs (and JAX-initialised weights, carried over by
io/jax_params.py) through the JAX function and its port.

Tolerances: 2e-5 for the attention with a full (H, T, T) bias (the plain
version against the Pallas kernel in interpret mode, tests/test_ops.py's
bound); 1e-6 for the distances, the kNN's distances and the f0 helpers
(fp32 sums of the same terms in another order); kNN indices exact; the
discriminators and residual blocks within 1e-5 of each output's largest
value (fp32 convolutions, XLA's and oneDNN's sums in other orders); plots
pixel for pixel."""

import glob
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_common import DISC_WIDTH_SCALE, small_generator
from test_torch_common import one_torch_thread  # noqa: F401  (autouse)


def _close(got, want, rel=1e-5):
    """got within rel of want's largest magnitude, element by element."""
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    want = np.asarray(want)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, atol=rel * max(float(np.abs(want).max()), 1e-30))


@pytest.mark.parametrize("T", [96, 200])
@pytest.mark.parametrize("gate_value", [1.0, 0.0, -0.5])
def test_full_bias_attention_matches_pallas_kernel(T, gate_value):
    """A random (non-Toeplitz) bias; T=96 is block-aligned for block_q=96,
    T=200 is ragged (padded keys take no weight under a zero or negative
    gate). The wrapper on CPU tensors is the plain version and counts no
    launch."""
    from knnsvc_tpu.ops.attention import gated_bias_attention as jax_attention
    from knnsvc_torch.ops.attention import gated_bias_attention, reference_attention

    rng = np.random.default_rng(T)
    H, d = 4, 64
    q, k, v = (rng.standard_normal((H, T, d)).astype(np.float32) for _ in range(3))
    bias = rng.standard_normal((H, T, T)).astype(np.float32)
    gate = np.full((H, T), gate_value, np.float32)
    want = np.asarray(jax_attention(*map(jnp.asarray, (q, k, v, bias, gate)), block_q=96,
                                    interpret=True))
    args = [torch.from_numpy(a) for a in (q, k, v, bias, gate)]
    got = reference_attention(*args)
    np.testing.assert_allclose(got.numpy(), want, atol=2e-5)
    before = gated_bias_attention.launches
    assert torch.equal(gated_bias_attention(*args), got)
    assert gated_bias_attention.launches == before
    with pytest.raises(ValueError):          # the diagonal table takes the other entry
        gated_bias_attention(*args[:3], torch.zeros(H, 2 * T - 1), args[4])


def _features(seed, *shape):
    return np.random.default_rng(seed).standard_normal(shape).astype(np.float32)


@pytest.mark.parametrize("weighted", [False, True])
def test_weighted_cosine_distance_matches_jax(weighted):
    """Zero rows (source, pool, and a zero weight row) give 2.0, as does a
    NaN source row; the weighted pool norms are one (Q, P) product."""
    from knnsvc_tpu.match.distance import weighted_cosine_distance as jax_wcd
    from knnsvc_torch.match.distance import weighted_cosine_distance

    src, pool = _features(1, 9, 24), _features(2, 13, 24)
    src[2] = 0.0
    pool[5] = 0.0
    src[6] = np.nan
    weights = None
    if weighted:
        weights = np.abs(_features(3, 9, 24))
        weights[4] = 0.0
    want = np.asarray(jax_wcd(jnp.asarray(src), jnp.asarray(pool),
                              None if weights is None else jnp.asarray(weights)))
    got = weighted_cosine_distance(torch.from_numpy(src), torch.from_numpy(pool),
                                   None if weights is None else torch.from_numpy(weights))
    np.testing.assert_allclose(got.numpy(), want, atol=1e-6)
    assert (got[2] == 2.0).all() and (got[:, 5] == 2.0).all() and (got[6] == 2.0).all()
    if weighted:
        assert (got[4] == 2.0).all()


@pytest.mark.parametrize("eps", [0.0, 1e-3, 0.5])
def test_cosine_distance_eps_matches_jax(eps):
    from knnsvc_tpu.match.distance import cosine_distance as jax_cd
    from knnsvc_torch.match.distance import cosine_distance

    src, pool = _features(4, 7, 16) * 0.05, _features(5, 11, 16)
    src[0] = 0.0
    want = np.asarray(jax_cd(jnp.asarray(src), jnp.asarray(pool), eps=eps))
    got = cosine_distance(torch.from_numpy(src), torch.from_numpy(pool), eps=eps)
    np.testing.assert_allclose(got.numpy(), want, atol=1e-6)


@pytest.mark.parametrize("masked", [False, True])
def test_knn_cosine_similarity_matches_jax(masked):
    """Inputs rounded through fp16; a retain mask adds 1 - mask; two equal
    pool rows tie and keep ascending pool order, as lax.top_k does."""
    from knnsvc_tpu.match.knn import knn_cosine_similarity as jax_knn
    from knnsvc_torch.match.knn import knn_cosine_similarity

    src, tgt = _features(6, 20, 32), _features(7, 50, 32)
    tgt[31] = tgt[30]
    src[3] = tgt[30] * 1.5
    mask = (np.random.default_rng(8).random((20, 50)) < 0.7).astype(np.float32) if masked \
        else None
    if masked:
        mask[3, 30:32] = 1.0
    want_idx, want_d = jax_knn(src, tgt, mask, k=8)
    got_idx, got_d = knn_cosine_similarity(torch.from_numpy(src), torch.from_numpy(tgt),
                                           None if mask is None else torch.from_numpy(mask), k=8)
    np.testing.assert_array_equal(got_idx.numpy(), np.asarray(want_idx))
    np.testing.assert_allclose(got_d.numpy(), np.asarray(want_d), atol=1e-6)
    assert got_idx[3, :2].tolist() == [30, 31]


def test_f0_helpers_match_jax():
    """compute_shift (an even candidate count: the lower median), smoothen_f0
    (host numpy, from an array or a tensor) and interp_f0_candidates (its
    (B, B, N) broadcast, as the JAX function gives it)."""
    from knnsvc_tpu.match import f0_logic as jax_f0
    from knnsvc_torch.match import f0_logic

    rng = np.random.default_rng(9)
    T, P, k = 40, 60, 4
    query_f0 = (rng.random(T) * 200 + 100).astype(np.float32)
    query_f0[::7] = 0.0
    f0_list = (rng.random(P) * 300 + 80).astype(np.float32)
    f0_list[rng.random(P) < 0.3] = 0.0
    idx = rng.integers(0, P, (T, k)).astype(np.int64)
    want = float(jax_f0.compute_shift(jnp.asarray(query_f0), jnp.asarray(f0_list),
                                      jnp.asarray(idx, jnp.int32)))
    got = f0_logic.compute_shift(*map(torch.from_numpy, (query_f0, f0_list, idx)))
    assert got.dim() == 0
    np.testing.assert_allclose(float(got), want, rtol=1e-6)
    unvoiced = np.zeros(P, np.float32)
    assert float(f0_logic.compute_shift(torch.from_numpy(query_f0), torch.from_numpy(unvoiced),
                                        torch.from_numpy(idx))) == 1.0

    track = (rng.random(200) * 100 + 150).astype(np.float32)
    slices = [(0.2, 0.5), (1.0, 0.9), (3.5, 9.0), (2.0, 2.3)]
    want_s = jax_f0.smoothen_f0(track, slices)
    np.testing.assert_array_equal(f0_logic.smoothen_f0(track, slices), want_s)
    got_s = f0_logic.smoothen_f0(torch.from_numpy(track), slices, frame_per_second=50)
    assert isinstance(got_s, np.ndarray)
    np.testing.assert_array_equal(got_s, want_s)

    B, F, N = 3, 6, 5
    xp = np.sort(rng.random((B, F)) * 400 + 60, axis=1).astype(np.float32)
    x = np.array([50.0, 200.0, 470.0], np.float32)      # below, inside and above the grid
    fp = rng.standard_normal((B, F, N)).astype(np.float32)
    want_i = np.asarray(jax_f0.interp_f0_candidates(*map(jnp.asarray, (x, xp, fp))))
    got_i = f0_logic.interp_f0_candidates(*map(torch.from_numpy, (x, xp, fp)))
    assert got_i.shape == want_i.shape == (B, B, N)
    np.testing.assert_allclose(got_i.numpy(), want_i, atol=1e-6, rtol=1e-6)


def test_scan_checkpoint_matches_jax(tmp_path):
    from knnsvc_tpu.hub import scan_checkpoint as jax_scan
    from knnsvc_torch.hub import scan_checkpoint

    for name in ("g_00000002_mix.knnsvc.pkl", "g_00000010_mix.knnsvc.pkl", "do_00000010_mix",
                 "g_00000005_wavlm_only.pt", "config.json"):
        (tmp_path / name).write_bytes(b"")
    for sub in ("mix", "wavlm_only", "g_", "do_", "absent"):
        assert scan_checkpoint(str(tmp_path), sub) == jax_scan(str(tmp_path), sub)
    assert scan_checkpoint(str(tmp_path), "g_") == str(tmp_path / "g_00000010_mix.knnsvc.pkl")
    assert scan_checkpoint(str(tmp_path), "absent") is None
    assert len(glob.glob(os.path.join(tmp_path, "*"))) == 5


@pytest.mark.parametrize("n_data,n_pool", [(1, 4), (2, 2)])
def test_pool_sharding_matches_jax(n_data, n_pool):
    """Grid position (d, p) holds the p-th block of the rows, the same on
    every grid row: JAX's NamedSharding(mesh, P('pool')) on a CPU mesh of
    the same shape, and the port's shard_rows."""
    from knnsvc_tpu.parallel.mesh import make_mesh as jax_make_mesh
    from knnsvc_tpu.parallel.mesh import pool_sharding as jax_pool_sharding
    from knnsvc_torch.parallel.mesh import make_mesh, pool_sharding, shard_rows

    x = np.arange(12 * 3, dtype=np.float32).reshape(12, 3)
    jmesh = jax_make_mesh(n_data, n_pool, devices=jax.devices()[:4])
    placed = jax.device_put(jnp.asarray(x), jax_pool_sharding(jmesh))
    by_device = {shard.device: np.asarray(shard.data) for shard in placed.addressable_shards}
    mesh = make_mesh(n_data, n_pool, devices=[torch.device("cpu")] * 4)
    sharding = pool_sharding(mesh)
    parts = sharding.put(torch.from_numpy(x))
    assert len(parts) == len(sharding.devices) == 4
    blocks = shard_rows(torch.from_numpy(x), mesh)
    for d in range(n_data):
        for p in range(n_pool):
            part = parts[d * n_pool + p]
            np.testing.assert_array_equal(part.numpy(), by_device[jmesh.devices[d, p]])
            assert torch.equal(part, blocks[d][p])
    with pytest.raises(ValueError, match="does not split"):
        sharding.put(torch.zeros(n_pool + 1, 2))


def test_resblock_functional_forms_match_jax():
    """resblock{1,2,3}_apply on the small vocoder's JAX-initialised blocks
    (io/jax_params.generator_from_numpy), against the JAX functions; the
    ResBlock2 is a ResBlock1's first convs, as test_torch_common builds
    one. A kernel size or dilations other than the block's raise."""
    from knnsvc_tpu.models.hifigan import layers as jax_layers
    from knnsvc_torch.io.jax_params import generator_from_numpy
    from knnsvc_torch.models.hifigan import layers

    h, _, fam, _, params = small_generator("mix")
    dec = generator_from_numpy(params, h, fam).dec
    k, dil = h.resblock_kernel_sizes[0], tuple(h.resblock_dilation_sizes[0])
    block1, tree1 = dec.resblocks[0], params["dec"]["resblocks"][0]
    ch = block1.convs1[0].in_channels
    block2 = layers.ResBlock2(ch, k, dil)
    block2.convs = block1.convs1
    x = np.random.default_rng(10).standard_normal((1, ch, 37)).astype(np.float32)
    for block, tree, name in ((block1, tree1, "resblock1_apply"),
                              (block2, {"convs": tree1["convs1"]}, "resblock2_apply")):
        want = jax.jit(getattr(jax_layers, name), static_argnames=("kernel_size", "dilations"))(
            jnp.asarray(x), tree, k, dil)
        with torch.no_grad():
            _close(getattr(layers, name)(torch.from_numpy(x), block, k, dil), want)
        with pytest.raises(ValueError):
            getattr(layers, name)(torch.from_numpy(x), block, k + 2, dil)
    block3, tree3 = dec.resblocks_downs[0], params["dec"]["resblocks_downs"][0]
    x = np.random.default_rng(11).standard_normal((1, block3.convs[0].in_channels, 29))
    x = x.astype(np.float32)
    with torch.no_grad():
        got = layers.resblock3_apply(torch.from_numpy(x), block3)
    _close(got, jax.jit(jax_layers.resblock3_apply)(jnp.asarray(x), tree3))
    with pytest.raises(ValueError):
        layers.resblock3_apply(torch.from_numpy(x), block3, dilation=2)


def _jax_discriminators(weight_norm_parametrized: bool):
    from knnsvc_tpu.models.hifigan.discriminator import init_mpd_params, init_msd_params

    static = ("weight_norm_parametrized", "width_scale", "n_periods")
    mpd = jax.jit(init_mpd_params, static_argnames=static)(
        jax.random.PRNGKey(5), weight_norm_parametrized, width_scale=DISC_WIDTH_SCALE,
        n_periods=2)
    msd = jax.jit(init_msd_params, static_argnames=static[:2] + ("n_scales",))(
        jax.random.PRNGKey(6), weight_norm_parametrized, width_scale=DISC_WIDTH_SCALE,
        n_scales=2)
    return jax.tree.map(np.asarray, mpd), jax.tree.map(np.asarray, msd)


def test_discriminator_functional_forms_match_jax():
    """discriminator_p_apply (the default stride and another) and
    discriminator_s_apply (a weight-normed scale; the spectral-normed scale
    after its power-iteration step) on JAX-initialised weights."""
    from knnsvc_tpu.models.hifigan import discriminator as jax_disc
    from knnsvc_torch.io.jax_params import discriminators_from_numpy
    from knnsvc_torch.models.hifigan import discriminator

    mpd_p, msd_p = _jax_discriminators(True)
    mpd, msd = discriminators_from_numpy(mpd_p, msd_p)
    x = (np.random.default_rng(11).standard_normal((2, 1, 641)) * 0.3).astype(np.float32)
    tx, jx = torch.from_numpy(x), jnp.asarray(x)
    jit_p = jax.jit(jax_disc.discriminator_p_apply, static_argnames=("period", "stride"))
    for i, period, stride in ((0, 2, 3), (1, 3, 3), (0, 2, 2)):
        want_logits, want_fmap = jit_p(mpd_p["discriminators"][i], period, jx, stride=stride)
        with torch.no_grad():
            logits, fmap = discriminator.discriminator_p_apply(mpd.discriminators[i], period, tx,
                                                               stride=stride)
        _close(logits, want_logits)
        for g, w in zip(fmap, want_fmap, strict=True):
            _close(g, w)

    jit_s = jax.jit(jax_disc.discriminator_s_apply, static_argnames="update_sn")
    for i, update_sn in ((1, False), (0, True)):
        want_logits, want_fmap, want_params = jit_s(msd_p["discriminators"][i], jx,
                                                    update_sn=update_sn)
        with torch.no_grad():
            logits, fmap, module = discriminator.discriminator_s_apply(
                msd.discriminators[i], tx, update_sn=update_sn)
        assert module is msd.discriminators[i]
        _close(logits, want_logits)
        for g, w in zip(fmap, want_fmap, strict=True):
            _close(g, w)
        if update_sn:
            sn = module.convs[0].parametrizations.weight[0]
            np.testing.assert_allclose(sn.u.numpy(), want_params["convs"][0]["u"], atol=1e-6)


def test_discriminator_inits_give_effective_weights():
    """weight_norm_parametrized=False: the JAX package's tree layout ({"w"}
    where weight norm was, the spectral-normed scale unchanged), the live
    init's v as each weight (g = ||v||, so g v / ||v|| = v), and the same
    discriminator outputs as the live trees."""
    from knnsvc_torch.io.jax_params import discriminators_from_numpy
    from knnsvc_torch.models.hifigan.discriminator import init_mpd_params, init_msd_params

    want_trees = _jax_discriminators(False)
    kw = dict(width_scale=DISC_WIDTH_SCALE)
    live = (init_mpd_params(torch.Generator().manual_seed(2), n_periods=2, **kw),
            init_msd_params(torch.Generator().manual_seed(3), n_scales=2, **kw))
    plain = (init_mpd_params(torch.Generator().manual_seed(2), False, n_periods=2, **kw),
             init_msd_params(torch.Generator().manual_seed(3), False, n_scales=2, **kw))

    def layout(tree):
        return jax.tree_util.tree_structure(tree), [a.shape for a in jax.tree.leaves(tree)]

    def weights(tree):
        """Each conv's weight: w, or v of a live weight norm, or v_sn."""
        if isinstance(tree, dict) and "b" in tree:
            return [tree.get("w", tree.get("v", tree.get("v_sn")))]
        subs = tree.values() if isinstance(tree, dict) else tree
        return [w for sub in subs for w in weights(sub)]

    for got, want, wn in zip(plain, want_trees, live):
        assert layout(got) == layout(want)
        assert len(weights(got)) == len(weights(wn)) > 10
        for w_plain, w_live in zip(weights(got), weights(wn)):
            np.testing.assert_array_equal(w_plain, w_live)
    y = torch.from_numpy(_features(12, 1, 1, 960) * 0.3)
    with torch.no_grad():
        for a, b in zip(discriminators_from_numpy(*plain), discriminators_from_numpy(*live)):
            for got, want in zip(a(y, -y)[0], b(y, -y)[0]):
                _close(got, want.numpy())


def test_generator_harm_apply_takes_kernel_size():
    from knnsvc_torch.io.jax_params import generator_harm_from_numpy
    from knnsvc_torch.models.hifigan.harm_head import (generator_harm_apply,
                                                       init_generator_harm_params)

    model = generator_harm_from_numpy(init_generator_harm_params(
        torch.Generator().manual_seed(0), 16, 5, n_layers=2, kernel_size=5))
    f0 = torch.full((1, 6, 1), 220.0)
    harm = torch.from_numpy(_features(13, 1, 16, 6))
    with torch.no_grad():
        assert torch.equal(generator_harm_apply(model, f0, harm, kernel_size=5), model(f0, harm))
    with pytest.raises(ValueError, match="kernel size"):
        generator_harm_apply(model, f0, harm)           # the default 3 is not this head's


@pytest.mark.parametrize("plot", ["plot_matrix", "plot_multi_sequences"])
def test_plots_match_jax_pixels(plot, tmp_path):
    """The same matplotlib calls: PNGs equal pixel for pixel, the port's
    drawn from tensors, JAX's from numpy arrays."""
    import matplotlib.image as mpimg

    from knnsvc_tpu.utils import plotting as jax_plotting
    from knnsvc_torch.utils import plotting

    rng = np.random.default_rng(14)
    if plot == "plot_matrix":
        mat = rng.integers(0, 50, (8, 30)).astype(np.float32)
        cols = [0.02 * i for i in range(30)]
        kw = dict(col_names=cols, title="picks", x_axis="s", y_axis="k")
        want = jax_plotting.plot_matrix(mat, out_path=str(tmp_path / "jax.png"), **kw)
        got = plotting.plot_matrix(torch.from_numpy(mat), out_path=str(tmp_path / "port.png"),
                                   **kw)
    else:
        x = np.arange(40, dtype=np.float32)
        ys = [np.sin(x / 5), np.cos(x / 7)]
        kw = dict(title="f0", x_axis="frame", y_axis="Hz")
        want = jax_plotting.plot_multi_sequences(x, ys, ["a", "b"],
                                                 out_path=str(tmp_path / "jax.png"), **kw)
        got = plotting.plot_multi_sequences(torch.from_numpy(x),
                                            [torch.from_numpy(y) for y in ys], ["a", "b"],
                                            out_path=str(tmp_path / "port.png"), **kw)
    assert got == str(tmp_path / "port.png") and want == str(tmp_path / "jax.png")
    np.testing.assert_array_equal(mpimg.imread(got), mpimg.imread(want))
