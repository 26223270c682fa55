"""knnsvc_torch's prematch, its CLI and its training dataset on the CPU
against the JAX package, on tests/test_train_loop.py's tiny WavLM world fed
sung (vibrato) audio — pure tones leave the f0 re-rank to near-ties that
XLA and torch break differently (ROADMAP.md Queue 3). Each package
prematches its own copy of the dataset (f0 sidecars are written beside the
audio). Expected: pool.npy within one fp16 ulp, pool_harmonics.npy within
1e-5, nearest_nbrs_f0_priority exactly equal (int64), nearest_nbrs the same
sets in the same order but where a one-ulp pool difference swaps a
near-tie (and exactly equal when both search the same pool),
amp_ratio at rtol 1e-5, the smoothness weights at atol 3e-3
(tests/test_torch_smoothness.py's bound); MelDataset on the JAX-written
tree equals the JAX package's item for item with one worker, and the port's
batches are the same with 4 workers as with 0."""

import pickle
import shutil

import numpy as np
import pytest

from knnsvc_tpu.train.dataset import MelDataset as JaxMelDataset
from knnsvc_tpu.train.dataset import batch_iterator as jax_batch_iterator
from knnsvc_tpu.train.prematch import per_spk_extract as jax_per_spk_extract
from knnsvc_tpu.utils.layer_weights import generate_matrix_from_index
from knnsvc_torch.config import HiFiGANConfig, WavLMConfig
from knnsvc_torch.train.dataset import BATCH_KEYS, MelDataset, batch_iterator
from knnsvc_torch.train.prematch import per_spk_extract

from test_torch_common import TINY_H, TINY_WAVLM, tiny_wavlm_params, write_sung_dataset
from test_torch_common import one_torch_thread  # noqa: F401  (autouse)

SINGERS = {"alto": [(230.0, 31), (250.0, 32)], "tenor": [(160.0, 41), (175.0, 42)]}
FIELDS = ("slice", "nearest_nbrs", "nearest_nbrs_f0_priority", "harmonics_best_weight_para",
          "amp_ratio", "f0")


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    root = tmp_path_factory.mktemp("prematch")
    write_sung_dataset(root / "data_jax", SINGERS)
    shutil.copytree(root / "data_jax", root / "data_port")
    jcfg, params = tiny_wavlm_params()
    w = generate_matrix_from_index(1, size=3)
    jax_per_spk_extract(root / "data_jax", root / "out_jax", params, jcfg, w, w)
    per_spk_extract(root / "data_port", root / "out_port", params,
                    WavLMConfig.from_dict(TINY_WAVLM), w, w, device="cpu")
    return root, params


def _load(path):
    with open(path, "rb") as fh:
        return pickle.load(fh)


@pytest.mark.parametrize("singer", sorted(SINGERS))
def test_prematch_pools_match_jax(world, singer):
    root, _ = world
    want = np.load(root / "out_jax" / singer / "pool.npy")
    got = np.load(root / "out_port" / singer / "pool.npy")
    assert got.dtype == want.dtype == np.float32 and got.shape == want.shape
    ulp = np.spacing(np.maximum(np.abs(got), np.abs(want)).astype(np.float16)).astype(np.float32)
    assert np.all(np.abs(got - want) <= ulp)
    np.testing.assert_allclose(np.load(root / "out_port" / singer / "pool_harmonics.npy"),
                               np.load(root / "out_jax" / singer / "pool_harmonics.npy"), atol=1e-5)


@pytest.mark.parametrize("utt", [f"{s}/utt{i}" for s in sorted(SINGERS) for i in range(2)])
def test_prematch_pickles_match_jax(world, utt):
    root, _ = world
    want, got = _load(root / "out_jax" / f"{utt}.pt"), _load(root / "out_port" / f"{utt}.pt")
    assert set(got) == set(want) == set(FIELDS)
    assert tuple(got["slice"]) == tuple(want["slice"])
    s, e = got["slice"]
    for key in ("nearest_nbrs", "nearest_nbrs_f0_priority"):
        assert got[key].dtype == want[key].dtype == np.int64
    np.testing.assert_array_equal(got["nearest_nbrs_f0_priority"], want["nearest_nbrs_f0_priority"])
    # the pools differ by one fp16 ulp (2^-10 relative) in a few elements (5
    # of 1600 in this world), which can swap two neighbours whose distances
    # lie closer than that: every row holds the same 32 neighbours, and where
    # the order differs the JAX distances of the two sides differ by less
    # than 2^-10 (test_self_knn_matches_jax_on_one_pool holds the order
    # exactly when both packages search the same pool)
    pool = np.load(root / "out_jax" / utt.split("/")[0] / "pool.npy").astype(np.float64)
    unit = pool / np.linalg.norm(pool, axis=1, keepdims=True)
    for t, (a, b) in enumerate(zip(got["nearest_nbrs"], want["nearest_nbrs"])):
        assert set(a) == set(b)
        for i, j in zip(a[a != b], b[a != b]):
            d = 1 - unit[s + t] @ unit[[i, j]].T
            assert abs(d[0] - d[1]) < 2 ** -10, (t, i, j, d)
    # the utterance's own frames are masked out of its self-kNN
    assert not np.any((got["nearest_nbrs"] >= s) & (got["nearest_nbrs"] < e))
    np.testing.assert_allclose(got["amp_ratio"], want["amp_ratio"], rtol=1e-5)
    np.testing.assert_allclose(got["harmonics_best_weight_para"],
                               want["harmonics_best_weight_para"], atol=3e-3)
    np.testing.assert_array_equal(got["f0"], want["f0"])
    for key in FIELDS[1:]:
        assert isinstance(got[key], np.ndarray) and got[key].dtype == want[key].dtype


@pytest.mark.parametrize("singer", sorted(SINGERS))
def test_self_knn_matches_jax_on_one_pool(world, singer):
    """The masked self-kNN and the f0-priority re-sort on the JAX-written
    pool and f0: exactly JAX's indices, on every frame of every utterance."""
    import jax.numpy as jnp
    import torch

    from knnsvc_tpu.match.f0_logic import sort_by_f0_compatibility as jax_sort
    from knnsvc_tpu.train.prematch import self_knn_with_mask as jax_self_knn
    from knnsvc_torch.match.f0_logic import sort_by_f0_compatibility
    from knnsvc_torch.train.prematch import self_knn_with_mask

    root, _ = world
    pool = np.load(root / "out_jax" / singer / "pool.npy")   # == the matching pool (layer 1 both)
    utts = [_load(root / "out_jax" / singer / f"utt{i}.pt") for i in range(2)]
    f0_pool = np.concatenate([u["f0"] for u in utts])
    for u in utts:
        s, e = u["slice"]
        want = jax_self_knn(jnp.asarray(pool), s, e, pool[s:e])
        got = self_knn_with_mask(torch.from_numpy(pool), s, e, torch.from_numpy(pool[s:e]))
        np.testing.assert_array_equal(got, want)
        np.testing.assert_array_equal(got, u["nearest_nbrs"])
        want_f0 = np.asarray(jax_sort(jnp.asarray(u["f0"]), jnp.asarray(f0_pool),
                                      jnp.asarray(want.astype(np.int32))))
        got_f0 = sort_by_f0_compatibility(torch.from_numpy(u["f0"]), torch.from_numpy(f0_pool),
                                          torch.from_numpy(got)).numpy()
        np.testing.assert_array_equal(got_f0, want_f0)


def test_prematch_cli_matches_api(world, tmp_path):
    """cli.prematch on the tiny world (a {'cfg', 'model'} .knnsvc.pkl WavLM)
    writes what per_spk_extract wrote; a second run merges into the files."""
    from knnsvc_torch.cli.prematch import main
    from knnsvc_torch.io.checkpoints import save_params

    root, params = world
    save_params(str(tmp_path / "wavlm.knnsvc.pkl"), {"cfg": TINY_WAVLM, "model": params})
    argv = ["--librispeech_path", str(root / "data_port"), "--out_path", str(tmp_path / "out"),
            "--prematch", "--device", "cpu", "--matching_layer", "1", "--synthesis_layer", "1",
            "--wavlm_ckpt", str(tmp_path / "wavlm.knnsvc.pkl")]
    for _ in range(2):
        assert main(argv) == 0
    for singer in SINGERS:
        np.testing.assert_array_equal(np.load(tmp_path / "out" / singer / "pool.npy"),
                                      np.load(root / "out_port" / singer / "pool.npy"))
        for i in range(2):
            got = _load(tmp_path / "out" / singer / f"utt{i}.pt")
            want = _load(root / "out_port" / singer / f"utt{i}.pt")
            np.testing.assert_array_equal(got["nearest_nbrs"], want["nearest_nbrs"])
            np.testing.assert_array_equal(got["harmonics_best_weight_para"],
                                          want["harmonics_best_weight_para"])


def _assert_items_equal(got, want):
    for k in ("feats", "audio", "harmonics", "f0"):
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    np.testing.assert_allclose(got["mel_loss"], want["mel_loss"], atol=1e-5)


@pytest.mark.parametrize("split", [True, False])
def test_dataset_matches_jax_item_for_item(world, split):
    from knnsvc_tpu.config import HiFiGANConfig as JaxHiFiGANConfig

    root, _ = world
    h, jh = HiFiGANConfig.from_dict(TINY_H), JaxHiFiGANConfig.from_dict(TINY_H)
    kw = dict(split=split, seed=5)
    got = MelDataset(h, root / "data_jax", root / "out_jax", **kw)
    want = JaxMelDataset(jh, root / "data_jax", root / "out_jax", **kw)
    assert got.rows == want.rows and len(got) == 4
    for i in range(len(got)):
        a, b = got[i], want[i]
        assert a["path"] == b["path"]
        assert a["feats"].shape == ((TINY_H["segment_size"] // 320, 16) if split
                                    else b["feats"].shape)
        _assert_items_equal(a, b)
    # and as batches, one worker each
    got_b = list(batch_iterator(MelDataset(h, root / "data_jax", root / "out_jax", **kw), 2,
                                seed=3, num_workers=1))
    want_b = list(jax_batch_iterator(JaxMelDataset(jh, root / "data_jax", root / "out_jax", **kw),
                                     2, seed=3, num_workers=1))
    assert len(got_b) == len(want_b) == 2
    for a, b in zip(got_b, want_b):
        assert a["paths"] == b["paths"]
        _assert_items_equal(a, b)


def test_batches_do_not_depend_on_workers(world):
    """The draws happen on the calling thread in batch order, so a seed gives
    the same batches for any number of workers (the JAX loader's do not)."""
    root, _ = world
    h = HiFiGANConfig.from_dict(TINY_H)
    runs = [list(batch_iterator(MelDataset(h, root / "data_port", root / "out_port", seed=9),
                                2, seed=4, num_workers=n, prefetch=p))
            for n, p in ((0, 1), (4, 2), (4, 1))]
    for other in runs[1:]:
        assert [b["paths"] for b in other] == [b["paths"] for b in runs[0]]
        for a, b in zip(other, runs[0]):
            for k in BATCH_KEYS:
                np.testing.assert_array_equal(a[k], b[k], err_msg=k)
