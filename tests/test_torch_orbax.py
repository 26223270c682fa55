"""knnsvc_torch's orbax checkpoints (io/orbax_ckpt.py over io/ocdbt.py,
io/zarr2.py and the zstd / CRC-32C codecs of csrc/orbax_io.cc) against the
JAX package's (orbax and tensorstore) on the CPU, at the tiny training
configs: JAX-written checkpoints restored by the port leaf for leaf, the
port's restored by JAX under its init_train_state template, retention and
steps, damaged files, the zstd decoder on libzstd's frames at several
levels, KnnSvc.load from an orbax-only directory, and the training loop's
orbax backend both ways."""

import glob
import json
import os
import shutil

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from knnsvc_tpu.config import HiFiGANConfig as JaxHiFiGANConfig
from knnsvc_tpu.io import orbax_ckpt as jax_orbax
from knnsvc_tpu.train.trainer import TrainState as JaxTrainState
from knnsvc_tpu.train.trainer import make_optimizers as jax_make_optimizers
from knnsvc_torch.config import HiFiGANConfig, ModelFamily, WavLMConfig
from knnsvc_torch.io import ocdbt, orbax_ckpt, zarr2
from knnsvc_torch.io.checkpoints import save_params
from knnsvc_torch.io.jax_params import optax_tree, train_state_from_jax, train_state_to_numpy
from knnsvc_torch.models.hifigan.discriminator import init_mpd_params, init_msd_params
from knnsvc_torch.models.hifigan.generator import init_generator_params
from knnsvc_torch.utils.layer_weights import generate_matrix_from_index

from test_torch_common import (DISC_WIDTH_SCALE, TINY_H, TINY_WAVLM, tiny_wavlm_params,
                               write_pair, write_sung_dataset)
from test_torch_common import one_torch_thread  # noqa: F401  (autouse)

STEP, EPOCH = 3, 2


def _jax_state(seed: int = 0, periods: int | None = 1, scales: int | None = 1):
    """A JAX TrainState (TINY_H, mix, the discriminators at DISC_WIDTH_SCALE)
    of numpy arrays, built as init_train_state builds it (JAX's TrainState
    and make_optimizers' optax states) from the port's seeded parameter
    trees, which are the JAX package's layout (jax.random's init compiles
    each distinct shape, tens of seconds on a CPU); with seeded Adam moments,
    counts, a learning rate and a step count."""
    gen = torch.Generator().manual_seed(seed)
    g = init_generator_params(HiFiGANConfig.from_dict(TINY_H), ModelFamily.MIX, gen,
                              weight_norm_parametrized=True)
    mpd = init_mpd_params(gen, width_scale=DISC_WIDTH_SCALE, n_periods=periods)
    msd = init_msd_params(gen, width_scale=DISC_WIDTH_SCALE, n_scales=scales)
    opt_g, opt_d = jax_make_optimizers(JaxHiFiGANConfig.from_dict(TINY_H))
    state = JaxTrainState(g, mpd, msd, jax.device_get(jax.jit(opt_g.init)(g)),
                          jax.device_get(jax.jit(opt_d.init)((mpd, msd))),
                          np.asarray(0, np.int32))
    rng = np.random.default_rng(seed)

    def moment(path, p, scale):
        # the spectral-norm buffers u / v_pow get no gradient: their moments stay 0
        if {"u", "v_pow"} & {getattr(k, "key", None) for k in path}:
            return np.zeros_like(p)
        return (scale * np.abs(rng.standard_normal(p.shape))).astype(np.float32)

    def moments(opt, count, lr):
        adam = opt.inner_state[0]
        fill = lambda scale: jax.tree_util.tree_map_with_path(  # noqa: E731
            lambda path, p: moment(path, p, scale), adam.mu)
        c = np.asarray(count, np.int32)
        opt = opt._replace(count=c, inner_state=(adam._replace(count=c, mu=fill(1e-3),
                                                               nu=fill(1e-6)),)
                           + tuple(opt.inner_state[1:]))
        opt.hyperparams["learning_rate"] = np.asarray(lr, np.float32)
        return opt

    return state._replace(opt_g=moments(state.opt_g, 7, 1.5e-4),
                          opt_d=moments(state.opt_d, 7, 1.25e-4), steps=np.asarray(7, np.int32))


def _plain(state) -> dict:
    """A JAX TrainState as the containers orbax restores without a template."""
    return {f: optax_tree(getattr(state, f)) for f in state._fields}


def _leaves(tree, prefix: str = "") -> dict:
    if isinstance(tree, dict):
        out = {}
        for k in tree:
            out.update(_leaves(tree[k], f"{prefix}{k}."))
        return out if tree else {prefix: "{}"}
    if hasattr(tree, "_fields"):
        return _leaves({f: getattr(tree, f) for f in tree._fields}, prefix) if tree._fields \
            else {prefix: None}
    if isinstance(tree, (list, tuple)):
        out = {}
        for i, v in enumerate(tree):
            out.update(_leaves(v, f"{prefix}{i}."))
        return out
    return {prefix: tree}


def assert_bit_equal(got, want):
    g, w = _leaves(got), _leaves(want)
    assert sorted(g) == sorted(w)
    for k in w:
        if w[k] is None or isinstance(w[k], str):
            assert g[k] == w[k], k
            continue
        a, b = np.asarray(g[k]), np.asarray(w[k])
        assert a.dtype == b.dtype and a.shape == b.shape, k
        assert a.tobytes() == b.tobytes(), k


@pytest.fixture(scope="module")
def jax_ckpts(tmp_path_factory):
    """JAX-written checkpoint directories: the current layout (state and
    epoch) and the legacy one (a bare state), and the state they hold."""
    import orbax.checkpoint as ocp

    root = tmp_path_factory.mktemp("jax_orbax")
    state = _jax_state()
    jax_orbax.save_train_state(str(root / "current"), STEP, state, epoch=EPOCH)
    with ocp.CheckpointManager(str(root / "legacy"), options=ocp.CheckpointManagerOptions(
            create=True)) as mngr:
        mngr.save(STEP, args=ocp.args.StandardSave(state))
        mngr.wait_until_finished()
    return root, state


@pytest.mark.parametrize("layout", ["current", "legacy"])
def test_jax_checkpoint_restores_bit_equal(jax_ckpts, layout):
    root, state = jax_ckpts
    want, step, epoch = jax_orbax.restore_train_state(str(root / layout), state)
    got, got_step, got_epoch = orbax_ckpt.restore_train_state(str(root / layout))
    assert (got_step, got_epoch) == (step, epoch) == (STEP, EPOCH if layout == "current" else 0)
    assert_bit_equal(got, _plain(want))
    # the port's own template: the same leaves, its containers
    again, _, _ = orbax_ckpt.restore_train_state(str(root / layout), template=got)
    assert_bit_equal(again, got)


def test_port_checkpoint_restores_in_jax(jax_ckpts, tmp_path):
    """A checkpoint the port writes (its TrainState carried across and
    back) restores in the JAX package under a template of JAX's TrainState."""
    root, state = jax_ckpts
    tree, _, _ = orbax_ckpt.restore_train_state(str(root / "current"))
    port = train_state_from_jax(tree, HiFiGANConfig.from_dict(TINY_H), ModelFamily.MIX)
    out = str(tmp_path / "port")
    orbax_ckpt.save_train_state(out, 11, train_state_to_numpy(port), epoch=4)
    got, step, epoch = jax_orbax.restore_train_state(out, _jax_state(seed=5))
    assert (step, epoch) == (11, 4)
    assert_bit_equal(_plain(got), _plain(state))


def test_retention_steps_and_template(tmp_path):
    tree = {"a": np.arange(6, dtype=np.float32).reshape(2, 3), "b": [np.int32(4), None],
            "c": {}, "d": torch.arange(4, dtype=torch.bfloat16)}
    d = str(tmp_path / "ck")
    with pytest.raises(FileNotFoundError):
        orbax_ckpt.restore_train_state(d)
    orbax_ckpt.save_train_state(d, 5, tree, keep=2, epoch=1)
    orbax_ckpt.save_train_state(d, 9, {**tree, "a": tree["a"] + 1}, keep=2, epoch=2)
    assert orbax_ckpt.checkpoint_steps(d) == [5, 9]
    state, step, epoch = orbax_ckpt.restore_train_state(d, step=5)
    assert (step, epoch) == (5, 1) and np.array_equal(state["a"], tree["a"])
    assert state["b"] == [np.int32(4), None] and state["c"] == {}
    assert state["d"].dtype == torch.bfloat16 and torch.equal(state["d"], tree["d"])
    orbax_ckpt.save_train_state(d, 12, tree, keep=1)
    assert orbax_ckpt.checkpoint_steps(d) == [12]
    assert not [n for n in os.listdir(d) if n != "12"]
    with pytest.raises(FileNotFoundError):
        orbax_ckpt.restore_train_state(d, step=9)
    _, step, _ = orbax_ckpt.restore_train_state(d, template={**tree, "b": (np.int32(0), None)})
    assert step == 12
    with pytest.raises(ValueError, match="template"):
        orbax_ckpt.restore_train_state(d, template={**tree, "a": np.zeros((3, 2), np.float32)})
    with pytest.raises(ValueError, match="template"):
        orbax_ckpt.restore_train_state(d, template={**tree, "a": tree["a"].astype(np.float64)})


def test_port_round_trip_keeps_optimizer_hyperparams(tmp_path):
    """optax stores the AdamW hyperparameters as float32; a port state saved
    and restored keeps the config's own (float64) lr, betas, eps and weight
    decay, so it steps as a state never saved does."""
    from knnsvc_torch.train.trainer import init_train_state

    h = HiFiGANConfig.from_dict(TINY_H)
    state = init_train_state(0, h, ModelFamily.MIX, disc_width_scale=DISC_WIDTH_SCALE,
                             disc_periods=1, disc_scales=1, device="cpu")
    orbax_ckpt.save_train_state(str(tmp_path), 0, train_state_to_numpy(state))
    tree, _, _ = orbax_ckpt.restore_train_state(str(tmp_path))
    restored = train_state_from_jax(tree, h, ModelFamily.MIX)
    def hyper(opt):
        return [{k: v for k, v in g.items() if k != "params"} for g in opt.param_groups]

    for got, want in ((restored.opt_g, state.opt_g), (restored.opt_d, state.opt_d)):
        assert hyper(got) == hyper(want)
        b2 = want.param_groups[0]["betas"][1]
        assert float(np.float32(b2)) != b2      # the float32 rounding would differ


def test_step_from_jax_checkpoint_matches_jax(jax_ckpts):
    """One train step from the JAX-written checkpoint (seeded moments, AdamW
    count 7, learning rates 1.5e-4 / 1.25e-4) in each package, on the same
    batch: the port restores it through its own reader, JAX through orbax;
    the metrics at rtol 1e-4 and the parameters, spectral-norm buffers and
    Adam moments at the train-step tests' atol 1e-5 (moments also rtol 1e-5);
    the port's lr, betas, eps and weight decay are JAX's float32 values and
    its AdamW count went from 7 to 8."""
    from knnsvc_tpu.config import ModelFamily as JaxModelFamily
    from knnsvc_tpu.train import trainer as jax_trainer
    from knnsvc_torch.train import trainer

    from test_torch_common import tiny_batch
    from test_torch_train_common import METRICS, assert_state_close

    root, state = jax_ckpts
    h, jh = HiFiGANConfig.from_dict(TINY_H), JaxHiFiGANConfig.from_dict(TINY_H)
    batch = tiny_batch(jh, 2, seed=3)
    jstate, _, _ = jax_orbax.restore_train_state(str(root / "current"), state)
    hyper = {opt: {k: np.asarray(v) for k, v in getattr(jstate, opt).hyperparams.items()}
             for opt in ("opt_g", "opt_d")}
    opt_g, opt_d = jax_make_optimizers(jh)
    jstep = jax_trainer.make_train_step(jh, JaxModelFamily.MIX, opt_g, opt_d)
    jstate, jmetrics = jstep(jstate, {k: jnp.asarray(v) for k, v in batch.items()})

    tree, _, _ = orbax_ckpt.restore_train_state(str(root / "current"))
    pstate = train_state_from_jax(tree, h, ModelFamily.MIX)
    got = trainer.make_train_step(h, ModelFamily.MIX)(
        pstate, {k: torch.from_numpy(v) for k, v in batch.items()})
    for k in METRICS:
        np.testing.assert_allclose(float(got[k]), float(jmetrics[k]), rtol=1e-4, err_msg=k)
    assert assert_state_close(pstate, jstate) > 100
    for opt in ("opt_g", "opt_d"):
        group, want = getattr(pstate, opt).param_groups[0], hyper[opt]
        got = {"learning_rate": group["lr"], "b1": group["betas"][0], "b2": group["betas"][1],
               "eps": group["eps"], "weight_decay": group["weight_decay"]}
        assert {k: np.float32(v) for k, v in got.items()} == {k: want[k] for k in got}, opt
        assert all(float(s["step"]) == 8.0 for s in getattr(pstate, opt).state.values())


@pytest.mark.parametrize("damage", ["node", "manifest", "chunk"])
def test_damaged_checkpoint_raises(jax_ckpts, tmp_path, damage):
    """A flipped byte in the root B-tree node or the manifest fails their
    CRC-32C; a data file cut short fails the chunk's read."""
    root, _ = jax_ckpts
    d = tmp_path / "ck"
    shutil.copytree(root / "current", d)
    item = d / str(STEP) / "default"
    if damage == "chunk":
        db = ocdbt.Database(str(item))
        ref = max((db.ref(k) for k in db.keys() if db.ref(k)), key=lambda r: r.length)
        with open(ref.file.path(str(item)), "r+b") as f:
            f.truncate(ref.offset + ref.length - 100)
        match = "ends before"
    else:
        path = str(item / "manifest.ocdbt") if damage == "manifest" else \
            glob.glob(str(item / "d" / "*"))[0]
        data = bytearray(open(path, "rb").read())
        data[len(data) // 2] ^= 0x10
        open(path, "wb").write(bytes(data))
        match = "CRC-32C"
    with pytest.raises(ValueError, match=match):
        orbax_ckpt.restore_train_state(str(d))


@pytest.mark.parametrize("level", [1, 3, 9, 19])
def test_zstd_decoder_matches_libzstd(tmp_path, level):
    """Arrays written through tensorstore's zarr driver (libzstd at
    `level`) into an OCDBT store, read back by the port: frames over
    128 KiB, a constant array (RLE), random bytes (raw blocks), a sung
    waveform, a multi-chunk int64 array with edge chunks, bfloat16."""
    import tensorstore as ts

    rng = np.random.default_rng(level)
    t = np.arange(120_000) / 16_000
    arrays = {
        "weights": (rng.standard_normal((300, 170)) * 0.02).astype(np.float32),
        "constant": np.full((70_000,), 0.25, np.float32),
        "random": rng.integers(0, 256, (200_000,), dtype=np.uint8),
        "sung": (0.3 * np.sin(2 * np.pi * 220 * t * (1 + 0.01 * np.sin(2 * np.pi * 5 * t)))
                 ).astype(np.float32),
        "tiled": np.arange(37 * 45, dtype=np.int64).reshape(37, 45),
        "bf16": (rng.standard_normal((64, 40)) * 3).astype(np.float32),
    }
    chunks = {"tiled": [16, 20]}
    for name, a in arrays.items():
        dtype = "bfloat16" if name == "bf16" else a.dtype.str
        store = ts.open({"driver": "zarr", "kvstore": {"driver": "ocdbt",
                                                       "base": f"file://{tmp_path}/"},
                         "path": name, "metadata": {
                             "compressor": {"id": "zstd", "level": level}, "dtype": dtype,
                             "shape": list(a.shape), "chunks": chunks.get(name, list(a.shape))}},
                        create=True).result()
        store.write(a.astype(jnp.bfloat16) if name == "bf16" else a).result()
    db = ocdbt.Database(str(tmp_path))

    def get(key):
        return db.read(key.encode()) if key.encode() in db else None

    for name, a in arrays.items():
        got = zarr2.read_array(get, name, zarr2.parse_zarray(get(f"{name}/.zarray")))
        if name == "bf16":
            want = torch.from_numpy(a.astype(jnp.bfloat16).view(np.int16)).view(torch.bfloat16)
            assert got.dtype == torch.bfloat16 and torch.equal(got, want)
        else:
            assert got.dtype == a.dtype and np.array_equal(got, a), name
    frame = get("weights/0.0")
    out = np.empty(arrays["weights"].nbytes, np.uint8)
    with pytest.raises(ValueError, match="zstd"):
        ocdbt.zstd_decode_into(frame[:-7], out)
    with pytest.raises(NotImplementedError, match="compressor"):
        zarr2.parse_zarray(json.dumps({"zarr_format": 2, "compressor": {"id": "blosc"},
                                       "shape": [1], "chunks": [1], "dtype": "<f4"}))
    with pytest.raises(NotImplementedError, match="order"):
        zarr2.parse_zarray(json.dumps({"zarr_format": 2, "order": "F", "compressor": None,
                                       "shape": [1], "chunks": [1], "dtype": "<f4"}))


@pytest.mark.parametrize("size", [0, 1, 255, 256, 65_791, 65_792, 300_000])
def test_zstd_frame_header_and_checksum(size):
    """The decoder on libzstd's frames (the zstandard module) of every
    Frame_Content_Size width (0/1, 2, 4 bytes) with and without the XXH64
    checksum, frames without a content size, concatenated and skippable
    frames; the port's raw-block frames read back by libzstd; a checksum or
    length mismatch, a truncated frame and a dictionary frame raise."""
    import zstandard

    rng = np.random.default_rng(size)
    data = (np.sin(np.arange(size) / 7.0) * 50 + rng.integers(0, 4, size)).astype(np.uint8)
    raw = data.tobytes()
    out = np.empty(size, np.uint8)
    for level in (1, 12):
        for checksum in (False, True):
            frame = zstandard.ZstdCompressor(level=level, write_checksum=checksum).compress(raw)
            ocdbt.zstd_decode_into(frame, out)
            assert out.tobytes() == raw
            assert ocdbt.zstd_decode(frame, size) == raw
    stream = zstandard.ZstdCompressor(level=3, write_content_size=False).compressobj()
    frame = stream.compress(raw[: size // 2]) + stream.flush()
    skippable = (0x184D2A53).to_bytes(4, "little") + (3).to_bytes(4, "little") + b"abc"
    frame += skippable + zstandard.ZstdCompressor(level=3).compress(raw[size // 2:])
    ocdbt.zstd_decode_into(frame, out)
    assert out.tobytes() == raw
    ours = ocdbt.zstd_frame(raw)
    assert zstandard.ZstdDecompressor().decompressobj().decompress(ours.tobytes()) == raw
    ocdbt.zstd_decode_into(ours, out)
    assert out.tobytes() == raw
    if size:
        damaged = ours.copy()
        damaged[-5] ^= 1                 # the last content byte: the checksum fails
        with pytest.raises(ValueError, match="checksum"):
            ocdbt.zstd_decode_into(damaged, out)
        with pytest.raises(ValueError, match="truncated"):
            ocdbt.zstd_decode_into(ours[:-6], out)
    with pytest.raises(ValueError):
        ocdbt.zstd_decode_into(ours, np.empty(size + 1, np.uint8))
    samples = [bytes(rng.integers(97, 101, 300, dtype=np.uint8)) for _ in range(64)]
    dictionary = zstandard.train_dictionary(1024, samples)
    with pytest.raises(ValueError, match="dictionary"):
        ocdbt.zstd_decode(zstandard.ZstdCompressor(dict_data=dictionary).compress(samples[0]),
                          1 << 20)


def test_knnsvc_load_serves_an_orbax_only_directory(jax_ckpts, tmp_path):
    """KnnSvc.load on a directory holding only orbax/ serves the newest
    step's generator: the same waveform as its .knnsvc.pkl twin."""
    from knnsvc_torch.hub import KnnSvc

    root, _ = jax_ckpts
    _, params = tiny_wavlm_params()
    save_params(str(tmp_path / "wavlm.knnsvc.pkl"), {"cfg": TINY_WAVLM, "model": params})
    (tmp_path / "config.json").write_text(json.dumps(TINY_H))
    shutil.copytree(root / "current", tmp_path / "orbax_only" / "orbax")
    tree, _, _ = orbax_ckpt.restore_train_state(str(root / "current"))
    (tmp_path / "pkl").mkdir()
    save_params(str(tmp_path / "pkl" / "g_mix_00000003.knnsvc.pkl"),
                {"generator": tree["g_params"]})
    src, ref = write_pair(tmp_path)
    kw = dict(wavlm_ckpt=str(tmp_path / "wavlm.knnsvc.pkl"),
              config_path=str(tmp_path / "config.json"), device="cpu")
    waves = []
    for d in ("orbax_only", "pkl"):
        knn = KnnSvc.load(str(tmp_path / d), "mix", **kw)
        knn.weighting = generate_matrix_from_index(1, size=3)
        waves.append(knn.convert_waveform(src, ref).numpy())
    assert np.abs(waves[1]).max() > 0 and waves[0].tobytes() == waves[1].tobytes()
    with pytest.raises(FileNotFoundError):
        KnnSvc.load(str(tmp_path / "pkl" / "none"), "mix", **kw)


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    """test_torch_train_loop.py's tiny training world, prematched by the port."""
    from knnsvc_torch.train.prematch import per_spk_extract

    root = tmp_path_factory.mktemp("orbax_world")
    _, params = tiny_wavlm_params()
    w = generate_matrix_from_index(1, size=3)
    notes = [(200.0, 51), (240.0, 52)]
    for split in ("train", "valid"):
        write_sung_dataset(root / split, {"spk0": notes})
        per_spk_extract(root / split, root / f"cached_{split}", params,
                        WavLMConfig.from_dict(TINY_WAVLM), w, w, device="cpu")
    return dict(audio_root_train=str(root / "train"), feat_root_train=str(root / "cached_train"),
                audio_root_valid=str(root / "valid"), feat_root_valid=str(root / "cached_valid"))


def test_train_orbax_backend_both_ways(world, tmp_path):
    """The port's train(checkpoint_backend='orbax') state restores in JAX
    bit-equal; a JAX-written orbax directory resumes in the port with its
    moments, AdamW step count, learning rate, step and epoch; and
    export_servable_checkpoint reads it."""
    from knnsvc_torch.io.checkpoints import load_params
    from knnsvc_torch.train.loop import export_servable_checkpoint, train

    h = HiFiGANConfig.from_dict(TINY_H)
    kw = dict(validation_interval=1, summary_interval=1, stdout_interval=100, with_harm=True,
              max_val_items=1, device="cpu", disc_width_scale=DISC_WIDTH_SCALE, val_artifacts=0,
              checkpoint_backend="orbax", **world)
    run1 = tmp_path / "run1"
    state = train(h, checkpoint_path=str(run1), training_epochs=1, max_steps=0, **kw)
    assert orbax_ckpt.checkpoint_steps(str(run1 / "orbax")) == [0] and not glob.glob(
        str(run1 / "g_*"))
    template = _jax_state(seed=1, periods=None, scales=None)
    restored, step, epoch = jax_orbax.restore_train_state(str(run1 / "orbax"), template)
    assert (step, epoch) == (0, 0) and int(restored.steps) == 1
    assert_bit_equal(_plain(restored), train_state_to_numpy(state))

    # JAX writes the next checkpoint: new moments, counts, learning rate
    jax_state = _jax_state(seed=3, periods=None, scales=None)
    jax_orbax.save_train_state(str(tmp_path / "jax" / "orbax"), 5, jax_state, epoch=1)
    resumed = train(h, checkpoint_path=str(tmp_path / "run2"), training_epochs=4, max_steps=5,
                    resume_from=str(tmp_path / "jax"), **kw)
    assert_bit_equal(train_state_to_numpy(resumed), _plain(jax_state))   # no step taken
    stepped = train(h, checkpoint_path=str(tmp_path / "run3"), training_epochs=4, max_steps=6,
                    resume_from=str(tmp_path / "jax"), **kw)
    log = [json.loads(line) for line in open(tmp_path / "run3" / "logs" / "train_log.jsonl")]
    assert [s["step"] for s in log if "loss_gen_total" in s] == [6] and stepped.steps == 8
    assert stepped.opt_g.param_groups[0]["lr"] == h.learning_rate * h.lr_decay ** 2  # epoch 2
    assert all(float(s["step"]) == 8.0 for s in stepped.opt_g.state.values())

    g_path, do_path = export_servable_checkpoint(str(tmp_path / "jax"), h, with_harm=True,
                                                 out_dir=str(tmp_path / "exported"))
    assert g_path.endswith("g_mix_00000005.knnsvc.pkl")
    assert_bit_equal(load_params(g_path)["generator"], _plain(jax_state)["g_params"])
    assert load_params(do_path)["epoch"] == 1
