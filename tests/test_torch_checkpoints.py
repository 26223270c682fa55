"""knnsvc_torch.io.checkpoints against the JAX package's converters on the
CPU. No checkpoint is in the repository, so each test builds a seeded
random state dict in the reference's key layout (WavLM-Large.pt's {'cfg',
'model'}, HiFi-GAN g_*.pt's {'generator'}; weight-normed convs as
weight_g / weight_v), saves it with torch.save, and loads it with both
packages: the numpy trees must be identical, and the port's models built
from them must match the JAX models at the existing tolerances (WavLM
features and waveforms within 2e-4, tests/test_torch_wavlm.py and
test_torch_dsp.py). Then KnnSvc.load and the CLI read such a directory."""

import json

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from knnsvc_tpu.io.checkpoints import load_hifigan_checkpoint as jax_load_hifigan
from knnsvc_tpu.io.checkpoints import load_wavlm_checkpoint as jax_load_wavlm
from knnsvc_tpu.models.hifigan.generator import vocode
from knnsvc_tpu.models.wavlm.model import wavlm_extract_layer
from knnsvc_torch.cli.inference import main
from knnsvc_torch.hub import KnnSvc
from knnsvc_torch.io.checkpoints import fold_weight_norm, load_hifigan_checkpoint, load_wavlm_checkpoint
from knnsvc_torch.io.jax_params import generator_from_numpy, wavlm_from_numpy

from test_torch_common import SMALL_HIFIGAN, SMALL_WAVLM, _sing, small_generator, small_wavlm

RESBLOCK2 = {"resblock": "2", "resblock_kernel_sizes": (3,), "resblock_dilation_sizes": ((1, 3),)}


def _t(a) -> torch.Tensor:
    return torch.from_numpy(np.array(a, np.float32, order="C"))


def wavlm_state_dict(params, cfg, seed: int = 0) -> dict:
    """The reference WavLM state_dict of a pytree: Linear weights (out, in),
    the positional conv weight-normed over dim 2, random norm affines."""
    rng = np.random.default_rng(seed)
    sd = {}

    def norm(key, dim):
        sd[key + ".weight"] = _t(1 + 0.1 * rng.standard_normal(dim))
        sd[key + ".bias"] = _t(0.1 * rng.standard_normal(dim))

    def lin(key, p):
        sd[key + ".weight"] = _t(np.asarray(p["w"]).T)
        if "b" in p:
            sd[key + ".bias"] = _t(p["b"])

    for i, blk in enumerate(params["feature_extractor"]["layers"]):
        pre = f"feature_extractor.conv_layers.{i}"
        sd[pre + ".0.weight"] = _t(blk["conv"]["w"])
        if "b" in blk["conv"]:
            sd[pre + ".0.bias"] = _t(blk["conv"]["b"])
        norm(pre + ".2.1", blk["conv"]["w"].shape[0])
    enc = params["encoder"]
    v = np.asarray(enc["pos_conv"]["w"])
    sd["encoder.pos_conv.0.weight_v"] = _t(v)
    sd["encoder.pos_conv.0.weight_g"] = _t(0.5 + rng.random((1, 1, v.shape[2])))
    sd["encoder.pos_conv.0.bias"] = _t(enc["pos_conv"]["b"])
    norm("layer_norm", params["layer_norm"]["scale"].shape[0])
    norm("encoder.layer_norm", enc["layer_norm"]["scale"].shape[0])
    lin("post_extract_proj", params["post_extract_proj"])
    L = enc["layers"]
    take = lambda p, i: {k: np.asarray(x)[i] for k, x in p.items()}  # noqa: E731
    for i in range(cfg.encoder_layers):
        pre = f"encoder.layers.{i}"
        for name, key in (("q", "q_proj"), ("k", "k_proj"), ("v", "v_proj"), ("out", "out_proj")):
            lin(f"{pre}.self_attn.{key}", take(L["attn"][name], i))
        lin(f"{pre}.self_attn.grep_linear", take(L["attn"]["grep"], i))
        sd[f"{pre}.self_attn.grep_a"] = _t(
            1 + 0.1 * rng.standard_normal((1, cfg.encoder_attention_heads, 1, 1)))
        lin(f"{pre}.fc1", take(L["fc1"], i))
        lin(f"{pre}.fc2", take(L["fc2"], i))
        norm(f"{pre}.self_attn_layer_norm", cfg.encoder_embed_dim)
        norm(f"{pre}.final_layer_norm", cfg.encoder_embed_dim)
    sd["encoder.layers.0.self_attn.relative_attention_bias.weight"] = _t(enc["rel_attn_bias"])
    return sd


def hifigan_state_dict(params, seed: int = 1) -> dict:
    """The reference generator state_dict of a pytree: conv_pre, ups,
    resblocks, conv_post and downs weight-normed over dim 0 (g = a random
    positive scale per output row), the others plain; lin_pre (out, in)."""
    rng = np.random.default_rng(seed)
    sd = {}
    original = "sin_prenet" not in params
    pre = "" if original else "dec."

    def conv(key, p, wn):
        w = np.asarray(p["w"])
        if wn:
            sd[key + ".weight_v"] = _t(w)
            sd[key + ".weight_g"] = _t(0.5 + rng.random((w.shape[0], 1, 1)))
        else:
            sd[key + ".weight"] = _t(w)
        if "b" in p:
            sd[key + ".bias"] = _t(np.asarray(p["b"]) + 0.01 * rng.standard_normal(w.shape[1 if key.startswith(pre + "ups") else 0]))

    dec = params["dec"]
    conv(pre + "conv_pre", dec["conv_pre"], True)
    for i, p in enumerate(dec["ups"]):
        conv(f"{pre}ups.{i}", p, True)
    for i, rb in enumerate(dec["resblocks"]):
        for name, convs in rb.items():
            for j, p in enumerate(convs):
                conv(f"{pre}resblocks.{i}.{name}.{j}", p, True)
    conv(pre + "conv_post", dec["conv_post"], True)
    if original:
        return sd
    sd["dec.lin_pre.weight"] = _t(np.asarray(dec["lin_pre"]["w"]).T)
    sd["dec.lin_pre.bias"] = _t(dec["lin_pre"]["b"])
    for i, p in enumerate(dec["downs"]):
        conv(f"dec.downs.{i}", p, True)
    for i, rb in enumerate(dec["resblocks_downs"]):
        conv(f"dec.resblocks_downs.{i}.convs.0", rb["convs"][0], True)
    conv("dec.concat_pre", dec["concat_pre"], False)
    for i, p in enumerate(dec["concat_conv"]):
        conv(f"dec.concat_conv.{i}", p, False)
    conv("sin_prenet", params["sin_prenet"], False)
    return sd


def assert_same_tree(a, b, path="") -> None:
    assert type(a) is type(b) or (isinstance(a, np.ndarray) and isinstance(b, np.ndarray)), path
    if isinstance(a, dict):
        assert sorted(a) == sorted(b), path
        for k in a:
            assert_same_tree(a[k], b[k], f"{path}/{k}")
    elif isinstance(a, (list, tuple)):
        assert len(a) == len(b), path
        for i, (x, y) in enumerate(zip(a, b)):
            assert_same_tree(x, y, f"{path}/{i}")
    else:
        assert a.dtype == b.dtype and a.shape == b.shape, path
        np.testing.assert_array_equal(a, b, err_msg=path)


def test_fold_weight_norm_matches_torch():
    rng = np.random.default_rng(2)
    conv = torch.nn.utils.parametrizations.weight_norm(torch.nn.Conv1d(4, 6, 3))
    with torch.no_grad():
        conv.parametrizations.weight.original1.copy_(_t(rng.standard_normal((6, 4, 3))))
        conv.parametrizations.weight.original0.copy_(_t(0.5 + rng.random((6, 1, 1))))
    want = conv.weight.detach().numpy()
    got = fold_weight_norm(conv.parametrizations.weight.original0.detach().numpy(),
                           conv.parametrizations.weight.original1.detach().numpy(), dim=0)
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-7)


def test_wavlm_checkpoint_matches_jax(tmp_path):
    cfg, jcfg, params = small_wavlm()
    path = str(tmp_path / "WavLM-Large.pt")
    torch.save({"cfg": dict(SMALL_WAVLM), "model": wavlm_state_dict(params, cfg)}, path)
    got, got_cfg = load_wavlm_checkpoint(path)
    want, want_cfg = jax_load_wavlm(path)
    assert got_cfg == cfg and want_cfg == jcfg
    assert_same_tree(got, want)

    wav = np.pad(_sing(16000, 1.2, 220, seed=4), (0, 320))[None]
    ref = np.asarray(wavlm_extract_layer(want, jcfg, jnp.asarray(wav), 3))
    with torch.no_grad():
        out = wavlm_from_numpy(got, got_cfg).extract_layer(torch.from_numpy(wav), 3).numpy()
    np.testing.assert_allclose(out, ref, atol=2e-4)


@pytest.mark.parametrize("ckpt_type,overrides", [
    ("mix", None), ("wavlm_only", None), ("wavlm_only_original", None),
    ("wavlm_only", RESBLOCK2)], ids=["mix", "wavlm_only", "original", "wavlm_only-resblock2"])
def test_hifigan_checkpoint_matches_jax(tmp_path, ckpt_type, overrides):
    h, jh, fam, jfam, params = small_generator(ckpt_type, overrides=overrides)
    path = str(tmp_path / f"g_00000001_{ckpt_type}.pt")
    torch.save({"generator": hifigan_state_dict(params)}, path)
    got = load_hifigan_checkpoint(path, h, fam)
    want = jax_load_hifigan(path, jh, jfam)
    assert_same_tree(got, want)
    live = load_hifigan_checkpoint(path, h, fam, fold=False)      # {'g', 'v'} kept live
    assert "g" in live["dec"]["ups"][0] and "w" not in live["dec"]["ups"][0]

    rng = np.random.default_rng(8)
    T = 40
    feats = rng.standard_normal((1, T, h.hubert_dim)).astype(np.float32)
    f0 = np.where(rng.random(T) < 0.2, 0.0, 180 + 20 * rng.random(T)).astype(np.float32)
    f0 = f0[None, :, None]
    harm = (0.05 * rng.random((1, T, 49))).astype(np.float32) if ckpt_type == "mix" else None
    original = ckpt_type == "wavlm_only_original"
    ref = np.asarray(vocode(want, jh, jfam, jnp.asarray(feats),
                            None if original else jnp.asarray(f0),
                            None if harm is None else jnp.asarray(harm)))
    with torch.no_grad():
        model = generator_from_numpy(live, h, fam)                # folded on build
        out = model(torch.from_numpy(feats), None if original else torch.from_numpy(f0),
                    None if harm is None else torch.from_numpy(harm)).numpy()
    assert out.shape == ref.shape == (1, T * 320)
    assert np.abs(ref).max() > 1e-2
    np.testing.assert_allclose(out, ref, atol=2e-4)


def _checkpoint_dir(root, ckpt_type):
    """A directory as the reference ships it: g_*<ckpt_type>.pt, a do_
    (discriminator) file that must not be picked, WavLM-Large.pt and a
    small HiFi-GAN config."""
    cfg, _, wavlm_params = small_wavlm(overrides={"encoder_layers": 6})
    h, _, fam, _, gen_params = small_generator(ckpt_type)
    root.mkdir(parents=True, exist_ok=True)
    torch.save({"cfg": {**SMALL_WAVLM, "encoder_layers": 6},
                "model": wavlm_state_dict(wavlm_params, cfg)}, root / "WavLM-Large.pt")
    torch.save({"generator": hifigan_state_dict(gen_params)}, root / f"g_00000002_{ckpt_type}.pt")
    (root / f"do_00000002_{ckpt_type}.pt").write_bytes(b"not a generator")
    (root / "config.json").write_text(json.dumps(
        {k: list(v) if isinstance(v, tuple) else v for k, v in SMALL_HIFIGAN.items()}))
    return h, fam


@pytest.mark.parametrize("ckpt_type", ["mix", "wavlm_only_original"])
def test_knnsvc_load_reads_pt_checkpoints(tmp_path, ckpt_type):
    h, fam = _checkpoint_dir(tmp_path, ckpt_type)
    knn = KnnSvc.load(str(tmp_path), ckpt_type, config_path=str(tmp_path / "config.json"),
                      device="cpu")
    gen = load_hifigan_checkpoint(str(tmp_path / f"g_00000002_{ckpt_type}.pt"), h, fam)
    wavlm, cfg = load_wavlm_checkpoint(str(tmp_path / "WavLM-Large.pt"))
    assert knn.wavlm_cfg == cfg and knn.family == fam
    np.testing.assert_array_equal(knn.vocoder.dec.conv_post.weight.detach().numpy(),
                                  gen["dec"]["conv_post"]["w"])
    np.testing.assert_array_equal(knn.wavlm.encoder.pos_conv.weight.detach().numpy(),
                                  wavlm["encoder"]["pos_conv"]["w"])


def test_cli_pt_checkpoints_device_f0_int16_flac_loudness(tmp_path):
    """The CLI with every option of this slice at once, on the CPU:
    .pt checkpoints, ckpt_type wavlm_only_original, FLAC in and out,
    --f0_method device, --upload_depth int16, --apply_loudness."""
    from knnsvc_torch.io.audio import load_audio, save_audio
    from knnsvc_torch.io.loudness import loudness

    _checkpoint_dir(tmp_path / "ckpt", "wavlm_only_original")
    src, ref = str(tmp_path / "src.flac"), str(tmp_path / "ref.flac")
    save_audio(src, _sing(16000, 1.0, 190, seed=11), 16000)
    save_audio(ref, _sing(16000, 1.3, 270, seed=12), 16000)
    out = tmp_path / "out.flac"
    assert main([src, ref, "--ckpt_dir", str(tmp_path / "ckpt"),
                 "--ckpt_type", "wavlm_only_original",
                 "--config", str(tmp_path / "ckpt" / "config.json"), "--fast", "true",
                 "--f0_method", "device", "--upload_depth", "int16",
                 "--apply_loudness", "true", "--tgt_loudness_db", "-30",
                 "--device", "cpu", "--out", str(out)]) == 0
    y, sr = load_audio(out)
    assert sr == 16000 and y.shape == (1, 50 * 320) and np.abs(y).max() > 0
    # 16-bit FLAC quantization moves the loudness by far less than 0.1 dB
    assert abs(loudness(y, sr) + 30.0) < 0.1
    assert not list(tmp_path.glob("*_f0*.npy"))     # device f0 writes no sidecar
