"""knnsvc_torch's entry points and guards on the CPU: the CLI driven end to
end from `.knnsvc.pkl` files (and with --precision high), no silent CPU
fallback, the multi-device matchers give the dense matchers' waveforms, an
`.mp3` output path writes an mp3, a directory holding only an orbax
checkpoint serves, no file of the port imports JAX, the JAX package, orbax
or tensorstore, every module of the JAX package has a counterpart, every
public name and keyword of its modules has one (or a listed reason), and
each subpackage exports the JAX package's names."""

import ast
import json
import pathlib

import numpy as np
import pytest
import torch

from knnsvc_tpu.io.checkpoints import save_params
from knnsvc_torch.cli.inference import main
from knnsvc_torch.hub import KnnSvc
from knnsvc_torch.io.audio import load_audio
from knnsvc_torch.utils.layer_weights import generate_matrix_from_index

from test_torch_common import (SMALL_HIFIGAN, SMALL_WAVLM, int16_codes, small_generator,
                               small_wavlm, write_pair)

REPO = pathlib.Path(__file__).resolve().parent.parent


@pytest.fixture(scope="module")
def pair(tmp_path_factory):
    root = tmp_path_factory.mktemp("torch_entry")
    return root, write_pair(root)


def test_unported_options_raise(pair):
    root, (src, ref) = pair
    cfg, _, wavlm_params = small_wavlm()
    h, _, _, _, gen_params = small_generator("mix")
    knn = KnnSvc(wavlm_params, cfg, gen_params, h, "mix", device="cpu")
    knn.weighting = generate_matrix_from_index(2, size=cfg.encoder_layers + 1)
    out = str(root / "unported.wav")
    # the multi-device matchers run on both pair paths: the sharded searches
    # pick the dense ones' rows, so the waveforms are the same bits
    pair = lambda fast, matcher, name: int16_codes(knn.convert_pair(
        src, ref, fast=fast, matcher=matcher, output_path=str(root / name)))
    for fast, dense in ((False, "exact"), (False, "int8"), (True, "exact")):
        want = pair(fast, dense, f"{dense}_{fast}.wav")
        got = pair(fast, "sharded" if dense == "exact" else "sharded_int8", "sharded.wav")
        np.testing.assert_array_equal(got, want)
    # an .mp3 output path: libmp3lame's CBR file (160 kbit/s at 16 kHz), which
    # decodes back near the WAV output, at tests/test_io_audio.py's 15 dB, in
    # the band that LAME keeps at this rate (its low-pass is at ~7.2 kHz; this
    # random-weight output holds 4% of its energy above 7 kHz)
    wav = load_audio(knn.convert_pair(src, ref, fast=True, output_path=str(root / "out.wav")))[0][0]
    decoded, sr = load_audio(knn.convert_pair(src, ref, fast=True,
                                              output_path=str(root / "out.mp3")))
    assert sr == 16000 and decoded.shape[0] == 1
    lag = int(np.argmax(np.correlate(decoded[0][:len(wav) // 2 + 2000], wav[:len(wav) // 2],
                                     "valid")))
    n = min(len(wav), len(decoded[0]) - lag)
    assert lag == 576 + 529 and n == len(wav)  # LAME's encoder delay, the decoder's
    want, got = np.fft.rfft(wav[:n]), np.fft.rfft(decoded[0][lag:lag + n])
    band = np.fft.rfftfreq(n, 1 / 16000) < 7000
    snr = 10 * np.log10(np.sum(np.abs(want[band]) ** 2) / np.sum(np.abs(got - want)[band] ** 2))
    assert snr > 15.0, f"mp3 output SNR {snr:.1f} dB below 7 kHz"
    # a directory holding only orbax/ (a training run's TrainState) serves
    # its generator: the same waveform as the model built from the same trees
    from knnsvc_torch.io.checkpoints import save_params as port_save_params
    from knnsvc_torch.io.orbax_ckpt import save_train_state

    orbax = root / "orbax_only"
    save_train_state(str(orbax / "orbax"), 7, {"g_params": gen_params, "steps": np.int32(7)})
    port_save_params(str(root / "wavlm_small.knnsvc.pkl"), {"cfg": SMALL_WAVLM,
                                                            "model": wavlm_params})
    (root / "small_config.json").write_text(json.dumps(SMALL_HIFIGAN))
    served = KnnSvc.load(str(orbax), "mix", wavlm_ckpt=str(root / "wavlm_small.knnsvc.pkl"),
                         config_path=str(root / "small_config.json"), device="cpu")
    served.weighting = knn.weighting
    np.testing.assert_array_equal(
        int16_codes(served.convert_pair(src, ref, fast=True, output_path=str(root / "ob.wav"))),
        pair(True, "exact", "exact_orbax_twin.wav"))
    with pytest.raises(ValueError, match="no_post_opt"):
        knn.convert_pair(src, ref, fast=True, matcher="sharded_int8", post_opt="post_opt_0.2",
                         output_path=out)


def _write_checkpoints(root):
    """JAX-written `.knnsvc.pkl` files of the small models under `root`:
    -> (WavLM cfg, WavLM params, generator params, the CLI's model flags)."""
    wavlm_cfg = {**SMALL_WAVLM, "encoder_layers": 6}   # layer 6 is the served one
    cfg, jcfg, wavlm_params = small_wavlm(overrides={"encoder_layers": 6})
    _, _, _, _, gen_params = small_generator("mix")
    save_params(str(root / "WavLM-small.knnsvc.pkl"), {"cfg": wavlm_cfg, "model": wavlm_params})
    save_params(str(root / "g_00000001_mix.knnsvc.pkl"), {"generator": gen_params})
    (root / "config.json").write_text(json.dumps(
        {k: list(v) if isinstance(v, tuple) else v for k, v in SMALL_HIFIGAN.items()}))
    flags = ["--ckpt_dir", str(root), "--ckpt_type", "mix",
             "--wavlm_ckpt", str(root / "WavLM-small.knnsvc.pkl"),
             "--config", str(root / "config.json")]
    return cfg, wavlm_params, gen_params, flags


def test_cli_loads_knnsvc_pkl_and_converts_on_cpu(pair, tmp_path):
    """`.knnsvc.pkl` files written by the JAX package (a {'cfg', 'model'}
    WavLM payload and a {'generator': ...} HiFi-GAN payload) drive the
    port's CLI end to end with --device cpu."""
    _, (src, ref) = pair
    cfg, wavlm_params, gen_params, flags = _write_checkpoints(tmp_path)
    out = tmp_path / "cli.wav"
    assert main([src, ref, *flags, "--fast", "true", "--device", "cpu", "--out", str(out)]) == 0
    codes = int16_codes(out)
    assert codes.shape == (50 * 320,) and np.abs(codes).max() > 0

    knn = KnnSvc.load(str(tmp_path), "mix", str(tmp_path / "WavLM-small.knnsvc.pkl"),
                      str(tmp_path / "config.json"), device="cpu")
    assert knn.wavlm_cfg == cfg and len(knn.wavlm.encoder.layers) == 6
    np.testing.assert_array_equal(knn.wavlm.encoder.layers[5].fc1.weight.detach().numpy(),
                                  wavlm_params["encoder"]["layers"]["fc1"]["w"][5].T)
    np.testing.assert_array_equal(knn.vocoder.dec.conv_post.weight.detach().numpy(),
                                  gen_params["dec"]["conv_post"]["w"])


def test_cuda_default_raises_without_a_card(monkeypatch, pair):
    """Entry points default to device='cuda' and never fall back to the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        KnnSvc.random_init()
    _, (src, ref) = pair
    with pytest.raises(RuntimeError, match="no CUDA device"):
        main([src, ref, "--random_init", "true", "--fast", "true"])


def test_cli_and_policy_take_the_jax_precision_names(pair, tmp_path):
    """--precision high converts and leaves the policy at "high", as the
    JAX CLI's choices allow; "default" is "fastest", as in the JAX
    package's precision names."""
    from knnsvc_torch.precision import get_precision, set_precision

    _, (src, ref) = pair
    *_, flags = _write_checkpoints(tmp_path)
    out = tmp_path / "high.wav"
    try:
        assert main([src, ref, *flags, "--fast", "true", "--device", "cpu",
                     "--precision", "high", "--out", str(out)]) == 0
        assert get_precision() == "high" and int16_codes(out).shape == (50 * 320,)
        set_precision("default")
        assert get_precision() == "fastest"
        assert torch.backends.cuda.matmul.allow_tf32
        with pytest.raises(ValueError, match="precision must be one of"):
            set_precision("bf16")
    finally:
        set_precision("highest")
    assert torch.backends.cuda.matmul.allow_tf32 is False


def test_new_entry_points_default_to_cuda(monkeypatch, tmp_path):
    """initialize_distributed, the regression metrics, speaker similarity's
    embedder, the Whisper transcriber, train()'s default mesh and
    quantize_pool run on device='cuda' unless told otherwise, and raise
    without a card."""
    from knnsvc_torch.config import HiFiGANConfig
    from knnsvc_torch.eval.intelligibility import default_whisper_transcriber
    from knnsvc_torch.eval.regression import spectral_distance
    from knnsvc_torch.eval.speaker_sim import compute_speaker_similarity, mfcc_stats_embedder
    from knnsvc_torch.io.audio import save_audio
    from knnsvc_torch.match.quantized_pool import quantize_pool
    from knnsvc_torch.parallel.mesh import initialize_distributed, make_mesh
    from knnsvc_torch.train.loop import train

    from test_torch_common import TINY_H

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    wav = np.zeros(3200, np.float32)
    save_audio(tmp_path / "a.wav", wav, 16000)
    (tmp_path / "pairs.csv").write_text("src_speaker,tgt_speaker,x_path,y_path,label\n"
                                        "s,t,a,a,0\ns,t,a,a,1\n")
    calls = [
        lambda: initialize_distributed(),
        lambda: initialize_distributed("127.0.0.1:29500", 2, 0),
        lambda: spectral_distance(str(tmp_path / "a.wav"), str(tmp_path / "a.wav")),
        lambda: mfcc_stats_embedder(wav),
        lambda: compute_speaker_similarity(str(tmp_path / "pairs.csv"), str(tmp_path),
                                           str(tmp_path), result_dir=str(tmp_path)),
        lambda: default_whisper_transcriber(str(tmp_path)),
        lambda: train(HiFiGANConfig.from_dict(TINY_H), str(tmp_path), str(tmp_path),
                      str(tmp_path), str(tmp_path), str(tmp_path / "ckpt")),
        lambda: make_mesh(),
        lambda: quantize_pool(np.ones((4, 8), np.float32)),
    ]
    for call in calls:
        with pytest.raises(RuntimeError, match="no CUDA device"):
            call()
    assert not torch.distributed.is_initialized()


def _imported_roots(path: pathlib.Path) -> set[str]:
    roots = set()
    for node in ast.walk(ast.parse(path.read_text(), filename=str(path))):
        if isinstance(node, ast.Import):
            roots.update(alias.name.split(".")[0] for alias in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            roots.add(node.module.split(".")[0])
    return roots


def test_port_imports_neither_jax_nor_the_jax_package():
    files = sorted((REPO / "knnsvc_torch").rglob("*.py")) + [REPO / "chip_smoke.py",
                                                             REPO / "tests" / "torch_dp_worker.py"]
    assert len(files) > 20
    names = {str(p.relative_to(REPO)) for p in files}
    assert {"knnsvc_torch/io/vad.py", "knnsvc_torch/match/quantized_pool.py",
            "knnsvc_torch/match/pipeline.py", "knnsvc_torch/match/pool.py",
            "knnsvc_torch/hub.py", "knnsvc_torch/cli/inference.py",
            "knnsvc_torch/models/wavlm/streaming.py", "knnsvc_torch/ops/concat_scan.py",
            "knnsvc_torch/match/concat_cost.py", "knnsvc_torch/eval/speaker_sim.py",
            "knnsvc_torch/eval/regression.py", "knnsvc_torch/eval/intelligibility.py",
            "knnsvc_torch/utils/profiling.py", "knnsvc_torch/utils/flops.py",
            "knnsvc_torch/train/spectral_losses.py", "knnsvc_torch/models/hifigan/harm_head.py",
            "knnsvc_torch/models/wavlm/masking.py", "knnsvc_torch/parallel/mesh.py",
            "knnsvc_torch/train/legacy_audio_dataset.py", "tests/torch_dp_worker.py",
            "knnsvc_torch/io/orbax_ckpt.py", "knnsvc_torch/io/ocdbt.py",
            "knnsvc_torch/io/zarr2.py"} <= names
    for path in files:
        bad = _imported_roots(path) & {"jax", "jaxlib", "knnsvc_tpu", "orbax", "tensorstore"}
        assert not bad, f"{path.relative_to(REPO)} imports {sorted(bad)}"


def test_every_jax_module_has_a_counterpart():
    """Every module of the JAX package has a counterpart in the port, orbax
    checkpoints too (io/orbax_ckpt.py, which reads and writes their format
    without orbax)."""
    def modules(pkg):
        return {str(p.relative_to(REPO / pkg)) for p in (REPO / pkg).rglob("*.py")}

    assert modules("knnsvc_tpu") - modules("knnsvc_torch") == set()


# Public names of JAX modules that the port's module of the same path does
# not define: (JAX module, name) -> (the port's counterpart as
# "module:attribute", or None, why). Counterparts are resolved by the test.
_PARAMS_ALIAS = "a type alias of the JAX pytrees; the port's parameters are nn.Modules"
NAME_MAP = {
    ("dsp/f0_device.py", "device_f0_jax"): (
        "knnsvc_torch.dsp.f0_device:device_f0_tensor", "device f0 of a waveform on the device"),
    ("match/concat_cost.py", "concat_cost_core"): (
        "knnsvc_torch.match.concat_cost:concat_cost_scan",
        "the gather-parameterized XLA core; the port's scan takes the pool or a gather"),
    ("match/concat_cost.py", "concat_cost_pair_core"): (
        "knnsvc_torch.match.concat_cost:concat_cost_scan", "both lanes of the same core"),
    ("match/pool.py", "harmonic_amplitudes_jax"): (
        "knnsvc_torch.match.pool:harmonic_amplitudes", "the device form; the port's runs on tensors"),
    ("match/serve.py", "convert_pools_fused"): (
        "knnsvc_torch.match.serve:convert_pools", "one jitted program in JAX; eager in the port"),
    ("models/hifigan/harm_head.py", "conv_relu_norm_apply"): (
        "knnsvc_torch.models.hifigan.harm_head:ConvReluNorm", "a functional primitive"),
    ("models/hifigan/layers.py", "Params"): (None, _PARAMS_ALIAS),
    ("models/hifigan/layers.py", "conv1d"): ("torch.nn:Conv1d", "a functional primitive"),
    ("models/hifigan/layers.py", "conv2d"): ("torch.nn:Conv2d", "a functional primitive"),
    ("models/hifigan/layers.py", "conv_transpose1d"): (
        "torch.nn:ConvTranspose1d", "a functional primitive"),
    ("models/hifigan/layers.py", "conv_weight"): (
        "torch.nn.utils.parametrizations:weight_norm", "live weight norm as a parametrization"),
    ("models/hifigan/layers.py", "leaky_relu"): (
        "torch.nn.functional:leaky_relu", "a functional primitive"),
    ("models/wavlm/model.py", "USE_PALLAS_ATTENTION"): (
        None, "chooses between the Pallas kernel and XLA einsums; a card always takes the "
              "port's kernel"),
    ("models/wavlm/model.py", "cached_position_bias"): (
        "knnsvc_torch.models.wavlm.model:WavLM.position_bias", "cached per T as its diagonal"),
    ("models/wavlm/model.py", "conv1d"): ("torch.nn:Conv1d", "a functional primitive"),
    ("models/wavlm/model.py", "conv_frontend"): (
        "knnsvc_torch.models.wavlm.model:ConvFrontend", "a functional primitive"),
    ("models/wavlm/model.py", "encoder_layer"): (
        "knnsvc_torch.models.wavlm.model:EncoderLayer", "a functional primitive"),
    ("models/wavlm/model.py", "gelu"): ("torch.nn.functional:gelu", "a functional primitive"),
    ("models/wavlm/model.py", "group_norm_per_channel"): (
        "torch.nn:GroupNorm", "GroupNorm(C, C) in ConvFrontend"),
    ("models/wavlm/model.py", "layer_norm"): ("torch.nn:LayerNorm", "a functional primitive"),
    ("models/wavlm/model.py", "linear"): ("torch.nn:Linear", "a functional primitive"),
    ("models/wavlm/model.py", "multihead_attention"): (
        "knnsvc_torch.models.wavlm.model:MultiheadAttention", "a functional primitive"),
    ("models/wavlm/model.py", "pos_conv"): (
        "knnsvc_torch.models.wavlm.model:Encoder", "Encoder.pos_conv and WavLM's gelu over it"),
    ("models/wavlm/streaming.py", "Params"): (None, _PARAMS_ALIAS),
    ("ops/attention.py", "DEFAULT_BLOCK_Q"): (
        None, "the Pallas grid's query block; the CUDA kernel's is compiled in (BQ = 64)"),
    ("ops/concat_scan.py", "C"): (None, "the Pallas kernel's lane-tile width"),
    ("ops/concat_scan.py", "K"): (None, "the Pallas kernel's fixed top-k; the CUDA kernel takes "
                                        "k <= 32"),
    ("ops/concat_scan.py", "LANES"): (None, "the Pallas kernel's lane count"),
    ("ops/concat_scan.py", "concat_cost_pair_pallas"): (
        "knnsvc_torch.ops.concat_scan:concat_cost_pair", "the CUDA kernel's wrapper"),
    ("ops/concat_scan.py", "pallas_concat_pair_ok"): (
        None, "whether the Pallas kernel takes a shape; the CUDA kernel takes every shape the "
              "serving path gives it"),
    ("train/trainer.py", "Params"): (None, _PARAMS_ALIAS),
}

# Parameters of a JAX function (or method) that its port does not take
# under the same name: (JAX module, function, parameter) -> (the port's
# name, or None, why).
_MODULE = "the port's function takes the nn.Module that holds these parameters"
_CARRIED = "the port's module carries it"
_GENERATOR = "a torch.Generator in place of a JAX PRNG key"
KEYWORD_MAP = {
    ("dsp/synth.py", "wrapped_phase_cumsum", "axis"): ("dim", "torch's name"),
    ("match/f0_logic.py", "torch_median", "axis"): ("dim", "torch's name"),
    ("match/smoothness.py", "optimize_smoothness_weights", "unroll"): (
        None, "lax.scan's unroll factor; the port's loop is eager"),
    ("match/smoothness.py", "optimize_smoothness_from_surrounding", "unroll"): (
        None, "lax.scan's unroll factor; the port's loop is eager"),
    ("ops/attention.py", "gated_bias_attention", "block_q"): (
        None, "the Pallas grid's query block; the CUDA kernel's is compiled in"),
    ("ops/attention.py", "gated_bias_attention", "interpret"): (
        None, "Pallas's interpret mode; CPU tensors take the plain version"),
    **{("match/concat_cost.py", fn, jax_name): (port_name, "the port's name")
       for fn, renames in (
           ("concat_cost_stream_core", ("target_feature_indices", "src_elements")),
           ("knn_with_concat_cost", ("target_feature_indices", "src_elements", "tgt_elements")),
           ("concat_cost_pair_stream_core", ("src_elements",)),
           ("knn_with_concat_cost_pair", ("src_elements", "tgt_elements")))
       for jax_name, port_name in (("target_feature_indices", "idx"), ("src_elements", "src"),
                                   ("tgt_elements", "tgt"))
       if jax_name in renames},
    **{("match/concat_cost.py", fn, jax_name): why
       for fn in ("concat_cost_stream_core", "concat_cost_pair_stream_core")
       for jax_name, why in (
           ("gather_rows", ("tgt", "the pool's rows")),
           ("pool_limit", (None, "the pool's length, read from tgt")),
           ("tgt_log_f0", ("tgt_f0", "the target f0 in Hz; the port takes its log2 inside")))},
    **{(mod, fn, "wavlm_params"): ("wavlm", _MODULE)
       for mod, fn in (("match/pipeline.py", "match_at_inference_time"),
                       ("match/pool.py", "chunked_wavlm_features"),
                       ("match/pool.py", "build_device_pool"),
                       ("match/pool.py", "build_speaker_pool"))},
    **{(mod, fn, "wavlm_cfg"): (None, _CARRIED)
       for mod, fn in (("match/pipeline.py", "match_at_inference_time"),
                       ("match/pool.py", "chunked_wavlm_features"),
                       ("match/pool.py", "build_device_pool"),
                       ("match/pool.py", "build_speaker_pool"))},
    ("match/pool.py", "DevicePool.__init__", "harmonics"): (
        None, "gathered from spec and f0 on first access"),
    ("models/hifigan/discriminator.py", "discriminator_p_apply", "params"): ("disc", _MODULE),
    ("models/hifigan/discriminator.py", "discriminator_s_apply", "params"): ("disc", _MODULE),
    ("models/hifigan/discriminator.py", "mpd_apply", "params"): ("mpd", _MODULE),
    ("models/hifigan/discriminator.py", "msd_apply", "params"): ("msd", _MODULE),
    **{("models/hifigan/generator.py", fn, "params"): (name, _MODULE)
       for fn, name in (("generator_apply", "generator"), ("synthesizer_mix_apply", "synth"),
                        ("synthesizer_f0_apply", "synth"), ("synthesizer_original_apply", "synth"),
                        ("vocode", "synth"))},
    **{("models/hifigan/generator.py", fn, knob): (None, _CARRIED)
       for fn, knobs in (("generator_apply", ("h", "family")), ("synthesizer_mix_apply", ("h",)),
                         ("synthesizer_f0_apply", ("h",)), ("synthesizer_original_apply", ("h",)),
                         ("vocode", ("h", "family")))
       for knob in knobs},
    ("models/hifigan/harm_head.py", "generator_harm_apply", "params"): ("model", _MODULE),
    **{("models/wavlm/model.py", fn, "params"): ("model", _MODULE)
       for fn in ("wavlm_extract_layer", "wavlm_extract_layer_bucketed",
                  "wavlm_extract_all_layers", "wavlm_encode")},
    **{("models/wavlm/model.py", fn, "cfg"): (None, _CARRIED)
       for fn in ("wavlm_extract_layer", "wavlm_extract_layer_bucketed",
                  "wavlm_extract_all_layers", "wavlm_encode")},
    ("models/wavlm/streaming.py", "WavLMStreamEncoder.__init__", "params"): ("wavlm", _MODULE),
    ("models/wavlm/streaming.py", "WavLMStreamEncoder.__init__", "cfg"): (None, _CARRIED),
    **{(mod, fn, "key"): ("generator", _GENERATOR)
       for mod, fn in (("models/hifigan/discriminator.py", "init_mpd_params"),
                       ("models/hifigan/discriminator.py", "init_msd_params"),
                       ("models/hifigan/generator.py", "init_generator_params"),
                       ("models/hifigan/harm_head.py", "init_generator_harm_params"),
                       ("models/wavlm/model.py", "init_wavlm_params"),
                       ("train/spectral_losses.py", "rss_loss"))},
    ("train/trainer.py", "init_train_state", "key"): ("seed", "a seed in place of a PRNG key"),
    ("train/prematch.py", "self_knn_with_mask", "matching_pool_j"): (
        "matching_pool", "the port's name"),
    ("train/trainer.py", "set_learning_rate", "opt_state"): (
        "optimizer", "a torch optimizer in place of optax's state"),
    ("train/trainer.py", "make_train_step", "opt_g"): (
        None, "an optax transformation; the port's step builds its AdamW from h"),
    ("train/trainer.py", "make_train_step", "opt_d"): (
        None, "an optax transformation; the port's step builds its AdamW from h"),
    ("train/trainer.py", "eval_step", "g_params"): ("generator", _MODULE),
    ("train/trainer.py", "eval_step_padded", "g_params"): ("generator", _MODULE),
}


def _module_surface(path: pathlib.Path, with_imports: bool):
    """A module's public top-level names (functions, classes, assigned
    names, and with_imports the names it imports) and its functions and
    class methods by name ("f", "Class.method")."""
    names, functions = set(), {}
    for node in ast.parse(path.read_text(), filename=str(path)).body:
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            names.add(node.name)
            functions[node.name] = node
        elif isinstance(node, ast.ClassDef):
            names.add(node.name)
            functions.update({f"{node.name}.{m.name}": m for m in node.body
                              if isinstance(m, (ast.FunctionDef, ast.AsyncFunctionDef))})
        elif isinstance(node, (ast.Assign, ast.AnnAssign)):
            targets = node.targets if isinstance(node, ast.Assign) else [node.target]
            names.update(n.id for t in targets for n in ast.walk(t) if isinstance(n, ast.Name))
        elif with_imports and isinstance(node, (ast.Import, ast.ImportFrom)):
            names.update((a.asname or a.name).split(".")[0] for a in node.names)
    return {n for n in names if not n.startswith("_")}, functions


def _parameters(fn: ast.FunctionDef) -> tuple[list[str], bool]:
    """The names a call can pass by keyword, and whether **kwargs is taken."""
    a = fn.args
    return [x.arg for x in a.args + a.kwonlyargs if x.arg != "self"], a.kwarg is not None


def _resolve(counterpart: str):
    import importlib

    module, attr = counterpart.split(":")
    obj = importlib.import_module(module)
    for part in attr.split("."):
        obj = getattr(obj, part)
    return obj


def test_every_jax_name_and_keyword_has_a_counterpart():
    """For each module of the JAX package, every public top-level name
    (function, class, constant) is defined or imported by the port's module
    of the same path, or stands in NAME_MAP with its counterpart (which must
    resolve) or the reason it has none; every parameter of a JAX function or
    method that both define is taken by the port's under the same name, or
    stands in KEYWORD_MAP with the port's name (which the port must take)
    or its reason. Stale entries of either map fail too."""
    missing_names, missing_keywords = set(), set()
    for jax_path in sorted((REPO / "knnsvc_tpu").rglob("*.py")):
        rel = str(jax_path.relative_to(REPO / "knnsvc_tpu"))
        jax_names, jax_fns = _module_surface(jax_path, with_imports=False)
        port_names, port_fns = _module_surface(REPO / "knnsvc_torch" / rel, with_imports=True)
        missing_names |= {(rel, n) for n in jax_names - port_names}
        for name, fn in jax_fns.items():
            if name not in port_fns or any(p.startswith("_") and p != "__init__"
                                           for p in name.split(".")):
                continue
            port_params, var_keyword = _parameters(port_fns[name])
            for param in _parameters(fn)[0]:
                if param not in port_params and not var_keyword:
                    missing_keywords.add((rel, name, param))
                    renamed = KEYWORD_MAP.get((rel, name, param), (None, ""))[0]
                    assert renamed is None or renamed in port_params, (rel, name, param, renamed)
    assert missing_names == set(NAME_MAP), (
        f"unported names: {sorted(missing_names - set(NAME_MAP))}; stale entries: "
        f"{sorted(set(NAME_MAP) - missing_names)}")
    assert missing_keywords == set(KEYWORD_MAP), (
        f"keywords the port does not take: {sorted(missing_keywords - set(KEYWORD_MAP))}; "
        f"stale entries: {sorted(set(KEYWORD_MAP) - missing_keywords)}")
    for key, (counterpart, why) in {**NAME_MAP, **KEYWORD_MAP}.items():
        assert why, key
        if key in NAME_MAP and counterpart is not None:
            assert _resolve(counterpart) is not None, (key, counterpart)


SUBPACKAGES = ["", "ops", "models", "models.wavlm", "models.hifigan", "match", "io", "utils",
               "dsp", "parallel", "eval", "train", "cli"]


def _public(module) -> set[str]:
    """__all__, or the names a package binds itself (not submodules)."""
    import types

    if hasattr(module, "__all__"):
        return set(module.__all__)
    return {n for n, v in vars(module).items()
            if not n.startswith("_") and not isinstance(v, types.ModuleType)
            and n not in ("annotations",)}


@pytest.mark.parametrize("sub", SUBPACKAGES)
def test_subpackage_exports_the_jax_names(sub):
    """Each subpackage exports what its JAX counterpart exports, every name
    bound; parallel adds Mesh, the port's grid of devices (JAX imports its
    own from jax.sharding)."""
    import importlib

    jax_mod = importlib.import_module("knnsvc_tpu" + ("." + sub if sub else ""))
    mod = importlib.import_module("knnsvc_torch" + ("." + sub if sub else ""))
    extra = {"Mesh"} if sub == "parallel" else set()
    assert _public(mod) == _public(jax_mod) | extra
    for name in _public(mod):
        assert getattr(mod, name) is not None, name
