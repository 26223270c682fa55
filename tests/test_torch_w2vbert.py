"""w2v-BERT 2.0 in the port (knnsvc_torch/models/w2vbert, dsp/fbank.py) on
the CPU at a tiny size: hidden 32, 2 heads, 3 layers, relative window
(4, 2), depthwise kernel 5, the published 80-bin frontend.

- the port against the benchmark's plain reference
  (h100_bench/reference/w2vbert.py), the frontend and every layer, on
  seeded random weights;
- the reference against HF's SeamlessM4TFeatureExtractor and
  Wav2Vec2BertModel (transformers; skipped without it), the frontend and
  each layer given HF's own input to it, which ties the reference to the
  published code;
- `KnnSvc.load` of an HF state dict gives HF's hidden states;
- `convert_pair(fast=True)` through the encoder against the reference
  pipeline (h100_bench/reference/pipeline_w2vbert2.py);
- the paths that serve WavLM alone raise NotImplementedError.

Tolerance 1e-5 of each frame's norm, float32. Inputs are sung phrases
(vibrato, phrasing): the extractor normalises each mel bin by its standard
deviation over the input after storing the log energies in float32, so on
a steady tone (a bin whose deviation is ~0.01) one float32 step of a log
energy (~2e-6 at 16) becomes ~2e-4, and any two implementations that sum
in another order differ there, HF's own against itself included. End to
end through HF's three layers, the frontend's ~3e-6 grows to ~1e-5, so
that comparison takes 3e-5.
"""

import dataclasses

import numpy as np
import pytest
import torch

from h100_bench import compare, inputs
from h100_bench.reference import pipeline_w2vbert2, w2vbert as reference
from knnsvc_torch.config import HiFiGANConfig, W2VBertConfig, WavLMConfig
from knnsvc_torch.dsp.fbank import w2vbert_input_features
from knnsvc_torch.hub import KnnSvc
from knnsvc_torch.models.w2vbert import W2VBert, init_w2vbert_params, w2vbert_from_state_dict
from knnsvc_torch.models.w2vbert.model import relative_index

TINY = dict(hidden_size=32, num_hidden_layers=3, num_attention_heads=2, intermediate_size=64,
            left_max_position_embeddings=4, right_max_position_embeddings=2,
            conv_depthwise_kernel_size=5)
LAYERS = 3
TOL = 1e-5
TINY_HIFIGAN = dict(upsample_initial_channel=32, n_harmonic=4, hubert_dim=32, hifi_dim=16,
                    resblock_kernel_sizes=[3], resblock_dilation_sizes=[[1, 3, 5]])


def _rel(a, b) -> float:
    a, b = torch.as_tensor(a, dtype=torch.float64), torch.as_tensor(b, dtype=torch.float64)
    return float(((a - b).norm(dim=-1) / b.norm(dim=-1)).max())


def _sung(seconds, hz, seed) -> torch.Tensor:
    """A sung phrase at int16 precision, as the pool uploads it."""
    wav, _ = inputs.sung_wav(seconds, hz, seed)
    return torch.from_numpy(np.round(wav * 32768.0).astype(np.float32) / 32768.0)


def _cfg(**kw) -> W2VBertConfig:
    return W2VBertConfig.from_dict({**TINY, "feature_layer": LAYERS, **kw})


@pytest.fixture(scope="module")
def weights():
    return init_w2vbert_params(_cfg(), torch.Generator().manual_seed(3))


@pytest.fixture(scope="module")
def hf():
    """(HF model, the extractor) at the tiny size, HF's own random init."""
    with pytest.MonkeyPatch.context() as mp:
        for flag in ("USE_TF", "USE_FLAX", "USE_JAX"):
            mp.setenv(flag, "0")
        modeling = pytest.importorskip("transformers.models.wav2vec2_bert.modeling_wav2vec2_bert")
        extraction = pytest.importorskip(
            "transformers.models.seamless_m4t.feature_extraction_seamless_m4t")
        from transformers import Wav2Vec2BertConfig
    with torch.random.fork_rng():
        torch.manual_seed(7)
        model = modeling.Wav2Vec2BertModel(Wav2Vec2BertConfig(**TINY, layerdrop=0.0)).eval()
    return model, extraction.SeamlessM4TFeatureExtractor()


def _hf_features(extractor, wav: torch.Tensor) -> torch.Tensor:
    return extractor(wav.numpy(), sampling_rate=16000, return_tensors="pt")["input_features"]


def test_init_names_are_hf_state_dict_names(hf, weights):
    """init_w2vbert_params draws every parameter HF's model holds, under its
    name and shape (HF's masked_spec_embed, which inference does not read,
    aside)."""
    model, _ = hf
    expected = {k: tuple(v.shape) for k, v in model.state_dict().items()
                if k != "masked_spec_embed"}
    assert {k: v.shape for k, v in weights.items()} == expected


def test_frontend_matches_the_extractor_and_the_reference(hf):
    _, extractor = hf
    for seconds, hz, seed in ((1.5, 230.0, 3), (2.13, 150.0, 4)):
        wav = _sung(seconds, hz, seed)
        port = w2vbert_input_features(wav)
        assert _rel(port, reference.input_features(wav)) <= TOL
        assert _rel(reference.input_features(wav), _hf_features(extractor, wav)[0]) <= TOL
        assert port.shape == (-(-((len(wav) - 400) // 160 + 1) // 2), 160)


def test_chunk_rows_are_wavlm_rows():
    """A chunk padded to 320 m samples gives m - 1 rows, as WavLM's
    frontend: the pool's f0, spectrogram and output stay on their grid."""
    from knnsvc_torch.models.wavlm.model import frame_count

    for m in (2, 3, 50, 1501):
        wav = torch.linspace(-0.5, 0.5, 320 * m)
        assert w2vbert_input_features(wav).shape[0] == m - 1 == frame_count(WavLMConfig(),
                                                                             320 * m)


def test_reference_layers_match_hf(hf):
    """Each of HF's layers against the reference's, given HF's own input to
    it; the projection on HF's features; end to end from the waveform."""
    model, extractor = hf
    state = model.state_dict()
    ref = reference.W2VBertReference(state, TINY, LAYERS, "cpu")
    wav = _sung(1.5, 230.0, 3)
    with torch.no_grad():
        hidden = model(_hf_features(extractor, wav), output_hidden_states=True).hidden_states
        feats = reference.input_features(wav)
        x = reference.linear(reference.layer_norm(feats, ref.state, "feature_projection.layer_norm",
                                                  1e-5), ref.state,
                             "feature_projection.projection")
        assert _rel(x, hidden[0][0]) <= TOL
        for i in range(LAYERS):
            out = reference.encoder_layer(hidden[i][0], ref.state, f"encoder.layers.{i}", ref.cfg)
            assert _rel(out, hidden[i + 1][0]) <= TOL, i
        ends = ref.hidden_states(wav)
    for i in range(LAYERS + 1):
        assert _rel(ends[i], hidden[i][0]) <= 3 * TOL, i


def test_port_layers_match_the_reference(weights):
    """Every layer of the port against the reference's, given the same
    input, and the early exit at each layer from the waveform."""
    port = w2vbert_from_state_dict(weights, _cfg(), "cpu")
    ref = reference.W2VBertReference(weights, TINY, LAYERS, "cpu")
    wav = _sung(2.13, 150.0, 4)
    with torch.no_grad():
        hidden = ref.hidden_states(wav)
        index = relative_index(hidden[0].shape[0], 4, 2, "cpu")
        assert _rel(port.feature_projection(port.input_features(wav[None]))[0], hidden[0]) <= TOL
        for i, layer in enumerate(port.encoder.layers):
            assert _rel(layer(hidden[i][None], index)[0], hidden[i + 1]) <= TOL, i
        for L in range(1, LAYERS + 1):
            assert _rel(port.extract_layer(wav[None], L)[0], hidden[L]) <= TOL, L


def test_load_serves_an_hf_state_dict(hf, tmp_path):
    """KnnSvc.load(encoder_ckpt=...) of HF's state dict and config keys:
    the encoder gives HF's hidden states. A bare state dict is read at the
    published widths; a WavLM checkpoint beside it is refused."""
    from knnsvc_torch.io.checkpoints import save_params

    model, extractor = hf
    torch.save({"cfg": {**model.config.to_dict(), "feature_layer": 2},
                "model": model.state_dict()}, tmp_path / "w2v.pt")
    h = {**dataclasses.asdict(HiFiGANConfig()), **TINY_HIFIGAN}
    save_params(str(tmp_path / "g_mix_00000001.knnsvc.pkl"),
                inputs.draw_tree(inputs.generator_spec(h, "mix"), 1, "cpu"))
    svc = KnnSvc.load(str(tmp_path), "mix", device="cpu", encoder_ckpt=str(tmp_path / "w2v.pt"),
                      config_path=_write_json(tmp_path / "h.json", h))
    assert isinstance(svc.wavlm, W2VBert) and len(svc.wavlm.encoder.layers) == 2
    assert int(np.argmax(svc.weighting)) == 2
    wav = _sung(1.5, 230.0, 3)
    with torch.no_grad():
        hidden = model(_hf_features(extractor, wav), output_hidden_states=True).hidden_states
        for L in (1, 2):
            assert _rel(svc.wavlm.extract_layer(wav[None], L)[0], hidden[L][0]) <= 3 * TOL
    # a bare state dict is read at the published widths
    torch.save(model.state_dict(), tmp_path / "bare.pt")
    with pytest.raises(RuntimeError, match="size mismatch"):
        KnnSvc.load(str(tmp_path), "mix", device="cpu", encoder_ckpt=str(tmp_path / "bare.pt"),
                    config_path=str(tmp_path / "h.json"))
    with pytest.raises(ValueError, match="not both"):
        KnnSvc.load(str(tmp_path), "mix", wavlm_ckpt="x.pt", device="cpu",
                    encoder_ckpt=str(tmp_path / "w2v.pt"))


def _write_json(path, data) -> str:
    import json

    path.write_text(json.dumps(data))
    return str(path)


@pytest.fixture(scope="module")
def tiny_service(weights):
    h = {**dataclasses.asdict(HiFiGANConfig()), **TINY_HIFIGAN}
    vocoder = inputs.draw_tree(inputs.generator_spec(h, "mix"), 5, "cpu")
    svc = KnnSvc(weights, _cfg(), vocoder, HiFiGANConfig.from_dict(h), "mix", device="cpu")
    svc.f0_method = "device"
    return svc, vocoder, h


@pytest.fixture(scope="module")
def pair_files(tmp_path_factory):
    root = tmp_path_factory.mktemp("w2v_pair")
    srcs, _ = inputs.write_files(str(root), "src", 1.0, 1.0, 1, 11, 1)
    tgts, _ = inputs.write_files(str(root), "tgt", 1.6, 1.6, 1, 12, 2)
    return srcs[0], tgts[0], root


@pytest.mark.parametrize("post_opt", ["no_post_opt", "post_opt_0.2"])
def test_convert_pair_matches_the_reference_pipeline(tiny_service, pair_files, post_opt):
    """convert_pair(fast=True), device f0 and int16 uploads, against
    pipeline_w2vbert2.convert from the same files and weights: the pools'
    features and f0, the matched features and harmonics, the waveform and
    its codes."""
    from h100_bench.drivers.pair import Tap, _host
    from h100_bench.reference.config import HiFiGANConfig as RefHiFiGANConfig

    svc, vocoder, h = tiny_service
    src, tgt, root = pair_files
    with Tap() as tap:
        tap.keep = {}
        svc.convert_pair(src, tgt, post_opt=post_opt, fast=True, upload_dtype="int16",
                         output_path=str(root / "out.wav"))
        prog = _host(tap.keep)
    enc = pipeline_w2vbert2.build_encoder(svc.wavlm.state_dict(), TINY, "cpu", LAYERS)
    voc = pipeline_w2vbert2.build_vocoder(vocoder, RefHiFiGANConfig.from_dict(h), "mix", "cpu")
    ref = pipeline_w2vbert2.convert(src, tgt, enc, voc, "mix", post_opt, 4, "cpu")
    numbers = compare.pair_numbers(prog, {k: None if v is None else v.numpy()
                                          for k, v in ref.items()})
    assert numbers["feat_rel_max"] <= TOL and numbers["f0_cents_max"] == 0
    assert numbers["out_rel_p90"] <= TOL and numbers["harm_rel_p90"] <= TOL
    assert numbers["wave_rel_median"] <= TOL and numbers["code_diff_share"] <= 1e-3


def test_counters_count_chunks_and_layers(weights):
    from knnsvc_torch.utils.profiling import counters

    port = w2vbert_from_state_dict(weights, _cfg(), "cpu")
    before = counters()
    with torch.no_grad():
        port.extract_layer(torch.stack([_sung(0.7, 200.0, 1)] * 2), 2)
    after = counters()
    assert after["w2vbert.chunks"] - before["w2vbert.chunks"] == 2
    assert after["w2vbert.layers_run"] - before["w2vbert.layers_run"] == 4


def test_paths_that_serve_wavlm_alone_raise(tiny_service, pair_files):
    svc, _, _ = tiny_service
    src, tgt, root = pair_files
    w2v = "w2v-BERT 2.0"
    with pytest.raises(NotImplementedError, match=w2v):
        next(svc.stream_convert_chunks(src, tgt))
    with pytest.raises(NotImplementedError, match=w2v):
        svc.stream_convert(src, tgt, output_path=str(root / "s.wav"))
    with pytest.raises(NotImplementedError, match=w2v):
        svc.stream_session(tgt)
    with pytest.raises(NotImplementedError, match=w2v):
        svc.convert_pair(src, tgt, fast=False, output_path=str(root / "h.wav"))
    for matcher in ("sharded", "sharded_int8"):
        with pytest.raises(NotImplementedError, match=w2v):
            svc.convert_pair(src, tgt, fast=True, matcher=matcher, output_path=str(root / "m.wav"))
    with pytest.raises(NotImplementedError, match=w2v):
        svc.bulk_convert(str(root), str(root), str(root / "bulk"))
    x = _sung(0.7, 200.0, 1)[None]
    with pytest.raises(NotImplementedError, match=w2v):
        svc.wavlm.extract_layer_bucketed(x, 2)
    with pytest.raises(NotImplementedError, match=w2v):
        svc.get_features(x[0].numpy(), weights=np.full(25, 1 / 25, np.float32))
    with pytest.raises(ValueError, match="layers 1..3"):
        svc.wavlm.extract_layer(x, 4)


def test_feature_layer_is_the_configuration_s():
    assert WavLMConfig().feature_layer == 6 and W2VBertConfig().feature_layer == 17
    assert W2VBertConfig().layers_built == 17
    assert W2VBertConfig.from_dict({"hidden_act": "swish", "feature_layer": 30}).layers_built == 24
    with pytest.raises(ValueError, match="hidden_act"):
        W2VBertConfig.from_dict({"hidden_act": "gelu"})
    with pytest.raises(ValueError, match="position_embeddings_type"):
        W2VBertConfig.from_dict({"position_embeddings_type": "rotary"})
    with pytest.raises(ValueError, match="encoder must be one of"):
        KnnSvc.random_init("mix", device="cpu", encoder="hubert")
