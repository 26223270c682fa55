"""The port's probes for traces, on the CPU at a tiny size: the request's
root span `knnsvc.convert_pair`, the part span `knnsvc:pos_conv` in the
WavLM encoder, the smoothness optimizer's step counters and
`utils.profiling.counters()`."""

from __future__ import annotations

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile, record_function

from knnsvc_torch.config import HiFiGANConfig, ModelFamily, WavLMConfig

SR = 16000
TINY_WAVLM = dict(extractor_mode="layer_norm", encoder_layers=3, encoder_embed_dim=16,
                  encoder_ffn_embed_dim=32, encoder_attention_heads=2, layer_norm_first=True,
                  conv_feature_layers="[(16,10,5)] + [(16,4,4)] * 3", conv_bias=True,
                  conv_pos=8, conv_pos_groups=2, num_buckets=16, max_distance=32)
TINY_HIFIGAN = dict(upsample_initial_channel=32, n_harmonic=4, hubert_dim=16, hifi_dim=16,
                    resblock_kernel_sizes=[3], resblock_dilation_sizes=[[1, 3, 5]])


def _profiled(fn):
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        fn()
    return prof.events()


def _spans(events, prefix="knnsvc"):
    return [e for e in events if e.name.startswith(prefix)]


def _first_span_above(e):
    p = e.cpu_parent
    while p is not None and not p.name.startswith("knnsvc"):
        p = p.cpu_parent
    return p


def _tiny_wavlm():
    from knnsvc_torch.io.jax_params import wavlm_from_numpy
    from knnsvc_torch.models.wavlm.model import init_wavlm_params

    cfg = WavLMConfig.from_dict(TINY_WAVLM)
    return wavlm_from_numpy(init_wavlm_params(cfg, torch.Generator().manual_seed(0)), cfg,
                            torch.device("cpu"))


def test_pos_conv_part_span_nests_in_the_callers_stage():
    model = _tiny_wavlm()
    wav = torch.from_numpy(np.random.default_rng(0).standard_normal((1, 8000)).astype(np.float32))

    def encode():
        with torch.no_grad(), record_function("knnsvc.pool_build"):
            for _ in range(2):
                model.extract_layer(wav, output_layer=2)

    parts = _spans(_profiled(encode), "knnsvc:")
    assert [e.name for e in parts] == ["knnsvc:pos_conv"] * 2
    assert all(_first_span_above(e).name == "knnsvc.pool_build" for e in parts)


def _write_pair(root):
    from knnsvc_torch.dsp.f0 import save_f0_sidecar
    from knnsvc_torch.io.audio import save_audio

    paths = []
    for name, seconds, hz, seed in (("src", 0.8, 190, 1), ("ref", 1.2, 270, 2)):
        rng = np.random.default_rng(seed)
        t = np.arange(int(SR * seconds)) / SR
        wav = (0.3 * np.sin(2 * np.pi * hz * t * (1 + 0.04 * np.sin(2 * np.pi * 5 * t)))
               + 0.02 * rng.standard_normal(len(t))).astype(np.float32)
        path = str(root / f"{name}.wav")
        save_audio(path, wav, SR)
        save_f0_sidecar(path, np.full(len(wav) // 320 + 1, hz, np.float32))
        paths.append(path)
    return paths


@pytest.fixture(scope="module")
def tiny_svc():
    from knnsvc_torch.hub import KnnSvc
    from knnsvc_torch.models.hifigan.generator import init_generator_params
    from knnsvc_torch.models.wavlm.model import init_wavlm_params
    from knnsvc_torch.utils.layer_weights import generate_matrix_from_index

    cfg, h = WavLMConfig.from_dict(TINY_WAVLM), HiFiGANConfig.from_dict(TINY_HIFIGAN)
    gen = torch.Generator().manual_seed(0)
    svc = KnnSvc(init_wavlm_params(cfg, gen), cfg,
                 init_generator_params(h, ModelFamily.MIX, gen), h, "mix", device="cpu")
    svc.weighting = generate_matrix_from_index(2, size=cfg.encoder_layers + 1)
    return svc


@pytest.mark.parametrize("fast", [True, False])
def test_convert_pair_has_one_root_span(tiny_svc, tmp_path, fast):
    """The fast path and the host path (f0 from the files' sidecars)."""
    src, ref = _write_pair(tmp_path)
    events = _profiled(lambda: tiny_svc.convert_pair(src, ref, fast=fast,
                                                     output_path=str(tmp_path / "out.wav")))
    spans = _spans(events)
    roots = [e for e in spans if e.name == "knnsvc.convert_pair"]
    assert len(roots) == 1
    root = roots[0]
    inner = [e for e in spans if e is not root]
    assert {"knnsvc.write_wav", "knnsvc:pos_conv"} <= {e.name for e in inner}
    assert ("knnsvc.load_wav" in {e.name for e in inner}) == fast
    assert all(root.time_range.start <= e.time_range.start <= e.time_range.end
               <= root.time_range.end for e in inner)
    # on the calling thread every span has the root above it
    for e in inner:
        if e.thread == root.thread:
            p = e.cpu_parent
            while p is not None and p is not root:
                p = p.cpu_parent
            assert p is root, e.name


def test_smoothness_counts_its_steps_and_runs():
    from knnsvc_torch.match.smoothness import optimize_smoothness_from_surrounding as opt

    surrounding = torch.from_numpy(
        np.random.default_rng(3).standard_normal((12, 4, 3 * 8)).astype(np.float32))
    steps, runs = opt.steps, opt.runs
    _, n = opt(surrounding, max_steps=150, return_steps=True)
    assert n > 0 and opt.steps == steps + n and opt.runs == runs + 1
    opt(surrounding, max_steps=150)
    assert opt.steps == steps + 2 * n and opt.runs == runs + 2


def test_counters_names_and_tracks_the_program_counters(monkeypatch):
    from knnsvc_torch.ops.attention import gated_bias_attention_diag
    from knnsvc_torch.ops.viterbi import f0_viterbi
    from knnsvc_torch.utils.profiling import counters

    before = counters()
    assert set(before) == {"attention.launches", "attention_diag.launches",
                           "concat_cost_pair.launches", "f0_viterbi.launches",
                           "smoothness.steps", "smoothness.runs"}
    assert all(isinstance(v, int) for v in before.values())
    monkeypatch.setattr(gated_bias_attention_diag, "launches",
                        gated_bias_attention_diag.launches + 6)
    monkeypatch.setattr(f0_viterbi, "launches", f0_viterbi.launches + 2)
    after = counters()
    assert {k: after[k] - before[k] for k in after} == {
        "attention.launches": 0, "attention_diag.launches": 6, "concat_cost_pair.launches": 0,
        "f0_viterbi.launches": 2, "smoothness.steps": 0, "smoothness.runs": 0}
