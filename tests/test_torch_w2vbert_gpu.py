"""w2v-BERT 2.0 on a card at its published widths (h100_bench/configs/
knnsvc-w2vbert2.json): the relative-key attention through the attention
kernel's full-bias entry against the plain attention, the encoder's 17
layers on a 30-s chunk (T = 1499) against the benchmark's plain reference,
and one pair through `convert_pair(fast=True)` with post_opt_0.2 against
the reference pipeline. Every test is marked gpu and skips when torch sees
no CUDA device (decided inside the test). The file imports neither JAX nor
the JAX package:

    python -m pytest tests/test_torch_w2vbert_gpu.py -m gpu --noconftest -p no:cacheprovider -s

Tolerances: the attention 1e-4, the kernel's bound at T = 1500
(tests/test_torch_gpu.py), under "highest". The encoder and the pair are
held to the cell's limits (h100_bench/limits/w2vbert2.pair_new.json: the
layer-17 features' largest frame error, and the rest of the pair's
numbers), and the reference computed in TF32 must exceed the feature limit,
so the bound separates the precisions.
"""

import json
import math
from pathlib import Path

import numpy as np
import pytest
import torch

REPO = Path(__file__).resolve().parents[1]
ATTN_ATOL = 1e-4


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    from knnsvc_torch.precision import set_precision

    set_precision("highest")
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _config() -> dict:
    return json.loads((REPO / "h100_bench" / "configs" / "knnsvc-w2vbert2.json").read_text())


def _limits() -> dict:
    return json.loads((REPO / "h100_bench" / "limits" / "w2vbert2.pair_new.json").read_text())[
        "limits"]


def _rows_rel(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    a, b = a.double(), b.double()
    return (a - b).norm(dim=-1) / b.norm(dim=-1)


def _time_ms(fn, n=20) -> float:
    fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(n):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / n


@pytest.mark.gpu
def test_relative_key_attention_matches_plain(cuda):
    """(16, 1499, 64), the (73, 64) table at window (64, 8): the gathered
    bias through the full-bias entry under a unit gate against the plain
    attention; prints the gather's and the kernel's CUDA-event times."""
    from knnsvc_torch.models.w2vbert.model import relative_index, relative_key_bias
    from knnsvc_torch.ops.attention import gated_bias_attention, reference_attention

    H, T, d = 16, 1499, 64
    g = torch.Generator(device=cuda).manual_seed(0)
    q, k, v = (0.6 * torch.randn(H, T, d, generator=g, device=cuda) for _ in range(3))
    table = torch.randn(73, d, generator=g, device=cuda)
    index = relative_index(T, 64, 8, cuda)
    gate = torch.ones(H, T, device=cuda)
    bias = relative_key_bias(q, table, index)
    out = gated_bias_attention(q, k, v, bias, gate)
    plain = reference_attention(q.cpu().double(), k.cpu().double(), v.cpu().double(),
                                bias.cpu().double(), gate.cpu().double())
    err = float((out.cpu().double() - plain).abs().max())
    # the gathered bias is HF's einsum over the (T, T, d) table
    rows = torch.arange(0, T, 97, device=cuda)
    dist = torch.clamp(torch.arange(T, device=cuda)[None, :] - rows[:, None], -64, 8) + 64
    direct = torch.einsum("hld,lrd->hlr", q[:, rows].double(), table[dist].double()) / math.sqrt(d)
    gather_ms = _time_ms(lambda: relative_key_bias(q, table, index))
    kernel_ms = _time_ms(lambda: gated_bias_attention(q, k, v, bias, gate))
    print(f"[w2vbert] rel-key attention (16, 1499, 64): max abs error {err:.3e}; "
          f"bias gather {gather_ms:.4f} ms, kernel {kernel_ms:.4f} ms "
          f"({torch.cuda.get_device_name(0)})")
    assert err <= ATTN_ATOL
    assert float((bias[:, rows].double() - direct).abs().max()) <= 1e-5


@pytest.mark.gpu
def test_encoder_matches_the_reference_at_published_widths(cuda):
    """The 17 layers of w2v-BERT 2.0 on a 30-s sung chunk (T = 1499) with the
    benchmark's seeded weights: every frame of layer 17 against the
    reference within the cell's feature limit; the reference in TF32 is
    not."""
    from h100_bench import inputs
    from h100_bench.drivers.pair_w2vbert2 import serving_weights
    from h100_bench.reference import pipeline_w2vbert2
    from knnsvc_torch.config import W2VBertConfig
    from knnsvc_torch.models.w2vbert import w2vbert_from_state_dict

    cfg = _config()
    layers = cfg["encoder_layers_run"]
    state, _ = serving_weights(cfg, 1_234_567_891, cuda)
    wav, _ = inputs.sung_wav(30.0, 196.0, 5)
    codes = np.round(wav * 32768.0).astype(np.int16)              # 480 000 samples, 1499 rows
    x = torch.from_numpy(codes).to(cuda)[None].float() / 32768
    port = w2vbert_from_state_dict(state, W2VBertConfig.from_dict(cfg["w2vbert"]), cuda)
    with torch.no_grad():
        prog = port.extract_layer(x, layers)[0]
    del port
    ref = pipeline_w2vbert2.build_encoder(state, cfg["w2vbert"], cuda, layers)
    plain = ref.extract_layer(x, layers)[0]
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = True
    try:
        control = ref.extract_layer(x, layers)[0]
    finally:
        torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    err, ctl = _rows_rel(prog, plain), _rows_rel(control, plain)
    limit = _limits()["feat_rel_max"]
    print(f"[w2vbert] layer {layers}, T = {prog.shape[0]}: program max {float(err.max()):.3e} "
          f"median {float(err.median()):.3e}; TF32 reference max {float(ctl.max()):.3e} "
          f"median {float(ctl.median()):.3e}; limit {limit:.1e}")
    assert prog.shape == (1499, 1024)
    assert float(err.max()) <= limit < float(ctl.max())


@pytest.mark.gpu
def test_convert_pair_post_opt_matches_the_reference_pipeline(cuda, tmp_path):
    """One 30-s source against a 60-s target, post_opt_0.2, device f0, int16
    uploads, through KnnSvc.convert_pair(fast=True) at the published widths,
    against pipeline_w2vbert2.convert from the same files and weights."""
    from h100_bench import compare, inputs
    from h100_bench.drivers.pair import Tap, _host
    from h100_bench.drivers.pair_w2vbert2 import _service, serving_weights
    from h100_bench.reference import pipeline_w2vbert2
    from h100_bench.reference.config import HiFiGANConfig

    cfg = _config()
    tr = json.loads((REPO / "h100_bench" / "traffic" / "pair_new.w2vbert2.json").read_text())
    weights = serving_weights(cfg, 2_100_000_007, cuda)
    svc = _service(cfg, tr, weights, cuda)
    srcs, _ = inputs.write_files(str(tmp_path), "src", 30.0, 30.0, 1, 8, 1)
    tgts, _ = inputs.write_files(str(tmp_path), "tgt", 60.0, 60.0, 1, 9, 2)
    with Tap() as tap:
        tap.keep = {}
        svc.convert_pair(srcs[0], tgts[0], post_opt="post_opt_0.2", fast=True,
                         upload_dtype="int16", output_path=str(tmp_path / "out.wav"))
        prog = _host(tap.keep)
    del svc
    torch.cuda.empty_cache()
    enc = pipeline_w2vbert2.build_encoder(weights[0], cfg["w2vbert"], cuda,
                                          cfg["encoder_layers_run"])
    voc = pipeline_w2vbert2.build_vocoder(weights[1], HiFiGANConfig.from_dict(cfg["hifigan"]),
                                          cfg["ckpt_type"], cuda)
    ref = pipeline_w2vbert2.convert(srcs[0], tgts[0], enc, voc, cfg["ckpt_type"], "post_opt_0.2",
                                    4, cuda)
    numbers = compare.pair_numbers(prog, {k: None if v is None else v.detach().cpu().numpy()
                                          for k, v in ref.items()})
    print(f"[w2vbert] post_opt_0.2 pair: {numbers}")
    for name, limit in _limits().items():
        assert numbers[name] <= limit, (name, numbers[name], limit)


@pytest.mark.gpu
def test_random_init_builds_the_published_encoder(cuda):
    from knnsvc_torch.hub import KnnSvc
    from knnsvc_torch.models.w2vbert import W2VBert

    svc = KnnSvc.random_init("mix", seed=1, device="cuda", encoder="w2v-bert-2.0")
    assert isinstance(svc.wavlm, W2VBert) and len(svc.wavlm.encoder.layers) == 17
    assert int(np.argmax(svc.weighting)) == 17
    with torch.no_grad():
        out = svc.wavlm.extract_layer(torch.zeros(1, 16320, device=cuda).uniform_(-0.1, 0.1), 17)
    assert out.shape == (1, 50, 1024) and bool(torch.isfinite(out).all())
