"""The w2v-BERT 2.0 cell (drivers/pair_w2vbert2.py) on the CPU at a tiny
size: the encoder 32 wide, 2 heads, 3 layers run, a relative window of
(4, 2), a depthwise kernel of 5. The driver reads `correct` on a sound
program, and not correct when one layer's relative-key term or its
convolution module is dropped from the timed path; its traced units carry
the counters the attention reader holds its launches to."""

from __future__ import annotations

import json

import pytest
import torch

from h100_bench import run
from h100_bench.harness import load_cell
from h100_bench.reference import w2vbert as reference

CELL = "w2vbert2.pair_new"
TINY_W2VBERT = dict(hidden_size=32, num_attention_heads=2, intermediate_size=64,
                    left_max_position_embeddings=4, right_max_position_embeddings=2,
                    conv_depthwise_kernel_size=5, feature_layer=3)
LAYERS = 3


@pytest.fixture
def w2v_root(tiny_root):
    path = tiny_root / "h100_bench" / "configs" / "knnsvc-w2vbert2.json"
    cfg = json.loads(path.read_text())
    cfg["w2vbert"].update(TINY_W2VBERT)
    cfg["encoder_layers_run"] = LAYERS
    cfg["hifigan"]["hubert_dim"] = TINY_W2VBERT["hidden_size"]
    path.write_text(json.dumps(cfg))
    return tiny_root


def _run(capsys, root, trace=0, seed=4_000_000_007):
    rc = run.main(["--workload", CELL, "--seed", str(seed), "--seconds", "0.5",
                   "--trace", str(trace)], root=str(root), device="cpu")
    out, err = capsys.readouterr()
    assert rc == 0, err[-3000:]
    return json.loads(out.strip().splitlines()[-1])


def _every_nth_layer(monkeypatch, cls, name, layer, replace):
    """Wrap cls.name so that its call in `layer` (0-based, of LAYERS run on
    each chunk) returns replace(original result)."""
    orig = getattr(cls, name)
    calls = [0]

    def wrapped(*a, **kw):
        r = orig(*a, **kw)
        calls[0] += 1
        return replace(r) if (calls[0] - 1) % LAYERS == layer else r

    monkeypatch.setattr(cls, name, wrapped)


def test_cell_reads_correct(capsys, w2v_root):
    result = _run(capsys, w2v_root)
    assert result["correct"] is True and result["failed"] == 0
    cell = load_cell(CELL, str(w2v_root))
    assert set(result["metrics"]) == {m["name"] for m in cell.end_to_end}
    assert set(result["checks"]) == set(cell.limits["limits"])


def test_traced_units_count_the_layers_run(capsys, w2v_root, monkeypatch):
    """The traced requests' counters: every chunk of both files runs the
    configuration's layers; the CPU gives no device readings, the MFU
    reader reads."""
    from h100_bench import harness

    seen = {}
    orig = harness.reduce_trace

    def keep(events, window_s):
        view = orig(events, window_s)
        seen["view"] = view
        return view

    monkeypatch.setattr(harness, "reduce_trace", keep)
    result = _run(capsys, w2v_root, trace=1)
    assert result["correct"] is True
    assert result["metrics"]["pair_mfu_pct.w2vbert2"]["value"] > 0
    assert "rel_attention_roofline_pct" not in result["metrics"]
    units = seen["view"].units
    assert units and all(u["w2vbert_layers_run"] == LAYERS * u["w2vbert_chunks"]
                         and u["w2vbert_chunks"] == len(u["src_chunks"] + u["tgt_chunks"])
                         for u in units)


def test_relative_key_term_dropped_is_not_correct(capsys, w2v_root, monkeypatch):
    import knnsvc_torch.models.w2vbert.model as model

    _every_nth_layer(monkeypatch, model, "relative_key_bias", 1, torch.zeros_like)
    result = _run(capsys, w2v_root)
    assert result["correct"] is False
    assert result["checks"]["feat_rel_max"]["value"] > result["checks"]["feat_rel_max"]["limit"]


def test_convolution_module_dropped_is_not_correct(capsys, w2v_root, monkeypatch):
    import knnsvc_torch.models.w2vbert.model as model

    _every_nth_layer(monkeypatch, model.ConvolutionModule, "forward", 2, torch.zeros_like)
    result = _run(capsys, w2v_root)
    assert result["correct"] is False
    assert result["checks"]["feat_rel_max"]["value"] > result["checks"]["feat_rel_max"]["limit"]


def test_frame_count_is_the_stacked_fbank():
    """drivers/pair_w2vbert2.py's FBANK_FRAMES counts the reference
    frontend's rows, which are WavLM's m - 1 for 320 m samples."""
    from h100_bench.drivers.pair import chunk_frames
    from h100_bench.drivers.pair_w2vbert2 import FBANK_FRAMES

    for n in (641, 959, 4000, 16000 * 3 + 17):
        wav = torch.zeros(n + 320 - n % 320)
        wav[::7] = 0.01
        rows = reference.input_features(wav).shape[0]
        assert chunk_frames(n, FBANK_FRAMES) == [rows] == [len(wav) // 320 - 1]
