"""A copy of the benchmark at a size the CPU runs in seconds: the cells of
BENCHMARK.json with tiny configurations (WavLM 16 wide, 6 layers, a
stride-320 frontend; a 32-channel vocoder) and short files."""

from __future__ import annotations

import json
import shutil
from pathlib import Path

BENCH = Path(__file__).resolve().parents[1]
REPO = BENCH.parent

TINY_WAVLM = dict(encoder_layers=6, encoder_embed_dim=16, encoder_ffn_embed_dim=32,
                  encoder_attention_heads=2,
                  conv_feature_layers="[(16,10,5)] + [(16,4,4)] * 3", conv_bias=True,
                  conv_pos=8, conv_pos_groups=2, num_buckets=16, max_distance=32)
TINY_HIFIGAN = dict(upsample_initial_channel=32, n_harmonic=4, hubert_dim=16, hifi_dim=16,
                    resblock_kernel_sizes=[3], resblock_dilation_sizes=[[1, 3, 5]],
                    batch_size=2, segment_size=1280)
TINY_TRAFFIC = dict(n_files=4, source_s=[0.6, 1.4], target_s=[1.0, 2.0], check_requests=2,
                    trace_requests=2, n_batches=4, warm_steps=1, trace_steps=2)


def make_root(tmp: Path) -> Path:
    """tmp/BENCHMARK.json and tmp/h100_bench/{configs,traffic,drivers,metrics,
    limits} at the tiny size; returns tmp."""
    bench = json.loads((REPO / "BENCHMARK.json").read_text())
    (tmp / "BENCHMARK.json").write_text(json.dumps(bench))
    for sub in ("configs", "traffic", "drivers", "metrics", "limits"):
        if (BENCH / sub).is_dir():
            shutil.copytree(BENCH / sub, tmp / "h100_bench" / sub,
                            ignore=shutil.ignore_patterns("__pycache__"))
    for path in (tmp / "h100_bench" / "configs").glob("*.json"):
        cfg = json.loads(path.read_text())
        if "wavlm" in cfg:
            cfg["wavlm"].update(TINY_WAVLM)
        cfg["hifigan"].update(TINY_HIFIGAN)
        cfg["disc_width_scale"] = 8
        path.write_text(json.dumps(cfg))
    for path in (tmp / "h100_bench" / "traffic").glob("*.json"):
        tr = json.loads(path.read_text())
        tr.update({k: v for k, v in TINY_TRAFFIC.items() if k in tr})
        path.write_text(json.dumps(tr))
    return tmp
