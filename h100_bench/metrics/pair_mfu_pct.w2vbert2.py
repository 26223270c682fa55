"""The matmul and conv FLOPs of the untraced window's requests through
w2v-BERT 2.0 (counts/w2vbert.py for the encoder on every 30-s chunk of
both files; counts/flops.py's match_flops and hifigan_flops at each
request's lengths), over its wall time on the host's clock, against the
card's 67-TFLOP/s fp32 peak."""

from types import SimpleNamespace

from h100_bench.counts import flops, w2vbert
from h100_bench.counts.peaks import PEAK_FP32_FLOPS


def request_flops(u, config, traffic):
    w, h = config["w2vbert"], SimpleNamespace(**config["hifigan"])
    total = sum(w2vbert.encoder_flops(w, config["encoder_layers_run"], T)
                for T in u["src_chunks"] + u["tgt_chunks"])
    Ts, P = sum(u["src_chunks"]), sum(u["tgt_chunks"])
    total += flops.match_flops(Ts, P, w["hidden_size"], topk=traffic["topk"],
                               concat=traffic["post_opt"] != "no_post_opt")
    return total + flops.hifigan_flops(h, Ts, "mix" if config["family"] == "mix" else "f0")


def read(view):
    if not view.window_units or view.window_wall_s <= 0:
        return None
    work = sum(request_flops(u, view.config, view.traffic) for u in view.window_units)
    return 100.0 * work / view.window_wall_s / PEAK_FP32_FLOPS
