"""Shared arithmetic of the share readers: the device's idle share of a
traced stretch, the attention and concat kernels' roofline shares, and the
requests' share of the fp32 peak in the untraced window, from the frozen
counts."""

from h100_bench.counts import bounds, flops
from h100_bench.counts.peaks import PEAK_FP32_FLOPS

ATTENTION_KERNEL = "gated_bias_attention"
CONCAT_KERNELS = ("concat_cost_prepass", "concat_cost_chain")


def idle_pct(view):
    if not view.has_device or view.window_s <= 0:
        return None
    return 100.0 * (1.0 - view.busy_s / view.window_s)


def attention_roofline_pct(view):
    """The summed bound of the traced requests' attention launches (each
    layer run on each 30-s chunk of both files) over their summed kernel
    time; nothing when the launches are not the ones counted."""
    w = view.config["wavlm"]
    layers = view.config["encoder_layers_run"]
    H, d = w["encoder_attention_heads"], w["encoder_embed_dim"] // w["encoder_attention_heads"]
    chunks = [T for u in view.units for T in u["src_chunks"] + u["tgt_chunks"]]
    kernel_ms = view.kernel_ms(ATTENTION_KERNEL)
    if not view.has_device or kernel_ms <= 0 or view.launches(ATTENTION_KERNEL) != layers * len(chunks):
        return None
    return 100.0 * sum(layers * bounds.attention_bound_ms(H, T, d)[0] for T in chunks) / kernel_ms


def concat_roofline_pct(view):
    """The summed concat bound of the traced requests (T source frames
    against P pool rows, one lane a selection) over the time of the
    kernel's pre-pass and chain launches."""
    D = view.config["wavlm"]["encoder_embed_dim"]
    lanes = 2 if view.config["family"] == "mix" else 1
    k = view.traffic["topk"]
    kernel_ms = sum(view.kernel_ms(name) for name in CONCAT_KERNELS)
    if not view.has_device or kernel_ms <= 0 or view.launches(CONCAT_KERNELS[1]) != len(view.units):
        return None
    return 100.0 * sum(bounds.concat_bound_ms(sum(u["src_chunks"]), sum(u["tgt_chunks"]), D,
                                              lanes, k)[0] for u in view.units) / kernel_ms


def request_flops(u, config, traffic):
    """Matmul and conv FLOPs of one request: the conv frontend and the
    encoder layers run on every chunk of both files, the kNN (and the
    concat costs with post_opt), the vocoder over the source's frames."""
    from types import SimpleNamespace

    w, h = config["wavlm"], SimpleNamespace(**config["hifigan"])
    total = 0
    for T, n_samples in zip(u["src_chunks"] + u["tgt_chunks"], u["chunk_samples"]):
        total += flops.conv_frontend_flops(w["conv_feature_layers"], n_samples)[0]
        total += flops.wavlm_encoder_flops(w["encoder_embed_dim"], w["encoder_ffn_embed_dim"],
                                           config["encoder_layers_run"], T, w["conv_pos"],
                                           w["conv_pos_groups"])
    Ts, P = sum(u["src_chunks"]), sum(u["tgt_chunks"])
    total += flops.match_flops(Ts, P, w["encoder_embed_dim"], topk=traffic["topk"],
                               concat=traffic["post_opt"] != "no_post_opt")
    total += flops.hifigan_flops(h, Ts, "mix" if config["family"] == "mix" else "f0")
    return total


def pair_mfu_pct(view):
    """The FLOPs of the window's requests over its wall time, against the
    fp32 peak (TF32 is off under "highest"): the whole request's share, in
    the untraced window that the traced requests follow."""
    if not view.window_units or view.window_wall_s <= 0:
        return None
    work = sum(request_flops(u, view.config, view.traffic) for u in view.window_units)
    return 100.0 * work / view.window_wall_s / PEAK_FP32_FLOPS
