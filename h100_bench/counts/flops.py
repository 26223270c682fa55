"""Analytic matmul and conv FLOPs (2 x multiply-adds) of the serving path's
stages: a frozen copy of knnsvc_torch/utils/flops.py:20-126
(`conv_frontend_flops`, `wavlm_encoder_flops`, `match_flops`,
`hifigan_flops`), which tests/test_torch_aux.py holds equal to the JAX
package's counts. Elementwise work, norms, softmax and the serial scans
are left out, so a share of the peak computed from them is a lower bound."""

from __future__ import annotations

def conv_frontend_flops(conv_feature_layers: str, n_samples: int) -> tuple[int, int]:
    """(FLOPs, output frames) of the WavLM conv feature extractor on one
    utterance of `n_samples` samples (stride-valid conv lengths)."""
    # the spec string is python (with list arithmetic), same as
    # WavLMConfig.conv_layers
    layers = eval(conv_feature_layers)  # noqa: S307 - trusted config
    L, in_ch, total = n_samples, 1, 0
    for c, k, s in layers:
        L = (L - k) // s + 1
        total += 2 * k * in_ch * c * L
        in_ch = c
    return total, L


def wavlm_encoder_flops(embed_dim: int, ffn_dim: int, n_layers: int,
                        t_frames: int, conv_pos: int = 128,
                        conv_pos_groups: int = 16) -> int:
    """Transformer encoder FLOPs for `n_layers` executed layers (early exit
    runs only the first `output_layer` layers) over `t_frames` frames:
    QKVO projections (8TD^2) + attention scores/apply (4T^2D) + FFN (4TDF),
    plus the one positional conv (grouped, D -> D, kernel conv_pos)."""
    d, f, t = embed_dim, ffn_dim, t_frames
    per_layer = 8 * t * d * d + 4 * t * t * d + 4 * t * d * f
    pos_conv = 2 * conv_pos * (d // conv_pos_groups) * d * t
    return n_layers * per_layer + pos_conv


def match_flops(t_frames: int, pool_rows: int, dim: int,
                k: int = 32, topk: int = 4,
                concat: bool = False) -> int:
    """kNN candidate search (the T x P x D distance matmul dominates) plus,
    when concat reselection runs, the per-frame 2k-candidate cost matmuls."""
    total = 2 * t_frames * pool_rows * dim
    if concat:
        # per frame: matching cost (2k x D dot) + concat cost (k x 2k x D),
        # two lanes (unpitched + pitched)
        total += 2 * t_frames * 2 * (2 * topk * dim * (topk + 1))
    return total


def hifigan_flops(h, t_frames: int, family: str = "mix") -> int:
    """Generator conv FLOPs for one utterance of `t_frames` feature frames
    (model structure: models/hifigan/generator.py — lin_pre, conv_pre,
    DDSP down branch (strided convs + resblock3) and concat convs for the
    mix/f0 families, ConvTranspose upsample stack, resblock groups,
    conv_post)."""
    rates = list(h.upsample_rates)
    kernels = list(h.upsample_kernel_sizes)
    uic = h.upsample_initial_channel
    n_up = len(rates)
    ddsp = family in ("mix", "f0")
    total = 0
    t = t_frames

    if ddsp:
        total += 2 * t * h.hubert_dim * h.hifi_dim          # lin_pre
        conv_pre_in = h.hifi_dim
    else:
        conv_pre_in = h.hubert_dim
    total += 2 * 7 * conv_pre_in * uic * t                   # conv_pre

    n_samples = t
    for r in rates:
        n_samples *= r

    skip_chans = []  # channels of res_features[1..n_up] (generator.py:77-85)
    if ddsp:
        # sin_prenet on the excitation (1 -> exc channels, k=3) @ sample rate
        exc_ch = h.n_harmonic + (2 if family == "f0" else 0)
        total += 2 * 3 * 1 * exc_ch * n_samples
        # down branch: strided convs (rates reversed; mix doubles channels,
        # f0 keeps them constant — generator._down_channels) + resblock3
        L = n_samples
        in_ch = exc_ch
        for i in range(n_up):
            k = kernels[n_up - 1 - i]
            out_ch = exc_ch * 2 ** (i + 1) if family == "mix" else exc_ch
            L //= rates[n_up - 1 - i]
            total += 2 * k * in_ch * out_ch * L              # strided conv
            total += 2 * 3 * out_ch * out_ch * L             # resblock3
            in_ch = out_ch
            skip_chans.append(out_ch)
        total += 2 * 3 * (uic + in_ch) * uic * t             # concat_pre
        skip_chans = [exc_ch] + skip_chans  # res_features[0] is the raw exc

    L = t
    ch = uic
    for i in range(n_up):
        out_ch = uic // (2 ** (i + 1))
        # transposed conv: every INPUT element feeds k taps, so useful MACs
        # scale with the input length — a zero-inserted (dilated) view's
        # zeros do no model work and are excluded (MFU counts useful FLOPs;
        # a library that executes the dilated conv literally shows the
        # waste as low %-peak on this stage)
        total += 2 * kernels[i] * ch * out_ch * L            # ConvTranspose
        L *= rates[i]
        ch = out_ch
        if ddsp:
            # concat_conv folds skip res_features[n_up-1-i] back in (k=3)
            total += 2 * 3 * (ch + skip_chans[n_up - 1 - i]) * ch * L
        # resblock1: one convs1 (dilated) + one convs2 per dilation;
        # resblock2: one conv per dilation
        for rk, rd in zip(h.resblock_kernel_sizes, h.resblock_dilation_sizes):
            n_convs = (2 if h.resblock == "1" else 1) * len(rd)
            total += n_convs * 2 * rk * ch * ch * L
    total += 2 * 7 * ch * 1 * L                              # conv_post
    return total
