"""Inputs made from the run's seed: synthetic sung audio and the random
weights of the configuration, as the parameter pytrees that `KnnSvc(...)`
and the reference both take.

`sung_wav` is a frozen copy of chip_smoke.py:365-381. The pytree layouts
follow knnsvc_torch/models/wavlm/model.py:350-410 `init_wavlm_params` and
knnsvc_torch/models/hifigan/generator.py:177-249 `init_generator_params`
(the same leaves and distributions), but every normal leaf comes from one
draw of a torch.Generator on the card, then one copy to the host.
"""

from __future__ import annotations

import os
import wave

import numpy as np

SAMPLE_RATE = 16000


def sung_wav(seconds: float, hz: float, seed: int):
    """A seeded synthetic singing voice (5 Hz vibrato, two harmonics, noise,
    phrasing) and its f0 track on the 20-ms frame grid (T//320 + 1 frames,
    as the extractors emit)."""

    def f0_at(t):
        return hz * (1 + 0.04 * np.sin(2 * np.pi * 5 * t))

    rng = np.random.default_rng(seed)
    t = np.arange(int(16000 * seconds)) / 16000
    phase = 2 * np.pi * np.cumsum(f0_at(t)) / 16000
    wav = 0.3 * np.sin(phase) + 0.1 * np.sin(2 * phase) + 0.02 * rng.standard_normal(len(t))
    wav *= 0.5 + 0.5 * np.abs(np.sin(2 * np.pi * 0.7 * t))
    frames = np.arange(len(t) // 320 + 1) * 320 / 16000
    return (np.clip(wav, -0.99, 0.99).astype(np.float32),
            f0_at(frames).astype(np.float32))


def write_wav16(path: str, wav: np.ndarray, sr: int = SAMPLE_RATE) -> None:
    """16-bit PCM mono WAV."""
    pcm = np.clip(np.round(np.asarray(wav, np.float64) * 32768.0), -32768, 32767)
    with wave.open(path, "wb") as f:
        f.setnchannels(1)
        f.setsampwidth(2)
        f.setframerate(sr)
        f.writeframes(pcm.astype("<i2").tobytes())


def spaced_lengths(lo: float, hi: float, n: int) -> np.ndarray:
    """n lengths spread evenly over [lo, hi] (the middles of n equal bins):
    every seed gets the same set."""
    return lo + (hi - lo) * (np.arange(n) + 0.5) / n


def write_files(root: str, prefix: str, lo_s: float, hi_s: float, n: int, seed: int,
                stream: int) -> tuple[list[str], list[float]]:
    """n sung WAV files of the spaced lengths, shortest first, with seeded
    noise, each at one of n pitches spread evenly over 110-440 Hz (two
    octaves) in a seeded order -> (paths, seconds)."""
    rng = np.random.default_rng([seed, stream])
    lengths = spaced_lengths(lo_s, hi_s, n)
    pitches = 110.0 * 2.0 ** rng.permutation(spaced_lengths(0.0, 2.0, n))
    seeds = rng.integers(0, 2 ** 63 - 1, n)
    paths = []
    for i in range(n):
        wav, _ = sung_wav(float(lengths[i]), float(pitches[i]), int(seeds[i]))
        path = os.path.join(root, f"{prefix}{i:02d}.wav")
        write_wav16(path, wav)
        paths.append(path)
    return paths, [float(x) for x in lengths]


# ------------------------------------------------------------------ weights
# A spec leaf is ("normal", shape, std), ("zeros", shape) or ("ones", shape).

def _normal(shape, std):
    return ("normal", tuple(shape), float(std))


def _zeros(*shape):
    return ("zeros", tuple(shape))


def _ones(*shape):
    return ("ones", tuple(shape))


def wavlm_spec(cfg: dict) -> dict:
    """The WavLM pytree (layers stacked on a leading axis)."""
    D, n, F = cfg["encoder_embed_dim"], cfg["encoder_layers"], cfg["encoder_ffn_embed_dim"]
    H = cfg["encoder_attention_heads"]
    conv_layers = eval(cfg["conv_feature_layers"])  # noqa: S307 - the config file's own spec
    fe, in_d = [], 1
    for i, (dim, kernel, _) in enumerate(conv_layers):
        blk = {"conv": {"w": _normal((dim, in_d, kernel), 0.05)}}
        if cfg["conv_bias"]:
            blk["conv"]["b"] = _zeros(dim)
        if cfg["extractor_mode"] == "layer_norm" or (cfg["extractor_mode"] == "default" and i == 0):
            blk["norm"] = {"scale": _ones(dim), "bias": _zeros(dim)}
        fe.append(blk)
        in_d = dim

    def lin(din, dout):
        return {"w": _normal((n, din, dout), 0.02), "b": _zeros(n, dout)}

    def ln(dim):
        return {"scale": _ones(n, dim), "bias": _zeros(n, dim)}

    layers = {"attn": {k: lin(D, D) for k in ("q", "k", "v", "out")}, "ln1": ln(D),
              "fc1": lin(D, F), "fc2": lin(F, D), "ln2": ln(D)}
    if cfg["gru_rel_pos"]:
        layers["attn"]["grep"] = lin(D // H, 8)
        layers["attn"]["grep_a"] = _ones(n, H)
    c0 = conv_layers[-1][0]
    spec = {"feature_extractor": {"layers": fe},
            "layer_norm": {"scale": _ones(c0), "bias": _zeros(c0)},
            "encoder": {"pos_conv": {"w": _normal((D, D // cfg["conv_pos_groups"],
                                                   cfg["conv_pos"]), 0.01), "b": _zeros(D)},
                        "layer_norm": {"scale": _ones(D), "bias": _zeros(D)},
                        "layers": layers}}
    if c0 != D:
        spec["post_extract_proj"] = {"w": _normal((c0, D), 0.02), "b": _zeros(D)}
    if cfg["relative_position_embedding"]:
        spec["encoder"]["rel_attn_bias"] = _normal((cfg["num_buckets"], H), 0.02)
    return spec


def generator_spec(h: dict, family: str, live_weight_norm: bool = False) -> dict:
    """The vocoder pytree of the 'mix' or 'f0_only' family. Weight-normed
    convs come folded ({"w"}) for serving, or as {"v", "g"} (g drawn as
    ||v|| per output row, filled in by `draw_tree`) for training."""
    rates, kernels = h["upsample_rates"], h["upsample_kernel_sizes"]
    n, uic, nh = len(rates), h["upsample_initial_channel"], h["n_harmonic"]

    def conv(out_c, in_c, k, bias=True, wn=False, std=0.01):
        p = ({"v": _normal((out_c, in_c, k), std), "g": ("norm_of_v",)}
             if wn and live_weight_norm else {"w": _normal((out_c, in_c, k), std)})
        if bias:
            p["b"] = _zeros(out_c)
        return p

    def resblock(ch, k, d):
        if h["resblock"] == "2":
            return {"convs": [conv(ch, ch, k, wn=True) for _ in d]}
        return {"convs1": [conv(ch, ch, k, wn=True) for _ in d],
                "convs2": [conv(ch, ch, k, wn=True) for _ in d]}

    if family == "mix":
        downs_ch = [(nh * 2 ** i, nh * 2 ** (i + 1)) for i in range(n)]
    else:
        downs_ch = [(nh + 2, nh + 2) for _ in range(n)]
    exc_ch = downs_ch[0][0]
    res_ch = [exc_ch] + [oc for _, oc in downs_ch]
    dec = {
        "conv_pre": conv(uic, h["hifi_dim"], 7),
        "ups": [{**conv(uic // 2 ** (i + 1), uic // 2 ** i, kernels[i], wn=True),
                 "b": _zeros(uic // 2 ** (i + 1))} for i in range(n)],
        "resblocks": [resblock(uic // 2 ** (i + 1), k, d) for i in range(n)
                      for k, d in zip(h["resblock_kernel_sizes"], h["resblock_dilation_sizes"])],
        "conv_post": conv(1, uic // 2 ** n, 7, bias=False),
        "lin_pre": {"w": _normal((h["hubert_dim"], h["hifi_dim"]), 0.02),
                    "b": _zeros(h["hifi_dim"])},
        "downs": [conv(oc, ic, kernels[n - 1 - i], wn=True) for i, (ic, oc) in enumerate(downs_ch)],
        "resblocks_downs": [{"convs": [conv(oc, oc, 3, wn=True)]} for _, oc in downs_ch],
        "concat_pre": conv(uic, uic + res_ch[n], 3),
        "concat_conv": [conv(uic // 2 ** (i + 1), uic // 2 ** (i + 1) + res_ch[n - 1 - i], 3,
                             bias=False) for i in range(n)],
    }
    # ConvTranspose1d weights are (in, out, k): swap the first two axes
    for up in dec["ups"]:
        key = "v" if "v" in up else "w"
        _, shape, std = up[key]
        up[key] = _normal((shape[1], shape[0], shape[2]), std)
    return {"dec": dec, "sin_prenet": conv(exc_ch, 1, 3)}


def _leaves(spec, out: list) -> list:
    if isinstance(spec, dict):
        for v in spec.values():
            _leaves(v, out)
    elif isinstance(spec, list):
        for v in spec:
            _leaves(v, out)
    else:
        out.append(spec)
    return out


def draw_tree(spec, seed: int, device) -> object:
    """Spec tree -> numpy pytree. Every normal leaf is a slice of one
    torch.randn on `device` from a generator seeded with `seed` (the leaves
    in the spec's order), scaled on the device and copied to the host once."""
    import torch

    normals = [leaf for leaf in _leaves(spec, []) if leaf[0] == "normal"]
    total = sum(int(np.prod(shape)) for _, shape, _ in normals)
    gen = torch.Generator(device=device).manual_seed(int(seed))
    buf = torch.randn(total, generator=gen, device=device, dtype=torch.float32)
    offsets, o = [], 0
    for _, shape, std in normals:
        n = int(np.prod(shape))
        buf[o:o + n].mul_(std)
        offsets.append(o)
        o += n
    host = buf.cpu().numpy()
    del buf
    host_rng = np.random.default_rng(int(seed))      # the few spectral-norm vectors
    it = iter(zip(normals, offsets))

    def build(node):
        if isinstance(node, tuple) and node[0] == "unit":
            v = host_rng.standard_normal(node[1])
            return (v / np.linalg.norm(v)).astype(np.float32)
        if isinstance(node, dict):
            built = {k: build(v) for k, v in node.items() if not _is_norm_leaf(v)}
            for k, v in node.items():
                if _is_norm_leaf(v):
                    vv = built["v"]
                    built[k] = np.linalg.norm(vv.reshape(vv.shape[0], -1), axis=1
                                              ).reshape(-1, *([1] * (vv.ndim - 1))
                                                        ).astype(np.float32)
            return built
        if isinstance(node, list):
            return [build(v) for v in node]
        if node[0] == "normal":
            (_, shape, _), off = next(it)
            return host[off:off + int(np.prod(shape))].reshape(shape)
        return (np.zeros if node[0] == "zeros" else np.ones)(node[1], np.float32)

    return build(spec)


def _is_norm_leaf(v) -> bool:
    return isinstance(v, tuple) and v and v[0] == "norm_of_v"


def serving_weights(config: dict, seed: int, device):
    """(WavLM pytree, vocoder pytree) of a serving configuration."""
    family = "mix" if config["family"] == "mix" else "f0_only"
    wavlm = draw_tree(wavlm_spec(config["wavlm"]), seed, device)
    vocoder = draw_tree(generator_spec(config["hifigan"], family), seed + 1, device)
    return wavlm, vocoder


# ------------------------------------------------------------------ training
# MPD and MSD trees as knnsvc_torch/models/hifigan/discriminator.py:244-292
# lays them out (std 0.02, zero biases, live weight norm; MSD scale 0
# spectral-normed with unit u and v_pow).

MPD_PERIODS = (2, 3, 5, 7, 11)
MPD_CHANNELS = (32, 128, 512, 1024)
MSD_SPECS = [(128, 15, 1, 1, 7), (128, 41, 2, 4, 20), (256, 41, 2, 16, 20),
             (512, 41, 4, 16, 20), (1024, 41, 4, 16, 20), (1024, 41, 1, 16, 20),
             (1024, 5, 1, 1, 2)]        # (out, kernel, stride, groups, pad)


def msd_channels(width_scale: int) -> list[tuple[int, int, int, int, int, int]]:
    """(in, out, kernel, stride, groups, pad) of each scale conv."""
    in_c, out = 1, []
    for o, k, s, g, pad in MSD_SPECS:
        o = max(g, o // width_scale)
        out.append((in_c, o, k, s, g, pad))
        in_c = o
    return out


def _wn(shape):
    return {"v": _normal(shape, 0.02), "g": ("norm_of_v",), "b": _zeros(shape[0])}


def mpd_spec(width_scale: int = 1) -> dict:
    top = 1024 // width_scale
    chans = [1] + [c // width_scale for c in MPD_CHANNELS] + [top]
    return {"discriminators": [
        {"convs": [_wn((chans[i + 1], chans[i], 5, 1)) for i in range(4)] + [_wn((top, top, 5, 1))],
         "conv_post": _wn((1, top, 3, 1))} for _ in MPD_PERIODS]}


def msd_spec(width_scale: int = 1) -> dict:
    specs = msd_channels(width_scale)
    discs = []
    for d in range(3):
        def conv(o, i, k):
            if d:
                return _wn((o, i, k))
            return {"v_sn": _normal((o, i, k), 0.02), "u": ("unit", o), "v_pow": ("unit", i * k),
                    "b": _zeros(o)}
        discs.append({"convs": [conv(o, i // g, k) for i, o, k, s, g, pad in specs],
                      "conv_post": conv(1, specs[-1][1], 3)})
    return {"discriminators": discs}


def train_weights(config: dict, seed: int, device):
    """(generator, MPD, MSD) trees of the training state: the generator's
    weight norms live."""
    family = "mix" if config["family"] == "mix" else "f0_only"
    ws = config.get("disc_width_scale", 1)
    g = draw_tree(generator_spec(config["hifigan"], family, live_weight_norm=True), seed, device)
    mpd = draw_tree(mpd_spec(ws), seed + 1, device)
    msd = draw_tree(msd_spec(ws), seed + 2, device)
    return g, mpd, msd


def train_batches(config: dict, n: int, seed: int, device, log_mel) -> list[dict]:
    """n batches of the configuration's shape on `device`, drawn there from
    the seed in one call per field: feats (B, T, 1024) unit normals, audio
    (B, T*hop) a seeded sum of three harmonics at f0 with noise, its
    log-mel `log_mel(audio)` as the mel target, f0 (B, T, 1) in 110-440 Hz
    with a fifth of the frames unvoiced, harmonics (B, T, 49) |normal| x 0.01."""
    import torch

    h = config["hifigan"]
    B, hop = h["batch_size"], h["hop_size"]
    T = h["segment_size"] // hop
    gen = torch.Generator(device=device).manual_seed(int(seed))
    feats = torch.randn((n, B, T, h["hubert_dim"]), generator=gen, device=device)
    base = 110.0 * 2.0 ** (2.0 * torch.rand((n, B, 1, 1), generator=gen, device=device))
    f0 = base * (1 + 0.04 * torch.randn((n, B, T, 1), generator=gen, device=device))
    f0 = torch.where(torch.rand((n, B, T, 1), generator=gen, device=device) < 0.2, 0.0, f0)
    harm = 0.01 * torch.randn((n, B, T, 49), generator=gen, device=device).abs()
    t = torch.arange(T * hop, device=device) / h["sampling_rate"]
    phase = 2 * torch.pi * base[..., 0] * t                                   # (n, B, T*hop)
    audio = (0.3 * torch.sin(phase) + 0.1 * torch.sin(2 * phase) + 0.05 * torch.sin(3 * phase)
             + 0.02 * torch.randn((n, B, T * hop), generator=gen, device=device))
    out = []
    for i in range(n):
        out.append({"feats": feats[i].contiguous(), "audio": audio[i].contiguous(),
                    "mel_loss": log_mel(audio[i]), "f0": f0[i].contiguous(),
                    "harmonics": harm[i].contiguous()})
    return out
