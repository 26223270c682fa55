"""Shared helpers (no tests) of the knnsvc_torch parity tests, test_torch_*.py:
the same seeded numpy inputs and JAX-initialized parameters go through the
JAX package and its port, on the CPU."""

import jax
import numpy as np
import pytest
import torch

from knnsvc_tpu.config import HiFiGANConfig as JaxHiFiGANConfig
from knnsvc_tpu.config import ModelFamily as JaxModelFamily
from knnsvc_tpu.config import WavLMConfig as JaxWavLMConfig
from knnsvc_tpu.models.hifigan import init_generator_params
from knnsvc_tpu.models.wavlm import init_wavlm_params
from knnsvc_torch.config import HiFiGANConfig, ModelFamily, WavLMConfig

from test_pipeline import SMALL_HIFIGAN, SMALL_WAVLM, _sing  # noqa: F401  (re-exported)

FAMILIES = {"mix": (ModelFamily.MIX, JaxModelFamily.MIX),
            "wavlm_only": (ModelFamily.F0_ONLY, JaxModelFamily.F0_ONLY),
            "wavlm_only_original": (ModelFamily.ORIGINAL, JaxModelFamily.ORIGINAL)}


def small_wavlm(seed: int = 0, overrides: dict | None = None):
    """(port cfg, JAX cfg, numpy params) of the small test encoder."""
    spec = {**SMALL_WAVLM, **(overrides or {})}
    jcfg = JaxWavLMConfig.from_dict(spec)
    params = jax.tree.map(np.asarray, init_wavlm_params(jax.random.PRNGKey(seed), jcfg))
    return WavLMConfig.from_dict(spec), jcfg, params


def small_generator(ckpt_type: str, seed: int = 1, overrides: dict | None = None):
    """(port cfg, JAX cfg, port family, JAX family, numpy params) of the
    small test vocoder. Weights are rescaled to std 1/sqrt(fan_in): at the
    init's std 0.01 the waveform stays near 1e-5, too small to test. With
    overrides {"resblock": "2", ...} each residual block keeps the first
    len(dilations) convs of its ResBlock1 init as ResBlock2's {"convs"}."""
    spec = {**SMALL_HIFIGAN, **(overrides or {})}
    h = HiFiGANConfig.from_dict(spec)
    jh = JaxHiFiGANConfig.from_dict(spec)
    fam, jfam = FAMILIES[ckpt_type]
    params = jax.tree.map(np.asarray, init_generator_params(jax.random.PRNGKey(seed), jh, jfam))
    if h.resblock == "2":
        params["dec"]["resblocks"] = [
            {"convs": rb["convs1"][:len(d)]}
            for rb, d in zip(params["dec"]["resblocks"],
                             [d for _ in h.upsample_rates for d in h.resblock_dilation_sizes])]

    def rescale(tree, key=None):
        if isinstance(tree, dict):
            return {k: rescale(v, k) for k, v in tree.items()}
        if isinstance(tree, list):
            return [rescale(v) for v in tree]
        if key == "w":
            fan_in = int(np.prod(tree.shape[1:])) if tree.ndim == 3 else tree.shape[0]
            return (tree / tree.std() / np.sqrt(fan_in)).astype(np.float32)
        return tree

    return h, jh, fam, jfam, rescale(params)


SR = 16000


def _vibrato_f0(n_frames, hz, seed):
    """A sung f0 track (5 Hz vibrato of +-4%, jitter, unvoiced runs). The
    pitched re-rank orders candidates by log2 distance, and a pure tone's
    near-identical f0s would leave their order to the last bit of log,
    where XLA's and torch's differ on some values
    (test_torch_match.py::test_sort_by_f0_compatibility_near_ties)."""
    rng = np.random.default_rng(seed)
    t = np.arange(n_frames) / 50.0
    f0 = hz * (1 + 0.04 * np.sin(2 * np.pi * 5 * t)) + rng.normal(0, 1.5, n_frames)
    f0[rng.random(n_frames) < 0.15] = 0.0
    return f0.astype(np.float32)


def write_pair(root):
    """A 1-s source and a 1.3-s target WAV under `root`, each with an
    `_f0.npy` sidecar, so both packages skip the f0 extractor. -> paths."""
    from knnsvc_torch.dsp.f0 import save_f0_sidecar
    from knnsvc_torch.io.audio import save_audio

    paths = []
    for name, seconds, hz, seed in (("src", 1.0, 190, 11), ("ref", 1.3, 270, 12)):
        wav = _sing(SR, seconds, hz, seed)
        p = root / f"{name}.wav"
        save_audio(p, wav, SR)
        save_f0_sidecar(str(p), _vibrato_f0(len(wav) // 320 + 1, hz, seed))
        paths.append(str(p))
    return paths


def vibrato_wav(seconds, hz, seed):
    """A sung note: 5 Hz vibrato of +-4%, two harmonics, noise, phrasing.
    Extracted f0 then varies frame to frame, so the pitched re-rank's order
    does not hang on the last bit of near-equal f0s (see _vibrato_f0)."""
    rng = np.random.default_rng(seed)
    t = np.arange(int(SR * seconds)) / SR
    phase = 2 * np.pi * np.cumsum(hz * (1 + 0.04 * np.sin(2 * np.pi * 5 * t))) / SR
    wav = 0.3 * np.sin(phase) + 0.1 * np.sin(2 * phase) + 0.02 * rng.standard_normal(len(t))
    wav *= 0.5 + 0.5 * np.abs(np.sin(2 * np.pi * 0.7 * t))
    return np.clip(wav, -0.99, 0.99).astype(np.float32)


def write_vibrato_pair(root):
    """A 1-s source and a 1.3-s target of vibrato_wav under `root`, with no
    f0 sidecar, for the f0 extractors. -> paths."""
    from knnsvc_torch.io.audio import save_audio

    paths = []
    for name, seconds, hz, seed in (("vsrc", 1.0, 190, 21), ("vref", 1.3, 270, 22)):
        p = root / f"{name}.wav"
        save_audio(p, vibrato_wav(seconds, hz, seed), SR)
        paths.append(str(p))
    return paths


def int16_codes(path):
    """The int16 codes of a WAV written by either package's convert_pair."""
    from knnsvc_torch.io.audio import load_audio

    y, sr = load_audio(path)
    assert sr == SR
    return np.round(y[0].astype(np.float64) * 32768).astype(np.int64)


# ------------------------------------------------------------ training

# tests/test_training.py's tiny vocoder config; the discriminators run at
# disc_width_scale=8
TINY_H = dict(
    upsample_initial_channel=32,
    n_harmonic=4,
    hubert_dim=16,
    hifi_dim=16,
    segment_size=1280,
    resblock_kernel_sizes=(3,),
    resblock_dilation_sizes=((1, 3, 5),),
    batch_size=2,
    seed=1234,
)
DISC_WIDTH_SCALE = 8

# tests/test_train_loop.py's tiny WavLM world
TINY_WAVLM = dict(
    extractor_mode="layer_norm", encoder_layers=2, encoder_embed_dim=16,
    encoder_ffn_embed_dim=32, encoder_attention_heads=2, layer_norm_first=True,
    conv_feature_layers="[(16,10,5)] + [(16,4,4)] + [(16,4,4)] + [(16,4,4)]",
    conv_bias=True, conv_pos=8, conv_pos_groups=2,
    relative_position_embedding=True, num_buckets=16, max_distance=32,
    gru_rel_pos=True,
)


def tiny_wavlm_params(seed: int = 0):
    """(JAX WavLMConfig, numpy params) of the tiny training-world encoder."""
    jcfg = JaxWavLMConfig.from_dict(TINY_WAVLM)
    return jcfg, jax.tree.map(np.asarray, init_wavlm_params(jax.random.PRNGKey(seed), jcfg))


def write_sung_dataset(root, singers, seconds: float = 1.0) -> None:
    """root/<singer>/utt<i>.wav for singers = {name: [(hz, seed), ...]},
    each a vibrato_wav of `seconds` (sung notes: the f0 re-rank does not hang
    on near-equal f0s, as a pure tone's does)."""
    from knnsvc_torch.io.audio import save_audio

    for name, notes in singers.items():
        d = root / name
        d.mkdir(parents=True, exist_ok=True)
        for i, (hz, seed) in enumerate(notes):
            save_audio(d / f"utt{i}.wav", vibrato_wav(seconds, hz, seed), SR)


def adam_moments(opt_state) -> dict:
    """optax's inject_hyperparams(adamw) state -> {"mu", "nu", "count"} of
    its Adam transform, as numpy."""
    adam = opt_state.inner_state[0]
    return {"mu": jax.tree.map(np.asarray, adam.mu), "nu": jax.tree.map(np.asarray, adam.nu),
            "count": int(adam.count)}


def tiny_batch(h, B: int, seed: int = 0) -> dict:
    """tests/test_training.py's _tiny_batch, as numpy."""
    rng = np.random.default_rng(seed)
    T = h.segment_size // h.hop_size
    n_mel_frames = (h.segment_size + (h.n_fft - h.hop_size) - h.n_fft) // h.hop_size + 1
    return {
        "feats": rng.standard_normal((B, T, h.hubert_dim)).astype(np.float32),
        "audio": (rng.standard_normal((B, h.segment_size)) * 0.1).astype(np.float32),
        "mel_loss": np.full((B, h.num_mels, n_mel_frames), -5.0, dtype=np.float32),
        "f0": (rng.random((B, T, 1)) * 200).astype(np.float32),
        "harmonics": (rng.random((B, T, 49)) * 0.05).astype(np.float32),
    }


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """torch on one intra-op thread for a module (restored after): these
    tiny shapes gain nothing from more, and idle OpenMP workers spin on the
    cores that the other test workers' XLA compiles need. A test module
    that imports it by name has it on every test (autouse)."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)
