"""Shared helpers (no tests) of the knnsvc_torch parity tests, test_torch_*.py:
the same seeded numpy inputs and JAX-initialized parameters go through the
JAX package and its port, on the CPU."""

import jax
import numpy as np

from knnsvc_tpu.config import HiFiGANConfig as JaxHiFiGANConfig
from knnsvc_tpu.config import ModelFamily as JaxModelFamily
from knnsvc_tpu.config import WavLMConfig as JaxWavLMConfig
from knnsvc_tpu.models.hifigan import init_generator_params
from knnsvc_tpu.models.wavlm import init_wavlm_params
from knnsvc_torch.config import HiFiGANConfig, ModelFamily, WavLMConfig

from test_pipeline import SMALL_HIFIGAN, SMALL_WAVLM, _sing  # noqa: F401  (re-exported)

FAMILIES = {"mix": (ModelFamily.MIX, JaxModelFamily.MIX),
            "wavlm_only": (ModelFamily.F0_ONLY, JaxModelFamily.F0_ONLY)}


def small_wavlm(seed: int = 0, overrides: dict | None = None):
    """(port cfg, JAX cfg, numpy params) of the small test encoder."""
    spec = {**SMALL_WAVLM, **(overrides or {})}
    jcfg = JaxWavLMConfig.from_dict(spec)
    params = jax.tree.map(np.asarray, init_wavlm_params(jax.random.PRNGKey(seed), jcfg))
    return WavLMConfig.from_dict(spec), jcfg, params


def small_generator(ckpt_type: str, seed: int = 1):
    """(port cfg, JAX cfg, port family, JAX family, numpy params) of the
    small test vocoder. Weights are rescaled to std 1/sqrt(fan_in): at the
    init's std 0.01 the waveform stays near 1e-5, too small to test."""
    h = HiFiGANConfig.from_dict(SMALL_HIFIGAN)
    jh = JaxHiFiGANConfig.from_dict(SMALL_HIFIGAN)
    fam, jfam = FAMILIES[ckpt_type]
    params = jax.tree.map(np.asarray, init_generator_params(jax.random.PRNGKey(seed), jh, jfam))

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


def int16_codes(path):
    """The int16 codes of a WAV written by either package's convert_pair."""
    from knnsvc_torch.io.audio import load_audio

    y, sr = load_audio(path)
    assert sr == SR
    return np.round(y[0].astype(np.float64) * 32768).astype(np.int64)
