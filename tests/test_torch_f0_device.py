"""knnsvc_torch.dsp.f0_device and ops/viterbi.py's plain Viterbi on the CPU:
the port's copies of the JAX package's contract tests
(tests/test_f0_device.py) and parity with knnsvc_tpu.dsp.f0_device on the
same numpy inputs.

Tolerances: the comb matrix and the Viterbi states are exact (the same
numpy code; the plain Viterbi repeats the JAX scan's fp32 operations and
tie rules). The features differ only by the FFT and matrix-product
summation order (pocketfft in both, XLA's and torch's matmul): rtol 1e-5
on the salience, 1e-4 on sqrt-magnitudes. The instantaneous frequency is
an angle of a complex product whose rounding differs near +-pi: compared
with the f0 it produces, within 0.05 cents (measured 0.003)."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from knnsvc_tpu.dsp import f0_device as jax_f0
from knnsvc_torch.dsp.f0_device import (BANDS, F0_CEIL, F0_FLOOR, DeviceF0Params, _comb_matrix,
                                        _features, _frame, device_f0, device_f0_tensor)
from knnsvc_torch.ops.viterbi import dt_min, f0_viterbi, viterbi_plain

SR = 16000
HOP = 320
CENTS_TOL = 0.05
LAM_S = float(np.float32(0.753) * np.float32(10.0 / 1200.0))
SWITCH = float(np.float32(0.291))


def _f0(x, **kw):
    return device_f0(x, SR, device="cpu", **kw)


def _tone(f0: float, seconds: float = 1.0, n_harm: int = 5) -> np.ndarray:
    t = np.arange(int(SR * seconds)) / SR
    x = sum(np.sin(2 * np.pi * f0 * k * t) / k for k in range(1, n_harm + 1))
    return (0.5 * x / np.abs(x).max()).astype(np.float32)


def _sung(seconds: float, hz: float, seed: int) -> np.ndarray:
    """5 Hz vibrato, two harmonics, noise, a silent lead-in and phrasing."""
    rng = np.random.default_rng(seed)
    t = np.arange(int(SR * seconds)) / SR
    phase = 2 * np.pi * np.cumsum(hz * (1 + 0.04 * np.sin(2 * np.pi * 5 * t))) / SR
    x = 0.3 * np.sin(phase) + 0.1 * np.sin(2 * phase) + 0.01 * rng.standard_normal(len(t))
    x *= 0.5 + 0.5 * np.abs(np.sin(2 * np.pi * 0.7 * t))
    x[: SR // 5] = 0.0
    return x.astype(np.float32)


def _costs(N, C, seed, ties=False):
    rng = np.random.default_rng(seed)
    cost_v = rng.standard_normal((N, C)).astype(np.float32)
    cost_u = (rng.standard_normal(N) * 0.5).astype(np.float32)
    if ties == "const":                                    # every row one value
        cost_v[:] = cost_v[:, :1]
    elif ties:
        cost_v[::3] = 1e3                                  # silent frames
        cost_v[1::4, 5:] = cost_v[1::4, 5:6]               # flat runs
        cost_v[2::5] = np.round(cost_v[2::5])              # repeated values
        cost_u[::7] = 1e3
    return cost_v, cost_u


def _agree(a: np.ndarray, b: np.ndarray) -> None:
    """Voicing equal on every frame; voiced f0 within CENTS_TOL."""
    assert a.shape == b.shape
    np.testing.assert_array_equal(a > 0, b > 0)
    v = a > 0
    assert v.any()
    assert np.abs(1200 * np.log2(a[v] / b[v])).max() < CENTS_TOL


# ---------------------------------------------------------- the contract


def test_output_contract_length_and_dtype():
    for n in [SR // 2, SR, SR + 37]:
        f0 = _f0(np.zeros(n, np.float32))
        assert f0.shape == (n // HOP + 1,)
        assert f0.dtype == np.float32


@pytest.mark.parametrize("f", [90.0, 180.0, 440.0, 880.0])
def test_tones_across_all_bands(f):
    """One tone per analysis band comes out voiced within 5 cents."""
    f0 = _f0(_tone(f))
    v = f0[f0 > 0]
    assert len(v) > 0.9 * len(f0), f
    assert 1200 * np.abs(np.log2(np.median(v) / f)) < 5.0, (f, float(np.median(v)))


def test_noise_and_silence_are_unvoiced():
    rng = np.random.default_rng(0)
    assert (_f0(rng.standard_normal(SR).astype(np.float32) * 0.3) > 0).sum() == 0
    assert (_f0(np.zeros(SR, np.float32)) > 0).sum() == 0


def test_below_80hz_zeroed():
    assert (_f0(_tone(70.0)) == 0).all()


def test_bucket_padding_invariance():
    """Same audio at two lengths: the same f0 away from the tail edge."""
    x = _tone(220.0, seconds=2.0)
    a, b = _f0(x), _f0(x[: len(x) - SR // 2])
    n = len(b) - 8
    np.testing.assert_allclose(a[:n], b[:n], rtol=0.01)


def test_tensor_variant_matches_wrapper():
    """device_f0_tensor (exact frames) against device_f0 (256-frame bucket):
    equal away from the tail, where the bucket's forced-unvoiced padding
    frames change the Viterbi's boundary."""
    x = _tone(300.0)
    n = len(x) // HOP + 1
    via_tensor = device_f0_tensor(torch.from_numpy(x), SR, n).numpy()
    np.testing.assert_allclose(via_tensor[: n - 8], _f0(x)[: n - 8], rtol=1e-5, atol=1e-3)


def test_octave_robustness_formant_boosted_third():
    t = np.arange(SR) / SR
    f = 218.0
    amps = {1: 0.25, 2: 0.3, 3: 1.0, 4: 0.5, 5: 0.2}
    x = sum(a * np.sin(2 * np.pi * f * k * t) for k, a in amps.items())
    f0 = _f0((0.5 * x / np.abs(x).max()).astype(np.float32))
    v = f0[f0 > 0]
    assert len(v) > 0.8 * len(f0)
    assert 1200 * np.abs(np.log2(np.median(v) / f)) < 50.0


def test_frame_centers():
    x = np.zeros(SR, np.float32)
    x[10 * HOP] = 1.0
    w = DeviceF0Params().window
    frames = _frame(torch.from_numpy(x), len(x) // HOP + 1, w, HOP).numpy()
    assert frames[10, w // 2] == 1.0
    assert min(b[0] for b in BANDS) <= F0_FLOOR and max(b[1] for b in BANDS) >= F0_CEIL


@pytest.mark.parametrize("C", [1, 2, 7, 64])
def test_distance_transform_matches_bruteforce(C):
    rng = np.random.default_rng(3)
    dv = rng.standard_normal(C).astype(np.float32) * 3
    lam = float(np.float32(0.23))
    best, arg = dt_min(torch.from_numpy(dv), lam, torch.arange(C, dtype=torch.float32))
    best, arg = best.numpy(), arg.numpy()
    ii = np.arange(C)
    ref = (dv[:, None] + np.float32(lam) * np.abs(ii[:, None] - ii[None, :])).min(0)
    np.testing.assert_allclose(best, ref, rtol=1e-6, atol=1e-6)
    achieved = dv[arg] + np.float32(lam) * np.abs(arg - ii)
    np.testing.assert_allclose(achieved, ref, rtol=1e-6, atol=1e-6)


def test_viterbi_matches_bruteforce_dp():
    """The returned path's cost equals a numpy DP's optimum."""
    N, C = 12, 9
    cost_v, cost_u = _costs(N, C, seed=5)
    lam_s, switch = np.float32(0.31), np.float32(0.4)
    states = viterbi_plain(torch.from_numpy(cost_v), torch.from_numpy(cost_u),
                           float(lam_s), float(switch)).numpy()
    ii = np.arange(C)
    trans = lam_s * np.abs(ii[:, None] - ii[None, :])
    d = np.concatenate([cost_v[0], [cost_u[0]]])
    for t in range(1, N):
        nd = np.empty(C + 1)
        for j in range(C):
            nd[j] = min((d[:C] + trans[:, j]).min(), d[C] + switch) + cost_v[t, j]
        nd[C] = min(d[C], d[:C].min() + switch) + cost_u[t]
        d = nd
    got = cost_v[0, states[0]] if states[0] < C else cost_u[0]
    for t in range(1, N):
        a, b = states[t - 1], states[t]
        if a < C and b < C:
            got += trans[a, b]
        elif (a == C) != (b == C):
            got += switch
        got += cost_v[t, b] if b < C else cost_u[t]
    np.testing.assert_allclose(got, d.min(), rtol=1e-5, atol=1e-5)


# ---------------------------------------------------------- parity with JAX


def test_comb_matrix_bit_identical():
    for sr in (16000, 22050):
        for a, b in zip(_comb_matrix(sr, DeviceF0Params()),
                        jax_f0._comb_matrix(sr, jax_f0.DeviceF0Params())):
            assert a.dtype == b.dtype
            np.testing.assert_array_equal(a, b)
    assert _comb_matrix(16000, DeviceF0Params())[0].shape == (482, 3 * 2049)


def test_features_match_jax():
    x = _sung(2.0, 230.0, seed=1)
    n = len(x) // HOP + 1
    frames = _frame(torch.from_numpy(x), n, 1024, HOP)
    jframes = jax_f0._frame(jnp.asarray(x), n, 1024, HOP)
    np.testing.assert_array_equal(frames.numpy(), np.asarray(jframes))
    got = _features(frames, SR, DeviceF0Params())
    want = jax_f0._features(jframes, SR, jax_f0.DeviceF0Params())
    for (name, rtol), g, w in zip([("salience", 1e-5), ("energy", 1e-5), ("A", 1e-4)],
                                  got[:3], want[:3]):
        w = np.asarray(w)
        assert np.abs(g.numpy() - w).max() <= rtol * np.abs(w).max(), name


@pytest.mark.parametrize("N,C,ties", [(300, 482, False), (300, 482, True), (40, 9, True),
                                      (1, 482, False), (2, 1, True),
                                      # the CUDA kernel's widest and warp-edge C, and
                                      # constant rows (the argmin ties at every level)
                                      (300, 511, True), (300, 128, True), (300, 482, "const")])
def test_plain_viterbi_states_identical_to_jax(N, C, ties):
    cost_v, cost_u = _costs(N, C, seed=N + C, ties=ties)
    want = np.asarray(jax.jit(jax_f0._viterbi)(jnp.asarray(cost_v), jnp.asarray(cost_u),
                                               jnp.float32(LAM_S), jnp.float32(SWITCH)))
    before = f0_viterbi.launches
    got = f0_viterbi(torch.from_numpy(cost_v), torch.from_numpy(cost_u), LAM_S, SWITCH)
    assert f0_viterbi.launches == before           # CPU: the plain version
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)
    if ties and N >= 40:
        assert (got.numpy() == C).any()            # the unvoiced state is reached


def test_viterbi_wrapper_checks_shapes():
    with pytest.raises(ValueError, match="cost_u"):
        f0_viterbi(torch.zeros(5, 3), torch.zeros(4), LAM_S, SWITCH)
    with pytest.raises(ValueError, match="cpu or cuda"):
        f0_viterbi(torch.zeros(5, 3, device="meta"), torch.zeros(5, device="meta"),
                   LAM_S, SWITCH)


def test_device_f0_matches_jax_on_sung_audio():
    x = _sung(2.0, 230.0, seed=2)
    _agree(_f0(x), jax_f0.device_f0(x, SR))
    n = len(x) // HOP + 1
    _agree(device_f0_tensor(torch.from_numpy(x), SR, n).numpy(),
           np.asarray(jax_f0.device_f0_jax(jnp.asarray(x), SR, n)))


def test_get_f0_device_method_matches_jax(tmp_path):
    """get_f0(method='device'): the JAX package's cache name (`_f0_dev1.npy`),
    read back on the next call, and its values."""
    from knnsvc_tpu.dsp.f0 import get_f0 as jax_get_f0
    from knnsvc_torch.dsp.f0 import get_f0

    x = _sung(1.0, 200.0, seed=3)
    port_path, jax_path = str(tmp_path / "port.wav"), str(tmp_path / "jax.wav")
    got = get_f0(x, SR, audio_path=port_path, method="device", device="cpu")
    want = jax_get_f0(x, SR, audio_path=jax_path, method="device")
    _agree(got, want)
    assert (tmp_path / "port_f0_dev1.npy").is_file() and (tmp_path / "jax_f0_dev1.npy").is_file()
    np.save(tmp_path / "port_f0_dev1.npy", np.full_like(got, 123.0))
    assert (get_f0(x, SR, audio_path=port_path, method="device", device="cpu") == 123.0).all()
