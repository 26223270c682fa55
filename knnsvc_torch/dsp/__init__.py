from knnsvc_torch.dsp.stft import (
    stft_magnitude,
    linear_spectrogram,
    log_mel_spectrogram,
    mel_filterbank,
)
from knnsvc_torch.dsp.synth import (
    upsample_nearest,
    upsample_bicubic,
    remove_above_nyquist,
    harmonic_synth,
    sine_excitation,
)

__all__ = [
    "stft_magnitude",
    "linear_spectrogram",
    "log_mel_spectrogram",
    "mel_filterbank",
    "upsample_nearest",
    "upsample_bicubic",
    "remove_above_nyquist",
    "harmonic_synth",
    "sine_excitation",
]
