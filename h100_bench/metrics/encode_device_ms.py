"""Device ms a request spent encoding: the device time launched from
knnsvc.pool_build itself (WavLM's 6 layers with the attention kernel, the
conv frontend, the spectrogram, the uploads), device f0 charged to its own
nested spans and so left out."""


def read(view):
    if not view.has_device or not view.units:
        return None
    return view.device_ms("pool_build") / len(view.units)
