"""Device ms a request spent in the vocoder: the device time launched from
knnsvc.vocode (excitation and HiFi-GAN)."""


def read(view):
    if not view.has_device or not view.units or view.device_ms("vocode") == 0.0:
        return None
    return view.device_ms("vocode") / len(view.units)
