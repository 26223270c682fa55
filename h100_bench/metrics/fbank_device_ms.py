"""Device ms a request spent in w2v-BERT 2.0's frontend: the device time
launched from knnsvc.fbank (the float64 Kaldi fbank, its normalisation and
stacking, on every 30-s chunk of both files)."""


def read(view):
    if not view.has_device or not view.units or view.device_ms("fbank") == 0.0:
        return None
    return view.device_ms("fbank") / len(view.units)
