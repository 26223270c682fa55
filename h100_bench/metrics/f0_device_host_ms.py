"""Host ms a request spent in knnsvc.f0_device (device f0 of every 30-s
chunk of both files, the Viterbi kernel's launch in it)."""


def read(view):
    if not view.units or view.host_ms("f0_device") == 0.0:
        return None
    return view.host_ms("f0_device") / len(view.units)
