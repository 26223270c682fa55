"""Host ms a request spent in knnsvc.smoothness (the optimizer of both
selections, or one for the wavlm_only family)."""


def read(view):
    if not view.units or view.host_ms("smoothness") == 0.0:
        return None
    return view.host_ms("smoothness") / len(view.units)
