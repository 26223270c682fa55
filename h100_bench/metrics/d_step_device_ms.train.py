"""Device ms a step launched from knnsvc.d_step (the power iteration, the
generator without gradient, the discriminators on y and y_hat, the
backward, AdamW)."""


def read(view):
    if not view.has_device or not view.units or view.device_ms("d_step") == 0.0:
        return None
    return view.device_ms("d_step") / len(view.units)
