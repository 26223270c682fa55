"""Device ms a step launched from knnsvc.g_step (the generator's forward,
the log-mel, the discriminators on y and y_hat, the backward, AdamW)."""


def read(view):
    if not view.has_device or not view.units or view.device_ms("g_step") == 0.0:
        return None
    return view.device_ms("g_step") / len(view.units)
