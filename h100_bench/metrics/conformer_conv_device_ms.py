"""Device ms a request spent in w2v-BERT 2.0's convolution modules: the
device time launched from knnsvc.conformer_conv (LayerNorm, the two
pointwise GEMMs, GLU, the depthwise conv, LayerNorm and swish of every
layer run on every 30-s chunk of both files)."""


def read(view):
    if not view.has_device or not view.units or view.device_ms("conformer_conv") == 0.0:
        return None
    return view.device_ms("conformer_conv") / len(view.units)
