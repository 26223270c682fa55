"""Global numeric-precision policy (counterpart of knnsvc_tpu/precision.py).

"highest": fp32 everywhere — TF32 off for cuBLAS matmuls AND for cuDNN
convolutions. cuDNN defaults `allow_tf32` to True, which would silently run
every WavLM and HiFi-GAN conv in TF32 (~3 decimal digits).
"high": the JAX package's Precision.HIGH (bf16_3x on a TPU): TF32 allowed in
cuBLAS and cuDNN, while the attention kernel (ops/attention.py) keeps its
three TF32 tensor-core passes (3xTF32, fp32-grade).
"fastest": TF32 allowed in both, which is what JAX's Precision.DEFAULT
means on a GPU; the attention kernel then takes one TF32 tensor-core pass
instead of three. "default" is another name for "fastest", as in the JAX
package.

The policy is process-wide, like torch's own backend flags. KnnSvc applies
it when constructed; `set_precision` applies it at once.
"""

from __future__ import annotations

import torch

_MODES = ("highest", "high", "fastest")
_ALIASES = {"default": "fastest"}
_mode = "highest"


def set_precision(name: str) -> None:
    global _mode
    name = _ALIASES.get(name, name)
    if name not in _MODES:
        raise ValueError(f"precision must be one of {_MODES + tuple(_ALIASES)}, not {name!r}")
    _mode = name
    apply_precision()


def get_precision() -> str:
    return _mode


def apply_precision() -> None:
    """Set torch's TF32 switches from the current policy."""
    tf32 = _mode in ("high", "fastest")
    torch.backends.cuda.matmul.allow_tf32 = tf32
    torch.backends.cudnn.allow_tf32 = tf32
