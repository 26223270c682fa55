"""Training's mel figure (counterpart of knnsvc_tpu/utils/plotting.py::
save_mel_figure). matplotlib is optional: the training loop keeps the .npy
artifact when it is absent."""

from __future__ import annotations

import numpy as np


def save_mel_figure(out_path, mel, title: str = "") -> str:
    """Log-mel heatmap PNG — the reference's tensorboard spectrogram figure
    (ref hifigan/ddsp_train.py:320-336, utils.plot_spectrogram) as a file."""
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    fig, ax = plt.subplots(figsize=(10, 3))
    im = ax.imshow(np.asarray(mel), aspect="auto", origin="lower", interpolation="none")
    fig.colorbar(im, ax=ax)
    ax.set_title(title)
    ax.set_xlabel("frames")
    ax.set_ylabel("mel bins")
    fig.tight_layout()
    fig.savefig(out_path, dpi=120)
    plt.close(fig)
    return str(out_path)
