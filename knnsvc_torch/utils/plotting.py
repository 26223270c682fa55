"""Debug plots and training's mel figure (counterpart of
knnsvc_tpu/utils/plotting.py; ref ddsp_matcher.py:23-84, lib_ongaku_test.py:
6-84, plotly there, matplotlib here). The plots take tensors on any device
(copied to the host first) or arrays. matplotlib is optional: without it
they raise ImportError, and the training loop keeps the .npy artifact."""

from __future__ import annotations

import numpy as np
import torch


def _host(x) -> np.ndarray:
    """A tensor on any device, or an array, as a numpy array."""
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _pyplot(out_path):
    import matplotlib

    matplotlib.use("Agg" if out_path else matplotlib.get_backend())
    import matplotlib.pyplot as plt

    return plt


def _finish(plt, fig, out_path):
    """Saves to out_path (png/pdf) and returns it, or shows and returns the figure."""
    fig.tight_layout()
    if out_path:
        fig.savefig(out_path, dpi=120)
        plt.close(fig)
        return out_path
    plt.show()
    return fig


def plot_multi_sequences(x, ys, y_names, title: str = "", out_path: str | None = None,
                         x_axis: str = "", y_axis: str = ""):
    """Overlayed line plots. Saves to out_path (png/pdf) or shows."""
    plt = _pyplot(out_path)
    fig, ax = plt.subplots(figsize=(12, 4))
    for y, name in zip(ys, y_names):
        ax.plot(_host(x), _host(y), label=name, linewidth=0.8)
    ax.set_title(title)
    ax.set_xlabel(x_axis)
    ax.set_ylabel(y_axis)
    ax.legend()
    return _finish(plt, fig, out_path)


def plot_matrix(mat, row_names=None, col_names=None, title: str = "",
                out_path: str | None = None, x_axis: str = "", y_axis: str = ""):
    """Heatmap (e.g. selected-neighbour index matrices over time); row_names
    is taken and unused, as in the JAX package."""
    plt = _pyplot(out_path)
    fig, ax = plt.subplots(figsize=(12, 4))
    im = ax.imshow(_host(mat), aspect="auto", cmap="coolwarm", interpolation="nearest")
    fig.colorbar(im, ax=ax)
    if col_names is not None:
        n = len(col_names)
        ticks = np.linspace(0, n - 1, min(n, 10)).astype(int)
        ax.set_xticks(ticks)
        ax.set_xticklabels([f"{col_names[t]:.2f}" if isinstance(col_names[t], float)
                            else str(col_names[t]) for t in ticks])
    ax.set_title(title)
    ax.set_xlabel(x_axis)
    ax.set_ylabel(y_axis)
    return _finish(plt, fig, out_path)


def save_mel_figure(out_path, mel, title: str = "") -> str:
    """Log-mel heatmap PNG — the reference's tensorboard spectrogram figure
    (ref hifigan/ddsp_train.py:320-336, utils.plot_spectrogram) as a file."""
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    fig, ax = plt.subplots(figsize=(10, 3))
    im = ax.imshow(_host(mel), aspect="auto", origin="lower", interpolation="none")
    fig.colorbar(im, ax=ax)
    ax.set_title(title)
    ax.set_xlabel("frames")
    ax.set_ylabel("mel bins")
    fig.tight_layout()
    fig.savefig(out_path, dpi=120)
    plt.close(fig)
    return str(out_path)
