"""Plotting helpers for loggers (spectrogram comparisons, confusion matrix).

Port of ``diffmst_tpu/callbacks/plotting.py``, which rebuilt the
reference's plots without librosa, PIL or torchvision: STFTs from NumPy, dB
scaling with librosa's ``amplitude_to_db`` semantics (ref = max, 80 dB
floor), figures rendered through matplotlib's Agg canvas to an HWC uint8
array (the ``fig2img`` role), for ``wandb.Image`` or disk. These run on the
host: their inputs are audio already brought back from the card.

matplotlib is imported lazily so training never pays for it; every function
returns ``None`` with a warning where it is missing.
"""

from __future__ import annotations

import warnings
from typing import Optional, Sequence

import numpy as np

__all__ = ["plot_spectrograms", "plot_confusion_matrix", "fig2img"]


def _mpl():
    try:
        import matplotlib

        matplotlib.use("Agg", force=False)
        import matplotlib.pyplot as plt

        return plt
    except ImportError:  # pragma: no cover
        warnings.warn("matplotlib unavailable; plotting helpers return None")
        return None


def _stft_db(x, n_fft: int, hop_length: int) -> np.ndarray:
    """Magnitude STFT in dB re max, 80 dB floor (librosa.amplitude_to_db);
    ``x`` an array or a tensor on any device."""
    if hasattr(x, "detach"):
        x = x.detach().float().cpu().numpy()
    x = np.asarray(x, np.float32).reshape(-1)
    pad = n_fft // 2
    x = np.pad(x, (pad, pad), mode="reflect")
    n_frames = 1 + (len(x) - n_fft) // hop_length
    idx = np.arange(n_fft)[None, :] + hop_length * np.arange(n_frames)[:, None]
    frames = x[idx] * np.hanning(n_fft)[None, :]
    mag = np.abs(np.fft.rfft(frames, axis=-1)).T  # (bins, frames)
    db = 20.0 * np.log10(np.maximum(mag, 1e-10))
    db -= db.max()
    return np.maximum(db, -80.0)


def fig2img(fig, dpi: int = 120) -> np.ndarray:
    """Render a matplotlib figure to an HWC uint8 RGB array and close it."""
    fig.set_dpi(dpi)
    fig.canvas.draw()
    img = np.asarray(fig.canvas.buffer_rgba())[..., :3].copy()
    plt = _mpl()
    if plt is not None:
        plt.close(fig)
    return img


def plot_spectrograms(
    input,
    target,
    estimate,
    n_fft: int = 4096,
    hop_length: int = 1024,
    sample_rate: float = 44100.0,
    filename: Optional[str] = None,
) -> Optional[np.ndarray]:
    """Stacked input/target/estimate log-spectrograms.

    Args:
      input/target/estimate: mono audio, any shape that flattens to samples.
      filename: optional path; the figure is also saved to disk when given.

    Returns:
      HWC uint8 image array, or None without matplotlib.
    """
    plt = _mpl()
    if plt is None:
        return None
    fig, axs = plt.subplots(nrows=3, sharex=True, figsize=(7, 6))
    for ax, (name, sig) in zip(axs, [("input", input), ("target", target), ("estimate", estimate)]):
        D = _stft_db(sig, n_fft, hop_length)
        extent = [0.0, D.shape[1] * hop_length / sample_rate, 0.0, sample_rate / 2.0]
        ax.imshow(D, origin="lower", aspect="auto", extent=extent, cmap="magma", vmin=-80.0, vmax=0.0)
        ax.set_yscale("symlog", linthresh=1000.0)
        ax.set_ylabel(f"{name} (Hz)")
    axs[-1].set_xlabel("time (s)")
    fig.tight_layout()
    if filename is not None:
        fig.savefig(filename, dpi=300)
    return fig2img(fig)


def plot_confusion_matrix(
    e_hat: Sequence[int],
    e: Sequence[int],
    labels: Optional[Sequence[str]] = None,
    filename: Optional[str] = None,
) -> Optional[np.ndarray]:
    """Confusion-matrix image from predicted and true ids (the count matrix
    accumulated directly, without sklearn)."""
    plt = _mpl()
    if plt is None:
        return None
    e_hat = np.asarray(e_hat, np.int64)
    e = np.asarray(e, np.int64)
    n = len(labels) if labels is not None else int(max(e_hat.max(), e.max())) + 1
    cm = np.zeros((n, n), np.int64)
    np.add.at(cm, (e, e_hat), 1)

    fig, ax = plt.subplots(figsize=(10, 10))
    im = ax.imshow(cm, cmap="Blues")
    fig.colorbar(im, ax=ax, fraction=0.046)
    ticks = np.arange(n)
    ax.set_xticks(ticks)
    ax.set_yticks(ticks)
    if labels is not None:
        ax.set_xticklabels(labels, rotation="vertical")
        ax.set_yticklabels(labels)
    thresh = cm.max() / 2.0 if cm.max() else 0.5
    for i in range(n):
        for j in range(n):
            ax.text(j, i, str(cm[i, j]), ha="center", va="center",
                    color="white" if cm[i, j] > thresh else "black")
    ax.set_xlabel("predicted")
    ax.set_ylabel("true")
    fig.tight_layout()
    if filename is not None:
        fig.savefig(filename, dpi=300)
    return fig2img(fig)
