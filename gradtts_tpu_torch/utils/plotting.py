"""Spectrogram and alignment plots: the port's copy of
gradtts_tpu/utils/plotting.py (``plot_tensor`` for TensorBoard images,
``save_plot`` for PNG files), with matplotlib's Agg backend. matplotlib is
imported inside each function, so that importing this module needs none;
it is a host-side dependency. Inputs are 2-D numpy arrays."""

import numpy as np


def _figure(mat, vmin=None, vmax=None):
    import matplotlib
    matplotlib.use('Agg')
    import matplotlib.pyplot as plt
    fig, ax = plt.subplots(figsize=(12, 3))
    im = ax.imshow(np.asarray(mat), aspect='auto', origin='lower',
                   interpolation='none', vmin=vmin, vmax=vmax)
    plt.colorbar(im, ax=ax)
    plt.tight_layout()
    return plt, fig


def plot_tensor(mat) -> np.ndarray:
    """[F, T] (a [T, F] mel transposed by the caller) or an alignment ->
    an RGB image [H, W, 3] uint8 for TensorBoard."""
    plt, fig = _figure(mat)
    fig.canvas.draw()
    data = np.frombuffer(fig.canvas.buffer_rgba(), dtype=np.uint8)
    w, h = fig.canvas.get_width_height()
    plt.close(fig)
    return data.reshape((h, w, 4))[..., :3].copy()


def save_plot(mat, savepath: str, vmin=None, vmax=None) -> None:
    """The heatmap of ``mat`` written to ``savepath`` (PNG)."""
    plt, fig = _figure(mat, vmin, vmax)
    fig.savefig(savepath)
    plt.close(fig)
