"""Figure helpers: reconstruction pairs and CFG sample grids, the port's
copy of the JAX package's `core/plotting.py` (numpy; matplotlib's Agg
backend, imported when a figure is drawn).  Images arrive as NHWC arrays
in [-1, 1]."""

from __future__ import annotations

import numpy as np


def pyplot():
    """matplotlib.pyplot on the Agg backend; a clear error without it."""
    try:
        import matplotlib
    except ImportError as e:
        raise ImportError("drawing a figure needs matplotlib, which is not installed") from e
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    return plt


def to_uint8(x: np.ndarray) -> np.ndarray:
    """[-1, 1] float -> [0, 255] uint8: clip((x + 1) / 2) * 255, truncated
    (the bytes of `pipelines.diffusion.to_uint8`)."""
    x = np.asarray(x, np.float32)
    x = np.clip((x + 1.0) / 2.0, 0.0, 1.0) * 255.0
    return x.astype(np.uint8)


def plot_reconstructions(images: np.ndarray, reconstructed: np.ndarray):
    """Original-vs-reconstruction column figure."""
    plt = pyplot()
    n = images.shape[0]
    fig, axs = plt.subplots(n, 2, figsize=(10, n * 5), squeeze=False)
    for i in range(n):
        axs[i, 0].imshow(to_uint8(images[i]))
        axs[i, 0].axis("off")
        axs[i, 1].imshow(to_uint8(reconstructed[i]))
        axs[i, 1].axis("off")
    axs[0, 0].set_title("Original", fontsize=16)
    axs[0, 1].set_title("Reconstructed", fontsize=16)
    plt.tight_layout()
    return fig


def make_grid(images: np.ndarray, nrow: int, padding: int = 2) -> np.ndarray:
    """Tile (B, H, W, C) into a (gh*H', gw*W', C) grid image (uint8)."""
    imgs = to_uint8(images)
    b, h, w, c = imgs.shape
    nrows = (b + nrow - 1) // nrow
    hp, wp = h + padding, w + padding
    grid = np.zeros((nrows * hp + padding, nrow * wp + padding, c), np.uint8)
    for i in range(b):
        r, col = divmod(i, nrow)
        grid[padding + r * hp : padding + r * hp + h,
             padding + col * wp : padding + col * wp + w] = imgs[i]
    return grid


def plot_cfg_grid(images: np.ndarray, classes: list[str], cfg_scales: list):
    """Annotated classes-x-scales grid figure: classes across the top,
    scales down the left."""
    plt = pyplot()
    grid = make_grid(images, nrow=len(classes))
    fig, ax = plt.subplots(figsize=(15, 15))
    ax.imshow(grid)
    ax.axis("off")
    for i, name in enumerate(classes):
        ax.text(
            i * grid.shape[1] // len(classes) + grid.shape[1] // (2 * len(classes)),
            -10, name, ha="center", va="center", fontsize=12, color="black",
        )
    for i, scale in enumerate(cfg_scales):
        ax.text(
            -20,
            i * grid.shape[0] // len(cfg_scales) + grid.shape[0] // (2 * len(cfg_scales)),
            str(scale), ha="center", va="center", fontsize=12, color="black",
        )
    return fig
