"""Panel-grid figure compositing.

Counterpart of ``upgdm_tpu/figures/figure_composer.py``: render matplotlib
figures to RGBA arrays, crop white margins, and tile them into a labelled
grid (matplotlib is imported in the call).
"""
from __future__ import annotations

from pathlib import Path
from typing import Optional, Sequence

import numpy as np

__all__ = ["crop_white_margin", "render_source_figure", "add_panel_image", "save_panel_grid",
           "compose_image_grid"]


def crop_white_margin(image: np.ndarray, threshold: int = 250, pad: int = 8) -> np.ndarray:
    """Crop near-white borders, keeping a small pad."""
    mask = np.any(image[:, :, :3] < threshold, axis=2)
    if not mask.any():
        return image
    rows = np.flatnonzero(mask.any(axis=1))
    cols = np.flatnonzero(mask.any(axis=0))
    r0 = max(0, rows[0] - pad)
    r1 = min(image.shape[0], rows[-1] + pad + 1)
    c0 = max(0, cols[0] - pad)
    c1 = min(image.shape[1], cols[-1] + pad + 1)
    return image[r0:r1, c0:c1]


def render_source_figure(source_fig, dpi: int = 220, crop: bool = True) -> np.ndarray:
    from matplotlib.backends.backend_agg import FigureCanvasAgg

    source_fig.set_dpi(dpi)
    canvas = FigureCanvasAgg(source_fig)
    canvas.draw()
    image = np.asarray(canvas.buffer_rgba()).copy()
    return crop_white_margin(image) if crop else image


def add_panel_image(ax, source_fig, label: Optional[str] = None, dpi: int = 220) -> None:
    image = render_source_figure(source_fig, dpi=dpi)
    ax.imshow(image)
    ax.axis("off")
    if label:
        ax.text(-0.02, 1.02, label, transform=ax.transAxes, fontsize=11,
                fontweight="bold", ha="right", va="bottom")


def save_panel_grid(
    source_figs: Sequence,
    output_path,
    n_cols: int = 2,
    labels: Optional[Sequence[str]] = None,
    dpi: int = 220,
    panel_size: float = 4.0,
):
    """Tile source figures into an n_cols grid and save PNG (+PDF)."""
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    n = len(source_figs)
    n_rows = (n + n_cols - 1) // n_cols
    fig, axes = plt.subplots(n_rows, n_cols, figsize=(panel_size * n_cols, panel_size * n_rows))
    axes = np.atleast_1d(axes).ravel()
    default_labels = [chr(ord("a") + i) for i in range(n)]
    labels = labels or default_labels
    for i, src in enumerate(source_figs):
        add_panel_image(axes[i], src, label=labels[i], dpi=dpi)
    for j in range(n, len(axes)):
        axes[j].axis("off")
    output_path = Path(output_path)
    output_path.parent.mkdir(parents=True, exist_ok=True)
    fig.tight_layout()
    fig.savefig(output_path, dpi=dpi, bbox_inches="tight")
    if output_path.suffix == ".png":
        fig.savefig(output_path.with_suffix(".pdf"), bbox_inches="tight")
    plt.close(fig)
    return output_path


def compose_image_grid(image_paths: Sequence, output_path, n_cols: int = 2,
                       labels: Optional[Sequence[str]] = None, dpi: int = 220):
    """Tile already-rendered PNGs (e.g. real-data subfigures) into a grid."""
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt
    from matplotlib.image import imread

    n = len(image_paths)
    n_rows = (n + n_cols - 1) // n_cols
    fig, axes = plt.subplots(n_rows, n_cols, figsize=(5.0 * n_cols, 4.2 * n_rows))
    axes = np.atleast_1d(axes).ravel()
    labels = labels or [chr(ord("a") + i) for i in range(n)]
    for i, path in enumerate(image_paths):
        img = imread(str(path))
        if img.dtype != np.uint8:
            img = (img * 255).astype(np.uint8)
        axes[i].imshow(crop_white_margin(img))
        axes[i].axis("off")
        axes[i].text(-0.02, 1.02, labels[i], transform=axes[i].transAxes, fontsize=11,
                     fontweight="bold", ha="right", va="bottom")
    for j in range(n, len(axes)):
        axes[j].axis("off")
    output_path = Path(output_path)
    output_path.parent.mkdir(parents=True, exist_ok=True)
    fig.tight_layout()
    fig.savefig(output_path, dpi=dpi, bbox_inches="tight")
    plt.close(fig)
    return output_path
