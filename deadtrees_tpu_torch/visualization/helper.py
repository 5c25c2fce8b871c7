"""Visualization: validation sample grids and confusion-matrix heatmaps.

Counterpart of ``deadtrees_tpu.visualization.helper`` (a copy: that module
holds no JAX): ``show`` (grids of image / image+mask overlay / mask /
prediction with dead-tree-fraction annotations), ``show_cm`` (side-by-side
default vs forest-masked normalized CM heatmaps) and ``fig2img``. The
arrays are numpy and channel-LAST, as in the JAX package: the trainer
permutes the port's NCHW batches once before calling ``show``.
matplotlib (and seaborn, when present) is imported inside each call.
"""

from __future__ import annotations

import io
from typing import Optional, Sequence

import numpy as np

from deadtrees_tpu_torch.data.config import DATASET_CONFIG


def fig2img(fig):
    """Matplotlib figure → PIL image (reference helper.py:52-60)."""
    from PIL import Image

    buf = io.BytesIO()
    fig.savefig(buf, format="png", bbox_inches="tight")
    buf.seek(0)
    return Image.open(buf)


def denormalize_for_display(
    img: np.ndarray,
    mean: Sequence[float] = DATASET_CONFIG.mean,
    std: Sequence[float] = DATASET_CONFIG.std,
) -> np.ndarray:
    """Normalized (H, W, C) float → displayable RGB uint8
    (reference rgbtensor_to_rgb, helper.py:63-78)."""
    c = img.shape[-1]
    mean = np.asarray(mean[:c], np.float32)
    std = np.asarray(std[:c], np.float32)
    x = img * std + mean
    x = np.clip(x[..., :3], 0.0, 1.0)
    return (x * 255).astype(np.uint8)


def show(
    x: np.ndarray,
    y: np.ndarray,
    y_hat: Optional[np.ndarray] = None,
    *,
    n_samples: int = 8,
    stats: Optional[Sequence[dict]] = None,
    dpi: int = 72,
):
    """Sample grid: rows = [image, image+mask, mask, prediction]
    (reference helper.py:96-191). ``x`` is the NORMALIZED (B, H, W, C)
    batch; ``y`` integer masks; ``y_hat`` probabilities (B, H, W, K) or
    class maps (B, H, W)."""
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    n = min(n_samples, x.shape[0])
    rows = 3 if y_hat is None else 4
    fig, axes = plt.subplots(rows, n, figsize=(2.2 * n, 2.2 * rows), dpi=dpi)
    axes = np.atleast_2d(axes)
    if axes.shape != (rows, n):
        axes = axes.reshape(rows, n)

    pred_cls = None
    if y_hat is not None:
        pred_cls = y_hat.argmax(-1) if y_hat.ndim == 4 else y_hat

    for i in range(n):
        rgb = denormalize_for_display(np.asarray(x[i]))
        mask = np.asarray(y[i])
        frac = float((mask > 0).mean() * 100)

        axes[0, i].imshow(rgb)
        title = f"{frac:.1f}%"
        if stats and i < len(stats) and isinstance(stats[i], dict):
            title = f"{stats[i].get('frac', frac):.1f}%"
        axes[0, i].set_title(title, fontsize=8)

        overlay = rgb.copy()
        overlay[mask > 0] = (
            0.5 * overlay[mask > 0] + 0.5 * np.array([255, 0, 0])
        ).astype(np.uint8)
        axes[1, i].imshow(overlay)
        axes[2, i].imshow(mask, vmin=0, vmax=2, cmap="viridis")
        if pred_cls is not None:
            axes[3, i].imshow(np.asarray(pred_cls[i]), vmin=0, vmax=2, cmap="viridis")

    for ax in axes.ravel():
        ax.set_xticks([])
        ax.set_yticks([])
    labels = ["image", "image+mask", "mask", "prediction"][:rows]
    for r, lab in enumerate(labels):
        axes[r, 0].set_ylabel(lab, fontsize=9)
    fig.tight_layout()
    return fig


def show_cm(
    cm: np.ndarray,
    cm_masked: Optional[np.ndarray] = None,
    *,
    class_names: Optional[Sequence[str]] = None,
    dpi: int = 72,
):
    """Normalized confusion-matrix heatmaps: default + forest-masked
    (reference helper.py:194-233, seaborn heatmaps)."""
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    mats = [("default", cm)] + (
        [("forest only", cm_masked)] if cm_masked is not None else []
    )
    fig, axes = plt.subplots(1, len(mats), figsize=(5 * len(mats), 4), dpi=dpi)
    if len(mats) == 1:
        axes = [axes]
    k = cm.shape[0]
    names = list(class_names) if class_names else [str(i) for i in range(k)]
    try:
        import seaborn as sns

        for ax, (title, mat) in zip(axes, mats):
            sns.heatmap(
                mat, annot=True, fmt=".2f", ax=ax, cmap="Blues",
                xticklabels=names, yticklabels=names, vmin=0,
            )
            ax.set_title(title)
            ax.set_xlabel("predicted")
            ax.set_ylabel("true")
    except ImportError:  # pragma: no cover
        for ax, (title, mat) in zip(axes, mats):
            ax.imshow(mat, cmap="Blues")
            ax.set_title(title)
    fig.tight_layout()
    return fig
