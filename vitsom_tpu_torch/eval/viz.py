"""Figures: the decoded-prototype grid, the label heatmap, the latent
projection and the paper's params-vs-metric plot.

Counterpart of ``vitsom_tpu/eval/viz.py``. Each figure is split in two:

- a numeric part, testable without matplotlib: ``cell_label_map`` (the
  per-cell majority vote, or the reference's last-write-wins behind
  ``mode="last"``) and ``prototype_grid_image`` (numpy copies of the JAX
  package's, bitwise equal), ``decoded_prototypes`` (all P prototypes
  through one ``model.decode_prototypes`` call on the model's device, under
  ``torch.no_grad()``) and ``latent_projection`` (the port's UMAP,
  ``eval/umap.py``, or its PCA, ``umap.pca``: no scikit-learn);
- a drawing part (``visualize_*``, ``plot_params_vs_metric``) that imports
  matplotlib (``Agg``) inside the function. Where matplotlib is missing
  the drawing raises its ``ImportError``; nothing draws in its place.
"""

from __future__ import annotations

import os
from typing import Optional, Sequence, Tuple

import numpy as np
import torch

from vitsom_tpu_torch.eval import umap as umap_lib


def _pyplot():
    """matplotlib's pyplot on the ``Agg`` backend (raises ImportError where
    matplotlib is not installed)."""
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    return plt


# ---------------------------------------------------------------------------
# numeric parts
# ---------------------------------------------------------------------------


def cell_label_map(
    bmu_indices: np.ndarray,
    labels: np.ndarray,
    n_prototypes: int,
    mode: str = "majority",
) -> np.ndarray:
    """Per-prototype label, [P] int64 (-1 = no sample mapped there).

    mode="majority": the most frequent label among the cell's samples.
    mode="last": the label of the last sample written to the cell wins,
    the reference's behaviour."""
    bmu_indices = np.asarray(bmu_indices).reshape(-1)
    labels = np.asarray(labels).reshape(-1)
    out = np.full(n_prototypes, -1, dtype=np.int64)
    if mode == "last":
        out[bmu_indices] = labels
        return out
    if mode != "majority":
        raise ValueError(f"unknown mode {mode}")
    n_classes = int(labels.max()) + 1 if labels.size else 1
    counts = np.zeros((n_prototypes, n_classes), dtype=np.int64)
    np.add.at(counts, (bmu_indices, labels), 1)
    mapped = counts.sum(axis=1) > 0
    out[mapped] = counts[mapped].argmax(axis=1)
    return out


def prototype_grid_image(
    decoded: np.ndarray, map_size: Tuple[int, int], pad: int = 1
) -> np.ndarray:
    """[P, H, W, C] decoded prototypes -> one [rows*(H+pad)-pad,
    cols*(W+pad)-pad, C] mosaic, each image normalised to [0, 1]."""
    rows, cols = map_size
    p, h, w, c = decoded.shape
    assert p == rows * cols, f"{p} prototypes != {rows}x{cols}"
    lo = decoded.min(axis=(1, 2, 3), keepdims=True)
    hi = decoded.max(axis=(1, 2, 3), keepdims=True)
    imgs = (decoded - lo) / np.maximum(hi - lo, 1e-8)
    canvas = np.ones((rows * (h + pad) - pad, cols * (w + pad) - pad, c), np.float32)
    for i in range(rows):
        for j in range(cols):
            canvas[i * (h + pad): i * (h + pad) + h, j * (w + pad): j * (w + pad) + w] = imgs[
                i * cols + j
            ]
    return canvas


def decoded_prototypes(model, cfg) -> torch.Tensor:
    """[P, H, W, C] images of every prototype, decoded in one
    ``model.decode_prototypes`` call on the model's device (vit_som with
    ``use_reduced=False`` only: the prototypes must be patch-token
    latents)."""
    if cfg.model_arch != "vit_som" or cfg.som.use_reduced:
        raise ValueError(
            "prototype decoding requires vit_som with use_reduced=False "
            "(prototypes must be full patch-token latents)"
        )
    with torch.no_grad():
        return model.decode_prototypes(model.prototypes)


def latent_projection(latents, method: str = "auto", seed: int = 0):
    """(the [N, 2] embedding as numpy, the method used): ``umap`` (the
    port's, cosine, n_neighbors 15) or ``pca``; ``auto`` takes UMAP and
    falls back to PCA only for inputs too small for the neighbour graph.
    A tensor is projected on its device."""
    if method not in ("auto", "umap", "pca"):
        raise ValueError(f"unknown projection method {method!r}")
    x = torch.as_tensor(latents).float().reshape(len(latents), -1)
    if method in ("auto", "umap"):
        try:
            return umap_lib.umap_embed(x, n_neighbors=15, seed=seed), "umap"
        except ValueError:  # too few points for the neighbour graph
            if method == "umap":
                raise
    return umap_lib.pca(x, 2).cpu().numpy(), "pca"


# ---------------------------------------------------------------------------
# figures
# ---------------------------------------------------------------------------


def _save(fig, plt, out_path: str, **kw) -> str:
    os.makedirs(os.path.dirname(out_path) or ".", exist_ok=True)
    fig.savefig(out_path, **kw)
    plt.close(fig)
    return out_path


def draw_prototype_grid(canvas: np.ndarray, map_size: Tuple[int, int], out_path: str,
                        epoch: Optional[int] = None) -> str:
    plt = _pyplot()
    fig, ax = plt.subplots(figsize=(map_size[1] * 0.4, map_size[0] * 0.4))
    ax.imshow(canvas.squeeze(-1) if canvas.shape[-1] == 1 else canvas, cmap="gray")
    ax.set_axis_off()
    title = "decoded prototypes" + (f" (epoch {epoch})" if epoch is not None else "")
    ax.set_title(title, fontsize=8)
    return _save(fig, plt, out_path, dpi=150, bbox_inches="tight")


def visualize_decoded_prototypes(model, cfg, out_path: str, epoch: Optional[int] = None) -> str:
    """Decode every SOM prototype through the ViT decoder and save the
    map_size grid PNG (reference ``visualize_decoded_prototypes``)."""
    decoded = decoded_prototypes(model, cfg).cpu().numpy()
    canvas = prototype_grid_image(decoded, tuple(cfg.som.map_size))
    return draw_prototype_grid(canvas, tuple(cfg.som.map_size), out_path, epoch)


def draw_heatmap(cell_labels: np.ndarray, map_size: Tuple[int, int], out_path: str,
                 mode: str = "majority") -> str:
    """``cell_label_map``'s [P] labels as a map_size heatmap."""
    rows, cols = map_size
    grid = cell_labels.reshape(rows, cols).astype(float)
    grid[grid < 0] = np.nan

    plt = _pyplot()
    fig, ax = plt.subplots(figsize=(max(4, cols * 0.3), max(4, rows * 0.3)))
    im = ax.imshow(grid, cmap="tab20", interpolation="nearest")
    n_classes = int(np.nanmax(grid)) + 1 if np.isfinite(grid).any() else 0
    if rows * cols <= 1024:  # annotate small maps like the reference
        for i in range(rows):
            for j in range(cols):
                if np.isfinite(grid[i, j]):
                    ax.text(j, i, int(grid[i, j]), ha="center", va="center", fontsize=5)
    ax.set_title(f"SOM label heatmap ({mode}, {n_classes} classes)", fontsize=9)
    ax.set_axis_off()
    fig.colorbar(im, ax=ax, fraction=0.046)
    return _save(fig, plt, out_path, dpi=150, bbox_inches="tight")


def visualize_label_heatmap(
    bmu_indices: np.ndarray,
    labels: np.ndarray,
    map_size: Tuple[int, int],
    out_path: str,
    mode: str = "majority",
) -> str:
    """Each SOM cell's label (``cell_label_map``) as a map_size heatmap."""
    rows, cols = map_size
    cells = cell_label_map(bmu_indices, labels, rows * cols, mode=mode)
    return draw_heatmap(cells, map_size, out_path, mode)


def draw_projection(emb: np.ndarray, labels: np.ndarray, used: str, out_path: str) -> str:
    plt = _pyplot()
    fig, ax = plt.subplots(figsize=(6, 6))
    sc = ax.scatter(emb[:, 0], emb[:, 1], c=np.asarray(labels).reshape(-1), s=2,
                    cmap="tab10", alpha=0.6)
    ax.set_title(f"latent projection ({used})", fontsize=9)
    fig.colorbar(sc, ax=ax, fraction=0.046)
    return _save(fig, plt, out_path, dpi=150, bbox_inches="tight")


def visualize_latent_projection(latents, labels: np.ndarray, out_path: str,
                                method: str = "auto", seed: int = 0) -> str:
    """2-D projection scatter of latents coloured by label (reference
    ``visualize_umap_progression``: UMAP, cosine, n_neighbors 15)."""
    emb, used = latent_projection(latents, method, seed)
    return draw_projection(emb, labels, used, out_path)


def plot_params_vs_metric(
    names: Sequence[str],
    n_params_m: Sequence[float],
    purity: Sequence[Optional[float]],
    accuracy: Sequence[Optional[float]],
    out_path: str,
) -> str:
    """The paper's dual-axis params-vs-purity/accuracy scatter (reference
    ``tools/plot.py``) from the caller's numbers."""
    plt = _pyplot()
    fig, ax1 = plt.subplots(figsize=(5, 3.2))
    ax2 = ax1.twinx()
    for name, p, pur, acc in zip(names, n_params_m, purity, accuracy):
        if pur is not None:
            ax1.scatter(p, pur, marker="o", label=f"{name} (purity)")
            ax1.annotate(name, (p, pur), fontsize=6)
        if acc is not None:
            ax2.scatter(p, acc, marker="^")
            ax2.annotate(name, (p, acc), fontsize=6)
    ax1.set_xlabel("parameters (M)")
    ax1.set_ylabel("purity")
    ax2.set_ylabel("accuracy")
    ax1.set_xscale("log")
    fig.tight_layout()
    return _save(fig, plt, out_path, bbox_inches="tight")
