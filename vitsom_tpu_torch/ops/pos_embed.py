"""2D sine-cosine position embeddings (numpy table).

The port's own copy of the fixed positional table of
``vitsom_tpu/ops/pos_embed.py``: half the channels encode the grid height,
half the width; each half is [sin | cos] over a 10000^-k frequency ladder;
an all-zero row is prepended for the CLS token. ``interpolate_pos_embed``
resizes a table to another grid as ``jax.image.resize``'s bicubic does.
"""

from __future__ import annotations

import numpy as np
import torch

from vitsom_tpu_torch.ops.resize import resize_weights


def _sincos_1d(embed_dim: int, pos: np.ndarray) -> np.ndarray:
    if embed_dim % 2 != 0:
        raise ValueError(f"embed_dim must be even, got {embed_dim}")
    omega = np.arange(embed_dim // 2, dtype=np.float64)
    omega /= embed_dim / 2.0
    omega = 1.0 / 10000**omega
    out = np.einsum("m,d->md", pos.reshape(-1), omega)
    return np.concatenate([np.sin(out), np.cos(out)], axis=1)


def get_2d_sincos_pos_embed(
    embed_dim: int, grid_size: int, cls_token: bool = False
) -> np.ndarray:
    """[(1+)G*G, D] float32 positional table (w goes first in the meshgrid)."""
    if embed_dim % 2 != 0:
        raise ValueError(f"embed_dim must be even, got {embed_dim}")
    grid_h = np.arange(grid_size, dtype=np.float32)
    grid_w = np.arange(grid_size, dtype=np.float32)
    grid = np.meshgrid(grid_w, grid_h)  # w first
    grid = np.stack(grid, axis=0).reshape([2, 1, grid_size, grid_size])

    emb_h = _sincos_1d(embed_dim // 2, grid[0])
    emb_w = _sincos_1d(embed_dim // 2, grid[1])
    pos = np.concatenate([emb_h, emb_w], axis=1)

    if cls_token:
        pos = np.concatenate([np.zeros([1, embed_dim]), pos], axis=0)
    return pos.astype(np.float32)


def interpolate_pos_embed(
    pos_embed: np.ndarray, new_grid_size: int, cls_token: bool = True
) -> np.ndarray:
    """A [(1+)G*G, D] positional table resized to a new grid size by
    ``jax.image.resize(..., "bicubic")``'s arithmetic (Keys' cubic, a =
    -0.5, antialiased when the grid shrinks; ``ops/resize.py``), applied
    as one product an axis (the reference's ``tools/utils.py:186-207``:
    checkpoint transfer between image resolutions; no shipped flow calls
    it). A table already at ``new_grid_size`` comes back as float32."""
    n_extra = 1 if cls_token else 0
    extra = pos_embed[:n_extra]
    patch_pos = pos_embed[n_extra:]
    dim = patch_pos.shape[1]
    old = int(round(patch_pos.shape[0] ** 0.5))
    if old == new_grid_size:
        return pos_embed.astype(np.float32)
    w = torch.from_numpy(resize_weights(old, new_grid_size, "cubic"))
    grid = torch.from_numpy(np.asarray(patch_pos, np.float32)).reshape(old, old, dim)
    resized = torch.einsum("ih,hwd->iwd", w, grid)
    resized = torch.einsum("jw,iwd->ijd", w, resized)
    resized = resized.reshape(new_grid_size * new_grid_size, dim).numpy()
    return np.concatenate([extra, resized], axis=0).astype(np.float32)
