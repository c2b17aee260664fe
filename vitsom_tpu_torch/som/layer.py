"""Self-Organizing Map core in PyTorch.

Counterpart of ``vitsom_tpu/som/layer.py``: the SOM is a prototype tensor
plus plain functions.

- ``init_prototypes``      — uniform [0, 1) init, row-normalised for cosine
- ``grid_positions``       — square/hexa topology coordinates
- ``grid_sq_distances``    — static [P, P] squared grid distances
- ``compute_distances``    — manhattan / euclidean / cosine
- ``bmu``                  — argmin over prototypes, first index on a tie
- ``neighborhood_weights`` — Gaussian weights gathered from the grid table
- ``som_loss``             — mean of weighted distances
- ``temperature_schedule`` — exponential Tmax -> Tmin decay at a host step,
  in numpy float32 arithmetic (the eval temperature)
- ``temperature_schedule_tensor`` / ``two_t_squared_tensor`` — the same
  functions of a step tensor on the model's device, in float32 tensor
  arithmetic: the train step computes them on the device, as the JAX step
  computes them from ``state.step``, so a captured step reads no host value
"""

from __future__ import annotations

import math
from typing import Optional, Tuple

import numpy as np
import torch

from vitsom_tpu_torch.config import SOMConfig


# ---------------------------------------------------------------------------
# static tables (host-side numpy; computed once per model build)
# ---------------------------------------------------------------------------


def grid_positions(map_size: Tuple[int, int], topology: str = "square") -> np.ndarray:
    """[P, 2] float32 grid coordinates: (row, col) for square; for hexa the
    odd rows shift by half a cell and the row pitch is sqrt(3)/2."""
    rows, cols = map_size
    n = rows * cols
    if topology == "square":
        gy, gx = np.meshgrid(np.arange(rows), np.arange(cols), indexing="ij")
        pos = np.stack([gy, gx], axis=-1).reshape(-1, 2).astype(np.float32)
    elif topology == "hexa":
        pos = np.zeros((n, 2), dtype=np.float32)
        idx = np.arange(n)
        row = idx // cols
        col = idx % cols
        pos[:, 0] = col + 0.5 * (row % 2 == 1)
        pos[:, 1] = row * math.sqrt(3.0) / 2.0
    else:
        raise ValueError(f"Unsupported topology: {topology}")
    return pos


def grid_sq_distances(map_size: Tuple[int, int], topology: str = "square") -> np.ndarray:
    """Static [P, P] matrix of squared grid distances between prototypes."""
    pos = grid_positions(map_size, topology)
    diff = pos[:, None, :] - pos[None, :, :]
    return np.sum(diff * diff, axis=-1).astype(np.float32)


# ---------------------------------------------------------------------------
# parameters
# ---------------------------------------------------------------------------


def init_prototypes(
    som: SOMConfig,
    latent_dim: int,
    generator: Optional[torch.Generator] = None,
) -> torch.Tensor:
    """Uniform [0, 1) init on the CPU; L2-row-normalised for cosine."""
    protos = torch.rand(
        (som.n_prototypes, latent_dim), generator=generator, dtype=torch.float32
    )
    if som.distance_fcn == "cosine":
        protos = protos / torch.linalg.norm(protos, dim=1, keepdim=True).clamp_min(1e-12)
    return protos


# ---------------------------------------------------------------------------
# distances / BMU / weights / loss
# ---------------------------------------------------------------------------


def compute_distances(
    x: torch.Tensor, prototypes: torch.Tensor, distance_fcn: str
) -> torch.Tensor:
    """[B, P] distances between inputs and prototypes."""
    if x.ndim > 2:
        x = x.reshape(x.shape[0], -1)
    if distance_fcn == "manhattan":
        return torch.sum(torch.abs(x[:, None, :] - prototypes[None, :, :]), dim=-1)
    if distance_fcn == "euclidean":
        x2 = torch.sum(x * x, dim=1, keepdim=True)
        p2 = torch.sum(prototypes * prototypes, dim=1)[None, :]
        cross = x @ prototypes.T
        sq = torch.clamp_min(x2 - 2.0 * cross + p2, 0.0)
        return torch.sqrt(sq)
    if distance_fcn == "cosine":
        xn = x / torch.linalg.norm(x, dim=1, keepdim=True).clamp_min(1e-12)
        pn = prototypes / torch.linalg.norm(prototypes, dim=1, keepdim=True).clamp_min(1e-12)
        return 1.0 - xn @ pn.T
    raise ValueError(f"Unsupported distance function: {distance_fcn}")


def bmu(distances: torch.Tensor) -> torch.Tensor:
    """Best-matching-unit indices, [B] int64; a tie goes to the first index
    (``torch.argmin`` returns the first minimal index)."""
    return torch.argmin(distances, dim=1)


def neighborhood_weights(
    bmu_indices: torch.Tensor, grid_sq_dist: torch.Tensor, temperature
) -> torch.Tensor:
    """Gaussian neighbourhood weights, [B, P], from a row gather of the
    static [P, P] table. They depend on the inputs only through the integer
    BMU, so no gradient flows through them. ``temperature`` is a host float
    or a float32 tensor (the train step's, on the device)."""
    d2 = grid_sq_dist[bmu_indices]
    if isinstance(temperature, torch.Tensor):
        return torch.exp(-d2 / two_t_squared_tensor(temperature))
    return torch.exp(-d2 / two_t_squared(temperature))


def two_t_squared(temperature) -> float:
    """``2 T^2`` rounded as float32 arithmetic rounds it (the JAX step and
    the CUDA kernel both compute it in float32)."""
    t = np.float32(temperature)
    return float(np.float32(2.0) * t * t)


def two_t_squared_tensor(temperature: torch.Tensor) -> torch.Tensor:
    """``2 T^2`` of a float32 tensor, as ``(2 T) T``: the products and their
    order of ``two_t_squared`` and of the CUDA kernel, so all three round
    alike."""
    return (2.0 * temperature) * temperature


def som_loss(weights: torch.Tensor, distances: torch.Tensor) -> torch.Tensor:
    """Mean of weighted distances."""
    return torch.mean(weights * distances)


def temperature_schedule(
    iteration: int, total_iterations: float, t_max: float, t_min: float
) -> float:
    """Exponential Tmax -> Tmin decay at a host step counter.

    ``total_iterations`` is the reference's float
    ``(len(dataset) / batch_size) * total_epochs``, not the drop-last step
    count. The arithmetic is float32, as in the JAX schedule, so the kernel
    sees the same temperature step for step.
    """
    frac = np.float32(iteration) / np.float32(total_iterations - 1.0)
    return float(np.float32(t_max) * np.float32(t_min / t_max) ** frac)


def temperature_schedule_tensor(
    step: torch.Tensor, total_iterations: float, t_max: float, t_min: float
) -> torch.Tensor:
    """``temperature_schedule`` of an integer step tensor, a float32 tensor
    on its device. The constants round to float32 as the host version
    rounds them; ``pow`` is the device's, which may differ from numpy's by
    an ulp (the eager and the captured step share this function, so they
    agree with each other bitwise). Python scalars enter the device
    arithmetic as kernel arguments, never as host-to-device copies, so a
    CUDA graph can capture it."""
    frac = step.to(torch.float32) / float(np.float32(total_iterations - 1.0))
    ratio = float(np.float32(t_min / t_max))
    return float(np.float32(t_max)) * torch.pow(ratio, frac)


def total_iterations(dataset_len: int, batch_size: int, total_epochs: int) -> float:
    """Reference ``update_temperature`` denominator."""
    return (dataset_len / batch_size) * total_epochs
