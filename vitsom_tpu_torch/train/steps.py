"""ViT-SOM train and eval steps in PyTorch.

Counterpart of the ViT-SOM part of ``vitsom_tpu/train/steps.py``. The JAX
step is one pure jitted function over a TrainState whose ``step`` lives on
the device, and the trainer scans it over an epoch. Here the model and the
optimizer hold the parameters and moments, and a ``DeviceState`` holds the
rest of what the JAX TrainState and the scan's stacked outputs hold: the
global step as an int64 tensor on the device, and a [capacity, 6] float32
metrics buffer. The train step reads the step tensor, computes the
temperature, the gamma ramp and the learning rate from it on the device,
runs forward, backward and AdamW, writes its six metrics into its row of
the buffer and increments the step tensor. It reads nothing on the host
and has no host-side value that changes from step to step, so the trainer
can capture it once as a CUDA graph and replay it (``train/trainer.py``);
the eager run calls the same function.

Loss recipe (clustering): L1(recon, x) + gamma(t) * som_loss, gamma ramping
linearly over the first half of the total steps. With
``train.use_pallas_som`` (the flagship config) the SOM loss comes from the
fused SOM op: the CUDA kernel on the card, its plain version on the CPU.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, Sequence

import numpy as np
import torch

from vitsom_tpu_torch.config import Config
from vitsom_tpu_torch.ops import som_fused
from vitsom_tpu_torch.som import layer as som
from vitsom_tpu_torch.train import optim, schedules


@dataclasses.dataclass(frozen=True)
class StepStatics:
    """Constants derived from the dataset size and the config."""

    steps_per_epoch: int  # floor(n_train / batch): drop-last semantics
    total_epochs: int
    dataset_len: int
    batch_size: int

    @property
    def total_steps(self) -> int:
        return self.steps_per_epoch * self.total_epochs

    @property
    def ramp_up_end_step(self) -> int:
        return self.total_steps // 2

    @property
    def total_iterations_float(self) -> float:
        return som.total_iterations(self.dataset_len, self.batch_size, self.total_epochs)


def l1_loss(pred: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    return torch.mean(torch.abs(pred - target))


def _uses_fused_som(cfg: Config) -> bool:
    return cfg.train.use_pallas_som and cfg.som.distance_fcn in ("euclidean", "cosine")


# the columns of the metrics buffer, in the order the step writes them
METRIC_KEYS = (
    "train/recon_loss", "train/som_loss", "train/total_loss",
    "hp/gamma", "hp/temperature", "hp/lr",
)


class DeviceState:
    """The train step's state beside the model and the optimizer, on one
    device: ``step`` (0-d int64, the global step), ``epoch_start`` (0-d
    int64, the global step of the current epoch's first step) and
    ``metrics`` ([capacity, 6] float32, row ``step - epoch_start`` holds
    that step's ``METRIC_KEYS``: the counterpart of the scan's stacked
    metrics). Their addresses never change, so a captured step reads and
    writes the same tensors at every replay."""

    def __init__(self, device, capacity: int):
        self.step = torch.zeros((), dtype=torch.int64, device=device)
        self.epoch_start = torch.zeros((), dtype=torch.int64, device=device)
        self.metrics = torch.zeros((capacity, len(METRIC_KEYS)), dtype=torch.float32,
                                   device=device)

    def row(self) -> torch.Tensor:
        """The current step's row of ``metrics``, a 0-d int64 tensor."""
        return self.step - self.epoch_start


def make_vit_som_train_step(
    cfg: Config,
    model,
    optimizer: torch.optim.Optimizer,
    statics: StepStatics,
    lr_schedule: Callable[[torch.Tensor], torch.Tensor],
    state: DeviceState,
):
    """Returns ``train_step(batch) -> metrics row``: one forward, backward
    and optimizer update at the step ``state.step`` holds, for a batch on
    the model's device. ``lr_schedule`` maps the step tensor to the lr
    tensor (``schedules.make_lr_schedule_tensor``). The step writes its
    metrics into row ``state.row()`` of ``state.metrics``, increments
    ``state.step`` and returns the values it wrote (a [6] tensor).
    Gradients stay in ``p.grad`` until the next step."""
    if cfg.classification:
        raise NotImplementedError("ViT-SOM classification is not ported yet")
    total_iters = statics.total_iterations_float
    ramp_end = statics.ramp_up_end_step
    use_fused = _uses_fused_som(cfg)
    if use_fused:
        fused_som = som_fused.make_fused_som(
            cfg.som.map_size, cfg.som.topology, cfg.som.distance_fcn
        )
    else:
        grid_d2 = torch.from_numpy(som.grid_sq_distances(cfg.som.map_size, cfg.som.topology))

    def train_step(batch: Dict[str, torch.Tensor]) -> torch.Tensor:
        x = batch["image"]
        step = state.step
        temperature = som.temperature_schedule_tensor(
            step, total_iters, cfg.som.t_max, cfg.som.t_min
        )
        cur_gamma = schedules.gamma_ramp_tensor(step, cfg.gamma, ramp_end)
        lr = lr_schedule(step)
        optim.set_learning_rate(optimizer, lr)

        optimizer.zero_grad(set_to_none=True)
        if use_fused:
            _, recon, _, z = model.features(x)
            som_l, _, _ = fused_som(z, model.prototypes, temperature)
        else:
            _, recon, _, distances, bmu_idx = model(x)
            weights = som.neighborhood_weights(
                bmu_idx, grid_d2.to(distances.device), temperature
            )
            som_l = som.som_loss(weights.detach(), distances)
        recon_l = l1_loss(recon, x)
        total = recon_l + cur_gamma * som_l
        total.backward()
        optimizer.step()
        values = torch.stack([recon_l.detach(), som_l.detach(), total.detach(),
                              cur_gamma, temperature, lr])
        state.metrics.index_copy_(0, state.row().reshape(1), values.reshape(1, -1))
        state.step.add_(1)
        return values

    return train_step


def make_vit_som_eval_step(cfg: Config, model):
    """Returns ``eval_step(batch, temperature) -> dict`` with ``bmu``,
    ``som_loss``, ``recon_loss`` and ``total_loss`` (full, unramped gamma).

    It takes (loss, bmu, distances) from the fused SOM forward under
    ``torch.no_grad()``: the kernel on the card, its plain version on the
    CPU. That is the same function as the JAX package's plain eval path at
    the same temperature (cosine/euclidean maps; manhattan uses the plain
    distances)."""
    if cfg.classification:
        raise NotImplementedError("ViT-SOM classification is not ported yet")
    gamma = cfg.gamma
    if cfg.som.distance_fcn in ("euclidean", "cosine"):
        fused_som = som_fused.make_fused_som(
            cfg.som.map_size, cfg.som.topology, cfg.som.distance_fcn
        )
    else:
        fused_som = None
        grid_d2 = torch.from_numpy(som.grid_sq_distances(cfg.som.map_size, cfg.som.topology))

    @torch.no_grad()
    def eval_step(batch: Dict[str, torch.Tensor], temperature: float) -> Dict[str, torch.Tensor]:
        x = batch["image"]
        if fused_som is not None:
            _, recon, _, z = model.features(x)
            som_l, bmu_idx, _ = fused_som(z, model.prototypes, temperature)
        else:
            _, recon, _, distances, bmu_idx = model(x)
            weights = som.neighborhood_weights(bmu_idx, grid_d2.to(x.device), temperature)
            som_l = som.som_loss(weights, distances)
        recon_l = l1_loss(recon, x)
        return {
            "bmu": bmu_idx,
            "som_loss": som_l,
            "recon_loss": recon_l,
            "total_loss": recon_l + gamma * som_l,
        }

    return eval_step


def metrics_dict(row) -> Dict[str, float]:
    """One row of the metrics buffer (a [6] tensor or array) -> {name:
    float}, with one device-to-host transfer."""
    vals = row.detach().cpu().numpy() if isinstance(row, torch.Tensor) else np.asarray(row)
    return {k: float(v) for k, v in zip(METRIC_KEYS, vals)}


def stack_metrics(rows: Sequence) -> Dict[str, np.ndarray]:
    """[[n_i, 6] metrics-buffer rows, host arrays or tensors] -> {name:
    [sum n_i] float array}, the keys of ``METRIC_KEYS``."""
    if not len(rows):
        return {}
    host = np.concatenate([r.detach().cpu().numpy() if isinstance(r, torch.Tensor)
                           else np.asarray(r) for r in rows]).astype(np.float64)
    return {k: host[:, i] for i, k in enumerate(METRIC_KEYS)}
