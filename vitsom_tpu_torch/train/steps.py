"""ViT-SOM train and eval steps in PyTorch.

Counterpart of the ViT-SOM part of ``vitsom_tpu/train/steps.py``. The JAX
step is one pure jitted function over a TrainState; here the model and the
optimizer hold the state and the step runs eagerly, with the global step
counter on the host. The schedules (temperature, gamma ramp, learning rate)
are computed on the host from that counter and reach the device as plain
floats, so a step needs no device synchronisation.

Loss recipe (clustering): L1(recon, x) + gamma(t) * som_loss, gamma ramping
linearly over the first half of the total steps. With
``train.use_pallas_som`` (the flagship config) the SOM loss comes from the
fused SOM op: the CUDA kernel on the card, its plain version on the CPU.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict

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


def make_vit_som_train_step(
    cfg: Config,
    model,
    optimizer: torch.optim.Optimizer,
    statics: StepStatics,
    lr_schedule: Callable[[int], float],
):
    """Returns ``train_step(step, batch) -> metrics``: one forward, backward
    and optimizer update at host step ``step``. The metrics are 0-d tensors
    on the model's device (no host transfer) or host floats for the
    schedule values. Gradients stay in ``p.grad`` until the next step."""
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

    def train_step(step: int, batch: Dict[str, torch.Tensor]) -> Dict[str, object]:
        x = batch["image"]
        temperature = som.temperature_schedule(step, total_iters, cfg.som.t_max, cfg.som.t_min)
        cur_gamma = schedules.gamma_ramp(step, cfg.gamma, ramp_end)
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
        return {
            "train/recon_loss": recon_l.detach(),
            "train/som_loss": som_l.detach(),
            "train/total_loss": total.detach(),
            "hp/gamma": cur_gamma,
            "hp/temperature": temperature,
            "hp/lr": lr,
        }

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


def stack_metrics(history) -> Dict[str, np.ndarray]:
    """[{name: 0-d tensor or float}] -> {name: [steps] float array}, with one
    device-to-host transfer per tensor metric."""
    if not history:
        return {}
    out = {}
    for k in history[0]:
        vals = [h[k] for h in history]
        if isinstance(vals[0], torch.Tensor):
            out[k] = torch.stack(vals).float().cpu().numpy()
        else:
            out[k] = np.asarray(vals, dtype=np.float64)
    return out
