"""ViT-SOM, DESOM and classifier (ViT, Swin, DeiT, MobileViT) train and
eval steps in PyTorch.

Counterpart of ``vitsom_tpu/train/steps.py`` (the DeiT train step is in
``models/deit.py``, as in the JAX package). The JAX
step is one pure jitted function over a TrainState whose ``step`` lives on
the device, and the trainer scans it over an epoch. Here the model and the
optimizer hold the parameters and moments, and a ``DeviceState`` holds the
rest of what the JAX TrainState and the scan's stacked outputs hold: the
global step as an int64 tensor on the device, and a [capacity, K] float32
metrics buffer (K = 6 columns for ViT-SOM, 5 or 6 for DESOM, 2 for the
classifier: ``metric_keys``). The train step reads the step tensor,
computes the temperature, the gamma ramp and the learning rate from it on
the device, runs forward, backward and AdamW, writes its metrics into its
row of the buffer and increments the step tensor. It reads nothing on the host
and has no host-side value that changes from step to step, so the trainer
can capture it once as a CUDA graph and replay it (``train/trainer.py``);
the eager run calls the same function.

Loss recipes, as the JAX package's:

- ViT-SOM clustering: L1(recon, x) + gamma(t) * som_loss, gamma ramping
  linearly over the first half of the total steps;
- ViT-SOM classification (``data.num_classes > 0``): CE(logits, y, label
  smoothing) + gamma(t) * som_loss. The loss reads no reconstruction, so
  the step runs the encoder only (``ViTSOM.encode``), as XLA drops the
  decoder from the JAX step; the decoder's parameters get zero gradients,
  as optax hands them, so AdamW still decays them;
- DESOM clustering: L1(decoded, x_flat) + gamma * som_loss (constant
  gamma); DESOM classification: CE (no smoothing) + gamma * (som_loss +
  recon_loss). The neighbourhood weights are held constant; BatchNorm, if
  on, normalises with the batch's statistics and moves its running
  averages in place (``models/ae.py``);
- ViT, Swin and MobileViT classifiers: CE with the smoothing the caller
  passes (the JAX trainer passes 0 for ``vit``, ``optimizer.smoothing``
  for the others); Swin's drop-path draws its masks from the generator the
  step is given; MobileViT's BatchNorm normalises with the batch's
  statistics and moves its running averages in place (``models/ae.py``),
  as the JAX step threads ``batch_stats``;
- DeiT: CE * (1 - alpha) + alpha * distillation against the frozen
  teacher, dropout from the step's generator (``models/deit.py``).

With ``train.use_pallas_som`` (every shipped ViT-SOM config) the SOM loss
comes from the fused SOM op: the CUDA kernel on the card, its plain version
on the CPU.

Under data parallelism (a process group: ``parallel/distributed.py``)
every rank runs the same step on its rows of the global batch: the fused
SOM op on the rank's rows, its loss the mean over the ranks
(``som_fused.make_fused_som_sharded``, the JAX ``pmean``), the gradients
averaged over the ranks just before the optimizer's step (the trainer's
step pre-hook), and the loss columns of the metrics row averaged over the
ranks before it is written (``DeviceState.average_losses``), so that every
rank writes the global batch's metrics.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, Optional, Sequence

import numpy as np
import torch

from vitsom_tpu_torch.config import Config
from vitsom_tpu_torch.ops import som_fused
from vitsom_tpu_torch.parallel import distributed as dist_lib
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


def cross_entropy(logits: torch.Tensor, labels: torch.Tensor, smoothing: float = 0.0):
    """Mean CE against one-hot targets smoothed as optax's ``smooth_labels``
    (``(1 - s) * onehot + s / K``, torch's ``label_smoothing``); ``labels``
    are class indices. Written out, so a captured step holds no check. A
    label outside [0, K) has an all-zero one-hot row, as ``jax.nn.one_hot``
    gives it (the synthetic medmnist stand-in draws 10 labels for 9
    classes): its term is the smoothing's alone."""
    logp = torch.log_softmax(logits.float(), dim=-1)
    labels = labels.long().reshape(-1, 1)
    valid = (labels >= 0) & (labels < logp.shape[-1])
    nll = -(logp.gather(1, labels.clamp(0, logp.shape[-1] - 1)) * valid)[:, 0]
    if smoothing > 0.0:
        nll = (1.0 - smoothing) * nll - smoothing * logp.mean(dim=-1)
    return nll.mean()


def _uses_fused_som(cfg: Config) -> bool:
    return cfg.train.use_pallas_som and cfg.som.distance_fcn in ("euclidean", "cosine")


# the columns of the metrics buffer, in the order the step writes them:
# ViT-SOM clustering, ViT-SOM classification, the ViT classifier
METRIC_KEYS = (
    "train/recon_loss", "train/som_loss", "train/total_loss",
    "hp/gamma", "hp/temperature", "hp/lr",
)
CLS_METRIC_KEYS = ("train/cls_loss",) + METRIC_KEYS[1:]
CLASSIFIER_METRIC_KEYS = ("train/cls_loss", "hp/lr")
# DeiT (``models/deit.py``): the whole distillation loss, the CE, the lr
DEIT_METRIC_KEYS = ("train/distill_loss", "train/cls_loss", "hp/lr")
# DESOM clustering; classification adds the CE in front
DESOM_METRIC_KEYS = ("train/recon_loss", "train/som_loss", "train/total_loss",
                     "hp/temperature", "hp/lr")


def metric_keys(cfg: Config) -> tuple:
    """The metrics-buffer columns of ``cfg``'s train step."""
    if cfg.model_arch in ("vit", "swin", "mobile_vit"):
        return CLASSIFIER_METRIC_KEYS
    if cfg.model_arch == "deit":
        return DEIT_METRIC_KEYS
    if cfg.model_arch == "desom":
        return (("train/cls_loss",) if cfg.classification else ()) + DESOM_METRIC_KEYS
    return CLS_METRIC_KEYS if cfg.classification else METRIC_KEYS


class DeviceState:
    """The train step's state beside the model and the optimizer, on one
    device: ``step`` (0-d int64, the global step), ``epoch_start`` (0-d
    int64, the global step of the current epoch's first step) and
    ``metrics`` ([capacity, len(keys)] float32, row ``step - epoch_start``
    holds that step's ``keys``, ``metric_keys(cfg)``: the counterpart of the
    scan's stacked metrics). Their addresses never change, so a captured
    step reads and writes the same tensors at every replay."""

    def __init__(self, device, capacity: int, keys: Sequence[str] = METRIC_KEYS):
        self.keys = tuple(keys)
        self.step = torch.zeros((), dtype=torch.int64, device=device)
        self.epoch_start = torch.zeros((), dtype=torch.int64, device=device)
        self.metrics = torch.zeros((capacity, len(self.keys)), dtype=torch.float32,
                                   device=device)
        self._losses: Optional[torch.Tensor] = None

    def average_losses(self) -> None:
        """From now on ``write`` averages the row's loss columns over the
        ranks (data parallelism); the schedules' columns are the same on
        every rank and stay as they are."""
        self._losses = torch.tensor(["loss" in k for k in self.keys],
                                    device=self.metrics.device)

    def row(self) -> torch.Tensor:
        """The current step's row of ``metrics``, a 0-d int64 tensor."""
        return self.step - self.epoch_start

    def write(self, values: torch.Tensor) -> None:
        """Write a step's metrics into its row and advance the step."""
        if self._losses is not None:
            values = torch.where(self._losses, dist_lib.all_reduce_mean(values), values)
        self.metrics.index_copy_(0, self.row().reshape(1), values.reshape(1, -1))
        self.step.add_(1)


def model_device(model) -> torch.device:
    return next(model.parameters()).device


def _grid_table(cfg: Config, model) -> torch.Tensor:
    """The static [P, P] squared grid distances on the model's device."""
    return torch.from_numpy(
        som.grid_sq_distances(cfg.som.map_size, cfg.som.topology)
    ).to(model_device(model))


def _zero_missing_grads(model) -> None:
    """Give every parameter that the loss did not reach a zero gradient:
    optax hands such parameters zeros, and AdamW then still decays them,
    where ``torch.optim.AdamW`` would skip a ``None`` gradient. The zeros
    are written into the same tensors at every step of a captured graph."""
    for p in model.parameters():
        if p.grad is None:
            p.grad = torch.zeros_like(p)


def _som_loss_fn(cfg: Config, model):
    """``(z, temperature) -> (som_loss, bmu)``: the fused SOM op with
    ``train.use_pallas_som`` (euclidean and cosine maps; under data
    parallelism its loss averaged over the ranks), else the plain
    distances with the neighbourhood weights held constant."""
    if _uses_fused_som(cfg):
        make = (som_fused.make_fused_som_sharded if dist_lib.initialized()
                else som_fused.make_fused_som)
        fused_som = make(cfg.som.map_size, cfg.som.topology, cfg.som.distance_fcn)

        def fused(z, temperature):
            loss, bmu_idx, _ = fused_som(z, model.prototypes, temperature)
            return loss, bmu_idx

        return fused
    grid_d2 = _grid_table(cfg, model)

    def plain(z, temperature):
        distances = som.compute_distances(z, model.prototypes, cfg.som.distance_fcn)
        bmu_idx = som.bmu(distances)
        weights = som.neighborhood_weights(bmu_idx, grid_d2, temperature)
        return som.som_loss(weights.detach(), distances), bmu_idx

    return plain


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
    the model's device (``image``; and ``label``, class indices, with
    ``num_classes > 0``). ``lr_schedule`` maps the step tensor to the lr
    tensor (``schedules.make_lr_schedule_tensor``). The step writes its
    metrics (``metric_keys(cfg)``) into row ``state.row()`` of
    ``state.metrics``, increments ``state.step`` and returns the values it
    wrote. Gradients stay in ``p.grad`` until the next step."""
    total_iters = statics.total_iterations_float
    ramp_end = statics.ramp_up_end_step
    classification = cfg.classification
    smoothing = cfg.optimizer.smoothing
    som_loss_fn = _som_loss_fn(cfg, model)

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
        if classification:
            logits, z = model.encode(x)
            main_l = cross_entropy(logits, batch["label"], smoothing)
        else:
            _, recon, _, z = model.features(x)
            main_l = l1_loss(recon, x)
        som_l, _ = som_loss_fn(z, temperature)
        total = main_l + cur_gamma * som_l
        total.backward()
        if classification:
            _zero_missing_grads(model)
        optimizer.step()
        values = torch.stack([main_l.detach(), som_l.detach(), total.detach(),
                              cur_gamma, temperature, lr])
        state.write(values)
        return values

    return train_step


def make_vit_som_eval_step(cfg: Config, model):
    """Returns ``eval_step(batch, temperature) -> dict`` with ``bmu``,
    ``logits`` ([B, 1] zeros on the clustering objective, as the JAX step),
    ``som_loss``, ``recon_loss`` and ``total_loss`` (full, unramped gamma);
    with ``num_classes > 0`` the logits are the head's, ``cls_loss`` is
    added (label smoothing kept, as the JAX eval step keeps it), and
    ``total_loss`` is ``cls_loss + gamma * som_loss``. The decoder runs: ``recon_loss`` is
    reported in both modes.

    It takes (loss, bmu, distances) from the fused SOM forward under
    ``torch.no_grad()``: the kernel on the card, its plain version on the
    CPU. That is the same function as the JAX package's plain eval path at
    the same temperature (cosine/euclidean maps; manhattan uses the plain
    distances)."""
    gamma = cfg.gamma
    smoothing = cfg.optimizer.smoothing
    if cfg.som.distance_fcn in ("euclidean", "cosine"):
        fused_som = som_fused.make_fused_som(
            cfg.som.map_size, cfg.som.topology, cfg.som.distance_fcn
        )
    else:
        fused_som = None
        grid_d2 = _grid_table(cfg, model)

    @torch.no_grad()
    def eval_step(batch: Dict[str, torch.Tensor], temperature: float) -> Dict[str, torch.Tensor]:
        x = batch["image"]
        _, recon, logits, z = model.features(x)
        if fused_som is not None:
            som_l, bmu_idx, _ = fused_som(z, model.prototypes, temperature)
        else:
            distances = som.compute_distances(z, model.prototypes, cfg.som.distance_fcn)
            bmu_idx = som.bmu(distances)
            weights = som.neighborhood_weights(bmu_idx, grid_d2, temperature)
            som_l = som.som_loss(weights, distances)
        recon_l = l1_loss(recon, x)
        out = {"bmu": bmu_idx, "som_loss": som_l, "recon_loss": recon_l}
        if logits is not None:
            cls_l = cross_entropy(logits, batch["label"], smoothing)
            out.update(logits=logits, cls_loss=cls_l, total_loss=cls_l + gamma * som_l)
        else:
            out.update(logits=torch.zeros((x.shape[0], 1), dtype=z.dtype, device=z.device),
                       total_loss=recon_l + gamma * som_l)
        return out

    return eval_step


def make_desom_train_step(
    cfg: Config,
    model,
    optimizer: torch.optim.Optimizer,
    statics: StepStatics,
    lr_schedule: Callable[[torch.Tensor], torch.Tensor],
    state: DeviceState,
):
    """Returns ``train_step(batch) -> metrics row`` for DESOM: the images
    flattened to [B, C*H*W], one ``forward_with_recon`` (BatchNorm on the
    batch's statistics), the plain SOM loss at the temperature of the step
    ``state.step`` holds, backward and Adam, as ``make_vit_som_train_step``
    does; writes ``metric_keys(cfg)`` into the metrics buffer."""
    grid_d2 = _grid_table(cfg, model)
    total_iters = statics.total_iterations_float
    classification = cfg.classification
    gamma = cfg.gamma

    def train_step(batch: Dict[str, torch.Tensor]) -> torch.Tensor:
        x = batch["image"]
        x_flat = x.reshape(x.shape[0], -1)
        step = state.step
        temperature = som.temperature_schedule_tensor(
            step, total_iters, cfg.som.t_max, cfg.som.t_min
        )
        lr = lr_schedule(step)
        optim.set_learning_rate(optimizer, lr)

        optimizer.zero_grad(set_to_none=True)
        logits, _, distances, bmu_idx, decoded = model.forward_with_recon(x_flat, train=True)
        weights = som.neighborhood_weights(bmu_idx, grid_d2, temperature)
        som_l = som.som_loss(weights.detach(), distances)
        recon_l = l1_loss(decoded, x_flat)
        if classification:
            cls_l = cross_entropy(logits, batch["label"])
            total = cls_l + gamma * (som_l + recon_l)
            front = [cls_l.detach()]
        else:
            total = recon_l + gamma * som_l
            front = []
        total.backward()
        optimizer.step()
        values = torch.stack(front + [recon_l.detach(), som_l.detach(), total.detach(),
                                      temperature, lr])
        state.write(values)
        return values

    return train_step


def make_desom_eval_step(cfg: Config, model):
    """Returns ``eval_step(batch, temperature=None) -> dict`` with ``bmu``,
    ``logits`` ([B, 1] zeros without a classifier, as the JAX step) and
    ``latent``, from the flattened images, BatchNorm on its running
    averages. It computes no loss, as the JAX step computes none."""

    @torch.no_grad()
    def eval_step(batch: Dict[str, torch.Tensor], temperature=None) -> Dict[str, torch.Tensor]:
        x = batch["image"]
        logits, z, _, bmu_idx = model(x.reshape(x.shape[0], -1))
        if logits is None:
            logits = torch.zeros((x.shape[0], 1), dtype=z.dtype, device=z.device)
        return {"bmu": bmu_idx, "logits": logits, "latent": z}

    return eval_step


def make_classifier_train_step(
    cfg: Config,
    model,
    optimizer: torch.optim.Optimizer,
    lr_schedule: Callable[[torch.Tensor], torch.Tensor],
    smoothing: float,
    state: DeviceState,
    generator: Optional[torch.Generator] = None,
):
    """Returns ``train_step(batch) -> metrics row`` for the ViT, Swin and
    MobileViT classifiers: CE(logits, label, ``smoothing``), backward and
    AdamW at the step ``state.step`` holds; writes
    ``CLASSIFIER_METRIC_KEYS`` (the loss and the lr) into the metrics
    buffer, as ``make_vit_som_train_step`` does. ``vit`` draws no random
    numbers in its forward (its blocks ignore ``drop_path``); Swin's
    drop-path draws its masks from ``generator`` (``models/stochastic.py``),
    which a Swin step requires; MobileViT draws nothing and runs its
    BatchNorm on the batch's statistics (``train=True``)."""
    if cfg.model_arch not in ("vit", "swin", "mobile_vit"):
        raise NotImplementedError(f"the {cfg.model_arch} classifier step is not ported yet")
    if cfg.model_arch == "swin" and generator is None:
        raise ValueError("the Swin train step draws drop-path masks: pass a generator")
    kwargs = ({"generator": generator} if cfg.model_arch == "swin"
              else {"train": True} if cfg.model_arch == "mobile_vit" else {})

    def train_step(batch: Dict[str, torch.Tensor]) -> torch.Tensor:
        lr = lr_schedule(state.step)
        optim.set_learning_rate(optimizer, lr)
        optimizer.zero_grad(set_to_none=True)
        loss = cross_entropy(model(batch["image"], **kwargs), batch["label"], smoothing)
        loss.backward()
        optimizer.step()
        values = torch.stack([loss.detach(), lr])
        state.write(values)
        return values

    return train_step


def make_classifier_eval_step(cfg: Config, model):
    """Returns ``eval_step(batch, temperature=None) -> dict`` with
    ``logits``, ``bmu`` (zeros) and ``cls_loss``, the model deterministic
    (MobileViT's BatchNorm on its running averages). The smoothing is the
    JAX package's rule: Swin and MobileViT validate with their smoothed
    train CE, ``vit`` and ``deit`` with plain CE."""
    if cfg.model_arch not in ("vit", "swin", "deit", "mobile_vit"):
        raise NotImplementedError(f"the {cfg.model_arch} classifier eval is not ported yet")
    smoothing = cfg.optimizer.smoothing if cfg.model_arch in ("swin", "mobile_vit") else 0.0

    @torch.no_grad()
    def eval_step(batch: Dict[str, torch.Tensor], temperature=None) -> Dict[str, torch.Tensor]:
        logits = model(batch["image"])
        return {
            "logits": logits,
            "bmu": torch.zeros(logits.shape[0], dtype=torch.int64, device=logits.device),
            "cls_loss": cross_entropy(logits, batch["label"], smoothing),
        }

    return eval_step


def metrics_dict(row, keys: Sequence[str] = METRIC_KEYS) -> Dict[str, float]:
    """One row of the metrics buffer (a tensor or array) -> {name: float}
    over ``keys`` (the buffer's ``DeviceState.keys``), with one
    device-to-host transfer."""
    vals = row.detach().cpu().numpy() if isinstance(row, torch.Tensor) else np.asarray(row)
    return {k: float(v) for k, v in zip(keys, vals)}


def stack_metrics(rows: Sequence, keys: Sequence[str] = METRIC_KEYS) -> Dict[str, np.ndarray]:
    """[[n_i, len(keys)] metrics-buffer rows, host arrays or tensors] ->
    {name: [sum n_i] float array} over ``keys``."""
    if not len(rows):
        return {}
    host = np.concatenate([r.detach().cpu().numpy() if isinstance(r, torch.Tensor)
                           else np.asarray(r) for r in rows]).astype(np.float64)
    return {k: host[:, i] for i, k in enumerate(keys)}
