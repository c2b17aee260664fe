"""Learning-rate and gamma schedules.

Counterparts of ``vitsom_tpu/train/schedules.py``. The JAX package evaluates
them inside the jitted step in float32, from ``state.step``. Each schedule
here has two versions with the same float32 arithmetic:

- the host version (``gamma_ramp``, ``make_lr_schedule``, ...) takes an int
  and computes in numpy float32;
- the tensor version (``gamma_ramp_tensor``, ``make_lr_schedule_tensor``,
  ...) takes the step as an integer tensor and computes on its device. The
  train step uses it, so a captured step reads no host value: every
  constant enters as a kernel argument, never as a host-to-device copy.

- ``warmup_cosine_epoch_factor``: the reference LambdaLR lambda, stepped
  per epoch; ``min_lr`` is a multiplicative floor on the factor, not an
  absolute learning rate (a quirk of the reference, kept).
- ``swin_warmup_cosine_factor``: the Swin baseline's lambda, a linear
  warm-up ``epoch / warmup_epochs`` (so epoch 0 trains at lr 0) then a
  cosine decay to the ratio ``min_lr / base_lr``;
- ``cosine_annealing_lr``: torch CosineAnnealingLR in closed form.
- ``gamma_ramp``: linear 0 -> gamma over the first half of the steps.
"""

from __future__ import annotations

import math

import numpy as np
import torch

_f32 = np.float32


def warmup_cosine_epoch_factor(
    epoch: int, warmup_epochs: int, total_epochs: int, min_lr_factor: float
) -> float:
    """max(min_lr, min((e+1)/(warmup+1e-8), 0.5(cos(e/total*pi)+1)))."""
    e = _f32(epoch)
    warm = (e + _f32(1.0)) / _f32(warmup_epochs + 1e-8)
    cos = _f32(0.5) * (np.cos(e / _f32(total_epochs) * _f32(math.pi)) + _f32(1.0))
    return float(np.maximum(_f32(min_lr_factor), np.minimum(warm, cos)))


def swin_warmup_cosine_factor(
    epoch: int, warmup_epochs: int, total_epochs: int, min_lr: float, base_lr: float
) -> float:
    """e / warmup before ``warmup_epochs``, then (1 - r) * 0.5 (1 + cos(pi *
    (e - warmup) / (total - warmup))) + r with r = min_lr / base_lr."""
    e = _f32(epoch)
    if e < warmup_epochs:
        return float(e / _f32(max(1, warmup_epochs)))
    progress = (e - _f32(warmup_epochs)) / _f32(max(1, total_epochs - warmup_epochs))
    cosine_decay = _f32(0.5) * (_f32(1.0) + np.cos(_f32(math.pi) * progress))
    r = _f32(min_lr / base_lr)
    return float((_f32(1.0) - r) * cosine_decay + r)


def cosine_annealing_lr(
    epoch: int, base_lr: float, total_epochs: int, eta_min: float = 0.0
) -> float:
    """lr = eta_min + (base - eta_min) * (1 + cos(pi * e / T_max)) / 2."""
    e = _f32(epoch)
    c = _f32(0.5) * (_f32(1.0) + np.cos(_f32(math.pi) * e / _f32(total_epochs)))
    return float(_f32(eta_min) + _f32(base_lr - eta_min) * c)


def gamma_ramp(iteration: int, gamma: float, ramp_up_end_step: int) -> float:
    """gamma * min(1, it / ramp_end); ``ramp_up_end_step`` is
    ``(steps_per_epoch * total_epochs) // 2`` with drop-last step counts."""
    frac = _f32(iteration) / _f32(max(1, ramp_up_end_step))
    return float(_f32(gamma) * np.minimum(_f32(1.0), frac))


def make_lr_schedule(opt_cfg, total_epochs: int, steps_per_epoch: int, base_lr: float):
    """Return step -> lr; the epoch is ``step // steps_per_epoch``, so the
    learning rate changes exactly at epoch boundaries, as LambdaLR does."""
    sched = opt_cfg.scheduler

    def schedule(step: int) -> float:
        epoch = int(step) // steps_per_epoch
        if sched == "cosine_annealing":
            if opt_cfg.warmup_epochs > 0:
                factor = warmup_cosine_epoch_factor(
                    epoch, opt_cfg.warmup_epochs, total_epochs, opt_cfg.min_lr
                )
                return float(_f32(base_lr) * _f32(factor))
            return cosine_annealing_lr(epoch, base_lr, total_epochs)
        if sched == "cosine_simple":
            return cosine_annealing_lr(epoch, base_lr, total_epochs)
        return float(_f32(base_lr))

    return schedule


def make_swin_lr_schedule(opt_cfg, total_epochs: int, steps_per_epoch: int, base_lr: float):
    """Step -> lr of the Swin baseline: ``base_lr *
    swin_warmup_cosine_factor(step // steps_per_epoch)``."""

    def schedule(step: int) -> float:
        factor = swin_warmup_cosine_factor(int(step) // steps_per_epoch, opt_cfg.warmup_epochs,
                                           total_epochs, opt_cfg.min_lr, base_lr)
        return float(_f32(base_lr) * _f32(factor))

    return schedule


# ---------------------------------------------------------------------------
# tensor versions: the step is an integer tensor on the model's device
# ---------------------------------------------------------------------------


def warmup_cosine_epoch_factor_tensor(
    epoch: torch.Tensor, warmup_epochs: int, total_epochs: int, min_lr_factor: float
) -> torch.Tensor:
    """``warmup_cosine_epoch_factor`` of an integer epoch tensor."""
    e = epoch.to(torch.float32)
    warm = (e + 1.0) / float(_f32(warmup_epochs + 1e-8))
    cos = 0.5 * (torch.cos(e / float(_f32(total_epochs)) * float(_f32(math.pi))) + 1.0)
    return torch.clamp_min(torch.minimum(warm, cos), float(_f32(min_lr_factor)))


def cosine_annealing_lr_tensor(
    epoch: torch.Tensor, base_lr: float, total_epochs: int, eta_min: float = 0.0
) -> torch.Tensor:
    """``cosine_annealing_lr`` of an integer epoch tensor."""
    e = epoch.to(torch.float32)
    c = 0.5 * (1.0 + torch.cos(float(_f32(math.pi)) * e / float(_f32(total_epochs))))
    return float(_f32(eta_min)) + float(_f32(base_lr - eta_min)) * c


def gamma_ramp_tensor(step: torch.Tensor, gamma: float, ramp_up_end_step: int) -> torch.Tensor:
    """``gamma_ramp`` of an integer step tensor."""
    frac = step.to(torch.float32) / float(_f32(max(1, ramp_up_end_step)))
    return float(_f32(gamma)) * torch.clamp_max(frac, 1.0)


def make_lr_schedule_tensor(opt_cfg, total_epochs: int, steps_per_epoch: int, base_lr: float):
    """``make_lr_schedule`` for an integer step tensor: returns step ->
    float32 lr tensor on the step's device."""
    sched = opt_cfg.scheduler
    lr0 = float(_f32(base_lr))

    def schedule(step: torch.Tensor) -> torch.Tensor:
        epoch = torch.div(step, steps_per_epoch, rounding_mode="floor")
        if sched == "cosine_annealing":
            if opt_cfg.warmup_epochs > 0:
                factor = warmup_cosine_epoch_factor_tensor(
                    epoch, opt_cfg.warmup_epochs, total_epochs, opt_cfg.min_lr
                )
                return lr0 * factor
            return cosine_annealing_lr_tensor(epoch, base_lr, total_epochs)
        if sched == "cosine_simple":
            return cosine_annealing_lr_tensor(epoch, base_lr, total_epochs)
        return torch.full((), lr0, dtype=torch.float32, device=step.device)

    return schedule


def swin_warmup_cosine_factor_tensor(
    epoch: torch.Tensor, warmup_epochs: int, total_epochs: int, min_lr: float, base_lr: float
) -> torch.Tensor:
    """``swin_warmup_cosine_factor`` of an integer epoch tensor."""
    e = epoch.to(torch.float32)
    warm = e / float(_f32(max(1, warmup_epochs)))
    progress = (e - float(_f32(warmup_epochs))) / float(_f32(max(1, total_epochs - warmup_epochs)))
    cosine_decay = 0.5 * (1.0 + torch.cos(float(_f32(math.pi)) * progress))
    r = float(_f32(min_lr / base_lr))
    return torch.where(e < warmup_epochs, warm, float(_f32(1.0 - _f32(r))) * cosine_decay + r)


def make_swin_lr_schedule_tensor(opt_cfg, total_epochs: int, steps_per_epoch: int,
                                 base_lr: float):
    """``make_swin_lr_schedule`` for an integer step tensor."""
    lr0 = float(_f32(base_lr))

    def schedule(step: torch.Tensor) -> torch.Tensor:
        epoch = torch.div(step, steps_per_epoch, rounding_mode="floor")
        return lr0 * swin_warmup_cosine_factor_tensor(
            epoch, opt_cfg.warmup_epochs, total_epochs, opt_cfg.min_lr, base_lr)

    return schedule
