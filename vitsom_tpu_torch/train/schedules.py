"""Learning-rate and gamma schedules, evaluated on the host.

Counterparts of ``vitsom_tpu/train/schedules.py``. The JAX package evaluates
them inside the jitted step in float32; here the trainer evaluates them on
its host step counter, in numpy float32 arithmetic so the values match, and
hands plain floats to the optimizer and the loss.

- ``warmup_cosine_epoch_factor``: the reference LambdaLR lambda, stepped
  per epoch; ``min_lr`` is a multiplicative floor on the factor, not an
  absolute learning rate (a quirk of the reference, kept).
- ``cosine_annealing_lr``: torch CosineAnnealingLR in closed form.
- ``gamma_ramp``: linear 0 -> gamma over the first half of the steps.
"""

from __future__ import annotations

import math

import numpy as np

_f32 = np.float32


def warmup_cosine_epoch_factor(
    epoch: int, warmup_epochs: int, total_epochs: int, min_lr_factor: float
) -> float:
    """max(min_lr, min((e+1)/(warmup+1e-8), 0.5(cos(e/total*pi)+1)))."""
    e = _f32(epoch)
    warm = (e + _f32(1.0)) / _f32(warmup_epochs + 1e-8)
    cos = _f32(0.5) * (np.cos(e / _f32(total_epochs) * _f32(math.pi)) + _f32(1.0))
    return float(np.maximum(_f32(min_lr_factor), np.minimum(warm, cos)))


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
