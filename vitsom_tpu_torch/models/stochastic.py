"""Dropout and stochastic depth, with every mask drawn in one function.

Counterpart of Flax's ``nn.Dropout`` (DeiT) and of the JAX package's
``DropPath`` (``vitsom_tpu/models/swin.py``). A mask is Bernoulli(keep),
``keep = 1 - rate``, and is applied as ``where(mask, x / keep, 0)``: a
true division, as Flax and the JAX ``DropPath`` divide. ``F.dropout``
multiplies by ``1 / keep`` and differs in the last bit; on the card a
division by a Python float does the same (torch turns a host scalar
divisor into a multiplication by its reciprocal), so the divisor here is a
0-d tensor on the input's device.

Every mask comes from ``bernoulli_mask`` with an explicit
``torch.Generator``, so a test can hand the port and the JAX package the
same masks by replacing that one function (and ``jax.random.bernoulli``,
which both Flax's ``Dropout`` and the JAX ``DropPath`` call). The streams
themselves are not the JAX package's: its ``rbg`` keys and torch's Philox
give different bits, and the reference's cuRAND stream was a third.

A module draws only when it is called with a generator: ``generator=None``
is Flax's ``deterministic=True``. On the card the trainer owns one CUDA
generator for the masks and registers it with the captured train step
(``CUDAGraph.register_generator_state``), so each replay draws new masks
from where the last one left off, as an eager step would.
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch
from torch import nn


def bernoulli_mask(keep: float, shape: Sequence[int], generator: torch.Generator,
                   device) -> torch.Tensor:
    """A bool mask of ``shape``, each entry True with probability ``keep``,
    drawn from ``generator`` on ``device``: the one place the port draws a
    dropout or drop-path mask."""
    return torch.rand(tuple(shape), generator=generator, device=device) < keep


def drop(x: torch.Tensor, mask: torch.Tensor, keep: float) -> torch.Tensor:
    """``where(mask, x / keep, 0)`` with a true division (module docstring);
    ``mask`` broadcasts against ``x``."""
    return torch.where(mask, x / torch.full((), keep, dtype=x.dtype, device=x.device), 0.0)


class Dropout(nn.Module):
    """Flax ``nn.Dropout(rate)``: an element-wise mask of ``x``'s shape."""

    def __init__(self, rate: float):
        super().__init__()
        self.rate = float(rate)

    def forward(self, x: torch.Tensor, generator: Optional[torch.Generator] = None):
        if self.rate <= 0.0 or generator is None:
            return x
        keep = 1.0 - self.rate
        return drop(x, bernoulli_mask(keep, x.shape, generator, x.device), keep)


class DropPath(nn.Module):
    """Stochastic depth: one mask entry a sample, [B, 1, ..., 1], as the
    JAX package's ``DropPath`` (timm's semantics)."""

    def __init__(self, rate: float):
        super().__init__()
        self.rate = float(rate)

    def forward(self, x: torch.Tensor, generator: Optional[torch.Generator] = None):
        if self.rate <= 0.0 or generator is None:
            return x
        keep = 1.0 - self.rate
        shape = (x.shape[0],) + (1,) * (x.ndim - 1)
        return drop(x, bernoulli_mask(keep, shape, generator, x.device), keep)
