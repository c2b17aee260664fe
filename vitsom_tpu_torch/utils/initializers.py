"""In-place weight initializers with the JAX package's distributions.

Counterparts of ``vitsom_tpu/utils/initializers.py``, written for torch
layouts (Linear ``weight [out, in]``, Conv2d ``weight [out, in, kh, kw]``)
and explicit ``torch.Generator``s. They give a model built by the port the
same distributions as one built by the JAX package, not the same numbers:
parity tests carry weights across with ``vitsom_tpu_torch.convert``.
"""

from __future__ import annotations

import math
from typing import Optional

import torch


def _uniform_(t: torch.Tensor, bound: float, generator: Optional[torch.Generator]):
    with torch.no_grad():
        u = torch.rand(t.shape, generator=generator, dtype=t.dtype)
        t.copy_((u * 2.0 - 1.0) * bound)
    return t


def xavier_uniform_(weight: torch.Tensor, generator=None, fans=None):
    """Glorot uniform on a Linear weight [out, in]: U(+-sqrt(6/(in+out))).

    ``fans`` overrides (fan_in, fan_out); the split q/k/v projections use
    the fans of the fused [dim, 3*dim] matrix they stand in for."""
    fan_in, fan_out = fans if fans else (weight.shape[1], weight.shape[0])
    bound = math.sqrt(6.0 / (fan_in + fan_out))
    return _uniform_(weight, bound, generator)


def conv_xavier_as_linear_(weight: torch.Tensor, generator=None):
    """Xavier uniform treating a conv weight [out, in, kh, kw] as a Linear of
    shape (out, in*kh*kw): fan_in = in*kh*kw, fan_out = out."""
    c_out, c_in, kh, kw = weight.shape
    bound = math.sqrt(6.0 / (c_in * kh * kw + c_out))
    return _uniform_(weight, bound, generator)


def normal_(t: torch.Tensor, std: float = 0.02, generator=None):
    """N(0, std), the JAX package's ``trunc_or_normal`` (untruncated)."""
    with torch.no_grad():
        t.copy_(torch.randn(t.shape, generator=generator, dtype=t.dtype) * std)
    return t


def torch_default_bias_(bias: torch.Tensor, fan_in: int, generator=None):
    """torch Linear's default bias init: U(-1/sqrt(fan_in), 1/sqrt(fan_in))."""
    bound = 1.0 / math.sqrt(fan_in) if fan_in > 0 else 0.0
    return _uniform_(bias, bound, generator)
