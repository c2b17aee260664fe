"""The weights of ``jax.image.resize`` along one axis, in JAX's float32
arithmetic.

``jax.image.resize`` is ``scale_and_translate`` with translation 0: for
output i the sample point (i + 0.5) / scale - 0.5, a kernel evaluated at
its distance to each input position, the kernel widened by 1 / scale when
it shrinks (antialiasing), each output's weights divided by their sum, and
zero where the sample point lies outside the input. Every step here is
rounded to float32 as XLA rounds it, so the weights are JAX's. A resize is
then one product an axis. The kernels:

- ``triangle`` (``"bilinear"``): max(0, 1 - |x|);
- ``cubic`` (``"bicubic"``): Keys' cubic with a = -0.5. ``F.interpolate``'s
  bicubic uses a = -0.75 and never antialiases, so it is another function.
"""

from __future__ import annotations

import numpy as np

_F = np.float32


def _triangle(x: np.ndarray) -> np.ndarray:
    return np.maximum(_F(0.0), _F(1.0) - x)


def _keys_cubic(x: np.ndarray) -> np.ndarray:
    out = ((_F(1.5) * x - _F(2.5)) * x) * x + _F(1.0)
    out = np.where(x >= _F(1.0), ((_F(-0.5) * x + _F(2.5)) * x - _F(4.0)) * x + _F(2.0), out)
    return np.where(x >= _F(2.0), _F(0.0), out).astype(_F)


KERNELS = {"triangle": _triangle, "cubic": _keys_cubic}


def resize_weights(in_size: int, out_size: int, kernel: str = "triangle") -> np.ndarray:
    """[out_size, in_size] float32 weights of ``jax.image.resize`` along one
    axis (``compute_weight_mat`` with antialiasing; module docstring)."""
    inv = 1.0 / (out_size / in_size)  # a Python float there, as here
    sample = (np.arange(out_size, dtype=_F) + _F(0.5)) * _F(inv) - _F(0.0) - _F(0.5)
    x = np.abs(sample[None, :] - np.arange(in_size, dtype=_F)[:, None]) / _F(max(inv, 1.0))
    w = KERNELS[kernel](x)  # [in, out]
    total = w.sum(axis=0, keepdims=True, dtype=_F)
    w = np.where(np.abs(total) > _F(1000.0 * float(np.finfo(np.float32).eps)),
                 w / np.where(total != 0, total, _F(1.0)), _F(0.0))
    inside = (sample >= _F(-0.5)) & (sample <= _F(in_size - 0.5))
    return np.where(inside[None, :], w, _F(0.0)).T.copy()
