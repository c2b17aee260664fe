"""Normalisation statistics and the eval transform, as batched torch ops.

Counterpart of the deterministic part of ``vitsom_tpu/data/augment.py``
(``norm_stats`` and ``is_static_transform``, whether the train transform
draws no random numbers, are ``data/host_augment.py``'s):

- ``make_eval_transform``: the eval transform of every dataset. The
  mnist family scales uint8 to [0, 1]; the others resize the shorter side
  to ``int(input_size / 0.875)`` (crop_pct 1.0 above 224) with PIL's
  bicubic, center-crop to ``input_size`` and normalise. The JAX package
  runs that per image through PIL; here it runs batched on the images'
  device, as PIL's own arithmetic (``center_crop_resize``): fixed-point
  coefficients over windows cut at the edges, a horizontal pass rounded
  and clipped to uint8, then a vertical pass, so the grey levels are
  PIL's.

The random train augmentation is ``device_augment.make_device_train_augment``
on the device, or ``host_augment.make_train_transform`` (PIL, per image,
in worker processes) on the host path.
"""

from __future__ import annotations

from typing import Callable

import numpy as np
import torch

from vitsom_tpu_torch.config import DataConfig
from vitsom_tpu_torch.data.host_augment import (  # noqa: F401 (re-exported)
    CIFAR_MEAN, CIFAR_STD, IMAGENET_MEAN, IMAGENET_STD, MNIST_FAMILY, is_static_transform,
    norm_stats,
)

# PIL's fixed-point resampling: coefficients carry PRECISION_BITS fraction
# bits (Resample.c, 32 - 8 - 2 for 8-bit images)
PIL_PRECISION_BITS = 22
PIL_BICUBIC_SUPPORT = 2.0


def _pil_bicubic(x: float) -> float:
    a = -0.5
    x = abs(x)
    if x < 1.0:
        return ((a + 2.0) * x - (a + 3.0)) * x * x + 1
    if x < 2.0:
        return (((x - 5) * x + 8) * x - 4) * a
    return 0.0


def pil_resize_coeffs(in_size: int, out_size: int) -> np.ndarray:
    """[out_size, in_size] float64 matrix of PIL's fixed-point bicubic
    coefficients for a resize of one axis (``precompute_coeffs`` and
    ``normalize_coeffs_8bpc`` of Pillow's ``Resample.c``, in the same double
    arithmetic): each output pixel's window is cut at the image edges and
    renormalised, and each coefficient is rounded to an integer multiple of
    2^-22, stored as that integer."""
    scale = in_size / out_size
    filterscale = max(scale, 1.0)
    support = PIL_BICUBIC_SUPPORT * filterscale
    out = np.zeros((out_size, in_size), dtype=np.float64)
    one = float(1 << PIL_PRECISION_BITS)
    for xx in range(out_size):
        center = (xx + 0.5) * scale
        xmin = max(int(center - support + 0.5), 0)
        xmax = min(int(center + support + 0.5), in_size) - xmin
        k = [_pil_bicubic((x + xmin - center + 0.5) / filterscale) for x in range(xmax)]
        ww = sum(k)
        for x, w in enumerate(k):
            w = w / ww if ww != 0.0 else w
            out[xx, xmin + x] = int(-0.5 + w * one) if w < 0 else int(0.5 + w * one)
    return out


def _pil_pass(x: torch.Tensor, coeffs: torch.Tensor, dim: int) -> torch.Tensor:
    """One axis of PIL's 8-bit resample on a float64 tensor of grey levels:
    the integer sum of the fixed-point taps plus a half, shifted right by
    ``PIL_PRECISION_BITS`` and clipped to [0, 255]. The sums are integers
    below 2^53, so float64 holds them exactly."""
    y = torch.movedim(torch.movedim(x, dim, -1) @ coeffs.T, -1, dim)
    half = float(1 << (PIL_PRECISION_BITS - 1))
    return torch.clamp(torch.floor((y + half) / float(1 << PIL_PRECISION_BITS)), 0.0, 255.0)


def center_crop_resize(images: torch.Tensor, out_size: int, crop_pct: float) -> torch.Tensor:
    """PIL's bicubic ``resize`` of the shorter side to ``int(out_size /
    crop_pct)`` and a centered ``out_size`` crop, of uint8 images [B, H, W,
    C], as float64 grey levels [B, S, S, C]: PIL's horizontal pass, rounded
    and clipped to uint8, then its vertical pass, computed for the cropped
    pixels only (each output pixel reads only its own window)."""
    b, height, width, c = images.shape
    size = int(out_size / crop_pct)
    if width <= height:
        nw, nh = size, max(1, int(round(height * size / width)))
    else:
        nh, nw = size, max(1, int(round(width * size / height)))
    left, top = (nw - out_size) // 2, (nh - out_size) // 2
    dev = images.device
    cx = torch.from_numpy(pil_resize_coeffs(width, nw)[left:left + out_size]).to(dev)
    cy = torch.from_numpy(pil_resize_coeffs(height, nh)[top:top + out_size]).to(dev)
    x = _pil_pass(images.to(torch.float64), cx, 2)
    return _pil_pass(x, cy, 1)


def to_unit_range(images: torch.Tensor) -> torch.Tensor:
    """The mnist family's eval transform (ToTensor): uint8 divided by 255,
    any other dtype (usps, stored in [0, 1]) as it is, as float32."""
    return images.float() / 255.0 if images.dtype == torch.uint8 else images.float()


def make_eval_transform(data_cfg: DataConfig) -> Callable[[torch.Tensor], torch.Tensor]:
    """``fn(uint8 images [B, H, W, C]) -> float32 [B, S, S, C]`` on the
    images' device: the eval transform (module docstring)."""
    if data_cfg.dataset in MNIST_FAMILY:
        return to_unit_range
    size = data_cfg.input_size
    mean, std = norm_stats(data_cfg.dataset, data_cfg.num_channels)
    crop_pct = 0.875 if size <= 224 else 1.0

    def transform(images: torch.Tensor) -> torch.Tensor:
        dev = images.device
        x = center_crop_resize(images, size, crop_pct).to(torch.float32)
        mean_t = torch.tensor(mean, dtype=torch.float32, device=dev)
        std_t = torch.tensor(std, dtype=torch.float32, device=dev)
        return (x / 255.0 - mean_t) / std_t

    return transform
