"""Normalisation statistics and the eval transform, as batched torch ops.

Counterpart of the deterministic part of ``vitsom_tpu/data/augment.py``:

- ``norm_stats``: the per-dataset mean and std;
- ``is_static_transform``: whether the train transform draws no random
  numbers (then a split can be transformed once);
- ``make_eval_transform``: the eval transform of every dataset. The
  mnist family scales uint8 to [0, 1]; the others resize the shorter side
  to ``int(input_size / 0.875)`` (crop_pct 1.0 above 224) with PIL's
  bicubic, center-crop to ``input_size`` and normalise. The JAX package
  runs that per image through PIL; here it runs batched on the images'
  device, through ``device_augment``'s PIL-convention warp (a = -0.5),
  clipped to [0, 255] and rounded as PIL's uint8 output is.

The random train augmentation is ``device_augment.make_device_train_augment``.
The host (PIL) augmentation path is not ported: no port module imports PIL.
"""

from __future__ import annotations

from typing import Callable, Tuple

import torch

from vitsom_tpu_torch.config import DataConfig
from vitsom_tpu_torch.data import device_augment as da

IMAGENET_MEAN = (0.485, 0.456, 0.406)
IMAGENET_STD = (0.229, 0.224, 0.225)
CIFAR_MEAN = (0.4914, 0.4822, 0.4465)
CIFAR_STD = (0.2023, 0.1994, 0.2010)
MNIST_FAMILY = ("mnist", "fmnist", "usps")


def norm_stats(dataset: str, num_channels: int) -> Tuple[Tuple[float, ...], Tuple[float, ...]]:
    """Normalisation (mean, std) per dataset."""
    if num_channels == 1:
        return (0.5,), (0.5,)
    if dataset in ("cifar-10", "cifar-100"):
        return CIFAR_MEAN, CIFAR_STD
    if dataset == "medmnist":
        return (0.5, 0.5, 0.5), (0.5, 0.5, 0.5)
    return IMAGENET_MEAN, IMAGENET_STD


def is_static_transform(data_cfg: DataConfig) -> bool:
    """True when the train transform is deterministic (no random augs)."""
    if data_cfg.dataset in MNIST_FAMILY + ("reuters-10k",):
        return True
    a = data_cfg.augment
    return (
        a.randaug_n == 0
        and tuple(a.resize_scale) == (1.0, 1.0)
        and tuple(a.resize_ratio) == (1.0, 1.0)
        and a.reprob == 0
        and a.horizontal_flip == 0
        and not a.autoaugment
    )


def center_crop_matrix(height: int, width: int, out_size: int, crop_pct: float) -> torch.Tensor:
    """[2, 3] out->in affine (``device_augment._warp`` convention) of PIL's
    ``resize`` of the shorter side to ``int(out_size / crop_pct)`` followed
    by a centered ``out_size`` crop. Output pixel center xo + .5 lies at
    resized position xo + left + .5, which is input position (xo + left +
    .5) * width / new_width."""
    size = int(out_size / crop_pct)
    if width <= height:
        nw, nh = size, max(1, int(round(height * size / width)))
    else:
        nh, nw = size, max(1, int(round(width * size / height)))
    left, top = (nw - out_size) // 2, (nh - out_size) // 2
    sx, sy = width / nw, height / nh
    return torch.tensor([[sx, 0.0, left * sx], [0.0, sy, top * sy]], dtype=torch.float32)


def make_eval_transform(data_cfg: DataConfig) -> Callable[[torch.Tensor], torch.Tensor]:
    """``fn(uint8 images [B, H, W, C]) -> float32 [B, S, S, C]`` on the
    images' device: the eval transform (module docstring)."""
    if data_cfg.dataset in MNIST_FAMILY:
        return lambda images: images.float() / 255.0
    size = data_cfg.input_size
    mean, std = norm_stats(data_cfg.dataset, data_cfg.num_channels)
    crop_pct = 0.875 if size <= 224 else 1.0

    def transform(images: torch.Tensor) -> torch.Tensor:
        b, h, w, c = images.shape
        dev = images.device
        mats = center_crop_matrix(h, w, size, crop_pct).to(dev).expand(b, 2, 3)
        x = da.warp_axis_aligned(images.float(), mats, size, "bicubic")
        x = torch.round(torch.clamp(x, 0.0, 255.0))
        mean_t = torch.tensor(mean, dtype=torch.float32, device=dev)
        std_t = torch.tensor(std, dtype=torch.float32, device=dev)
        return (x / 255.0 - mean_t) / std_t

    return transform
