"""The host augmentation path's per-image train transform, in numpy and PIL.

The port's own copy of the host half of ``vitsom_tpu/data/augment.py``
(``tf_random_resized_crop``, ``torch_random_resized_crop``,
``rand_augment``, ``timm_rand_augment``, ``random_erasing``,
``_to_pil`` / ``_from_pil``, ``make_train_transform``): the same PIL calls
drawing from the same ``np.random.Generator`` in the same order, so one
generator gives the JAX package's arrays bitwise. It is what the data
module runs per image where the train transform is random and the images
do not go through the device augmentation (``data.device_augment: false``,
or a source of variable-size images: a jpg dir's object array,
tiny-imagenet's paths), in worker processes at batch granularity
(``data/pipeline.py``).

This module imports no torch, and PIL only inside the functions that use
it, so a worker process loads numpy, PIL and the config alone. The
worker functions live here for that reason (``worker_init``,
``worker_run``).
"""

from __future__ import annotations

import functools
import math
from typing import Callable, Dict, Sequence, Tuple

import numpy as np

from vitsom_tpu_torch.config import DataConfig
from vitsom_tpu_torch.data.datasets import load_image

IMAGENET_MEAN = (0.485, 0.456, 0.406)
IMAGENET_STD = (0.229, 0.224, 0.225)
CIFAR_MEAN = (0.4914, 0.4822, 0.4465)
CIFAR_STD = (0.2023, 0.1994, 0.2010)
MNIST_FAMILY = ("mnist", "fmnist", "usps")


def norm_stats(dataset: str, num_channels: int) -> Tuple[Tuple[float, ...], Tuple[float, ...]]:
    """Normalisation (mean, std) per dataset (``data/augment.py``'s)."""
    if num_channels == 1:
        return (0.5,), (0.5,)
    if dataset in ("cifar-10", "cifar-100"):
        return CIFAR_MEAN, CIFAR_STD
    if dataset == "medmnist":
        return (0.5, 0.5, 0.5), (0.5, 0.5, 0.5)
    return IMAGENET_MEAN, IMAGENET_STD


def is_static_transform(data_cfg: DataConfig) -> bool:
    """True when the train transform draws no random numbers."""
    if data_cfg.dataset in MNIST_FAMILY + ("reuters-10k",):
        return True
    a = data_cfg.augment
    return (a.randaug_n == 0 and tuple(a.resize_scale) == (1.0, 1.0)
            and tuple(a.resize_ratio) == (1.0, 1.0) and a.reprob == 0
            and a.horizontal_flip == 0 and not a.autoaugment)


def materialize(item) -> np.ndarray:
    """An HWC array from a source element: a path is decoded."""
    return load_image(item) if isinstance(item, str) else np.asarray(item)


# ---------------------------------------------------------------------------
# geometric ops
# ---------------------------------------------------------------------------


def tf_random_resized_crop(img, rng: np.random.Generator, out_size: int,
                           scale: Tuple[float, float], ratio: Tuple[float, float]):
    """BYOL/TF-style RandomResizedCrop: one draw, w and h clamped to the
    image, no retry."""
    from PIL import Image

    width, height = img.size
    area = height * width
    target_area = area * rng.uniform(scale[0], scale[1])
    log_ratio = (math.log(ratio[0]), math.log(ratio[1]))
    aspect = math.exp(rng.uniform(*log_ratio))
    w = min(int(round(math.sqrt(target_area * aspect))), width)
    h = min(int(round(math.sqrt(target_area / aspect))), height)
    i = int(rng.integers(0, height - h + 1))
    j = int(rng.integers(0, width - w + 1))
    return img.resize((out_size, out_size), Image.BICUBIC, box=(j, i, j + w, i + h))


def torch_random_resized_crop(img, rng: np.random.Generator, out_size: int,
                              scale: Tuple[float, float] = (0.08, 1.0),
                              ratio: Tuple[float, float] = (3.0 / 4.0, 4.0 / 3.0)):
    """torchvision's RandomResizedCrop: 10 attempts, then a centre crop
    clamped to the ratio bounds (the crop inside timm's ``create_transform``)."""
    from PIL import Image

    width, height = img.size
    area = height * width
    log_ratio = (math.log(ratio[0]), math.log(ratio[1]))
    for _ in range(10):
        target_area = area * rng.uniform(scale[0], scale[1])
        aspect = math.exp(rng.uniform(*log_ratio))
        w = int(round(math.sqrt(target_area * aspect)))
        h = int(round(math.sqrt(target_area / aspect)))
        if 0 < w <= width and 0 < h <= height:
            i = int(rng.integers(0, height - h + 1))
            j = int(rng.integers(0, width - w + 1))
            return img.resize((out_size, out_size), Image.BICUBIC, box=(j, i, j + w, i + h))
    in_ratio = width / height
    if in_ratio < ratio[0]:
        w, h = width, int(round(width / ratio[0]))
    elif in_ratio > ratio[1]:
        h, w = height, int(round(height * ratio[1]))
    else:
        w, h = width, height
    i = (height - h) // 2
    j = (width - w) // 2
    return img.resize((out_size, out_size), Image.BICUBIC, box=(j, i, j + w, i + h))


def center_crop_resize(img, out_size: int, crop_pct: float):
    """Resize the shorter side to ``int(out_size / crop_pct)`` (bicubic),
    then centre-crop ``out_size``."""
    from PIL import Image

    size = int(out_size / crop_pct)
    w, h = img.size
    if w <= h:
        nw, nh = size, max(1, int(round(h * size / w)))
    else:
        nh, nw = size, max(1, int(round(w * size / h)))
    img = img.resize((nw, nh), Image.BICUBIC)
    left, top = (nw - out_size) // 2, (nh - out_size) // 2
    return img.crop((left, top, left + out_size, top + out_size))


# ---------------------------------------------------------------------------
# RandAugment: torchvision-style (14 ops) and timm rand-m9-mstd0.5-inc1
# ---------------------------------------------------------------------------


@functools.lru_cache(maxsize=None)
def _ra_ops() -> Dict[str, tuple]:
    """name -> (fn(img, v), max magnitude, signed), the torchvision table."""
    from PIL import Image, ImageEnhance, ImageOps

    def affine(img, coeffs):
        return img.transform(img.size, Image.AFFINE, coeffs, Image.BICUBIC)

    return {
        "Identity": (lambda img, v: img, 0.0, False),
        "AutoContrast": (lambda img, v: ImageOps.autocontrast(img), 0.0, False),
        "Equalize": (lambda img, v: ImageOps.equalize(img), 0.0, False),
        "Rotate": (lambda img, v: img.rotate(v, Image.BICUBIC), 30.0, True),
        "Posterize": (lambda img, v: ImageOps.posterize(img, max(1, int(v))), 4.0, False),
        "Solarize": (lambda img, v: ImageOps.solarize(img, int(v)), 255.0, False),
        "Color": (lambda img, v: ImageEnhance.Color(img).enhance(1.0 + v), 0.9, True),
        "Contrast": (lambda img, v: ImageEnhance.Contrast(img).enhance(1.0 + v), 0.9, True),
        "Brightness": (lambda img, v: ImageEnhance.Brightness(img).enhance(1.0 + v), 0.9, True),
        "Sharpness": (lambda img, v: ImageEnhance.Sharpness(img).enhance(1.0 + v), 0.9, True),
        "ShearX": (lambda img, v: affine(img, (1, v, 0, 0, 1, 0)), 0.3, True),
        "ShearY": (lambda img, v: affine(img, (1, 0, 0, v, 1, 0)), 0.3, True),
        "TranslateX": (lambda img, v: affine(img, (1, 0, v * img.size[0], 0, 1, 0)), 0.45, True),
        "TranslateY": (lambda img, v: affine(img, (1, 0, 0, 0, 1, v * img.size[1])), 0.45, True),
    }


def rand_augment(img, rng: np.random.Generator, num_ops: int = 2, magnitude: int = 9,
                 mstd: float = 0.0, num_bins: int = 31):
    """RandAugment: ``num_ops`` ops drawn from the torchvision table at a
    shared magnitude (jittered by ``mstd``), normalised over ``num_bins``."""
    ops = _ra_ops()
    names = list(ops)
    for _ in range(num_ops):
        name = names[int(rng.integers(0, len(names)))]
        fn, maxv, signed = ops[name]
        m = float(magnitude)
        if mstd > 0:
            m = float(np.clip(rng.normal(m, mstd), 0, num_bins - 1))
        frac = m / (num_bins - 1)
        if name == "Posterize":
            v = 8 - frac * maxv  # bits kept: 8 -> 4
        elif name == "Solarize":
            v = 255 - frac * 255.0  # threshold: 255 -> 0
        else:
            v = frac * maxv
        if signed and rng.random() < 0.5:
            v = -v
        img = fn(img, v)
    return img


def _timm_enhance_factor(m: float, rng) -> float:
    v = (m / 10.0) * 0.9
    return 1.0 + (-v if rng.random() < 0.5 else v)


def _timm_ops(fill):
    """name -> fn(img, m, rng): timm's 15 ``_RAND_INCREASING_TRANSFORMS``
    (level formulas at _MAX_LEVEL 10), the geometric ops filling with
    ``fill``."""
    from PIL import Image, ImageEnhance, ImageOps

    def signed(v, rng):
        return -v if rng.random() < 0.5 else v

    def solarize_add(img, add, thresh=128):
        lut = [min(255, i + add) if i < thresh else i for i in range(256)]
        if img.mode == "RGB":
            lut = lut + lut + lut
        return img.point(lut)

    def affine(img, coeffs):
        return img.transform(img.size, Image.AFFINE, coeffs, Image.BICUBIC, fillcolor=f)

    def enhance(cls):
        return lambda img, m, rng: cls(img).enhance(_timm_enhance_factor(m, rng))

    f = fill if len(fill) > 1 else fill[0]
    return {
        "AutoContrast": lambda img, m, rng: ImageOps.autocontrast(img),
        "Equalize": lambda img, m, rng: ImageOps.equalize(img),
        "Invert": lambda img, m, rng: ImageOps.invert(img),
        "Rotate": lambda img, m, rng: img.rotate(
            signed((m / 10.0) * 30.0, rng), Image.BICUBIC, fillcolor=f),
        "PosterizeIncreasing": lambda img, m, rng: ImageOps.posterize(
            img, 4 - int((m / 10.0) * 4)),
        "SolarizeIncreasing": lambda img, m, rng: ImageOps.solarize(
            img, 256 - int((m / 10.0) * 256)),
        "SolarizeAdd": lambda img, m, rng: solarize_add(img, int((m / 10.0) * 110)),
        "ColorIncreasing": enhance(ImageEnhance.Color),
        "ContrastIncreasing": enhance(ImageEnhance.Contrast),
        "BrightnessIncreasing": enhance(ImageEnhance.Brightness),
        "SharpnessIncreasing": enhance(ImageEnhance.Sharpness),
        "ShearX": lambda img, m, rng: affine(img, (1, signed((m / 10.0) * 0.3, rng), 0, 0, 1, 0)),
        "ShearY": lambda img, m, rng: affine(img, (1, 0, 0, signed((m / 10.0) * 0.3, rng), 1, 0)),
        "TranslateXRel": lambda img, m, rng: affine(
            img, (1, 0, signed((m / 10.0) * 0.45, rng) * img.size[0], 0, 1, 0)),
        "TranslateYRel": lambda img, m, rng: affine(
            img, (1, 0, 0, 0, 1, signed((m / 10.0) * 0.45, rng) * img.size[1])),
    }


def timm_rand_augment(img, rng: np.random.Generator, num_layers: int = 2,
                      magnitude: float = 9.0, mstd: float = 0.5, prob: float = 0.5,
                      fill: Tuple[int, ...] = (124, 116, 104)):
    """timm ``rand-m9-mstd0.5-inc1``: ``num_layers`` ops drawn with
    replacement, each applied with probability ``prob`` at a magnitude
    jittered by ``mstd`` and clamped to [0, 10]."""
    ops = _timm_ops(tuple(int(c) for c in fill))
    names = list(ops)
    for _ in range(num_layers):
        name = names[int(rng.integers(0, len(names)))]
        if prob < 1.0 and rng.random() > prob:
            continue
        m = float(magnitude)
        if mstd > 0:
            m = float(np.clip(rng.normal(m, mstd), 0.0, 10.0))
        img = ops[name](img, m, rng)
    return img


def random_erasing(x: np.ndarray, rng: np.random.Generator, prob: float, mode: str = "pixel",
                   count: int = 1, scale: Tuple[float, float] = (0.02, 1 / 3),
                   ratio: Tuple[float, float] = (0.3, 3.3)) -> np.ndarray:
    """timm's RandomErasing on a normalised float HWC array, in place
    (``pixel`` fills with N(0, 1) noise, any other mode with 0)."""
    if prob <= 0 or rng.random() > prob:
        return x
    h, w, c = x.shape
    area = h * w
    for _ in range(max(1, count)):
        for _attempt in range(10):
            target = area * rng.uniform(*scale)
            aspect = math.exp(rng.uniform(math.log(ratio[0]), math.log(ratio[1])))
            eh = int(round(math.sqrt(target * aspect)))
            ew = int(round(math.sqrt(target / aspect)))
            if eh < h and ew < w:
                top = int(rng.integers(0, h - eh + 1))
                left = int(rng.integers(0, w - ew + 1))
                if mode == "pixel":
                    x[top:top + eh, left:left + ew] = rng.normal(size=(eh, ew, c)).astype(x.dtype)
                else:
                    x[top:top + eh, left:left + ew] = 0.0
                break
    return x


# ---------------------------------------------------------------------------
# transforms
# ---------------------------------------------------------------------------


def _to_pil(x: np.ndarray):
    from PIL import Image

    if x.dtype != np.uint8:
        x = np.clip(x * 255.0 if x.max() <= 1.0 else x, 0, 255).astype(np.uint8)
    if x.ndim == 3 and x.shape[2] == 1:
        return Image.fromarray(x[:, :, 0])
    return Image.fromarray(x)


def _from_pil(img, num_channels: int) -> np.ndarray:
    x = np.asarray(img, dtype=np.float32) / 255.0
    if x.ndim == 2:
        x = x[:, :, None]
    if x.shape[2] != num_channels:
        if num_channels == 1:
            x = x.mean(axis=2, keepdims=True)
        else:
            x = np.repeat(x[:, :, :1], num_channels, axis=2)
    return x


def _to_unit(x, rng=None) -> np.ndarray:
    """The mnist family's ToTensor: uint8 / 255, float as it is."""
    return x.astype(np.float32) / 255.0 if x.dtype == np.uint8 else x.astype(np.float32)


def make_eval_transform(data_cfg: DataConfig) -> Callable:
    """``fn(HWC array, rng=None) -> float32 HWC``: the eval transform,
    per image through PIL (the device's batched copy is
    ``data/augment.make_eval_transform``)."""
    if data_cfg.dataset in MNIST_FAMILY:
        return _to_unit
    size = data_cfg.input_size
    mean, std = norm_stats(data_cfg.dataset, data_cfg.num_channels)
    mean_a, std_a = np.asarray(mean, np.float32), np.asarray(std, np.float32)
    crop_pct = 0.875 if size <= 224 else 1.0

    def transform(x, rng=None):
        img = center_crop_resize(_to_pil(x), size, crop_pct)
        return (_from_pil(img, data_cfg.num_channels) - mean_a) / std_a

    return transform


def make_train_transform(data_cfg: DataConfig) -> Callable:
    """``fn(HWC array, rng) -> float32 HWC``, the per-image train transform:
    ToTensor for the mnist family; the eval transform where nothing is
    random; else pass 1 (TF-style crop, torchvision RandAugment, flip, from
    the config) and pass 2 (timm's own defaults: torchvision crop, flip 0.5,
    rand-m9-mstd0.5-inc1), then normalise and erase."""
    aug = data_cfg.augment
    size = data_cfg.input_size
    if data_cfg.dataset in MNIST_FAMILY:
        return _to_unit
    if is_static_transform(data_cfg):
        return make_eval_transform(data_cfg)
    mean, std = norm_stats(data_cfg.dataset, data_cfg.num_channels)
    mean_a, std_a = np.asarray(mean, np.float32), np.asarray(std, np.float32)
    # timm fills the geometric ops' borders with the dataset's mean colour
    timm_fill = tuple(min(255, round(255 * float(m))) for m in mean)

    def transform(x, rng):
        from PIL import Image

        img = tf_random_resized_crop(_to_pil(x), rng, size, tuple(aug.resize_scale),
                                     tuple(aug.resize_ratio))
        if aug.randaug_n > 0:
            img = rand_augment(img, rng, num_ops=aug.randaug_n, magnitude=aug.randaug_m)
        if aug.horizontal_flip > 0 and rng.random() < aug.horizontal_flip:
            img = img.transpose(Image.FLIP_LEFT_RIGHT)
        img = torch_random_resized_crop(img, rng, size)
        if rng.random() < 0.5:
            img = img.transpose(Image.FLIP_LEFT_RIGHT)
        if aug.autoaugment:
            img = timm_rand_augment(img, rng, fill=timm_fill)
        arr = (_from_pil(img, data_cfg.num_channels) - mean_a) / std_a
        return random_erasing(arr, rng, aug.reprob, aug.remode, aug.recount)

    return transform


def augment_batch(transform: Callable, items: Sequence, rng: np.random.Generator) -> np.ndarray:
    """[len(items), S, S, C] float32: ``transform`` of each source element
    (an array, or a path decoded here) in order, from one generator."""
    return np.stack([transform(materialize(item), rng) for item in items])


# ---------------------------------------------------------------------------
# worker processes (data/pipeline.py's pool)
# ---------------------------------------------------------------------------

_WORKER: Dict[str, Callable] = {}


def worker_init(data_cfg: DataConfig) -> None:
    """A pool worker's initializer: its train transform."""
    _WORKER["transform"] = make_train_transform(data_cfg)


def worker_run(args) -> np.ndarray:
    """One batch: (source elements, seed entropy) -> augmented images, from
    ``np.random.default_rng(SeedSequence(entropy))``."""
    items, entropy = args
    rng = np.random.default_rng(np.random.SeedSequence(entropy))
    return augment_batch(_WORKER["transform"], items, rng)
