"""Synthetic stand-in data and the clustering data module.

``make_synthetic`` is the port's own copy of the part of
``vitsom_tpu/data/datasets.make_synthetic`` that the shipped configs use
(``synthetic_overlap == 0``: class templates + uniform noise, at each
dataset's stored resolution): the same seed (``zlib.crc32(dataset)``), the
same draws in the same order, the same uint8 arrays. The overlap
generators and reading the raw dataset files are later slices of the port.

``DataModule`` keeps the clustering split (train + test concatenated, as
the reference trains and evaluates clustering on it) on the device as
float32 in [0, 1] (the mnist family's transform), and draws each epoch's
shuffled drop-last batches from a ``torch.Generator``: one batch at a time
(``train_batches``), or all of an epoch's at once into a fixed buffer
(``fill_epoch``), the counterpart of the JAX trainer's one bulk gather an
epoch (``vitsom_tpu/train/trainer.py:464-469``), from which a captured
train step reads its batch with a device index (``epoch_batch``).
``build_datamodule`` returns it for clustering configs and the
classification module of ``data/pipeline.py`` (train/val/test split,
augmentation on the device) for ``num_classes > 0``.
"""

from __future__ import annotations

import zlib
from dataclasses import dataclass
from typing import Dict, Iterator, Optional

import numpy as np
import torch

from vitsom_tpu_torch.config import Config, DataConfig
from vitsom_tpu_torch.utils.device import resolve_device

# stored resolution of each dataset's source files; the synthetic stand-in
# is generated at this size, not at data.input_size
_NATIVE_HW = {
    "mnist": 28, "fmnist": 28, "usps": 16, "medmnist": 28,
    "cifar-10": 32, "cifar-100": 32, "svhn": 32, "tiny-imagenet": 64,
}


# the datasets whose transform (ToTensor: x / 255) is ported
MNIST_FAMILY = ("mnist", "fmnist", "usps", "synthetic")


@dataclass
class ArraySplits:
    """Raw arrays; images NHWC uint8."""

    train_x: np.ndarray
    train_y: np.ndarray
    test_x: np.ndarray
    test_y: np.ndarray


def make_synthetic(cfg: DataConfig, num_classes_hint: int = 10) -> ArraySplits:
    """Deterministic class-conditional blobs shaped like the real dataset:
    per-class templates in [0, 0.6*255] plus uniform noise in [0, 0.4*255]."""
    if cfg.synthetic_overlap > 0.0 or cfg.synthetic_object_array:
        raise NotImplementedError(
            "synthetic_overlap / synthetic_object_array generators are not ported yet"
        )
    k = max(cfg.num_classes, num_classes_hint)
    n_train = cfg.synthetic_size
    n_test = max(cfg.synthetic_size // 5, 64)
    rng = np.random.default_rng(zlib.crc32(cfg.dataset.encode()))
    h = w = _NATIVE_HW.get(cfg.dataset, cfg.input_size)
    c = cfg.num_channels

    # templates are drawn once and shared by both splits, so train and test
    # come from the same class-conditional distribution
    templates = rng.random(size=(k, h, w, c), dtype=np.float32)
    templates = templates * (0.6 * 255.0)

    def gen(n):
        y = rng.integers(0, k, size=n)
        noise = rng.random(size=(n, h, w, c), dtype=np.float32)
        noise *= 0.4 * 255.0
        x = templates[y]
        x += noise
        return x.astype(np.uint8), y.astype(np.int64)

    tx, ty = gen(n_train)
    vx, vy = gen(n_test)
    return ArraySplits(tx, ty, vx, vy)


def load_raw(cfg: DataConfig) -> ArraySplits:
    if cfg.dataset == "synthetic" or cfg.allow_synthetic:
        return make_synthetic(cfg)
    raise NotImplementedError(
        f"reading the {cfg.dataset} files is not ported yet; "
        "set data.allow_synthetic (--synthetic) for the synthetic stand-in"
    )


class DataModule:
    """Clustering data resident on one device.

    ``images`` [N, H, W, C] float32 in [0, 1] (the mnist-family ToTensor
    transform) and ``labels`` [N] int64 hold concat(train, test)."""

    def __init__(self, cfg: Config, images: torch.Tensor, labels: torch.Tensor):
        self.cfg = cfg
        self.images = images
        self.labels = labels

    @property
    def n_train(self) -> int:
        return self.images.shape[0]

    @property
    def steps_per_epoch(self) -> int:
        return self.n_train // self.cfg.batch_size

    def train_batches(self, generator: torch.Generator) -> Iterator[Dict[str, torch.Tensor]]:
        """One epoch of shuffled drop-last batches; the permutation is drawn
        on the CPU from ``generator`` and the gathers run on the device."""
        bs = self.cfg.batch_size
        perm = torch.randperm(self.n_train, generator=generator).to(self.images.device)
        for s in range(self.steps_per_epoch):
            idx = perm[s * bs : (s + 1) * bs]
            yield {"image": self.images[idx], "label": self.labels[idx]}

    def epoch_buffer(self) -> torch.Tensor:
        """An uninitialised [steps_per_epoch * B, H, W, C] buffer on the
        data's device, for ``fill_epoch``."""
        rows = self.steps_per_epoch * self.cfg.batch_size
        return torch.empty((rows, *self.images.shape[1:]), dtype=self.images.dtype,
                           device=self.images.device)

    def fill_epoch(self, generator: torch.Generator, out: torch.Tensor,
                   augment: Optional[torch.Generator] = None) -> None:
        """Gather one epoch's shuffled drop-last batches into ``out`` (from
        ``epoch_buffer``), batch after batch, with one ``index_select``.
        The permutation is the same draw from ``generator`` that
        ``train_batches`` makes, so ``out`` holds the batches it would
        yield, in its order. ``augment`` is not read: the clustering
        transform draws no random numbers."""
        perm = torch.randperm(self.n_train, generator=generator).to(self.images.device)
        torch.index_select(self.images, 0, perm[: out.shape[0]], out=out)

    def epoch_batch(self, buffer: torch.Tensor, index: torch.Tensor) -> Dict[str, torch.Tensor]:
        """Batch ``index`` (a 0-d int64 tensor on the device) of a filled
        epoch buffer, read with a device index: no host value, so a CUDA
        graph replays it for whatever batch ``index`` holds."""
        bs = self.cfg.batch_size
        batches = buffer.view(buffer.shape[0] // bs, bs, *buffer.shape[1:])
        return {"image": batches.index_select(0, index.reshape(1))[0]}

    def eval_batches(self, drop_last: bool = True) -> Iterator[Dict[str, torch.Tensor]]:
        bs = self.cfg.batch_size
        n = self.n_train
        stop = (n // bs) * bs if drop_last else n
        for s in range(0, stop, bs):
            yield {"image": self.images[s : s + bs], "label": self.labels[s : s + bs]}


def raw_synthetic_datamodule(cfg: Config, device="cuda") -> DataModule:
    """The config's synthetic stand-in (``make_synthetic``), train and test
    concatenated and scaled to [0, 1] as the mnist family is, with no
    transform and no augmentation, for any dataset. ``build_datamodule``
    takes clustering on the mnist family and classification on any
    dataset (``data/pipeline.py``); the clustering of the other datasets,
    whose JAX train transform augments, is not ported. This module lets
    their models run clustering at their real shapes for timing and smoke
    runs."""
    dev = resolve_device(device)
    raw = make_synthetic(cfg.data)
    x = np.concatenate([raw.train_x, raw.test_x])
    y = np.concatenate([raw.train_y, raw.test_y])
    return DataModule(cfg, torch.from_numpy(x).to(dev).float() / 255.0, torch.from_numpy(y).to(dev))


def build_datamodule(cfg: Config, device="cuda"):
    """Load (or synthesise) the dataset and move it to ``device`` (default:
    the card): the clustering split as a ``DataModule``, or for
    ``num_classes > 0`` the classification split as a
    ``pipeline.ClassificationDataModule``."""
    if cfg.classification:
        from vitsom_tpu_torch.data.pipeline import build_classification_datamodule

        return build_classification_datamodule(cfg, device)
    if cfg.data.dataset not in MNIST_FAMILY:
        raise NotImplementedError(
            f"clustering on {cfg.data.dataset} (an augmented train transform) is not "
            "ported yet (mnist family only)"
        )
    dev = resolve_device(device)
    raw = load_raw(cfg.data)
    x = np.concatenate([raw.train_x, raw.test_x])
    y = np.concatenate([raw.train_y, raw.test_y])
    images = torch.from_numpy(x).to(dev).float() / 255.0
    return DataModule(cfg, images, torch.from_numpy(y).to(dev))
