"""The clustering data module.

``DataModule`` keeps the clustering split (train + test concatenated, as
the reference trains and evaluates clustering on it) on the device as
float32: uint8 images scaled to [0, 1] (the mnist family's ToTensor),
float images (usps, stored in [0, 1]) as they are, as the JAX eval
transform treats them. It draws each epoch's
shuffled drop-last batches from a ``torch.Generator``: one batch at a time
(``train_batches``), or all of an epoch's at once into a fixed buffer
(``fill_epoch``), the counterpart of the JAX trainer's one bulk gather an
epoch (``vitsom_tpu/train/trainer.py:464-469``), from which a captured
train step reads its batch with a device index (``epoch_batch``).
``build_datamodule`` reads the dataset's files (``datasets.load_raw``)
and returns this module for clustering configs and the classification
module of ``data/pipeline.py`` (train/val/test split, augmentation on the
device) for ``num_classes > 0``.

``make_synthetic``, ``_NATIVE_HW`` and ``load_raw`` live in
``data/datasets.py`` and are importable from here as well.
"""

from __future__ import annotations

from typing import Dict, Iterator, Optional

import numpy as np
import torch

from vitsom_tpu_torch.config import Config
from vitsom_tpu_torch.data.augment import to_unit_range
from vitsom_tpu_torch.data.datasets import _NATIVE_HW, load_raw, make_synthetic  # noqa: F401
from vitsom_tpu_torch.utils.device import resolve_device

# the datasets whose transform (ToTensor) is ported for clustering
MNIST_FAMILY = ("mnist", "fmnist", "usps", "synthetic")


class DataModule:
    """Clustering data resident on one device.

    ``images`` [N, H, W, C] float32 (``augment.to_unit_range``) and ``labels`` [N]
    int64 hold concat(train, test)."""

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
    concatenated and scaled as the mnist family is, with no
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
    return DataModule(cfg, to_unit_range(torch.from_numpy(x).to(dev)), torch.from_numpy(y).to(dev))


def build_datamodule(cfg: Config, device="cuda"):
    """Read the dataset's files (``datasets.load_raw``: the synthetic
    stand-in where they are missing and ``data.allow_synthetic`` is set,
    or for ``dataset: synthetic``) and move it to ``device`` (default:
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
    return DataModule(cfg, to_unit_range(torch.from_numpy(x).to(dev)), torch.from_numpy(y).to(dev))
