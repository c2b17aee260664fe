"""The clustering data modules.

``DataModule`` keeps the clustering split (train + test concatenated, as
the reference trains and evaluates clustering on it) of the mnist family
on the device as float32: uint8 images scaled to [0, 1] (the mnist
family's ToTensor), float images (usps, stored in [0, 1]) as they are, as
the JAX eval transform treats them. It draws each epoch's
shuffled drop-last batches from a ``torch.Generator``: one batch at a time
(``train_batches``), or all of an epoch's at once into a fixed buffer
(``fill_epoch``), the counterpart of the JAX trainer's one bulk gather an
epoch (``vitsom_tpu/train/trainer.py:464-469``), from which a captured
train step reads its batch with a device index (``epoch_batch``). Under
data parallelism (``parallel/mesh.DataSpan``) each rank's buffer holds
its rows of every global batch of the same permutation.
``build_datamodule`` reads the dataset's files (``datasets.load_raw``)
and returns this module for clustering on the mnist family, the
clustering module of ``data/pipeline.py`` (``ClusteringDataModule``: the
dataset's train transform, augmented on the device or on the host) for
clustering on any other dataset, and the classification module there
(train/val/test split) for ``num_classes > 0``.

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
from vitsom_tpu_torch.parallel.mesh import DataSpan
from vitsom_tpu_torch.utils.device import resolve_device

# the datasets whose clustering split is ``DataModule`` (ToTensor)
MNIST_FAMILY = ("mnist", "fmnist", "usps", "synthetic")


class DataModule(DataSpan):
    """Clustering data resident on one device.

    ``images`` [N, H, W, C] float32 (``augment.to_unit_range``) and ``labels`` [N]
    int64 hold concat(train, test)."""

    # the whole epoch is gathered at its fill, on the device
    streams = False
    host = False

    def __init__(self, cfg: Config, images: torch.Tensor, labels: torch.Tensor):
        self.cfg = cfg
        self.images = images
        self.labels = labels

    def close(self) -> None:
        """Nothing to release: no worker pool, no stream."""

    @property
    def n_train(self) -> int:
        return self.images.shape[0]

    @property
    def steps_per_epoch(self) -> int:
        return self.n_train // self.cfg.batch_size

    def train_batches(self, generator: torch.Generator) -> Iterator[Dict[str, torch.Tensor]]:
        """One epoch of shuffled drop-last batches (this rank's rows of
        each); the permutation is drawn on the CPU from ``generator`` and
        the gathers run on the device."""
        bs = self.cfg.batch_size
        perm = torch.randperm(self.n_train, generator=generator).to(self.images.device)
        perm = self.epoch_rows(perm[: self.steps_per_epoch * bs])
        for s in range(self.steps_per_epoch):
            idx = perm[s * self.batch : (s + 1) * self.batch]
            yield {"image": self.images[idx], "label": self.labels[idx]}

    def epoch_buffer(self) -> torch.Tensor:
        """An uninitialised [steps_per_epoch * batch, H, W, C] buffer on the
        data's device, for ``fill_epoch``."""
        rows = self.steps_per_epoch * self.batch
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
        perm = self.epoch_rows(perm[: self.steps_per_epoch * self.cfg.batch_size])
        torch.index_select(self.images, 0, perm, out=out)

    def epoch_batch(self, buffer: torch.Tensor, index: torch.Tensor) -> Dict[str, torch.Tensor]:
        """Batch ``index`` (a 0-d int64 tensor on the device) of a filled
        epoch buffer, read with a device index: no host value, so a CUDA
        graph replays it for whatever batch ``index`` holds."""
        batches = buffer.view(buffer.shape[0] // self.batch, self.batch, *buffer.shape[1:])
        return {"image": batches.index_select(0, index.reshape(1))[0]}

    def split_len(self, split: str = "train") -> int:
        return self.n_train

    def eval_batches(self, split: str = "train",
                     drop_last: bool = True) -> Iterator[Dict[str, torch.Tensor]]:
        """The clustering split (its one split, ``train``) in order."""
        bs = self.cfg.batch_size
        n = self.n_train
        stop = (n // bs) * bs if drop_last else n
        for s in range(0, stop, bs):
            yield {"image": self.images[s : s + bs], "label": self.labels[s : s + bs]}

    def span_eval_batches(self, split: str = "train") -> Iterator[Dict[str, torch.Tensor]]:
        """This rank's span of the split (``eval_span``) in batches of
        ``batch_size``, the last one ragged: the sharded evaluation's."""
        span = self.eval_span(self.n_train)
        images, labels = self.images[span], self.labels[span]
        for s in range(0, len(labels), self.cfg.batch_size):
            yield {"image": images[s : s + self.cfg.batch_size],
                   "label": labels[s : s + self.cfg.batch_size]}


def raw_synthetic_datamodule(cfg: Config, device="cuda") -> DataModule:
    """The config's synthetic stand-in (``make_synthetic``), train and test
    concatenated and scaled as the mnist family is, with no
    transform and no augmentation, for any dataset: the clustering of the
    other datasets without their train transform, which
    ``build_datamodule`` applies (``pipeline.ClusteringDataModule``)."""
    dev = resolve_device(device)
    raw = make_synthetic(cfg.data)
    x = np.concatenate([raw.train_x, raw.test_x])
    y = np.concatenate([raw.train_y, raw.test_y])
    return DataModule(cfg, to_unit_range(torch.from_numpy(x).to(dev)), torch.from_numpy(y).to(dev))


def build_datamodule(cfg: Config, device="cuda"):
    """Read the dataset's files (``datasets.load_raw``: the synthetic
    stand-in where they are missing and ``data.allow_synthetic`` is set,
    or for ``dataset: synthetic``) and move it to ``device`` (default:
    the card): the clustering split as a ``DataModule`` (the mnist family)
    or a ``pipeline.ClusteringDataModule`` (any other dataset), or for
    ``num_classes > 0`` the classification split as a
    ``pipeline.ClassificationDataModule``."""
    if cfg.classification:
        from vitsom_tpu_torch.data.pipeline import build_classification_datamodule

        return build_classification_datamodule(cfg, device)
    if cfg.data.dataset not in MNIST_FAMILY:
        from vitsom_tpu_torch.data.pipeline import build_clustering_datamodule

        return build_clustering_datamodule(cfg, device)
    dev = resolve_device(device)
    raw = load_raw(cfg.data)
    x = np.concatenate([raw.train_x, raw.test_x])
    y = np.concatenate([raw.train_y, raw.test_y])
    return DataModule(cfg, to_unit_range(torch.from_numpy(x).to(dev)), torch.from_numpy(y).to(dev))
