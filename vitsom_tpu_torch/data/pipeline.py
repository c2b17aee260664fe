"""The classification split, resident on one device, with augmentation on
the device or a static train transform.

Counterpart of the classification branch of ``vitsom_tpu/data/pipeline.py``
(``build_datamodule``), of its device-augment path
(``DataModule.use_device_augment``) and of its static path
(``DataModule.is_static``, ``device_arrays``):

- the dataset's train split is divided 80/20 (90/10 for tiny-imagenet)
  into train and val by a ``np.random.default_rng(0)`` permutation
  (``classification_split``); test is the dataset's own test split;
- the train rows stay raw uint8 on the device. At each epoch start
  (``fill_epoch``), outside the captured train step, the epoch's shuffled
  drop-last batches are augmented into a fixed float32 buffer and their
  labels gathered into a fixed int64 buffer, from which the step reads its
  batch with a device index (``epoch_batch``). Every random parameter of
  the epoch is drawn at once (``DeviceTrainAugment.sample``); then each
  batch is gathered and augmented by the deterministic half
  (``DeviceTrainAugment.apply``), which on the card is captured once as a
  CUDA graph reading its batch index, permutation and parameters from
  fixed device buffers and replayed batch after batch. The JAX package
  augments inside its epoch scan; the per-image distribution is the same;
- where the train transform draws nothing (``augment.is_static_transform``:
  no crop, RandAugment, flip or erasing configured, e.g.
  ``desom_flowers17.yaml``), the JAX package's train transform is its eval
  transform. The train rows are then eval-transformed on the device once,
  at construction, and stay resident as float32; each epoch fill is one
  gather of the shuffled rows into the epoch buffer, as the clustering
  module's, and no augmentation graph is built;
- val and test are eval-transformed on the device once, when first asked
  for, and cached there (``eval_arrays``) until ``release``;
- a source of variable-size images (an object array from a jpg dir:
  flowers-17/102, tiny-imagenet's paths) stays on the host, and each image
  is moved to the device and eval-transformed one at a time into one
  fixed-size tensor (``transform_objects``); only the static path takes
  it (``desom_flowers17.yaml``).

The host augmentation path (``data.device_augment: false``, or a source of
variable-size images, with a random train transform) is not ported (the
head of ROADMAP Queue 1 item 4).
"""

from __future__ import annotations

from typing import Dict, Iterator, Optional, Tuple, Union

import numpy as np
import torch

from vitsom_tpu_torch.config import Config
from vitsom_tpu_torch.data import augment as aug_lib
from vitsom_tpu_torch.data.datasets import load_image, load_raw
from vitsom_tpu_torch.data.device_augment import make_device_train_augment
from vitsom_tpu_torch.utils.device import resolve_device

# images eval-transformed in one call: at most EVAL_TRANSFORM_CHUNK, and at
# most EVAL_TRANSFORM_BYTES of float64 source pixels (PIL's resample runs in
# float64: about four such tensors are live at once)
EVAL_TRANSFORM_CHUNK = 2048
EVAL_TRANSFORM_BYTES = 1 << 30

# an image split: a uint8 tensor on the device, or an object array of
# variable-size images or paths on the host
Images = Union[torch.Tensor, np.ndarray]


def classification_split(n: int, dataset: str) -> Tuple[np.ndarray, np.ndarray]:
    """(train indices, val indices) into the dataset's train split."""
    val_frac = 0.1 if dataset == "tiny-imagenet" else 0.2
    perm = np.random.default_rng(0).permutation(n)
    n_val = int(round(val_frac * len(perm)))
    return perm[n_val:], perm[:n_val]


def eval_transform_chunks(transform, x: torch.Tensor) -> torch.Tensor:
    """``transform`` of uint8 images [N, H, W, C], in chunks of at most
    ``EVAL_TRANSFORM_CHUNK`` images and ``EVAL_TRANSFORM_BYTES`` of float64
    source pixels."""
    per_image = 8 * int(np.prod(x.shape[1:]))
    chunk = max(1, min(EVAL_TRANSFORM_CHUNK, EVAL_TRANSFORM_BYTES // per_image))
    return torch.cat([transform(part) for part in x.split(chunk)])


def transform_objects(transform, x: np.ndarray, device: torch.device) -> torch.Tensor:
    """``transform`` of an object array of variable-size HWC uint8 images
    (or paths, decoded by ``datasets.load_image``), one image at a time on
    ``device``, into one [N, S, S, C] tensor."""
    def image(item):
        img = load_image(item) if isinstance(item, str) else item
        return torch.tensor(np.asarray(img), device=device)[None]

    return torch.cat([transform(image(item)) for item in x])


class ClassificationDataModule:
    """Train (raw uint8, or eval-transformed float32 on the static path),
    val and test (uint8, eval-transformed on demand) splits on one device;
    labels int64 class indices on the device. An image split may instead
    be an object array of variable-size images or paths, on the host
    (module docstring)."""

    def __init__(self, cfg: Config, train: Tuple[Images, torch.Tensor],
                 val: Tuple[Images, torch.Tensor], test: Tuple[Images, torch.Tensor]):
        self.static = aug_lib.is_static_transform(cfg.data)
        objects = isinstance(train[0], np.ndarray)
        if not self.static and (objects or not cfg.data.device_augment):
            raise NotImplementedError(
                "the host augmentation path (a random train transform with "
                "data.device_augment: false or a source of variable-size images, e.g. "
                "a jpg dir) is not ported yet (the head of ROADMAP Queue 1 item 4)"
            )
        self.cfg = cfg
        self.train_x, self.train_y = train
        self.raw = {"val": val, "test": test}
        self.eval_transform = aug_lib.make_eval_transform(cfg.data)
        # the static path's resident transformed train rows; the augmented
        # path's device augmentation
        self.train_images: Optional[torch.Tensor] = None
        self.augment = None
        if self.static:
            self.train_images = self._transform(self.train_x)
        else:
            self.augment = make_device_train_augment(cfg.data)
        self._cache: Dict[str, Tuple[torch.Tensor, torch.Tensor]] = {}
        # the epoch's permutation and draws, and the batch index, at fixed
        # addresses: what the captured augmentation reads
        self._perm: Optional[torch.Tensor] = None
        self._params: Dict[str, torch.Tensor] = {}
        self._index = torch.zeros((), dtype=torch.int64, device=self.device)
        self._batch_out: Optional[torch.Tensor] = None
        self._graph: Optional[torch.cuda.CUDAGraph] = None

    @property
    def device(self) -> torch.device:
        return self.train_y.device

    @property
    def n_train(self) -> int:
        return self.train_y.shape[0]

    def _transform(self, x: Images) -> torch.Tensor:
        """The eval transform of a whole split, on the device."""
        if isinstance(x, np.ndarray):
            return transform_objects(self.eval_transform, x, self.device)
        return eval_transform_chunks(self.eval_transform, x)

    @property
    def steps_per_epoch(self) -> int:
        return self.n_train // self.cfg.batch_size

    def epoch_buffer(self) -> Dict[str, torch.Tensor]:
        """Uninitialised [steps_per_epoch * B, S, S, C] float32 images and
        [steps_per_epoch * B] int64 labels on the data's device."""
        rows = self.steps_per_epoch * self.cfg.batch_size
        s, c = self.cfg.data.input_size, self.cfg.data.num_channels
        return {"image": torch.empty((rows, s, s, c), dtype=torch.float32, device=self.device),
                "label": torch.empty((rows,), dtype=torch.int64, device=self.device)}

    def fill_epoch(self, generator: torch.Generator, out: Dict[str, torch.Tensor],
                   augment: torch.Generator) -> None:
        """One epoch's shuffled drop-last batches into ``out`` (from
        ``epoch_buffer``): the permutation drawn on the CPU from
        ``generator``, the augmentation's parameters on the device from
        ``augment`` (a generator on the data's device), then each batch
        gathered and augmented (module docstring). On the static path the
        transformed rows are gathered in one ``index_select`` and
        ``augment`` is not read."""
        bs = self.cfg.batch_size
        rows = out["label"].shape[0]
        perm = torch.randperm(self.n_train, generator=generator).to(self.device)[:rows]
        torch.index_select(self.train_y, 0, perm, out=out["label"])
        if self.static:
            torch.index_select(self.train_images, 0, perm, out=out["image"])
            return
        _, h, w, _ = self.train_x.shape
        params = self.augment.sample(augment, rows, h, w, self.device)
        if self._perm is None or self._perm.shape[0] != rows:
            self._perm = torch.empty_like(perm)
            self._params = {k: torch.empty_like(v) for k, v in params.items()}
            self._graph = None
        self._perm.copy_(perm)
        for k, v in params.items():
            self._params[k].copy_(v)
        graphed = self.device.type == "cuda"
        if graphed and self._graph is None:
            self._capture_augment()
        for s in range(rows // bs):
            self._index.fill_(s)
            if graphed:
                self._graph.replay()
            else:
                self._augment_batch()
            out["image"][s * bs:(s + 1) * bs].copy_(self._batch_out)

    def _augment_batch(self) -> None:
        """Batch ``self._index`` of the epoch, gathered and augmented at its
        drawn parameters into ``self._batch_out``; reads only device
        buffers, so a graph replays it for whatever batch the index holds."""
        bs = self.cfg.batch_size
        i = self._index.reshape(1)
        idx = self._perm.view(-1, bs).index_select(0, i)[0]
        params = {k: v.view(-1, bs, *v.shape[1:]).index_select(0, i)[0]
                  for k, v in self._params.items()}
        y = self.augment.apply(self.train_x.index_select(0, idx), params)
        if self._batch_out is None:
            self._batch_out = torch.empty_like(y)
        self._batch_out.copy_(y)

    def _capture_augment(self) -> None:
        """One eager batch on a side stream (cuBLAS workspaces, the
        constants' copies, the output buffer), then the capture."""
        side = torch.cuda.Stream(self.device)
        side.wait_stream(torch.cuda.current_stream(self.device))
        with torch.cuda.stream(side):
            self._augment_batch()
        torch.cuda.current_stream(self.device).wait_stream(side)
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            self._augment_batch()
        self._graph = graph

    def augment_batch_eagerly(self, index: int) -> torch.Tensor:
        """Batch ``index`` of the last ``fill_epoch``, augmented again by
        eager calls of the same ops at the same draws: what the captured
        augmentation is held against."""
        bs = self.cfg.batch_size
        rows = slice(index * bs, (index + 1) * bs)
        return self.augment.apply(self.train_x[self._perm[rows]],
                                  {k: v[rows] for k, v in self._params.items()})

    def epoch_batch(self, buffer: Dict[str, torch.Tensor],
                    index: torch.Tensor) -> Dict[str, torch.Tensor]:
        """Batch ``index`` (a 0-d int64 tensor on the device) of a filled
        epoch buffer, read with a device index, as the clustering module's."""
        bs = self.cfg.batch_size
        i = index.reshape(1)
        images = buffer["image"].view(-1, bs, *buffer["image"].shape[1:])
        return {"image": images.index_select(0, i)[0],
                "label": buffer["label"].view(-1, bs).index_select(0, i)[0]}

    def eval_arrays(self, split: str) -> Tuple[torch.Tensor, torch.Tensor]:
        """(eval-transformed float32 images, labels) of ``val`` or ``test``,
        transformed on the device the first time and cached."""
        if split not in self._cache:
            x, y = self.raw[split]
            self._cache[split] = (self._transform(x), y)
        return self._cache[split]

    def release(self, split: str) -> None:
        """Drop the cached transformed ``split``."""
        self._cache.pop(split, None)

    def eval_batches(self, split: str, drop_last: bool = True) -> Iterator[Dict[str, torch.Tensor]]:
        images, labels = self.eval_arrays(split)
        bs = self.cfg.batch_size
        stop = (len(labels) // bs) * bs if drop_last else len(labels)
        for s in range(0, stop, bs):
            yield {"image": images[s:s + bs], "label": labels[s:s + bs]}

    def split_len(self, split: str) -> int:
        return self.raw[split][1].shape[0]


def build_classification_datamodule(cfg: Config, device="cuda") -> ClassificationDataModule:
    """Read the dataset's files (``datasets.load_raw``, or the synthetic
    stand-in), split them (``classification_split``) and move the three
    splits to ``device`` (default: the card) as uint8; an object array of
    variable-size images stays on the host (module docstring)."""
    dev = resolve_device(device)
    raw = load_raw(cfg.data)
    train_idx, val_idx = classification_split(len(raw.train_y), cfg.data.dataset)

    def put(x: np.ndarray, y: np.ndarray, idx: Optional[np.ndarray] = None):
        if idx is not None:
            x, y = x[idx], y[idx]
        labels = torch.from_numpy(y.astype(np.int64)).to(dev)
        if x.dtype == object:
            return x, labels
        return torch.from_numpy(np.ascontiguousarray(x)).to(dev), labels

    return ClassificationDataModule(
        cfg, put(raw.train_x, raw.train_y, train_idx), put(raw.train_x, raw.train_y, val_idx),
        put(raw.test_x, raw.test_y),
    )
