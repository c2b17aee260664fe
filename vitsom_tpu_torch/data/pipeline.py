"""The classification split, with augmentation on the device or on the
host, or a static train transform.

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
  augments inside its epoch scan; the per-image distribution is the same.
  The one draw that is not a few numbers an image, random erasing's
  full-size noise (24 GB for a cifar-10 epoch at 224), is drawn at the
  fill as one seed a batch and expanded into a fixed one-batch buffer
  just before that batch is augmented (``_draw_fills``).
  Where the epoch's float32 buffer would pass ``STREAM_BYTES`` (the 224x224
  configs on their full splits: 24 GB for cifar-10's 312 batches), the
  epoch streams: the permutation and every draw are still made at the
  fill, but the buffer holds one batch, and the captured augmentation of
  batch i replays into it just before step i (``stream_batch``). The
  batches are bitwise those of the whole-epoch fill;
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
  it (``desom_flowers17.yaml``) and the host path's val and test splits;
- the host path, taken exactly where the JAX package takes it: a random
  train transform with ``data.device_augment: false``, or a source that is
  not a fixed-size uint8 array (a jpg dir's object array, tiny-imagenet's
  paths; ``uses_host_path``). The train rows stay on the host, and each
  epoch's batches are the JAX package's ``train_batches``, bitwise: the
  permutation from ``SeedSequence([seed, epoch])``, drop-last batches,
  each image through the PIL train transform
  (``host_augment.make_train_transform``), from one generator
  ``SeedSequence([seed, epoch, 7])`` with at most one worker, else in a
  pool of ``min(num_workers, 2 * cpu_count)`` processes with batch s
  seeded ``SeedSequence([seed, epoch, s])``. The pool's processes start
  from a fork server (``multiprocessing``'s ``forkserver``: a fresh
  interpreter with no CUDA context and no threads of ours, from which each
  worker forks), never from a fork of this process, whose CUDA context
  and prefetch thread could leave a lock held in the child; they run numpy
  and PIL only and get each batch's source images with its task. A
  background thread copies each finished batch into pinned memory
  (``HostBatchStream``, the counterpart of ``device_prefetch``) and
  ``stream_batch`` copies it, without blocking, into the fixed one-batch
  buffers the captured train step reads. A worker's failure raises in the
  trainer; nothing falls back.
"""

from __future__ import annotations

import atexit
import collections
import itertools
import os
import queue
import sys
import threading
import time
from typing import Dict, Iterator, List, Optional, Tuple, Union

import numpy as np
import torch

from vitsom_tpu_torch.config import Config, DataConfig
from vitsom_tpu_torch.data import augment as aug_lib
from vitsom_tpu_torch.data import device_augment, host_augment
from vitsom_tpu_torch.data.datasets import load_image, load_raw
from vitsom_tpu_torch.utils.device import resolve_device

# images eval-transformed in one call: at most EVAL_TRANSFORM_CHUNK, and at
# most EVAL_TRANSFORM_BYTES of float64 source pixels (PIL's resample runs in
# float64: about four such tensors are live at once)
EVAL_TRANSFORM_CHUNK = 2048
EVAL_TRANSFORM_BYTES = 1 << 30
# the largest whole-epoch float32 buffer of the device augmentation; a
# larger epoch streams a batch at a time. Every 32x32 and 64x64 config
# stays below it on its full split (tiny-imagenet, B 512: 4.4 GB), and so
# does every 224x224 split of at most ~14000 train rows (flowers, the
# smoke's cut splits); cifar-10 and svhn at 224 (24 and 35 GB) stream,
# leaving the card's memory to the eval caches (svhn's test split
# transformed at 224 is 15.7 GB) and the model
STREAM_BYTES = 8 << 30
# host batches augmented or held ready ahead of the step that reads them
HOST_PREFETCH = 2

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


def uses_host_path(data_cfg: DataConfig, x: np.ndarray) -> bool:
    """The JAX package's rule (``DataModule.use_device_augment``): a random
    train transform augments on the host unless ``data.device_augment`` is
    on and the source is a fixed-size [N, H, W, C] uint8 array."""
    if aug_lib.is_static_transform(data_cfg):
        return False
    return not (data_cfg.device_augment and x.dtype == np.uint8 and x.ndim == 4)


def _ordered_map(pool, args: Iterator, ahead: int) -> Iterator:
    """``pool.map(worker_run, args)`` in order, with at most ``ahead``
    tasks submitted and unread (``Executor.map`` would submit them all at
    once, holding a whole epoch of augmented batches); the unstarted ones
    are cancelled when the consumer stops early."""
    pending = collections.deque(pool.submit(host_augment.worker_run, a)
                                for a in itertools.islice(args, ahead))
    try:
        while pending:
            result = pending.popleft().result()
            for a in itertools.islice(args, 1):
                pending.append(pool.submit(host_augment.worker_run, a))
            yield result
    finally:
        for fut in pending:
            fut.cancel()


class HostBatchStream:
    """A background thread that pulls host batches ({"image": float32
    [B, S, S, C], "label": int64 [B]} numpy arrays) from ``batches`` and
    copies each into a free slot of a ring of pinned tensors (plain tensors
    on the CPU); ``next_into`` hands the next one to device buffers with a
    non-blocking copy and frees a slot once the device has read it. Every
    CUDA call is made on the consumer's thread. An exception in the
    producer (a failed worker) is raised by ``next_into``."""

    _END = object()

    def __init__(self, batches: Iterator[Dict[str, np.ndarray]], batch: int, image_shape,
                 device: torch.device, depth: int = HOST_PREFETCH):
        self.cuda = device.type == "cuda"
        self.slots = [{"image": torch.empty((batch, *image_shape), dtype=torch.float32,
                                            pin_memory=self.cuda),
                       "label": torch.empty((batch,), dtype=torch.int64, pin_memory=self.cuda)}
                      for _ in range(depth + 1)]
        self.free: "queue.Queue" = queue.Queue()
        for i in range(len(self.slots)):
            self.free.put(i)
        self.ready: "queue.Queue" = queue.Queue()
        self.in_flight: collections.deque = collections.deque()  # (slot, event)
        self.batch_ms: List[float] = []  # host ms between batches leaving ``batches``
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._produce, args=(batches,), daemon=True)
        self._thread.start()

    def _produce(self, batches) -> None:
        try:
            t0 = time.perf_counter()
            for b in batches:
                now = time.perf_counter()
                self.batch_ms.append((now - t0) * 1e3)
                t0 = now
                i = self.free.get()
                if i is None or self._stop.is_set():
                    return
                self.slots[i]["image"].numpy()[...] = b["image"]
                self.slots[i]["label"].numpy()[...] = b["label"]
                self.ready.put(i)
        except Exception as e:  # raised again on the consumer's thread
            self.ready.put(e)
        finally:
            batches.close()
            self.ready.put(self._END)

    def next_into(self, out: Dict[str, torch.Tensor]) -> None:
        """Copy the next batch into ``out["image"]`` and ``out["label"]``."""
        while self.in_flight and (self.in_flight[0][1] is None or self.in_flight[0][1].query()):
            self.free.put(self.in_flight.popleft()[0])
        if len(self.in_flight) == len(self.slots):
            slot, ev = self.in_flight.popleft()
            ev.synchronize()
            self.free.put(slot)
        item = self.ready.get()
        if isinstance(item, BaseException):
            raise RuntimeError("the host augmentation failed") from item
        if item is self._END:
            raise RuntimeError("the host batch stream ended before the epoch")
        for key in ("image", "label"):
            out[key].copy_(self.slots[item][key], non_blocking=self.cuda)
        ev = None
        if self.cuda:
            ev = torch.cuda.Event()
            ev.record()
        self.in_flight.append((item, ev))

    def close(self) -> None:
        """Stop the producer after its current batch and wait for it."""
        self._stop.set()
        self.free.put(None)
        self._thread.join()


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
    be an object array of variable-size images or paths, or a train split a
    host array of the host path, on the host (module docstring)."""

    def __init__(self, cfg: Config, train: Tuple[Images, torch.Tensor],
                 val: Tuple[Images, torch.Tensor], test: Tuple[Images, torch.Tensor]):
        self.static = aug_lib.is_static_transform(cfg.data)
        # a random transform of rows held on the host: the host path
        self.host = not self.static and isinstance(train[0], np.ndarray)
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
        elif self.host:
            self.train_transform = host_augment.make_train_transform(cfg.data)
            self._host_labels = self.train_y.cpu().numpy()
            self._pool = None
            self._stream: Optional[HostBatchStream] = None
        else:
            self.augment = device_augment.make_device_train_augment(cfg.data)
        # the epoch reaches the step one batch at a time: from the host, or
        # from the device augmentation where a whole epoch would pass
        # STREAM_BYTES
        s, c = cfg.data.input_size, cfg.data.num_channels
        epoch_bytes = self.steps_per_epoch * cfg.batch_size * s * s * c * 4
        self.streams = self.host or (self.augment is not None and epoch_bytes > STREAM_BYTES)
        self._cache: Dict[str, Tuple[torch.Tensor, torch.Tensor]] = {}
        # the epoch's permutation and draws, and the batch index, at fixed
        # addresses: what the captured augmentation reads
        self._perm: Optional[torch.Tensor] = None
        self._params: Dict[str, torch.Tensor] = {}
        # the erasing fills' seeds (one a batch, drawn at the fill), their
        # generator and the one-batch fills the augmentation reads
        self._fill_seeds: List[int] = []
        self._noise = torch.Generator(device=self.device)
        self._fills: Dict[str, torch.Tensor] = {}
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
        [steps_per_epoch * B] int64 labels on the data's device; one batch
        of images where the epoch streams, and one batch of labels on the
        host path."""
        bs = self.cfg.batch_size
        rows = self.steps_per_epoch * bs
        s, c = self.cfg.data.input_size, self.cfg.data.num_channels
        return {"image": torch.empty((bs if self.streams else rows, s, s, c),
                                     dtype=torch.float32, device=self.device),
                "label": torch.empty((bs if self.host else rows,), dtype=torch.int64,
                                     device=self.device)}

    def fill_epoch(self, generator: torch.Generator, out: Dict[str, torch.Tensor],
                   augment: torch.Generator) -> None:
        """One epoch's shuffled drop-last batches into ``out`` (from
        ``epoch_buffer``): the permutation drawn on the CPU from
        ``generator``, the augmentation's parameters on the device from
        ``augment`` (a generator on the data's device), then each batch
        gathered and augmented (module docstring). On the static path the
        transformed rows are gathered in one ``index_select`` and
        ``augment`` is not read. A streamed epoch draws everything here and
        augments each batch in ``stream_batch``."""
        bs = self.cfg.batch_size
        rows = out["label"].shape[0]
        perm = torch.randperm(self.n_train, generator=generator).to(self.device)[:rows]
        torch.index_select(self.train_y, 0, perm, out=out["label"])
        if self.static:
            torch.index_select(self.train_images, 0, perm, out=out["image"])
            return
        _, h, w, _ = self.train_x.shape
        params = self.augment.sample(augment, rows, h, w, self.device, erase_fill=False)
        self._fill_seeds = torch.randint(0, 2**62, (rows // bs,), generator=augment,
                                         device=self.device).tolist()
        if self._perm is None or self._perm.shape[0] != rows:
            self._perm = torch.empty_like(perm)
            self._params = {k: torch.empty_like(v) for k, v in params.items()}
            self._graph = None
        self._perm.copy_(perm)
        for k, v in params.items():
            self._params[k].copy_(v)
        if self.device.type == "cuda" and self._graph is None:
            self._draw_fills(0)
            self._capture_augment()
        if not self.streams:
            for s in range(rows // bs):
                self._replay(s)
                out["image"][s * bs:(s + 1) * bs].copy_(self._batch_out)

    def _draw_fills(self, index: int, out: Optional[Dict[str, torch.Tensor]] = None
                    ) -> Dict[str, torch.Tensor]:
        """Batch ``index``'s erasing fills, from its seed, into ``out``
        (default: the fixed buffers the captured augmentation reads)."""
        out = self._fills if out is None else out
        s, c = self.cfg.data.input_size, self.cfg.data.num_channels
        shape = (self.cfg.batch_size, s, s, c)
        self._noise.manual_seed(self._fill_seeds[index])
        for key in self.augment.erase_keys():
            if key not in out:
                out[key] = torch.empty(shape, dtype=torch.float32, device=self.device)
            device_augment.erase_fill(self._noise, shape, self.cfg.data.augment.remode,
                                      self.device, out=out[key])
        return out

    def _replay(self, index: int) -> None:
        """Batch ``index`` of the filled epoch into ``self._batch_out``: its
        fills drawn, then a replay of the captured augmentation on the
        card."""
        self._draw_fills(index)
        self._index.fill_(index)
        if self._graph is not None:
            self._graph.replay()
        else:
            self._augment_batch()

    def stream_batch(self, index: int, out: Dict[str, torch.Tensor]) -> None:
        """Where the epoch streams: batch ``index`` into the one-batch
        ``out["image"]`` (and, on the host path, ``out["label"]``), just
        before the step that reads it. The device augmentation replays at
        the fill's draws; the host path takes the next batch of its
        stream, which must be batch ``index``."""
        if not self.host:
            self._replay(index)
            out["image"].copy_(self._batch_out)
            return
        if index != self._stream_next:
            raise RuntimeError(f"the host stream is at batch {self._stream_next}, not {index}")
        self._stream.next_into(out)
        self._stream_next += 1

    # -- the host path ---------------------------------------------------------

    def _workers(self) -> int:
        return min(self.cfg.data.num_workers, 2 * (os.cpu_count() or 1))

    def _get_pool(self):
        """The module's persistent worker pool (module docstring)."""
        if self._pool is None:
            import multiprocessing as mp
            from concurrent.futures import ProcessPoolExecutor

            # the fork server imports the main module once (a ``-m`` module
            # by name), so the workers forked from it do not each import it
            spec = getattr(sys.modules["__main__"], "__spec__", None)
            ctx = mp.get_context("forkserver")
            ctx.set_forkserver_preload(["__main__", host_augment.__name__]
                                       + ([spec.name] if spec is not None else []))
            self._pool = ProcessPoolExecutor(
                max_workers=self._workers(), mp_context=ctx,
                initializer=host_augment.worker_init, initargs=(self.cfg.data,))
            atexit.register(self._pool.shutdown, wait=False, cancel_futures=True)
        return self._pool

    def train_batches(self, epoch: int, seed: int = 0,
                      start: int = 0) -> Iterator[Dict[str, np.ndarray]]:
        """The host path's epoch ``epoch`` from batch ``start`` on: the JAX
        package's ``DataModule.train_batches`` (module docstring), as
        {"image": float32 [B, S, S, C], "label": int64 [B]} host arrays.
        With one generator the batches before ``start`` are augmented and
        dropped, as the generator's state needs them."""
        bs = self.cfg.batch_size
        perm = np.random.default_rng(np.random.SeedSequence([seed, epoch])).permutation(
            len(self._host_labels))
        idx_batches = [perm[i * bs:(i + 1) * bs] for i in range(len(perm) // bs)]
        if self._workers() <= 1:
            rng = np.random.default_rng(np.random.SeedSequence([seed, epoch, 7]))
            for s, idx in enumerate(idx_batches):
                images = host_augment.augment_batch(self.train_transform, self.train_x[idx], rng)
                if s >= start:
                    yield {"image": images, "label": self._host_labels[idx]}
            return
        args = ((self.train_x[idx], [seed, epoch, s])
                for s, idx in enumerate(idx_batches) if s >= start)
        images = _ordered_map(self._get_pool(), args, self._workers() + HOST_PREFETCH)
        try:
            for idx, batch in zip(idx_batches[start:], images):
                yield {"image": batch, "label": self._host_labels[idx]}
        finally:
            images.close()

    def start_host_epoch(self, epoch: int, seed: int, start: int = 0) -> None:
        """Begin streaming the host path's epoch ``epoch`` at batch ``start``
        (``train_batches``), ending any stream still open."""
        self.close_stream()
        s, c = self.cfg.data.input_size, self.cfg.data.num_channels
        self._stream = HostBatchStream(self.train_batches(epoch, seed, start),
                                       self.cfg.batch_size, (s, s, c), self.device)
        self._stream_next = start

    @property
    def host_batch_ms(self) -> List[float]:
        """The host ms between batches of the current stream's producer."""
        return self._stream.batch_ms if self.host and self._stream is not None else []

    def close_stream(self) -> None:
        if self.host and self._stream is not None:
            self._stream.close()
            self._stream = None

    def close(self) -> None:
        """End the host stream and shut the worker pool down."""
        if self.host:
            self.close_stream()
            if self._pool is not None:
                self._pool.shutdown(wait=True, cancel_futures=True)
                self._pool = None

    def _augment_batch(self) -> None:
        """Batch ``self._index`` of the epoch, gathered and augmented at its
        drawn parameters into ``self._batch_out``; reads only device
        buffers, so a graph replays it for whatever batch the index holds."""
        bs = self.cfg.batch_size
        i = self._index.reshape(1)
        idx = self._perm.view(-1, bs).index_select(0, i)[0]
        params = {k: v.view(-1, bs, *v.shape[1:]).index_select(0, i)[0]
                  for k, v in self._params.items()}
        y = self.augment.apply(self.train_x.index_select(0, idx), {**params, **self._fills})
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
                                  {**{k: v[rows] for k, v in self._params.items()},
                                   **self._draw_fills(index, {})})

    def epoch_batch(self, buffer: Dict[str, torch.Tensor],
                    index: torch.Tensor) -> Dict[str, torch.Tensor]:
        """Batch ``index`` (a 0-d int64 tensor on the device) of a filled
        epoch buffer, read with a device index, as the clustering module's;
        a one-batch buffer (a streamed epoch) is its batch."""
        bs = self.cfg.batch_size
        i = index.reshape(1)

        def pick(t):
            return t if t.shape[0] == bs else t.view(-1, bs, *t.shape[1:]).index_select(0, i)[0]

        return {"image": pick(buffer["image"]), "label": pick(buffer["label"])}

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
    variable-size images, and the train rows of the host path, stay on the
    host (module docstring)."""
    dev = resolve_device(device)
    raw = load_raw(cfg.data)
    train_idx, val_idx = classification_split(len(raw.train_y), cfg.data.dataset)
    host = uses_host_path(cfg.data, raw.train_x)

    def put(x: np.ndarray, y: np.ndarray, idx: Optional[np.ndarray] = None,
            on_host: bool = False):
        if idx is not None:
            x, y = x[idx], y[idx]
        labels = torch.from_numpy(y.astype(np.int64)).to(dev)
        if x.dtype == object or on_host:
            return x, labels
        return torch.from_numpy(np.ascontiguousarray(x)).to(dev), labels

    return ClassificationDataModule(
        cfg, put(raw.train_x, raw.train_y, train_idx, host),
        put(raw.train_x, raw.train_y, val_idx), put(raw.test_x, raw.test_y),
    )
