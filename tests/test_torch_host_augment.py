"""The port's host augmentation path against the JAX package, on the CPU.

The host path (``data/host_augment.py``, ``data/pipeline.py``) is the JAX
package's numpy / PIL train transform and batch rules, so everything here
is held bitwise:

- each host op (the two RandomResizedCrops, torchvision's and timm's
  RandAugment, random erasing, the PIL round trip) from the same
  ``np.random.Generator`` state;
- ``make_train_transform`` for cifar-10 (32 -> 32), MobileViT's 224 from a
  32x32 source, and the mnist family;
- ``train_batches`` against ``vitsom_tpu.data.pipeline.DataModule
  .train_batches`` for two epochs, with one generator (``num_workers`` 0)
  and with a worker pool (2), on a fixed-size uint8 source with
  ``data.device_augment: false``, the object-array flowers stand-in
  (``data.synthetic_object_array``) and tiny-imagenet-style paths to jpgs
  in a temporary directory; the object-array generator itself;
- a streamed device-augmented epoch (``pipeline.STREAM_BYTES`` patched
  low) against the whole-epoch buffer, batch by batch and through the
  trainer; a host-path checkpoint saved mid-epoch that restores and
  continues the same batches.
"""

import os

import numpy as np
import pytest
import torch
from PIL import Image

from vitsom_tpu.config import load_config as jload_config
from vitsom_tpu.data import augment as jaug
from vitsom_tpu.data import datasets as jdatasets
from vitsom_tpu.data import pipeline as jpipeline
from vitsom_tpu_torch.config import load_config
from vitsom_tpu_torch.data import datasets as tdatasets
from vitsom_tpu_torch.data import host_augment as haug
from vitsom_tpu_torch.data import pipeline as tpipeline
from vitsom_tpu_torch.train import trainer as ttrainer

CIFAR = "configs/vit/vit_cifar-10.yaml"
SMALL_VIT = {"vit.emb_dim": 16, "vit.depth": 1, "vit.heads": 2, "vit.dec_depth": 1,
             "vit.dec_emb_dim": 8}


def _img(seed, h=37, w=29, c=3):
    return np.random.default_rng(seed).integers(0, 256, size=(h, w, c), dtype=np.uint8)


def _same(a, b):
    """Two PIL images or arrays equal to the bit, with the same mode."""
    if isinstance(a, Image.Image):
        assert a.mode == b.mode and a.size == b.size
        a, b = np.asarray(a), np.asarray(b)
    assert a.dtype == b.dtype and np.array_equal(a, b)


OPS = {
    "tf_rrc": lambda m, img, rng: m.tf_random_resized_crop(img, rng, 24, (0.08, 1.0),
                                                           (0.75, 1.3333)),
    "torch_rrc": lambda m, img, rng: m.torch_random_resized_crop(img, rng, 24),
    "torch_rrc_fallback": lambda m, img, rng: m.torch_random_resized_crop(
        img, rng, 16, scale=(0.99, 1.0), ratio=(3.0, 4.0)),
    "rand_augment": lambda m, img, rng: m.rand_augment(img, rng, num_ops=3, magnitude=9),
    "rand_augment_mstd": lambda m, img, rng: m.rand_augment(img, rng, num_ops=3, magnitude=7,
                                                            mstd=0.5),
    "timm_rand_augment": lambda m, img, rng: m.timm_rand_augment(img, rng, num_layers=3,
                                                                 prob=0.9),
}


@pytest.mark.parametrize("op", list(OPS))
def test_host_ops_match_jax_bitwise(op):
    """20 images each (so RandAugment draws most of its ops), from the same
    generator state; the generators end in the same state."""
    for seed in range(20):
        img = Image.fromarray(_img(seed))
        rj, rt = np.random.default_rng(seed), np.random.default_rng(seed)
        _same(OPS[op](haug, img, rt), OPS[op](jaug, img, rj))
        assert rj.random() == rt.random()


def test_random_erasing_and_pil_round_trip_match_jax():
    for seed in range(20):
        x = np.random.default_rng(seed).normal(size=(20, 24, 3)).astype(np.float32)
        rj, rt = np.random.default_rng(seed), np.random.default_rng(seed)
        _same(haug.random_erasing(x.copy(), rt, 0.7, "pixel", 2),
              jaug.random_erasing(x.copy(), rj, 0.7, "pixel", 2))
        _same(haug.random_erasing(x.copy(), rt, 0.7, "const"),
              jaug.random_erasing(x.copy(), rj, 0.7, "const"))
    for x in (_img(1), _img(2, c=1), np.random.default_rng(3).random((5, 6, 3)),
              np.random.default_rng(4).random((5, 6, 1)).astype(np.float32) * 200):
        _same(haug._to_pil(x), jaug._to_pil(x))
        for c in (1, 3):
            _same(haug._from_pil(haug._to_pil(x), c), jaug._from_pil(jaug._to_pil(x), c))


@pytest.mark.parametrize("yaml,over,shape", [
    (CIFAR, {}, (32, 32, 3)),
    ("configs/mobile_vit/mobile_vit_cifar-10.yaml", {}, (32, 32, 3)),
    ("configs/vit_som/vit_som_mnist.yaml", {}, (28, 28, 1)),
    ("configs/desom/desom_flowers17.yaml", {"data.input_size": 48}, (61, 53, 3)),
])
def test_make_train_transform_matches_jax(yaml, over, shape):
    """cifar-10 at 32, MobileViT's 224 from a 32x32 source (the whole
    stack: both crops, both RandAugments, flips, erasing), the mnist
    family's ToTensor and a static config's PIL eval transform."""
    jt = jaug.make_train_transform(jload_config(yaml, over).data)
    tt = haug.make_train_transform(load_config(yaml, over).data)
    for seed in range(6):
        x = _img(seed, *shape)
        rj, rt = np.random.default_rng(seed), np.random.default_rng(seed)
        _same(tt(x, rt), jt(x, rj))
        assert rj.random() == rt.random()


def test_object_array_generator_matches_jax():
    over = {"data.allow_synthetic": True, "data.synthetic_size": 6,
            "data.synthetic_object_array": True}
    path = "configs/vit_som/vit_som_flowers-17.yaml"
    j = jdatasets.make_synthetic(jload_config(path, over).data)
    t = tdatasets.make_synthetic(load_config(path, over).data)
    for name in ("train_x", "test_x"):
        a, b = getattr(j, name), getattr(t, name)
        assert a.dtype == b.dtype == object and len(a) == len(b)
        assert len({x.shape for x in b}) > 1
        for u, v in zip(a, b):
            _same(u, v)
    assert np.array_equal(j.train_y, t.train_y) and np.array_equal(j.test_y, t.test_y)


def _write_tiny_imagenet(root, n_per_class=10):
    """tiny-imagenet-200's train layout with jpgs of two sizes."""
    rng = np.random.default_rng(0)
    d = os.path.join(root, "tiny-imagenet-200")
    for c in ("n01", "n02"):
        os.makedirs(os.path.join(d, "train", c, "images"))
        for i in range(n_per_class):
            size = 64 if i % 3 else 48
            Image.fromarray(rng.integers(0, 256, (size, size, 3), dtype=np.uint8)).save(
                os.path.join(d, "train", c, "images", f"{c}_{i}.JPEG"), quality=90)
    os.makedirs(os.path.join(d, "val", "n01"))
    Image.fromarray(rng.integers(0, 256, (64, 64, 3), dtype=np.uint8)).save(
        os.path.join(d, "val", "n01", "v.JPEG"))


SOURCES = {
    "uint8": (CIFAR, {"data.allow_synthetic": True, "data.synthetic_size": 40,
                      "data.device_augment": False}),
    "objects": ("configs/vit/vit_flowers-17.yaml",
                {"data.allow_synthetic": True, "data.synthetic_size": 40,
                 "data.synthetic_object_array": True, "data.input_size": 32}),
    "paths": ("configs/vit/vit_tiny-imagenet.yaml", {"data.input_size": 32}),
}


@pytest.mark.parametrize("workers", [0, 2])
@pytest.mark.parametrize("source", list(SOURCES))
def test_train_batches_match_jax(source, workers, tmp_path):
    """Two epochs of drop-last batches of 8: images and labels equal to
    the JAX package's to the bit (its labels int32, the port's int64)."""
    path, over = SOURCES[source]
    over = {**over, "batch_size": 8, "data.num_workers": workers,
            "data.data_dir": str(tmp_path)}
    if source == "paths":
        _write_tiny_imagenet(str(tmp_path))
    jdm = jpipeline.build_datamodule(jload_config(path, over))
    tdm = tpipeline.build_classification_datamodule(load_config(path, over), device="cpu")
    try:
        assert tdm.host and tdm.streams and not jdm.use_device_augment
        assert isinstance(tdm.train_x, np.ndarray) and tdm._workers() == min(
            workers, 2 * os.cpu_count())
        if source == "paths":
            assert isinstance(tdm.train_x[0], str)
        for epoch in range(2):
            jb = list(jdm.train_batches(epoch, seed=11))
            tb = list(tdm.train_batches(epoch, seed=11))
            assert len(jb) == len(tb) == tdm.steps_per_epoch >= 2
            for a, b in zip(jb, tb):
                _same(b["image"], a["image"])
                assert b["label"].dtype == np.int64 and np.array_equal(b["label"], a["label"])
        # from a batch inside the epoch: the same batches
        tail = list(tdm.train_batches(1, seed=11, start=1))
        for a, b in zip(tail, tb[1:]):
            _same(a["image"], b["image"])
    finally:
        tdm.close()
        jpipeline.close_pools(jdm)


@pytest.mark.parametrize("host", [False, True])
def test_streamed_epoch_equals_whole_epoch(host, monkeypatch, tmp_path):
    """A streamed epoch hands the step the batches a whole-epoch fill
    holds, to the bit: the device augmentation's replays with
    ``STREAM_BYTES`` patched low, and the host path's stream against
    ``train_batches``; then two trainers, streamed and whole, take the
    same two steps."""
    over = {**SMALL_VIT, "batch_size": 8, "data.allow_synthetic": True,
            "data.synthetic_size": 40, "data.device_augment": not host,
            "train.checkpoint_dir": str(tmp_path / "states"),
            "train.log_dir": str(tmp_path / "logs")}
    cfg = load_config(CIFAR, over)
    whole = tpipeline.build_classification_datamodule(cfg, device="cpu")
    monkeypatch.setattr(tpipeline, "STREAM_BYTES", 1024)
    streamed = tpipeline.build_classification_datamodule(cfg, device="cpu")
    assert streamed.streams and whole.streams == host
    buf = streamed.epoch_buffer()
    assert buf["image"].shape[0] == 8
    if host:
        want = list(whole.train_batches(0, seed=5))
        streamed.start_host_epoch(0, 5)
        for s, b in enumerate(want):
            streamed.stream_batch(s, buf)
            assert torch.equal(buf["image"], torch.from_numpy(b["image"]))
            assert torch.equal(buf["label"], torch.from_numpy(b["label"]))
    else:
        full = whole.epoch_buffer()
        whole.fill_epoch(torch.Generator().manual_seed(1), full, torch.Generator().manual_seed(2))
        streamed.fill_epoch(torch.Generator().manual_seed(1), buf, torch.Generator().manual_seed(2))
        assert torch.equal(buf["label"], full["label"])
        for s in range(streamed.steps_per_epoch):
            streamed.stream_batch(s, buf)
            assert torch.equal(buf["image"], full["image"][s * 8:(s + 1) * 8])
    streamed.close()
    runs = []
    for dm in (whole, tpipeline.build_classification_datamodule(cfg, device="cpu")):
        tr = ttrainer.Trainer(cfg, device="cpu", dm=dm)
        hist = tr.fit(max_steps=2)
        runs.append((hist["train/cls_loss"], dict(tr.model.state_dict()), len(tr.stream_ms)))
        dm.close()
    assert np.array_equal(runs[0][0], runs[1][0])
    assert all(torch.equal(runs[0][1][k], runs[1][1][k]) for k in runs[0][1])
    assert runs[1][2] == 2 and runs[0][2] == (2 if host else 0)


@pytest.mark.parametrize("workers", [0, 2])
def test_host_path_restore_continues_the_same_batches(workers, tmp_path):
    """A host-path trainer saved at step 3 of a 4-step epoch and run to
    step 6 (into the next epoch): a fresh trainer restored from the
    checkpoint reaches the same state bitwise, as the batches are a
    function of (seed, epoch, batch); a different run_id (seed) does not."""
    over = {**SMALL_VIT, "batch_size": 8, "data.allow_synthetic": True,
            "data.synthetic_size": 40, "data.device_augment": False,
            "data.num_workers": workers, "total_epochs": 3,
            "train.checkpoint_dir": str(tmp_path / "states"),
            "train.log_dir": str(tmp_path / "logs")}
    cfg = load_config(CIFAR, over)
    tr = ttrainer.Trainer(cfg, device="cpu")
    assert tr.dm.host and tr.host_seed == cfg.train.seed
    tr.fit(max_steps=3)
    tr.save_checkpoint("mid")
    tr.fit(max_steps=6, new_epoch=False)
    want = {k: v.clone() for k, v in tr.model.state_dict().items()}
    assert len(tr.host_wait_ms) == 6 and tr.epochs_done == 1
    tr.dm.close()
    fresh = ttrainer.Trainer(cfg, device="cpu")
    fresh.restore_checkpoint("mid")
    fresh.fit(max_steps=6)
    assert all(torch.equal(v, want[k]) for k, v in fresh.model.state_dict().items())
    fresh.dm.close()
    other = ttrainer.Trainer(cfg, device="cpu", run_id=1)
    assert other.host_seed == cfg.train.seed + 1000
    other.restore_checkpoint("mid", path=tr.checkpoint_dir("mid"))
    other.fit(max_steps=6)
    assert not all(torch.equal(v, want[k]) for k, v in other.model.state_dict().items())
    other.dm.close()
