"""The port's dataset readers against the JAX package's, on files the tests
write in each published format.

- every format through ``vitsom_tpu_torch.data.datasets.load_raw`` against
  ``vitsom_tpu.data.datasets.load_raw`` on the same files: arrays and
  dtypes bitwise equal, object arrays element by element (decoded images
  bitwise, path lists equal); the arrays also equal what was written,
  after the reader's own transform (CHW -> HWC, HWCN -> NHWC, svhn's
  label 10 -> 0, the reuters 80/20 cut, flowers' class = index // 80);
- ``load_raw``'s fallback rule: the files win over ``allow_synthetic``;
  missing files fall back only with it;
- the overlap generator (``synthetic_overlap > 0``) bitwise, at two
  overlaps and both direction generators;
- the usps clustering module (float images in [0, 1] on disk) against the
  JAX pipeline's device arrays: no second division by 255;
- ``desom_flowers17.yaml``'s static path on a jpg dir of mixed sizes
  against the JAX package's transformed train split, to 1e-5.

The JAX package's IDX reader calls ``newbyteorder`` on a numpy scalar type,
which numpy 2 removed; there the port is held against the arrays written.
"""

import gzip
import os
import pickle
import struct
import tarfile

import numpy as np
import pytest
import torch

from vitsom_tpu.config import DataConfig as JDataConfig
from vitsom_tpu.config import load_config as jload_config
from vitsom_tpu.data import datasets as jdatasets
from vitsom_tpu.data import pipeline as jpipeline
from vitsom_tpu_torch.config import DataConfig, load_config
from vitsom_tpu_torch.data import datasets
from vitsom_tpu_torch.data.synthetic import build_datamodule

SPLITS = ("train_x", "train_y", "test_x", "test_y")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Many small CPU ops: one torch thread per test worker (restored after)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _write_idx(path, arr, gz=False):
    code = {np.uint8: 0x08, np.int32: 0x0C}[arr.dtype.type]
    header = struct.pack(">I", (code << 8) | arr.ndim) + struct.pack(f">{arr.ndim}I", *arr.shape)
    data = header + arr.astype(arr.dtype.newbyteorder(">")).tobytes()
    os.makedirs(os.path.dirname(path), exist_ok=True)
    with (gzip.open(path, "wb") if gz else open(path, "wb")) as f:
        f.write(data)


def _images(rng, n, shape):
    return rng.integers(0, 256, size=(n, *shape), dtype=np.uint8)


def _labels(rng, n, k):
    return rng.integers(0, k, size=n).astype(np.int64)


def _write_jpgs(paths, rng):
    """Small RGB jpgs of distinct heights (so the JAX package's object array
    is one-dimensional); returns nothing: the readers decode them."""
    from PIL import Image

    for i, p in enumerate(paths):
        os.makedirs(os.path.dirname(p), exist_ok=True)
        h, w = 6 + i, 5 + (i * 3) % 7
        Image.fromarray(_images(rng, 1, (h, w, 3))[0]).save(p, quality=90)


def write_format(fmt, root):
    """Writes ``fmt``'s files under ``root``; returns (dataset name, the
    ArraySplits the reader must return, or None where only the JAX
    reader's output is the reference)."""
    rng = np.random.default_rng(sum(map(ord, fmt)))
    if fmt.startswith("idx"):
        tx, vx = _images(rng, 12, (28, 28)), _images(rng, 7, (28, 28))
        ty, vy = _labels(rng, 12, 10).astype(np.uint8), _labels(rng, 7, 10).astype(np.uint8)
        if fmt == "idx_raw":
            name, d, names = "mnist", os.path.join(root, "MNIST", "raw"), (
                "{}-images-idx3-ubyte", "{}-labels-idx1-ubyte")
        elif fmt == "idx_gz":
            name, d, names = "mnist", os.path.join(root, "mnist"), (
                "{}-images-idx3-ubyte.gz", "{}-labels-idx1-ubyte.gz")
        else:  # the .idx3-ubyte naming, at the data dir's top
            name, d, names = "fmnist", root, ("{}-images.idx3-ubyte", "{}-labels.idx1-ubyte")
        for stem, x, y in (("train", tx, ty), ("t10k", vx, vy)):
            _write_idx(os.path.join(d, names[0].format(stem)), x, gz=fmt == "idx_gz")
            _write_idx(os.path.join(d, names[1].format(stem)), y, gz=fmt == "idx_gz")
        return name, datasets.ArraySplits(tx[..., None], ty.astype(np.int64),
                                          vx[..., None], vy.astype(np.int64))
    if fmt == "usps_h5":
        import h5py

        tx, vx = rng.random((9, 256)), rng.random((5, 256))
        ty, vy = _labels(rng, 9, 10), _labels(rng, 5, 10)
        with h5py.File(os.path.join(root, "usps.h5"), "w") as hf:
            for g, x, y in (("train", tx, ty), ("test", vx, vy)):
                hf.create_group(g).create_dataset("data", data=x)
                hf[g].create_dataset("target", data=y)
        return "usps", datasets.ArraySplits(
            tx.reshape(-1, 16, 16, 1).astype(np.float32), ty,
            vx.reshape(-1, 16, 16, 1).astype(np.float32), vy)
    if fmt == "reuters_npy":
        x, y = rng.random((10, 40)), _labels(rng, 10, 4).reshape(-1, 1)
        np.save(os.path.join(root, "reutersidf10k.npy"), {"data": x, "label": y})
        x32 = x.astype(np.float32)
        return "reuters-10k", datasets.ArraySplits(x32[:8], y[:8, 0], x32[8:], y[8:, 0])
    if fmt == "pathmnist_npz":
        tx, vx = _images(rng, 6, (28, 28, 3)), _images(rng, 4, (28, 28, 3))
        ty, vy = _labels(rng, 6, 9).reshape(-1, 1), _labels(rng, 4, 9).reshape(-1, 1)
        os.makedirs(os.path.join(root, "medmnist"))
        np.savez(os.path.join(root, "medmnist", "pathmnist.npz"), train_images=tx,
                 train_labels=ty, test_images=vx, test_labels=vy)
        return "medmnist", datasets.ArraySplits(tx, ty[:, 0], vx, vy[:, 0])
    if fmt in ("cifar10_pickle", "cifar100_pickle"):
        ten = fmt == "cifar10_pickle"
        d = os.path.join(root, "cifar-10-batches-py" if ten else "cifar-100-python")
        os.makedirs(d)
        key = b"labels" if ten else b"fine_labels"
        files = [f"data_batch_{i}" for i in range(1, 6)] + ["test_batch"] if ten else [
            "train", "test"]
        xs, ys = [], []
        for f in files:
            x, y = _images(rng, 3, (3 * 32 * 32,)), _labels(rng, 3, 10 if ten else 100)
            with open(os.path.join(d, f), "wb") as fh:
                pickle.dump({key: list(map(int, y)), b"data": x}, fh)
            xs.append(x.reshape(-1, 3, 32, 32).transpose(0, 2, 3, 1))
            ys.append(y)
        return ("cifar-10" if ten else "cifar-100"), datasets.ArraySplits(
            np.concatenate(xs[:-1]), np.concatenate(ys[:-1]), xs[-1], ys[-1])
    if fmt == "svhn_mat":
        from scipy.io import savemat

        out = []
        for f, n in (("train_32x32.mat", 7), ("test_32x32.mat", 5)):
            x = _images(rng, n, (32, 32, 3))
            y = rng.integers(1, 11, size=n)
            y[0] = 10
            savemat(os.path.join(root, f), {"X": x.transpose(1, 2, 3, 0),
                                            "y": y.reshape(-1, 1).astype(np.uint8)})
            out += [x, np.where(y == 10, 0, y).astype(np.int64)]
        return "svhn", datasets.ArraySplits(*out)
    if fmt.startswith("flowers17"):
        if fmt == "flowers17_classdirs":
            paths = [os.path.join(root, "17flowers", "jpg", f"class_{c}", f"im_{i}.jpg")
                     for c in range(3) for i in range(2)]
        else:
            paths = [os.path.join(root, "jpg", f"image_{i:04d}.jpg") for i in range(83)]
        _write_jpgs(paths, rng)
        if fmt == "flowers17_tgz":
            with tarfile.open(os.path.join(root, "17flowers.tgz"), "w:gz") as t:
                t.add(os.path.join(root, "jpg"), arcname="jpg")
            for p in paths:
                os.remove(p)
            os.rmdir(os.path.join(root, "jpg"))
        return "flowers-17", None
    if fmt == "flowers102_mat":
        from scipy.io import savemat

        d = os.path.join(root, "flowers-102")
        _write_jpgs([os.path.join(d, "jpg", f"image_{i:05d}.jpg") for i in range(1, 9)], rng)
        savemat(os.path.join(d, "imagelabels.mat"),
                {"labels": rng.integers(1, 103, size=(1, 8)).astype(np.uint8)})
        savemat(os.path.join(d, "setid.mat"), {"trnid": np.array([[1, 3, 4, 8]]),
                                               "tstid": np.array([[2, 5, 6, 7]])})
        return "flowers-102", None
    if fmt.startswith("tinyimagenet"):
        d = os.path.join(root, "tiny-imagenet-200")
        for c in ("n02", "n01"):
            for i in range(3):
                os.makedirs(os.path.join(d, "train", c, "images"), exist_ok=True)
                open(os.path.join(d, "train", c, "images", f"{c}_{i}.JPEG"), "wb").close()
        if fmt == "tinyimagenet_annotations":
            os.makedirs(os.path.join(d, "val", "images"))
            with open(os.path.join(d, "val", "val_annotations.txt"), "w") as f:
                for i, c in enumerate(("n02", "n01", "n01")):
                    open(os.path.join(d, "val", "images", f"val_{i}.JPEG"), "wb").close()
                    f.write(f"val_{i}.JPEG\t{c}\t0\t0\t63\t63\n")
        else:
            for c in ("n01", "n02", "not_a_class"):
                os.makedirs(os.path.join(d, "val", c))
                open(os.path.join(d, "val", c, f"{c}_v.JPEG"), "wb").close()
        return "tiny-imagenet", None
    raise AssertionError(fmt)


def assert_splits_equal(a, b):
    for name in SPLITS:
        x, y = getattr(a, name), getattr(b, name)
        assert x.dtype == y.dtype and x.shape == y.shape, (name, x.dtype, y.dtype, x.shape, y.shape)
        if x.dtype == object:
            for u, v in zip(x, y):
                if isinstance(v, str):
                    assert u == v, name
                else:
                    assert u.dtype == v.dtype and u.shape == v.shape, name
                    np.testing.assert_array_equal(u, v, err_msg=name)
        else:
            np.testing.assert_array_equal(x, y, err_msg=name)


FORMATS = ["idx_raw", "idx_gz", "idx_dotted", "usps_h5", "reuters_npy", "pathmnist_npz",
           "cifar10_pickle", "cifar100_pickle", "svhn_mat", "flowers17_flat",
           "flowers17_classdirs", "flowers17_tgz", "flowers102_mat",
           "tinyimagenet_annotations", "tinyimagenet_classdirs"]


@pytest.mark.parametrize("fmt", FORMATS)
def test_reader_matches_jax(fmt, tmp_path):
    """Bitwise equal to the JAX reader on the same files, and to what was
    written where the test knows it."""
    name, written = write_format(fmt, str(tmp_path))
    port = datasets.load_raw(DataConfig(dataset=name, data_dir=str(tmp_path)))
    try:
        ref = jdatasets.load_raw(JDataConfig(dataset=name, data_dir=str(tmp_path)))
    except TypeError:
        # the JAX IDX reader's numpy-1-only newbyteorder call (module docstring)
        assert fmt.startswith("idx") and np.lib.NumpyVersion(np.__version__) >= "2.0.0"
        ref = written
    assert_splits_equal(port, ref)
    if written is not None:
        assert_splits_equal(port, written)
    if fmt == "flowers17_flat":  # 83 images: class = index // 80
        assert list(port.train_y[78:]) == [0, 0, 1, 1, 1]
        assert port.train_x is port.test_x


def test_missing_library_raises_not_substitutes(tmp_path, monkeypatch):
    """Where usps.h5 exists but h5py cannot be imported, the reader raises
    the ImportError, even with allow_synthetic; with the file missing it
    falls back without importing h5py (the card's machine has no h5py)."""
    import sys

    write_format("usps_h5", str(tmp_path))
    monkeypatch.setitem(sys.modules, "h5py", None)
    cfg = DataConfig(dataset="usps", data_dir=str(tmp_path), allow_synthetic=True,
                     num_channels=1, input_size=16)
    with pytest.raises(ImportError):
        datasets.load_raw(cfg)
    empty = tmp_path / "empty"
    empty.mkdir()
    raw = datasets.load_raw(DataConfig(dataset="usps", data_dir=str(empty),
                                       allow_synthetic=True, synthetic_size=64))
    assert raw.train_x.dtype == np.uint8 and raw.train_x.shape == (64, 16, 16, 1)


@pytest.mark.parametrize("files,allow", [(True, False), (True, True), (False, True),
                                         (False, False)])
def test_load_raw_fallback_rule(files, allow, tmp_path):
    """The JAX rule: the reader first; the synthetic stand-in only when the
    files are missing and ``allow_synthetic`` is set. The port used to take
    the stand-in whenever ``allow_synthetic`` was set."""
    if files:
        write_format("cifar10_pickle", str(tmp_path))
    kw = dict(dataset="cifar-10", data_dir=str(tmp_path), allow_synthetic=allow,
              synthetic_size=64, num_classes=10, num_channels=3, input_size=32)
    if not files and not allow:
        for load, c in ((datasets.load_raw, DataConfig), (jdatasets.load_raw, JDataConfig)):
            with pytest.raises(FileNotFoundError):
                load(c(**kw))
        return
    port = datasets.load_raw(DataConfig(**kw))
    assert_splits_equal(port, jdatasets.load_raw(JDataConfig(**kw)))
    assert port.train_x.shape[0] == (15 if files else 64)


@pytest.mark.parametrize("dataset,overlap,gen", [("mnist", 0.1, "g4"), ("cifar-10", 0.01, "g2"),
                                                 ("mnist", 0.01, "g2")])
def test_overlap_generator_matches_jax(dataset, overlap, gen):
    kw = dict(dataset=dataset, allow_synthetic=True, synthetic_size=96,
              synthetic_overlap=overlap, synthetic_gen=gen,
              num_channels=3 if dataset == "cifar-10" else 1)
    assert_splits_equal(datasets.make_synthetic(DataConfig(**kw)),
                        jdatasets.make_synthetic(JDataConfig(**kw)))


def test_usps_clustering_module_not_scaled_twice(tmp_path):
    """usps.h5 holds float images in [0, 1]: the JAX eval transform passes
    them as they are, and so must the port's clustering module (it divided
    every input by 255)."""
    write_format("usps_h5", str(tmp_path))
    over = {"data.data_dir": str(tmp_path), "batch_size": 4}
    dm = build_datamodule(load_config("configs/desom/desom_usps.yaml", over), device="cpu")
    jdm = jpipeline.build_datamodule(jload_config("configs/desom/desom_usps.yaml", over))
    images, labels = jdm.device_arrays(jdm.train)
    np.testing.assert_array_equal(dm.images.numpy(), np.asarray(images))
    np.testing.assert_array_equal(dm.labels.numpy(), np.asarray(labels))
    assert dm.images.dtype == torch.float32 and float(dm.images.max()) > 0.5


def test_flowers17_static_path_on_jpgs_matches_jax(tmp_path):
    """``desom_flowers17.yaml`` on a flat jpg dir of mixed sizes: each image
    eval-transformed on its own into one fixed-size tensor, against the JAX
    package's transformed train split and test split (atol 1e-5)."""
    write_format("flowers17_flat", str(tmp_path))
    over = {"data.data_dir": str(tmp_path), "batch_size": 8, "data.input_size": 32}
    cfg = load_config("configs/desom/desom_flowers17.yaml", over)
    dm = build_datamodule(cfg, device="cpu")
    jdm = jpipeline.build_datamodule(jload_config("configs/desom/desom_flowers17.yaml", over))
    assert dm.static and isinstance(dm.train_x, np.ndarray) and dm.train_x.dtype == object
    images, labels = jdm.device_arrays(jdm.train, train_mode=True)
    np.testing.assert_allclose(dm.train_images.numpy(), np.asarray(images), atol=1e-5, rtol=0)
    np.testing.assert_array_equal(dm.train_y.numpy(), np.asarray(labels))
    test_images, _ = dm.eval_arrays("test")
    j_test, _ = jdm.device_arrays(jdm.test, train_mode=False)
    np.testing.assert_allclose(test_images.numpy(), np.asarray(j_test), atol=1e-5, rtol=0)
    assert test_images.shape == (83, 32, 32, 3)


def test_object_array_on_augmented_path_raises(tmp_path):
    """A jpg source on an augmented config takes the host augmentation
    path, and a failure there raises: an unreadable image stops the epoch
    with the reader's error, nothing falls back."""
    write_format("flowers17_classdirs", str(tmp_path))
    cfg = load_config("configs/vit_som/vit_som_flowers-17.yaml",
                      {"data.data_dir": str(tmp_path), "batch_size": 2,
                       "data.input_size": 32, "data.num_workers": 0})
    dm = build_datamodule(cfg, device="cpu")
    assert dm.host and dm.train_x.dtype == object and dm.steps_per_epoch == 2
    assert next(dm.train_batches(0))["image"].shape == (2, 32, 32, 3)
    dm.train_x[:] = str(tmp_path / "missing.jpg")
    with pytest.raises(FileNotFoundError):
        next(dm.train_batches(0))
    dm.start_host_epoch(0, 0)
    with pytest.raises(RuntimeError, match="host augmentation failed"):
        dm.stream_batch(0, dm.epoch_buffer())
    dm.close()
