"""Dataset readers for the raw on-disk formats, and the synthetic stand-in.

The port's own copy of ``vitsom_tpu/data/datasets.py``: the same readers,
the same search paths, the same arrays (NHWC uint8 or float32 images,
int64 labels), bitwise:

- mnist / fmnist : IDX files, raw or gzipped
- usps           : ``usps.h5`` (h5py), float32 images already in [0, 1]
- cifar-10/100   : python pickle batches
- svhn           : ``{train,test}_32x32.mat`` (scipy), label 10 -> 0
- medmnist       : ``pathmnist.npz``
- reuters-10k    : ``reutersidf10k.npy``, an 80/20 split of its rows
- flowers-17     : a flat jpg dir (class = index // 80), class dirs or the
                   ``17flowers.tgz``; object arrays of decoded images
- flowers-102    : a jpg dir + ``imagelabels.mat`` / ``setid.mat``
- tiny-imagenet  : ``tiny-imagenet-200/``; object arrays of paths (lazy)
- synthetic      : deterministic class-conditional blobs (``make_synthetic``)

The readers that need a library import it inside the function, as the JAX
package does: ``scipy.io`` for svhn and flowers-102, ``h5py`` for usps and
``PIL`` for decoding jpgs. Where the library is missing the reader raises
its ``ImportError``; nothing substitutes for it. The import comes after
the files are found, so missing files still raise ``FileNotFoundError``
(and may fall back) on a machine without the library; the JAX package
imports first.

``load_raw`` tries the dataset's reader first and falls back to the
synthetic stand-in only when the files are missing (``FileNotFoundError``)
and ``data.allow_synthetic`` is set. Nothing is downloaded.

Not ported: the on-disk ``.synthetic_cache`` of the JAX generator (it
returns the same arrays) and the object-array generator
(``synthetic_object_array``, a PIL resize), which goes with the host
augmentation path.
"""

from __future__ import annotations

import gzip
import os
import pickle
import struct
import tarfile
import zlib
from dataclasses import dataclass
from typing import List, Optional, Tuple

import numpy as np

from vitsom_tpu_torch.config import DataConfig


@dataclass
class ArraySplits:
    """Raw arrays straight off disk; images NHWC (or object arrays of
    variable-size images or paths)."""

    train_x: np.ndarray
    train_y: np.ndarray
    test_x: np.ndarray
    test_y: np.ndarray


def _find(data_dir: str, candidates: List[str]) -> Optional[str]:
    for c in candidates:
        p = os.path.join(data_dir, c)
        if os.path.exists(p):
            return p
    return None


def _open_maybe_gz(path: str):
    if path.endswith(".gz"):
        return gzip.open(path, "rb")
    return open(path, "rb")


# ---------------------------------------------------------------------------
# IDX (MNIST family)
# ---------------------------------------------------------------------------


def _read_idx(path: str) -> np.ndarray:
    with _open_maybe_gz(path) as f:
        magic = struct.unpack(">I", f.read(4))[0]
        dtype_code = (magic >> 8) & 0xFF
        ndim = magic & 0xFF
        dims = struct.unpack(f">{ndim}I", f.read(4 * ndim))
        dtype = {0x08: np.uint8, 0x09: np.int8, 0x0B: np.int16, 0x0C: np.int32,
                 0x0D: np.float32, 0x0E: np.float64}[dtype_code]
        # np.dtype(...): numpy 2 has no newbyteorder on the scalar types,
        # which the JAX package's copy calls
        data = np.frombuffer(f.read(), dtype=np.dtype(dtype).newbyteorder(">"))
        return data.reshape(dims).astype(dtype)


def _load_idx_pair(data_dir: str, stem: str) -> Tuple[np.ndarray, np.ndarray]:
    img = _find(data_dir, [f"{stem}-images-idx3-ubyte", f"{stem}-images-idx3-ubyte.gz",
                           f"{stem}-images.idx3-ubyte"])
    lbl = _find(data_dir, [f"{stem}-labels-idx1-ubyte", f"{stem}-labels-idx1-ubyte.gz",
                           f"{stem}-labels.idx1-ubyte"])
    if img is None or lbl is None:
        raise FileNotFoundError(f"IDX files for {stem} not found in {data_dir}")
    x = _read_idx(img)[..., None]  # [N, 28, 28, 1]
    y = _read_idx(lbl).astype(np.int64)
    return x, y


def load_mnist_like(data_dir: str, name: str) -> ArraySplits:
    sub = {"mnist": ["MNIST/raw", "mnist", "."],
           "fmnist": ["FashionMNIST/raw", "fmnist", "fashion-mnist", "."]}[name]
    for s in sub:
        d = os.path.join(data_dir, s)
        if os.path.isdir(d):
            try:
                tx, ty = _load_idx_pair(d, "train")
                vx, vy = _load_idx_pair(d, "t10k")
                return ArraySplits(tx, ty, vx, vy)
            except FileNotFoundError:
                continue
    raise FileNotFoundError(f"{name} IDX files not found under {data_dir}")


# ---------------------------------------------------------------------------
# USPS (h5), Reuters (npy), PathMNIST (npz)
# ---------------------------------------------------------------------------


def load_usps(data_dir: str) -> ArraySplits:
    """float32 images in [0, 1], as stored: the eval transform scales only
    uint8 images, so these reach the model unscaled."""
    path = _find(data_dir, ["usps.h5"])
    if path is None:
        raise FileNotFoundError(f"usps.h5 not found in {data_dir}")
    import h5py

    with h5py.File(path, "r") as hf:
        tx = hf["train"]["data"][:].reshape(-1, 16, 16, 1).astype(np.float32)
        ty = hf["train"]["target"][:].astype(np.int64)
        vx = hf["test"]["data"][:].reshape(-1, 16, 16, 1).astype(np.float32)
        vy = hf["test"]["target"][:].astype(np.int64)
    return ArraySplits(tx, ty, vx, vy)


def load_reuters(data_dir: str) -> ArraySplits:
    """The first 80 % of the rows train, the rest test (one array on disk).
    The file is a pickled dict, so only a file from a trusted source may be
    read."""
    path = _find(data_dir, ["reutersidf10k.npy"])
    if path is None:
        raise FileNotFoundError(f"reutersidf10k.npy not found in {data_dir}")
    d = np.load(path, allow_pickle=True).item()
    x = np.asarray(d["data"], dtype=np.float32)
    y = np.asarray(d["label"], dtype=np.int64).reshape(-1)
    n = int(0.8 * len(x))
    return ArraySplits(x[:n], y[:n], x[n:], y[n:])


def load_pathmnist(data_dir: str) -> ArraySplits:
    path = _find(data_dir, ["pathmnist.npz", "medmnist/pathmnist.npz"])
    if path is None:
        raise FileNotFoundError(f"pathmnist.npz not found in {data_dir}")
    with np.load(path) as z:
        return ArraySplits(
            z["train_images"], z["train_labels"].reshape(-1).astype(np.int64),
            z["test_images"], z["test_labels"].reshape(-1).astype(np.int64),
        )


# ---------------------------------------------------------------------------
# CIFAR (pickle)
# ---------------------------------------------------------------------------


def _cifar_batch(path: str, labels_key: bytes) -> Tuple[np.ndarray, np.ndarray]:
    """One pickled batch: [N, 3072] CHW rows -> [N, 32, 32, 3]. A pickle can
    run code when read: read only the published batches."""
    with open(path, "rb") as f:
        d = pickle.load(f, encoding="bytes")
    x = d[b"data"].reshape(-1, 3, 32, 32).transpose(0, 2, 3, 1)  # NHWC
    y = np.asarray(d[labels_key], dtype=np.int64)
    return x, y


def load_cifar10(data_dir: str) -> ArraySplits:
    root = _find(data_dir, ["cifar-10-batches-py"])
    if root is None:
        raise FileNotFoundError(f"cifar-10-batches-py not found in {data_dir}")
    xs, ys = [], []
    for i in range(1, 6):
        x, y = _cifar_batch(os.path.join(root, f"data_batch_{i}"), b"labels")
        xs.append(x)
        ys.append(y)
    tx, ty = np.concatenate(xs), np.concatenate(ys)
    vx, vy = _cifar_batch(os.path.join(root, "test_batch"), b"labels")
    return ArraySplits(tx, ty, vx, vy)


def load_cifar100(data_dir: str) -> ArraySplits:
    root = _find(data_dir, ["cifar-100-python"])
    if root is None:
        raise FileNotFoundError(f"cifar-100-python not found in {data_dir}")
    tx, ty = _cifar_batch(os.path.join(root, "train"), b"fine_labels")
    vx, vy = _cifar_batch(os.path.join(root, "test"), b"fine_labels")
    return ArraySplits(tx, ty, vx, vy)


# ---------------------------------------------------------------------------
# SVHN (.mat)
# ---------------------------------------------------------------------------


def load_svhn(data_dir: str) -> ArraySplits:
    tr = _find(data_dir, ["train_32x32.mat", "svhn/train_32x32.mat"])
    te = _find(data_dir, ["test_32x32.mat", "svhn/test_32x32.mat"])
    if tr is None or te is None:
        raise FileNotFoundError(f"SVHN .mat files not found in {data_dir}")
    from scipy.io import loadmat

    def _load(p):
        m = loadmat(p)
        x = m["X"].transpose(3, 0, 1, 2)  # HWCN -> NHWC
        y = m["y"].reshape(-1).astype(np.int64)
        y[y == 10] = 0  # torchvision convention: label 10 -> 0
        return x, y

    tx, ty = _load(tr)
    vx, vy = _load(te)
    return ArraySplits(tx, ty, vx, vy)


# ---------------------------------------------------------------------------
# Image folders (flowers, tiny-imagenet)
# ---------------------------------------------------------------------------


def load_image(path: str) -> np.ndarray:
    """A jpg/png file as an HWC uint8 RGB array (PIL decodes it)."""
    from PIL import Image

    with Image.open(path) as im:
        return np.asarray(im.convert("RGB"), dtype=np.uint8)


def _object_array(items) -> np.ndarray:
    """A 1-D object array with one image a row. ``np.asarray(items,
    dtype=object)``, as the JAX package builds it, fails on images of one
    height and different widths, and gives a 4-D array of ints when every
    image has the same shape."""
    out = np.empty(len(items), dtype=object)
    for i, item in enumerate(items):
        out[i] = item
    return out


def load_flowers17(data_dir: str) -> ArraySplits:
    """A flat jpg dir ``jpg/`` (class = sorted index // 80, the reference's
    ``organize_flowers`` mapping), or one dir a class, or ``17flowers.tgz``
    unpacked into ``data_dir``. Decoded eagerly (1360 images) into object
    arrays; train and test are the same full set, as in the reference."""
    root = _find(data_dir, ["jpg", "17flowers/jpg"])
    if root is None:
        tar = _find(data_dir, ["17flowers.tgz"])
        if tar is None:
            raise FileNotFoundError(f"flowers-17 jpg dir not found in {data_dir}")
        with tarfile.open(tar, "r:gz") as t:
            t.extractall(path=data_dir, filter="data")
        root = os.path.join(data_dir, "jpg")
    entries = sorted(os.listdir(root))
    jpgs = [e for e in entries if e.endswith(".jpg")]
    imgs, labels = [], []
    if jpgs:
        for i, name in enumerate(jpgs):
            imgs.append(load_image(os.path.join(root, name)))
            labels.append(i // 80)
    else:
        classes = sorted(d for d in entries if os.path.isdir(os.path.join(root, d)))
        for ci, cname in enumerate(classes):
            for f in sorted(os.listdir(os.path.join(root, cname))):
                if f.endswith(".jpg"):
                    imgs.append(load_image(os.path.join(root, cname, f)))
                    labels.append(ci)
    y = np.asarray(labels, dtype=np.int64)
    x = _object_array(imgs)
    return ArraySplits(x, y, x, y)


def load_flowers102(data_dir: str) -> ArraySplits:
    root = _find(data_dir, ["flowers-102", "102flowers", "."])
    jpg = _find(root, ["jpg"]) if root else None
    lab = _find(root, ["imagelabels.mat"]) if root else None
    sid = _find(root, ["setid.mat"]) if root else None
    if not (jpg and lab and sid):
        raise FileNotFoundError(f"flowers-102 files not found in {data_dir}")
    from scipy.io import loadmat

    labels = loadmat(lab)["labels"].reshape(-1).astype(np.int64) - 1
    setid = loadmat(sid)
    trn = setid["trnid"].reshape(-1)
    tst = setid["tstid"].reshape(-1)

    def gather(ids):
        xs = [load_image(os.path.join(jpg, f"image_{i:05d}.jpg")) for i in ids]
        return _object_array(xs), labels[ids - 1]

    tx, ty = gather(trn)
    vx, vy = gather(tst)
    return ArraySplits(tx, ty, vx, vy)


def load_tiny_imagenet(data_dir: str) -> ArraySplits:
    """Object arrays of image paths (100k 64x64 images decode lazily); the
    val split from ``val_annotations.txt`` or from one dir a class."""
    root = _find(data_dir, ["tiny-imagenet-200"])
    if root is None:
        raise FileNotFoundError(f"tiny-imagenet-200 not found in {data_dir}")
    train_dir = os.path.join(root, "train")
    classes = sorted(d for d in os.listdir(train_dir) if os.path.isdir(os.path.join(train_dir, d)))
    cls_to_idx = {c: i for i, c in enumerate(classes)}
    tx, ty = [], []
    for c in classes:
        cdir = os.path.join(train_dir, c)
        img_dir = os.path.join(cdir, "images")
        src = img_dir if os.path.isdir(img_dir) else cdir
        for f in sorted(os.listdir(src)):
            if f.lower().endswith((".jpeg", ".jpg", ".png")):
                tx.append(os.path.join(src, f))
                ty.append(cls_to_idx[c])
    val_dir = os.path.join(root, "val")
    ann = os.path.join(val_dir, "val_annotations.txt")
    vx, vy = [], []
    if os.path.exists(ann):
        with open(ann) as f:
            for line in f:
                parts = line.strip().split("\t")
                img, cls = parts[0], parts[1]
                p = os.path.join(val_dir, "images", img)
                if not os.path.exists(p):
                    p = os.path.join(val_dir, cls, img)
                vx.append(p)
                vy.append(cls_to_idx[cls])
    else:
        for c in sorted(os.listdir(val_dir)):
            cdir = os.path.join(val_dir, c)
            if not os.path.isdir(cdir) or c not in cls_to_idx:
                continue
            for f in sorted(os.listdir(cdir)):
                vx.append(os.path.join(cdir, f))
                vy.append(cls_to_idx[c])
    return ArraySplits(
        np.asarray(tx, dtype=object), np.asarray(ty, dtype=np.int64),
        np.asarray(vx, dtype=object), np.asarray(vy, dtype=np.int64),
    )


# ---------------------------------------------------------------------------
# synthetic (smoke runs; deterministic)
# ---------------------------------------------------------------------------


# stored resolution of each dataset's source files; the synthetic stand-in
# is generated at this size, not at data.input_size
_NATIVE_HW = {
    "mnist": 28, "fmnist": 28, "usps": 16, "medmnist": 28,
    "cifar-10": 32, "cifar-100": 32, "svhn": 32, "tiny-imagenet": 64,
}


def make_synthetic(cfg: DataConfig, num_classes_hint: int = 10) -> ArraySplits:
    """Deterministic class-conditional uint8 images shaped like the real
    dataset, from ``np.random.default_rng(zlib.crc32(dataset))``: the same
    draws in the same order as the JAX package, so the same arrays.

    ``synthetic_overlap == 0``: per-class templates in [0, 0.6*255] plus
    uniform noise in [0, 0.4*255], separable classes.
    ``synthetic_overlap > 0``: Gaussian class means ``0.5 + delta * u_i``
    (u_i orthonormal class directions: white noise with ``synthetic_gen:
    g2``, low-frequency fields orthonormalised by QR with ``g4``) and
    per-pixel noise of std 0.1, delta solved so that the pairwise Bayes
    error is the overlap; purity cannot reach 1."""
    if cfg.synthetic_object_array:
        raise NotImplementedError(
            "the synthetic_object_array generator goes with the host augmentation "
            "path, which is not ported yet (ROADMAP Queue 1 item 4)"
        )
    k = max(cfg.num_classes, num_classes_hint)
    n_train = cfg.synthetic_size
    n_test = max(cfg.synthetic_size // 5, 64)
    rng = np.random.default_rng(zlib.crc32(cfg.dataset.encode()))
    h = w = _NATIVE_HW.get(cfg.dataset, cfg.input_size)
    c = cfg.num_channels

    if cfg.synthetic_overlap > 0.0:
        from scipy.stats import norm

        sigma = 0.1
        delta = np.sqrt(2.0) * sigma * float(norm.isf(cfg.synthetic_overlap))
        d = h * w * c
        if cfg.synthetic_gen == "g2":
            dirs = rng.normal(size=(k, d)).astype(np.float32)
            dirs /= np.linalg.norm(dirs, axis=1, keepdims=True)
        else:
            from scipy.ndimage import zoom

            coarse = rng.normal(size=(k, 4, 4, c)).astype(np.float32)
            dirs = zoom(coarse, (1, h / 4.0, w / 4.0, 1), order=1).reshape(k, d)
            q_mat, _ = np.linalg.qr(dirs.T.astype(np.float64))
            dirs = np.ascontiguousarray(q_mat.T).astype(np.float32)
        means = 0.5 + delta * dirs.reshape(k, h, w, c)

        def gen(n):
            y = rng.integers(0, k, size=n)
            x = rng.standard_normal(size=(n, h, w, c), dtype=np.float32)
            x *= sigma
            x += means[y]
            np.clip(x, 0, 1, out=x)
            x *= 255
            return x.astype(np.uint8), y.astype(np.int64)

    else:
        # templates are drawn once and shared by both splits, so train and
        # test come from the same class-conditional distribution
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


# ---------------------------------------------------------------------------
# dispatch
# ---------------------------------------------------------------------------

_LOADERS = {
    "mnist": lambda d: load_mnist_like(d, "mnist"),
    "fmnist": lambda d: load_mnist_like(d, "fmnist"),
    "usps": load_usps,
    "reuters-10k": load_reuters,
    "medmnist": load_pathmnist,
    "cifar-10": load_cifar10,
    "cifar-100": load_cifar100,
    "svhn": load_svhn,
    "flowers-17": load_flowers17,
    "flowers-102": load_flowers102,
    "tiny-imagenet": load_tiny_imagenet,
}


def load_raw(cfg: DataConfig) -> ArraySplits:
    """The dataset's files under ``cfg.data_dir``; the synthetic stand-in
    for ``dataset: synthetic``, or when the files are missing and
    ``allow_synthetic`` is set."""
    name = cfg.dataset
    if name == "synthetic":
        return make_synthetic(cfg)
    loader = _LOADERS.get(name)
    if loader is None:
        raise ValueError(f"Dataset {name} is not supported")
    try:
        return loader(cfg.data_dir)
    except FileNotFoundError:
        if cfg.allow_synthetic:
            return make_synthetic(cfg)
        raise
