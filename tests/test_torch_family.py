"""The ViT-SOM / ViT family at its shipped data shapes against the JAX
package, on the CPU; and the clustering evaluator's protocol.

Each yaml below keeps its input size, channels, patch, classes, map,
split, norm statistics and augmentation as shipped; only the widths are
narrowed (emb 16, depth 1, 2 heads; decoder emb 8, depth 1) and the data
cut to a few synthetic images (one train image at 224x224). For each:

- the data: the raw splits and the 80/20 (90/10 for tiny-imagenet) split
  indices against ``vitsom_tpu.data.pipeline``, or the clustering concat;
- the eval transform (PIL's bicubic resize to 32, 36, 73 or 256 and the
  centre crop, then the dataset's normalisation) against the JAX
  package's ``make_eval_transform`` at atol 1e-5: the port runs PIL's own
  fixed-point arithmetic, so the grey levels are PIL's;
- the model's outputs against the Flax model's at atol/rtol 1e-5 (the
  port's seeded weights carried across with ``convert``);
- one ``Trainer`` step (augmentation, encoder-only cls step) with finite
  losses.

Also held: the static classification path's train arrays
(``desom_flowers17.yaml``'s data) against the JAX ``device_arrays(train,
train_mode=True)``; ``vit_som_fmnist`` and ``vit_som_usps`` trained and
evaluated through ``Trainer`` on a few dozen images; the CE of a label
outside the classes (the synthetic medmnist's 10th) as JAX computes it;
and ``evaluate_clustering``'s timer (one warm-up batch outside it) and
its sub-batch split (evaluated whole, as in JAX).
"""

import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import traverse_util

from vitsom_tpu.config import load_config as jload_config
from vitsom_tpu.data import augment as jaug
from vitsom_tpu.data import pipeline as jpipeline
from vitsom_tpu.eval import evaluate as jevaluate
from vitsom_tpu.models.vit_som import ViTClassifier as JViTClassifier
from vitsom_tpu.models.vit_som import ViTSOM as JViTSOM
from vitsom_tpu.train import steps as jsteps
from vitsom_tpu_torch import config as tconfig
from vitsom_tpu_torch import convert
from vitsom_tpu_torch.data import augment as taug
from vitsom_tpu_torch.data import pipeline as tpipeline
from vitsom_tpu_torch.data.synthetic import build_datamodule
from vitsom_tpu_torch.eval import evaluate as tevaluate
from vitsom_tpu_torch.models.vit_som import build_model
from vitsom_tpu_torch.train import steps as tsteps
from vitsom_tpu_torch.train import trainer as ttrainer

CLASSIFICATION = [
    "configs/vit_som/vit_som_cifar-100.yaml", "configs/vit_som/vit_som_svhn.yaml",
    "configs/vit_som/vit_som_medmnist.yaml", "configs/vit_som/vit_som_tiny-imagenet.yaml",
    "configs/vit_som/vit_som_flowers-17.yaml", "configs/vit_som/vit_som_flowers-102.yaml",
    "configs/vit/vit_cifar-100.yaml", "configs/vit/vit_svhn.yaml", "configs/vit/vit_medmnist.yaml",
    "configs/vit/vit_tiny-imagenet.yaml", "configs/vit/vit_flowers-17.yaml",
    "configs/vit/vit_flowers-102.yaml",
]
CLUSTERING = ["configs/vit_som/vit_som_fmnist.yaml", "configs/vit_som/vit_som_usps.yaml"]
NARROW = {"vit.emb_dim": 16, "vit.depth": 1, "vit.heads": 2, "vit.dec_emb_dim": 8,
          "vit.dec_depth": 1, "train.log_every_n_steps": 100}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Many small CPU ops: one torch thread per test worker (restored after)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _overrides(path):
    """The narrowed widths and a few synthetic images: 20 train images
    (batch 4); at 224 one (batch 1, no val image, so validation is off),
    since the CPU augments a 224 image in ~4 s."""
    if "flowers" in path:
        return {**NARROW, "data.allow_synthetic": True, "data.synthetic_size": 1,
                "batch_size": 1, "train.eval_every_n_epochs": 2}
    return {**NARROW, "data.allow_synthetic": True, "data.synthetic_size": 20,
            "batch_size": 4}


def _jax_params(model):
    """The port model's parameters as a nested Flax tree."""
    flat = convert.state_dict_to_flax(model.state_dict())
    return traverse_util.unflatten_dict({tuple(k.split("/")): jnp.asarray(v)
                                         for k, v in flat.items()})


@pytest.mark.parametrize("path", CLASSIFICATION + CLUSTERING)
def test_family_config_matches_jax(path):
    over = _overrides(path)
    jcfg, tcfg = jload_config(path, over), tconfig.load_config(path, over)
    assert (tcfg.data.input_size, tcfg.vit.patch_size, tcfg.data.num_classes,
            tuple(tcfg.som.map_size)) == (jcfg.data.input_size, jcfg.vit.patch_size,
                                          jcfg.data.num_classes, tuple(jcfg.som.map_size))
    jdm = jpipeline.build_datamodule(jcfg)
    tdm = build_datamodule(tcfg, device="cpu")
    s, c = tcfg.data.input_size, tcfg.data.num_channels

    # the data: splits, or the clustering concat
    if tcfg.classification:
        assert isinstance(tdm, tpipeline.ClassificationDataModule) and not tdm.static
        np.testing.assert_array_equal(tdm.train_x.numpy(), jdm.train.x)
        np.testing.assert_array_equal(tdm.train_y.numpy(), jdm.train.y)
        for name in ("val", "test"):
            x, y = tdm.raw[name]
            np.testing.assert_array_equal(x.numpy(), getattr(jdm, name).x, err_msg=name)
            np.testing.assert_array_equal(y.numpy(), getattr(jdm, name).y, err_msg=name)
        n = over["data.synthetic_size"]
        train_idx, val_idx = tpipeline.classification_split(n, tcfg.data.dataset)
        perm = np.random.default_rng(0).permutation(n)
        n_val = int(round((0.1 if tcfg.data.dataset == "tiny-imagenet" else 0.2) * n))
        np.testing.assert_array_equal(val_idx, perm[:n_val])
        np.testing.assert_array_equal(train_idx, perm[n_val:])
        raw = tdm.raw["test"][0][:2]
    else:
        images, labels = jdm.device_arrays(jdm.train, train_mode=True)
        np.testing.assert_allclose(tdm.images.numpy(), np.asarray(images), rtol=1e-7)
        np.testing.assert_array_equal(tdm.labels.numpy(), np.asarray(labels))
        raw = torch.from_numpy(jdm.train.x[:2])

    # the eval transform (test images; the clustering sets' /255)
    t_eval = taug.make_eval_transform(tcfg.data)(raw).numpy()
    jtf = jaug.make_eval_transform(jcfg.data)
    j_eval = np.stack([jtf(im) for im in raw.numpy()])
    assert t_eval.shape == j_eval.shape == (2, s, s, c)
    np.testing.assert_allclose(t_eval, j_eval, atol=1e-5, rtol=0)

    # the model's outputs against the Flax model's
    tmodel = build_model(tcfg, "cpu", seed=1).eval()
    jmodel = (JViTClassifier if tcfg.model_arch == "vit" else JViTSOM)(jcfg)
    x = torch.from_numpy(t_eval)
    with torch.no_grad():
        t_out = tmodel(x)
    j_out = jmodel.apply({"params": _jax_params(tmodel)}, jnp.asarray(t_eval))
    if tcfg.model_arch == "vit":
        t_out, j_out = (t_out,), (j_out,)
        assert t_out[0].shape == (2, tcfg.data.num_classes)
    else:
        assert (t_out[2] is None) == (not tcfg.classification)
        if tcfg.classification:
            assert t_out[2].shape == (2, tcfg.data.num_classes)
        assert t_out[1].shape == (2, s, s, c) and t_out[3].shape == (2, tcfg.som.n_prototypes)
    for k, (t, j) in enumerate(zip(t_out, j_out)):
        if t is None:
            continue
        if t.dtype == torch.int64:
            np.testing.assert_array_equal(t.numpy(), np.asarray(j), err_msg=str(k))
        else:
            np.testing.assert_allclose(t.numpy(), np.asarray(j), atol=1e-5, rtol=1e-5,
                                       err_msg=str(k))

    # one trainer step on the port's data module
    tr = ttrainer.Trainer(tcfg, device="cpu", dm=tdm)
    hist = tr.fit(max_steps=1)
    assert tr.step == 1 and list(hist) == list(tsteps.metric_keys(tcfg))
    for k in hist:
        assert np.all(np.isfinite(hist[k])), k
    if tcfg.classification:
        assert tr.epoch_images["image"].shape[1:] == (s, s, c)
        assert torch.isfinite(tr.epoch_images["image"]).all()


@pytest.mark.parametrize("path", CLUSTERING)
def test_clustering_family_trains_and_evaluates(path):
    """``vit_som_fmnist`` / ``vit_som_usps`` narrowed, on 40 + 64 synthetic
    images, batch 8: two epochs, the recon loss falling, purity and NMI in
    [0, 1]."""
    cfg = tconfig.load_config(path, {**NARROW, "data.allow_synthetic": True,
                                     "data.synthetic_size": 40, "batch_size": 8,
                                     "total_epochs": 2})
    tr = ttrainer.Trainer(cfg, device="cpu")
    assert tr.dm.steps_per_epoch == 13
    hist = tr.fit()
    assert tr.step == 26 and np.all(np.isfinite(hist["train/total_loss"]))
    assert hist["train/recon_loss"][-1] < hist["train/recon_loss"][0]
    res = tr.evaluate()
    assert 0.0 <= res["purity"] <= 1.0 and 0.0 <= res["nmi"] <= 1.0


def test_static_classification_arrays_match_jax():
    """``desom_flowers17.yaml``'s data (no random augmentation configured):
    the JAX package's train transform is its eval transform, applied to the
    train split once (``device_arrays(train, train_mode=True)``); the
    port's resident ``train_images`` equal it at atol 1e-5, and so does its
    test split."""
    path = "configs/desom/desom_flowers17.yaml"
    over = {"data.allow_synthetic": True, "data.synthetic_size": 6, "batch_size": 2,
            "ae.encoder_dims": [8, 4]}
    jcfg, tcfg = jload_config(path, over), tconfig.load_config(path, over)
    jdm = jpipeline.build_datamodule(jcfg)
    assert jdm.is_static and not jdm.use_device_augment
    tdm = build_datamodule(tcfg, device="cpu")
    assert tdm.static and tdm.augment is None
    images, labels = jdm.device_arrays(jdm.train, train_mode=True)
    assert tdm.train_images.shape == images.shape == (5, 224, 224, 3)
    np.testing.assert_allclose(tdm.train_images.numpy(), np.asarray(images), atol=1e-5, rtol=0)
    np.testing.assert_array_equal(tdm.train_y.numpy(), np.asarray(labels))
    j_test, _ = jdm.device_arrays(jdm.test, train_mode=False)
    t_test, _ = tdm.eval_arrays("test")
    np.testing.assert_allclose(t_test[:8].numpy(), np.asarray(j_test)[:8], atol=1e-5, rtol=0)
    # a random train transform with data.device_augment off is the host
    # path, as in the JAX package: the train rows stay on the host
    over = {"data.allow_synthetic": True, "data.synthetic_size": 4,
            "data.device_augment": False}
    cfg = tconfig.load_config("configs/vit_som/vit_som_flowers-17.yaml", over)
    dm = build_datamodule(cfg, device="cpu")
    jdm = jpipeline.build_datamodule(jload_config("configs/vit_som/vit_som_flowers-17.yaml", over))
    assert dm.host and dm.streams and dm.augment is None and not jdm.use_device_augment
    assert isinstance(dm.train_x, np.ndarray) and dm.train_x.dtype == np.uint8


def test_cross_entropy_out_of_range_labels_match_jax():
    """The synthetic medmnist stand-in draws labels from 10 templates for
    its 9 classes (``max(num_classes, 10)``): ``jax.nn.one_hot`` gives label
    9 an all-zero row, so its CE term is the smoothing's alone. The port's
    CE matches at rtol 1e-6, with and without smoothing, and takes no
    out-of-range gather."""
    rng = np.random.default_rng(11)
    logits = (rng.normal(size=(32, 9)) * 3).astype(np.float32)
    labels = rng.integers(0, 10, size=32)
    labels[:3] = 9
    for s in (0.0, 0.1):
        t = float(tsteps.cross_entropy(torch.from_numpy(logits), torch.from_numpy(labels), s))
        j = float(jsteps.cross_entropy(jnp.asarray(logits), jnp.asarray(labels), s))
        np.testing.assert_allclose(t, j, rtol=1e-6)
    in_range = labels < 9
    t = tsteps.cross_entropy(torch.from_numpy(logits[in_range]),
                             torch.from_numpy(labels[in_range]), 0.1)
    ref = torch.nn.functional.cross_entropy(torch.from_numpy(logits[in_range]),
                                            torch.from_numpy(labels[in_range]),
                                            label_smoothing=0.1)
    np.testing.assert_allclose(float(t), float(ref), rtol=1e-6)


# ---------------------------------------------------------------------------
# evaluate_clustering's protocol
# ---------------------------------------------------------------------------


class _SlowFirst:
    """An eval step that sleeps on its first call and counts its calls."""

    def __init__(self, inner, sleep):
        self.inner, self.sleep, self.calls = inner, sleep, 0

    def __call__(self, batch, temperature):
        self.calls += 1
        if self.calls == 1:
            time.sleep(self.sleep)
        return self.inner(batch, temperature)


MNIST = "configs/vit_som/vit_som_mnist.yaml"
MNIST_SMALL = {**NARROW, "data.allow_synthetic": True, "som.map_size": [4, 4],
               "vit.patch_size": 7}


def test_evaluate_clustering_times_no_first_call():
    """The first call (a warm-up batch) falls outside the timer, as the JAX
    package warms its eval before the clock: a step whose first call sleeps
    0.5 s reports less than that, with the split's batches each evaluated
    after the warm-up."""
    cfg = tconfig.load_config(MNIST, {**MNIST_SMALL, "data.synthetic_size": 64,
                                      "batch_size": 32})
    dm = build_datamodule(cfg, device="cpu")
    model = build_model(cfg, "cpu", seed=0)
    step = _SlowFirst(tsteps.make_vit_som_eval_step(cfg, model), 0.5)
    p, n, dt = tevaluate.evaluate_clustering(step, dm, 1.0)
    assert dt < 0.5, dt
    assert step.calls == 1 + 128 // 32
    assert 0.0 <= p <= 1.0 and 0.0 <= n <= 1.0


def test_evaluate_clustering_sub_batch_split_matches_jax():
    """A clustering split smaller than one batch (16 + 64 images, batch 128)
    is evaluated whole, as ``vitsom_tpu.eval.evaluate.evaluate_clustering``
    evaluates it: the same purity and NMI from the same weights."""
    over = {**MNIST_SMALL, "data.synthetic_size": 16}
    jcfg, tcfg = jload_config(MNIST, over), tconfig.load_config(MNIST, over)
    tdm = build_datamodule(tcfg, device="cpu")
    assert tdm.n_train == 80 < tcfg.batch_size == 128
    tmodel = build_model(tcfg, "cpu", seed=2)
    t = tevaluate.evaluate_clustering(tsteps.make_vit_som_eval_step(tcfg, tmodel), tdm, 1.0)
    jdm = jpipeline.build_datamodule(jcfg)
    jstep = jsteps.make_vit_som_eval_step(jcfg, JViTSOM(jcfg))
    j = jevaluate.evaluate_clustering(jstep, _jax_params(tmodel), jdm, jnp.float32(1.0))
    assert t[:2] == pytest.approx(j[:2], rel=1e-9)
    assert 0.0 < t[0] <= 1.0
