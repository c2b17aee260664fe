"""Clustering on a dataset with an augmented train transform
(``vitsom_tpu_torch/data/pipeline.ClusteringDataModule``) against the JAX
package, on the CPU.

``configs/vit_som/vit_som_cifar-10.yaml`` with ``data.num_classes: 0`` on
the synthetic stand-in (40 + 64 images: the clustering split of 104 rows),
batch 8, cut to depth 1, emb 16, 2 heads, decoder emb 8 and depth 1, a 2x2
map. Held:

- the split: train and test concatenated in the JAX order, labels equal,
  the raw rows on the device for the device augmentation;
- one filled epoch buffer, bitwise, against eager calls of the same ops at
  the same draws made again, as ``tests/test_torch_cls.py`` holds the
  classification buffer;
- the evaluation's batches, bitwise equal to the JAX
  ``dm.eval_batches(dm.train)`` (the train transform, row by row, from one
  ``default_rng(0)``), and the cached rows to the JAX ``device_arrays``;
- a host-path source (an object array of variable-size images, and uint8
  rows with ``data.device_augment: false``) through the same clustering
  split: its train batches and eval batches equal the JAX package's;
- a 3-step ``Trainer.fit`` on the module, from the JAX model's weights,
  against the JAX train step on the batches the trainer's epoch buffer
  held, at ``tests/test_torch_train.py``'s three-step bounds;
- purity and NMI equal to the JAX ``evaluate_clustering`` given the same
  weights; the N-run protocol (fit, save, restore, evaluate) and
  ``eval_checkpoint`` on the module.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from vitsom_tpu.config import load_config as jload_config
from vitsom_tpu.data import pipeline as jpipeline
from vitsom_tpu.eval import evaluate as jevaluate
from vitsom_tpu.models.vit_som import ViTSOM as JViTSOM
from vitsom_tpu.train import optim as joptim
from vitsom_tpu.train import schedules as jsched
from vitsom_tpu.train import steps as jsteps
from vitsom_tpu_torch import convert
from vitsom_tpu_torch.config import load_config
from vitsom_tpu_torch.data import pipeline as tpipeline
from vitsom_tpu_torch.data.synthetic import build_datamodule
from vitsom_tpu_torch.eval import eval_checkpoint
from vitsom_tpu_torch.eval import evaluate as tevaluate
from vitsom_tpu_torch.train import steps as tsteps
from vitsom_tpu_torch.train import trainer as ttrainer

B = 8
CIFAR = "configs/vit_som/vit_som_cifar-10.yaml"
FLOWERS = "configs/vit_som/vit_som_flowers-17.yaml"
SMALL = {"data.num_classes": 0, "data.allow_synthetic": True, "data.synthetic_size": 40,
         "batch_size": B, "vit.emb_dim": 16, "vit.depth": 1, "vit.heads": 2,
         "vit.dec_emb_dim": 8, "vit.dec_depth": 1, "som.map_size": [2, 2],
         "optimizer.scheduler": "constant", "optimizer.lr": 0.032}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _modules(path=CIFAR, **extra):
    over = {**SMALL, **extra}
    jdm = jpipeline.build_datamodule(jload_config(path, over))
    tdm = build_datamodule(load_config(path, over), device="cpu")
    return jdm, tdm


def _same_split(jdm, tdm):
    assert isinstance(tdm, tpipeline.ClusteringDataModule)
    assert tdm.n_train == len(jdm.train) and jdm.train.train_mode and jdm.val is None
    x = tdm.train_x.numpy() if isinstance(tdm.train_x, torch.Tensor) else tdm.train_x
    assert x.dtype == jdm.train.x.dtype and len(x) == len(jdm.train.x)
    for a, b in zip(x, jdm.train.x):
        assert np.array_equal(a, b)
    assert tdm.labels.dtype == torch.int64
    np.testing.assert_array_equal(tdm.labels.numpy(), jdm.train.y)


def _same_eval_batches(jdm, tdm):
    jb = list(jdm.eval_batches(jdm.train))
    tb = list(tdm.eval_batches())
    assert len(jb) == len(tb) == tdm.n_train // B
    for a, b in zip(jb, tb):
        np.testing.assert_array_equal(b["image"].numpy(), a["image"])
        np.testing.assert_array_equal(b["label"].numpy(), a["label"])


def test_clustering_split_matches_jax():
    jdm, tdm = _modules()
    _same_split(jdm, tdm)
    assert tdm.n_train == 40 + 64 and tdm.steps_per_epoch == 13
    # the fixed-size uint8 rows take the device augmentation
    assert not tdm.host and not tdm.static and tdm.augment is not None
    assert isinstance(tdm.train_x, torch.Tensor) and tdm.train_x.dtype == torch.uint8
    assert not jdm.is_static and jdm.use_device_augment


def test_epoch_buffer_holds_augmented_batches():
    """The epoch buffer's batches are the augmentation of the permuted raw
    rows at the epoch's draws, made once from the augmentation generator
    (the erasing fills from one seed a batch), bitwise."""
    _, tdm = _modules()
    buf = tdm.epoch_buffer()
    rows = tdm.steps_per_epoch * B
    assert buf["image"].shape == (rows, 32, 32, 3)
    tdm.fill_epoch(torch.Generator().manual_seed(1), buf, torch.Generator().manual_seed(2))
    perm = torch.randperm(tdm.n_train, generator=torch.Generator().manual_seed(1))[:rows]
    assert torch.equal(buf["label"], tdm.labels[perm])
    g = torch.Generator().manual_seed(2)
    params = tdm.augment.sample(g, rows, 32, 32, "cpu", erase_fill=False)
    seeds = torch.randint(0, 2**62, (tdm.steps_per_epoch,), generator=g).tolist()
    for k in (0, 5, tdm.steps_per_epoch - 1):
        batch = slice(k * B, (k + 1) * B)
        assert torch.equal(buf["image"][batch], tdm.augment_batch_eagerly(k))
        fill = torch.randn((B, 32, 32, 3), generator=torch.Generator().manual_seed(seeds[k]))
        again = tdm.augment.apply(tdm.train_x[perm[batch]],
                                  {**{n: v[batch] for n, v in params.items()},
                                   "erase0.fill": fill})
        assert torch.equal(buf["image"][batch], again)
    assert torch.isfinite(buf["image"]).all()


def test_eval_batches_match_jax():
    jdm, tdm = _modules()
    _same_eval_batches(jdm, tdm)
    # every row, cached: the JAX device_arrays of the split (train_mode)
    images, labels = jdm.device_arrays(jdm.train, train_mode=True)
    np.testing.assert_array_equal(tdm.images.numpy(), np.asarray(images))
    assert tdm.images is tdm.images


@pytest.mark.parametrize("source", ["objects", "uint8_host"])
def test_host_path_source_takes_the_clustering_split(source):
    """A jpg-shaped object array (flowers-17 at 32x32) and uint8 rows with
    ``device_augment: false``: the split, two epochs of host train batches
    (one generator) and the eval batches equal the JAX package's."""
    if source == "objects":
        jdm, tdm = _modules(FLOWERS, **{"data.synthetic_object_array": True,
                                        "data.input_size": 32, "data.num_workers": 0})
        assert tdm.train_x.dtype == object
    else:
        jdm, tdm = _modules(**{"data.device_augment": False, "data.num_workers": 0})
    try:
        _same_split(jdm, tdm)
        assert tdm.host and tdm.streams and not jdm.use_device_augment
        for epoch in range(2):
            jb = list(jdm.train_batches(epoch, seed=3))
            tb = list(tdm.train_batches(epoch, seed=3))
            assert len(jb) == len(tb) == tdm.steps_per_epoch
            for a, b in zip(jb, tb):
                np.testing.assert_array_equal(b["image"], a["image"])
                np.testing.assert_array_equal(b["label"], a["label"])
        _same_eval_batches(jdm, tdm)
    finally:
        tdm.close()
        jpipeline.close_pools(jdm)


def _capture_grads(tx):
    def init(p):
        return tx.init(p), jax.tree_util.tree_map(jnp.zeros_like, p)

    def update(g, state, p=None):
        u, inner = tx.update(g, state[0], p)
        return u, (inner, g)

    return optax.GradientTransformation(init, update)


def test_three_step_fit_meets_train_bounds(tmp_path):
    """``Trainer.fit`` on the clustering module, one step a call from the
    JAX model's weights, against ``make_vit_som_train_step`` (the fused SOM
    in interpret mode) on the batches the trainer's epoch buffer held:
    losses at rtol 1e-5, the first step's gradients at atol 1e-6 / rtol
    1e-4, and each parameter's update over the three steps as
    ``tests/test_torch_train.py`` holds it (0.05 lr where the gradients
    agree to 1e-3 at every step, on at least 99 % of the components; 2 x
    steps x lr everywhere)."""
    over = {**SMALL, "train.checkpoint_dir": str(tmp_path / "s"),
            "train.log_dir": str(tmp_path / "l")}
    jcfg, tcfg = jload_config(CIFAR, over), load_config(CIFAR, over)
    jmodel = JViTSOM(jcfg)
    params = jax.jit(jmodel.init)(jax.random.key(5), jnp.zeros((2, 32, 32, 3)))["params"]
    tr = ttrainer.Trainer(tcfg, device="cpu")
    assert isinstance(tr.dm, tpipeline.ClusteringDataModule)
    tr.model.load_state_dict(convert.flax_to_state_dict(params), strict=True)
    spe, n = tr.dm.steps_per_epoch, tr.dm.n_train
    statics = jsteps.StepStatics(steps_per_epoch=spe, total_epochs=tcfg.total_epochs,
                                 dataset_len=n, batch_size=B)
    jsch = jsched.make_lr_schedule(jcfg.optimizer, jcfg.total_epochs, spe,
                                   joptim.base_learning_rate(jcfg))
    tx = _capture_grads(joptim.make_optimizer(jcfg, params, jsch))
    state = jsteps.TrainState(step=jnp.asarray(0, jnp.int32), params=params,
                              opt_state=tx.init(params))
    jstep = jax.jit(jsteps.make_vit_som_train_step(jcfg, jmodel, tx, statics, jsch))
    named = dict(tr.model.named_parameters())
    start = {k: p.detach().clone() for k, p in named.items()}
    agree = {k: torch.ones_like(p, dtype=torch.bool) for k, p in named.items()}
    eps = tcfg.optimizer.eps
    for i in range(3):
        hist = tr.fit(max_steps=i + 1, new_epoch=i == 0)
        x = tr.epoch_images["image"][i * B:(i + 1) * B].numpy()
        state, jm = jstep(state, {"image": jnp.asarray(x), "label": jnp.zeros((B,), jnp.int32)})
        for k in ("train/recon_loss", "train/som_loss", "train/total_loss"):
            np.testing.assert_allclose(hist[k][0], float(jm[k]), rtol=1e-5, err_msg=k)
        grads = convert.flax_to_state_dict(jax.device_get(state.opt_state[1]))
        for k, g in grads.items():
            tg = named[k].grad
            if i == 0:
                np.testing.assert_allclose(tg.numpy(), g.numpy(), atol=1e-6, rtol=1e-4, err_msg=k)
            agree[k] &= (tg - g).abs() <= 1e-3 * g.abs().clamp_min(eps)
    assert tr.step == 3
    lr = jsch(0)
    final = convert.flax_to_state_dict(jax.device_get(state.params))
    assert sum(int(a.sum()) for a in agree.values()) >= 0.99 * sum(a.numel() for a in agree.values())
    for k, p in named.items():
        t_upd = (p.detach() - start[k]).numpy()
        j_upd = (final[k] - start[k]).numpy()
        a = agree[k].numpy()
        np.testing.assert_allclose(t_upd[a], j_upd[a], atol=0.05 * lr, rtol=0, err_msg=k)
        np.testing.assert_allclose(t_upd, j_upd, atol=2 * 3 * lr, rtol=0, err_msg=k)


def test_purity_nmi_match_jax():
    """``evaluate_clustering`` on the module and the JAX one on its
    ``eval_batches`` (the train transform) with the same weights: the same
    BMUs, so purity and NMI equal."""
    jdm, tdm = _modules()
    jcfg, tcfg = jload_config(CIFAR, SMALL), load_config(CIFAR, SMALL)
    params = jax.jit(JViTSOM(jcfg).init)(jax.random.key(9), jnp.zeros((2, 32, 32, 3)))["params"]
    from vitsom_tpu_torch.models.vit_som import ViTSOM as TViTSOM

    tmodel = TViTSOM(tcfg)
    tmodel.load_state_dict(convert.flax_to_state_dict(params), strict=True)
    tmodel.eval()
    temp = 1.5
    jfn = jax.jit(jsteps.make_vit_som_eval_step(jcfg, JViTSOM(jcfg)))
    j = jevaluate.evaluate_clustering(jfn, params, jdm, jnp.float32(temp))
    t = tevaluate.evaluate_clustering(tsteps.make_vit_som_eval_step(tcfg, tmodel), tdm, temp)
    assert t[:2] == pytest.approx(j[:2], rel=1e-9)


def test_protocol_and_eval_checkpoint_on_the_module(tmp_path):
    """The N-run protocol through ``trainer.main`` (fit, save ``last``,
    restore, evaluate) and ``eval_checkpoint`` on its checkpoint: purity
    and NMI equal, QE and TE in range."""
    res = ttrainer.main([
        "--config", CIFAR, "--synthetic", "--runs", "1", "--max-steps", "3", "--device", "cpu",
        "--batch-size", str(B)] + sum((["--override", f"{k}={v}"] for k, v in {
            **SMALL, "train.checkpoint_dir": tmp_path / "states",
            "train.log_dir": tmp_path / "logs"}.items()), []))
    assert res[0]["steps"] == 3 and 0.0 <= res[0]["purity"] <= 1.0
    ckpt = tmp_path / "states" / "vit_som" / "cifar-10_run0_last"
    out = eval_checkpoint.main(["--checkpoint", str(ckpt), "--cpu", "--no-kmeans"])
    assert out["purity"] == pytest.approx(res[0]["purity"], rel=1e-12)
    assert out["nmi"] == pytest.approx(res[0]["nmi"], rel=1e-12)
    assert out["quantization_error"] >= 0.0 and 0.0 <= out["topographic_error"] <= 1.0
