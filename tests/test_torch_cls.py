"""The port's classification path against the JAX package, on the CPU.

Small shapes throughout: 32x32x3 images, patch 4 (N 65), emb 16, depth 2,
2 heads, decoder emb 8 and depth 1, a 2x2 cosine map, 10 classes, batch 8;
the inputs are drawn with numpy from a seed and the weights carried across
with ``vitsom_tpu_torch.convert``. Held:

- the logits (and every other output) of ``ViTSOM`` with a head and of
  ``ViTClassifier`` at atol/rtol 1e-5;
- three train steps of the classification ViT-SOM step (plain and fused
  SOM) and of the classifier step: losses at rtol 1e-5, parameters at
  ``tests/test_torch_train.py``'s three-step tolerances, and the decoder,
  which the loss never reaches, decayed by AdamW exactly as optax decays it;
- the eval steps at 1e-5, ``classification_metrics``,
  ``evaluate_classification`` and ``validation_metrics`` on the same
  transformed arrays and parameters;
- the classification split against ``vitsom_tpu.data.pipeline``;
- the trainer and its command line on both configs.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from vitsom_tpu.config import (
    Config, DataConfig, OptimizerConfig, SOMConfig, TrainConfig, ViTConfig,
)
from vitsom_tpu.config import load_config as jload_config
from vitsom_tpu.data import pipeline as jpipeline
from vitsom_tpu.eval import evaluate as jevaluate
from vitsom_tpu.eval import metrics as jmetrics
from vitsom_tpu.models.vit_som import ViTClassifier as JViTClassifier
from vitsom_tpu.models.vit_som import ViTSOM as JViTSOM
from vitsom_tpu.train import optim as joptim
from vitsom_tpu.train import schedules as jsched
from vitsom_tpu.train import steps as jsteps
from vitsom_tpu_torch import config as tconfig
from vitsom_tpu_torch import convert
from vitsom_tpu_torch.data import pipeline as tpipeline
from vitsom_tpu_torch.data.synthetic import build_datamodule
from vitsom_tpu_torch.eval import evaluate as tevaluate
from vitsom_tpu_torch.eval import metrics as tmetrics
from vitsom_tpu_torch.models.vit_som import ViTClassifier as TViTClassifier
from vitsom_tpu_torch.models.vit_som import ViTSOM as TViTSOM
from vitsom_tpu_torch.models.vit_som import build_model
from vitsom_tpu_torch.ops import som_fused
from vitsom_tpu_torch.train import optim as toptim
from vitsom_tpu_torch.train import schedules as tsched
from vitsom_tpu_torch.train import steps as tsteps
from vitsom_tpu_torch.train import trainer as ttrainer

B = 8
CIFAR = "configs/vit_som/vit_som_cifar-10.yaml"
VIT = "configs/vit/vit_cifar-10.yaml"
SMALL = {"vit.emb_dim": 16, "vit.depth": 2, "vit.heads": 2, "vit.dec_emb_dim": 8,
         "vit.dec_depth": 1, "som.map_size": [2, 2], "batch_size": B}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The port's ops here are many small CPU ops, which torch's thread
    pool slows down when several test workers share the cores; the module
    runs them on one thread and restores the count after."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _cfg(arch="vit_som", use_pallas=True):
    """A cut-down cifar-10 classification config; lr 0.032 (base lr 1e-3 at
    batch 8) makes AdamW's decay of the untouched decoder, lr * wd * p a
    step (5e-5 of p), large against float32 rounding."""
    return Config(
        model_arch=arch,
        total_epochs=2,
        batch_size=B,
        gamma=0.01,
        som=SOMConfig(map_size=(2, 2), t_max=4.0, t_min=0.1, distance_fcn="cosine"),
        vit=ViTConfig(patch_size=4, emb_dim=16, depth=2, heads=2, dec_emb_dim=8, dec_depth=1),
        data=DataConfig(dataset="cifar-10", num_classes=10, num_channels=3, input_size=32),
        train=TrainConfig(use_pallas_som=use_pallas),
        optimizer=OptimizerConfig(lr=0.032, smoothing=0.1),
    ).validate()


_JMODELS = {"vit_som": JViTSOM, "vit": JViTClassifier}
_TMODELS = {"vit_som": TViTSOM, "vit": TViTClassifier}


@functools.lru_cache(maxsize=None)
def _init_params(arch):
    model = _JMODELS[arch](_cfg(arch))
    return jax.jit(model.init)(jax.random.key(3), jnp.zeros((2, 32, 32, 3)))["params"]


def _torch_model(jcfg, params):
    tcfg = tconfig.config_from_dict(jcfg.to_dict())
    model = _TMODELS[jcfg.model_arch](tcfg)
    model.load_state_dict(convert.flax_to_state_dict(params), strict=True)
    return tcfg, model


def _inputs(seed, n=B):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(n, 32, 32, 3)).astype(np.float32)
    y = rng.integers(0, 10, size=n)
    return x, y


# ---------------------------------------------------------------------------
# models and the converter
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("arch", ["vit_som", "vit"])
def test_cls_models_match_and_round_trip(arch):
    jcfg = _cfg(arch)
    params = _init_params(arch)
    tcfg, tmodel = _torch_model(jcfg, params)
    x, _ = _inputs(1)
    jmodel = _JMODELS[arch](jcfg)
    with torch.no_grad():
        t_out = tmodel(torch.from_numpy(x))
    j_out = jax.jit(jmodel.apply)({"params": params}, jnp.asarray(x))
    if arch == "vit":
        t_out, j_out = (t_out,), (j_out,)
    assert t_out[-1 if arch == "vit" else 2].shape == (B, 10)
    for k, (t, j) in enumerate(zip(t_out, j_out)):
        np.testing.assert_allclose(t.numpy(), np.asarray(j), atol=1e-5, rtol=1e-5, err_msg=str(k))
    if arch == "vit_som":
        # features and the encoder-only path give the same logits and latent
        with torch.no_grad():
            _, _, f_logits, z = tmodel.features(torch.from_numpy(x))
            e_logits, ez = tmodel.encode(torch.from_numpy(x))
        assert torch.equal(f_logits, t_out[2]) and torch.equal(e_logits, f_logits)
        assert torch.equal(ez, z)
    # the converter's inverse gives JAX's tree back, leaf for leaf
    back = convert.state_dict_to_flax(tmodel.state_dict())
    flat = convert.flatten(params)
    assert set(back) == set(flat)
    for k, v in flat.items():
        np.testing.assert_array_equal(back[k], np.asarray(v), err_msg=k)
    names = [n for n, _ in tmodel.named_parameters()]
    assert "cls_head.weight" in names
    assert any("decoder" in n for n in names) == (arch == "vit_som")


def test_built_models_have_jax_init_distributions():
    tcfg = tconfig.load_config(CIFAR, SMALL)
    model = build_model(tcfg, "cpu", seed=0)
    head = model.cls_head.requires_grad_(False)
    assert head.weight.shape == (10, 16)
    assert abs(float(head.weight.std()) - 0.02) < 0.006
    assert float(head.bias.abs().max()) <= 1.0 / 16**0.5
    vcfg = tconfig.load_config(VIT, SMALL)
    clf = build_model(vcfg, "cpu", seed=0)
    assert isinstance(clf, TViTClassifier)
    assert set(convert.state_dict_to_flax(clf.state_dict())) == set(
        convert.flatten(jax.eval_shape(lambda: JViTClassifier(jload_config(VIT, SMALL)).init(
            jax.random.key(0), jnp.zeros((2, 32, 32, 3))))["params"]))


# ---------------------------------------------------------------------------
# train steps
# ---------------------------------------------------------------------------


def _capture_grads(tx):
    """Wraps an optax transformation so its state also keeps the last
    gradients it was given."""

    def init(p):
        return tx.init(p), jax.tree_util.tree_map(jnp.zeros_like, p)

    def update(g, state, p=None):
        u, inner = tx.update(g, state[0], p)
        return u, (inner, g)

    return optax.GradientTransformation(init, update)


def _check_cls_train_steps(jcfg, steps=3):
    """``steps`` steps of both packages from shared weights on the same
    batches and labels, held as ``tests/test_torch_train.py``'s
    ``test_train_steps_match`` states (its docstring gives the reasons):
    losses at rtol 1e-5, schedule values at rtol 1e-6, the first step's
    gradients at atol 1e-6 / rtol 1e-4, each parameter's update at 0.05 *
    lr where the gradients agree to 1e-3 (at least 99 % of components) and
    2 * steps * lr elsewhere. Parameters that no gradient reaches (the
    decoder) get zero gradients on both sides and move by AdamW's decay
    alone: held at rtol 1e-6, and they must have moved."""
    arch = jcfg.model_arch
    params = _init_params(arch)
    batches = [_inputs(20 + i) for i in range(steps)]
    jmodel = _JMODELS[arch](jcfg)
    jsch = jsched.make_lr_schedule(jcfg.optimizer, 2, steps, joptim.base_learning_rate(jcfg))
    tx = _capture_grads(joptim.make_optimizer(jcfg, params, jsch))
    state = jsteps.TrainState(step=jnp.asarray(0, jnp.int32), params=params,
                              opt_state=tx.init(params))
    tcfg, tmodel = _torch_model(jcfg, params)
    opt = toptim.make_optimizer(tcfg, tmodel)
    base_lr = toptim.base_learning_rate(tcfg)
    tsch = tsched.make_lr_schedule_tensor(tcfg.optimizer, 2, steps, base_lr)
    dstate = tsteps.DeviceState("cpu", steps, tsteps.metric_keys(tcfg))
    if arch == "vit":
        jstep = jax.jit(jsteps.make_classifier_train_step(jcfg, jmodel, tx, jsch, 0.0))
        tstep = tsteps.make_classifier_train_step(tcfg, tmodel, opt, tsch, 0.0, dstate)
        losses, hps = ("train/cls_loss",), ("hp/lr",)
    else:
        statics = jsteps.StepStatics(steps, 2, steps * B, B)
        jstep = jax.jit(jsteps.make_vit_som_train_step(jcfg, jmodel, tx, statics, jsch))
        tstep = tsteps.make_vit_som_train_step(
            tcfg, tmodel, opt, tsteps.StepStatics(steps, 2, steps * B, B), tsch, dstate)
        losses = ("train/cls_loss", "train/som_loss", "train/total_loss")
        hps = ("hp/gamma", "hp/temperature", "hp/lr")
    assert dstate.keys == losses + hps

    named = dict(tmodel.named_parameters())
    start = {name: p.detach().clone() for name, p in named.items()}
    eps = tcfg.optimizer.eps
    agree = {name: torch.ones_like(p, dtype=torch.bool) for name, p in named.items()}
    launches = som_fused.LAUNCHES
    for i, (x, y) in enumerate(batches):
        state, jm = jstep(state, {"image": jnp.asarray(x), "label": jnp.asarray(y, jnp.int32)})
        tm = tsteps.metrics_dict(
            tstep({"image": torch.from_numpy(x), "label": torch.from_numpy(y)}), dstate.keys)
        for k in losses:
            np.testing.assert_allclose(tm[k], float(jm[k]), rtol=1e-5, err_msg=k)
        for k in hps:
            np.testing.assert_allclose(tm[k], float(jm[k]), rtol=1e-6, err_msg=k)
        grads = convert.flax_to_state_dict(jax.device_get(state.opt_state[1]))
        assert set(grads) == set(named)
        for name, g in grads.items():
            tg = named[name].grad
            if i == 0:
                np.testing.assert_allclose(tg.numpy(), g.numpy(), atol=1e-6, rtol=1e-4,
                                           err_msg=name)
            agree[name] &= (tg - g).abs() <= 1e-3 * g.abs().clamp_min(eps)
    assert som_fused.LAUNCHES == launches  # CPU tensors take the plain versions

    lr = float(tsch(torch.tensor(0)))
    final = convert.flax_to_state_dict(jax.device_get(state.params))
    tight = sum(int(a.sum()) for a in agree.values())
    assert tight >= 0.99 * sum(a.numel() for a in agree.values())
    untouched = [n for n, g in grads.items() if not g.any()]
    if arch == "vit_som":
        assert untouched and all(n.startswith("vit.decoder") for n in untouched)
    for name, p in named.items():
        t_upd = (p.detach() - start[name]).numpy()
        j_upd = (final[name] - start[name]).numpy()
        a = agree[name].numpy()
        np.testing.assert_allclose(t_upd[a], j_upd[a], atol=0.05 * lr, rtol=0, err_msg=name)
        np.testing.assert_allclose(t_upd, j_upd, atol=2 * steps * lr, rtol=0, err_msg=name)
    for name in untouched:
        np.testing.assert_allclose(named[name].detach().numpy(), final[name].numpy(),
                                   rtol=1e-6, atol=1e-9, err_msg=name)
        if named[name].ndim == 2:  # decayed (wd 0.05); vectors carry none
            assert not torch.equal(named[name].detach(), start[name]), name


@pytest.mark.parametrize("use_pallas", [False, True])
def test_vit_som_cls_train_steps_match(use_pallas):
    _check_cls_train_steps(_cfg("vit_som", use_pallas))


def test_classifier_train_steps_match():
    _check_cls_train_steps(_cfg("vit"))


def test_cross_entropy_matches_optax():
    rng = np.random.default_rng(5)
    logits = rng.normal(size=(16, 10)).astype(np.float32) * 3
    y = rng.integers(0, 10, size=16)
    for s in (0.0, 0.1):
        t = float(tsteps.cross_entropy(torch.from_numpy(logits), torch.from_numpy(y), s))
        j = float(jsteps.cross_entropy(jnp.asarray(logits), jnp.asarray(y), s))
        np.testing.assert_allclose(t, j, rtol=1e-6)
        ref = torch.nn.functional.cross_entropy(torch.from_numpy(logits), torch.from_numpy(y),
                                                label_smoothing=s)
        np.testing.assert_allclose(t, float(ref), rtol=1e-6)


# ---------------------------------------------------------------------------
# eval steps, metrics, evaluators
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("arch", ["vit_som", "vit"])
def test_eval_steps_match(arch):
    jcfg = _cfg(arch)
    params = _init_params(arch)
    tcfg, tmodel = _torch_model(jcfg, params)
    x, y = _inputs(4)
    jmodel = _JMODELS[arch](jcfg)
    jfn = (jsteps.make_vit_som_eval_step(jcfg, jmodel) if arch == "vit_som"
           else jsteps.make_classifier_eval_step(jcfg, jmodel))
    tfn = (tsteps.make_vit_som_eval_step(tcfg, tmodel) if arch == "vit_som"
           else tsteps.make_classifier_eval_step(tcfg, tmodel))
    j = jax.jit(jfn)(params, {"image": jnp.asarray(x), "label": jnp.asarray(y, jnp.int32)},
                     jnp.float32(2.0))
    t = tfn({"image": torch.from_numpy(x), "label": torch.from_numpy(y)}, 2.0)
    keys = (("logits", "cls_loss", "som_loss", "recon_loss", "total_loss") if arch == "vit_som"
            else ("logits", "cls_loss"))
    for k in keys:
        np.testing.assert_allclose(t[k].numpy(), np.asarray(j[k]), atol=1e-5, rtol=1e-5,
                                   err_msg=k)
    if arch == "vit_som":
        np.testing.assert_array_equal(t["bmu"].numpy(), np.asarray(j["bmu"]))


def test_classification_metrics_match():
    rng = np.random.default_rng(0)
    y_true = rng.integers(0, 10, size=300)
    for y_pred in (np.where(rng.random(300) < 0.5, y_true, rng.integers(0, 10, 300)),
                   np.full(300, 3), np.where(y_true == 9, 0, y_true), y_true):
        t = tmetrics.classification_metrics(y_true, y_pred)
        j = jmetrics.classification_metrics(y_true, y_pred)
        assert t == pytest.approx(j, rel=1e-12, nan_ok=True)


@functools.lru_cache(maxsize=None)
def _split_modules():
    """The JAX and the port's classification data modules on one small
    synthetic cifar-10 (256 train rows: 205 train, 51 val; 64 test)."""
    over = {"data.allow_synthetic": True, "data.synthetic_size": 256, **SMALL}
    jdm = jpipeline.build_datamodule(jload_config(CIFAR, over))
    tdm = build_datamodule(tconfig.load_config(CIFAR, over), device="cpu")
    return jdm, tdm


def test_classification_split_matches_jax():
    jdm, tdm = _split_modules()
    assert isinstance(tdm, tpipeline.ClassificationDataModule)
    assert (tdm.n_train, tdm.split_len("val"), tdm.split_len("test")) == (205, 51, 64)
    np.testing.assert_array_equal(tdm.train_x.numpy(), jdm.train.x)
    np.testing.assert_array_equal(tdm.train_y.numpy(), jdm.train.y)
    for name in ("val", "test"):
        x, y = tdm.raw[name]
        np.testing.assert_array_equal(x.numpy(), getattr(jdm, name).x, err_msg=name)
        np.testing.assert_array_equal(y.numpy(), getattr(jdm, name).y, err_msg=name)
        assert y.dtype == torch.int64
    train_idx, val_idx = tpipeline.classification_split(256, "cifar-10")
    assert len(val_idx) == 51 and sorted(np.concatenate([train_idx, val_idx])) == list(range(256))
    assert len(tpipeline.classification_split(1000, "tiny-imagenet")[1]) == 100


def test_epoch_buffer_holds_augmented_train_batches():
    """fill_epoch: the labels are the permuted train labels; the epoch's
    draws are made at once from the augmentation generator (the erasing
    fills as one seed a batch, expanded per batch), and each image batch
    is the augmentation of the raw rows the permutation picked at those
    draws (``augment_batch_eagerly``, and the same draws made again);
    epoch_batch reads a batch of both buffers."""
    over = {"data.allow_synthetic": True, "data.synthetic_size": 40, **SMALL}
    tdm = build_datamodule(tconfig.load_config(CIFAR, over), device="cpu")
    assert tdm.steps_per_epoch == 4
    buf = tdm.epoch_buffer()
    rows = tdm.steps_per_epoch * B
    assert buf["image"].shape == (rows, 32, 32, 3) and buf["label"].shape == (rows,)
    tdm.fill_epoch(torch.Generator().manual_seed(1), buf, torch.Generator().manual_seed(2))
    perm = torch.randperm(tdm.n_train, generator=torch.Generator().manual_seed(1))[:rows]
    assert torch.equal(buf["label"], tdm.train_y[perm])
    g = torch.Generator().manual_seed(2)
    params = tdm.augment.sample(g, rows, 32, 32, "cpu", erase_fill=False)
    seeds = torch.randint(0, 2**62, (tdm.steps_per_epoch,), generator=g).tolist()
    assert tdm.augment.erase_keys() == ["erase0.fill"]
    for k in (0, tdm.steps_per_epoch - 1):
        batch = slice(k * B, (k + 1) * B)
        assert torch.equal(buf["image"][batch], tdm.augment_batch_eagerly(k))
        fill = torch.randn((B, 32, 32, 3), generator=torch.Generator().manual_seed(seeds[k]))
        again = tdm.augment.apply(tdm.train_x[perm[batch]],
                                  {**{name: v[batch] for name, v in params.items()},
                                   "erase0.fill": fill})
        assert torch.equal(buf["image"][batch], again)
    b3 = tdm.epoch_batch(buf, torch.tensor(3))
    assert torch.equal(b3["image"], buf["image"][3 * B:4 * B])
    assert torch.equal(b3["label"], buf["label"][3 * B:4 * B])
    assert torch.isfinite(buf["image"]).all()


@pytest.mark.parametrize("arch", ["vit_som", "vit"])
def test_evaluators_match_jax(arch):
    """``evaluate_classification`` on the test split and
    ``validation_metrics`` on the val split, both packages on the port's
    transformed arrays (seeded into the JAX splits' device cache) with the
    same parameters: the metrics equal, the losses at rtol 1e-5."""
    jdm, tdm = _split_modules()
    cfg_path = CIFAR if arch == "vit_som" else VIT
    over = {"data.allow_synthetic": True, "data.synthetic_size": 256, **SMALL}
    jcfg = jload_config(cfg_path, over)
    params = jax.jit(_JMODELS[arch](jcfg).init)(jax.random.key(7),
                                                jnp.zeros((2, 32, 32, 3)))["params"]
    tcfg = tconfig.load_config(cfg_path, over)
    tmodel = _TMODELS[arch](tcfg)
    tmodel.load_state_dict(convert.flax_to_state_dict(params), strict=True)
    tmodel.eval()
    jmodel = _JMODELS[arch](jcfg)
    if arch == "vit_som":
        jfn = jsteps.make_vit_som_eval_step(jcfg, jmodel)
        tfn = tsteps.make_vit_som_eval_step(tcfg, tmodel)
    else:
        jfn = jsteps.make_classifier_eval_step(jcfg, jmodel)
        tfn = tsteps.make_classifier_eval_step(tcfg, tmodel)
    for name in ("val", "test"):
        images, labels = tdm.eval_arrays(name)
        getattr(jdm, name)._device_cache = {
            False: (jnp.asarray(images.numpy()), jnp.asarray(labels.numpy().astype(np.int32)))}
    temp = 1.5
    j = jevaluate.evaluate_classification(jfn, params, jdm, temperature=jnp.float32(temp))
    t = tevaluate.evaluate_classification(tfn, tdm, "test", temp)
    assert t[:4] == pytest.approx(j[:4], rel=1e-9, nan_ok=True)
    jv = jevaluate.validation_metrics(jfn, params, jdm, jdm.val, temperature=jnp.float32(temp))
    tv = tevaluate.validation_metrics(tfn, tdm, "val", temp)
    assert set(tv) == set(jv)
    for k, v in jv.items():
        np.testing.assert_allclose(tv[k], v, rtol=1e-5, err_msg=k)


# ---------------------------------------------------------------------------
# the trainer
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("cfg_path", [CIFAR, VIT])
def test_trainer_fits_validates_and_tests_on_cpu(cfg_path):
    """Two epochs of 4 steps at a tiny size: every step's losses finite, a
    validation after each epoch, the val buffer released before the test
    eval, test metrics in [0, 1]; the decoder (ViT-SOM) has gradients of
    zeros, not None."""
    over = {"data.allow_synthetic": True, "data.synthetic_size": 40, **SMALL,
            "train.log_every_n_steps": 100}
    cfg = tconfig.load_config(cfg_path, over)
    tr = ttrainer.Trainer(cfg, device="cpu")
    assert tr.dm.steps_per_epoch == 4
    hist = tr.fit(max_steps=8)
    assert tr.step == 8 and len(tr.step_ms) == 8 and len(tr.fill_ms) == 2
    assert list(hist) == list(tsteps.metric_keys(cfg))
    assert np.all(np.isfinite(hist["train/cls_loss"]))
    assert [v["epoch"] for v in tr.val_history] == [0, 1]
    assert 0.0 <= tr.best_val_accuracy <= 1.0
    assert "val" in tr.dm._cache
    res = tr.evaluate()
    assert "val" not in tr.dm._cache and "test" in tr.dm._cache
    for k in ("accuracy", "precision", "recall", "f1"):
        assert 0.0 <= res[k] <= 1.0, k
    if cfg.model_arch == "vit_som":
        dec = [p for n, p in tr.model.named_parameters() if n.startswith("vit.decoder")]
        assert dec and all(p.grad is not None and not p.grad.any() for p in dec)
        assert set(tr.val_history[0]) >= {"val/accuracy", "val/cls_loss", "val/som_loss",
                                          "val/recon_loss", "val/total_loss"}
    else:
        assert not any("decoder" in n for n, _ in tr.model.named_parameters())


def test_trainer_cli_cls_on_cpu(capsys, tmp_path):
    results = ttrainer.main([
        "--override", f"train.checkpoint_dir={tmp_path / 'states'}",
        "--override", f"train.log_dir={tmp_path / 'logs'}",
        "--config", CIFAR, "--synthetic", "--runs", "1", "--max-steps", "2", "--device", "cpu",
        "--batch-size", "8", "--override", "data.synthetic_size=40",
        "--override", "som.map_size=[2, 2]", "--override", "vit.depth=1",
        "--override", "vit.emb_dim=16", "--override", "vit.heads=2",
        "--override", "vit.dec_emb_dim=8",
    ])
    assert len(results) == 1 and results[0]["steps"] == 2
    assert 0.0 <= results[0]["accuracy"] <= 1.0 and np.isfinite(results[0]["first_cls_loss"])
    assert '"mean_std"' in capsys.readouterr().out
