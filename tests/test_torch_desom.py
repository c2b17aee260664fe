"""The port's DESOM against the JAX package, on the CPU.

Small shapes: 8x8x3 inputs (192-d flattened), encoder dims [32, 10] (the
decoder mirrors them), a 4x4 manhattan map, 6 classes where a classifier is
on, batch 16; inputs drawn with numpy from a seed and weights (and
BatchNorm statistics) carried across with ``vitsom_tpu_torch.convert``.
Held:

- ``forward`` (logits, z, distances, bmu) and ``decode`` at atol/rtol 1e-5,
  with and without BatchNorm, in train mode (the batch's statistics) and
  in eval mode (the running averages);
- the BatchNorm running mean and var after 3 train-mode passes against
  Flax's ``batch_stats`` at 1e-5, and the eval-mode outputs after them
  (torch's own BatchNorm, which stores the unbiased variance with the
  momentum read the other way round, fails this);
- 3 DESOM train steps (adam; clustering and classification; BatchNorm on
  and off): losses at rtol 1e-5, schedule values at rtol 1e-6, parameters
  at ``tests/test_torch_train.py``'s 3-step tolerances, running statistics
  at 1e-5;
- the eval step at 1e-5 (BMUs equal), the converter's round trip, the
  optimizer groups;
- the trainer and its command line on a tiny ``desom_mnist.yaml``, and a
  static-path classification DESOM (``desom_flowers17.yaml``) at 224x224
  on a few images.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from flax import traverse_util

from vitsom_tpu.config import AEConfig, Config, DataConfig, OptimizerConfig, SOMConfig
from vitsom_tpu.models.desom import DESOM as JDESOM
from vitsom_tpu.train import optim as joptim
from vitsom_tpu.train import schedules as jsched
from vitsom_tpu.train import steps as jsteps
from vitsom_tpu_torch import config as tconfig
from vitsom_tpu_torch import convert
from vitsom_tpu_torch.data import pipeline as tpipeline
from vitsom_tpu_torch.models import ae as tae
from vitsom_tpu_torch.models.desom import DESOM as TDESOM
from vitsom_tpu_torch.models.vit_som import build_model
from vitsom_tpu_torch.train import optim as toptim
from vitsom_tpu_torch.train import schedules as tsched
from vitsom_tpu_torch.train import steps as tsteps
from vitsom_tpu_torch.train import trainer as ttrainer

B = 16
S = 8
MNIST = "configs/desom/desom_mnist.yaml"
FLOWERS = "configs/desom/desom_flowers17.yaml"
STEPS = 3


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Many small CPU ops: one torch thread per test worker (restored after)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _cfg(bn=False, classes=0):
    """A cut-down DESOM config; lr 0.01 makes each Adam step large against
    float32 rounding."""
    return Config(
        model_arch="desom",
        total_epochs=2,
        batch_size=B,
        gamma=0.01,
        som=SOMConfig(map_size=(4, 4), t_max=8.0, t_min=0.1, distance_fcn="manhattan"),
        ae=AEConfig(encoder_dims=(32, 10), act="relu", batch_norm=bn),
        data=DataConfig(dataset="flowers-17", num_classes=classes, num_channels=3,
                        input_size=S),
        optimizer=OptimizerConfig(type="adam", lr=0.01),
    ).validate()


@functools.lru_cache(maxsize=None)
def _init(bn, classes):
    """(params, batch_stats or None) of the Flax model from a fixed key; the
    BatchNorm scale, bias and running statistics moved off their init so
    that each of them shows in the outputs."""
    model = JDESOM(_cfg(bn, classes))
    v = jax.jit(model.init)(jax.random.key(5), jnp.zeros((2, 3 * S * S)))
    params = jax.device_get(v["params"])
    stats = jax.device_get(v.get("batch_stats"))
    if bn:
        rng = np.random.default_rng(9)
        flat = traverse_util.flatten_dict(params, sep="/")
        for k in flat:
            if "/bn_" in k:
                flat[k] = flat[k] + rng.normal(scale=0.1, size=flat[k].shape).astype(np.float32)
        params = traverse_util.unflatten_dict(flat, sep="/")
        sflat = traverse_util.flatten_dict(stats, sep="/")
        for k, v in sflat.items():
            shift = rng.normal(scale=0.2, size=v.shape).astype(np.float32)
            sflat[k] = v + (np.abs(shift) if k.endswith("var") else shift)
        stats = traverse_util.unflatten_dict(sflat, sep="/")
    return params, stats


def _torch_model(jcfg, params, stats):
    tcfg = tconfig.config_from_dict(jcfg.to_dict())
    model = TDESOM(tcfg)
    model.load_state_dict(convert.flax_to_state_dict(params, stats), strict=True)
    return tcfg, model


def _inputs(seed, n=B, classes=6):
    rng = np.random.default_rng(seed)
    x = rng.uniform(size=(n, S, S, 3)).astype(np.float32)
    return x, rng.integers(0, max(classes, 1), size=n)


def _variables(params, stats):
    return {"params": params, **({"batch_stats": stats} if stats is not None else {})}


# ---------------------------------------------------------------------------
# the model, BatchNorm and the converter
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("bn", [False, True])
@pytest.mark.parametrize("train", [False, True])
def test_desom_outputs_match(bn, train):
    jcfg = _cfg(bn, 6)
    params, stats = _init(bn, 6)
    _, tmodel = _torch_model(jcfg, params, stats)
    x, _ = _inputs(1)
    x_flat = x.reshape(B, -1)
    jmodel = JDESOM(jcfg)
    variables = _variables(params, stats)
    kw = {"mutable": ["batch_stats"]} if (bn and train) else {}
    j_out = jmodel.apply(variables, jnp.asarray(x_flat), train=train,
                         method="forward_with_recon", **kw)
    if kw:
        j_out = j_out[0]
    j_plain = jmodel.apply(variables, jnp.asarray(x_flat))
    z = np.array(j_plain[1])
    j_dec = jmodel.apply(variables, jnp.asarray(z), train=False, method="decode")
    with torch.no_grad():
        # eval mode first: the train-mode pass moves the running averages
        t_plain = tmodel(torch.from_numpy(x_flat))
        t_dec = tmodel.decode(torch.from_numpy(z))
        t_out = tmodel.forward_with_recon(torch.from_numpy(x_flat), train=train)
    assert t_out[0].shape == (B, 6) and t_out[1].shape == (B, 10) and t_out[2].shape == (B, 16)
    for k, name in enumerate(("logits", "z", "distances", "bmu", "decoded")):
        if name == "bmu":
            np.testing.assert_array_equal(t_out[k].numpy(), np.asarray(j_out[k]))
        else:
            np.testing.assert_allclose(t_out[k].numpy(), np.asarray(j_out[k]), atol=1e-5,
                                       rtol=1e-5, err_msg=name)
    # forward (eval mode) and decode against the JAX model's
    for k in range(3):
        np.testing.assert_allclose(t_plain[k].numpy(), np.asarray(j_plain[k]), atol=1e-5,
                                   rtol=1e-5)
    np.testing.assert_array_equal(t_plain[3].numpy(), np.asarray(j_plain[3]))
    np.testing.assert_allclose(t_dec.numpy(), np.asarray(j_dec), atol=1e-5, rtol=1e-5)


def test_batchnorm_running_stats_match_flax():
    """Three train-mode passes on different batches: the running mean and
    var at 1e-5 against Flax's ``batch_stats``; then the eval-mode outputs
    at 1e-5. torch's BatchNorm1d with any momentum gives other statistics
    (it keeps the unbiased batch variance)."""
    jcfg = _cfg(True, 6)
    params, stats = _init(True, 6)
    _, tmodel = _torch_model(jcfg, params, stats)
    jmodel = JDESOM(jcfg)
    for i in range(3):
        x = _inputs(10 + i)[0].reshape(B, -1)
        _, mutated = jmodel.apply({"params": params, "batch_stats": stats}, jnp.asarray(x),
                                  train=True, mutable=["batch_stats"])
        stats = jax.device_get(mutated["batch_stats"])
        with torch.no_grad():
            tmodel(torch.from_numpy(x), train=True)
    back = convert.batch_stats_to_flax(tmodel.state_dict())
    flat = convert.flatten(stats)
    assert set(back) == set(flat) and len(flat) == 4
    for k, v in flat.items():
        np.testing.assert_allclose(back[k], np.asarray(v), atol=1e-5, rtol=1e-5, err_msg=k)
    x = _inputs(20)[0].reshape(B, -1)
    j = jmodel.apply({"params": params, "batch_stats": stats}, jnp.asarray(x))
    with torch.no_grad():
        t = tmodel(torch.from_numpy(x))
    for k in range(3):
        np.testing.assert_allclose(t[k].numpy(), np.asarray(j[k]), atol=1e-5, rtol=1e-5)
    # torch's own BatchNorm would have stored other statistics
    ref = torch.nn.BatchNorm1d(32, momentum=0.01)
    xb = torch.from_numpy(_inputs(3)[0].reshape(B, -1)[:, :32])
    ref(xb)
    bn = tae.BatchNorm(32)
    bn(xb, train=True)
    assert not torch.allclose(ref.running_var, bn.running_var, rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(bn.running_var.numpy(),
                               0.99 + 0.01 * xb.var(dim=0, unbiased=False).numpy(), rtol=1e-5)


def test_converter_round_trip_and_init():
    params, stats = _init(True, 6)
    tcfg, tmodel = _torch_model(_cfg(True, 6), params, stats)
    sd = tmodel.state_dict()
    assert "autoencoder.encoder.dense_0.weight" in sd and sd[
        "autoencoder.encoder.dense_0.weight"].shape == (32, 3 * S * S)
    assert {"autoencoder.decoder.bn_0.running_var", "classifier.weight", "prototypes"} <= set(sd)
    back = convert.state_dict_to_flax(sd)
    flat = convert.flatten(params)
    assert set(back) == set(flat)
    for k, v in flat.items():
        np.testing.assert_array_equal(back[k], np.asarray(v), err_msg=k)
    bstats = convert.batch_stats_to_flax(sd)
    for k, v in convert.flatten(stats).items():
        np.testing.assert_array_equal(bstats[k], np.asarray(v), err_msg=k)
    # build_model: the JAX init's distributions and tree
    built = build_model(tcfg, "cpu", seed=0)
    assert isinstance(built, TDESOM)
    assert set(convert.state_dict_to_flax(built.state_dict())) == set(flat)
    w = built.autoencoder.encoder.dense_0.weight.detach()
    assert float(w.abs().max()) <= (6.0 / (192 + 32)) ** 0.5
    cls = built.classifier.weight.detach()
    assert float(cls.abs().max()) <= 10 ** -0.5 and float(cls.std()) > 0.1
    assert torch.equal(built.autoencoder.encoder.bn_0.running_var, torch.ones(32))
    protos = built.prototypes.detach()
    assert protos.shape == (16, 10) and 0.0 <= float(protos.min()) and float(protos.max()) < 1.0


def test_optimizer_groups_are_adam_at_the_raw_lr():
    tcfg, tmodel = _torch_model(_cfg(True, 6), *_init(True, 6))
    wd = toptim.build_weight_decay_map(tmodel, tcfg)
    assert set(wd) == {n for n, _ in tmodel.named_parameters()} and set(wd.values()) == {0.0}
    assert toptim.base_learning_rate(tcfg) == joptim.base_learning_rate(_cfg(True, 6)) == 0.01
    opt = toptim.make_optimizer(tcfg, tmodel)
    assert [g["weight_decay"] for g in opt.param_groups] == [0.0]
    assert tcfg.optimizer.scheduler == "constant"


# ---------------------------------------------------------------------------
# train and eval steps
# ---------------------------------------------------------------------------


def _capture_grads(tx):
    """An optax transformation whose state also keeps the last gradients."""

    def init(p):
        return tx.init(p), jax.tree_util.tree_map(jnp.zeros_like, p)

    def update(g, state, p=None):
        u, inner = tx.update(g, state[0], p)
        return u, (inner, g)

    return optax.GradientTransformation(init, update)


@pytest.mark.parametrize("bn", [False, True])
@pytest.mark.parametrize("classes", [0, 6])
def test_desom_train_steps_match(bn, classes):
    """Three steps of both packages from shared weights on the same batches,
    held as ``tests/test_torch_cls.py``'s ``_check_cls_train_steps`` holds
    the cls steps: losses at rtol 1e-5, temperature and lr at rtol 1e-6,
    the first step's gradients at atol 1e-6 / rtol 1e-4, each parameter's
    update at 0.05 * lr where the gradients agree to 1e-3 (at least 99 % of
    components) and 2 * steps * lr elsewhere. BatchNorm's running
    statistics at atol/rtol 1e-5 after the first step, which reads them
    through the shared initial weights; after the next two, whose batch
    statistics pass through weights that already differ by Adam's float32
    noise (a step of up to 2 * lr where a gradient near 0 flips its sign),
    at atol 0.05 * lr, the parameters' own bound (5e-4; up to 1.4e-4
    seen). The first step's 1e-5 already fails torch's BatchNorm
    semantics."""
    jcfg = _cfg(bn, classes)
    params, stats = _init(bn, 6 if classes else 0)
    jmodel = JDESOM(jcfg)
    batches = [_inputs(30 + i, classes=classes) for i in range(STEPS)]
    jsch = jsched.make_lr_schedule(jcfg.optimizer, 2, STEPS, joptim.base_learning_rate(jcfg))
    tx = _capture_grads(joptim.make_optimizer(jcfg, params, jsch))
    state = jsteps.TrainState(step=jnp.asarray(0, jnp.int32), params=params,
                              opt_state=tx.init(params), batch_stats=stats)
    statics = (STEPS, 2, STEPS * B, B)
    jstep = jax.jit(jsteps.make_desom_train_step(jcfg, jmodel, tx, jsteps.StepStatics(*statics),
                                                 jsch))
    tcfg, tmodel = _torch_model(jcfg, params, stats)
    opt = toptim.make_optimizer(tcfg, tmodel)
    tsch = tsched.make_lr_schedule_tensor(tcfg.optimizer, 2, STEPS,
                                          toptim.base_learning_rate(tcfg))
    dstate = tsteps.DeviceState("cpu", STEPS, tsteps.metric_keys(tcfg))
    tstep = tsteps.make_desom_train_step(tcfg, tmodel, opt, tsteps.StepStatics(*statics), tsch,
                                         dstate)
    losses = (("train/cls_loss",) if classes else ()) + (
        "train/recon_loss", "train/som_loss", "train/total_loss")
    assert dstate.keys == losses + ("hp/temperature", "hp/lr")

    named = dict(tmodel.named_parameters())
    start = {name: p.detach().clone() for name, p in named.items()}
    eps = tcfg.optimizer.eps
    agree = {name: torch.ones_like(p, dtype=torch.bool) for name, p in named.items()}
    for i, (x, y) in enumerate(batches):
        state, jm = jstep(state, {"image": jnp.asarray(x), "label": jnp.asarray(y, jnp.int32)})
        tm = tsteps.metrics_dict(
            tstep({"image": torch.from_numpy(x), "label": torch.from_numpy(y)}), dstate.keys)
        assert set(jm) == set(tm)
        for k in losses:
            np.testing.assert_allclose(tm[k], float(jm[k]), rtol=1e-5, err_msg=k)
        for k in ("hp/temperature", "hp/lr"):
            np.testing.assert_allclose(tm[k], float(jm[k]), rtol=1e-6, err_msg=k)
        if bn:
            back = convert.batch_stats_to_flax(tmodel.state_dict())
            tol = (1e-5, 1e-5) if i == 0 else (0.05 * toptim.base_learning_rate(tcfg), 0.0)
            for k, v in convert.flatten(jax.device_get(state.batch_stats)).items():
                np.testing.assert_allclose(back[k], np.asarray(v), atol=tol[0], rtol=tol[1],
                                           err_msg=f"step {i} {k}")
        grads = convert.flax_to_state_dict(jax.device_get(state.opt_state[1]))
        assert set(grads) == set(named)
        for name, g in grads.items():
            tg = named[name].grad
            if i == 0:
                np.testing.assert_allclose(tg.numpy(), g.numpy(), atol=1e-6, rtol=1e-4,
                                           err_msg=name)
            agree[name] &= (tg - g).abs() <= 1e-3 * g.abs().clamp_min(eps)

    lr = toptim.base_learning_rate(tcfg)
    final = convert.flax_to_state_dict(jax.device_get(state.params))
    assert sum(int(a.sum()) for a in agree.values()) >= 0.99 * sum(
        a.numel() for a in agree.values())
    for name, p in named.items():
        t_upd = (p.detach() - start[name]).numpy()
        j_upd = (final[name] - start[name]).numpy()
        a = agree[name].numpy()
        np.testing.assert_allclose(t_upd[a], j_upd[a], atol=0.05 * lr, rtol=0, err_msg=name)
        np.testing.assert_allclose(t_upd, j_upd, atol=2 * STEPS * lr, rtol=0, err_msg=name)
        assert not torch.equal(p.detach(), start[name]), name


@pytest.mark.parametrize("bn", [False, True])
def test_desom_eval_step_matches(bn):
    """The eval step on the running averages (moved off their init):
    logits and latent at 1e-5, BMUs equal; without a classifier the logits
    are [B, 1] zeros, as in the JAX step."""
    for classes in (6, 0):
        jcfg = _cfg(bn, classes)
        params, stats = _init(bn, classes)
        _, tmodel = _torch_model(jcfg, params, stats)
        x, y = _inputs(7, classes=classes)
        jfn = jsteps.make_desom_eval_step(jcfg, JDESOM(jcfg))
        j = jax.jit(jfn)(params, {"image": jnp.asarray(x), "label": jnp.asarray(y)},
                         jnp.float32(1.0), stats)
        t = tsteps.make_desom_eval_step(tconfig.config_from_dict(jcfg.to_dict()), tmodel)(
            {"image": torch.from_numpy(x), "label": torch.from_numpy(y)})
        assert set(t) == set(j) == {"bmu", "logits", "latent"}
        for k in ("logits", "latent"):
            np.testing.assert_allclose(t[k].numpy(), np.asarray(j[k]), atol=1e-5, rtol=1e-5,
                                       err_msg=k)
        np.testing.assert_array_equal(t["bmu"].numpy(), np.asarray(j["bmu"]))
        assert t["logits"].shape == ((B, 6) if classes else (B, 1))


# ---------------------------------------------------------------------------
# the trainer
# ---------------------------------------------------------------------------

TINY = {"data.allow_synthetic": True, "data.synthetic_size": 64, "batch_size": 16,
        "ae.encoder_dims": [32, 10], "train.log_every_n_steps": 100}


@pytest.mark.parametrize("bn", [False, True])
def test_trainer_fits_and_evaluates_desom_mnist_on_cpu(bn):
    """``desom_mnist.yaml`` narrowed to [32, 10] on 64 + 64 synthetic images
    (8 steps an epoch): two epochs, losses finite, recon falling, the
    temperature decaying, purity and NMI of the BMUs in [0, 1]; with
    BatchNorm the running averages moved."""
    cfg = tconfig.load_config(MNIST, {**TINY, "ae.batch_norm": bn, "total_epochs": 2})
    tr = ttrainer.Trainer(cfg, device="cpu")
    assert isinstance(tr.model, TDESOM) and tr.dm.steps_per_epoch == 8
    hist = tr.fit()
    assert tr.step == 16 and list(hist) == list(tsteps.DESOM_METRIC_KEYS)
    assert np.all(np.isfinite(hist["train/total_loss"]))
    assert hist["train/recon_loss"][-1] < hist["train/recon_loss"][0]
    assert hist["hp/temperature"][-1] < hist["hp/temperature"][0] == 8.0
    np.testing.assert_allclose(hist["hp/lr"], 1e-3, rtol=1e-6)
    res = tr.evaluate()
    assert 0.0 <= res["purity"] <= 1.0 and 0.0 <= res["nmi"] <= 1.0
    if bn:
        assert not torch.equal(tr.model.autoencoder.encoder.bn_0.running_var, torch.ones(32))


def test_trainer_cli_desom_on_cpu(capsys, tmp_path):
    results = ttrainer.main([
        "--override", f"train.checkpoint_dir={tmp_path / 'states'}",
        "--override", f"train.log_dir={tmp_path / 'logs'}",
        "--config", MNIST, "--synthetic", "--runs", "1", "--epochs", "1", "--device", "cpu",
        "--batch-size", "16", "--override", "data.synthetic_size=64",
        "--override", "ae.encoder_dims=[32, 10]",
    ])
    assert len(results) == 1 and results[0]["steps"] == 8
    assert 0.0 <= results[0]["purity"] <= 1.0 and np.isfinite(results[0]["last_recon_loss"])
    assert '"mean_std"' in capsys.readouterr().out


def test_static_path_classification_desom_on_cpu():
    """``desom_flowers17.yaml`` (the static 224x224 path, 17 classes)
    narrowed to [16, 10] on 10 + 64 synthetic images: the train rows are
    the eval transform's, held once, and each epoch buffer is a gather of
    them; two epochs of 4-image batches with validation (2 images, ragged)
    and the test eval."""
    cfg = tconfig.load_config(FLOWERS, {"data.allow_synthetic": True,
                                        "data.synthetic_size": 10, "batch_size": 4,
                                        "ae.encoder_dims": [16, 10], "total_epochs": 2,
                                        "train.log_every_n_steps": 100})
    tr = ttrainer.Trainer(cfg, device="cpu")
    dm = tr.dm
    assert isinstance(dm, tpipeline.ClassificationDataModule) and dm.static
    assert dm.augment is None and dm.train_images.shape == (8, 224, 224, 3)
    assert tr.model.autoencoder.encoder.dense_0.weight.shape == (16, 150528)
    hist = tr.fit()
    assert tr.step == 4 and list(hist) == ["train/cls_loss"] + list(tsteps.DESOM_METRIC_KEYS)
    assert np.all(np.isfinite(hist["train/total_loss"]))
    perm = _second_perm(cfg.train.seed, 8)
    assert torch.equal(tr.epoch_images["label"], dm.train_y[perm])
    assert torch.equal(tr.epoch_images["image"], dm.train_images[perm])
    assert [v["epoch"] for v in tr.val_history] == [0, 1]
    assert set(tr.val_history[0]) == {"epoch", "step", "seconds", "val/accuracy"}
    res = tr.evaluate()
    for k in ("accuracy", "precision", "recall", "f1"):
        assert 0.0 <= res[k] <= 1.0, k


def _second_perm(seed, n):
    """The second epoch's permutation of the trainer's shuffle generator."""
    g = torch.Generator().manual_seed(seed)
    torch.randperm(n, generator=g)
    return torch.randperm(n, generator=g)
