"""The port's training path against the JAX package, on the CPU.

Schedules, the optimizer's parameter groups, the synthetic data, the
metrics, the eval step and, for the slice as a whole, three train steps
from shared weights and batches against ``make_vit_som_train_step`` with
``use_pallas_som=True`` (the Pallas kernel in interpret mode).
"""

import functools
import importlib

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from flax import traverse_util

from vitsom_tpu.config import (
    Config, DataConfig, OptimizerConfig, SOMConfig, TrainConfig, ViTConfig,
)
from vitsom_tpu.data.datasets import make_synthetic as jmake_synthetic
from vitsom_tpu.eval import metrics as jmetrics
from vitsom_tpu.models.vit_som import ViTSOM as JViTSOM
from vitsom_tpu.train import optim as joptim
from vitsom_tpu.train import schedules as jsched
from vitsom_tpu.train import steps as jsteps
from vitsom_tpu_torch import config as tconfig
from vitsom_tpu_torch import convert
from vitsom_tpu_torch.data import synthetic as tdata
from vitsom_tpu_torch.eval import metrics as tmetrics
from vitsom_tpu_torch.models.vit_som import ViTSOM as TViTSOM
from vitsom_tpu_torch.ops import attention_fused, som_fused
from vitsom_tpu_torch.train import optim as toptim
from vitsom_tpu_torch.train import schedules as tsched
from vitsom_tpu_torch.train import steps as tsteps
from vitsom_tpu_torch.train import trainer as ttrainer


def _slice_cfg(use_pallas=True, attn_impl="", remat=False, **opt):
    """The config of test_pallas_kernels.py's fused-vs-XLA train-step test."""
    return Config(
        model_arch="vit_som",
        total_epochs=2,
        batch_size=4,
        gamma=0.005,
        som=SOMConfig(map_size=(4, 4), t_max=5.0, t_min=0.1, distance_fcn="cosine"),
        vit=ViTConfig(patch_size=7, emb_dim=16, depth=1, heads=2, dec_emb_dim=8, dec_depth=1),
        data=DataConfig(dataset="mnist", num_classes=0, num_channels=1, input_size=28),
        train=TrainConfig(use_pallas_som=use_pallas, attn_impl=attn_impl, remat_blocks=remat),
        optimizer=OptimizerConfig(**opt),
    ).validate()


@functools.lru_cache(maxsize=None)
def _init_params():
    model = JViTSOM(_slice_cfg())
    return jax.jit(model.init)(jax.random.key(0), jnp.zeros((4, 28, 28, 1)))["params"]


def _torch_model(jcfg, params, attn_impl="xla"):
    tcfg = tconfig.config_from_dict(jcfg.to_dict())
    model = TViTSOM(tcfg, attn_impl=attn_impl)
    model.load_state_dict(convert.flax_to_state_dict(params), strict=True)
    return tcfg, model


# ---------------------------------------------------------------------------
# schedules and optimizer groups
# ---------------------------------------------------------------------------


def test_warmup_cosine_factor_matches():
    for e in (0, 1, 5, 24, 25, 26, 100, 499, 500):
        j = float(jsched.warmup_cosine_epoch_factor(jnp.asarray(e), 25, 500, 1e-5))
        t = tsched.warmup_cosine_epoch_factor(e, 25, 500, 1e-5)
        np.testing.assert_allclose(t, j, rtol=1e-6)
    # min_lr is a floor on the factor, not an absolute learning rate
    assert tsched.warmup_cosine_epoch_factor(500, 25, 500, 1e-5) == pytest.approx(1e-5)


@pytest.mark.parametrize(
    "scheduler,warmup", [("cosine_annealing", 25), ("cosine_annealing", 0),
                         ("cosine_simple", 0), ("constant", 0)]
)
def test_lr_schedule_matches(scheduler, warmup):
    opt = OptimizerConfig(scheduler=scheduler, warmup_epochs=warmup, min_lr=1e-5)
    topt = tconfig.OptimizerConfig(scheduler=scheduler, warmup_epochs=warmup, min_lr=1e-5)
    j = jsched.make_lr_schedule(opt, 500, 38, 0.005)
    t = tsched.make_lr_schedule(topt, 500, 38, 0.005)
    for step in (0, 37, 38, 39, 1000, 18999):
        np.testing.assert_allclose(t(step), float(j(jnp.asarray(step))), rtol=1e-6)


def test_gamma_ramp_matches():
    for it in (0, 1, 500, 9499, 9500, 20000):
        j = float(jsched.gamma_ramp(jnp.asarray(it), 0.005, 9500))
        np.testing.assert_allclose(tsched.gamma_ramp(it, 0.005, 9500), j, rtol=1e-6)


@pytest.mark.parametrize("apply_layer_decay", [False, True])
def test_optimizer_groups_match(apply_layer_decay):
    jcfg = _slice_cfg(apply_layer_decay=apply_layer_decay)
    params = _init_params()
    tcfg, model = _torch_model(jcfg, params)
    for jmap, tmap in (
        (joptim.build_weight_decay_map(params, jcfg), toptim.build_weight_decay_map(model, tcfg)),
        (joptim.build_lr_scale_map(params, jcfg), toptim.build_lr_scale_map(model, tcfg)),
    ):
        flat = traverse_util.flatten_dict(jmap, sep="/")
        names = convert.key_map(flat)
        assert set(names.values()) == set(tmap)
        for k, v in flat.items():
            assert tmap[names[k]] == pytest.approx(float(v), rel=1e-7), k
    assert toptim.base_learning_rate(tcfg) == joptim.base_learning_rate(jcfg)
    opt = toptim.make_optimizer(tcfg, model)
    n = sum(len(g["params"]) for g in opt.param_groups)
    assert n == len(list(model.parameters()))


@pytest.mark.parametrize(
    "opt_type,apply_layer_decay", [("adamw", False), ("adamw", True), ("adam", False)]
)
def test_optimizer_update_matches(opt_type, apply_layer_decay):
    _check_optimizer_update(opt_type, apply_layer_decay)


@pytest.mark.parametrize(
    "opt_type,apply_layer_decay", [("adamw", False), ("adamw", True), ("adam", False)]
)
def test_capturable_optimizer_update_matches(opt_type, apply_layer_decay, monkeypatch):
    """``test_optimizer_update_matches`` with the optimizer the card runs:
    ``capturable=True`` (step counts on the device, bias corrections in
    float32 tensor arithmetic, foreach), each group's lr a tensor written
    in place. torch takes a capturable optimizer on accelerators only, so
    the test lets it take the CPU: the arithmetic is the same code."""
    monkeypatch.setattr(importlib.import_module("torch.optim.adam"),
                        "_get_capturable_supported_devices", lambda supports_xla=True: ["cpu"])
    _check_optimizer_update(opt_type, apply_layer_decay, capturable=True)


def _check_optimizer_update(opt_type, apply_layer_decay, capturable=False):
    """Four updates of the same parameters by the same gradients, the port's
    ``torch.optim.AdamW`` groups against the JAX package's optax chain.

    The gradients are drawn afresh at every step with magnitudes
    log-uniform over [1e-9, 1e-1], so the moments, the bias corrections and
    the placement of eps (near |g| ~ 1e-8) all shape the result; the lr of
    1e-2 makes the decoupled decay (lr * wd * |p| per step) and the layer
    scales (0.75^k) large against the tolerance. Parameters hold at atol
    1e-4 * lr: float32 rounding of the two formulas."""
    jcfg = _slice_cfg(type=opt_type, apply_layer_decay=apply_layer_decay)
    params = _init_params()
    tcfg, model = _torch_model(jcfg, params)
    lr = 1e-2
    tx = joptim.make_optimizer(jcfg, params, lambda count: lr)
    jparams, jstate = params, tx.init(params)
    opt = toptim.make_optimizer(tcfg, model)
    if capturable:
        # the port's groups with the card's settings
        opt = torch.optim.AdamW([{**g, "capturable": True, "foreach": True}
                                 for g in opt.param_groups])
        assert all(torch.is_tensor(g["lr"]) and g["capturable"] for g in opt.param_groups)
    named = dict(model.named_parameters())
    rng = np.random.default_rng(3)
    for _ in range(4):
        flat = {}
        for k, v in traverse_util.flatten_dict(params, sep="/").items():
            mag = 10.0 ** rng.uniform(-9, -1, size=v.shape)
            flat[k] = (rng.choice([-1.0, 1.0], size=v.shape) * mag).astype(np.float32)
        grads = traverse_util.unflatten_dict(flat, sep="/")
        updates, jstate = tx.update(jax.tree_util.tree_map(jnp.asarray, grads), jstate, jparams)
        jparams = optax.apply_updates(jparams, updates)
        toptim.set_learning_rate(opt, torch.tensor(lr))
        for name, g in convert.flax_to_state_dict(grads).items():
            named[name].grad = g
        opt.step()
    if capturable:
        assert all(opt.state[p]["step"].dtype == torch.float32 for p in named.values())
    final = convert.flax_to_state_dict(jax.device_get(jparams))
    for name, p in model.state_dict().items():
        np.testing.assert_allclose(
            p.numpy(), final[name].numpy(), atol=1e-4 * lr, rtol=0, err_msg=name
        )


# ---------------------------------------------------------------------------
# data and metrics
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("size", [64, 300])
def test_synthetic_matches(size):
    kw = dict(dataset="mnist", allow_synthetic=True, synthetic_size=size)
    j = jmake_synthetic(DataConfig(**kw))
    t = tdata.make_synthetic(tconfig.DataConfig(**kw))
    for name in ("train_x", "train_y", "test_x", "test_y"):
        np.testing.assert_array_equal(getattr(t, name), getattr(j, name), err_msg=name)


def test_datamodule_concat_and_batches():
    cfg = tconfig.load_config(
        "configs/vit_som/vit_som_mnist.yaml",
        {"data.allow_synthetic": True, "data.synthetic_size": 100, "batch_size": 16},
    )
    raw = jmake_synthetic(DataConfig(dataset="mnist", allow_synthetic=True, synthetic_size=100))
    dm = tdata.build_datamodule(cfg, device="cpu")
    x = np.concatenate([raw.train_x, raw.test_x]).astype(np.float32) / 255.0
    assert dm.n_train == 164 and dm.steps_per_epoch == 10
    np.testing.assert_allclose(dm.images.numpy(), x, rtol=1e-7)
    np.testing.assert_array_equal(dm.labels.numpy(), np.concatenate([raw.train_y, raw.test_y]))
    batches = list(dm.train_batches(torch.Generator().manual_seed(0)))
    assert len(batches) == 10 and all(b["image"].shape == (16, 28, 28, 1) for b in batches)
    seen = torch.cat([b["label"] for b in batches])
    assert seen.shape == (160,)
    assert sum(1 for _ in dm.eval_batches()) == 10
    assert sum(b["image"].shape[0] for b in dm.eval_batches(drop_last=False)) == 164


def test_metrics_match():
    rng = np.random.default_rng(0)
    y_true = rng.integers(0, 10, size=500)
    y_pred = np.where(rng.random(500) < 0.6, y_true * 3, rng.integers(0, 64, size=500))
    assert tmetrics.purity(y_true, y_pred) == jmetrics.purity(y_true, y_pred)
    assert tmetrics.nmi(y_true, y_pred) == jmetrics.nmi(y_true, y_pred)
    assert tmetrics.purity(y_true, y_true) == 1.0
    assert tmetrics.nmi(y_true, y_true) == pytest.approx(1.0)


# ---------------------------------------------------------------------------
# eval step and the slice as a whole
# ---------------------------------------------------------------------------


def test_eval_step_matches():
    jcfg = _slice_cfg()
    params = _init_params()
    tcfg, tmodel = _torch_model(jcfg, params)
    x = np.random.default_rng(1).uniform(size=(4, 28, 28, 1)).astype(np.float32)
    temp = 2.0
    j = jax.jit(jsteps.make_vit_som_eval_step(jcfg, JViTSOM(jcfg)))(
        params, {"image": jnp.asarray(x), "label": jnp.zeros((4,), jnp.int32)}, jnp.float32(temp)
    )
    t = tsteps.make_vit_som_eval_step(tcfg, tmodel)({"image": torch.from_numpy(x)}, temp)
    np.testing.assert_array_equal(t["bmu"].numpy(), np.asarray(j["bmu"]))
    for k in ("som_loss", "recon_loss", "total_loss"):
        np.testing.assert_allclose(float(t[k]), float(j[k]), rtol=1e-5, atol=1e-6, err_msg=k)


def _capture_grads(tx):
    """Wraps an optax transformation so its state also keeps the last
    gradients it was given."""

    def init(p):
        return tx.init(p), jax.tree_util.tree_map(jnp.zeros_like, p)

    def update(g, state, p=None):
        u, inner = tx.update(g, state[0], p)
        return u, (inner, g)

    return optax.GradientTransformation(init, update)


@pytest.mark.parametrize(
    "use_pallas,attn_impl,remat",
    [
        pytest.param(True, "xla", False, id="True"),
        pytest.param(False, "xla", False, id="False"),
        pytest.param(True, "pallas", False, id="True-pallas"),
        pytest.param(True, "hybrid", False, id="True-hybrid"),
        pytest.param(True, "pallas", True, id="True-pallas-remat"),
    ],
)
def test_train_steps_match(use_pallas, attn_impl, remat):
    """Three steps from the same weights and batches, with the attention
    impl ``attn_impl`` on both sides (``pallas``/``hybrid``: the Pallas
    kernels in interpret mode against the port's plain versions of its CUDA
    kernels) and, in one case, block remat. The first step's
    gradients hold at atol 1e-6 / rtol 1e-4 and every step's losses at
    rtol 1e-5.

    Each parameter's update over the three steps, p_3 - p_0, is held
    against JAX's at atol 0.05 * lr (lr is constant here) on every
    component whose two gradients agree, at each step, to 1e-3 of
    max(|g|, eps). Adam's normalised step g / (|g| + eps) moves by at most
    |dg| * eps / max(|g|, eps)^2 for a gradient change dg, so there the two
    updates differ by ~1e-3 * lr per step, plus float32 rounding of p
    (~1e-2 * lr at |p| ~ 0.5). The other components carry float32 noise:
    the key bias, whose exact gradient is 0 (softmax ignores a logit shift
    shared by all keys), gets |g| ~ 1e-9 of either sign in each framework,
    which Adam turns into a step of up to lr, so they hold only at
    6 * lr = 2 * 3 steps * lr. At least 99 % of the components must be
    held to the tight bound. ``test_optimizer_update_matches`` holds the
    AdamW update itself (moments, eps, decay, layer scales) tightly."""
    jcfg = _slice_cfg(use_pallas, attn_impl=attn_impl, remat=remat)
    xs = np.random.default_rng(7).uniform(size=(3, 4, 28, 28, 1)).astype(np.float32)
    _check_train_steps(jcfg, _init_params(), attn_impl, xs)


def _check_train_steps(jcfg, params, attn_impl, xs):
    """``len(xs)`` steps of both packages from ``params`` on the batches
    ``xs``, held as ``test_train_steps_match`` states."""
    steps, batch = xs.shape[:2]
    jmodel = JViTSOM(jcfg, attn_impl=attn_impl)
    statics = jsteps.StepStatics(steps_per_epoch=steps, total_epochs=2,
                                 dataset_len=steps * batch, batch_size=batch)
    jsch = jsched.make_lr_schedule(jcfg.optimizer, 2, steps, joptim.base_learning_rate(jcfg))
    tx = _capture_grads(joptim.make_optimizer(jcfg, params, jsch))
    state = jsteps.TrainState(
        step=jnp.asarray(0, jnp.int32), params=params, opt_state=tx.init(params)
    )
    jstep = jax.jit(jsteps.make_vit_som_train_step(jcfg, jmodel, tx, statics, jsch))

    tcfg, tmodel = _torch_model(jcfg, params, attn_impl)
    opt = toptim.make_optimizer(tcfg, tmodel)
    tstatics = tsteps.StepStatics(steps, 2, steps * batch, batch)
    base_lr = toptim.base_learning_rate(tcfg)
    tsch = tsched.make_lr_schedule(tcfg.optimizer, 2, steps, base_lr)
    dstate = tsteps.DeviceState("cpu", steps)
    tstep = tsteps.make_vit_som_train_step(
        tcfg, tmodel, opt, tstatics,
        tsched.make_lr_schedule_tensor(tcfg.optimizer, 2, steps, base_lr), dstate,
    )
    named = dict(tmodel.named_parameters())
    start = {name: p.detach().clone() for name, p in named.items()}
    eps = tcfg.optimizer.eps
    agree = {name: torch.ones_like(p, dtype=torch.bool) for name, p in named.items()}

    launches = som_fused.LAUNCHES, attention_fused.LAUNCHES_FWD, attention_fused.LAUNCHES_BWD
    for i in range(steps):
        state, jm = jstep(state, {"image": jnp.asarray(xs[i]), "label": jnp.zeros((batch,), jnp.int32)})
        tm = tsteps.metrics_dict(tstep({"image": torch.from_numpy(xs[i])}))
        assert int(dstate.step) == i + 1
        assert tsteps.metrics_dict(dstate.metrics[i]) == tm
        for k in ("train/recon_loss", "train/som_loss", "train/total_loss"):
            np.testing.assert_allclose(float(tm[k]), float(jm[k]), rtol=1e-5, err_msg=k)
        for k in ("hp/gamma", "hp/temperature", "hp/lr"):
            np.testing.assert_allclose(float(tm[k]), float(jm[k]), rtol=1e-6, err_msg=k)
        grads = convert.flax_to_state_dict(jax.device_get(state.opt_state[1]))
        for name, g in grads.items():
            tg = named[name].grad
            if i == 0:
                np.testing.assert_allclose(tg.numpy(), g.numpy(), atol=1e-6, rtol=1e-4, err_msg=name)
            agree[name] &= (tg - g).abs() <= 1e-3 * g.abs().clamp_min(eps)
    # CPU tensors take the plain versions
    assert (som_fused.LAUNCHES, attention_fused.LAUNCHES_FWD, attention_fused.LAUNCHES_BWD) == launches

    lr = tsch(0)
    assert all(tsch(i) == lr for i in range(steps))
    final = convert.flax_to_state_dict(jax.device_get(state.params))
    tight = sum(int(a.sum()) for a in agree.values())
    assert tight >= 0.99 * sum(a.numel() for a in agree.values())
    for name, p in named.items():
        t_upd = (p.detach() - start[name]).numpy()
        j_upd = (final[name] - start[name]).numpy()
        a = agree[name].numpy()
        np.testing.assert_allclose(t_upd[a], j_upd[a], atol=0.05 * lr, rtol=0, err_msg=name)
        np.testing.assert_allclose(t_upd, j_upd, atol=2 * steps * lr, rtol=0, err_msg=name)


def _cifar10_width_cfg(attn_impl):
    """``configs/vit_som/vit_som_cifar-10.yaml``'s widths (emb 192, 3 heads,
    patch 4 on 32x32x3, decoder emb 96, 4x4 cosine map, SOM latent 64 x
    192), cut to depth 2 / decoder depth 1 and batch 4, on the clustering
    objective (num_classes 0)."""
    return Config(
        model_arch="vit_som",
        total_epochs=2,
        batch_size=4,
        gamma=0.01,
        som=SOMConfig(map_size=(4, 4), t_max=4.0, t_min=0.1, distance_fcn="cosine"),
        vit=ViTConfig(patch_size=4, emb_dim=192, depth=2, heads=3, dec_emb_dim=96, dec_depth=1),
        data=DataConfig(dataset="cifar-10", num_classes=0, num_channels=3, input_size=32),
        train=TrainConfig(use_pallas_som=True, attn_impl=attn_impl),
    ).validate()


@functools.lru_cache(maxsize=None)
def _cifar10_width_params():
    model = JViTSOM(_cifar10_width_cfg("xla"))
    return jax.jit(model.init)(jax.random.key(1), jnp.zeros((4, 32, 32, 3)))["params"]


@pytest.mark.parametrize("attn_impl", ["xla", "pallas"])
def test_cifar10_width_train_steps_match(attn_impl):
    """The slice's new path at the cifar-10 config's widths (head_dim 64 in
    the encoder, 32 in the decoder, N 65): two steps against
    ``make_vit_som_train_step`` from shared weights, with ``attn_impl`` on
    both sides (``pallas``: the Pallas kernels in interpret mode against the
    port's plain versions of its CUDA kernels), held as
    ``test_train_steps_match`` holds the flagship slice."""
    xs = np.random.default_rng(11).uniform(size=(2, 4, 32, 32, 3)).astype(np.float32)
    _check_train_steps(_cifar10_width_cfg(attn_impl), _cifar10_width_params(), attn_impl, xs)


def test_trainer_fits_and_evaluates_on_cpu():
    cfg = tconfig.load_config(
        "configs/vit_som/vit_som_mnist.yaml",
        {"data.allow_synthetic": True, "data.synthetic_size": 200, "batch_size": 16,
         "som.map_size": [6, 6], "vit.depth": 1, "vit.dec_depth": 1},
    )
    tr = ttrainer.Trainer(cfg, device="cpu")
    hist = tr.fit(max_steps=15)
    assert tr.step == 15 and len(tr.step_ms) == 15
    assert hist["train/recon_loss"].shape == (15,)
    assert hist["train/recon_loss"][-1] < hist["train/recon_loss"][0]
    assert np.all(np.isfinite(hist["train/total_loss"]))
    res = tr.evaluate()
    assert 0.0 <= res["purity"] <= 1.0 and 0.0 <= res["nmi"] <= 1.0


def test_trainer_cli_on_cpu(capsys, tmp_path):
    results = ttrainer.main([
        "--override", f"train.checkpoint_dir={tmp_path / 'states'}",
        "--override", f"train.log_dir={tmp_path / 'logs'}",
        "--config", "configs/vit_som/vit_som_mnist.yaml", "--synthetic", "--runs", "1",
        "--max-steps", "2", "--device", "cpu", "--batch-size", "8",
        "--override", "data.synthetic_size=64", "--override", "som.map_size=[4, 4]",
        "--override", "vit.depth=1",
    ])
    assert len(results) == 1 and results[0]["steps"] == 2
    assert '"mean_std"' in capsys.readouterr().out
