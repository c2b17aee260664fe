"""The port's graph-safe train step against the JAX package, on the CPU.

On the card the trainer captures one train step as a CUDA graph and replays
it (``vitsom_tpu_torch/train/trainer.py``); the step reads its step,
schedules, learning rate, temperature and batch from device tensors. The
CPU runs the same step body eagerly. These tests hold, at a small size
(depth 2, an 8x8 map, batch 16, or the slice config of
``tests/test_torch_train.py``):

- the tensor schedules against the host schedules and the JAX schedules;
- the fused SOM op with a tensor temperature against a host float, bitwise;
- the trainer's buffered step (epoch buffer, device index, device state)
  against ``make_vit_som_train_step`` over three steps, at
  ``tests/test_torch_train.py``'s tolerances;
- the metrics buffer, the epoch buffer and a multi-epoch history.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vitsom_tpu.config import OptimizerConfig
from vitsom_tpu.models.vit_som import ViTSOM as JViTSOM
from vitsom_tpu.som import layer as jsom
from vitsom_tpu.train import optim as joptim
from vitsom_tpu.train import schedules as jsched
from vitsom_tpu.train import steps as jsteps
from vitsom_tpu_torch import config as tconfig
from vitsom_tpu_torch import convert
from vitsom_tpu_torch.data.synthetic import DataModule
from vitsom_tpu_torch.ops import som_fused
from vitsom_tpu_torch.som import layer as tsom
from vitsom_tpu_torch.train import optim as toptim
from vitsom_tpu_torch.train import schedules as tsched
from vitsom_tpu_torch.train import steps as tsteps
from vitsom_tpu_torch.train import trainer as ttrainer
from test_torch_train import _capture_grads, _init_params, _slice_cfg

# steps_per_epoch x total_epochs, the warm-up epochs and the ramp end: the
# schedules are evaluated over 0 .. 2 * total
SPE, EPOCHS, WARMUP = 7, 6, 2
TOTAL = SPE * EPOCHS


@pytest.fixture(autouse=True)
def _two_threads():
    """Two intra-op threads: the suite runs several workers on the same
    cores, and torch's default of one thread a core oversubscribes them."""
    threads = torch.get_num_threads()
    torch.set_num_threads(min(threads, 2))
    yield
    torch.set_num_threads(threads)


def _steps():
    return list(range(0, 2 * TOTAL + 1))


# ---------------------------------------------------------------------------
# schedules
# ---------------------------------------------------------------------------


def test_temperature_and_gamma_tensor_schedules_match():
    total_iters = tsom.total_iterations(SPE * 16 + 5, 16, EPOCHS)
    ramp_end = TOTAL // 2
    for step in _steps():
        st = torch.tensor(step)
        t = float(tsom.temperature_schedule_tensor(st, total_iters, 20.0, 0.001))
        np.testing.assert_allclose(
            t, tsom.temperature_schedule(step, total_iters, 20.0, 0.001), rtol=1e-6)
        np.testing.assert_allclose(
            t, float(jsom.temperature_schedule(jnp.asarray(step), total_iters, 20.0, 0.001)),
            rtol=1e-6)
        g = float(tsched.gamma_ramp_tensor(st, 0.005, ramp_end))
        assert g == tsched.gamma_ramp(step, 0.005, ramp_end)
        np.testing.assert_allclose(
            g, float(jsched.gamma_ramp(jnp.asarray(step), 0.005, ramp_end)), rtol=1e-6)
        two_t2 = float(tsom.two_t_squared_tensor(torch.tensor(np.float32(t))))
        assert two_t2 == tsom.two_t_squared(t)
    # the ramp's end and past it
    assert float(tsched.gamma_ramp_tensor(torch.tensor(ramp_end), 0.005, ramp_end)) == \
        pytest.approx(0.005, rel=1e-7)
    assert float(tsched.gamma_ramp_tensor(torch.tensor(2 * TOTAL), 0.005, ramp_end)) == \
        pytest.approx(0.005, rel=1e-7)


@pytest.mark.parametrize(
    "scheduler,warmup", [("cosine_annealing", WARMUP), ("cosine_annealing", 0),
                         ("cosine_simple", 0), ("constant", 0)]
)
def test_lr_tensor_schedule_matches(scheduler, warmup):
    jopt = OptimizerConfig(scheduler=scheduler, warmup_epochs=warmup, min_lr=1e-5)
    topt = tconfig.OptimizerConfig(scheduler=scheduler, warmup_epochs=warmup, min_lr=1e-5)
    j = jsched.make_lr_schedule(jopt, EPOCHS, SPE, 0.005)
    h = tsched.make_lr_schedule(topt, EPOCHS, SPE, 0.005)
    t = tsched.make_lr_schedule_tensor(topt, EPOCHS, SPE, 0.005)
    for step in _steps():
        lr = t(torch.tensor(step))
        assert lr.dtype == torch.float32 and lr.shape == ()
        np.testing.assert_allclose(float(lr), h(step), rtol=1e-6, err_msg=str(step))
        np.testing.assert_allclose(float(lr), float(j(jnp.asarray(step))), rtol=1e-6,
                                   err_msg=str(step))


# ---------------------------------------------------------------------------
# the SOM op with a tensor temperature
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("distance", ["cosine", "euclidean"])
@pytest.mark.parametrize("topology", ["square", "hexa"])
def test_fused_som_tensor_temperature_is_bitwise_the_float_one(distance, topology):
    rng = np.random.default_rng(5)
    x0 = rng.normal(size=(16, 48)).astype(np.float32)
    p0 = rng.normal(size=(64, 48)).astype(np.float32)
    fused = som_fused.make_fused_som((8, 8), topology, distance)
    temperature = tsom.temperature_schedule(37, 400.0, 20.0, 0.001)
    out = {}
    for kind, temp in (("float", temperature),
                       ("tensor", torch.tensor(temperature, dtype=torch.float32))):
        x = torch.from_numpy(x0).requires_grad_()
        p = torch.from_numpy(p0).requires_grad_()
        loss, bmu, dist = fused(x, p, temp)
        loss.backward()
        out[kind] = (loss.detach(), bmu, dist, x.grad, p.grad)
    for a, b, name in zip(out["float"], out["tensor"], ("loss", "bmu", "dist", "dx", "dp")):
        assert torch.equal(a, b), name
    # the plain neighbourhood weights too
    table = torch.from_numpy(tsom.grid_sq_distances((8, 8), topology))
    bmu = out["float"][1]
    assert torch.equal(tsom.neighborhood_weights(bmu, table, temperature),
                       tsom.neighborhood_weights(bmu, table, torch.tensor(np.float32(temperature))))


# ---------------------------------------------------------------------------
# the trainer's buffered step against the JAX train step
# ---------------------------------------------------------------------------


def _slice_trainer(jcfg, params, n_train, seed):
    """A CPU Trainer of the slice config on ``n_train`` images from
    ``seed``, with the JAX package's weights."""
    tcfg = tconfig.config_from_dict(jcfg.to_dict())
    x = np.random.default_rng(seed).uniform(size=(n_train, 28, 28, 1)).astype(np.float32)
    dm = DataModule(tcfg, torch.from_numpy(x), torch.zeros(n_train, dtype=torch.int64))
    tr = ttrainer.Trainer(tcfg, device="cpu", dm=dm)
    tr.model.load_state_dict(convert.flax_to_state_dict(params), strict=True)
    return tcfg, tr


@pytest.mark.parametrize("attn_impl", ["xla", "pallas"])
@pytest.mark.parametrize("remat", [False, True])
def test_buffered_step_matches_jax(attn_impl, remat):
    """Three steps of the trainer's own step (the batch read from the epoch
    buffer at the device index ``step - epoch_start``, the schedules from
    the step tensor, the metrics into the device buffer), as the card's
    eager run and captured step run it, against ``make_vit_som_train_step``
    on the same batches, with ``attn_impl`` on both sides (``pallas``: the
    Pallas kernels in interpret mode against the port's plain versions of
    its CUDA kernels) and block remat off and on. Losses hold at rtol 1e-5
    and the schedule values at rtol 1e-6 at every step, the first step's
    gradients at atol 1e-6 / rtol 1e-4, and the three-step updates at
    0.05 * lr where the two gradients agree (at least 99 % of components;
    ``tests/test_torch_train.py::test_train_steps_match`` gives the
    reasons) and 6 * lr elsewhere."""
    jcfg = _slice_cfg(True, attn_impl=attn_impl, remat=remat)
    params = _init_params()
    batch = jcfg.batch_size
    tcfg, tr = _slice_trainer(jcfg, params, 3 * batch + 1, seed=13)
    spe = tr.dm.steps_per_epoch
    assert spe == 3

    jmodel = JViTSOM(jcfg, attn_impl=attn_impl)
    statics = jsteps.StepStatics(spe, jcfg.total_epochs, tr.dm.n_train, batch)
    jsch = jsched.make_lr_schedule(jcfg.optimizer, jcfg.total_epochs, spe,
                                   joptim.base_learning_rate(jcfg))
    tx = _capture_grads(joptim.make_optimizer(jcfg, params, jsch))
    state = jsteps.TrainState(step=jnp.asarray(0, jnp.int32), params=params,
                              opt_state=tx.init(params))
    jstep = jax.jit(jsteps.make_vit_som_train_step(jcfg, jmodel, tx, statics, jsch))

    named = dict(tr.model.named_parameters())
    start = {name: p.detach().clone() for name, p in named.items()}
    eps = tcfg.optimizer.eps
    agree = {name: torch.ones_like(p, dtype=torch.bool) for name, p in named.items()}
    # one step, then two: each fit starts an epoch and refills the buffer
    hist = {}
    for n in (1, 2):
        first = tr.step
        h = tr.fit(max_steps=first + n)
        for k, v in h.items():
            hist.setdefault(k, []).extend(v)
        for i in range(n):
            x = tr.epoch_images[i * batch:(i + 1) * batch].numpy()
            state, jm = jstep(state, {"image": jnp.asarray(x),
                                      "label": jnp.zeros((batch,), jnp.int32)})
            jm = jax.device_get(jm)
            s = first + i
            for k in ("train/recon_loss", "train/som_loss", "train/total_loss"):
                np.testing.assert_allclose(hist[k][s], float(jm[k]), rtol=1e-5, err_msg=k)
            for k in ("hp/gamma", "hp/temperature", "hp/lr"):
                np.testing.assert_allclose(hist[k][s], float(jm[k]), rtol=1e-6, err_msg=k)
        # the torch gradients are the last step's
        grads = convert.flax_to_state_dict(jax.device_get(state.opt_state[1]))
        for name, g in grads.items():
            tg = named[name].grad
            if first == 0:
                np.testing.assert_allclose(tg.numpy(), g.numpy(), atol=1e-6, rtol=1e-4,
                                           err_msg=name)
            agree[name] &= (tg - g).abs() <= 1e-3 * g.abs().clamp_min(eps)
    assert tr.step == 3 and int(tr.state.step) == 3 and int(tr.state.epoch_start) == 1

    lr = float(hist["hp/lr"][0])
    assert all(v == lr for v in hist["hp/lr"])
    final = convert.flax_to_state_dict(jax.device_get(state.params))
    tight = sum(int(a.sum()) for a in agree.values())
    assert tight >= 0.99 * sum(a.numel() for a in agree.values())
    for name, p in named.items():
        t_upd = (p.detach() - start[name]).numpy()
        j_upd = (final[name] - start[name]).numpy()
        a = agree[name].numpy()
        np.testing.assert_allclose(t_upd[a], j_upd[a], atol=0.05 * lr, rtol=0, err_msg=name)
        np.testing.assert_allclose(t_upd, j_upd, atol=6 * lr, rtol=0, err_msg=name)


# ---------------------------------------------------------------------------
# the metrics buffer, the epoch buffer, the history
# ---------------------------------------------------------------------------


def _small_cfg(size=200, **over):
    return tconfig.load_config(
        "configs/vit_som/vit_som_mnist.yaml",
        {"data.allow_synthetic": True, "data.synthetic_size": size, "batch_size": 16,
         "som.map_size": [8, 8], "vit.depth": 2, "vit.dec_depth": 1, **over},
    )


def test_metrics_buffer_rows_equal_the_step_values():
    """The step body writes row ``step - epoch_start`` of the buffer with
    the values it returns, increments the step tensor, and its schedule
    values are the host schedules' at that step."""
    cfg = _small_cfg()
    tr = ttrainer.Trainer(cfg, device="cpu")
    state = tr.state
    tr.dm.fill_epoch(torch.Generator().manual_seed(3), tr.epoch_images)
    state.epoch_start.fill_(0)
    returned = []
    for i in range(3):
        returned.append(tr._buffered_step().clone())
        assert int(state.step) == i + 1
    rows = state.metrics[:3]
    for i, r in enumerate(returned):
        assert torch.equal(rows[i], r)
        m = tsteps.metrics_dict(r)
        assert list(m) == list(tsteps.METRIC_KEYS)
        np.testing.assert_allclose(m["hp/temperature"], tsom.temperature_schedule(
            i, tr.statics.total_iterations_float, cfg.som.t_max, cfg.som.t_min), rtol=1e-6)
        np.testing.assert_allclose(m["hp/gamma"], tsched.gamma_ramp(
            i, cfg.gamma, tr.statics.ramp_up_end_step), rtol=1e-6)
        np.testing.assert_allclose(m["hp/lr"], tsched.make_lr_schedule(
            cfg.optimizer, cfg.total_epochs, tr.dm.steps_per_epoch,
            toptim.base_learning_rate(cfg))(i), rtol=1e-6)
        np.testing.assert_allclose(m["train/total_loss"],
                                   m["train/recon_loss"] + m["hp/gamma"] * m["train/som_loss"],
                                   rtol=1e-6)
    stacked = tsteps.stack_metrics([rows])
    assert list(stacked) == list(tsteps.METRIC_KEYS)
    for i, k in enumerate(tsteps.METRIC_KEYS):
        np.testing.assert_array_equal(stacked[k], rows[:, i].numpy().astype(np.float64))


def test_epoch_buffer_holds_the_train_batches():
    cfg = _small_cfg(size=100)
    from vitsom_tpu_torch.data.synthetic import build_datamodule

    dm = build_datamodule(cfg, device="cpu")
    buf = dm.epoch_buffer()
    assert buf.shape == (dm.steps_per_epoch * 16, 28, 28, 1)
    g_batches, g_buffer = torch.Generator().manual_seed(4), torch.Generator().manual_seed(4)
    for _ in range(2):  # two epochs: the same draws in the same order
        batches = list(dm.train_batches(g_batches))
        dm.fill_epoch(g_buffer, buf)
        assert torch.equal(buf, torch.cat([b["image"] for b in batches]))
        for i, b in enumerate(batches):
            assert torch.equal(dm.epoch_batch(buf, torch.tensor(i))["image"], b["image"])


def test_fit_history_over_epochs_is_the_host_schedule():
    """A fit across an epoch boundary (and a second fit): the history has
    every step once, with each step's own schedule values, and the eager
    flag changes nothing on the CPU."""
    cfg = _small_cfg(size=100, **{"vit.depth": 1})  # 164 images: 10 steps an epoch
    runs = {}
    for eager in (False, True):
        tr = ttrainer.Trainer(cfg, device="cpu")
        h1 = tr.fit(max_steps=13, eager=eager)
        h2 = tr.fit(max_steps=15, eager=eager)
        assert tr.step == 15 and len(tr.step_ms) == 15
        runs[eager] = {k: np.concatenate([h1[k], h2[k]]) for k in h1}
    for k in tsteps.METRIC_KEYS:
        np.testing.assert_array_equal(runs[False][k], runs[True][k], err_msg=k)
    h = runs[False]
    host_lr = tsched.make_lr_schedule(cfg.optimizer, cfg.total_epochs, 10,
                                      toptim.base_learning_rate(cfg))
    total_iters = tsom.total_iterations(164, 16, cfg.total_epochs)
    for s in range(15):
        np.testing.assert_allclose(h["hp/lr"][s], host_lr(s), rtol=1e-6, err_msg=str(s))
        np.testing.assert_allclose(
            h["hp/temperature"][s],
            tsom.temperature_schedule(s, total_iters, cfg.som.t_max, cfg.som.t_min),
            rtol=1e-6, err_msg=str(s))
    assert h["hp/lr"][9] != h["hp/lr"][10]  # the lr changes at the epoch boundary
    assert np.all(np.isfinite(h["train/total_loss"]))


def test_raw_synthetic_datamodule_takes_cifar():
    """The un-augmented stand-in for clustering on any dataset: the JAX
    package's synthetic arrays, concatenated and scaled to [0, 1]; where
    the dataset's train transform augments, ``build_datamodule`` applies
    it instead (``pipeline.ClusteringDataModule``)."""
    from vitsom_tpu.config import load_config as jload
    from vitsom_tpu.data.datasets import make_synthetic as jmake_synthetic
    from vitsom_tpu_torch.data.pipeline import ClusteringDataModule
    from vitsom_tpu_torch.data.synthetic import build_datamodule, raw_synthetic_datamodule

    path = "configs/vit_som/vit_som_cifar-10.yaml"
    over = {"data.allow_synthetic": True, "data.synthetic_size": 96, "data.num_classes": 0}
    cfg = tconfig.load_config(path, over)
    assert isinstance(build_datamodule(cfg, device="cpu"), ClusteringDataModule)
    dm = raw_synthetic_datamodule(cfg, device="cpu")
    raw = jmake_synthetic(jload(path, over).data)
    x = np.concatenate([raw.train_x, raw.test_x]).astype(np.float32) / 255.0
    assert dm.images.shape == (96 + 64, 32, 32, 3)
    np.testing.assert_allclose(dm.images.numpy(), x, rtol=1e-7)
    np.testing.assert_array_equal(dm.labels.numpy(), np.concatenate([raw.train_y, raw.test_y]))
