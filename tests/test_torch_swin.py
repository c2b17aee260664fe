"""The port's Swin baseline against the JAX package, on the CPU.

Small shapes: embed 24, depths [1, 1] (two blocks: one unshifted, one whose
window covers its map), heads [2, 4], window 4, 10 classes; 16x16 images
at patch 2 (8x8 tokens: the dense-masked path) and 28x28 at patch 4 (7x7
tokens: the windowed path, padded to 8x8, then 4x4 after the merge);
weights carried across with ``vitsom_tpu_torch.convert``, inputs drawn
with numpy from a seed. Held:

- the numpy constants (``dense_attn_constants``, ``shift_attn_mask``,
  ``relative_position_index``) equal the JAX package's exactly;
- the forward at atol/rtol 1e-5, deterministic; the dense path against
  the port's own windowed path at 2e-5 (the JAX test's bound,
  ``tests/test_baselines_learning.py:88-113``), and a block above
  ``DENSE_MAX_TOKENS`` (windowed in the port) against the JAX dense path
  at 2e-5;
- three train steps with drop-path live, both packages fed the same masks
  (a test-local ``jax.random.bernoulli`` and the port's
  ``bernoulli_mask``, one queue), at ``tests/test_torch_cls.py``'s bounds;
  the first step at lr 0 leaves the parameters bitwise unchanged in both;
- the eval step (smoothed CE), the Swin lr schedule (float and tensor) at
  rtol 1e-6, the AdamW group, the converter's round trip, the init
  distributions, the trainer, its command line and a mid-epoch checkpoint
  restore (the dropout generator included).
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from vitsom_tpu.config import load_config as jload_config
from vitsom_tpu.models import swin as jswin
from vitsom_tpu.train import optim as joptim
from vitsom_tpu.train import schedules as jsched
from vitsom_tpu.train import steps as jsteps
from vitsom_tpu_torch import convert
from vitsom_tpu_torch.config import load_config
from vitsom_tpu_torch.models import stochastic
from vitsom_tpu_torch.models import swin as tswin
from vitsom_tpu_torch.models.vit_som import build_model
from vitsom_tpu_torch.train import optim as toptim
from vitsom_tpu_torch.train import schedules as tsched
from vitsom_tpu_torch.train import steps as tsteps
from vitsom_tpu_torch.train import trainer as ttrainer

CIFAR = "configs/swin/swin_cifar-10.yaml"
MEDMNIST = "configs/swin/swin_medmnist.yaml"
SMALL = {"swin.embed_dim": 24, "swin.depths": [1, 1], "swin.num_heads": [2, 4]}
KW = dict(in_chans=3, num_classes=10, embed_dim=24, depths=(1, 1), num_heads=(2, 4), window=4)
# (image size, patch): the dense-masked path, the windowed path with padding
SHAPES = {"dense": (16, 2), "windowed": (28, 4)}
B = 4


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Many small CPU ops: one torch thread per test worker (restored after)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _images(seed, size, n=B):
    return np.random.default_rng(seed).uniform(size=(n, size, size, 3)).astype(np.float32)


def _pair(size, patch, seed=0, **extra):
    """A JAX Swin, its parameters and the port's Swin holding them."""
    kw = dict(KW, img_size=size, patch_size=patch, **extra)
    jm = jswin.SwinTransformer(**kw)
    params = jax.jit(jm.init)(jax.random.key(seed), jnp.zeros((2, size, size, 3)))["params"]
    tm = tswin.SwinTransformer(**kw)
    tm.load_state_dict(convert.baseline_to_state_dict("swin", params), strict=True)
    return jm, params, tm


# ---------------------------------------------------------------------------
# constants and forward
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("h,w,window,shift", [(8, 8, 4, 0), (8, 8, 4, 2), (16, 16, 4, 2),
                                              (4, 8, 2, 1), (12, 12, 4, 2)])
def test_constants_equal_jax(h, w, window, shift):
    tm, ti = tswin.dense_attn_constants(h, w, window, shift)
    jm, ji = jswin.dense_attn_constants(h, w, window, shift)
    np.testing.assert_array_equal(tm, jm)
    np.testing.assert_array_equal(ti, ji)
    assert tm.dtype == jm.dtype and ti.dtype == ji.dtype
    np.testing.assert_array_equal(tswin.relative_position_index(window),
                                  jswin.relative_position_index(window))
    if shift:
        np.testing.assert_array_equal(tswin.shift_attn_mask(h, w, window, shift),
                                      jswin.shift_attn_mask(h, w, window, shift))
    # the one-hot rows gather exactly the table entries the index names
    table = torch.randn((2 * window - 1) ** 2, 3, dtype=torch.float64)
    gathered = tswin.one_hot_rows(ti, table.shape[0]).double() @ table
    assert torch.equal(gathered, table[torch.from_numpy(ti.reshape(-1)).long()])


@pytest.mark.parametrize("path", list(SHAPES))
def test_forward_matches_jax_and_round_trips(path):
    size, patch = SHAPES[path]
    jm, params, tm = _pair(size, patch)
    assert [blk.dense for blk in tm.blocks] == ([True, True] if path == "dense"
                                                else [False, True])
    x = _images(1, size)
    with torch.no_grad():
        t = tm(torch.from_numpy(x)).numpy()
    j = np.asarray(jax.jit(jm.apply)({"params": params}, jnp.asarray(x)))
    assert t.shape == (B, 10)
    np.testing.assert_allclose(t, j, atol=1e-5, rtol=1e-5)
    back, stats = convert.state_dict_to_baseline("swin", tm.state_dict())
    flat = convert.flatten(params)
    assert set(back) == set(flat) and not stats
    for k, v in flat.items():
        np.testing.assert_array_equal(back[k], np.asarray(v), err_msg=k)


def test_dense_matches_windowed_and_large_maps_run_windowed(monkeypatch):
    """The port's dense path against its windowed path on the same
    parameters (32x32, patch 2, depths (2, 2): shifted and unshifted dense
    blocks), and a port whose DENSE_MAX_TOKENS is below the first stage's
    256 tokens (so that stage runs windowed, the second, of 64 tokens,
    dense) against the JAX dense path."""
    size, patch = 32, 2
    kw = dict(KW, img_size=size, patch_size=patch, depths=(2, 2))
    jm = jswin.SwinTransformer(**kw)
    params = jax.jit(jm.init)(jax.random.key(2), jnp.zeros((2, size, size, 3)))["params"]
    sd = convert.baseline_to_state_dict("swin", params)
    dense = tswin.SwinTransformer(**kw)
    windowed = tswin.SwinTransformer(**kw, force_windowed=True)
    monkeypatch.setattr(tswin, "DENSE_MAX_TOKENS", 64)
    capped = tswin.SwinTransformer(**kw)
    assert [b.dense for b in dense.blocks] == [True] * 4
    assert [b.dense for b in capped.blocks] == [False, False, True, True]
    assert not any(b.dense for b in windowed.blocks) and dense.blocks[1].shift == 2
    x = _images(3, size)
    outs = {}
    for name, m in (("dense", dense), ("windowed", windowed), ("capped", capped)):
        m.load_state_dict(sd, strict=True)
        with torch.no_grad():
            outs[name] = m(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(outs["dense"], outs["windowed"], rtol=2e-5, atol=2e-5)
    j = np.asarray(jax.jit(jm.apply)({"params": params}, jnp.asarray(x)))
    np.testing.assert_allclose(outs["capped"], j, rtol=2e-5, atol=2e-5)
    np.testing.assert_allclose(outs["dense"], j, rtol=1e-5, atol=1e-5)


# ---------------------------------------------------------------------------
# train steps with drop-path live
# ---------------------------------------------------------------------------


class SharedMasks:
    """Bernoulli masks both packages share: the k-th draw of step ``step``
    is ``default_rng([seed, step, k]).random(shape) < keep`` in either. The
    JAX step is traced once; its ``jax.random.bernoulli`` stand-in numbers
    its calls in trace order and fetches each mask at run time through a
    callback, for the step ``self.step`` names then. The shapes and rates
    asked for are recorded, so both sequences can be compared."""

    def __init__(self, seed):
        self.seed = seed
        self.step = 0
        self.port_k = 0
        self.calls = {"jax": [], "port": []}

    def mask(self, step, k, keep, shape):
        return np.random.default_rng([self.seed, step, k]).random(tuple(shape)) < keep

    def next_step(self, step):
        self.step, self.port_k = step, 0

    def install(self, monkeypatch):
        def jax_bernoulli(key, p=0.5, shape=None, mode=None):
            k, keep, shape = len(self.calls["jax"]), float(p), tuple(int(s) for s in shape)
            self.calls["jax"].append((shape, round(keep, 7)))
            return jax.pure_callback(lambda: self.mask(self.step, k, keep, shape),
                                     jax.ShapeDtypeStruct(shape, jnp.bool_))

        def port_mask(keep, shape, generator, device):
            assert generator is not None
            shape = tuple(int(s) for s in shape)
            self.calls["port"].append((shape, round(float(keep), 7)))
            m = self.mask(self.step, self.port_k, float(keep), shape)
            self.port_k += 1
            return torch.from_numpy(m).to(device)

        monkeypatch.setattr(jax.random, "bernoulli", jax_bernoulli)
        monkeypatch.setattr(stochastic, "bernoulli_mask", port_mask)


def capture_grads(tx):
    """An optax transformation whose state also keeps the last gradients."""

    def init(p):
        return tx.init(p), jax.tree_util.tree_map(jnp.zeros_like, p)

    def update(g, state, p=None):
        u, inner = tx.update(g, state[0], p)
        return u, (inner, g)

    return optax.GradientTransformation(init, update)


def check_three_steps(tcfg, tmodel, jstep_fn, tstep_fn, batches, lr_max, keys, to_state_dict,
                      masks):
    """Runs both packages' steps on ``batches`` and holds them as
    ``tests/test_torch_cls.py`` does: losses rtol 1e-5, lr rtol 1e-6, the
    first step's gradients atol 1e-6 / rtol 1e-4, each update at 0.05 *
    lr where the gradients agree to 1e-3 (at least 99 % of components) and
    2 * steps * lr elsewhere (lr: the largest of the steps'). Returns the
    per-step parameter snapshots of the port."""
    state, jstep = jstep_fn[0], jax.jit(jstep_fn[1])
    named = dict(tmodel.named_parameters())
    start = {n: p.detach().clone() for n, p in named.items()}
    agree = {n: torch.ones_like(p, dtype=torch.bool) for n, p in named.items()}
    eps = tcfg.optimizer.eps
    snaps = []
    losses = [k for k in keys if k.endswith("_loss")]
    for i, (x, y) in enumerate(batches):
        masks.next_step(i)
        state, jm = jstep(state, {"image": jnp.asarray(x), "label": jnp.asarray(y, jnp.int32)})
        row = tstep_fn({"image": torch.from_numpy(x), "label": torch.from_numpy(y)})
        tm = tsteps.metrics_dict(row, keys)
        for k in losses:
            np.testing.assert_allclose(tm[k], float(jm[k]), rtol=1e-5, err_msg=k)
        np.testing.assert_allclose(tm["hp/lr"], float(jm["hp/lr"]), rtol=1e-6)
        grads = to_state_dict(jax.device_get(state.opt_state[1]))
        assert set(grads) == set(named)
        for name, g in grads.items():
            tg = named[name].grad
            if i == 0:
                np.testing.assert_allclose(tg.numpy(), g.numpy(), atol=1e-6, rtol=1e-4,
                                           err_msg=name)
            agree[name] &= (tg - g).abs() <= 1e-3 * g.abs().clamp_min(eps)
        snaps.append({n: p.detach().clone() for n, p in named.items()})
    final = to_state_dict(jax.device_get(state.params))
    tight = sum(int(a.sum()) for a in agree.values())
    assert tight >= 0.99 * sum(a.numel() for a in agree.values())
    steps = len(batches)
    for name, p in named.items():
        t_upd = (p.detach() - start[name]).numpy()
        j_upd = (final[name] - start[name]).numpy()
        a = agree[name].numpy()
        np.testing.assert_allclose(t_upd[a], j_upd[a], atol=0.05 * lr_max, rtol=0, err_msg=name)
        np.testing.assert_allclose(t_upd, j_upd, atol=2 * steps * lr_max, rtol=0, err_msg=name)
    return start, snaps, final


@pytest.mark.parametrize("path", list(SHAPES))
def test_train_steps_match_with_drop_path(path, monkeypatch):
    """Three Swin steps, one a epoch with one warm-up epoch: step 0 runs at
    lr 0 (the parameters stay bitwise as they were in both packages),
    steps 1-2 on the cosine. Drop-path rates linspace(0, 0.1, 2): the
    second block draws two [B, 1, 1] masks a step."""
    size, patch = SHAPES[path]
    over = {**SMALL, "batch_size": B, "total_epochs": 4, "optimizer.warmup_epochs": 1,
            "optimizer.lr": 0.01, "data.input_size": size, "swin.patch_size": patch}
    jcfg = jload_config(CIFAR, over)
    tcfg = load_config(CIFAR, over)
    jm = jswin.build_swin(jcfg)
    params = jax.jit(jm.init)(jax.random.key(4), jnp.zeros((2, size, size, 3)))["params"]
    tmodel = build_model(tcfg, "cpu")
    tmodel.load_state_dict(convert.baseline_to_state_dict("swin", params), strict=True)
    base = joptim.base_learning_rate(jcfg)
    jsch = jsched.make_swin_lr_schedule(jcfg.optimizer, 4, 1, base)
    tx = capture_grads(joptim.make_optimizer(jcfg, params, jsch))
    state = jsteps.TrainState(step=jnp.asarray(0, jnp.int32), params=params,
                              opt_state=tx.init(params))
    masks = SharedMasks(11)
    masks.install(monkeypatch)
    jstep = jsteps.make_classifier_train_step(jcfg, jm, tx, jsch, jcfg.optimizer.smoothing)
    opt = toptim.make_optimizer(tcfg, tmodel)
    tsch = tsched.make_swin_lr_schedule_tensor(tcfg.optimizer, 4, 1, base)
    dstate = tsteps.DeviceState("cpu", 3, tsteps.metric_keys(tcfg))
    tstep = tsteps.make_classifier_train_step(tcfg, tmodel, opt, tsch, tcfg.optimizer.smoothing,
                                              dstate, torch.Generator())
    rng = np.random.default_rng(5)
    batches = [(_images(20 + i, size), rng.integers(0, 10, size=B)) for i in range(3)]
    lr_max = max(float(tsch(torch.tensor(s))) for s in range(3))
    start, snaps, _ = check_three_steps(
        tcfg, tmodel, (state, jstep), tstep, batches, lr_max, dstate.keys,
        lambda p: convert.baseline_to_state_dict("swin", p), masks)
    assert float(tsch(torch.tensor(0))) == 0.0 < lr_max
    assert all(torch.equal(snaps[0][n], start[n]) for n in start)
    # traced once: the JAX step's two draws, the port's two a step
    assert masks.calls["jax"] == [((B, 1, 1), 0.9)] * 2
    assert masks.calls["port"] == masks.calls["jax"] * 3
    assert not masks.mask(1, 0, 0.9, (B, 1, 1)).all()  # step 1 drops samples
    assert not torch.equal(snaps[2]["head.weight"], start["head.weight"])


def test_eval_step_smoothed_ce_matches_jax():
    size, patch = SHAPES["dense"]
    over = {**SMALL, "data.input_size": size, "swin.patch_size": patch}
    jcfg, tcfg = jload_config(CIFAR, over), load_config(CIFAR, over)
    jm = jswin.build_swin(jcfg)
    params = jax.jit(jm.init)(jax.random.key(6), jnp.zeros((2, size, size, 3)))["params"]
    tmodel = build_model(tcfg, "cpu")
    tmodel.load_state_dict(convert.baseline_to_state_dict("swin", params), strict=True)
    x = _images(7, size)
    y = np.random.default_rng(8).integers(0, 10, size=B)
    j = jax.jit(jsteps.make_classifier_eval_step(jcfg, jm))(
        params, {"image": jnp.asarray(x), "label": jnp.asarray(y, jnp.int32)})
    t = tsteps.make_classifier_eval_step(tcfg, tmodel)(
        {"image": torch.from_numpy(x), "label": torch.from_numpy(y)})
    assert jcfg.optimizer.smoothing == 0.1
    for k in ("logits", "cls_loss"):
        np.testing.assert_allclose(t[k].numpy(), np.asarray(j[k]), atol=1e-5, rtol=1e-5,
                                   err_msg=k)
    plain = float(tsteps.cross_entropy(t["logits"], torch.from_numpy(y)))
    assert abs(plain - float(t["cls_loss"])) > 1e-4  # the smoothing is in


# ---------------------------------------------------------------------------
# schedule, optimizer, init
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("yaml", [CIFAR, MEDMNIST])
def test_swin_lr_schedule_matches_jax(yaml):
    """Every third step of a 500-epoch, 7-step-an-epoch run, float and
    tensor forms at rtol 1e-6, or within 1e-6 of the base lr near the
    1e-6 floor (where the float32 cosines of the two libraries round
    apart by up to 1.5e-11); epoch 0 is 0."""
    jcfg, tcfg = jload_config(yaml), load_config(yaml)
    base = joptim.base_learning_rate(jcfg)
    assert base == toptim.base_learning_rate(tcfg) == 5e-4
    steps = np.arange(0, 500 * 7, 3)
    j = np.asarray(jax.vmap(jsched.make_swin_lr_schedule(jcfg.optimizer, 500, 7, base))(
        jnp.asarray(steps)))
    f = tsched.make_swin_lr_schedule(tcfg.optimizer, 500, 7, base)
    t = tsched.make_swin_lr_schedule_tensor(tcfg.optimizer, 500, 7, base)
    host = np.array([f(int(s)) for s in steps])
    dev = t(torch.from_numpy(steps)).numpy()
    np.testing.assert_allclose(host, j, rtol=1e-6, atol=1e-6 * base)
    np.testing.assert_allclose(dev, j, rtol=1e-6, atol=1e-6 * base)
    assert f(0) == f(6) == 0.0 and float(t(torch.tensor(6))) == 0.0
    warm = tcfg.optimizer.warmup_epochs
    np.testing.assert_allclose(f(7), base / warm, rtol=1e-6)


@pytest.mark.parametrize("yaml", [CIFAR, "configs/deit/deit_cifar-10.yaml"])
def test_baselines_adamw_is_one_flat_group(yaml):
    """Weight decay on every tensor, norms and biases included, one group,
    at the raw lr (no x B / 256), as the JAX optimizer builds it."""
    over = SMALL if "swin" in yaml else {"vit.depth": 1, "vit.emb_dim": 32, "vit.heads": 2}
    jcfg, tcfg = jload_config(yaml, over), load_config(yaml, over)
    model = build_model(tcfg, "cpu")
    wd = toptim.build_weight_decay_map(model, tcfg)
    assert set(wd.values()) == {tcfg.optimizer.weight_decay} and len(wd) == len(
        list(model.parameters()))
    jm = jswin.build_swin(jcfg) if "swin" in yaml else None
    if jm is not None:
        params = jax.eval_shape(jm.init, jax.random.key(0), jnp.zeros((2, 32, 32, 3)))["params"]
        jwd = convert.flatten(joptim.build_weight_decay_map(params, jcfg))
        assert set(jwd.values()) == {jcfg.optimizer.weight_decay} and len(jwd) == len(wd)
    opt = toptim.make_optimizer(tcfg, model)
    assert len(opt.param_groups) == 1
    g = opt.param_groups[0]
    assert g["weight_decay"] == tcfg.optimizer.weight_decay and g["lr_scale"] == 1.0
    assert float(g["lr"]) == pytest.approx(tcfg.optimizer.lr, rel=1e-7)


def test_built_swin_has_jax_init_distributions():
    tcfg = load_config(CIFAR)
    model = build_model(tcfg, "cpu", seed=0)
    names = set(convert.state_dict_to_baseline("swin", model.state_dict())[0])
    jm = jswin.build_swin(jload_config(CIFAR))
    shapes = jax.eval_shape(jm.init, jax.random.key(0), jnp.zeros((2, 32, 32, 3)))["params"]
    jflat = convert.flatten(shapes)
    assert names == set(jflat)
    back = convert.state_dict_to_baseline("swin", model.state_dict())[0]
    for k, v in jflat.items():
        assert back[k].shape == v.shape, k
    with torch.no_grad():
        for name, p in model.named_parameters():
            if name.endswith("bias"):
                assert not p.any(), name
            elif p.ndim == 1:
                assert torch.equal(p, torch.ones_like(p)), name
            elif p.numel() >= 2000:
                assert abs(float(p.std()) - 0.02) < 0.002, name
                assert abs(float(p.mean())) < 0.002, name
    assert sum(p.numel() for p in model.parameters()) == sum(
        int(np.prod(v.shape)) for v in jflat.values())
    # every block's drop-path rate, as the JAX linspace gives them
    np.testing.assert_allclose([b.drop_path.rate for b in model.blocks],
                               np.linspace(0, 0.1, 12), rtol=0, atol=0)


# ---------------------------------------------------------------------------
# compute_dtype bfloat16
# ---------------------------------------------------------------------------


def check_three_steps_bf16(tmodel, jstep_fn, tstep_fn, batches, lr_max, keys, to_state_dict,
                           masks):
    """Both packages' bf16 steps on ``batches``, held at
    ``tests/test_torch_bf16.py``'s bf16 bounds: losses rtol 2e-3, lr rtol
    1e-6, the first step's gradients elementwise at atol 2e-1 / rtol 1e-1
    and within 1e-1 in relative L2 over all parameters, the three-step
    updates at 6 * lr (Adam turns bf16 gradient noise into steps of up to
    lr). Parameters stay float32 in both."""
    state, jstep = jstep_fn[0], jax.jit(jstep_fn[1])
    named = dict(tmodel.named_parameters())
    assert all(p.dtype == torch.float32 for p in named.values())
    start = {n: p.detach().clone() for n, p in named.items()}
    losses = [k for k in keys if k.endswith("_loss")]
    for i, (x, y) in enumerate(batches):
        masks.next_step(i)
        state, jm = jstep(state, {"image": jnp.asarray(x), "label": jnp.asarray(y, jnp.int32)})
        row = tstep_fn({"image": torch.from_numpy(x), "label": torch.from_numpy(y)})
        tm = tsteps.metrics_dict(row, keys)
        for k in losses:
            np.testing.assert_allclose(tm[k], float(jm[k]), rtol=2e-3, err_msg=k)
        np.testing.assert_allclose(tm["hp/lr"], float(jm["hp/lr"]), rtol=1e-6)
        if i == 0:
            grads = to_state_dict(jax.device_get(state.opt_state[1]))
            assert set(grads) == set(named)
            num = den = 0.0
            for name, g in grads.items():
                tg = named[name].grad
                np.testing.assert_allclose(tg.numpy(), g.numpy(), atol=2e-1, rtol=1e-1,
                                           err_msg=name)
                num += float(((tg - g) ** 2).sum())
                den += float((g ** 2).sum())
            assert (num / den) ** 0.5 <= 1e-1
    final = to_state_dict(jax.device_get(state.params))
    for name, p in named.items():
        np.testing.assert_allclose((p.detach() - start[name]).numpy(),
                                   (final[name] - start[name]).numpy(), atol=6 * lr_max, rtol=0,
                                   err_msg=name)


@pytest.mark.parametrize("path,impl", [("dense", "xla"), ("windowed", "xla"),
                                       ("dense", "xla_bf16"), ("dense", "xla_bf16s")])
def test_bf16_forward_matches_jax(path, impl):
    """``compute_dtype: bfloat16`` (the JAX scoreboard's Swin row sets it
    with ``xla_bf16``): logits from converted weights at atol/rtol 5e-2
    (``tests/test_torch_bf16.py``'s bound), float32 logits from float32
    parameters, and the bf16 stream inside."""
    size, patch = SHAPES[path]
    kw = dict(KW, img_size=size, patch_size=patch, attn_impl=impl)
    jm = jswin.SwinTransformer(**kw, dtype=jnp.bfloat16)
    params = jax.jit(jm.init)(jax.random.key(0), jnp.zeros((2, size, size, 3)))["params"]
    tm = tswin.SwinTransformer(**kw, dtype=torch.bfloat16)
    tm.load_state_dict(convert.baseline_to_state_dict("swin", params), strict=True)
    assert all(p.dtype == torch.float32 for p in tm.parameters())
    seen = []
    tm.blocks[0].register_forward_hook(lambda m, i, o: seen.append(o.dtype))
    x = _images(1, size)
    with torch.no_grad():
        t = tm(torch.from_numpy(x))
    j = np.asarray(jax.jit(jm.apply)({"params": params}, jnp.asarray(x)))
    assert t.dtype == torch.float32 and j.dtype == np.float32 and seen == [torch.bfloat16]
    np.testing.assert_allclose(t.numpy(), j, atol=5e-2, rtol=5e-2)


def test_bf16_train_steps_match_jax(monkeypatch):
    """Three bf16 Swin steps with the scoreboard's overrides
    (``experiments/run_family_bench.py``: bfloat16, ``xla_bf16``) on the
    dense path, drop-path live with shared masks, at the bf16 bounds."""
    size, patch = SHAPES["dense"]
    over = {**SMALL, "batch_size": B, "total_epochs": 4, "optimizer.warmup_epochs": 1,
            "optimizer.lr": 0.01, "data.input_size": size, "swin.patch_size": patch,
            "train.compute_dtype": "bfloat16", "train.attn_impl": "xla_bf16"}
    jcfg = jload_config(CIFAR, over)
    tcfg = load_config(CIFAR, over)
    jm = jswin.build_swin(jcfg)
    params = jax.jit(jm.init)(jax.random.key(4), jnp.zeros((2, size, size, 3)))["params"]
    tmodel = build_model(tcfg, "cpu")
    assert tmodel.dtype == torch.bfloat16 and tmodel.blocks[0].attn.attn_impl == "xla_bf16"
    tmodel.load_state_dict(convert.baseline_to_state_dict("swin", params), strict=True)
    base = joptim.base_learning_rate(jcfg)
    jsch = jsched.make_swin_lr_schedule(jcfg.optimizer, 4, 1, base)
    tx = capture_grads(joptim.make_optimizer(jcfg, params, jsch))
    state = jsteps.TrainState(step=jnp.asarray(0, jnp.int32), params=params,
                              opt_state=tx.init(params))
    masks = SharedMasks(11)
    masks.install(monkeypatch)
    jstep = jsteps.make_classifier_train_step(jcfg, jm, tx, jsch, jcfg.optimizer.smoothing)
    opt = toptim.make_optimizer(tcfg, tmodel)
    tsch = tsched.make_swin_lr_schedule_tensor(tcfg.optimizer, 4, 1, base)
    dstate = tsteps.DeviceState("cpu", 3, tsteps.metric_keys(tcfg))
    tstep = tsteps.make_classifier_train_step(tcfg, tmodel, opt, tsch, tcfg.optimizer.smoothing,
                                              dstate, torch.Generator())
    rng = np.random.default_rng(5)
    batches = [(_images(20 + i, size), rng.integers(0, 10, size=B)) for i in range(3)]
    lr_max = max(float(tsch(torch.tensor(s))) for s in range(3))
    check_three_steps_bf16(tmodel, (state, jstep), tstep, batches, lr_max, dstate.keys,
                           lambda p: convert.baseline_to_state_dict("swin", p), masks)
    assert masks.calls["port"] == masks.calls["jax"] * 3


# ---------------------------------------------------------------------------
# the trainer, its command line and a checkpoint restore
# ---------------------------------------------------------------------------


def _trainer_cfg(tmp_path, path=CIFAR, **extra):
    over = {**SMALL, "batch_size": 8, "data.allow_synthetic": True, "data.synthetic_size": 40,
            "total_epochs": 3, "optimizer.warmup_epochs": 1,
            "train.checkpoint_dir": str(tmp_path / "states"),
            "train.log_dir": str(tmp_path / "logs"), **extra}
    return load_config(path, over)


@pytest.mark.parametrize("path", [CIFAR, MEDMNIST])
def test_trainer_fits_swin_on_cpu(path, tmp_path):
    """Two epochs of 4 steps (``swin_medmnist`` takes the windowed path):
    epoch 0 at lr 0 leaves every parameter bitwise as built; epoch 1
    trains at base_lr / warmup; validation after each epoch; test metrics
    in [0, 1]."""
    extra = {"swin.depths": [2, 2]} if path == MEDMNIST else {}
    cfg = _trainer_cfg(tmp_path, path, **extra)
    tr = ttrainer.Trainer(cfg, device="cpu")
    if path == MEDMNIST:
        assert [b.dense for b in tr.model.blocks] == [False, False, True, True]
    start = {n: p.detach().clone() for n, p in tr.model.named_parameters()}
    hist = tr.fit(max_steps=4)
    assert all(torch.equal(p, start[n]) for n, p in tr.model.named_parameters())
    hist2 = tr.fit(max_steps=8, new_epoch=False)
    assert list(hist) == list(tsteps.CLASSIFIER_METRIC_KEYS)
    assert np.all(hist["hp/lr"] == 0.0)
    np.testing.assert_allclose(hist2["hp/lr"], cfg.optimizer.lr, rtol=1e-6)
    assert np.all(np.isfinite(np.concatenate([hist["train/cls_loss"],
                                              hist2["train/cls_loss"]])))
    assert not all(torch.equal(p, start[n]) for n, p in tr.model.named_parameters())
    assert [v["epoch"] for v in tr.val_history] == [0, 1]
    res = tr.evaluate()
    for k in ("accuracy", "precision", "recall", "f1"):
        assert 0.0 <= res[k] <= 1.0, k


def test_trainer_cli_swin_on_cpu(capsys, tmp_path):
    results = ttrainer.main([
        "--config", CIFAR, "--synthetic", "--runs", "1", "--max-steps", "2", "--device", "cpu",
        "--batch-size", "8", "--override", "data.synthetic_size=40",
        "--override", f"train.checkpoint_dir={tmp_path / 'states'}",
        "--override", f"train.log_dir={tmp_path / 'logs'}",
        "--override", "swin.embed_dim=24", "--override", "swin.depths=[1, 1]",
        "--override", "swin.num_heads=[2, 4]",
    ])
    assert len(results) == 1 and results[0]["steps"] == 2
    assert 0.0 <= results[0]["accuracy"] <= 1.0 and np.isfinite(results[0]["first_cls_loss"])
    out = capsys.readouterr().out
    assert "model=swin" in out and '"mean_std"' in out


def test_restore_continues_with_the_dropout_generator(tmp_path):
    """Save at step 6 (mid-epoch 1, after the lr-0 epoch), step to 10
    (crossing an epoch): state S. The same trainer restored to step 6
    (its generator moved on meanwhile) and a fresh one reach S bitwise;
    the restored dropout generator equals the saved one, and without it
    the masks differ."""
    cfg = _trainer_cfg(tmp_path, **{"optimizer.lr": 0.01})
    tr = ttrainer.Trainer(cfg, device="cpu")
    tr.fit(max_steps=6)
    saved_rng = tr._dropout.get_state()
    tr.save_checkpoint("mid")
    tr.fit(max_steps=10, new_epoch=False)
    s = {n: p.detach().clone() for n, p in tr.model.named_parameters()}
    assert not torch.equal(tr._dropout.get_state(), saved_rng)

    tr.restore_checkpoint("mid")
    assert torch.equal(tr._dropout.get_state(), saved_rng) and tr.step == 6
    tr.fit(max_steps=10)
    assert all(torch.equal(p, s[n]) for n, p in tr.model.named_parameters())

    fresh = ttrainer.Trainer(cfg, device="cpu")
    fresh.restore_checkpoint("mid")
    fresh.fit(max_steps=10)
    assert all(torch.equal(p, s[n]) for n, p in fresh.model.named_parameters())

    other = ttrainer.Trainer(cfg, device="cpu")
    other.restore_checkpoint("mid")
    other._dropout.manual_seed(123)
    other.fit(max_steps=10)
    assert not all(torch.equal(p, s[n]) for n, p in other.model.named_parameters())
    assert os.path.exists(os.path.join(tr.checkpoint_dir("mid"), "state.pt"))
