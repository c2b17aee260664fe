"""The port's bf16 compute path against the JAX package, on the CPU.

``train.compute_dtype: bfloat16`` with ``train.attn_impl: xla_bf16`` and no
remat is ``bench.py``'s configuration (``bench.py:36-60``). Held here, at a
small size (the flagship's widths, depth 2, an 8x8 map, batch 16):

- the ``xla_bf16`` and ``xla_bf16s`` attention and their gradients against
  ``xla_attention_bf16_scores`` / ``xla_attention_bf16_store`` on the same
  inputs, at ``tests/test_pallas_kernels.py``'s bf16 bounds (:365-379 and
  :411-425), and ``_softmax_f32math_bf16store``'s custom backward;
- the bf16 ViT-SOM forward from converted weights;
- three bf16 train steps against ``make_vit_som_train_step``;
- the port's own bf16-against-f32 drift on overlapped data, with
  ``tests/test_bf16_parity.py``'s protocol and bounds.

bf16 rounds to 8 significant bits. XLA rounds every elementwise op of a bf16
expression (GELU, the softmax, the bias add after a product) to bf16 where
torch's fused bf16 kernels round once, so the two agree to bf16 noise, not
to float32 rounding; each tolerance below says what it holds.
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from flax import traverse_util

from vitsom_tpu.config import load_config as jload
from vitsom_tpu.models.vit_som import ViTSOM as JViTSOM
from vitsom_tpu.ops import attention as jattn
from vitsom_tpu.train import optim as joptim
from vitsom_tpu.train import schedules as jsched
from vitsom_tpu.train import steps as jsteps
from vitsom_tpu_torch import config as tconfig
from vitsom_tpu_torch import convert
from vitsom_tpu_torch.models.vit_som import ViTSOM as TViTSOM
from vitsom_tpu_torch.ops import attention as tattn
from vitsom_tpu_torch.train import optim as toptim
from vitsom_tpu_torch.train import schedules as tsched
from vitsom_tpu_torch.train import steps as tsteps
from test_torch_train import _capture_grads, _init_params, _slice_cfg, _torch_model

FLAGSHIP = "configs/vit_som/vit_som_mnist.yaml"


@pytest.fixture(autouse=True)
def _two_threads():
    """Two intra-op threads: the suite runs several workers on the same
    cores, and torch's default of one thread a core oversubscribes them."""
    threads = torch.get_num_threads()
    torch.set_num_threads(min(threads, 2))
    yield
    torch.set_num_threads(threads)
SMALL = {"som.map_size": [8, 8], "vit.depth": 2, "batch_size": 16, "total_epochs": 2,
         "train.remat_blocks": False}


def _t(a):
    return torch.from_numpy(np.array(a))


def _qkv(seed, shape=(8, 33, 2, 8)):
    rng = np.random.default_rng(seed)
    return tuple(rng.normal(size=shape).astype(np.float32) for _ in range(3))


def _grads(fn, framework, q, k, v):
    """Gradients of sum(o^2) w.r.t. q, k, v as float32 numpy arrays."""
    if framework == "jax":
        def f(q, k, v):
            return jnp.sum(fn(q, k, v)[0].astype(jnp.float32) ** 2)
        return [np.asarray(g, np.float32) for g in
                jax.jit(jax.grad(f, argnums=(0, 1, 2)))(*map(jnp.asarray, (q, k, v)))]
    ts = [_t(x).requires_grad_() for x in (q, k, v)]
    torch.sum(fn(*ts)[0].float() ** 2).backward()
    return [x.grad.float().numpy() for x in ts]


# ---------------------------------------------------------------------------
# attention
# ---------------------------------------------------------------------------

# (port fn, JAX fn, seed, o (atol, rtol), grads (atol, rtol)): the JAX tests'
# own bounds for each impl against the float32 path
ATTN_CASES = {
    "xla_bf16": (tattn.xla_attention_bf16_scores, jattn.xla_attention_bf16_scores, 7,
                 (5e-2, 5e-2), (2e-1, 1e-1)),
    "xla_bf16s": (tattn.xla_attention_bf16_store, jattn.xla_attention_bf16_store, 9,
                  (3e-2, 3e-2), (1e-1, 5e-2)),
}


@pytest.mark.parametrize("impl", list(ATTN_CASES))
def test_bf16_attention_matches_jax(impl):
    """Outputs and gradients against the JAX function on the same inputs,
    and both against the float32 path, at the JAX test's bounds
    (``tests/test_pallas_kernels.py:365-379`` for xla_bf16, ``:411-425``
    for xla_bf16s). The output is float32, as the JAX function's is."""
    tfn, jfn, seed, otol, gtol = ATTN_CASES[impl]
    q, k, v = _qkv(seed)
    o_t, attn = tfn(_t(q), _t(k), _t(v))
    assert attn is None and o_t.dtype == torch.float32
    o_j = np.asarray(jfn(*map(jnp.asarray, (q, k, v)))[0])
    o_ref = np.asarray(jattn.xla_attention(*map(jnp.asarray, (q, k, v)))[0])
    np.testing.assert_allclose(o_t.numpy(), o_j, atol=otol[0], rtol=otol[1])
    np.testing.assert_allclose(o_t.numpy(), o_ref, atol=otol[0], rtol=otol[1])
    g_t = _grads(tfn, "torch", q, k, v)
    g_j = _grads(jfn, "jax", q, k, v)
    g_ref = _grads(jattn.xla_attention, "jax", q, k, v)
    for a, b, c, name in zip(g_t, g_j, g_ref, "qkv"):
        np.testing.assert_allclose(a, b, atol=gtol[0], rtol=gtol[1], err_msg=name)
        np.testing.assert_allclose(a, c, atol=gtol[0], rtol=gtol[1], err_msg=name)


@pytest.mark.parametrize("impl", list(ATTN_CASES))
def test_bf16_attention_dispatch(impl):
    """``multi_head_attention`` takes the bf16 impls, on bf16 inputs too
    (the model's), and falls back to the float32 path with
    ``return_attn``, as ``vitsom_tpu/ops/attention.py:226-254`` does."""
    q, k, v = _qkv(8, (2, 9, 2, 8))
    direct = ATTN_CASES[impl][0](_t(q), _t(k), _t(v))[0]
    out, attn = tattn.multi_head_attention(_t(q), _t(k), _t(v), impl=impl)
    assert attn is None and torch.equal(out, direct)
    out, attn = tattn.multi_head_attention(_t(q), _t(k), _t(v), impl=impl, return_attn=True)
    ref, ref_attn = tattn.xla_attention(_t(q), _t(k), _t(v), return_attn=True)
    assert torch.equal(out, ref) and torch.equal(attn, ref_attn)
    qb, kb, vb = (_t(x).to(torch.bfloat16) for x in (q, k, v))
    out, _ = tattn.multi_head_attention(qb, kb, vb, impl=impl)
    assert out.dtype == torch.float32 and out.shape == q.shape


def test_softmax_f32math_bf16store_custom_backward():
    """The forward and the custom backward of ``SoftmaxF32MathBf16Store``
    against JAX's ``_softmax_f32math_bf16store`` VJP on the same bf16
    scores and cotangent: both compute in float32 and round to bf16 once,
    so they hold to two bf16 ulps (atol/rtol 8e-3, tighter than the JAX
    tests' 3e-2). The only saved tensor is the bf16 probs."""
    rng = np.random.default_rng(11)
    scores = (rng.normal(size=(4, 2, 17, 17)) * 3).astype(np.float32)
    g = rng.normal(size=scores.shape).astype(np.float32)
    s_j = jnp.asarray(scores).astype(jnp.bfloat16)
    p_j, vjp = jax.vjp(jattn._softmax_f32math_bf16store, s_j)
    (ds_j,) = vjp(jnp.asarray(g).astype(jnp.bfloat16))
    s_t = _t(scores).to(torch.bfloat16).requires_grad_()
    p_t = tattn.SoftmaxF32MathBf16Store.apply(s_t)
    saved = p_t.grad_fn.saved_tensors
    assert len(saved) == 1 and saved[0].dtype == torch.bfloat16 and torch.equal(saved[0], p_t)
    p_t.backward(_t(g).to(torch.bfloat16))
    assert p_t.dtype == torch.bfloat16 and s_t.grad.dtype == torch.bfloat16
    np.testing.assert_allclose(p_t.detach().float().numpy(), np.asarray(p_j, np.float32),
                               atol=8e-3, rtol=8e-3)
    np.testing.assert_allclose(s_t.grad.float().numpy(), np.asarray(ds_j, np.float32),
                               atol=8e-3, rtol=8e-3)
    # and against the float32 expression p (g - sum(g p)) on the bf16 probs
    pf = p_t.detach().float()
    gf = _t(g).to(torch.bfloat16).float()
    want = (pf * (gf - (gf * pf).sum(-1, keepdim=True))).to(torch.bfloat16)
    assert torch.equal(s_t.grad, want)


# ---------------------------------------------------------------------------
# the bf16 model
# ---------------------------------------------------------------------------


@functools.lru_cache(maxsize=None)
def _pair(impl, dtype="bfloat16"):
    jcfg = jload(FLAGSHIP, {**SMALL, "train.compute_dtype": dtype, "train.attn_impl": impl})
    tcfg = tconfig.config_from_dict(jcfg.to_dict())
    jmodel = JViTSOM(jcfg, attn_impl=impl)
    params = jax.jit(jmodel.init)(jax.random.key(0), jnp.zeros((2, 28, 28, 1)))["params"]
    tmodel = TViTSOM(tcfg, attn_impl=impl)
    tmodel.load_state_dict(convert.flax_to_state_dict(params), strict=True)
    return jcfg, tcfg, jmodel, params, tmodel


def _rel_l2(a, b):
    return float(np.linalg.norm(a - b) / np.linalg.norm(b))


@pytest.mark.parametrize("impl", ["xla_bf16", "xla_bf16s", "xla", "pallas"])
def test_bf16_vit_som_forward_matches_jax(impl):
    """The bf16 forward (recon, the SOM latent z, the distances, the BMUs)
    from converted weights against the JAX package's. z and the distances
    hold at atol/rtol 5e-2 elementwise (the JAX tests' bf16 attention
    bound) and the BMUs agree on > 0.85 of the rows
    (``tests/test_bf16_parity.py``'s bound). The reconstruction passes the
    emb-4 decoder, whose 4-wide LayerNorms magnify a one-ulp difference:
    there the JAX package's own bf16 recon differs from its float32 one by
    more than 5e-2 on ~0.5 % of the values. So the recon holds at 5e-2 on
    99 % of the values, at a relative L2 error of 5e-2, and no farther
    from JAX's float32 recon than JAX's bf16 recon is (relative L2, x1.5).
    Parameters stay float32; z, the distances and the recon are float32.
    ``pallas`` runs the attention kernels' plain bf16 versions here, JAX's
    Pallas kernels in interpret mode."""
    jcfg, tcfg, jmodel, params, tmodel = _pair(impl)
    x = np.random.default_rng(0).uniform(size=(16, 28, 28, 1)).astype(np.float32)
    assert all(p.dtype == torch.float32 for p in tmodel.parameters())
    _, jrecon, _, jdist, jbmu = jax.jit(jmodel.apply)({"params": params}, jnp.asarray(x))
    jz = jax.jit(lambda p, x: jmodel.apply({"params": p}, x, method="features")[3])(
        params, jnp.asarray(x))
    with torch.no_grad():
        _, trecon, _, tdist, tbmu = tmodel(_t(x))
        tz = tmodel.features(_t(x))[3]
    for a in (trecon, tdist, tz):
        assert a.dtype == torch.float32
    np.testing.assert_allclose(tz.numpy(), np.asarray(jz), atol=5e-2, rtol=5e-2)
    np.testing.assert_allclose(tdist.numpy(), np.asarray(jdist), atol=5e-2, rtol=5e-2)
    assert (tbmu.numpy() == np.asarray(jbmu)).mean() > 0.85
    r_t, r_j = trecon.numpy(), np.asarray(jrecon)
    assert (np.abs(r_t - r_j) <= 5e-2 + 5e-2 * np.abs(r_j)).mean() >= 0.99
    assert _rel_l2(r_t, r_j) <= 5e-2
    j32 = JViTSOM(jload(FLAGSHIP, {**SMALL, "train.compute_dtype": "float32"}), attn_impl="xla")
    r32 = np.asarray(jax.jit(j32.apply)({"params": params}, jnp.asarray(x))[1])
    assert _rel_l2(r_t, r32) <= 1.5 * _rel_l2(r_j, r32)


def test_bf16_train_steps_match_jax():
    """Three bf16 train steps of ``bench.py``'s configuration (xla_bf16, no
    remat, the fused SOM) from shared weights and batches against
    ``make_vit_som_train_step`` (``_check_train_steps``)."""
    _check_train_steps("xla_bf16")


def test_bf16_pallas_train_steps_match_jax():
    """The same three bf16 steps with ``attn_impl: pallas``: the attention
    kernels' plain bf16 versions (forward and backward) here, the JAX
    package's Pallas kernels in interpret mode, at the same bounds."""
    _check_train_steps("pallas")


def _check_train_steps(impl):
    """Three bf16 train steps at ``impl`` from shared weights and batches against
    ``make_vit_som_train_step``. Every step's losses hold at rtol 2e-3
    (bf16 noise reaches 4.2e-4 after one update) and its schedule values at
    rtol 1e-6. The first step's gradients hold elementwise at the JAX
    tests' bf16 gradient bound (atol 2e-1, rtol 1e-1), within 1e-1 of
    JAX's in relative L2 over all parameters, and no farther from JAX's
    float32 gradients than JAX's bf16 gradients are (relative L2, x1.5).
    Adam turns bf16 gradient noise into steps of up to lr, so the
    three-step updates hold at 6 * lr (``tests/test_torch_train.py``'s
    bound for gradients that are noise)."""
    jcfg, tcfg, _, params, _ = _pair(impl)
    tmodel = TViTSOM(tcfg, attn_impl=impl)  # trained here: not the cached one
    tmodel.load_state_dict(convert.flax_to_state_dict(params), strict=True)
    xs = np.random.default_rng(1).uniform(size=(3, 16, 28, 28, 1)).astype(np.float32)
    statics = jsteps.StepStatics(3, 2, 48, 16)
    base_lr = joptim.base_learning_rate(jcfg)
    jsch = jsched.make_lr_schedule(jcfg.optimizer, 2, 3, base_lr)
    tx = _capture_grads(joptim.make_optimizer(jcfg, params, jsch))

    def jax_run(cfg, impl):
        model = JViTSOM(cfg, attn_impl=impl)
        step = jax.jit(jsteps.make_vit_som_train_step(cfg, model, tx, statics, jsch))
        state = jsteps.TrainState(step=jnp.asarray(0, jnp.int32), params=params,
                                  opt_state=tx.init(params))
        return step, state

    jstep, state = jax_run(jcfg, impl)
    opt = toptim.make_optimizer(tcfg, tmodel)
    dstate = tsteps.DeviceState("cpu", 3)
    tstep = tsteps.make_vit_som_train_step(
        tcfg, tmodel, opt, tsteps.StepStatics(3, 2, 48, 16),
        tsched.make_lr_schedule_tensor(tcfg.optimizer, 2, 3, base_lr), dstate)
    named = dict(tmodel.named_parameters())
    start = {n: p.detach().clone() for n, p in named.items()}
    for i in range(3):
        batch = {"image": jnp.asarray(xs[i]), "label": jnp.zeros((16,), jnp.int32)}
        state, jm = jstep(state, batch)
        tm = tsteps.metrics_dict(tstep({"image": _t(xs[i])}))
        for k in ("train/recon_loss", "train/som_loss", "train/total_loss"):
            np.testing.assert_allclose(tm[k], float(jm[k]), rtol=2e-3, err_msg=k)
        for k in ("hp/gamma", "hp/temperature", "hp/lr"):
            np.testing.assert_allclose(tm[k], float(jm[k]), rtol=1e-6, err_msg=k)
        if i == 0:
            g_j = convert.flax_to_state_dict(jax.device_get(state.opt_state[1]))
            g_t = {n: named[n].grad.clone() for n in g_j}
            step32, s32 = jax_run(jload(FLAGSHIP, {**SMALL}), "xla")
            s32, _ = step32(s32, batch)
            g_32 = convert.flax_to_state_dict(jax.device_get(s32.opt_state[1]))
    for n in g_j:
        np.testing.assert_allclose(g_t[n].numpy(), g_j[n].numpy(), atol=2e-1, rtol=1e-1,
                                   err_msg=n)

    def rel(a, b):
        num = sum(float(((a[n] - b[n]) ** 2).sum()) for n in b)
        return (num / sum(float((b[n] ** 2).sum()) for n in b)) ** 0.5

    assert rel(g_t, g_j) <= 1e-1
    assert rel(g_t, g_32) <= 1.5 * rel(g_j, g_32)
    lr = float(jsch(0))
    final = convert.flax_to_state_dict(jax.device_get(state.params))
    for n, p in named.items():
        np.testing.assert_allclose((p.detach() - start[n]).numpy(),
                                   (final[n] - start[n]).numpy(), atol=6 * lr, rtol=0, err_msg=n)


# ---------------------------------------------------------------------------
# the port's own bf16 drift (tests/test_bf16_parity.py's protocol)
# ---------------------------------------------------------------------------


def _overlapped_batch(n=32, seed=0):
    """``tests/test_bf16_parity.py``'s data: templates drowned in noise."""
    rng = np.random.default_rng(seed)
    y = np.arange(n) % 10
    templates = rng.uniform(0, 1, size=(10, 28, 28, 1)).astype(np.float32)
    x = templates[y] * 0.35 + rng.uniform(0, 1, size=(n, 28, 28, 1)).astype(np.float32) * 0.65
    return _t(x)


def _parity_cfg(dtype):
    return tconfig.load_config(FLAGSHIP, {
        "total_epochs": 4, "batch_size": 32, "som.map_size": [8, 8], "vit.depth": 2,
        "train.use_pallas_som": False, "train.compute_dtype": dtype,
    })


@functools.lru_cache(maxsize=None)
def _init_state():
    """The port's initialisation from seed 0 (its JAX-like distributions)."""
    model = TViTSOM(_parity_cfg("float32"))
    model.reset_parameters(torch.Generator().manual_seed(0))
    return {k: v.clone() for k, v in model.state_dict().items()}


@functools.lru_cache(maxsize=None)
def _train(dtype, n_steps=60, snapshot=30):
    """The port's step body, ``n_steps`` steps on one overlapped batch from
    one initialisation (the float32 model's, seeded), as the JAX protocol
    trains (StepStatics(15, 4, 480, 32)). Returns the recon and SOM losses
    and the weights after ``snapshot`` steps (what a ``snapshot``-step run
    of the same protocol ends with: the schedules do not depend on
    ``n_steps``)."""
    cfg = _parity_cfg(dtype)
    model = TViTSOM(cfg)
    model.load_state_dict(_init_state())
    opt = toptim.make_optimizer(cfg, model)
    state = tsteps.DeviceState("cpu", n_steps)
    step = tsteps.make_vit_som_train_step(
        cfg, model, opt, tsteps.StepStatics(15, 4, 480, 32),
        tsched.make_lr_schedule_tensor(cfg.optimizer, 4, 15, toptim.base_learning_rate(cfg)),
        state)
    x = _overlapped_batch()
    weights = None
    for i in range(n_steps):
        step({"image": x})
        if i + 1 == snapshot:
            weights = {k: v.clone() for k, v in model.state_dict().items()}
    h = tsteps.stack_metrics([state.metrics])
    return h["train/recon_loss"], h["train/som_loss"], weights


def test_bf16_tracks_f32_on_overlapped_data():
    """``tests/test_bf16_parity.py::test_bf16_tracks_f32_on_overlapped_data``
    on the port: both dtypes learn, and the terminal losses agree within
    5 % (recon) and 10 % (SOM)."""
    r32, s32, _ = _train("float32")
    r16, s16, _ = _train("bfloat16")
    assert np.isfinite(r16).all() and np.isfinite(s16).all()
    assert r32[-5:].mean() < r32[:5].mean() * 0.9
    assert r16[-5:].mean() < r16[:5].mean() * 0.9
    assert abs(r16[-5:].mean() - r32[-5:].mean()) / r32[-5:].mean() < 0.05
    assert abs(s16[-5:].mean() - s32[-5:].mean()) / max(s32[-5:].mean(), 1e-9) < 0.10


def test_bf16_bmu_assignments_mostly_agree():
    """``tests/test_bf16_parity.py::test_bf16_bmu_assignments_mostly_agree``
    on the port: the float32 model trained 30 steps, its weights run
    through a float32 and a bf16 forward; the BMUs agree on > 0.85."""
    _, _, weights = _train("float32")
    x = _overlapped_batch(seed=7)
    bmus = {}
    for dtype in ("float32", "bfloat16"):
        m = TViTSOM(_parity_cfg(dtype))
        m.load_state_dict(weights)
        with torch.no_grad():
            bmus[dtype] = m(x)[4].numpy()
    assert (bmus["float32"] == bmus["bfloat16"]).mean() > 0.85


# ---------------------------------------------------------------------------
# train.adam_mu_dtype: bfloat16
# ---------------------------------------------------------------------------


def _mu_cfg(opt_type, apply_layer_decay):
    """``tests/test_torch_train.py``'s slice config with a bf16 first moment."""
    jcfg = _slice_cfg(type=opt_type, apply_layer_decay=apply_layer_decay)
    return dataclasses.replace(jcfg, train=dataclasses.replace(jcfg.train,
                                                               adam_mu_dtype="bfloat16"))


@pytest.mark.parametrize(
    "opt_type,apply_layer_decay", [("adamw", False), ("adamw", True), ("adam", False)]
)
def test_bf16_mu_adamw_matches_optax(opt_type, apply_layer_decay):
    """``AdamWBf16Mu`` against the JAX ``make_optimizer`` with
    ``adam_mu_dtype: bfloat16`` (optax's ``scale_by_adam(mu_dtype=
    bfloat16)``), fed the same four gradients (log-uniform magnitudes over
    [1e-9, 1e-1], ``tests/test_torch_train.py``'s draw): after every step
    the bf16 first moment equals JAX's bit for bit and the float32 second
    moment holds within 1 float32 ulp; the parameters hold at that file's
    update bound, atol 1e-4 * lr."""
    jcfg = _mu_cfg(opt_type, apply_layer_decay)
    params = _init_params()
    tcfg, model = _torch_model(jcfg, params)
    lr = 1e-2
    tx = joptim.make_optimizer(jcfg, params, lambda count: lr)
    jparams, jstate = params, tx.init(params)
    opt = toptim.make_optimizer(tcfg, model)
    assert isinstance(opt, toptim.AdamWBf16Mu)
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
        adam = jstate[0]
        mu = convert.flax_to_state_dict(jax.tree_util.tree_map(
            lambda x: np.asarray(x.astype(jnp.float32)), adam.mu))
        nu = convert.flax_to_state_dict(jax.device_get(adam.nu))
        for name, p in named.items():
            st = opt.state[p]
            assert st["exp_avg"].dtype == torch.bfloat16 and st["exp_avg_sq"].dtype == torch.float32
            assert torch.equal(st["exp_avg"].float(), mu[name]), name
            np.testing.assert_array_max_ulp(st["exp_avg_sq"].numpy(), nu[name].numpy(), maxulp=1)
    final = convert.flax_to_state_dict(jax.device_get(jparams))
    for name, p in model.state_dict().items():
        np.testing.assert_allclose(p.numpy(), final[name].numpy(), atol=1e-4 * lr, rtol=0,
                                   err_msg=name)


def test_bf16_mu_adamw_checkpoint_round_trip(tmp_path):
    """The optimizer's state through ``torch.save`` / ``torch.load`` and
    ``load_state_dict`` into a fresh optimizer keeps the first moment bf16
    and its bits, and the two optimizers' next steps agree bit for bit."""
    jcfg = _mu_cfg("adamw", False)
    models = [_torch_model(jcfg, _init_params())[1] for _ in range(2)]
    tcfg = tconfig.config_from_dict(jcfg.to_dict())
    assert tcfg.train.adam_mu_dtype == "bfloat16"
    opts = [toptim.make_optimizer(tcfg, m) for m in models]
    gen = torch.Generator().manual_seed(0)
    grads = [[torch.randn(p.shape, generator=gen) * 1e-2 for p in models[0].parameters()]
             for _ in range(2)]

    def step(model, opt, gs):
        toptim.set_learning_rate(opt, torch.tensor(1e-3))
        for p, g in zip(model.parameters(), gs):
            p.grad = g.clone()
        opt.step()

    step(models[0], opts[0], grads[0])
    torch.save(opts[0].state_dict(), tmp_path / "opt.pt")
    models[1].load_state_dict(models[0].state_dict())
    opts[1].load_state_dict(torch.load(tmp_path / "opt.pt"))
    for p0, p1 in zip(models[0].parameters(), models[1].parameters()):
        m0, m1 = opts[0].state[p0]["exp_avg"], opts[1].state[p1]["exp_avg"]
        assert m1.dtype == torch.bfloat16 and torch.equal(m0, m1)
    for model, opt in zip(models, opts):
        step(model, opt, grads[1])
    for p0, p1 in zip(models[0].parameters(), models[1].parameters()):
        assert torch.equal(p0, p1)
        assert torch.equal(opts[0].state[p0]["exp_avg"], opts[1].state[p1]["exp_avg"])
