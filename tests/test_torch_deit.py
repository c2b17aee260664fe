"""The port's DeiT baseline and its ResNet teacher against the JAX package,
on the CPU.

Small shapes: the student at emb 32, depth 2, 2 heads (head_dim 64: inner
128), patch 4 at 32x32 (65 tokens, 66 with the distill token), 10
classes; weights carried across with ``vitsom_tpu_torch.convert``, inputs
drawn with numpy from a seed. Held:

- the eval forward and ``train_forward`` at atol/rtol 1e-5, and the
  converter's exact round trip;
- ``soft_distill_loss`` and the hard branch's CE at rtol 1e-6;
- the ResNet-50 teacher's batch-statistics logits at 32x32, B 4: the
  observed max|port - JAX| is 0.0168 (logits up to 4.3); at that size the
  last stage normalises over 4 values of a 1x1 map, where mean(x^2) -
  mean(x)^2 cancels, so both packages sit far from float64. The bound: the
  port within 0.05 of JAX and no farther from a float64 evaluation than
  JAX is (observed 0.0039 against 0.0174); nothing is written back to the
  running statistics;
- ``load_torch_resnet50``: the name map is total over a torchvision
  state_dict, each mapped tensor equals what the JAX loader reads, a shape
  mismatch, a missing module and a left-over tensor raise;
- three train steps with dropout live (49 sites at full depth, 9 here),
  both packages fed the same masks, soft and hard, at
  ``tests/test_torch_cls.py``'s bounds. The teacher there is the JAX
  package's ``ResNet`` at one basic block (a test-local stand-in for
  ``resnet50`` in both), whose batch statistics at 8x8 are well
  conditioned, so the distillation term compares at rtol 1e-5;
- the eval step (plain CE), init distributions, the trainer and its
  command line with a ``resnet50.pth`` in ``data_dir``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vitsom_tpu.config import load_config as jload_config
from vitsom_tpu.models import deit as jdeit
from vitsom_tpu.models import resnet as jresnet
from vitsom_tpu.train import optim as joptim
from vitsom_tpu.train import schedules as jsched
from vitsom_tpu.train import steps as jsteps
from vitsom_tpu_torch import convert
from vitsom_tpu_torch.config import load_config
from vitsom_tpu_torch.models import deit as tdeit
from vitsom_tpu_torch.models import resnet as tresnet
from vitsom_tpu_torch.models.vit_som import build_model, model_attn_impl
from vitsom_tpu_torch.train import optim as toptim
from vitsom_tpu_torch.train import schedules as tsched
from vitsom_tpu_torch.train import steps as tsteps
from vitsom_tpu_torch.train import trainer as ttrainer

from test_torch_swin import SharedMasks, capture_grads, check_three_steps

DEIT = "configs/deit/deit_cifar-10.yaml"
SMALL = {"vit.depth": 2, "vit.emb_dim": 32, "vit.heads": 2}
B = 4


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Many small CPU ops: one torch thread per test worker (restored after)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _x(seed, n=B, size=32):
    return np.random.default_rng(seed).normal(size=(n, size, size, 3)).astype(np.float32)


def _student(over=None, seed=2):
    over = {**SMALL, **(over or {})}
    jcfg, tcfg = jload_config(DEIT, over), load_config(DEIT, over)
    jm = jdeit.DeiT(jcfg)
    params = jax.jit(jm.init)(jax.random.key(seed), jnp.zeros((2, 32, 32, 3)))["params"]
    tm = build_model(tcfg, "cpu")
    tm.load_state_dict(convert.baseline_to_state_dict("deit", params), strict=True)
    return jcfg, tcfg, jm, params, tm


def test_forward_matches_jax_and_round_trips():
    jcfg, tcfg, jm, params, tm = _student()
    x = _x(1)
    with torch.no_grad():
        t_eval = tm(torch.from_numpy(x)).numpy()
        t_cls, t_dist = tm.train_forward(torch.from_numpy(x))
    j_eval = jax.jit(jm.apply)({"params": params}, jnp.asarray(x))
    j_cls, j_dist = jax.jit(lambda p, v: jm.apply({"params": p}, v, deterministic=True,
                                                  method="train_forward"))(params, jnp.asarray(x))
    for t, j in ((t_eval, j_eval), (t_cls.numpy(), j_cls), (t_dist.numpy(), j_dist)):
        assert t.shape == (B, 10)
        np.testing.assert_allclose(t, np.asarray(j), atol=1e-5, rtol=1e-5)
    # the eval path leaves the distill token out: it differs from train_forward's
    assert not np.allclose(t_eval, t_cls.numpy(), atol=1e-4)
    back, stats = convert.state_dict_to_baseline("deit", tm.state_dict())
    flat = convert.flatten(params)
    assert set(back) == set(flat) and not stats
    for k, v in flat.items():
        np.testing.assert_array_equal(back[k], np.asarray(v), err_msg=k)
    assert model_attn_impl(load_config(DEIT, {"train.attn_impl": "pallas"})) == "xla"


def test_distill_losses_match_jax():
    rng = np.random.default_rng(3)
    d = rng.normal(size=(16, 10)).astype(np.float32) * 3
    t = rng.normal(size=(16, 10)).astype(np.float32) * 3
    t[0, 0] = 80.0  # a teacher row whose other probabilities underflow: the 1e-12 clip
    for temp in (1.0, 3.0):
        port = float(tdeit.soft_distill_loss(torch.from_numpy(d), torch.from_numpy(t), temp))
        ref = float(jdeit.soft_distill_loss(jnp.asarray(d), jnp.asarray(t), temp))
        np.testing.assert_allclose(port, ref, rtol=1e-6)
    hard_t = float(tsteps.cross_entropy(torch.from_numpy(d), torch.from_numpy(t).argmax(-1)))
    hard_j = float(jsteps.cross_entropy(jnp.asarray(d), jnp.asarray(t).argmax(-1)))
    np.testing.assert_allclose(hard_t, hard_j, rtol=1e-6)


# ---------------------------------------------------------------------------
# the ResNet teacher and its loader
# ---------------------------------------------------------------------------


def test_teacher_batch_stats_logits_match_jax():
    """ResNet-50 at 32x32, B 4, train=True with the statistics update
    dropped (module docstring for the bound)."""
    x = _x(4)
    jm = jresnet.resnet50(10)
    v = jax.jit(lambda a: jm.init(jax.random.key(1), a, train=True))(jnp.asarray(x))
    j, _ = jax.jit(lambda vv, a: jm.apply(vv, a, train=True, mutable=["batch_stats"]))(
        v, jnp.asarray(x))
    j = np.asarray(j)
    sd = convert.baseline_to_state_dict("resnet", v["params"], v["batch_stats"])
    tm = tresnet.resnet50(10)
    tm.load_state_dict(sd, strict=True)
    before = {k: b.clone() for k, b in tm.named_buffers()}
    with torch.no_grad():
        t = tm(torch.from_numpy(x), train=True).numpy()
        tm64 = tresnet.resnet50(10).double()
        tm64.load_state_dict({k: a.double() for k, a in sd.items()})
        ref = tm64(torch.from_numpy(x).double(), train=True).numpy()
    assert all(torch.equal(b, before[k]) for k, b in tm.named_buffers())
    err, port64, jax64 = (float(np.abs(a - b).max()) for a, b in ((t, j), (t, ref), (j, ref)))
    assert err <= 0.05, err
    assert port64 <= jax64, (port64, jax64)
    back, stats = convert.state_dict_to_baseline("resnet", tm.state_dict())
    assert set(back) == set(convert.flatten(v["params"]))
    assert set(stats) == set(convert.flatten(v["batch_stats"]))
    for k, a in convert.flatten(v["params"]).items():
        np.testing.assert_array_equal(back[k], np.asarray(a), err_msg=k)
    # train=False reads the running statistics (mean 0, var 1 at init)
    j_eval = np.asarray(jax.jit(lambda vv, a: jm.apply(vv, a, train=False))(v, jnp.asarray(x)))
    with torch.no_grad():
        t_eval = tm(torch.from_numpy(x), train=False).numpy()
    np.testing.assert_allclose(t_eval, j_eval, rtol=1e-4, atol=1e-4 * np.abs(j_eval).max())


WIDTHS = (64, 128, 256, 512)
SIZES = (3, 4, 6, 3)


def torchvision_state_dict(seed: int = 0):
    """A state_dict with torchvision resnet50's names and shapes, drawn from
    a seed (``tests/test_resnet_loader.py``'s construction)."""
    g = torch.Generator().manual_seed(seed)
    sd = {}

    def add_bn(name, c):
        sd[f"{name}.weight"] = torch.randn(c, generator=g)
        sd[f"{name}.bias"] = torch.randn(c, generator=g)
        sd[f"{name}.running_mean"] = torch.randn(c, generator=g)
        sd[f"{name}.running_var"] = torch.randn(c, generator=g).abs() + 0.5
        sd[f"{name}.num_batches_tracked"] = torch.tensor(0)

    sd["conv1.weight"] = torch.randn(64, 3, 7, 7, generator=g)
    add_bn("bn1", 64)
    c_in = 64
    for s, (w, n) in enumerate(zip(WIDTHS, SIZES), start=1):
        for i in range(n):
            pre = f"layer{s}.{i}"
            sd[f"{pre}.conv1.weight"] = torch.randn(w, c_in, 1, 1, generator=g)
            add_bn(f"{pre}.bn1", w)
            sd[f"{pre}.conv2.weight"] = torch.randn(w, w, 3, 3, generator=g)
            add_bn(f"{pre}.bn2", w)
            sd[f"{pre}.conv3.weight"] = torch.randn(4 * w, w, 1, 1, generator=g)
            add_bn(f"{pre}.bn3", 4 * w)
            if i == 0:
                sd[f"{pre}.downsample.0.weight"] = torch.randn(4 * w, c_in, 1, 1, generator=g)
                add_bn(f"{pre}.downsample.1", 4 * w)
            c_in = 4 * w
    sd["fc.weight"] = torch.randn(1000, 2048, generator=g)
    sd["fc.bias"] = torch.randn(1000, generator=g)
    return sd


def test_loader_maps_every_tensor_as_the_jax_loader(tmp_path):
    sd = torchvision_state_dict()
    pth = tmp_path / "resnet50.pth"
    torch.save({f"module.{k}": v for k, v in sd.items()}, pth)
    mods = {k.rsplit(".", 1)[0] for k in sd
            if not k.startswith("fc.") and not k.endswith("num_batches_tracked")}
    assert mods == set(tresnet.torchvision_name_map()) == set(jresnet.torchvision_name_map())
    assert tresnet.torchvision_name_map() == jresnet.torchvision_name_map()
    assert tresnet.torchvision_name_map((3, 4, 6, 3), "basic") == jresnet.torchvision_name_map(
        (3, 4, 6, 3), "basic")
    tm = tresnet.resnet50(10)
    tm.reset_parameters(torch.Generator().manual_seed(0))
    fc = tm.fc.weight.detach().clone()
    n = tresnet.load_torch_resnet50(tm, str(pth))
    assert n == len([k for k in sd if not k.startswith("fc.")
                     and not k.endswith("num_batches_tracked")]) == 265
    own = tm.state_dict()
    for k, v in sd.items():
        if not k.startswith("fc.") and not k.endswith("num_batches_tracked"):
            assert torch.equal(own[k], v), k
    assert torch.equal(tm.fc.weight, fc)  # the head stays as it was
    # the JAX loader reads the same values into the Flax tree
    jm = jresnet.resnet50(10)
    v = jax.eval_shape(lambda k, a: jm.init(k, a, train=False), jax.random.key(0),
                       jnp.zeros((1, 32, 32, 3)))
    zeros = jax.tree_util.tree_map(lambda s: np.zeros(s.shape, s.dtype), v)
    jp, jb = jresnet.load_torch_resnet50(zeros["params"], zeros["batch_stats"], str(pth))
    mapped = convert.baseline_to_state_dict("resnet", jp, jb)
    for k, t in mapped.items():
        if not k.startswith("fc."):
            assert torch.equal(own[k], t), k


@pytest.mark.parametrize("fault", ["shape", "missing", "leftover"])
def test_loader_raises(fault, tmp_path):
    sd = torchvision_state_dict()
    if fault == "shape":
        sd["layer2.0.conv2.weight"] = torch.zeros(128, 128, 1, 1)
        match = "shape mismatch"
    elif fault == "missing":
        for k in [k for k in sd if k.startswith("layer3.1.bn2.")]:
            del sd[k]
        match = "no tensors for module 'layer3.1.bn2'"
    else:
        sd["layer9.0.conv1.weight"] = torch.zeros(1)
        match = "unconsumed"
    torch.save(sd, tmp_path / "resnet50.pth")
    with pytest.raises(ValueError, match=match):
        tresnet.load_torch_resnet50(tresnet.resnet50(10), str(tmp_path / "resnet50.pth"))


def test_init_distributions():
    """The student's and the teacher's (and resnet34's tree): lecun_normal kernels (std
    sqrt(1/fan_in), cut at 2 std / 0.87962566), the fused-fan uniform
    q/k/v, N(0, 1) tokens and positions, zero biases."""
    cfg = load_config(DEIT)
    m = build_model(cfg, "cpu", seed=0)
    names = set(convert.state_dict_to_baseline("deit", m.state_dict())[0])
    shapes = jax.eval_shape(jdeit.DeiT(jload_config(DEIT)).init, jax.random.key(0),
                            jnp.zeros((2, 32, 32, 3)))["params"]
    assert names == set(convert.flatten(shapes))
    with torch.no_grad():
        w = m.transformer.layers[0].fc1.weight
        assert abs(float(w.std()) - 192 ** -0.5) < 0.003
        assert float(w.abs().max()) <= 2 * 192 ** -0.5 / 0.87962566 + 1e-6
        q = m.transformer.layers[3].query.weight
        bound = (6 / (192 + 3 * 192)) ** 0.5
        assert float(q.abs().max()) <= bound and float(q.abs().max()) > 0.95 * bound
        assert abs(float(m.pos_embedding.std()) - 1.0) < 0.02
        assert not m.patch_proj.bias.any() and not m.mlp_head.bias.any()
        assert torch.equal(m.patch_norm_pre.weight, torch.ones(48))
    # resnet34 (basic blocks) carries the JAX resnet34's tree, name for name
    r34 = tresnet.resnet34(10)
    j34 = jax.eval_shape(lambda k, a: jresnet.resnet34(10).init(k, a, train=False),
                         jax.random.key(0), jnp.zeros((1, 32, 32, 3)))
    params, stats = convert.state_dict_to_baseline("resnet", r34.state_dict())
    assert set(params) == set(convert.flatten(j34["params"]))
    assert set(stats) == set(convert.flatten(j34["batch_stats"]))
    teacher = tdeit.build_teacher(cfg, "cpu")
    assert not any(p.requires_grad for p in teacher.parameters())
    w = teacher.layer3[0].conv2.weight  # fan_in 256 * 9
    assert abs(float(w.std()) - (256 * 9) ** -0.5) < 0.001
    assert float(w.abs().max()) <= 2 * (256 * 9) ** -0.5 / 0.87962566 + 1e-6


# ---------------------------------------------------------------------------
# train and eval steps with dropout live
# ---------------------------------------------------------------------------


def _small_teacher(num_classes):
    return jresnet.ResNet(stage_sizes=(1,), block="basic", num_classes=num_classes)


@pytest.mark.parametrize("hard", [False, True])
def test_train_steps_match_with_dropout(hard, monkeypatch):
    """Three DeiT steps at lr 1e-3 (cosine, no warm-up) with dropout 0.1 at
    all 9 sites, soft and hard distillation; the teacher is the one-block
    stand-in (module docstring), the JAX one drawn at ``train.seed + 13``
    as the JAX step draws it, the port's holding its weights."""
    over = {**SMALL, "batch_size": B, "total_epochs": 3,
            "distillation.hard": hard}
    jcfg, tcfg, jm, params, tmodel = _student(over, seed=5)
    monkeypatch.setattr(jdeit, "resnet50", _small_teacher)
    t_vars = _small_teacher(10).init(jax.random.key(jcfg.train.seed + 13),
                                     jnp.zeros((2, 32, 32, 3)), train=True)
    teacher = tresnet.ResNet((1,), "basic", 10)
    teacher.load_state_dict(convert.baseline_to_state_dict(
        "resnet", t_vars["params"], t_vars["batch_stats"]), strict=True)
    teacher.requires_grad_(False)

    base = joptim.base_learning_rate(jcfg)
    jsch = jsched.make_lr_schedule(jcfg.optimizer, 3, 1, base)
    tx = capture_grads(joptim.make_optimizer(jcfg, params, jsch))
    state = jsteps.TrainState(step=jnp.asarray(0, jnp.int32), params=params,
                              opt_state=tx.init(params))
    masks = SharedMasks(13)
    masks.install(monkeypatch)
    jstep = jdeit.make_deit_train_step(jcfg, jm, tx, jsch)
    opt = toptim.make_optimizer(tcfg, tmodel)
    tsch = tsched.make_lr_schedule_tensor(tcfg.optimizer, 3, 1, base)
    dstate = tsteps.DeviceState("cpu", 3, tsteps.metric_keys(tcfg))
    assert dstate.keys == tsteps.DEIT_METRIC_KEYS
    tstep = tdeit.make_deit_train_step(tcfg, tmodel, opt, tsch, dstate, torch.Generator(),
                                       teacher=teacher)
    rng = np.random.default_rng(6)
    batches = [(_x(30 + i), rng.integers(0, 10, size=B)) for i in range(3)]
    lr_max = max(float(tsch(torch.tensor(s))) for s in range(3))
    check_three_steps(tcfg, tmodel, (state, jstep), tstep, batches, lr_max, dstate.keys,
                      lambda p: convert.baseline_to_state_dict("deit", p), masks)
    n = 65  # tokens before the distill token is appended
    layer = [((B, 2, n + 1, n + 1), 0.9), ((B, n + 1, 32), 0.9), ((B, n + 1, 128), 0.9),
             ((B, n + 1, 32), 0.9)]
    assert masks.calls["jax"] == [((B, n, 32), 0.9)] + layer * 2
    assert masks.calls["port"] == masks.calls["jax"] * 3


def test_eval_step_plain_ce_matches_jax():
    jcfg, tcfg, jm, params, tm = _student()
    x = _x(8)
    y = np.random.default_rng(9).integers(0, 10, size=B)
    j = jax.jit(jsteps.make_classifier_eval_step(jcfg, jm))(
        params, {"image": jnp.asarray(x), "label": jnp.asarray(y, jnp.int32)})
    t = tsteps.make_classifier_eval_step(tcfg, tm)(
        {"image": torch.from_numpy(x), "label": torch.from_numpy(y)})
    for k in ("logits", "cls_loss"):
        np.testing.assert_allclose(t[k].numpy(), np.asarray(j[k]), atol=1e-5, rtol=1e-5,
                                   err_msg=k)
    plain = float(tsteps.cross_entropy(t["logits"], torch.from_numpy(y)))
    np.testing.assert_allclose(float(t["cls_loss"]), plain, rtol=1e-7)


# ---------------------------------------------------------------------------
# the trainer and its command line
# ---------------------------------------------------------------------------


def test_trainer_and_cli_train_deit_with_a_written_teacher(tmp_path, capsys):
    """``deit_cifar-10`` cut to depth 1 at B 8 on 40 synthetic images: the
    trainer (one epoch, validation, test) with the random teacher, then the
    CLI with a torchvision-named ``resnet50.pth`` in ``data_dir``, which the
    step loads (its mapped count printed)."""
    base = {**SMALL, "vit.depth": 1, "batch_size": 8, "data.allow_synthetic": True,
            "data.synthetic_size": 40, "train.checkpoint_dir": str(tmp_path / "states"),
            "train.log_dir": str(tmp_path / "logs"), "data.data_dir": str(tmp_path)}
    tr = ttrainer.Trainer(load_config(DEIT, base), device="cpu")
    assert "RANDOMLY INITIALIZED" in capsys.readouterr().out
    hist = tr.fit(max_steps=4)
    assert list(hist) == list(tsteps.DEIT_METRIC_KEYS)
    assert np.all(np.isfinite(hist["train/distill_loss"])) and len(tr.val_history) == 1
    res = tr.evaluate()
    assert 0.0 <= res["accuracy"] <= 1.0

    torch.save(torchvision_state_dict(1), tmp_path / "resnet50.pth")
    argv = ["--config", DEIT, "--synthetic", "--runs", "1", "--max-steps", "2",
            "--device", "cpu"]
    for k, v in base.items():
        if k not in ("data.allow_synthetic",):
            argv += ["--override", f"{k}={v}"]
    results = ttrainer.main(argv)
    out = capsys.readouterr().out
    assert "loaded pretrained ResNet-50 weights" in out and "model=deit" in out
    assert results[0]["steps"] == 2 and np.isfinite(results[0]["first_cls_loss"])
