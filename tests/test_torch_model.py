"""The port's model pieces against the JAX package, on the CPU.

Weights are made by the Flax model from a seed and carried across with
``vitsom_tpu_torch.convert``; inputs are numpy arrays handed to both.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import traverse_util

from vitsom_tpu.config import Config, DataConfig, SOMConfig, TrainConfig, ViTConfig
from vitsom_tpu.models import vit as jvit
from vitsom_tpu.models.vit_som import ViTSOM as JViTSOM
from vitsom_tpu.ops import attention as jattn
from vitsom_tpu.ops.pos_embed import get_2d_sincos_pos_embed as jpos
from vitsom_tpu_torch import config as tconfig
from vitsom_tpu_torch import convert
from vitsom_tpu_torch.models import vit as tvit
from vitsom_tpu_torch.models.vit_som import ViTSOM as TViTSOM
from vitsom_tpu_torch.ops import attention as tattn
from vitsom_tpu_torch.ops.pos_embed import get_2d_sincos_pos_embed as tpos
from vitsom_tpu_torch.utils import initializers as tinit


def _t(a):
    return torch.from_numpy(np.array(a))


def _cfgs(emb, depth, dec_depth, remat, distance="cosine", topology="square"):
    kw = dict(
        model_arch="vit_som", total_epochs=2, batch_size=4, gamma=0.005,
        som=dict(map_size=(4, 5), t_max=5.0, t_min=0.1, distance_fcn=distance, topology=topology),
        vit=dict(patch_size=7, emb_dim=emb, depth=depth, heads=2, dec_emb_dim=8, dec_depth=dec_depth),
        data=dict(dataset="mnist", num_classes=0, num_channels=1, input_size=28),
        train=dict(use_pallas_som=True, remat_blocks=remat),
    )
    jcfg = Config(
        **{k: v for k, v in kw.items() if not isinstance(v, dict)},
        som=SOMConfig(**kw["som"]), vit=ViTConfig(**kw["vit"]),
        data=DataConfig(**kw["data"]), train=TrainConfig(**kw["train"]),
    ).validate()
    tcfg = tconfig.config_from_dict(jcfg.to_dict())
    return jcfg, tcfg


@functools.lru_cache(maxsize=None)
def _pair(emb, depth=1, dec_depth=1, remat=False, distance="cosine", topology="square",
          impl="xla"):
    jcfg, tcfg = _cfgs(emb, depth, dec_depth, remat, distance, topology)
    jmodel = JViTSOM(jcfg, attn_impl=impl)
    params = jax.jit(jmodel.init)(jax.random.key(0), jnp.zeros((2, 28, 28, 1)))["params"]
    tmodel = TViTSOM(tcfg, attn_impl=impl)
    tmodel.load_state_dict(convert.flax_to_state_dict(params), strict=True)
    return jmodel, params, tmodel


def test_config_copy_reads_flagship_yaml():
    from vitsom_tpu.config import load_config as jload

    path = "configs/vit_som/vit_som_mnist.yaml"
    assert tconfig.load_config(path).to_dict() == jload(path).to_dict()
    over = {"total_epochs": 3, "som.map_size": [24, 24], "train.steps_per_dispatch": 4}
    assert tconfig.load_config(path, over).to_dict() == jload(path, over).to_dict()


@pytest.mark.parametrize("dim,grid", [(16, 14), (8, 4), (192, 8)])
def test_pos_embed_matches(dim, grid):
    np.testing.assert_array_equal(tpos(dim, grid, cls_token=True), jpos(dim, grid, cls_token=True))


def test_patchify_roundtrip_matches():
    rng = np.random.default_rng(0)
    imgs = rng.normal(size=(3, 28, 28, 2)).astype(np.float32)
    jp = np.asarray(jvit.patchify(jnp.asarray(imgs), 7))
    tp = tvit.patchify(_t(imgs), 7).numpy()
    np.testing.assert_array_equal(tp, jp)
    np.testing.assert_array_equal(tvit.unpatchify(_t(tp), 7, 2).numpy(), imgs)
    np.testing.assert_array_equal(
        tvit.unpatchify(_t(tp), 7, 2).numpy(), np.asarray(jvit.unpatchify(jnp.asarray(jp), 7, 2))
    )


@pytest.mark.parametrize("shape", [(2, 197, 2, 8), (2, 197, 2, 2), (1, 17, 3, 16)])
def test_xla_attention_matches(shape):
    rng = np.random.default_rng(1)
    q, k, v = (rng.normal(size=shape).astype(np.float32) for _ in range(3))
    jo, ja = jattn.xla_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), return_attn=True)
    to, ta = tattn.multi_head_attention(_t(q), _t(k), _t(v), impl="xla", return_attn=True)
    np.testing.assert_allclose(to.numpy(), np.asarray(jo), atol=1e-5, rtol=1e-5)
    np.testing.assert_allclose(ta.numpy(), np.asarray(ja), atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("impl", ["xla_bf16", "xla_bf16s"])
def test_unported_attention_impls_raise(impl):
    """The bf16 impls run (``tests/test_torch_bf16.py`` holds them against
    the JAX package) and fall back to the float32 path with
    ``return_attn``. Nothing of them is left unported: bf16 inputs to the
    attention kernels (``pallas``, ``hybrid``) reach the kernels' plain bf16
    versions on the CPU (``tests/test_torch_attention_bf16.py``)."""
    x = torch.zeros(1, 3, 1, 4)
    out, attn = tattn.multi_head_attention(x, x, x, impl=impl)
    assert attn is None and out.shape == x.shape and out.dtype == torch.float32
    out, attn = tattn.multi_head_attention(x, x, x, impl=impl, return_attn=True)
    assert attn.shape == (1, 1, 3, 3) and attn.dtype == torch.float32
    xb = x.to(torch.bfloat16)
    for kernel_impl, dtype in (("pallas", torch.bfloat16), ("hybrid", torch.float32)):
        out, attn = tattn.multi_head_attention(xb, xb, xb, impl=kernel_impl)
        assert attn is None and out.shape == x.shape and out.dtype == dtype


def test_convert_roundtrip_exact():
    for emb in (16, 128):
        _, params, tmodel = _pair(emb)
        flat = traverse_util.flatten_dict(jax.device_get(params), sep="/")
        sd = convert.flax_to_state_dict(params)
        assert set(sd) == set(tmodel.state_dict())
        back = convert.state_dict_to_flax(tmodel.state_dict())
        assert set(back) == set(flat)
        for k, v in flat.items():
            np.testing.assert_array_equal(back[k], np.asarray(v), err_msg=k)
    # the qkv layout follows the width: fused below 128, split at 128
    assert "vit.blocks.0.attn.qkv.weight" in _pair(16)[2].state_dict()
    assert "vit.blocks.0.attn.query.weight" in _pair(128)[2].state_dict()


@pytest.mark.parametrize(
    "emb,depth,remat,distance,topology,impl",
    [
        pytest.param(16, 2, True, "cosine", "square", "xla", id="16-2-True-cosine-square"),
        pytest.param(128, 1, False, "euclidean", "hexa", "xla", id="128-1-False-euclidean-hexa"),
        pytest.param(16, 2, True, "cosine", "square", "pallas", id="16-2-True-cosine-square-pallas"),
    ],
)
def test_vit_som_forward_and_features_match(emb, depth, remat, distance, topology, impl):
    """The port's model against the Flax model; with ``pallas`` both run
    their fused attention (Pallas in interpret mode, the port's plain
    version of the CUDA kernels)."""
    jmodel, params, tmodel = _pair(emb, depth=depth, dec_depth=2, remat=remat,
                                   distance=distance, topology=topology, impl=impl)
    x = np.random.default_rng(2).uniform(size=(3, 28, 28, 1)).astype(np.float32)
    jcls, jrec, _, jdist, jbmu = jax.jit(jmodel.apply)({"params": params}, jnp.asarray(x))
    tcls, trec, tlog, tdist, tbmu = tmodel(_t(x))
    assert tlog is None
    np.testing.assert_allclose(tcls.detach().numpy(), np.asarray(jcls), atol=1e-5)
    np.testing.assert_allclose(trec.detach().numpy(), np.asarray(jrec), atol=1e-5)
    np.testing.assert_allclose(tdist.detach().numpy(), np.asarray(jdist), atol=1e-5)
    np.testing.assert_array_equal(tbmu.numpy(), np.asarray(jbmu))

    _, _, _, jz = jax.jit(functools.partial(jmodel.apply, method="features"))(
        {"params": params}, jnp.asarray(x)
    )
    _, trec2, _, tz = tmodel.features(_t(x))
    assert tz.shape == (3, 16 * emb)
    np.testing.assert_allclose(tz.detach().numpy(), np.asarray(jz), atol=1e-5)
    np.testing.assert_allclose(trec2.detach().numpy(), np.asarray(jrec), atol=1e-5)


def test_decode_prototypes_matches():
    jmodel, params, tmodel = _pair(16)
    protos = np.random.default_rng(3).normal(size=(5, 16 * 16)).astype(np.float32)
    j = jmodel.apply({"params": params}, jnp.asarray(protos), method="decode_prototypes")
    t = tmodel.decode_prototypes(_t(protos))
    assert t.shape == (5, 28, 28, 1)
    np.testing.assert_allclose(t.detach().numpy(), np.asarray(j), atol=1e-5)


def test_initializer_distributions():
    g = torch.Generator().manual_seed(0)
    w = tinit.xavier_uniform_(torch.empty(300, 200), g)
    bound = (6.0 / 500) ** 0.5
    assert float(w.abs().max()) <= bound and float(w.abs().max()) > 0.99 * bound
    np.testing.assert_allclose(float(w.std()), bound / 3**0.5, rtol=0.02)
    c = tinit.conv_xavier_as_linear_(torch.empty(64, 3, 4, 4), g)
    cb = (6.0 / (3 * 16 + 64)) ** 0.5
    assert float(c.abs().max()) <= cb and float(c.abs().max()) > 0.98 * cb
    n = tinit.normal_(torch.empty(100000), 0.02, g)
    np.testing.assert_allclose(float(n.std()), 0.02, rtol=0.02)
    b = tinit.torch_default_bias_(torch.empty(1000), 49, g)
    assert float(b.abs().max()) <= 1 / 7 and float(b.abs().max()) > 0.99 / 7


def test_fresh_model_init_matches_jax_distributions():
    """A model built by the port has the JAX package's init distributions:
    per-parameter std within a few percent of the Flax init's."""
    from vitsom_tpu_torch.models.vit_som import build_model

    _, tcfg = _cfgs(128, 1, 1, False)
    _, params, _ = _pair(128)
    ref = convert.flax_to_state_dict(params)
    model = build_model(tcfg, device="cpu", seed=0)
    for name, p in model.state_dict().items():
        r = ref[name]
        if float(r.std()) == 0.0:  # zero biases, unit LayerNorm scales
            assert torch.equal(p, r), name
        elif r.numel() >= 500:
            np.testing.assert_allclose(float(p.std()), float(r.std()), rtol=0.1, err_msg=name)
