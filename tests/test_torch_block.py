"""The port's fused transformer block (plain versions, autograd op, weight
carrying) against the JAX package, on the CPU.

The JAX side runs ``block_pallas.make_fused_block`` in interpret mode, as
``tests/test_block_pallas.py`` does, and the Flax ``Block``; the port runs
the plain PyTorch versions, which its wrappers take for CPU tensors.
Weights come from the Flax init with biases and LayerNorm parameters moved
off their init values by numpy noise from a seed; inputs and cotangents are
numpy arrays from a seed. Tolerances are the JAX test's own: atol 2e-5 /
rtol 1e-5 for values (``test_block_pallas.py:64``), atol 2e-5 / rtol 1e-4
for gradients (``:89-94``).
"""

import copy
import re
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import traverse_util

from vitsom_tpu.models import vit as jvit
from vitsom_tpu.ops import block_pallas
from vitsom_tpu_torch import convert
from vitsom_tpu_torch.models import vit as tvit
from vitsom_tpu_torch.ops import block_fused as tblock

Y_TOL = dict(atol=2e-5, rtol=1e-5)
GRAD_TOL = dict(atol=2e-5, rtol=1e-4)


def _t(a, grad=False):
    return torch.from_numpy(np.array(a, dtype=np.float32)).requires_grad_(grad)


def _jax_block(b, n, dim, heads, ratio, seed):
    """(Flax Block, its params, x [B, N, D], cotangent [B, N, D])."""
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(b, n, dim)).astype(np.float32)
    cot = rng.normal(size=(b, n, dim)).astype(np.float32)
    model = jvit.Block(dim, heads, ratio)
    params = model.init(jax.random.key(seed), jnp.asarray(x))["params"]
    flat = traverse_util.flatten_dict(jax.device_get(params), sep="/")
    for k, v in flat.items():
        if not k.endswith("kernel"):  # biases and LayerNorm scales off their init
            flat[k] = (np.asarray(v) + 0.02 * rng.normal(size=v.shape)).astype(np.float32)
    return model, traverse_util.unflatten_dict(flat, sep="/"), x, cot


def _port_block(params, dim, heads, ratio):
    """The port's Block holding the Flax Block's params, carried by
    ``flax_to_state_dict`` as block 0 of an encoder."""
    sd = convert.flax_to_state_dict({"vit": {"block_0": params}})
    prefix = "vit.blocks.0."
    blk = tvit.Block(dim, heads, ratio)
    blk.load_state_dict({k[len(prefix):]: v for k, v in sd.items()}, strict=True)
    return blk


def _param_grads_fused(blk):
    """The Block's parameter gradients in the fused layout."""
    shadow = copy.deepcopy(blk)
    with torch.no_grad():
        for p, q in zip(shadow.parameters(), blk.parameters()):
            p.copy_(q.grad)
    return {k: v.detach() for k, v in convert.block_weights(shadow).items()}


def _jnp(w):
    return {k: jnp.asarray(v.detach().numpy()) for k, v in w.items()}


@pytest.mark.parametrize(
    "b,n,dim,heads,ratio",
    [
        (8, 197, 16, 2, 4.0),   # the flagship encoder block
        (4, 65, 24, 3, 4.0),    # odd N, 3 heads
        (3, 17, 16, 2, 2.0),    # mlp_ratio 2
        (2, 197, 4, 2, 4.0),    # the flagship decoder block, head_dim 2
    ],
)
def test_reference_matches_jax(b, n, dim, heads, ratio):
    model, params, x, _ = _jax_block(b, n, dim, heads, ratio, seed=n + dim)
    w = convert.block_weights_from_flax(params)
    jref, _ = model.apply({"params": params}, jnp.asarray(x))
    jfused = jax.jit(block_pallas.make_fused_block(dim, heads, ratio, n))(jnp.asarray(x), _jnp(w))
    y = tblock.fused_block_reference(_t(x), w, heads)
    assert y.shape == (b, n, dim)
    np.testing.assert_allclose(y.numpy(), np.asarray(jref), **Y_TOL)
    np.testing.assert_allclose(y.numpy(), np.asarray(jfused), **Y_TOL)


@pytest.mark.parametrize("b,n,dim,heads,ratio", [(4, 33, 16, 2, 4.0), (2, 33, 4, 2, 4.0)])
def test_bwd_reference_matches_jax_and_autograd(b, n, dim, heads, ratio):
    """The backward kernel's plain version (closed form, no autograd)
    against ``jax.grad`` through the JAX fused block and the Flax Block, and
    against torch autograd through the port's Block."""
    model, params, x, cot = _jax_block(b, n, dim, heads, ratio, seed=100 + dim)
    w = convert.block_weights_from_flax(params)
    jcot = jnp.asarray(cot)
    jfused = block_pallas.make_fused_block(dim, heads, ratio, n)
    gx_f, gw_f = jax.grad(lambda x, w: jnp.sum(jfused(x, w) * jcot), argnums=(0, 1))(
        jnp.asarray(x), _jnp(w))
    gx_r, gp_r = jax.grad(
        lambda x, p: jnp.sum(model.apply({"params": p}, x)[0] * jcot), argnums=(0, 1)
    )(jnp.asarray(x), params)
    gw_r = convert.block_weights_from_flax(gp_r)

    blk = _port_block(params, dim, heads, ratio)
    xl = _t(x, grad=True)
    blk(xl).backward(_t(cot))
    gw_a = _param_grads_fused(blk)

    dx, dw = tblock.fused_block_bwd_reference(_t(x), _t(cot), w, heads)
    assert list(dw) == list(tblock.WEIGHT_NAMES)
    for other in (np.asarray(gx_f), np.asarray(gx_r), xl.grad.numpy()):
        np.testing.assert_allclose(dx.numpy(), other, **GRAD_TOL)
    for name in tblock.WEIGHT_NAMES:
        for other in (np.asarray(gw_f[name]), gw_r[name].numpy(), gw_a[name].numpy()):
            np.testing.assert_allclose(dw[name].numpy(), other, err_msg=name, **GRAD_TOL)


@pytest.mark.parametrize("b,n,dim,heads", [(2, 33, 16, 2), (2, 9, 128, 2)])
def test_fused_block_op_on_cpu(b, n, dim, heads):
    """``make_fused_block`` on CPU tensors runs the plain versions, launches
    nothing, and its gradients reach the port Block's parameters through
    ``block_weights`` (transposed views; a cat of q/k/v at dim 128)."""
    _, params, x, cot = _jax_block(b, n, dim, heads, 4.0, seed=200 + dim)
    blk = _port_block(params, dim, heads, 4.0)
    launches = (tblock.LAUNCHES_FWD, tblock.LAUNCHES_BWD)
    xf = _t(x, grad=True)
    y = tblock.make_fused_block(dim, heads, 4.0, n)(xf, convert.block_weights(blk))
    y.backward(_t(cot))
    assert (tblock.LAUNCHES_FWD, tblock.LAUNCHES_BWD) == launches
    fused = {name: p.grad.clone() for name, p in blk.named_parameters()}
    blk.zero_grad(set_to_none=True)
    xe = _t(x, grad=True)
    ye = blk(xe)
    ye.backward(_t(cot))
    np.testing.assert_allclose(y.detach().numpy(), ye.detach().numpy(), **Y_TOL)
    np.testing.assert_allclose(xf.grad.numpy(), xe.grad.numpy(), **GRAD_TOL)
    assert set(fused) == {name for name, _ in blk.named_parameters()}
    for name, p in blk.named_parameters():
        np.testing.assert_allclose(fused[name].numpy(), p.grad.numpy(), err_msg=name, **GRAD_TOL)


@pytest.mark.parametrize("dim,heads", [(16, 2), (128, 4)])
def test_block_weights_from_flax_matches_block_weights(dim, heads):
    _, params, _, _ = _jax_block(1, 5, dim, heads, 4.0, seed=300 + dim)
    from_flax = convert.block_weights_from_flax(params)
    blk = _port_block(params, dim, heads, 4.0)
    from_port = convert.block_weights(blk)
    shapes = tblock.weight_shapes(dim, 4 * dim)
    assert list(from_flax) == list(from_port) == list(tblock.WEIGHT_NAMES)
    for name in tblock.WEIGHT_NAMES:
        assert tuple(from_port[name].shape) == shapes[name], name
        np.testing.assert_array_equal(from_port[name].detach().numpy(), from_flax[name].numpy(),
                                      err_msg=name)
    # views of the module's own parameters, not copies (the split qkv is a cat)
    assert from_port["proj_kernel"].data_ptr() == blk.attn.proj.weight.data_ptr()
    if dim < 128:
        assert from_port["qkv_kernel"].data_ptr() == blk.attn.qkv.weight.data_ptr()


def _small_weights(dim, mlp_hidden, dtype):
    g = torch.Generator().manual_seed(0)
    return {name: torch.randn(shape, generator=g, dtype=dtype)
            for name, shape in tblock.weight_shapes(dim, mlp_hidden).items()}


@pytest.mark.parametrize("case", ["emb192", "not_built", "float64", "cpu_tensor", "bwd_past_16_tiles"])
def test_kernel_checks_refuse(case):
    """What the kernels do not cover raises ValueError before any launch."""
    launches = tblock.LAUNCHES_FWD
    if case == "emb192":  # 1.8 MB of weights: no one-CTA-per-sample block
        with pytest.raises(ValueError, match="shared memory"):
            tblock.check_shape(2, 65, 192, 3, 768, backward=False)
    elif case == "not_built":
        with pytest.raises(ValueError, match="not built"):
            tblock.check_shape(2, 17, 32, 2, 128, backward=False)
    elif case == "bwd_past_16_tiles":  # the backward gives each row tile a warp
        tblock.check_shape(2, 257, 16, 2, 64, backward=False)
        with pytest.raises(ValueError, match="warps"):
            tblock.check_shape(2, 257, 16, 2, 64, backward=True)
    elif case == "float64":
        w = _small_weights(16, 64, torch.float64)
        with pytest.raises(ValueError, match="float32"):
            tblock._check(torch.zeros(2, 17, 16, dtype=torch.float64), w, 2, backward=False)
    else:
        w = _small_weights(16, 64, torch.float32)
        with pytest.raises(ValueError, match="CUDA"):
            tblock._kernel_forward(torch.zeros(2, 17, 16), w, 2)
    assert tblock.LAUNCHES_FWD == launches


def test_flagship_block_shapes_fit():
    """The flagship encoder and decoder blocks (B 128, N 197) are built and
    fit in a CTA's shared memory, forward and backward."""
    for dim, mlp_hidden in ((16, 64), (4, 16)):
        for backward in (False, True):
            tblock.check_shape(128, 197, dim, 2, mlp_hidden, backward)
    assert tblock.smem_bytes(197, 16, 2, 64, backward=True) <= tblock.SMEM_LIMIT_BYTES


# (B, N, D, heads, M): the flagship's encoder and decoder blocks and the JAX
# tests' blocks, every shape chip_smoke.py holds the kernels at
BLOCK_SHAPES = [(128, 197, 16, 2, 64), (128, 197, 4, 2, 16), (8, 197, 16, 2, 64),
                (4, 65, 24, 3, 96), (3, 17, 16, 2, 32), (4, 33, 16, 2, 64)]


def _kernel_source():
    return (Path(tblock.__file__).parent / "csrc" / "block.cu").read_text()


def test_constants_match_the_kernel_source():
    """The wrapper's row tile, fragment block, thread limits and row stride
    are the kernels' own."""
    src = _kernel_source()
    consts = {k: int(v) for k, v in re.findall(r"constexpr int (k\w+) = (\d+);", src)}
    assert consts["kTile"] == tblock.ROW_TILE == 16
    assert consts["kFrag"] == tblock.FRAG_FLOATS == 128
    assert consts["kMaxThreads"] == tblock.MAX_THREADS
    assert consts["kFwdThreads"] == tblock.FWD_THREADS
    assert consts["kSlices"] == tblock.WGRAD_SLICES
    assert "constexpr int wpad(int c) { return r8(c) + 4; }" in src
    assert "constexpr int r8(int c) { return (c + 7) / 8 * 8; }" in src
    assert [tblock._wpad(c) for c in (4, 12, 16, 48, 64, 96)] == [12, 20, 20, 52, 68, 100]
    # a stride of 4 mod 8 floats: rows 2t at column g fall in 32 distinct banks
    for c in (4, 16, 24, 48, 64, 96):
        ld = tblock._wpad(c)
        banks = {(2 * t * ld + g) % 32 for t in range(4) for g in range(8)}
        assert len(banks) == 32, c


@pytest.mark.parametrize("b,n,dim,heads,m", BLOCK_SHAPES)
def test_smem_fits_at_every_held_shape(b, n, dim, heads, m):
    for backward in (False, True):
        tblock.check_shape(b, n, dim, heads, m, backward)
        assert tblock.smem_bytes(n, dim, heads, m, backward) <= tblock.SMEM_LIMIT_BYTES


def test_launch_plan_at_the_flagship_shapes():
    """13 row tiles at N 197: 26 forward warps (two a tile), 13 backward
    warps; the layouts' shared memory in bytes."""
    assert tblock.row_tiles(197) == 13
    assert tblock.fwd_threads(197) == 832 and tblock.bwd_threads(197) == 416
    assert tblock.fwd_threads(17) == 128 and tblock.bwd_threads(17) == 64
    assert tblock.fwd_threads(1000) == tblock.FWD_THREADS
    assert tblock.staged_floats(16, 64) == 3760 and tblock.staged_floats(4, 16) == 720
    assert tblock.smem_bytes(197, 16, 2, 64, backward=False) == 98240
    assert tblock.smem_bytes(197, 4, 2, 16, backward=False) == 79424
    assert tblock.wgrad_scratch(16, 64) == 10 * 3 * 128  # fc2 8 tiles + proj 2
    assert tblock.smem_bytes(197, 16, 2, 64, backward=True) == 220096
    assert tblock.smem_bytes(197, 4, 2, 16, backward=True) == 149056
