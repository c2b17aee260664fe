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

import contextlib
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
        (2, 9, 192, 3, 4.0),    # emb 192: the cifar, tiny-imagenet and family encoders
        (2, 9, 96, 3, 4.0),     # their decoders (dec_emb 96, head_dim 32)
        (2, 17, 20, 5, 3.0),    # head_dim 4, M 60
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


@pytest.mark.parametrize("b,n,dim,heads,ratio", [(4, 33, 16, 2, 4.0), (2, 33, 4, 2, 4.0),
                                                 (2, 9, 192, 3, 4.0), (2, 9, 96, 3, 4.0),
                                                 (2, 17, 20, 5, 3.0)])
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


@pytest.mark.parametrize("case", ["float64", "cpu_tensor", "bad_heads", "past_dim",
                                  "past_head_dim", "past_mlp", "past_seq_len"])
def test_kernel_checks_refuse(case):
    """What the kernels do not cover raises ValueError before any launch:
    a malformed shape, one past the limits, a dtype or device they do not
    take."""
    launches = (tblock.LAUNCHES_FWD, tblock.LAUNCHES_FWD_STREAMED)
    past = {"past_dim": ((2, 9, 1024, 8, 4096), "D up to 768"),
            "past_head_dim": ((2, 9, 256, 1, 1024), "head_dim up to 192"),
            "past_mlp": ((2, 9, 768, 4, 4096), "M up to 3072"),
            "past_seq_len": ((2, 1026, 192, 3, 768), "N up to 1025")}
    if case == "bad_heads":
        with pytest.raises(ValueError, match="bad block shape"):
            tblock.check_shape(2, 9, 192, 5, 768, backward=False)
    elif case in past:
        shape, what = past[case]
        for backward in (False, True):
            with pytest.raises(ValueError, match=what):
                tblock.check_shape(*shape, backward)
    elif case == "float64":
        w = _small_weights(16, 64, torch.float64)
        with pytest.raises(ValueError, match="float32"):
            tblock._check(torch.zeros(2, 17, 16, dtype=torch.float64), w, 2, backward=False)
    else:
        w = _small_weights(16, 64, torch.float32)
        with pytest.raises(ValueError, match="CUDA"):
            tblock._kernel_forward(torch.zeros(2, 17, 16), w, 2)
    assert (tblock.LAUNCHES_FWD, tblock.LAUNCHES_FWD_STREAMED) == launches


# (B, N, D, heads, M) the JAX kernel computes and the resident design does
# not hold: emb 192 and its decoders, a (D, hd, M) that is not built, the
# backward past 16 row tiles, hd 4, 12 and 192, N 1025, the limits
STREAMED_SHAPES = [(2, 65, 192, 3, 768), (128, 65, 192, 3, 768), (128, 65, 96, 3, 384),
                   (128, 197, 192, 3, 768), (128, 257, 192, 3, 768), (2, 17, 32, 2, 128),
                   (2, 9, 128, 2, 512), (8, 785, 16, 2, 64), (3, 17, 20, 5, 60),
                   (2, 33, 12, 1, 48), (2, 65, 384, 2, 1536), (2, 1025, 192, 3, 768),
                   (2, 9, 768, 4, 3072)]


@pytest.mark.parametrize("shape", STREAMED_SHAPES)
def test_check_shape_takes_what_the_jax_kernel_takes(shape):
    """``check_shape`` takes every shape above, forward and backward, and
    ``block_plan`` gives it the streamed design; the backward past 16 row
    tiles at the flagship's widths too (its forward stays resident)."""
    for backward in (False, True):
        tblock.check_shape(*shape, backward)
        assert tblock.block_plan(*shape, backward) == "streamed"
    tblock.check_shape(2, 257, 16, 2, 64, backward=True)
    assert tblock.block_plan(2, 257, 16, 2, 64, True) == "streamed"
    assert tblock.block_plan(2, 257, 16, 2, 64, False) == "resident"


def test_block_plan_keeps_the_built_shapes_resident():
    """The four built (D, hd, M) run the resident kernels at the flagship's
    N and the JAX tests' shapes, forward and backward."""
    for b, n, dim, heads, m in BLOCK_SHAPES:
        for backward in (False, True):
            assert tblock.block_plan(b, n, dim, heads, m, backward) == "resident"
    assert tblock.block_plan(8, 400, 16, 2, 64, True) == "streamed"


def test_workspace_bytes_by_hand():
    """The streamed workspace at the vit_som_cifar-10 encoder block (B 128,
    N 65, D 192, 3 heads, M 768: R = 8320 rows, every buffer a multiple of
    32 floats): the barrier's 32 floats, qkv, o, r, m1, two row statistics
    and lse; the backward's dm1, dh2, dr, do, dqkv, dh1 and 5 slices of the
    444,864 weight floats."""
    r, d, m = 8320, 192, 768
    fwd = 32 + 3 * r * d + r * d + r * d + r * m + 2 * r + 2 * r + 3 * r
    w = 3 * d * d + d * d + 2 * d * m + 9 * d + m
    assert w == 444864 and tblock.wgrad_slices(r) == 5
    bwd = fwd + r * m + 3 * r * d + 3 * r * d + r * d + 5 * w
    assert tblock.workspace_bytes(128, 65, 192, 3, 768, False) == 4 * fwd == 57740928
    assert tblock.workspace_bytes(128, 65, 192, 3, 768, True) == 4 * bwd
    # 1 slice up to 2048 rows, one a 2048 rows begun, at most 16
    assert [tblock.wgrad_slices(x) for x in (18, 2048, 2049, 32896, 10**6)] == [1, 1, 2, 16, 16]


def test_streamed_constants_match_the_kernel_source():
    """The wrapper's streamed constants are csrc/block_streamed.cu's (the
    loaded library is checked against them too)."""
    src = (Path(tblock.__file__).parent / "csrc" / "block_streamed.cu").read_text()
    consts = {k: int(v) for k, v in re.findall(r"constexpr int (k\w+) = (\d+);", src)}
    names = ("kThreads", "kTileM", "kTileN", "kTileK", "kChunkK", "kAttnRows", "kAttnCols",
             "kSumRows", "kSliceRows", "kMaxSlices", "kAlign")
    assert tuple(consts[k] for k in names) == tblock.STREAMED_CONSTANTS
    body = re.search(r"block_streamed_constants\(int\* out\) \{\n  const int c\[\] = "
                     r"\{([^}]*)\}", src).group(1)
    assert tuple(x.strip() for x in body.split(",")) == names


class _Recorder:
    """A stand-in for a built library: records each entry point's arguments
    and returns 0."""

    def __init__(self):
        self.calls = {}

    def __getattr__(self, name):
        def call(*args):
            self.calls[name] = args
            return 0
        return call


@pytest.mark.parametrize("shape", [(2, 17, 16, 2, 64), (2, 17, 20, 5, 60), (2, 300, 16, 2, 64)])
def test_wrappers_dispatch_by_plan(monkeypatch, shape):
    """Each wrapper launches the design ``block_plan`` names, hands the
    streamed kernels a workspace of ``workspace_bytes`` and counts the
    launch under that design alone."""
    b, n, dim, heads, m = shape
    lib = _Recorder()
    for name in ("_lib", "_lib_streamed"):
        monkeypatch.setattr(tblock, name, lambda: lib)
    monkeypatch.setattr(tblock, "_check", lambda x, w, h, backward, dy=None: (b, n, dim, m))
    monkeypatch.setattr(tblock, "_stream", lambda dev: None)
    monkeypatch.setattr(tblock.torch.cuda, "device", lambda dev: contextlib.nullcontext())
    w = _small_weights(dim, m, torch.float32)
    x = torch.zeros(b, n, dim)
    for backward in (False, True):
        before = (tblock.LAUNCHES_FWD, tblock.LAUNCHES_BWD, tblock.LAUNCHES_FWD_STREAMED,
                  tblock.LAUNCHES_BWD_STREAMED)
        lib.calls.clear()
        if backward:
            tblock._kernel_backward(x, x, w, heads)
        else:
            tblock._kernel_forward(x, w, heads)
        streamed = tblock.block_plan(b, n, dim, heads, m, backward) == "streamed"
        entry = {(False, False): "block_forward", (False, True): "block_streamed_forward",
                 (True, False): "block_backward", (True, True): "block_streamed_backward"}
        assert list(lib.calls) == [entry[(backward, streamed)]]
        args = lib.calls[entry[(backward, streamed)]]
        if streamed:
            assert args[7 if backward else 5] == (
                tblock.workspace_bytes(b, n, dim, heads, m, backward) // 4)
            assert args[-7:-2] == (b, n, dim, heads, m)
        after = (tblock.LAUNCHES_FWD, tblock.LAUNCHES_BWD, tblock.LAUNCHES_FWD_STREAMED,
                 tblock.LAUNCHES_BWD_STREAMED)
        bumped = [a - c for a, c in zip(after, before)]
        assert bumped == [int(k == (backward, streamed)) for k in
                          ((False, False), (True, False), (False, True), (True, True))]


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
