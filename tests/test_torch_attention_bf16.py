"""The plain versions of the bf16 attention kernels against the JAX package's
Pallas kernels on bf16 inputs, on the CPU.

The JAX side runs ``fused_attention`` and its VJP in interpret mode, as
``tests/test_pallas_kernels.py`` does; the port runs the plain PyTorch
versions that its wrappers take for CPU tensors. Both round at the same
points (bf16 attn before the product with v, bf16 p and ds before theirs,
bf16 outputs), so they differ only where a different float32 summation
order flips a bf16 rounding. The bound: within 1 bf16 ulp of the JAX
element on all but 0.1 % of the elements, and atol 1e-2 / rtol 1e-2
everywhere (hybrid's float32 output too); lse, float32 in both, within
1e-5. Observed at the shapes below
(numpy seed 0): at most 0.13 % of an output's elements differ at all, and
none by more than 1 ulp.
"""

import contextlib
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vitsom_tpu.ops import attention as jattn
from vitsom_tpu.ops import attention_pallas as jpallas
from vitsom_tpu_torch.ops import attention as tattn
from vitsom_tpu_torch.ops import attention_fused as tfused

SHAPES = [(2, 197, 2, 8), (2, 197, 2, 2), (2, 65, 3, 64), (2, 33, 2, 32), (2, 65, 2, 8),
          (2, 33, 2, 16), (1, 9, 1, 8)]
# past 320 keys: the two-pass forwards (mma.sync at hd 8, wgmma at hd 64)
SHAPES += [(1, 401, 2, 8), (1, 401, 1, 64)]


@pytest.fixture(autouse=True)
def _two_threads():
    """Two intra-op threads: the suite runs several workers on the same
    cores, and torch's default of one thread a core oversubscribes them."""
    threads = torch.get_num_threads()
    torch.set_num_threads(min(threads, 2))
    yield
    torch.set_num_threads(threads)


def _inputs(shape, seed, n=4):
    """bf16 arrays of numpy normals, as JAX arrays and as torch tensors."""
    rng = np.random.default_rng(seed)
    jx = [jnp.asarray(rng.normal(size=shape).astype(np.float32), jnp.bfloat16)
          for _ in range(n)]
    return jx, [_t(x) for x in jx]


def _t(x, grad=False):
    t = torch.from_numpy(np.array(jnp.asarray(x).astype(jnp.float32)))
    return t.to(torch.bfloat16 if x.dtype == jnp.bfloat16 else torch.float32).requires_grad_(grad)


def _ulp(ref: np.ndarray) -> np.ndarray:
    """The bf16 spacing at each element (8 significant bits)."""
    mag = np.maximum(np.abs(ref), np.float32(2.0**-126))
    return np.exp2(np.floor(np.log2(mag)) - 7)


def _assert_bf16_close(got: torch.Tensor, want, name):
    got = got.detach().float().numpy().reshape(-1)
    want = np.asarray(jnp.asarray(want).astype(jnp.float32)).reshape(-1)
    np.testing.assert_allclose(got, want, atol=1e-2, rtol=1e-2, err_msg=name)
    beyond = np.abs(got - want) > _ulp(want)
    assert beyond.mean() <= 1e-3, (name, beyond.mean())


@pytest.mark.parametrize("shape", SHAPES)
def test_bf16_forward_reference_matches_jax(shape):
    b, n, h, hd = shape
    (jq, jk, jv, _), (tq, tk, tv, _) = _inputs(shape, 0)
    jout, (_, _, _, _, jlse) = jpallas._fused_attention_fwd_impl(jq, jk, jv)
    assert jout.dtype == jnp.bfloat16
    to, tlse = tfused.attention_forward(*(x.reshape(b, n, h * hd) for x in (tq, tk, tv)), h)
    assert to.dtype == torch.bfloat16 and tlse.dtype == torch.float32
    _assert_bf16_close(to, jout.reshape(b, n, h * hd), "o")
    np.testing.assert_allclose(tlse.numpy(), np.asarray(jlse), atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("shape", SHAPES)
def test_bf16_backward_reference_matches_jax_vjp(shape):
    """dq, dk, dv of the autograd op (the plain backward on the CPU) against
    the VJP of JAX's ``fused_attention`` with the same bf16 cotangent."""
    (jq, jk, jv, jg), (tq, tk, tv, tg) = _inputs(shape, 1)
    _, vjp = jax.vjp(jpallas.fused_attention, jq, jk, jv)
    jgrads = vjp(jg)
    tq, tk, tv = (x.requires_grad_(True) for x in (tq, tk, tv))
    out = tfused.fused_attention(tq, tk, tv)
    assert out.dtype == torch.bfloat16
    out.backward(tg)
    for name, a, b_ in zip(("dq", "dk", "dv"), (tq.grad, tk.grad, tv.grad), jgrads):
        assert a.dtype == torch.bfloat16 and b_.dtype == jnp.bfloat16
        _assert_bf16_close(a, b_, name)


@pytest.mark.parametrize("shape", [(2, 197, 2, 8), (2, 65, 3, 64), (2, 401, 2, 8)])
def test_bf16_hybrid_matches_jax(shape):
    """``hybrid`` on bf16 inputs: ``_hybrid_fwd``'s float32 output, and the
    backward kernel's plain version fed that float32 o. The cotangent holds
    bf16 values, as in the models (they cast the output to bf16 next)."""
    (jq, jk, jv, jg), (tq, tk, tv, _) = _inputs(shape, 2)
    jg = jg.astype(jnp.float32)
    jout, vjp = jax.vjp(jattn.hybrid_attention, jq, jk, jv)
    assert jout.dtype == jnp.float32
    jgrads = vjp(jg)
    tq, tk, tv = (x.requires_grad_(True) for x in (tq, tk, tv))
    out = tattn.hybrid_attention(tq, tk, tv)
    assert out.dtype == torch.float32
    # float32 sums of bf16 attn times v: a flipped rounding of one attn
    # moves a whole output row by a bf16 ulp of attn times v, which stays
    # under a bf16 ulp of the row's elements
    _assert_bf16_close(out, jout, "out")
    out.backward(_t(jg))
    for name, a, b_ in zip(("dq", "dk", "dv"), (tq.grad, tk.grad, tv.grad), jgrads):
        _assert_bf16_close(a, b_, name)


def test_bf16_hybrid_takes_a_float32_cotangent():
    """hybrid's float32 output takes a float32 cotangent that bf16 cannot
    hold: the backward uses it unrounded, as JAX's ``_hybrid_bwd`` passes
    its float32 g to the kernel, and its gradients differ from those of
    the bf16-rounded cotangent."""
    shape = (2, 65, 3, 64)
    b, n, h, hd = shape
    (jq, jk, jv, _), (tq, tk, tv, _) = _inputs(shape, 5)
    jg = jnp.asarray(np.random.default_rng(6).normal(size=shape).astype(np.float32))
    assert not bool(jnp.all(jg.astype(jnp.bfloat16).astype(jnp.float32) == jg))
    _, vjp = jax.vjp(jattn.hybrid_attention, jq, jk, jv)
    jgrads = vjp(jg)
    leaves = [x.requires_grad_(True) for x in (tq, tk, tv)]
    tattn.hybrid_attention(*leaves).backward(_t(jg))
    for name, a, b_ in zip(("dq", "dk", "dv"), (x.grad for x in leaves), jgrads):
        _assert_bf16_close(a, b_, name)
    qr, kr, vr = (x.detach().reshape(b, n, h * hd) for x in leaves)
    o, lse = tfused.fused_attention_reference(qr, kr, vr, h)
    g = _t(jg).reshape(b, n, h * hd)
    grads = tfused.attention_backward(qr, kr, vr, o, lse, g, h)
    rounded = tfused.attention_backward(qr, kr, vr, o, lse, g.to(torch.bfloat16).float(), h)
    assert all(torch.equal(x.grad.reshape(b, n, h * hd), y) for x, y in zip(leaves, grads))
    assert any(not torch.equal(x, y) for x, y in zip(grads, rounded))


def test_bf16_backward_takes_a_float32_o():
    """The plain backward's delta is taken over the stored o whatever its
    dtype: hybrid's float32 o gives the JAX kernel's gradients on the same
    residuals, which differ from those over the bf16-rounded o."""
    shape = (2, 33, 2, 32)
    b, n, h, hd = shape
    (jq, jk, jv, jg), (tq, tk, tv, tg) = _inputs(shape, 3)
    _, res = jattn._hybrid_fwd(jq, jk, jv)
    jgrads = jpallas._fused_attention_bwd_impl(res, jg)
    qr, kr, vr, o, lse = (_t(x) for x in res)
    assert o.dtype == torch.float32
    grads = tfused.attention_backward(qr, kr, vr, o, lse, tg.reshape(b, n, h * hd), h)
    for name, a, b_ in zip(("dq", "dk", "dv"), grads, jgrads):
        _assert_bf16_close(a, b_.reshape(b, n, h * hd), name)
    rounded = tfused.attention_backward(qr, kr, vr, o.to(torch.bfloat16), lse,
                                        tg.reshape(b, n, h * hd), h)
    assert any(not torch.equal(x, y) for x, y in zip(grads, rounded))


@pytest.mark.parametrize("impl", ["pallas", "hybrid"])
def test_multi_head_attention_takes_bf16_to_the_plain_bf16_versions(impl):
    """bf16 CPU tensors given to ``pallas`` or ``hybrid`` reach the plain
    version: bf16 o from ``pallas`` (its accumulated o rounded), hybrid's
    float32 output (the accumulated o), equal to it bit for bit."""
    shape = (2, 17, 2, 8)
    b, n, h, hd = shape
    _, (tq, tk, tv, _) = _inputs(shape, 4)
    out, attn = tattn.multi_head_attention(tq, tk, tv, impl=impl)
    assert attn is None
    flat = [x.reshape(b, n, h * hd) for x in (tq, tk, tv)]
    want, _ = tfused.fused_attention_reference(*flat, h)
    assert want.dtype == torch.float32
    if impl == "pallas":
        want = want.to(torch.bfloat16)
    assert out.dtype == want.dtype
    assert torch.equal(out.reshape(b, n, h * hd), want)


def test_bf16_kernel_shapes_fit_shared_memory():
    """The bf16 shapes of the shipped configs (N 65, 197, 257 at hd 2, 8,
    32, 64: every ViT-SOM and ViT yaml's encoder and decoder) and the JAX
    tests' hd 48 fit in a CTA's shared memory, and N 8192 at hd 8 does not
    (the forward stages k and v of every key: 256 KB);
    the bf16 kernels' constants are the source's."""
    src = (Path(tfused.__file__).parent / "csrc" / "attention_bf16.cu").read_text()
    assert f"constexpr int kTile = {tfused.BF16_TILE};" in src
    assert f"constexpr int kHdp = {tfused.BF16_HDP};" in src
    assert f"constexpr int kMaxKeyBlocks = {tfused.BF16_MAX_KEY_BLOCKS};" in src
    assert f"constexpr int kSmemAlign = {tfused.BF16_SMEM_ALIGN};" in src
    shipped = [(n, hd) for n in (65, 197, 257) for hd in (2, 8, 32, 64)]
    for n, hd in shipped + [(33, 48)]:
        for backward, f32_do in ((False, False), (True, False), (True, True)):
            tfused.check_shape(n, hd, backward, torch.bfloat16, f32_do)
    with pytest.raises(ValueError, match="shared memory"):
        tfused.check_shape(8192, 8, False, torch.bfloat16)
    # the forward holds all of k and v at hd 64: five [64][64] bf16 tiles
    # of each at N 257, two q tiles and the o tile, 1 KB of alignment slack,
    # 128 bytes for its mbarriers
    assert tfused.bf16_smem_bytes(257, 64, False) == 1024 + (2 * 5 + 3) * 64 * 64 * 2 + 128
    # a float32 do (hybrid) adds its two lower bf16 parts to both ring stages
    assert (tfused.bf16_smem_bytes(257, 64, True, True)
            - tfused.bf16_smem_bytes(257, 64, True)) == 2 * 2 * 64 * 64 * 2
    # past 320 keys the two-pass forward streams k and v: its q tile, two
    # ring stages of k and v, the o tile, three mbarriers, at any N
    for n in (321, 1025, 4096):
        assert tfused.bf16_smem_bytes(n, 64, False) == 1024 + 6 * 64 * 64 * 2 + 3 * 8


@pytest.mark.parametrize("n, hd", [(n, hd) for n in (65, 197, 257) for hd in (32, 64)]
                         + [(33, 48)])
def test_bf16_tensor_core_launch_plan(n, hd):
    """The wgmma kernels' grid and shared memory at every shipped hd >= 32
    shape and the JAX tests' (33, 48): one forward CTA a (b, h) holding
    ceil(N / 64) key blocks (its scores in registers), a key-role and a
    query-role backward CTA a 64-row tile; the layout is the same at every
    hd (padded to 64), the forward's grows with N, the backward's does not.
    An H100 SM (228 KB, 1 KB reserved a CTA) holds two forward CTAs, three
    bf16 backward CTAs (its launch bounds' count) and two of hybrid's."""
    tiles = -(-n // 64)
    assert tfused.bf16_mma_plan(n) == (1, tiles, 2 * tiles)
    tile = 64 * 64 * 2
    fwd = tfused.bf16_smem_bytes(n, hd, False)
    assert fwd == 1024 + (2 * tiles + 3) * tile + 128
    assert fwd == tfused.bf16_smem_bytes(n, 64, False)
    bwd = tfused.bf16_smem_bytes(n, hd, True)
    hybrid = tfused.bf16_smem_bytes(n, hd, True, f32_do=True)
    assert bwd == 1024 + 6 * tile + 2 * 2 * 64 * 4 + 3 * 8
    assert hybrid == 1024 + 10 * tile + 2 * 2 * 64 * 4 + 3 * 8
    sm = 228 * 1024
    assert 2 * (fwd + 1024) <= sm
    assert 3 * (bwd + 1024) <= sm
    assert 2 * (hybrid + 1024) <= sm


def test_bf16_forward_refuses_more_keys_than_its_registers_hold():
    """The one-pass forwards keep a row's scores in registers, 320 keys at
    most at hd >= 32 (5 * 64), 72 below (9 8-key tiles: past them the
    two-pass form is measured as fast or faster); past them the two-pass
    forwards take the call, so every N from 321 to 1025 is taken forward,
    backward and on hybrid's float32 o and do at every built hd, by the
    kernels ``bf16_kernel`` names."""
    for hd in (2, 8, 16, 32, 48, 64):  # the shipped and JAX-test head dims
        kind = "mma" if tfused.bf16_tier(hd) >= tfused.BF16_HDP else "hmma"
        one_pass = 320 if kind == "mma" else 72
        assert tfused.bf16_kernel(one_pass, hd) == f"attn_fwd_{kind}_bf16"
        assert tfused.bf16_kernel(one_pass + 1, hd) == f"attn_fwd_{kind}2_bf16"
        for n in range(321, 1026):
            for backward, f32_do in ((False, False), (True, False), (True, True)):
                tfused.check_shape(n, hd, backward, torch.bfloat16, f32_do)
            assert tfused.bf16_kernel(n, hd) == f"attn_fwd_{kind}2_bf16"
            assert tfused.bf16_kernel(n, hd, backward=True) == f"attn_bwd_{kind}_bf16"
        assert tfused.bf16_hmma_score_tiles(72) == 9 and tfused.bf16_hmma_score_tiles(73) == 0


@pytest.mark.parametrize("d", [96, 144, 192])
def test_16_byte_rows_take_the_model_views(d):
    """q, k and v sliced out of the model's [B, N, 3, D] qkv buffer (D 96,
    144, 192: hd 32, 48, 64 at 3 heads) start their rows on 16-byte
    boundaries in bf16 and float32, and so do contiguous tensors: the
    tensor-core kernels copy them 16 bytes at a time (``wide_copies``). A
    view one element off, or with an odd row stride, takes narrower copies,
    and the bf16 forward then runs its two-pass form."""
    hd = d // 3
    for dtype in (torch.bfloat16, torch.float32):
        buf = torch.zeros(2, 9, 3, d, dtype=dtype)
        views = [buf[:, :, i] for i in range(3)]
        assert tfused.wide_copies(views, hd)
        assert tfused.wide_copies([torch.zeros(2, 9, d, dtype=dtype)], hd)
        flat = torch.zeros(2, 9, 3 * d + 1, dtype=dtype)
        assert not tfused.wide_copies([flat[:, :, 1:d + 1]], hd)
        assert not tfused.wide_copies([flat[:, :, :d]], hd)
        if dtype == torch.bfloat16:
            odd = [flat[:, :, 1 + i * d:1 + (i + 1) * d] for i in range(3)]
            assert tfused.bf16_kernel(9, hd, views=views) == "attn_fwd_mma_bf16"
            assert tfused.bf16_kernel(9, hd, views=odd) == "attn_fwd_mma2_bf16"


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_bf16_delta_reference_matches_float64(dtype):
    """The backward pre-pass's plain version, delta = rowsum(do o) [B, H,
    N], against the same sum in float64 of the same stored values: bf16 o
    and do (``pallas``) or hybrid's float32 ones, within float32 rounding of
    a 64-term sum."""
    b, n, h, hd = 2, 65, 3, 64
    rng = np.random.default_rng(7)
    o, do = (torch.from_numpy(rng.normal(size=(b, n, h * hd)).astype(np.float32)).to(dtype)
             for _ in range(2))
    got = tfused.attention_delta_reference(o, do, h)
    assert got.dtype == torch.float32 and tuple(got.shape) == (b, h, n)
    want = (o.double() * do.double()).reshape(b, n, h, hd).sum(-1).transpose(1, 2)
    np.testing.assert_allclose(got.double().numpy(), want.numpy(), rtol=0, atol=2e-5)
    # the plain backward takes its delta from it
    q, k, v = (torch.from_numpy(rng.normal(size=(b, n, h * hd)).astype(np.float32)).to(
        torch.bfloat16) for _ in range(3))
    o_ref, lse = tfused.fused_attention_reference(q, k, v, h)
    o_ref = o_ref.to(dtype)
    grads = tfused.fused_attention_bwd_reference(q, k, v, o_ref, lse, do, h)
    assert all(x.dtype == torch.bfloat16 for x in grads)


@pytest.mark.parametrize("n", [9, 33, 65, 197])
@pytest.mark.parametrize("hd", [2, 8, 16])
def test_bf16_row_plan(n, hd):
    """The bf16 row plan at N 9 / 33 / 65 / 197 and hd 2 / 8 / 16: the
    tensor-core row kernels, a 16-row tile a warp, at most 8 warps a CTA,
    the tiles spread evenly (every chunk holds a tile, none more than one
    more than another); up to N 72 a row's scores are 4 floats a lane for
    each 8-key tile of the forward's register tier (past it the two-pass
    forward); the shared memory is two [NP][hd]
    bf16 tiles (NP = N rounded up to 16) and the
    backward's lse and delta rows. hybrid's float32 o and do take the same
    backward and plan, do staged as its three bf16 parts beside the delta
    row (lse then comes from global memory)."""
    tiles = -(-n // 16)
    chunks, warps = tfused.bf16_hmma_plan(n)
    assert warps <= tfused.BF16_HMMA_WARPS and chunks * warps >= tiles
    per_chunk = [len(range(c, tiles, chunks)) for c in range(chunks)]
    assert min(per_chunk) >= 1 and max(per_chunk) - min(per_chunk) <= 1
    assert max(per_chunk) == warps
    assert chunks == {9: 1, 33: 1, 65: 1, 197: 2}[n]
    # each N up to 72 has a tier of its own: 2, 5, 9 tiles, 8 to 36 score
    # registers a lane; N 197 takes the two-pass forward
    assert tfused.bf16_hmma_score_tiles(n) == (-(-n // 8) if n <= 72 else 0)
    rows = 16 * tiles
    assert tfused.bf16_kernel(n, hd) == ("attn_fwd_hmma_bf16" if n <= 72
                                         else "attn_fwd_hmma2_bf16")
    assert tfused.bf16_kernel(n, hd, backward=True) == "attn_bwd_hmma_bf16"
    for backward in (False, True):
        smem = tfused.bf16_smem_bytes(n, hd, backward)
        assert smem == 2 * rows * hd * 2 + (8 * rows if backward else 0)
    tile = rows * hd * 2
    assert tfused.bf16_smem_bytes(n, hd, True, f32_do=True) == 4 * tile + 4 * rows


@pytest.mark.parametrize("hd", [2, 8, 16])
def test_bf16_row_shapes_stay_accepted(hd):
    """Every (N, hd) the float32 row kernels take (their shared memory, N
    up to the largest they take at each hd, forward and backward) is taken
    in bf16 too, forward, backward and on hybrid's float32 o and do, each N
    by the kernel ``bf16_kernel`` names (the one-pass forward up to N 72,
    with a register tier for every N, the two-pass past it). The bf16
    kernels' own limit lies past it: NP = 16 ceil(N / 16) staged rows of 4
    hd bytes (forward: k and v), 4 hd + 8 (backward: q, do, lse and delta)
    or 8 hd + 4 (float32 do: q, do's three parts and delta) in the
    227 KB a CTA may take; the next N is refused for shared memory."""
    limit = tfused.SMEM_LIMIT_BYTES
    for backward, f32_do in ((False, False), (True, False), (True, True)):
        last = max(n for n in range(1, 20000) if tfused.smem_bytes(n, hd, backward) <= limit)
        assert last >= 1025, (hd, backward, last)
        for n in list(range(1, 400)) + list(range(400, last + 1, 97)) + [last]:
            tfused.check_shape(n, hd, backward, torch.bfloat16, f32_do)
            got = tfused.bf16_kernel(n, hd, backward)
            want = ("attn_bwd_hmma_bf16" if backward else
                    "attn_fwd_hmma_bf16" if n <= 72 else "attn_fwd_hmma2_bf16")
            assert got == want, (n, hd, got)
            if not backward and n <= 72:
                assert 8 * tfused.bf16_hmma_score_tiles(n) >= n
        row = 8 * hd + 4 if f32_do else 4 * hd + 8 if backward else 4 * hd
        top = 16 * (limit // row // 16)
        assert top >= last
        tfused.check_shape(top, hd, backward, torch.bfloat16, f32_do)
        with pytest.raises(ValueError, match="shared memory"):
            tfused.check_shape(top + 1, hd, backward, torch.bfloat16, f32_do)


def _takes_wide_copies(views, hd: int) -> bool:
    """The tensor-core row kernels' test for 16-byte copies (hd 2: its whole
    4-byte row; ``csrc/attention_bf16.cu``: wide_views): every view's
    pointer and batch and row strides are multiples of min(hd, 8) bf16."""
    f = min(hd, 8)
    return all(x.data_ptr() % (2 * f) == 0 and x.stride(0) % f == 0 and x.stride(1) % f == 0
               for x in views)


def test_bf16_row_kernel_of_the_model_views():
    """The flagship's q, k, v (slices of the [B, N, 3, D] qkv buffer: the
    encoder's hd 8, the decoder's hd 2), USPS's and the JAX tests' row
    shapes' views take the tensor-core row kernels' 16-byte copies (hd 2:
    its whole 4-byte row) beside a contiguous o and do; a view 2 bytes off a
    4-byte boundary takes the same kernels, by 2-byte loads."""
    for (n, h, hd) in ((197, 2, 8), (197, 2, 2), (65, 2, 8), (65, 2, 2), (33, 2, 16),
                       (9, 1, 8)):
        d = h * hd
        buf = torch.zeros(2, n, 3, d, dtype=torch.bfloat16)
        views = [buf[:, :, i] for i in range(3)]
        assert _takes_wide_copies(views + [torch.zeros(2, n, d, dtype=torch.bfloat16)], hd)
        assert tfused.bf16_kernel(n, hd) == ("attn_fwd_hmma_bf16" if n <= 72
                                             else "attn_fwd_hmma2_bf16")
    odd = torch.zeros(2, 9, 49, dtype=torch.bfloat16)
    assert not _takes_wide_copies([odd[:, :, 1:17]], 8)
    assert tfused.bf16_kernel(9, 8) == "attn_fwd_hmma_bf16"


class _Recorder:
    """A stand-in for the built library: records each entry point's
    arguments and returns 0."""

    def __init__(self):
        self.calls = {}

    def __getattr__(self, name):
        def call(*args):
            self.calls[name] = args
            return 0
        return call


@pytest.mark.parametrize("n, hd", [(197, 8), (65, 2), (33, 16), (9, 8), (320, 8), (321, 8),
                                   (400, 2), (72, 8), (73, 2)])
def test_bf16_wrappers_pass_the_row_plan(monkeypatch, n, hd):
    """The kernel wrappers pass the plan that ``bf16_hmma_plan`` and
    ``bf16_hmma_score_tiles`` give (the library launches what it is
    passed): the forward's register tier (0 past N 72: the two-pass
    form), chunks and warps, and the backward's chunks and warps on bf16
    and on hybrid's float32 o and do alike."""
    lib = _Recorder()
    monkeypatch.setattr(tfused, "_lib_bf16", lambda: lib)
    monkeypatch.setattr(tfused, "_check", lambda t, heads, backward: (2, n, hd))
    monkeypatch.setattr(tfused, "_stream", lambda dev: None)
    monkeypatch.setattr(tfused.torch.cuda, "device", lambda dev: contextlib.nullcontext())
    h = 2
    x = [torch.zeros(2, n, h * hd, dtype=torch.bfloat16) for _ in range(5)]
    lse = torch.zeros(2, h, n)
    plan = tfused.bf16_hmma_plan(n)
    tiers = tfused.bf16_hmma_score_tiles(n)
    assert (tiers == 0) == (n > 72)
    tfused._kernel_forward(x[0], x[1], x[2], h)
    assert lib.calls["attention_bf16_forward"][-4:] == (tiers, *plan, None)
    tfused._kernel_backward(x[0], x[1], x[2], x[3], lse, x[4], h)
    assert lib.calls["attention_bf16_backward"][-3:] == (*plan, None)
    tfused._kernel_backward(x[0], x[1], x[2], x[3].float(), lse, x[4].float(), h)
    assert lib.calls["attention_bf16_backward"][-3:] == (*plan, None)
    assert lib.calls["attention_bf16_backward"][12] == 1  # o_do_f32


@pytest.mark.parametrize("backward", [False, True])
def test_bf16_kernel_wrapper_refuses_cpu_tensors(backward):
    """The kernel wrappers raise on tensors that are not on a CUDA device:
    only the public entry points take the plain version, and only for CPU
    tensors; a tensor on another device is refused too."""
    b, n, h, hd = 2, 33, 2, 8
    x = [torch.zeros(b, n, h * hd, dtype=torch.bfloat16) for _ in range(5)]
    lse = torch.zeros(b, h, n)
    with pytest.raises(ValueError, match="CUDA"):
        if backward:
            tfused._kernel_backward(x[0], x[1], x[2], x[3], lse, x[4], h)
        else:
            tfused._kernel_forward(x[0], x[1], x[2], h)
    meta = [t.to("meta") for t in x]
    with pytest.raises(ValueError, match="unsupported device"):
        if backward:
            tfused.attention_backward(meta[0], meta[1], meta[2], meta[3], lse.to("meta"),
                                      meta[4], h)
        else:
            tfused.attention_forward(meta[0], meta[1], meta[2], h)
