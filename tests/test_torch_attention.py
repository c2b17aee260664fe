"""The port's attention kernels' plain versions and autograd ops against the
JAX package, on the CPU.

The JAX side runs its Pallas kernels in interpret mode, as
``tests/test_pallas_kernels.py`` does; the port runs the plain PyTorch
versions, which its wrappers take for CPU tensors. Inputs are numpy arrays
from a seed, handed to both. Tolerances are the JAX tests' own: 1e-5 for
the fused op's values and gradients (``test_pallas_kernels.py:42,63``),
atol 2e-4 / rtol 1e-3 for the hybrid op's gradients (``:341``).
"""

import glob
import re
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml

from vitsom_tpu.ops import attention as jattn
from vitsom_tpu.ops import attention_pallas as jpallas
from vitsom_tpu_torch.ops import attention as tattn
from vitsom_tpu_torch.ops import attention_fused as tfused

TOL = 1e-5


def _inputs(shape, seed, n=3):
    rng = np.random.default_rng(seed)
    return [rng.normal(size=shape).astype(np.float32) for _ in range(n)]


def _t(a, grad=False):
    return torch.from_numpy(np.array(a)).requires_grad_(grad)


@pytest.mark.parametrize("shape", [(2, 197, 2, 8), (2, 65, 3, 64), (1, 17, 4, 48), (2, 197, 2, 2)])
def test_fused_attention_and_lse_match_jax(shape):
    b, n, h, hd = shape
    q, k, v = _inputs(shape, 0)
    jout, (_, _, _, _, jlse) = jpallas._fused_attention_fwd_impl(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v)
    )
    tout = tfused.fused_attention(_t(q), _t(k), _t(v))
    np.testing.assert_allclose(tout.numpy(), np.asarray(jout), atol=TOL, rtol=TOL)
    _, tlse = tfused.attention_forward(
        *(_t(x).reshape(b, n, h * hd) for x in (q, k, v)), h
    )
    assert tlse.shape == (b, h, n)
    np.testing.assert_allclose(tlse.numpy(), np.asarray(jlse), atol=TOL, rtol=TOL)


def test_fused_attention_grads_match_jax():
    shape = (2, 33, 2, 16)
    q, k, v, cot = _inputs(shape, 1, n=4)

    def loss(q, k, v):
        return jnp.sum(jpallas.fused_attention(q, k, v) * jnp.asarray(cot))

    jg = jax.grad(loss, argnums=(0, 1, 2))(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    tq, tk, tv = (_t(x, grad=True) for x in (q, k, v))
    torch.sum(tfused.fused_attention(tq, tk, tv) * _t(cot)).backward()
    for name, a, b_ in zip("qkv", (tq.grad, tk.grad, tv.grad), jg):
        np.testing.assert_allclose(a.numpy(), np.asarray(b_), atol=TOL, rtol=TOL, err_msg=name)


@pytest.mark.parametrize("shape", [(2, 197, 2, 2), (2, 65, 3, 32)])
def test_bwd_reference_matches_jax_bwd_impl(shape):
    """The backward kernel's plain version against ``_fused_attention_bwd_impl``
    on the same residuals (from JAX's forward) and the same cotangent."""
    b, n, h, hd = shape
    q, k, v, g = _inputs(shape, 2, n=4)
    _, res = jpallas._fused_attention_fwd_impl(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    jgrads = jpallas._fused_attention_bwd_impl(res, jnp.asarray(g))
    qr, kr, vr, o, lse = (_t(x) for x in res)
    tgrads = tfused.fused_attention_bwd_reference(
        qr, kr, vr, o, lse, _t(g).reshape(b, n, h * hd), h
    )
    for name, a, b_ in zip("qkv", tgrads, jgrads):
        assert a.shape == (b, n, h * hd)
        np.testing.assert_allclose(
            a.numpy(), np.asarray(b_).reshape(b, n, h * hd), atol=TOL, rtol=TOL, err_msg=name
        )


def test_hybrid_attention_matches_jax():
    q, k, v = _inputs((8, 33, 2, 8), 5)
    jq, jk, jv = (jnp.asarray(x) for x in (q, k, v))
    tq, tk, tv = (_t(x, grad=True) for x in (q, k, v))
    tout = tattn.hybrid_attention(tq, tk, tv)
    np.testing.assert_allclose(
        tout.detach().numpy(), np.asarray(jattn.hybrid_attention(jq, jk, jv)), atol=TOL, rtol=TOL
    )
    jg = jax.grad(lambda *a: jnp.sum(jattn.hybrid_attention(*a) ** 2), argnums=(0, 1, 2))(jq, jk, jv)
    torch.sum(tout**2).backward()
    for name, a, b_ in zip("qkv", (tq.grad, tk.grad, tv.grad), jg):
        np.testing.assert_allclose(a.numpy(), np.asarray(b_), atol=2e-4, rtol=1e-3, err_msg=name)


@pytest.mark.parametrize("impl", ["pallas", "hybrid"])
def test_strided_qkv_views_match_contiguous(impl):
    """q, k, v sliced out of a fused [B, N, 3, H, hd] buffer, as the model
    hands them over, give the values and gradients of contiguous copies."""
    b, n, h, hd = 2, 33, 2, 8
    (buf,) = _inputs((b, n, 3, h, hd), 6, n=1)
    (cot,) = _inputs((b, n, h, hd), 7, n=1)
    qkv = _t(buf, grad=True)
    views = qkv[:, :, 0], qkv[:, :, 1], qkv[:, :, 2]
    assert views[0].reshape(b, n, h * hd).stride() == (n * 3 * h * hd, 3 * h * hd, 1)
    out_v, _ = tattn.multi_head_attention(*views, impl=impl)
    torch.sum(out_v * _t(cot)).backward()
    dense = [_t(buf[:, :, i], grad=True) for i in range(3)]
    assert all(x.is_contiguous() for x in dense)
    out_c, _ = tattn.multi_head_attention(*dense, impl=impl)
    torch.sum(out_c * _t(cot)).backward()
    np.testing.assert_allclose(out_v.detach().numpy(), out_c.detach().numpy(), atol=1e-6, rtol=1e-6)
    for i in range(3):
        np.testing.assert_allclose(
            qkv.grad[:, :, i].numpy(), dense[i].grad.numpy(), atol=1e-6, rtol=1e-6
        )


def test_cpu_path_launches_no_kernel():
    q, k, v = (_t(x, grad=True) for x in _inputs((2, 17, 2, 8), 8))
    fwd, bwd = tfused.LAUNCHES_FWD, tfused.LAUNCHES_BWD
    for impl in ("pallas", "hybrid"):
        out, _ = tattn.multi_head_attention(q, k, v, impl=impl)
        out.sum().backward()
    assert (tfused.LAUNCHES_FWD, tfused.LAUNCHES_BWD) == (fwd, bwd)
    # the kernel wrappers themselves refuse CPU tensors rather than fall back
    flat = q.detach().reshape(2, 17, 16)
    with pytest.raises(ValueError, match="CUDA"):
        tfused._kernel_forward(flat, flat, flat, 2)
    assert tfused.LAUNCHES_FWD == fwd


@pytest.mark.parametrize("impl", ["pallas", "hybrid"])
def test_return_attn_and_bias_take_xla_path(impl):
    """With ``return_attn`` or a ``bias`` both impls take the f32 XLA path,
    as the JAX package's dispatch does (``attention.py:244-254``)."""
    shape = (2, 17, 2, 8)
    q, k, v = _inputs(shape, 9)
    (bias,) = _inputs((2, 17, 17), 10, n=1)
    jargs = [jnp.asarray(x) for x in (q, k, v)]
    targs = [_t(x) for x in (q, k, v)]
    jo, ja = jattn.multi_head_attention(*jargs, impl=impl, return_attn=True)
    to, ta = tattn.multi_head_attention(*targs, impl=impl, return_attn=True)
    np.testing.assert_allclose(to.numpy(), np.asarray(jo), atol=TOL, rtol=TOL)
    np.testing.assert_allclose(ta.numpy(), np.asarray(ja), atol=TOL, rtol=TOL)
    jo, ja = jattn.multi_head_attention(*jargs, impl=impl, bias=jnp.asarray(bias))
    to, ta = tattn.multi_head_attention(*targs, impl=impl, bias=_t(bias))
    assert ja is None and ta is None
    np.testing.assert_allclose(to.numpy(), np.asarray(jo), atol=TOL, rtol=TOL)
    xo, _ = tattn.xla_attention(*targs, bias=_t(bias))
    np.testing.assert_array_equal(to.numpy(), xo.numpy())


def test_shipped_vit_head_dims_are_built():
    """Every head_dim and sequence length of a shipped ViT config is one the
    kernels are built for and whose operands fit in a block's shared memory."""
    seen = set()
    for path in glob.glob("configs/*/*.yaml"):
        with open(path) as f:
            cfg = yaml.safe_load(f)
        vit, data = cfg.get("vit") or {}, cfg.get("data") or {}
        if not vit.get("emb_dim"):
            continue
        n = (data["input_size"] // vit["patch_size"]) ** 2 + 1
        for emb in (vit["emb_dim"], vit.get("dec_emb_dim")):
            if emb:
                hd = emb // vit["heads"]
                seen.add((hd, n))
                assert tfused.head_tier(hd) == hd, (path, hd)
                assert tfused.smem_bytes(n, hd, backward=True) <= tfused.SMEM_LIMIT_BYTES, path
    assert {2, 8, 32, 64} <= {hd for hd, _ in seen}
    assert max(n for _, n in seen) == 257


def test_tiles_and_shared_memory_match_the_kernel_source():
    """The wrapper plans the tensor-core kernels' grid, shared memory and dq
    workspace with the source's tile constants (and refuses a built library
    whose constants differ); its ``mma_plan`` and ``smem_bytes`` give the
    chunks, warps, CTAs and bytes the source's header states per shape."""
    src = (Path(tfused.__file__).parent / "csrc" / "attention.cu").read_text()
    consts = {k: int(v) for k, v in
              re.findall(r"constexpr int (kRowTile|kMaxWarps|kPad|kKeyBlock) = (\d+);", src)}
    assert consts == {"kRowTile": tfused.ROW_TILE, "kMaxWarps": tfused.MAX_WARPS,
                      "kPad": tfused.SMEM_PAD, "kKeyBlock": tfused.KEY_BLOCK}
    def tiers(name):
        body = re.search(rf"#define {name}\(X\)((?:[^\n]*\\\n)*[^\n]*)", src).group(1)
        return tuple(int(x) for x in re.findall(r"X\((\d+)\)", body))

    assert tiers("ATTN_ROW_TIERS") == tfused.ROW_TIERS
    assert tiers("ATTN_MMA_TIERS") == tfused.MMA_TIERS
    # the shipped (2, 8, 32, 64) and JAX-test (16, 48) head dims are tiers
    # of their own, from 32 up the tensor-core kernels'
    assert {2, 8, 16} <= set(tfused.ROW_TIERS)
    assert {32, 48, 64} <= set(tfused.MMA_TIERS)
    rows = re.findall(
        r"smem N (\d+), hd (\d+): (\d+) x (\d+), (\d+) CTAs(?: at B (\d+))?; "
        r"forward (\d+) B, backward (\d+) B", src)
    assert len(rows) == 3  # hd 64 at N 65, 197, 257 (hd 32 there runs the row kernels)
    for n, hd, chunks, warps, ctas, batch, fwd, bwd in rows:
        n, hd = int(n), int(hd)
        assert tfused.mma_plan(n) == (int(chunks), int(warps))
        assert int(ctas) == int(batch or 128) * 3 * int(chunks)
        assert tfused.smem_bytes(n, hd, backward=False) == int(fwd)
        assert tfused.smem_bytes(n, hd, backward=True) == int(bwd)


def _vit_shapes(path):
    """{(N, head_dim)} of a config's encoder and decoder attention."""
    with open(path) as f:
        cfg = yaml.safe_load(f)
    vit, data = cfg["vit"], cfg["data"]
    n = (data["input_size"] // vit["patch_size"]) ** 2 + 1
    return {(n, emb // vit["heads"]) for emb in (vit["emb_dim"], vit.get("dec_emb_dim")) if emb}


@pytest.mark.parametrize("path", sorted(glob.glob("configs/vit_som/*.yaml")))
def test_check_shape_takes_every_shipped_vit_som_shape(path):
    """``check_shape`` (the shape rules ``_check`` applies before a launch)
    accepts each (N, head_dim) of the config, forward and backward; with
    hd >= 32 the tensor-core kernels' shared memory at that N fits."""
    for n, hd in _vit_shapes(path):
        for backward in (False, True):
            tfused.check_shape(n, hd, backward)
            assert tfused.smem_bytes(n, hd, backward) <= tfused.SMEM_LIMIT_BYTES


def test_check_shape_refuses_what_the_kernels_do_not_take():
    # every head dim up to 192 runs at a tier (hd 24 at its own); past it
    # the refusal names the widest
    tfused.check_shape(65, 24, backward=False)
    with pytest.raises(ValueError, match="outside 1..192"):
        tfused.check_shape(65, 200, backward=False)
    # the tensor-core kernels stream keys (forward) and query tiles
    # (backward); only the backward's lse and delta rows grow with N
    assert tfused.smem_bytes(4096, 64, backward=False) == tfused.smem_bytes(65, 64, backward=False)
    tfused.check_shape(4096, 64, backward=True)
    with pytest.raises(ValueError, match="shared memory"):
        tfused.check_shape(30000, 64, backward=True)
    # the row kernels stage all of K and V
    with pytest.raises(ValueError, match="shared memory"):
        tfused.check_shape(4096, 8, backward=False)
    assert tfused.mma_plan(65) == (1, 5) and tfused.mma_plan(128) == (1, 8)
    assert tfused.mma_plan(129) == (2, 5) and tfused.mma_plan(257) == (3, 6)


@pytest.mark.parametrize(
    "over,want",
    [({}, "xla"), ({"train.use_pallas_attention": True}, "pallas"),
     ({"train.use_pallas_attention": True, "train.attn_impl": "hybrid"}, "hybrid")],
)
def test_config_selects_attention_impl(over, want):
    """``train.attn_impl``, else ``pallas`` when ``use_pallas_attention`` is
    set, as the JAX trainer chooses (``vitsom_tpu/train/trainer.py:52-55``);
    every attention module of the built model carries it."""
    from vitsom_tpu.config import load_config as jload
    from vitsom_tpu.train.trainer import build_model
    from vitsom_tpu_torch.config import load_config
    from vitsom_tpu_torch.models import vit as tvit
    from vitsom_tpu_torch.models.vit_som import build_model as tbuild_model, model_attn_impl

    path = "configs/vit_som/vit_som_mnist.yaml"
    small = {"som.map_size": [2, 2], **over}
    assert build_model(jload(path, small)).attn_impl == want
    cfg = load_config(path, small)
    assert model_attn_impl(cfg) == want
    impls = {m.attn_impl for m in tbuild_model(cfg, device="cpu").modules()
             if isinstance(m, tvit.Attention)}
    assert impls == {want}


# the row kernels' (hd <= 16) shapes: every shipped one (B, N, H, hd), and
# the JAX tests' hd 16 and ragged N 9 (tests/test_pallas_kernels.py:48, :69)
ROW_SHAPES = [(128, 197, 2, 8), (128, 197, 2, 2), (128, 65, 2, 8), (128, 65, 2, 2),
              (128, 257, 2, 8), (128, 257, 2, 2), (2, 33, 2, 16), (1, 9, 1, 8)]


def test_row_plan_and_shared_memory_match_the_kernel_source():
    """The wrapper's row-kernel constants are the source's, and its
    ``row_plan`` and ``smem_bytes`` give the chunks, threads, CTAs and bytes
    the source's header states for each row shape (the resident CTAs an SM
    there are the card's, which ``chip_smoke.py`` phase 9 prints)."""
    src = (Path(tfused.__file__).parent / "csrc" / "attention.cu").read_text()
    consts = {k: int(v) for k, v in re.findall(
        r"constexpr int (kRowThreads|kRowLanes|kRowRows) = (\d+);", src)}
    assert consts == {"kRowThreads": tfused.ROW_THREADS, "kRowLanes": tfused.ROW_LANES,
                      "kRowRows": tfused.ROW_ROWS}
    rows = re.findall(
        r"rows (fwd|bwd) N (\d+), hd (\d+): (\d+)(?: \+ (\d+))? x (\d+) threads, (\d+) CTAs "
        r"at B (\d+), H (\d+); (\d+) B; (\d+) an SM", src)
    assert len(rows) == 2 * len(ROW_SHAPES)
    seen = set()
    for kind, n, hd, ca, cb, threads, ctas, b, h, smem, _ in rows:
        n, hd, b, h = int(n), int(hd), int(b), int(h)
        backward = kind == "bwd"
        plan = tfused.row_plan(n, hd, backward)
        want = (int(ca), int(cb), int(threads)) if backward else (int(ca), int(threads))
        assert plan == want, (kind, n, hd)
        assert int(ctas) == b * h * sum(plan[:-1])
        assert tfused.smem_bytes(n, hd, backward) == int(smem)
        seen.add((kind, (b, n, h, hd)))
    assert seen == {(kind, s) for s in ROW_SHAPES for kind in ("fwd", "bwd")}


@pytest.mark.parametrize("hd", [2, 8, 16])
def test_row_plan_gives_every_chunk_rows(hd):
    """Every chunk of ``row_plan`` holds at least one row and at most a
    CTA's worth, in whole warps (the kernels rely on it); the tensor-core
    head dims have no row plan."""
    lanes, per_group = tfused.ROW_LANES, tfused.ROW_ROWS
    assert 32 % lanes == 0 and tfused.ROW_THREADS % 32 == 0
    for n in range(1, 300):
        for backward in (False, True):
            plan = tfused.row_plan(n, hd, backward)
            chunks, threads = plan[0], plan[-1]
            if backward:
                assert plan[1] == chunks
            rows = -(-n // chunks)
            assert (chunks - 1) * rows < n <= chunks * rows
            assert threads % 32 == 0 and threads <= tfused.ROW_THREADS
            assert -(-rows // per_group) * lanes <= threads
    with pytest.raises(ValueError, match="no row kernel"):
        tfused.row_plan(65, 64, False)


@pytest.mark.parametrize("shape", ROW_SHAPES)
def test_check_shape_takes_the_row_kernel_shapes(shape):
    """No alignment or size rule refuses a row shape the kernels take; the
    row kernels stage all of K and V (q and do in pass A), so shared memory
    still binds at N 4096, hd 8."""
    _, n, _, hd = shape
    for backward in (False, True):
        tfused.check_shape(n, hd, backward)
        with pytest.raises(ValueError, match="shared memory"):
            tfused.check_shape(4096, 8, backward)


def _model_qkv_views(monkeypatch):
    """q, k, v of every attention call of the flagship ViT-SOM's forward on
    the CPU, as the model slices them out of its fused qkv buffer, in the
    [B, N, D] layout the kernels take."""
    from vitsom_tpu_torch.config import load_config
    from vitsom_tpu_torch.models import vit as tvit
    from vitsom_tpu_torch.models.vit_som import build_model

    calls = []
    inner = tattn.multi_head_attention

    def record(q, k, v, **kw):
        b, n, h, hd = q.shape
        calls.append(([x.reshape(b, n, h * hd) for x in (q, k, v)], hd))
        return inner(q, k, v, **kw)

    monkeypatch.setattr(tvit.attention_ops, "multi_head_attention", record)
    cfg = load_config("configs/vit_som/vit_som_mnist.yaml", {"som.map_size": [2, 2]})
    model = build_model(cfg, device="cpu")
    with torch.no_grad():
        model(torch.rand(2, 28, 28, 1))
    return calls


def test_row_copy_width_of_the_models_views(monkeypatch):
    """16-byte copies for the flagship encoder's q, k, v (hd 8: rows of 48
    floats, heads 8 floats apart), 8-byte for its decoder's (hd 2: heads 2
    floats apart); every head's row start is a multiple of the width."""
    calls = _model_qkv_views(monkeypatch)
    assert [hd for _, hd in calls] == [8] * 4 + [2] * 2
    for views, hd in calls:
        width = tfused.row_copy_width(views, hd)
        assert width == (16 if hd == 8 else 8)
        for x in views:
            assert not x.is_contiguous() and x.stride(1) == 3 * x.shape[2]
            for h in range(x.shape[2] // hd):
                assert (x.data_ptr() + 4 * h * hd) % width == 0


def test_row_copy_width_of_an_odd_view():
    """Rows starting 4 bytes off an 8-byte boundary copy 4 bytes at a time;
    an odd row stride does too."""
    buf = torch.zeros(2, 9, 3 * 16 + 1)
    views = [buf[:, :, 1 + 16 * i:17 + 16 * i] for i in range(3)]
    assert tfused.row_copy_width(views, 8) == 4
    assert tfused.row_copy_width(views, 2) == 4
    dense = [torch.zeros(2, 9, 16) for _ in range(3)]
    assert tfused.row_copy_width(dense, 8) == 16 and tfused.row_copy_width(dense, 2) == 8
    assert tfused.row_copy_width([buf[:, :, :16]], 8) == 4
