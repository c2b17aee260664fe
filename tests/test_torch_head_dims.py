"""Every head dim the JAX attention kernel takes (1-128 and 192), and the
fused SOM at any depth, on the CPU.

The port's plain attention versions (which its wrappers take for CPU
tensors) against ``_fused_attention_fwd_impl`` / ``_fused_attention_bwd_impl``
and the VJP of ``fused_attention``, run in interpret mode as
``tests/test_torch_attention.py`` runs them: float32 within 1e-5, bf16 within
``tests/test_torch_attention_bf16.py``'s bound (1 bf16 ulp on all but 0.1 %
of the elements, atol/rtol 1e-2, lse 1e-5). Then the shape rules that pick a
kernel for each (N, hd), the flagship at ``vit.heads: 4`` (head dims 4 and 1)
against the Flax model, and the fused SOM at D 33 against the JAX kernel.
"""

import contextlib
import functools
import re
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vitsom_tpu.config import load_config as jload
from vitsom_tpu.ops import attention_pallas as jpallas
from vitsom_tpu.ops import som_pallas
from vitsom_tpu.train.trainer import build_model as jbuild_model
from vitsom_tpu_torch import convert
from vitsom_tpu_torch.config import load_config
from vitsom_tpu_torch.models.vit_som import build_model as tbuild_model
from vitsom_tpu_torch.ops import attention_fused as tfused
from vitsom_tpu_torch.ops import som_fused

TOL = 1e-5
HEAD_DIMS = (1, 3, 4, 12, 24, 40, 96, 128, 192)
# (hd, (B, N, H)): each head dim at one of two shapes, in turn
CASES = [(hd, [(1, 17, 2), (2, 33, 1)][i % 2]) for i, hd in enumerate(HEAD_DIMS)]
# every hd the kernels take, at the sequence lengths the kernels' designs
# switch at (the one-pass forwards' 72 and 320 keys, the shipped 65, 197,
# 257, N 1025)
ALL_HEAD_DIMS = tuple(range(1, 129)) + (192,)
ALL_SEQ = (1, 9, 65, 197, 257, 320, 321, 1025)
SIDES = [(torch.float32, False, False), (torch.float32, True, False),
         (torch.bfloat16, False, False), (torch.bfloat16, True, False),
         (torch.bfloat16, True, True)]
# the largest N the kernels took at 2516b40 at each head dim they took then,
# float32 forward / backward, bf16 forward / backward / backward on a float32
# do (200000: every N up to it, the wgmma kernels and the tensor-core
# forwards streaming their keys)
OLD_LARGEST = {
    2: (14528, 9685, 29056, 14528, 11616),
    8: (3632, 3228, 7264, 5808, 3408),
    16: (1816, 1709, 3632, 3216, 1760),
    32: (200000, 22208, 200000, 200000, 200000),
    48: (200000, 19648, 200000, 200000, 200000),
    64: (200000, 17088, 200000, 200000, 200000),
}


@pytest.fixture(autouse=True)
def _two_threads():
    """Two intra-op threads: the suite runs several workers on the same
    cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(min(threads, 2))
    yield
    torch.set_num_threads(threads)


def _ulp(ref):
    mag = np.maximum(np.abs(ref), np.float32(2.0**-126))
    return np.exp2(np.floor(np.log2(mag)) - 7)


def _assert_bf16_close(got, want, name):
    got = got.detach().float().numpy().reshape(-1)
    want = np.asarray(jnp.asarray(want).astype(jnp.float32)).reshape(-1)
    np.testing.assert_allclose(got, want, atol=1e-2, rtol=1e-2, err_msg=name)
    beyond = np.abs(got - want) > _ulp(want)
    assert beyond.mean() <= 1e-3, (name, beyond.mean())


_JAX_FWD = jax.jit(jpallas._fused_attention_fwd_impl)
_JAX_BWD = jax.jit(jpallas._fused_attention_bwd_impl)


def _port_vs_jax(hd, shape, dtype, seed):
    """(port, JAX) pairs of o, lse, dq, dk, dv: the JAX kernels' forward
    and backward (the backward on the forward's residuals and a cotangent
    in the inputs' dtype), and the port's plain forward on the same q, k, v
    and plain backward on the same residuals."""
    b, n, h = shape
    rng = np.random.default_rng(seed)
    jq, jk, jv, jg = (jnp.asarray(rng.normal(size=(b, n, h, hd)).astype(np.float32),
                                  jnp.bfloat16 if dtype == torch.bfloat16 else jnp.float32)
                      for _ in range(4))
    jo, res = _JAX_FWD(jq, jk, jv)
    jgrads = _JAX_BWD(res, jg)

    def port(x):
        return torch.from_numpy(np.array(x.astype(jnp.float32))).to(dtype).reshape(b, n, -1)

    to, tlse = tfused.attention_forward(*(port(x) for x in (jq, jk, jv)), h)
    qr, kr, vr, o = (port(x) for x in res[:4])
    tgrads = tfused.attention_backward(qr, kr, vr, o, torch.from_numpy(np.array(res[4])),
                                       port(jg), h)
    assert to.dtype == dtype and all(x.dtype == dtype for x in tgrads)
    return list(zip((to, tlse, *tgrads),
                    (jo.reshape(b, n, -1), res[4], *(x.reshape(b, n, -1) for x in jgrads))))


@pytest.mark.parametrize("hd, shape", CASES)
def test_float32_plain_versions_match_jax_at_head_dim(hd, shape):
    """o, lse and the backward's dq, dk, dv on JAX's residuals, within 1e-5."""
    for name, (got, want) in zip(("o", "lse", "dq", "dk", "dv"),
                                 _port_vs_jax(hd, shape, torch.float32, hd)):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=TOL, rtol=TOL,
                                   err_msg=name)


@pytest.mark.parametrize("hd, shape", CASES)
def test_bf16_plain_versions_match_jax_at_head_dim(hd, shape):
    """bf16 o, dq, dk, dv within 1 bf16 ulp of JAX's on all but 0.1 % of the
    elements and atol/rtol 1e-2; lse within 1e-5."""
    pairs = _port_vs_jax(hd, shape, torch.bfloat16, 100 + hd)
    for name, (got, want) in zip(("o", "lse", "dq", "dk", "dv"), pairs):
        if name == "lse":
            np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=TOL, rtol=TOL)
        else:
            _assert_bf16_close(got, want, name)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["float32", "bf16"])
def test_check_shape_takes_every_head_dim(dtype):
    """Every hd in 1..128 and 192 at every N of ALL_SEQ is taken forward,
    backward and (bf16) on hybrid's float32 o and do, within the shared
    memory a CTA may take; each call's kernel is named, the tensor-core
    kernels from hd 25 in float32 (3xTF32) and 17 in bf16 (wgmma), the
    forward's two-pass form past N 72 (hd <= 16, bf16) or 320, and in bf16
    at every N from hd 65 and at hd off multiples of 8. A head dim below its
    tier copies float32 rows 4 bytes at a time."""
    for hd in ALL_HEAD_DIMS:
        for n in ALL_SEQ:
            for side_dtype, backward, f32_do in SIDES:
                if side_dtype != dtype:
                    continue
                tfused.check_shape(n, hd, backward, dtype, f32_do)
                need = (tfused.bf16_smem_bytes(n, hd, backward, f32_do) if dtype == torch.bfloat16
                        else tfused.smem_bytes(n, hd, backward))
                assert need <= tfused.SMEM_LIMIT_BYTES, (hd, n, backward, f32_do, need)
            if dtype == torch.bfloat16:
                kind = "hmma" if hd <= 16 else "mma"
                one_pass = n <= (72 if hd <= 16 else 320 if hd <= 64 and hd % 8 == 0 else 0)
                assert tfused.bf16_kernel(n, hd) == f"attn_fwd_{kind}{'' if one_pass else '2'}_bf16"
                assert tfused.bf16_kernel(n, hd, backward=True) == f"attn_bwd_{kind}_bf16"
        tier = tfused.head_tier(hd)
        assert tier >= hd and (tier in tfused.ROW_TIERS) == (hd <= 24)
        assert tfused.bf16_tier(hd) >= hd
        if tier != hd:
            assert tfused.row_copy_width([torch.zeros(2, 9, 4 * hd)], hd) == 4


@pytest.mark.parametrize("hd", sorted(OLD_LARGEST))
def test_check_shape_keeps_every_shape_it_took(hd):
    """Each (N, hd) taken before every head dim was: the largest N at each
    of the six head dims the kernels were first built for (and N 1 to 400),
    forward and backward in both dtypes; the next N still refused where the
    limit was shared memory."""
    for (dtype, backward, f32_do), largest in zip(SIDES, OLD_LARGEST[hd]):
        for n in list(range(1, 401, 7)) + [largest]:
            tfused.check_shape(n, hd, backward, dtype, f32_do)
        if largest < 200000:
            with pytest.raises(ValueError, match="shared memory"):
                tfused.check_shape(largest + 1, hd, backward, dtype, f32_do)


def test_check_shape_names_what_it_refuses():
    """Past 192, and below 1, the refusal names the widest tier; a long N
    names the bytes of shared memory it would take. No rule says "not
    built"."""
    for hd in (0, 193, 256):
        for dtype in (torch.float32, torch.bfloat16):
            with pytest.raises(ValueError, match="outside 1..192") as err:
                tfused.check_shape(65, hd, False, dtype)
            assert "not built" not in str(err.value)
    with pytest.raises(ValueError, match=r"needs \d+ bytes of shared memory"):
        tfused.check_shape(30000, 128, True)
    assert tfused.mma_plan(1025, 192) == (17, 4) and tfused.mma_plan(1025, 128) == (9, 8)
    assert [tfused.mma_slices(hd) for hd in (17, 64, 65, 80, 96, 112, 128, 129, 192)] == [
        1, 1, 2, 2, 2, 2, 2, 3, 3]
    # hd 129-192 on hybrid's float32 do: one ring stage of q and do's parts
    assert [tfused.bf16_key_stages(hd, f32) for hd, f32 in
            ((64, True), (128, True), (192, False), (192, True))] == [2, 2, 2, 1]


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


@pytest.mark.parametrize("hd", [1, 12, 16, 17, 24, 25, 64, 65, 96, 192])
def test_wrappers_pass_each_design_its_workspaces(monkeypatch, hd):
    """The kernel wrappers hand each design what it takes: the bf16 row
    plan up to hd 16 and none from 17 (wgmma plans its own grid), whose
    backward gets the delta workspace and, on a float32 do, the three
    parts' workspace; the float32 backward's dq partials on the tensor
    cores (hd 33 up at N 257) where the plan has more than one chunk."""
    n, h = 257, 2
    lib = _Recorder()
    for name in ("_lib", "_lib_bf16"):
        monkeypatch.setattr(tfused, name, lambda: lib)
    monkeypatch.setattr(tfused, "_check", lambda t, heads, backward: (2, n, hd))
    monkeypatch.setattr(tfused, "_stream", lambda dev: None)
    monkeypatch.setattr(tfused.torch.cuda, "device", lambda dev: contextlib.nullcontext())
    lse = torch.zeros(2, h, n)
    x = [torch.zeros(2, n, h * hd, dtype=torch.bfloat16) for _ in range(5)]
    tfused._kernel_forward(x[0], x[1], x[2], h)
    plan = (0, 0) if hd > 16 else tfused.bf16_hmma_plan(n)
    assert lib.calls["attention_bf16_forward"][-3:] == (*plan, None)
    for f32 in (False, True):
        o, do = (x[3].float(), x[4].float()) if f32 else (x[3], x[4])
        tfused._kernel_backward(x[0], x[1], x[2], o, lse, do, h)
        args = lib.calls["attention_bf16_backward"]
        assert args[12] == int(f32) and args[-3:] == (*plan, None)
        assert (args[20] is not None) == (hd > 16)  # delta
        assert (args[21] is not None) == (hd > 16 and f32)  # do's parts
    x = [t.float() for t in x]
    tfused._kernel_backward(*x[:4], lse, x[4], h)
    args = lib.calls["attention_backward"]
    # dq partials: 3 chunks at N 257 on the tensor cores (hd 25-32 runs the
    # row kernels up to N 880)
    assert (args[19] is not None) == (hd > 32)
    assert args[-2] == tfused.row_copy_width(x, hd)


@pytest.mark.parametrize("hd", [25, 28, 31, 32])
def test_tier_32_runs_the_row_kernels_up_to_n_880(hd):
    """hd 25-32 runs the FP32-core row kernels at tier 32, a row a lane
    group, where their staged [N, 32] operands fit (N <= 880: the backward's
    264 N bytes), and the 3xTF32 tensor-core kernels past it; the source's
    constants, dispatch and row plan say the same. Every N 1-1025 stays
    taken in both directions."""
    src = (Path(tfused.__file__).parent / "csrc" / "attention.cu").read_text()
    consts = {k: int(v) for k, v in re.findall(
        r"constexpr int (kRowWideTier|kRowWideMaxN) = (\d+);", src)}
    assert consts == {"kRowWideTier": tfused.ROW_WIDE_TIER,
                      "kRowWideMaxN": tfused.ROW_WIDE_MAX_N} == {
        "kRowWideTier": 32, "kRowWideMaxN": 880}
    assert "if (hd > 24 && hd <= kRowWideTier && N <= kRowWideMaxN)" in src
    assert "return HD > 24 ? 1 : kRowRows;" in src
    for n in (1, 9, 65, 197, 257, 880):
        assert tfused.row_kernels(n, hd)
        for backward in (False, True):
            assert tfused.smem_bytes(n, hd, backward) == 4 * (64 * n + (2 * n if backward else 0))
            assert tfused.smem_bytes(n, hd, backward) <= tfused.SMEM_LIMIT_BYTES
    assert tfused.smem_bytes(881, hd, True) != 4 * (64 * 881 + 2 * 881)
    assert 4 * (64 * 881 + 2 * 881) > tfused.SMEM_LIMIT_BYTES
    for n in (881, 1025):
        assert not tfused.row_kernels(n, hd)
    for n in range(1, 1026, 8):
        for backward in (False, True):
            tfused.check_shape(n, hd, backward)
    # one row a group: 64 rows a CTA of 128 threads, 2 lanes a row
    assert tfused.row_rows(hd) == 1 and tfused.row_rows(24) == tfused.ROW_ROWS == 2
    assert tfused.row_plan(65, hd, False) == (2, 96)
    assert tfused.row_plan(197, hd, True) == (4, 4, 128)
    assert tfused.row_plan(197, 24, True) == (2, 2, 128)
    assert tfused.row_copy_width([torch.zeros(2, 9, 4 * hd)], hd) == (16 if hd == 32 else 4)


def test_tiers_match_the_kernel_sources():
    """The wrapper's tiers are the sources' (the loaded libraries are also
    checked against them)."""
    csrc = Path(tfused.__file__).parent / "csrc"
    f32 = (csrc / "attention.cu").read_text()
    bf16 = (csrc / "attention_bf16.cu").read_text()

    def tiers(src, name):
        body = re.search(rf"#define {name}\(X\)((?:[^\n]*\\\n)*[^\n]*)", src).group(1)
        return tuple(int(x) for x in re.findall(r"X\((\d+)\)", body))

    assert tiers(f32, "ATTN_ROW_TIERS") == tfused.ROW_TIERS
    assert tiers(f32, "ATTN_MMA_TIERS") == tfused.MMA_TIERS
    assert tiers(bf16, "ATTN_BF16_TIERS") == tfused.BF16_TIERS
    assert max(tfused.MMA_TIERS) == max(tfused.BF16_TIERS) == tfused.MAX_HEAD_DIM


_FLAGSHIP = "configs/vit_som/vit_som_mnist.yaml"
_FLAGSHIP_OVER = {"vit.heads": 4, "vit.depth": 1, "vit.dec_depth": 1, "som.map_size": [4, 5],
                  "train.use_pallas_attention": True}


@functools.lru_cache(maxsize=None)
def _flagship_params():
    """The Flax flagship's weights at vit.heads 4, depth 1, dec_depth 1
    (the attention implementation does not enter them)."""
    jmodel = jbuild_model(jload(_FLAGSHIP, _FLAGSHIP_OVER))
    return jax.jit(jmodel.init)(jax.random.key(0), jnp.zeros((2, 28, 28, 1)))["params"]


def _flagship_pair(impl):
    """The Flax flagship at vit.heads 4 and the port's model with its
    weights, both with attention ``impl``."""
    over = {**_FLAGSHIP_OVER, "train.attn_impl": impl}
    params = _flagship_params()
    tmodel = tbuild_model(load_config(_FLAGSHIP, over), device="cpu")
    tmodel.load_state_dict(convert.flax_to_state_dict(params), strict=True)
    return jbuild_model(jload(_FLAGSHIP, over)), params, tmodel


@pytest.mark.parametrize("impl", ["pallas", "hybrid"])
def test_flagship_at_four_heads_matches_jax(impl):
    """Head dims 4 (encoder) and 1 (decoder): the reconstruction, the SOM
    distances and BMUs within ``tests/test_torch_model.py``'s 1e-5, and the
    gradients of the training objective's two terms (the reconstruction's
    mean squared error and the mean distance) with respect to every
    parameter within the train step's gradient bound (atol 1e-6, rtol 1e-4:
    ``tests/test_torch_train.py``), port against JAX."""
    jmodel, params, tmodel = _flagship_pair(impl)
    assert {m.attn_impl for m in tmodel.modules() if hasattr(m, "attn_impl")} == {impl}
    x = np.random.default_rng(4).uniform(size=(2, 28, 28, 1)).astype(np.float32)

    def jloss(p):
        _, rec, _, dist, _ = jmodel.apply({"params": p}, jnp.asarray(x))
        return jnp.mean((rec - x) ** 2) + jnp.mean(dist), (rec, dist)

    (jl, (jrec, jdist)), jgrads = jax.jit(jax.value_and_grad(jloss, has_aux=True))(params)
    _, trec, _, tdist, tbmu = tmodel(torch.from_numpy(x))
    np.testing.assert_allclose(trec.detach().numpy(), np.asarray(jrec), atol=TOL)
    np.testing.assert_allclose(tdist.detach().numpy(), np.asarray(jdist), atol=TOL)
    np.testing.assert_array_equal(tbmu.numpy(), np.argmin(np.asarray(jdist), axis=1))
    tl = torch.mean((trec - torch.from_numpy(x)) ** 2) + torch.mean(tdist)
    tl.backward()
    np.testing.assert_allclose(float(tl.detach()), float(jl), rtol=TOL)
    want = convert.flax_to_state_dict(jgrads)
    named = dict(tmodel.named_parameters())
    assert set(want) >= set(named)
    for name, p in named.items():
        np.testing.assert_allclose(p.grad.numpy(), want[name].numpy(), atol=1e-6, rtol=1e-4,
                                   err_msg=name)


@pytest.mark.parametrize("distance", ["cosine", "euclidean"])
def test_fused_som_at_depth_33_matches_jax(distance):
    """The port's fused SOM (its plain version on the CPU) at the JAX tests'
    (B 12, D 33, a 6 x 7 map), x a view with row stride 35: loss, BMUs,
    distances and the gradients against ``make_fused_som`` within 1e-5 (the
    JAX test's 1e-6 / 1e-4 for the gradients); the kernel takes D 33 and
    ldx 35, by 4-byte copies."""
    map_size, b, d = (6, 7), 12, 33
    p = map_size[0] * map_size[1]
    rng = np.random.default_rng(33)
    xbuf = rng.normal(size=(b, d + 2)).astype(np.float32)
    protos = rng.normal(size=(p, d)).astype(np.float32)
    temp = 1.9
    fused = som_pallas.make_fused_som(map_size, "square", distance)

    def loss(x, w):
        out = fused(x, w, jnp.asarray(temp, jnp.float32))
        return out[0], out[1:]

    (jl, (jbmu, jdist)), (jgx, jgp) = jax.jit(jax.value_and_grad(
        loss, argnums=(0, 1), has_aux=True))(jnp.asarray(xbuf[:, :d]), jnp.asarray(protos))
    tbuf = torch.from_numpy(xbuf).requires_grad_(True)
    tx = tbuf[:, :d]
    tp = torch.from_numpy(protos).requires_grad_(True)
    assert tx.stride(0) == d + 2
    tl, tbmu, tdist = som_fused.FusedSOM.apply(tx, tp, temp, map_size[1], "square", distance)
    np.testing.assert_allclose(float(tl.detach()), float(jl), atol=TOL, rtol=TOL)
    np.testing.assert_array_equal(tbmu.numpy(), np.asarray(jbmu))
    np.testing.assert_allclose(tdist.detach().numpy(), np.asarray(jdist), atol=TOL, rtol=TOL)
    tl.backward()
    np.testing.assert_allclose(tbuf.grad[:, :d].numpy(), np.asarray(jgx), atol=1e-6, rtol=1e-4)
    np.testing.assert_allclose(tp.grad.numpy(), np.asarray(jgp), atol=1e-6, rtol=1e-4)
    som_fused.check_shape(b, p, d, d + 2)
    assert not som_fused.wide_copies(d, d + 2, 0, 0)
    assert som_fused.wide_copies(32, 36, 16, 64)
    with pytest.raises(ValueError, match="row stride"):
        som_fused.check_shape(b, p, d, d - 1)
