"""Fully fused pre-norm transformer block: hand-written CUDA forward and
backward kernels.

Counterpart of ``vitsom_tpu/ops/block_pallas.py``. The kernels in
``csrc/block.cu`` and ``csrc/block_streamed.cu`` replace its TPU kernels
``_fwd_kernel`` and ``_bwd_kernel``; the sources' headers give their designs
and their bounds on the H100. One op
runs a whole block on x [B, N, D] f32:

    LN1 -> QKV -> per-head attention -> proj -> residual
        -> LN2 -> fc1 -> GELU -> fc2 -> residual

- forward: x and the 12 weights -> y [B, N, D];
- backward: x, dy and the weights -> dx and the 12 weight gradients,
  recomputing the forward (the saved residuals are x and the weights alone,
  as in the JAX ``block_fwd``).

Weights follow the JAX package's names, order and ``[in, out]`` layouts
(``WEIGHT_NAMES``, ``weight_shapes``); ``vitsom_tpu_torch.convert`` maps a
Flax ``Block`` or the port's ``models/vit.Block`` onto them.

GELU is exact-erf in both the plain versions (``torch.erf``) and the kernels
(CUDA ``erff``): it is the function the model computes
(``vitsom_tpu/models/vit.py:73``). The TPU kernel carries the Abramowitz-Stegun
7.1.26 polynomial only because Mosaic has no erf lowering; it differs from erf
by at most 1.5e-7, far inside the 2e-5 tolerance the block is held to.

On a CUDA tensor each wrapper launches its kernel, or raises; on a CPU tensor
it runs the plain PyTorch version beside it. There is no fallback from one to
the other. Two designs take every shape the JAX kernel takes
(``block_plan`` names the one a call runs):

- ``"resident"`` (``csrc/block.cu``): a CTA a sample, every weight and the
  sample's intermediates in shared memory, at the (D, head_dim, M) in
  ``BUILT_SHAPES`` (the flagship's encoder and decoder, the JAX tests'
  blocks) where that working set fits (the backward, a warp a 16-row tile,
  up to N 256);
- ``"streamed"`` (``csrc/block_streamed.cu``): every other shape, emb 192
  and its 1.8 MB of weights included. One persistent cooperative launch a
  direction, phases over a float32 workspace in device memory
  (``workspace_bytes``), weights streamed through shared memory as k-tiles.

``check_shape`` refuses malformed shapes and those past ``MAX_DIM``,
``MAX_HEAD_DIM``, ``MAX_MLP_HIDDEN`` and ``MAX_SEQ_LEN``, the widest the
card has held the streamed design at; a CUDA call also refuses a workspace
larger than the card's free memory.
"""

from __future__ import annotations

import ctypes
import math
from typing import Dict, Mapping, Tuple

import torch

from vitsom_tpu_torch.ops import _build
from vitsom_tpu_torch.ops._build import SMEM_LIMIT_BYTES

LN_EPS = 1e-6

WEIGHT_NAMES = (
    "ln1_scale", "ln1_bias", "qkv_kernel", "qkv_bias", "proj_kernel",
    "proj_bias", "ln2_scale", "ln2_bias", "fc1_kernel", "fc1_bias",
    "fc2_kernel", "fc2_bias",
)

# Kernel launches since the last reset, one per wrapper call, by design (the
# resident backward's weight-gradient reduction, and the streamed design's
# 8-byte memset of its barrier, are part of their call). Plain ints:
# chip_smoke.py zeroes them before a main-path run and reads them after.
LAUNCHES_FWD = 0
LAUNCHES_BWD = 0
LAUNCHES_FWD_STREAMED = 0
LAUNCHES_BWD_STREAMED = 0

# (dim, head_dim, mlp_hidden) the kernels are built for (csrc/block.cu,
# BLOCK_SHAPES): the flagship's encoder and decoder blocks and the JAX tests'
# blocks
BUILT_SHAPES = ((16, 8, 64), (16, 8, 32), (24, 8, 96), (4, 2, 16))

# csrc/block_streamed.cu's constants (block_streamed_constants): threads of
# a CTA, a product's output tile (rows, columns) and staged depth, the depth
# summed from zero before it joins a tile's total, an attention warp's rows
# and output columns, the rows a lane sums from zero in a column sum, a
# weight-gradient slice's rows at least and the slices at most, and the
# floats each workspace buffer is aligned to
STREAMED_CONSTANTS = (128, 64, 64, 32, 256, 16, 64, 32, 2048, 16, 32)
STREAMED_THREADS = STREAMED_CONSTANTS[0]
STREAMED_SLICE_ROWS, STREAMED_MAX_SLICES, STREAMED_ALIGN = STREAMED_CONSTANTS[8:]
# the widest block the kernels take: emb 768 (ViT-B) with heads of up to 192
# columns and a 4x MLP, and 1025 tokens (chip_smoke.py phase 10 holds the
# streamed design at each)
MAX_DIM, MAX_HEAD_DIM, MAX_MLP_HIDDEN, MAX_SEQ_LEN = 768, 192, 3072, 1025

_LIB = None
_LIB_STREAMED = None


def weight_shapes(dim: int, mlp_hidden: int) -> Dict[str, Tuple[int, ...]]:
    return {
        "ln1_scale": (dim,), "ln1_bias": (dim,),
        "qkv_kernel": (dim, 3 * dim), "qkv_bias": (3 * dim,),
        "proj_kernel": (dim, dim), "proj_bias": (dim,),
        "ln2_scale": (dim,), "ln2_bias": (dim,),
        "fc1_kernel": (dim, mlp_hidden), "fc1_bias": (mlp_hidden,),
        "fc2_kernel": (mlp_hidden, dim), "fc2_bias": (dim,),
    }


def _lib():
    global _LIB
    if _LIB is None:
        lib = _build.load("block")
        ptr = ctypes.c_void_p
        dims = [ctypes.c_int] * 5 + [ctypes.c_float, ptr]  # B, N, D, hd, M, scale, stream
        lib.block_forward.argtypes = [ptr] * 4 + dims
        lib.block_forward.restype = ctypes.c_int
        lib.block_backward.argtypes = [ptr] * 7 + dims
        lib.block_backward.restype = ctypes.c_int
        _LIB = lib
    return _LIB


def _lib_streamed():
    global _LIB_STREAMED
    if _LIB_STREAMED is None:
        lib = _build.load("block_streamed")
        ptr, size = ctypes.c_void_p, ctypes.c_longlong
        # ws floats, B, N, D, heads, M, scale, stream
        dims = [size] + [ctypes.c_int] * 5 + [ctypes.c_float, ptr]
        lib.block_streamed_forward.argtypes = [ptr] * 5 + dims
        lib.block_streamed_forward.restype = ctypes.c_int
        lib.block_streamed_backward.argtypes = [ptr] * 7 + dims
        lib.block_streamed_backward.restype = ctypes.c_int
        lib.block_streamed_grid.argtypes = [ctypes.c_int, ptr]
        lib.block_streamed_grid.restype = ctypes.c_int
        got = (ctypes.c_int * len(STREAMED_CONSTANTS))()
        lib.block_streamed_constants(got)
        if tuple(got) != STREAMED_CONSTANTS:
            raise RuntimeError(f"block_streamed.cu constants {tuple(got)} differ from the "
                               f"wrapper's {STREAMED_CONSTANTS}")
        _LIB_STREAMED = lib
    return _LIB_STREAMED


def streamed_grid(backward: bool) -> Tuple[int, int, int]:
    """(CTAs, CTAs an SM, SMs) of the streamed kernels' persistent launch on
    the current card (CUDA only)."""
    out = (ctypes.c_int * 3)()
    rc = _lib_streamed().block_streamed_grid(int(backward), out)
    if rc != 0:
        raise RuntimeError(f"block_streamed_grid failed with code {rc}")
    return tuple(out)


# ---------------------------------------------------------------------------
# plain versions
# ---------------------------------------------------------------------------


def _ln(x, scale, bias):
    """(LayerNorm(x), xhat, rstd) with the mean and biased variance."""
    mu = torch.mean(x, dim=-1, keepdim=True)
    xc = x - mu
    rstd = torch.rsqrt(torch.mean(xc * xc, dim=-1, keepdim=True) + LN_EPS)
    xhat = xc * rstd
    return xhat * scale + bias, xhat, rstd


def _ln_bwd(dout, xhat, rstd, scale):
    """(dx, dscale, dbias) over the rows of 2-D operands."""
    dxhat = dout * scale
    m1 = torch.mean(dxhat, dim=-1, keepdim=True)
    m2 = torch.mean(dxhat * xhat, dim=-1, keepdim=True)
    return rstd * (dxhat - m1 - xhat * m2), torch.sum(dout * xhat, dim=0), torch.sum(dout, dim=0)


def _gelu(x):
    return 0.5 * x * (1.0 + torch.erf(x / math.sqrt(2.0)))


def _gelu_grad(x):
    cdf = 0.5 * (1.0 + torch.erf(x / math.sqrt(2.0)))
    return cdf + x * torch.exp(-0.5 * x * x) / math.sqrt(2.0 * math.pi)


def _heads(t, b, n, heads):
    """[B*N, D] column slice -> [B, H, N, hd]."""
    return t.reshape(b, n, heads, -1).transpose(1, 2)


def _forward(x, w: Mapping[str, torch.Tensor], heads: int):
    """The block forward on x [B, N, D]; returns (y [B*N, D], the
    intermediates the backward needs)."""
    b, n, d = x.shape
    scale = (d // heads) ** -0.5
    x2 = x.reshape(b * n, d)
    h1, xhat1, rstd1 = _ln(x2, w["ln1_scale"], w["ln1_bias"])
    qkv = h1 @ w["qkv_kernel"] + w["qkv_bias"]
    q, k, v = (_heads(qkv[:, i * d:(i + 1) * d], b, n, heads) for i in range(3))
    p = torch.softmax(q @ k.transpose(-1, -2) * scale, dim=-1)
    o = (p @ v).transpose(1, 2).reshape(b * n, d)
    r = x2 + o @ w["proj_kernel"] + w["proj_bias"]
    h2, xhat2, rstd2 = _ln(r, w["ln2_scale"], w["ln2_bias"])
    m1 = h2 @ w["fc1_kernel"] + w["fc1_bias"]
    gm = _gelu(m1)
    y = r + gm @ w["fc2_kernel"] + w["fc2_bias"]
    cache = dict(h1=h1, xhat1=xhat1, rstd1=rstd1, q=q, k=k, v=v, p=p, o=o,
                 h2=h2, xhat2=xhat2, rstd2=rstd2, m1=m1, gm=gm)
    return y, cache


def fused_block_reference(x: torch.Tensor, w: Mapping[str, torch.Tensor], heads: int) -> torch.Tensor:
    """Plain PyTorch version of the forward kernel: y [B, N, D], as
    ``_block_fwd_core`` computes it (softmax over rows, exact-erf GELU)."""
    y, _ = _forward(x, w, heads)
    return y.reshape(x.shape)


def fused_block_bwd_reference(
    x: torch.Tensor, dy: torch.Tensor, w: Mapping[str, torch.Tensor], heads: int
) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Plain PyTorch version of the backward kernel: (dx, {name: grad}), the
    closed form of ``_bwd_kernel`` (``block_pallas.py:249-283``) in torch ops,
    without autograd."""
    b, n, d = x.shape
    scale = (d // heads) ** -0.5
    _, c = _forward(x, w, heads)
    dy2 = dy.reshape(b * n, d)

    # MLP
    g = {"fc2_kernel": c["gm"].T @ dy2, "fc2_bias": dy2.sum(0)}
    dm1 = (dy2 @ w["fc2_kernel"].T) * _gelu_grad(c["m1"])
    g["fc1_kernel"] = c["h2"].T @ dm1
    g["fc1_bias"] = dm1.sum(0)
    dln2, g["ln2_scale"], g["ln2_bias"] = _ln_bwd(
        dm1 @ w["fc1_kernel"].T, c["xhat2"], c["rstd2"], w["ln2_scale"])
    dr = dy2 + dln2

    # projection and attention
    g["proj_kernel"] = c["o"].T @ dr
    g["proj_bias"] = dr.sum(0)
    do = _heads(dr @ w["proj_kernel"].T, b, n, heads)
    p = c["p"]
    dv = p.transpose(-1, -2) @ do
    dp = do @ c["v"].transpose(-1, -2)
    ds = (dp - torch.sum(dp * p, dim=-1, keepdim=True)) * p * scale
    dq, dk = ds @ c["k"], ds.transpose(-1, -2) @ c["q"]
    dqkv = torch.cat([t.transpose(1, 2).reshape(b * n, d) for t in (dq, dk, dv)], dim=1)
    g["qkv_kernel"] = c["h1"].T @ dqkv
    g["qkv_bias"] = dqkv.sum(0)
    dln1, g["ln1_scale"], g["ln1_bias"] = _ln_bwd(
        dqkv @ w["qkv_kernel"].T, c["xhat1"], c["rstd1"], w["ln1_scale"])
    dx = (dr + dln1).reshape(b, n, d)
    return dx, {name: g[name] for name in WEIGHT_NAMES}


# ---------------------------------------------------------------------------
# kernels
# ---------------------------------------------------------------------------


# csrc/block.cu's constants: rows of a warp's tile, floats of a fragment
# block (32 lanes x 4), the forward's and the backward's thread limits
ROW_TILE = 16
FRAG_FLOATS = 128
FWD_THREADS = 832
MAX_THREADS = 512
WGRAD_SLICES = 3  # row-step ranges a weight-gradient tile is split into


def _r8(c: int) -> int:
    return (c + 7) // 8 * 8


def _wpad(c: int) -> int:
    """csrc/block.cu's wpad: a shared-memory row stride, c rounded up to 8
    floats plus 4."""
    return _r8(c) + 4


def staged_floats(dim: int, mlp_hidden: int) -> int:
    """Floats of the weights as the kernels stage them (csrc/block.cu
    staged_floats): each [r8(rows)][wpad(cols)], a vector one row."""
    total = 0
    for name in WEIGHT_NAMES:
        shape = weight_shapes(dim, mlp_hidden)[name]
        rows, cols = (shape if len(shape) == 2 else (1, shape[0]))
        total += (1 if rows == 1 else _r8(rows)) * _wpad(cols)
    return total


def row_tiles(n: int) -> int:
    return (n + ROW_TILE - 1) // ROW_TILE


def fwd_threads(n: int) -> int:
    """Threads of a forward CTA (csrc/block.cu fwd_threads): two warps a
    row tile, at most FWD_THREADS."""
    return 32 * min(2 * row_tiles(n), FWD_THREADS // 32)


def bwd_threads(n: int) -> int:
    """Threads of a backward CTA: a warp a row tile (check_shape refuses N
    past MAX_THREADS / 32 tiles)."""
    return 32 * row_tiles(n)


def _wgrad_tiles(a: int, c: int) -> int:
    """16 x 8 tiles of an [a][c] weight gradient."""
    return (a + 15) // 16 * ((c + 7) // 8)


def wgrad_scratch(dim: int, mlp_hidden: int) -> int:
    """Floats of the backward's weight-gradient scratch (csrc/block.cu
    wgrad_scratch): the most tiles of one phase (fc2 + proj, fc1, qkv),
    WGRAD_SLICES partial tiles of FRAG_FLOATS each."""
    most = max(_wgrad_tiles(mlp_hidden, dim) + _wgrad_tiles(dim, dim),
               _wgrad_tiles(dim, mlp_hidden), _wgrad_tiles(dim, 3 * dim))
    return most * WGRAD_SLICES * FRAG_FLOATS


def smem_bytes(n: int, dim: int, heads: int, mlp_hidden: int, backward: bool) -> int:
    """Dynamic shared memory of one CTA (csrc/block.cu fwd_floats and
    BwdLayout), for T = ceil(N / 16) row tiles of NP = 16 T rows and U
    floats of one fragment buffer (H heads x T tiles x head_dim / 8 k-steps
    x FRAG_FLOATS). The forward: the staged weights, q, k, v as attention
    fragments (k and v split into two TF32 parts: 5 U) and the attention
    output [NP][wpad(D)]. The backward: the weights, lse and delta [H][NP],
    d(residual) [NP][wpad(D)], do as fragments (2 U), then the largest of
    three phases' buffers on one region: the forward recompute's attention
    output and fragments; the MLP backward's attention output, xhat2, d(h2),
    dy and gelu(m1) / d(m1) [NP][wpad(M)]; the attention backward's q, k, v
    fragments (5 U), xhat1, d(h1) and d(qkv) [NP][wpad(3D)]; then the weight
    gradients' scratch."""
    tiles, ks = row_tiles(n), _r8(dim // heads) // 8
    rows, u = tiles * ROW_TILE, heads * tiles * ks * FRAG_FLOATS
    ld, lm, lq = _wpad(dim), _wpad(mlp_hidden), _wpad(3 * dim)
    if not backward:
        return 4 * (staged_floats(dim, mlp_hidden) + 5 * u + rows * ld)
    fwd_mlp = rows * ld + max(5 * u, 3 * rows * ld + rows * lm)
    attn = 5 * u + 2 * rows * ld + rows * lq
    return 4 * (staged_floats(dim, mlp_hidden) + 2 * heads * rows + rows * ld + 2 * u
                + max(fwd_mlp, attn) + wgrad_scratch(dim, mlp_hidden))


def resident_fits(b: int, n: int, dim: int, heads: int, mlp_hidden: int, backward: bool) -> bool:
    """Whether the resident kernels (csrc/block.cu) take this shape: its (D,
    head_dim, M) is built, the backward has at most MAX_THREADS / 32 row
    tiles (a warp each), and one CTA's working set fits in shared memory."""
    return ((dim, dim // heads, mlp_hidden) in BUILT_SHAPES
            and not (backward and row_tiles(n) > MAX_THREADS // 32)
            and smem_bytes(n, dim, heads, mlp_hidden, backward) <= SMEM_LIMIT_BYTES)


def block_plan(b: int, n: int, dim: int, heads: int, mlp_hidden: int, backward: bool) -> str:
    """The design a call runs: ``"resident"`` (csrc/block.cu) where
    ``resident_fits``, else ``"streamed"`` (csrc/block_streamed.cu). Needs
    no CUDA."""
    check_shape(b, n, dim, heads, mlp_hidden, backward)
    return "resident" if resident_fits(b, n, dim, heads, mlp_hidden, backward) else "streamed"


def _aligned(n: int) -> int:
    return -(-n // STREAMED_ALIGN) * STREAMED_ALIGN


def wgrad_slices(rows: int) -> int:
    """Row slices of a streamed weight gradient's sum over ``rows`` = B N
    rows (csrc/block_streamed.cu wgrad_slices): one each STREAMED_SLICE_ROWS
    rows begun, 1 to STREAMED_MAX_SLICES."""
    return max(1, min(STREAMED_MAX_SLICES, -(-rows // STREAMED_SLICE_ROWS)))


def workspace_bytes(b: int, n: int, dim: int, heads: int, mlp_hidden: int, backward: bool) -> int:
    """Bytes of the streamed kernels' float32 workspace (csrc/
    block_streamed.cu make_layout), R = B N rows, each buffer at a multiple
    of STREAMED_ALIGN floats after the barrier's STREAMED_ALIGN: qkv [R, 3D],
    o, r [R, D], m1 [R, M], LN1's and LN2's row statistics [R, 2], the log2-
    sum-exp2 [B, H, N]; the backward's besides: dm1 [R, M], dh2, dr, do [R,
    D], dqkv [R, 3D], dh1 [R, D] and the weight gradients' slices
    [wgrad_slices(R), W], W the 12 weights' floats."""
    r, d, m = b * n, dim, mlp_hidden
    sizes = [3 * r * d, r * d, r * d, r * m, 2 * r, 2 * r, r * heads]
    if backward:
        w = sum(math.prod(s) for s in weight_shapes(d, m).values())
        sizes += [r * m, r * d, r * d, r * d, 3 * r * d, r * d, wgrad_slices(r) * w]
    return 4 * (STREAMED_ALIGN + sum(_aligned(x) for x in sizes))


def check_shape(b: int, n: int, dim: int, heads: int, mlp_hidden: int, backward: bool) -> None:
    """Raises ValueError unless the kernels take this block shape: a
    well-formed one within MAX_DIM, MAX_HEAD_DIM, MAX_MLP_HIDDEN and
    MAX_SEQ_LEN. Needs no CUDA."""
    if min(b, n, dim, heads, mlp_hidden) < 1 or dim % heads:
        raise ValueError(f"bad block shape B={b} N={n} D={dim} heads={heads} M={mlp_hidden}")
    limits = (("D", dim, MAX_DIM), ("head_dim", dim // heads, MAX_HEAD_DIM),
              ("M", mlp_hidden, MAX_MLP_HIDDEN), ("N", n, MAX_SEQ_LEN))
    for name, value, most in limits:
        if value > most:
            raise ValueError(f"the fused block takes {name} up to {most}, got {value}")


def _check(x: torch.Tensor, w: Mapping[str, torch.Tensor], heads: int, backward: bool,
           dy: torch.Tensor = None) -> Tuple[int, int, int, int]:
    """(B, N, D, M) after checking what the kernels take; raises ValueError
    otherwise. Dtypes and shapes are checked before the device, so a CPU
    tensor reaches every check."""
    if x.ndim != 3:
        raise ValueError(f"the fused block takes x [B, N, D], got {tuple(x.shape)}")
    b, n, d = x.shape
    acts = (x,) if dy is None else (x, dy)
    tensors = acts + tuple(w[name] for name in WEIGHT_NAMES)
    if any(t.dtype != torch.float32 for t in tensors):
        raise ValueError(f"the fused block takes float32, got {sorted({str(t.dtype) for t in tensors})}")
    m = w["fc1_kernel"].shape[-1]
    for name, shape in weight_shapes(d, m).items():
        if tuple(w[name].shape) != shape:
            raise ValueError(f"{name} has shape {tuple(w[name].shape)}, not {shape}")
    for t in acts:
        if tuple(t.shape) != (b, n, d) or not t.is_contiguous():
            raise ValueError(f"x and dy must be contiguous {(b, n, d)} tensors")
    check_shape(b, n, d, heads, m, backward)
    if not x.is_cuda or any(t.device != x.device for t in tensors):
        raise ValueError("fused block kernel inputs must be on the same CUDA device")
    if any(t.data_ptr() % 16 for t in acts):
        raise ValueError("x and dy must be 16-byte aligned")
    if block_plan(b, n, d, heads, m, backward) == "streamed":
        need = workspace_bytes(b, n, d, heads, m, backward)
        free = (torch.cuda.mem_get_info(x.device)[0] + torch.cuda.memory_reserved(x.device)
                - torch.cuda.memory_allocated(x.device))
        if need > free:
            raise ValueError(f"the fused block at B={b} N={n} D={d} M={m} needs a {need}-byte "
                             f"workspace, more than the card's {free} free bytes")
    return b, n, d, m


def _weight_args(w: Mapping[str, torch.Tensor]):
    """(pointer array, stride array): each weight as a [rows, cols] view."""
    ptrs, strides = [], []
    for name in WEIGHT_NAMES:
        t = w[name]
        ptrs.append(t.data_ptr())
        strides += list(t.stride()) if t.ndim == 2 else [0, t.stride(0)]
    return (ctypes.c_void_p * len(ptrs))(*ptrs), (ctypes.c_longlong * len(strides))(*strides)


def _stream(dev):
    return torch.cuda.current_stream(dev).cuda_stream


def _workspace(b, n, d, heads, m, backward, dev):
    return torch.empty(workspace_bytes(b, n, d, heads, m, backward) // 4, device=dev,
                       dtype=torch.float32)


def _kernel_forward(x, w, heads: int):
    global LAUNCHES_FWD, LAUNCHES_FWD_STREAMED
    b, n, d, m = _check(x, w, heads, backward=False)
    streamed = block_plan(b, n, d, heads, m, False) == "streamed"
    y = torch.empty_like(x)
    ptrs, strides = _weight_args(w)
    with torch.cuda.device(x.device):
        if streamed:
            ws = _workspace(b, n, d, heads, m, False, x.device)
            rc = _lib_streamed().block_streamed_forward(
                x.data_ptr(), ptrs, strides, y.data_ptr(), ws.data_ptr(), ws.numel(),
                b, n, d, heads, m, (d // heads) ** -0.5, _stream(x.device))
        else:
            rc = _lib().block_forward(x.data_ptr(), ptrs, strides, y.data_ptr(), b, n, d,
                                      d // heads, m, (d // heads) ** -0.5, _stream(x.device))
    if rc != 0:
        raise RuntimeError(f"block forward ({'streamed' if streamed else 'resident'}) launch "
                           f"failed with code {rc}")
    if streamed:
        LAUNCHES_FWD_STREAMED += 1
    else:
        LAUNCHES_FWD += 1
    return y


def _kernel_backward(x, dy, w, heads: int):
    global LAUNCHES_BWD, LAUNCHES_BWD_STREAMED
    b, n, d, m = _check(x, w, heads, backward=True, dy=dy)
    streamed = block_plan(b, n, d, heads, m, True) == "streamed"
    shapes = weight_shapes(d, m)
    sizes = [math.prod(shapes[name]) for name in WEIGHT_NAMES]
    dx = torch.empty_like(x)
    dw = torch.empty(sum(sizes), device=x.device, dtype=torch.float32)
    ptrs, strides = _weight_args(w)
    with torch.cuda.device(x.device):
        if streamed:
            ws = _workspace(b, n, d, heads, m, True, x.device)
            rc = _lib_streamed().block_streamed_backward(
                x.data_ptr(), dy.data_ptr(), ptrs, strides, dx.data_ptr(), dw.data_ptr(),
                ws.data_ptr(), ws.numel(), b, n, d, heads, m, (d // heads) ** -0.5,
                _stream(x.device))
        else:
            part = torch.empty((b, sum(sizes)), device=x.device, dtype=torch.float32)
            rc = _lib().block_backward(x.data_ptr(), dy.data_ptr(), ptrs, strides, dx.data_ptr(),
                                       part.data_ptr(), dw.data_ptr(), b, n, d, d // heads, m,
                                       (d // heads) ** -0.5, _stream(x.device))
    if rc != 0:
        raise RuntimeError(f"block backward ({'streamed' if streamed else 'resident'}) launch "
                           f"failed with code {rc}")
    if streamed:
        LAUNCHES_BWD_STREAMED += 1
    else:
        LAUNCHES_BWD += 1
    grads = {name: g.view(shapes[name]) for name, g in zip(WEIGHT_NAMES, dw.split(sizes))}
    return dx, grads


def block_forward(x, w, heads: int):
    """y: the forward kernel for CUDA tensors, its plain version for CPU
    tensors."""
    if x.is_cuda:
        return _kernel_forward(x, w, heads)
    if x.device.type != "cpu":
        raise ValueError(f"unsupported device {x.device}")
    return fused_block_reference(x, w, heads)


def block_backward(x, dy, w, heads: int):
    """(dx, {name: grad}): the backward kernel for CUDA tensors, its plain
    version for CPU tensors."""
    if x.is_cuda:
        return _kernel_backward(x, dy, w, heads)
    if x.device.type != "cpu":
        raise ValueError(f"unsupported device {x.device}")
    return fused_block_bwd_reference(x, dy, w, heads)


# ---------------------------------------------------------------------------
# autograd op
# ---------------------------------------------------------------------------


class FusedBlock(torch.autograd.Function):
    """x [B, N, D] and the 12 weights (``WEIGHT_NAMES`` order) -> y. Saves
    (x, weights), the residuals of ``block_pallas.py:387-388``; the backward
    is the backward kernel."""

    @staticmethod
    def forward(ctx, x, heads, *weights):
        ctx.save_for_backward(x, *weights)
        ctx.heads = heads
        return block_forward(x, dict(zip(WEIGHT_NAMES, weights)), heads)

    @staticmethod
    def backward(ctx, dy):
        x, *weights = ctx.saved_tensors
        dx, dw = block_backward(x, dy.contiguous(), dict(zip(WEIGHT_NAMES, weights)), ctx.heads)
        return (dx, None, *(dw[name] for name in WEIGHT_NAMES))


def make_fused_block(dim: int, num_heads: int, mlp_ratio: float, seq_len: int):
    """Returns ``block(x [B, seq_len, dim] f32, weights dict) -> y`` with the
    fused forward and backward kernels (``block_pallas.make_fused_block``)."""
    shapes = weight_shapes(dim, int(dim * mlp_ratio))

    def block(x: torch.Tensor, w: Mapping[str, torch.Tensor]) -> torch.Tensor:
        if tuple(x.shape[1:]) != (seq_len, dim):
            raise ValueError(f"x has shape {tuple(x.shape)}, not [B, {seq_len}, {dim}]")
        for name, shape in shapes.items():
            if tuple(w[name].shape) != shape:
                raise ValueError(f"{name} has shape {tuple(w[name].shape)}, not {shape}")
        return FusedBlock.apply(x, num_heads, *(w[name] for name in WEIGHT_NAMES))

    return block
