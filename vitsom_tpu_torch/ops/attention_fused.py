"""Fused multi-head attention: hand-written CUDA forward and backward kernels.

Counterpart of ``vitsom_tpu/ops/attention_pallas.py``. The kernels in
``csrc/attention.cu`` (float32) and ``csrc/attention_bf16.cu`` (bf16 inputs
and outputs, float32 accumulation and lse) replace its TPU kernels
``_attn_fwd_kernel`` and ``_attn_bwd_kernel``; the sources' headers give
their design and their bound on the H100. The wrappers dispatch on the
inputs' dtype. Tensors stay in the model's [B, N, D] layout (D = H * hd, heads
are column slices), as in the JAX package:

- forward: q, k, v -> o [B, N, D] and the row log-sum-exp lse [B, H, N];
- backward: q, k, v, o, lse and the cotangent do -> dq, dk, dv [B, N, D],
  recomputing the probabilities from lse (flash-attention residuals: no
  N x N tensor is saved or written).

On a CUDA tensor each wrapper launches its kernel, or raises; on a CPU
tensor it runs the plain PyTorch version beside it. There is no fallback
from one to the other. q, k and v may be strided views (the model slices
them out of its fused qkv buffer) as long as their column stride is 1, at
any alignment.

Every head dim from 1 to 192 is taken (``MAX_HEAD_DIM``), as the JAX
kernel takes any: each runs at a tier, the first at least as wide
(``head_tier``, ``bf16_tier``), its staged rows and fragments zero past hd.

- float32 (``csrc/attention.cu``): hd 1-24 the row kernels on the FP32
  cores at tiers 2, 4, 8, 16, 24 (``ROW_TIERS``), and hd 25-32 there at tier
  32 up to N 880 (``ROW_WIDE_TIER``, ``ROW_WIDE_MAX_N``; ``row_kernels``
  says which calls); at its tier a head's rows
  are copied 16, 8 or 4 bytes at a time as the views' pointers and strides
  allow (``row_copy_width``), below it 4 bytes. hd 25-192 (25-32 past N 880) the 3xTF32
  tensor-core kernels (mma.sync) at the multiples of 8 in ``MMA_TIERS``;
  past 64 a CTA forms one slice of ceil(tier / 64) of the output columns
  (``mma_slices``), each recomputing the scores. 16-byte copies where hd is
  the tier and the rows start on 16-byte boundaries, else 4-byte ones.
- bf16 (``csrc/attention_bf16.cu``): hd 1-16 the tensor-core row kernels
  (mma.sync) at tiers 2, 8, 16 with the plan the wrapper passes
  (``bf16_hmma_plan``, ``bf16_hmma_score_tiles``); hd 17-192 the wgmma
  kernels, the head in 1, 2 or 3 column tiles of 64 (``BF16_TIERS``), a CTA
  a 64-column slice of the output. 16-byte copies where hd is the tier
  (a multiple of 8 for wgmma) and every view allows them, 2-byte loads
  elsewhere. The forwards hold a row's scores in registers up to N 72
  (mma.sync; the split measured in csrc/attention_bf16.cu) or 320 (wgmma)
  and walk the keys twice past it; ``bf16_kernel`` names the kernel a call
  runs. The bf16 backward also takes a float32 o with its float32
  cotangent (``hybrid``'s output).

A head dim past 192 is refused by ``check_shape``.
"""

from __future__ import annotations

import ctypes
from typing import Tuple

import torch

from vitsom_tpu_torch.ops import _build
from vitsom_tpu_torch.ops._build import SMEM_LIMIT_BYTES

# Kernel launches since the last reset (plain ints: chip_smoke.py zeroes
# them before a main-path run and reads them after).
LAUNCHES_FWD = 0
LAUNCHES_BWD = 0
LAUNCHES_FWD_BF16 = 0
LAUNCHES_BWD_BF16 = 0

# the tiers a head dim runs at, the first at least as wide (csrc/
# attention.cu: ATTN_ROW_TIERS, ATTN_MMA_TIERS; csrc/attention_bf16.cu:
# ATTN_BF16_TIERS), and the widest head dim the kernels take
ROW_TIERS = (2, 4, 8, 16, 24)
MMA_TIERS = (32, 40, 48, 56, 64, 80, 96, 112, 128, 192)
BF16_TIERS = (2, 8, 16, 64, 128, 192)
MAX_HEAD_DIM = 192
# the tensor-core kernels' tile constants (kRowTile, kMaxWarps, kPad,
# kKeyBlock: 8-key tiles a forward ring stage holds)
ROW_TILE, MAX_WARPS, SMEM_PAD, KEY_BLOCK = 16, 8, 4, 4
# the row kernels' (hd <= 24): threads of a CTA at most (kRowThreads),
# lanes of a row group (kRowLanes) and rows a group (kRowRows)
ROW_THREADS, ROW_LANES, ROW_ROWS = 128, 2, 2
# tier 32 on the row kernels (kRowWideTier, kRowWideMaxN): hd 25-32 up to
# N 880, a row a group; past it the tensor-core tier 32
ROW_WIDE_TIER, ROW_WIDE_MAX_N = 32, 880
# the bf16 kernels' (csrc/attention_bf16.cu: kTile, kHdp, kMaxKeyBlocks):
# from hd 17 up the 64-row wgmma tiles, 64 columns (128-byte rows) each,
# and the one-pass forward's key blocks at most (its scores stay in
# registers: N <= 320; the two-pass forward takes longer sequences)
BF16_TILE, BF16_HDP, BF16_MAX_KEY_BLOCKS = 64, 64, 5
BF16_TILE_BYTES = BF16_TILE * BF16_HDP * 2
BF16_SMEM_ALIGN = 1024  # the tiles' 128-byte swizzle repeats every 8 rows
# the bf16 tensor-core row kernels at hd <= 16 (mma.sync; kHmmaWarps,
# kHmmaMaxKeys): warps of a CTA at most, a 16-row tile each, and the
# one-pass forward's N at most (it keeps a row's scores in registers; the
# two-pass forward takes longer sequences; csrc/attention_bf16.cu gives
# the timings that set the split)
BF16_HMMA_WARPS, BF16_HMMA_MAX_KEYS = 8, 72
# the forward's register tiers (HMMA_SCORE_TILES, checked against the
# library): a warp's scores are 4 floats a lane for each 8-key tile of the
# smallest tier that holds ceil(N / 8) tiles
BF16_HMMA_SCORE_TILES = (2, 5, 9)

_LIB = None
_LIB_BF16 = None


def _lib():
    global _LIB
    if _LIB is None:
        lib = _build.load("attention")
        view = [ctypes.c_void_p, ctypes.c_longlong, ctypes.c_longlong]  # ptr, batch/row strides
        # B, N, H, hd, scale, the row copy width in bytes, stream
        dims = [ctypes.c_int] * 4 + [ctypes.c_float, ctypes.c_int, ctypes.c_void_p]
        lib.attention_forward.argtypes = view * 3 + [ctypes.c_void_p] * 2 + dims
        lib.attention_forward.restype = ctypes.c_int
        lib.attention_backward.argtypes = (
            view * 4 + [ctypes.c_void_p] + view + [ctypes.c_void_p] * 4 + dims
        )
        lib.attention_backward.restype = ctypes.c_int
        lib.attention_row_launch.argtypes = [ctypes.c_int] * 6 + [ctypes.c_void_p]
        lib.attention_row_launch.restype = ctypes.c_int
        tiles = (ctypes.c_int * 9)()
        lib.attention_tiles(tiles)
        want = (ROW_TILE, MAX_WARPS, SMEM_PAD, KEY_BLOCK, ROW_THREADS, ROW_LANES, ROW_ROWS,
                ROW_WIDE_TIER, ROW_WIDE_MAX_N)
        if tuple(tiles) != want:
            raise RuntimeError(
                "attention.cu tiles (kRowTile, kMaxWarps, kPad, kKeyBlock, kRowThreads, "
                f"kRowLanes, kRowRows, kRowWideTier, kRowWideMaxN) = {tuple(tiles)} differ "
                f"from the wrapper's {want}"
            )
        tiers = (ctypes.c_int * 32)()
        lib.attention_head_tiers(tiers)
        got = tuple(tiers)[:len(ROW_TIERS) + len(MMA_TIERS) + 2]
        if got != (*ROW_TIERS, 0, *MMA_TIERS, 0):
            raise RuntimeError(f"attention.cu head-dim tiers {got} differ from the wrapper's "
                               f"{ROW_TIERS} and {MMA_TIERS}")
        _LIB = lib
    return _LIB


def _lib_bf16():
    global _LIB_BF16
    if _LIB_BF16 is None:
        lib = _build.load("attention_bf16")
        view = [ctypes.c_void_p, ctypes.c_longlong, ctypes.c_longlong]
        # B, N, H, hd, scale, the tensor-core row plan (the forward's
        # register tier, chunks, warps), stream
        dims = [ctypes.c_int] * 4 + [ctypes.c_float] + [ctypes.c_int] * 3 + [ctypes.c_void_p]
        lib.attention_bf16_forward.argtypes = view * 3 + [ctypes.c_void_p] * 2 + dims
        lib.attention_bf16_forward.restype = ctypes.c_int
        # ..., dq, dk, dv, delta, do_split, dims without the tier
        lib.attention_bf16_backward.argtypes = (
            view * 4 + [ctypes.c_int, ctypes.c_void_p] + view + [ctypes.c_void_p] * 5
            + dims[:5] + dims[6:]
        )
        lib.attention_bf16_backward.restype = ctypes.c_int
        tiles = (ctypes.c_int * (5 + len(BF16_HMMA_SCORE_TILES)))()
        lib.attention_bf16_tiles(tiles)
        want = (BF16_TILE, BF16_HDP, BF16_MAX_KEY_BLOCKS, BF16_HMMA_WARPS, BF16_HMMA_MAX_KEYS,
                *BF16_HMMA_SCORE_TILES)
        if tuple(tiles) != want:
            raise RuntimeError(
                "attention_bf16.cu constants (kTile, kHdp, kMaxKeyBlocks, kHmmaWarps, "
                f"kHmmaMaxKeys, HMMA_SCORE_TILES) = {tuple(tiles)} differ from the wrapper's "
                f"{want}"
            )
        tiers = (ctypes.c_int * 16)()
        lib.attention_bf16_head_tiers(tiers)
        if tuple(tiers)[:len(BF16_TIERS) + 1] != (*BF16_TIERS, 0):
            raise RuntimeError(f"attention_bf16.cu head-dim tiers {tuple(tiers)} differ from "
                               f"the wrapper's {BF16_TIERS}")
        _LIB_BF16 = lib
    return _LIB_BF16


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


def head_tier(head_dim: int) -> int:
    """The float32 kernels' tier for ``head_dim``: the first of ROW_TIERS
    (1-24, the row kernels) or MMA_TIERS (25-192, the tensor-core kernels)
    at least as wide. Tier 32 runs on the row kernels up to N
    ROW_WIDE_MAX_N (``row_kernels``)."""
    for tier in ROW_TIERS + MMA_TIERS:
        if 1 <= head_dim <= tier:
            return tier
    raise ValueError(f"head_dim {head_dim} is outside 1..{MAX_HEAD_DIM}")


def bf16_tier(head_dim: int) -> int:
    """The bf16 kernels' tier for ``head_dim``: 2, 8, 16 (the tensor-core
    row kernels) or 64, 128, 192 (wgmma, the head in tier / 64 column
    tiles)."""
    for tier in BF16_TIERS:
        if 1 <= head_dim <= tier:
            return tier
    raise ValueError(f"head_dim {head_dim} is outside 1..{MAX_HEAD_DIM}")


def row_kernels(n: int, head_dim: int) -> bool:
    """Whether a float32 call at sequence length ``n`` runs the row kernels
    on the FP32 cores: hd 1-24, and hd 25-32 (tier ROW_WIDE_TIER) up to N
    ROW_WIDE_MAX_N; else the 3xTF32 tensor-core kernels."""
    return head_dim <= ROW_TIERS[-1] or (head_dim <= ROW_WIDE_TIER and n <= ROW_WIDE_MAX_N)


def row_tier(head_dim: int) -> int:
    """The row kernels' tier for ``head_dim``: its ``head_tier`` up to 24,
    ROW_WIDE_TIER for 25-32."""
    return head_tier(head_dim) if head_dim <= ROW_TIERS[-1] else ROW_WIDE_TIER


def row_rows(head_dim: int) -> int:
    """Rows a row group holds (csrc/attention.cu row_rows): ROW_ROWS up to
    hd 24, one at tier 32."""
    return ROW_ROWS if head_dim <= ROW_TIERS[-1] else 1


def mma_slices(head_dim: int) -> int:
    """Output column slices of the float32 tensor-core kernels at
    ``head_dim`` (a CTA each, the scores formed in every one): one up to
    tier 64, else ceil(tier / 64)."""
    tier = head_tier(head_dim)
    return 1 if tier <= 64 else _cdiv(tier, 64)


def mma_plan(n: int, head_dim: int = 64) -> Tuple[int, int]:
    """(chunks C, warps W) of one (b, h) in the tensor-core kernels: the
    ceil(N / 16) row tiles (query tiles in the forward, key tiles in the
    backward) cut into C chunks of at most ``MAX_WARPS`` warp tiles each
    (half as many at tier 192, where the backward's K and V rows of 16 W
    keys would not fit in shared memory)."""
    most = MAX_WARPS if head_tier(head_dim) <= 128 else MAX_WARPS // 2
    tiles = _cdiv(n, ROW_TILE)
    chunks = _cdiv(tiles, most)
    return chunks, _cdiv(tiles, chunks)


def row_plan(n: int, head_dim: int, backward: bool) -> Tuple[int, ...]:
    """The row kernels' grid at sequence length ``n`` (head dims 1-24, the
    same plan at each, and 25-32): a group of ``ROW_LANES`` lanes holds
    ``row_rows`` rows, a CTA at most ``ROW_THREADS`` threads; the N rows of a
    (b, h) are spread evenly over C chunks, a CTA each, rounded up to warps.
    Forward (C, threads); backward (C_A, C_B, threads), the key chunks of
    pass A and the query chunks of pass B in one launch."""
    if not 1 <= head_dim <= ROW_WIDE_TIER:
        raise ValueError(f"head_dim {head_dim} has no row kernel")
    rows = row_rows(head_dim)
    chunks = _cdiv(n, ROW_THREADS // ROW_LANES * rows)
    threads = _cdiv(_cdiv(_cdiv(n, chunks), rows) * ROW_LANES, 32) * 32
    return (chunks, chunks, threads) if backward else (chunks, threads)


def row_copy_width(views, head_dim: int) -> int:
    """Bytes of the widest copy the float32 row kernels can make of every
    head's row in the float32 ``views``: 16, 8 or 4. Each view's pointer and
    batch and row strides, and the head offsets (``head_dim`` elements),
    must be multiples of it. The flagship encoder's q, k, v views (rows 48
    floats, heads 8 apart) take 16; its decoder's (heads 2 apart) 8. A head
    dim below its tier (``head_tier``) runs the padded kernels, 4 bytes a
    copy."""
    if head_dim not in ROW_TIERS + (ROW_WIDE_TIER,):
        return 4
    for width in (16, 8):
        f = width // 4
        if head_dim % f == 0 and all(
                x.data_ptr() % width == 0 and x.stride(0) % f == 0 and x.stride(1) % f == 0
                for x in views):
            return width
    return 4


def row_launch(b: int, n: int, heads: int, head_dim: int, backward: bool,
               width: int) -> Tuple[int, int, int, int]:
    """(CTAs, threads, shared memory bytes, resident CTAs an SM) of a row
    kernel's launch, from the built library (CUDA only)."""
    out = (ctypes.c_int * 4)()
    rc = _lib().attention_row_launch(b, n, heads, head_dim, int(backward), width, out)
    if rc != 0:
        raise RuntimeError(f"attention_row_launch failed with code {rc}")
    return tuple(out)


def smem_bytes(n: int, head_dim: int, backward: bool) -> int:
    """Dynamic shared memory of one CTA (``csrc/attention.cu``'s header),
    at the head dim's tier T (``head_tier``; ``row_tier`` on the row kernels).

    The row kernels (``row_kernels``): two staged [N, T] operands, plus lse
    and delta rows in the backward. The tensor-core kernels: rows of T + SMEM_PAD floats; the forward a
    two-stage ring of K blocks and of V blocks (the slice's T / slices
    columns) of 8 * KEY_BLOCK keys; the backward its chunk's K and V rows,
    a two-stage ring of 16-row q and do tiles, lse and delta (N rounded up
    to 16) and a [16, keys] ds tile whose row stride is 8 mod 32 floats."""
    if row_kernels(n, head_dim):
        return 4 * (2 * n * row_tier(head_dim) + (2 * n if backward else 0))
    tier = head_tier(head_dim)
    ld = tier + SMEM_PAD
    if not backward:
        return 4 * 2 * 8 * KEY_BLOCK * (ld + tier // mma_slices(head_dim) + SMEM_PAD)
    nq = _cdiv(n, ROW_TILE) * ROW_TILE
    keys = mma_plan(n, head_dim)[1] * ROW_TILE
    lds = keys + (8 - keys) % 32
    return 4 * ((2 * keys + 4 * ROW_TILE) * ld + 2 * nq + ROW_TILE * lds)


def bf16_mma_plan(n: int) -> Tuple[int, int, int]:
    """The bf16 wgmma kernels' grid a (b, h) at sequence length ``n`` (hd
    17-64; from 65 the grid's y dimension adds the column slices), CTAs of one warpgroup (128 threads): (forward CTAs, the
    forward's 64-key blocks, which are also its 64-row query tiles,
    backward CTAs: a key-role and a query-role CTA a 64-row tile). The
    one-pass forward (up to BF16_MAX_KEY_BLOCKS blocks) runs one CTA over
    every query tile; the two-pass forward a CTA a query tile."""
    tiles = _cdiv(n, BF16_TILE)
    return 1 if tiles <= BF16_MAX_KEY_BLOCKS else tiles, tiles, 2 * tiles


def wide_copies(views, head_dim: int) -> bool:
    """Whether the tensor-core kernels (float32 from hd 25, bf16 from 17)
    copy every head's rows of ``views`` 16 bytes at a time: hd is its tier
    (float32) or a multiple of 8 (bf16), and every view's pointer and batch
    and row strides are multiples of 16 bytes (``csrc/attention.cu``:
    mma_pad; ``csrc/attention_bf16.cu``: mma_narrow). Elsewhere they copy 4
    bytes (float32) or 2 (bf16) at a time. The model's q, k and v, column
    slices of its [B, N, 3, D] qkv buffer, take 16 at every shipped width."""
    size = views[0].element_size()
    if head_dim % (16 // size) or (size == 4 and head_tier(head_dim) != head_dim):
        return False
    return all(x.data_ptr() % 16 == 0 and (x.stride(0) * size) % 16 == 0
               and (x.stride(1) * size) % 16 == 0 for x in views)


def bf16_kernel(n: int, head_dim: int, backward: bool = False, views=None) -> str:
    """The bf16 kernel that serves a call at sequence length ``n`` and
    ``head_dim`` on the q, k, v ``views`` (None: views that take 16-byte
    copies, as the model's do) (``csrc/attention_bf16.cu``; the name the
    profiler shows): hd 1-16 the tensor-core row kernels (mma.sync), 17-192
    the wgmma ones. A forward holds a row's scores in registers up to
    BF16_HMMA_MAX_KEYS (``attn_fwd_hmma_bf16``) or, at hd 17-64, 320 keys
    (``attn_fwd_mma_bf16``) and walks the keys twice past it, and on wgmma
    at every N from hd 65 on and where the rows take no 16-byte copies
    (``wide_copies``: hd not a multiple of 8, or views off 16-byte
    boundaries) (``attn_fwd_hmma2_bf16``, ``attn_fwd_mma2_bf16``); the
    backwards (``attn_bwd_hmma_bf16``, ``attn_bwd_mma_bf16``) take any N, on
    bf16 or float32 o and do, whatever the views' alignment."""
    tier = bf16_tier(head_dim)
    kind = "mma" if tier >= BF16_HDP else "hmma"
    if backward:
        return f"attn_bwd_{kind}_bf16"
    narrow = head_dim % 8 or (views is not None and not wide_copies(views, head_dim))
    two_pass = (n > BF16_HMMA_MAX_KEYS if kind == "hmma" else
                tier > BF16_HDP or narrow or n > BF16_TILE * BF16_MAX_KEY_BLOCKS)
    return f"attn_fwd_{kind}{'2' if two_pass else ''}_bf16"


def bf16_hmma_plan(n: int) -> Tuple[int, int]:
    """The tensor-core row kernels' grid a (b, h) at sequence length ``n``:
    (chunks C, warps W). The ceil(N / 16) 16-row tiles (query tiles in the
    forward; key tiles and query tiles in the backward's two roles) are
    spread over C chunks of at most BF16_HMMA_WARPS, a tile a warp, tile c
    + C w in warp w of chunk c. The forward launches C CTAs a (b, h), the
    backward 2 C (a key-role and a query-role CTA a chunk), of 32 W
    threads."""
    tiles = _cdiv(n, 16)
    chunks = _cdiv(tiles, BF16_HMMA_WARPS)
    return chunks, _cdiv(tiles, chunks)


def bf16_hmma_score_tiles(n: int) -> int:
    """The tensor-core row forward's register tier at sequence length
    ``n``: up to BF16_HMMA_MAX_KEYS the 8-key tiles of scores the one-pass
    form holds, 4 floats a lane each (USPS's N 65 and the JAX tests' 9,
    33 exactly); past it 0, the two-pass form."""
    if n > BF16_HMMA_MAX_KEYS:
        return 0
    return min(t for t in BF16_HMMA_SCORE_TILES if 8 * t >= n)


def bf16_key_stages(head_dim: int, f32_do: bool = False) -> int:
    """Ring stages of the wgmma backward's key role: two where a second
    stage of q and do's parts fits beside k and v, else one (hd 129-192 on
    hybrid's float32 do, whose three parts take 3 column tiles each)."""
    hc, parts = bf16_tier(head_dim) // BF16_HDP, 3 if f32_do else 1
    two = (BF16_SMEM_ALIGN + (2 * hc + 2 * hc * (1 + parts)) * BF16_TILE_BYTES
           + 2 * 2 * BF16_TILE * 4 + 3 * 8)
    return 2 if two <= SMEM_LIMIT_BYTES else 1


def bf16_smem_bytes(n: int, head_dim: int, backward: bool, f32_do: bool = False) -> int:
    """Dynamic shared memory of one CTA of the bf16 kernels
    (``csrc/attention_bf16.cu``); ``f32_do``: hybrid's float32 do, split
    into three bf16 parts.
    hd <= 16 (the tensor-core row kernels, both forward forms alike):
    [NP][T] bf16 tiles (T the tier: 2, 8, 16), N padded to NP = 16
    ceil(N / 16) rows: the forward's k and v; the backward's key role q and
    do's parts (one, or three), its NP delta floats and, beside a bf16 do,
    NP lse floats (on a float32 do it reads lse from global memory). Every
    N the float32 kernels take at the same hd fits.
    hd >= 17: [64][64] bf16 tiles (BF16_TILE_BYTES), the head padded to HC
    = 1, 2 or 3 column tiles, after BF16_SMEM_ALIGN bytes of slack for their
    1024-byte alignment; the one-pass forward (HC 1) every key block of k
    and of v, two q tiles, 128 bytes for four 8-byte mbarriers and the o
    tile that stages its stores; the two-pass forward (past
    BF16_MAX_KEY_BLOCKS blocks, HC 2 and 3, or hd % 8) its q tiles, a two-stage ring
    of k and the slice's v, the o tile and three mbarriers; the backward
    its larger role: the key role's k and v and S (``bf16_key_stages``)
    ring stages of q and do's parts with 64 lse and 64 delta floats a stage,
    an mbarrier for k and v and one a stage; or the query role's q and do's
    parts, a two-stage ring of k and v and three mbarriers."""
    parts = 3 if f32_do else 1
    tier = bf16_tier(head_dim)
    if tier < BF16_HDP:
        rows = 16 * _cdiv(n, 16)
        tile = rows * tier * 2
        return (1 + parts) * tile + (1 if f32_do else 2) * rows * 4 if backward else 2 * tile
    hc = tier // BF16_HDP
    if not backward:
        blocks = bf16_mma_plan(n)[1]
        if hc > 1 or head_dim % 8 or blocks > BF16_MAX_KEY_BLOCKS:
            return BF16_SMEM_ALIGN + (3 * hc + 3) * BF16_TILE_BYTES + 3 * 8
        return BF16_SMEM_ALIGN + (2 * blocks + 3) * BF16_TILE_BYTES + 128
    stages = bf16_key_stages(head_dim, f32_do)
    keys = (BF16_SMEM_ALIGN + (2 * hc + stages * hc * (1 + parts)) * BF16_TILE_BYTES
            + stages * 2 * BF16_TILE * 4 + (1 + stages) * 8)
    queries = BF16_SMEM_ALIGN + (hc * (1 + parts) + 4 * hc) * BF16_TILE_BYTES + 3 * 8
    return max(keys, queries)


def check_shape(n: int, head_dim: int, backward: bool, dtype=torch.float32,
                f32_do: bool = False) -> None:
    """Raises ValueError unless the kernels take sequence length ``n`` at
    ``head_dim`` (1 to MAX_HEAD_DIM, and its CTA's working set fits in
    shared memory)."""
    if not 1 <= head_dim <= MAX_HEAD_DIM:
        raise ValueError(
            f"head_dim {head_dim} is outside 1..{MAX_HEAD_DIM}: the kernels pad a head to a "
            f"tier of at most {MAX_HEAD_DIM} columns (float32 {ROW_TIERS + MMA_TIERS}, bf16 "
            f"{BF16_TIERS})")
    need = (bf16_smem_bytes(n, head_dim, backward, f32_do) if dtype == torch.bfloat16
            else smem_bytes(n, head_dim, backward))
    if need > SMEM_LIMIT_BYTES:
        raise ValueError(
            f"N={n} at head_dim {head_dim} needs {need} bytes of shared memory per block, "
            f"more than {SMEM_LIMIT_BYTES}"
        )


def _split(x: torch.Tensor, heads: int) -> torch.Tensor:
    b, n, d = x.shape
    return x.reshape(b, n, heads, d // heads)


# ---------------------------------------------------------------------------
# plain versions
# ---------------------------------------------------------------------------


def _acc(x: torch.Tensor) -> torch.Tensor:
    """x in its accumulation dtype: float32, or float64 for float64 x."""
    return x.to(torch.promote_types(x.dtype, torch.float32))


def _exp(x: torch.Tensor, rounded: bool) -> torch.Tensor:
    """exp of x. Where a bf16 rounding follows (``rounded``: bf16 inputs),
    float32 x takes exp in float64, rounded once to float32: torch's float32
    exp on the CPU gives the last bit by the path an element takes
    (vectorised or not, which the threads' split of the tensor decides),
    and the bf16 roundings of p after it turn one such bit into whole bf16
    ulps of the outputs, so the plain version would differ from run to
    run."""
    if rounded and x.dtype == torch.float32:
        return torch.exp(x.double()).float()
    return torch.exp(x)


def fused_attention_reference(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, heads: int
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of the forward kernel at the JAX kernel's
    steps: [B, N, D] q, k, v -> (o [B, N, D], lse [B, H, N]). Scores are
    accumulated in float32 (float64 for float64 inputs) and scaled, then
    ``m``, ``p = exp(s - m)`` (``_exp``), ``l``, ``attn = (p / l)`` rounded to v's
    dtype (a no-op unless bf16) and ``attn v`` accumulated as the scores
    are. Returns that accumulated o, contiguous (``_hybrid_fwd``'s output,
    which the backward kernel takes); the kernel (and
    :func:`attention_forward`) stores it in the inputs' dtype."""
    b, n, d = q.shape
    scale = (d // heads) ** -0.5
    qh, kh, vh = (_acc(_split(x, heads)) for x in (q, k, v))
    scores = torch.einsum("bnhd,bmhd->bhnm", qh, kh) * scale
    m = torch.amax(scores, dim=-1, keepdim=True)
    p = _exp(scores - m, v.dtype == torch.bfloat16)
    denom = torch.sum(p, dim=-1, keepdim=True)
    attn = (p / denom).to(v.dtype).to(p.dtype)
    o = torch.einsum("bhnm,bmhd->bnhd", attn, vh)
    return o.reshape(b, n, d).contiguous(), (m + torch.log(denom))[..., 0]


def attention_delta_reference(o: torch.Tensor, do: torch.Tensor, heads: int) -> torch.Tensor:
    """Plain version of the bf16 tensor-core backward's pre-pass
    (``attn_delta_bf16``): delta = rowsum(do o) over each head's columns,
    [B, H, N], in float32 (float64 for float64 inputs), from o and do as
    they are stored (bf16, or hybrid's float32)."""
    oh, doh = (_acc(_split(x, heads)) for x in (o, do))
    return torch.sum(doh * oh, dim=-1).transpose(1, 2)


def fused_attention_bwd_reference(q, k, v, o, lse, do, heads: int):
    """Plain PyTorch version of the backward kernel: (dq, dk, dv), each
    [B, N, D] in q's dtype, as ``_fused_attention_bwd_impl`` computes them.
    o and do are in q's dtype, or float32 beside bf16 q, k, v (hybrid's
    output and its cotangent). At the JAX kernel's steps, products
    accumulated as in :func:`fused_attention_reference`:
    p = exp(s - lse), dv = bf16(p)^T do, dp = do v^T,
    delta = rowsum(do o), ds = bf16(p (dp - delta) scale), dq = ds k,
    dk = ds^T q; each bf16 rounding a no-op unless the inputs are bf16."""
    b, n, d = q.shape
    scale = (d // heads) ** -0.5
    qh, kh, vh, doh = (_acc(_split(x, heads)) for x in (q, k, v, do))
    p = _exp(torch.einsum("bnhd,bmhd->bhnm", qh, kh) * scale - lse[..., None],
             v.dtype == torch.bfloat16)
    dv = torch.einsum("bhnm,bnhd->bmhd", p.to(v.dtype).to(p.dtype), doh)
    dp = torch.einsum("bnhd,bmhd->bhnm", doh, vh)
    delta = attention_delta_reference(o, do, heads)[..., None]  # [B, H, N, 1]
    ds = (p * (dp - delta) * scale).to(q.dtype).to(p.dtype)
    dq = torch.einsum("bhnm,bmhd->bnhd", ds, kh)
    dk = torch.einsum("bhnm,bnhd->bmhd", ds, qh)
    return tuple(x.reshape(b, n, d).to(q.dtype) for x in (dq, dk, dv))


# ---------------------------------------------------------------------------
# kernels
# ---------------------------------------------------------------------------


def _check(tensors, heads: int, backward: bool):
    """(B, N, hd) after checking what the kernels take; raises otherwise.
    All are float32, or all bf16 (the bf16 kernels); a bf16 backward's o
    and do (``tensors[3:]``) may instead both be float32 (hybrid)."""
    ref = tensors[0]
    if ref.ndim != 3:
        raise ValueError(f"attention kernels take [B, N, D] tensors, got {tuple(ref.shape)}")
    b, n, d = ref.shape
    if ref.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"attention kernels take float32 or bfloat16, got {ref.dtype}")
    for i, x in enumerate(tensors):
        if not x.is_cuda or x.device != ref.device:
            raise ValueError("attention kernel inputs must be on the same CUDA device")
        want = tensors[3].dtype if backward and i == 4 else ref.dtype
        f32_o = backward and i == 3 and ref.dtype == torch.bfloat16
        if x.dtype != want and not (f32_o and x.dtype == torch.float32):
            raise TypeError(f"attention kernel inputs mix {want} and {x.dtype}")
        if tuple(x.shape) != (b, n, d):
            raise ValueError(f"shape {tuple(x.shape)} differs from {(b, n, d)}")
        if x.stride(2) != 1:
            raise ValueError(f"attention kernels need unit column stride, got strides {x.stride()}")
    if b < 1 or n < 1 or heads < 1 or d % heads:
        raise ValueError(f"bad attention shape B={b} N={n} D={d} heads={heads}")
    hd = d // heads
    check_shape(n, hd, backward, ref.dtype, backward and tensors[4].dtype != ref.dtype)
    return b, n, hd


def _view(x: torch.Tensor):
    return (x.data_ptr(), x.stride(0), x.stride(1))


def _stream(dev):
    return torch.cuda.current_stream(dev).cuda_stream


def _hmma_plan(n: int, hd: int) -> Tuple[int, int]:
    """(chunks, warps) of the bf16 tensor-core row kernels (hd <= 16), else
    (0, 0): the wgmma kernels plan their own grid."""
    return (0, 0) if bf16_tier(hd) >= BF16_HDP else bf16_hmma_plan(n)


def _kernel_forward(q, k, v, heads: int):
    global LAUNCHES_FWD, LAUNCHES_FWD_BF16
    b, n, hd = _check((q, k, v), heads, backward=False)
    bf16 = q.dtype == torch.bfloat16
    o = torch.empty((b, n, heads * hd), device=q.device, dtype=q.dtype)
    lse = torch.empty((b, heads, n), device=q.device, dtype=torch.float32)
    args = [*_view(q), *_view(k), *_view(v), o.data_ptr(), lse.data_ptr(),
            b, n, heads, hd, hd**-0.5]
    if bf16:
        plan = _hmma_plan(n, hd)
        args += [bf16_hmma_score_tiles(n) if plan[0] else 0, *plan]
    else:
        args.append(row_copy_width((q, k, v), hd))
    lib = _lib_bf16() if bf16 else _lib()
    launch = lib.attention_bf16_forward if bf16 else lib.attention_forward
    with torch.cuda.device(q.device):
        rc = launch(*args, _stream(q.device))
    if rc != 0:
        raise RuntimeError(f"attention forward ({q.dtype}) launch failed with code {rc}")
    if bf16:
        LAUNCHES_FWD_BF16 += 1
    else:
        LAUNCHES_FWD += 1
    return o, lse


def _kernel_backward(q, k, v, o, lse, do, heads: int):
    global LAUNCHES_BWD, LAUNCHES_BWD_BF16
    b, n, hd = _check((q, k, v, o, do), heads, backward=True)
    if (lse.device != q.device or lse.dtype != torch.float32
            or tuple(lse.shape) != (b, heads, n) or not lse.is_contiguous()):
        raise ValueError("lse must be a contiguous float32 [B, H, N] tensor beside q")
    bf16 = q.dtype == torch.bfloat16
    # the tensor-core kernels: bf16 wgmma from hd 17, float32 3xTF32 from 25
    # (25-32 past N ROW_WIDE_MAX_N)
    mma = bf16_tier(hd) >= BF16_HDP if bf16 else not row_kernels(n, hd)
    dq, dk, dv = (torch.empty((b, n, heads * hd), device=q.device, dtype=q.dtype)
                  for _ in range(3))
    lib = _lib_bf16() if bf16 else _lib()
    with torch.cuda.device(q.device):
        if bf16:
            # the tensor-core backward's workspaces: delta = rowsum(do o) of
            # the pre-pass, and a float32 do's three bf16 parts
            delta = (torch.empty((b, heads, n), device=q.device, dtype=torch.float32)
                     if mma else None)
            split = (torch.empty((3, b, n, heads * hd), device=q.device, dtype=torch.bfloat16)
                     if mma and o.dtype == torch.float32 else None)
            rc = lib.attention_bf16_backward(
                *_view(q), *_view(k), *_view(v), *_view(o), int(o.dtype == torch.float32),
                lse.data_ptr(), *_view(do), dq.data_ptr(), dk.data_ptr(), dv.data_ptr(),
                None if delta is None else delta.data_ptr(),
                None if split is None else split.data_ptr(),
                b, n, heads, hd, hd**-0.5, *_hmma_plan(n, hd), _stream(q.device),
            )
        else:
            chunks = mma_plan(n, hd)[0] if mma else 1
            # the key chunks' dq partials, summed in chunk order by a second launch
            part = (torch.empty((chunks, b, n, heads * hd), device=q.device,
                                dtype=torch.float32) if chunks > 1 else None)
            rc = lib.attention_backward(
                *_view(q), *_view(k), *_view(v), *_view(o), lse.data_ptr(), *_view(do),
                dq.data_ptr(), dk.data_ptr(), dv.data_ptr(),
                None if part is None else part.data_ptr(),
                b, n, heads, hd, hd**-0.5, row_copy_width((q, k, v, o, do), hd),
                _stream(q.device),
            )
    if rc != 0:
        raise RuntimeError(f"attention backward ({q.dtype}) launch failed with code {rc}")
    if bf16:
        LAUNCHES_BWD_BF16 += 1
    else:
        LAUNCHES_BWD += 1
    return dq, dk, dv


def attention_forward(q, k, v, heads: int):
    """(o, lse): the forward kernel for CUDA tensors, its plain version for
    CPU tensors."""
    if q.is_cuda:
        return _kernel_forward(q, k, v, heads)
    if q.device.type != "cpu":
        raise ValueError(f"unsupported device {q.device}")
    o, lse = fused_attention_reference(q, k, v, heads)
    return o.to(q.dtype), lse


def attention_backward(q, k, v, o, lse, do, heads: int):
    """(dq, dk, dv): the backward kernel for CUDA tensors, its plain version
    for CPU tensors."""
    if q.is_cuda:
        return _kernel_backward(q, k, v, o, lse, do, heads)
    if q.device.type != "cpu":
        raise ValueError(f"unsupported device {q.device}")
    return fused_attention_bwd_reference(q, k, v, o, lse, do, heads)


# ---------------------------------------------------------------------------
# autograd op
# ---------------------------------------------------------------------------


class FusedAttention(torch.autograd.Function):
    """[B, N, D] q, k, v -> o. Saves (q, k, v, o, lse), the residuals of
    ``attention_pallas.py:155``; the backward is the backward kernel."""

    @staticmethod
    def forward(ctx, q, k, v, heads):
        o, lse = attention_forward(q, k, v, heads)
        ctx.save_for_backward(q, k, v, o, lse)
        ctx.heads = heads
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, o, lse = ctx.saved_tensors
        if do.stride(-1) != 1:
            do = do.contiguous()
        return (*attention_backward(q, k, v, o, lse, do, ctx.heads), None)


def fused_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """q, k, v: [B, N, H, hd] -> out [B, N, H, hd], softmax(q k^T / sqrt(hd)) v."""
    b, n, h, hd = q.shape
    o = FusedAttention.apply(*(x.reshape(b, n, h * hd) for x in (q, k, v)), h)
    return o.reshape(b, n, h, hd)
