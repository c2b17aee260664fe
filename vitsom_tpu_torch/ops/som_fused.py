"""Fused SOM step: a hand-written CUDA forward with a closed-form backward.

Replaces the TPU kernel ``vitsom_tpu/ops/som_pallas.py:_som_kernel``
(launched by ``_forward_impl``, wrapped by ``make_fused_som``). For latents
``x [B, D]`` and ``prototypes [P, D]`` the op returns

- ``loss``: mean over B*P of ``w * dist`` with Gaussian neighbourhood
  weights ``w = exp(-d2 / (2 T^2))``, ``d2`` the squared grid distance to
  the BMU, computed analytically from square/hexa grid coordinates;
- ``bmu``: [B] int64 argmin of each row, the first index on a tie;
- ``dist``: [B, P] cosine or euclidean distances.

On a CUDA tensor the forward runs ``csrc/som_fused.cu``, two launches:

1. a grid of (128-prototype tiles, 64-row batch tiles, S splits of D). In
   each CTA two producer warpgroups copy 32-deep chunks of x and the
   prototypes with ``cp.async`` into a 3-stage shared-memory ring and split
   every value into a TF32 big part and a TF32 residual; a consumer
   warpgroup multiplies them on the tensor cores with ``wgmma`` in the
   3xTF32 form (small*big + big*small + big*big, float32 accuracy), each
   chunk's products added to an FP32 accumulator outside the tensor cores.
   The CTA writes partial dot products and partial sums of squares to a
   workspace;
2. one CTA per batch row sums the S partials in a fixed order, forms the
   distances, the first-index argmin, the weights and the row's loss term;
   the last row to finish sums the row terms in row order. No float
   atomics: two runs give bitwise-equal distances and losses.

``plan_splits`` picks S from the shape alone: as many splits as fit the
grid in one wave of the H100's 132 SMs (one CTA an SM), evened out over
whole chunks. At the main path's shape (B 128, D 3136, P 1600) that is S 5
and 130 CTAs. Bound there on an H100 SXM: 3 TF32 products of 2*B*P*D =
3.85 GFLOP at 495 TFLOP/s, 7.78 us, against 22.5 MB at 3.35 TB/s, 6.72 us:
operations. What still holds the kernel back: shared-memory bandwidth (3
reads of both operands a product, beside the copies and splits), the
consumer's wait for its accumulator once a chunk, and the finalize's fixed
cost. The copies are 16 bytes wide where x's and the prototypes' base
addresses are 16-byte aligned and ``ldx`` and D are multiples of 4 floats
(``wide_copies``; every shipped ViT-SOM config), else 4 bytes wide, zero
past D: any D >= 1 and any row stride ``ldx >= D`` is taken
(``check_shape``), as the JAX kernel takes any D.

On a CPU tensor the op runs ``fused_som_reference``, the plain PyTorch
version of the same function. A CUDA tensor never falls back to the plain
version: the kernel launches or the call raises.

The backward is the closed form of ``som_pallas.py:260-286`` in torch ops
(weights are stop-gradient; they depend on the inputs only through the
integer BMU):

  L = mean(w * d),   dL/dd_bp = g * w_bp / (B*P) =: c_bp
  euclidean: dx = x * sum_p(e) - e @ P,   dp = p * sum_b(e) - e^T @ x,   e = c / d
  cosine:    dx = -(c @ Pn - sum_p(c*s) * xn) / |x|
             dp = -(c^T @ Xn - sum_b(c*s) * pn) / |p|,   s = 1 - d
"""

from __future__ import annotations

import ctypes
from typing import Tuple

import torch

from vitsom_tpu_torch.ops import _build
from vitsom_tpu_torch.parallel import distributed as dist_lib
from vitsom_tpu_torch.som.layer import two_t_squared_tensor

_SQRT3_2 = 0.8660254037844386

# Forward launches of the CUDA kernel since the last reset (a plain int:
# chip_smoke.py zeroes it before the main path and reads it after).
LAUNCHES = 0

_LIB = None


def _lib():
    global _LIB
    if _LIB is None:
        lib = _build.load("som_fused")
        fn = lib.som_fused_forward
        fn.argtypes = [
            ctypes.c_void_p, ctypes.c_longlong,  # x, ldx
            ctypes.c_void_p,  # prototypes
            ctypes.c_void_p, ctypes.c_void_p,  # dist, bmu
            ctypes.c_void_p, ctypes.c_void_p,  # workspace, loss
            ctypes.c_int, ctypes.c_int, ctypes.c_int,  # B, P, D
            ctypes.c_int, ctypes.c_int,  # splits, chunks per split
            ctypes.c_int, ctypes.c_int, ctypes.c_int,  # cols, hexa, cosine
            ctypes.c_void_p,  # temperature: one float on the device
            ctypes.c_int,  # wide: 16-byte copies (wide_copies), else 4-byte
            ctypes.c_void_p,  # stream
        ]
        fn.restype = ctypes.c_int
        tiles = (ctypes.c_int * 3)()
        lib.som_fused_tiles(tiles)
        if tuple(tiles) != (TILE_B, TILE_P, CHUNK):
            raise RuntimeError(
                f"som_fused.cu tiles (kBM, kBN, kBK) = {tuple(tiles)} differ from "
                f"TILE_B, TILE_P, CHUNK = {(TILE_B, TILE_P, CHUNK)}"
            )
        _LIB = lib
    return _LIB


# ---------------------------------------------------------------------------
# the kernel's grid and what its copies need (no CUDA needed)
# ---------------------------------------------------------------------------

# som_fused.cu's kBM, kBN, kBK; _lib() refuses a library whose tiles differ
TILE_B, TILE_P, CHUNK = 64, 128, 32
WAVE_CTAS = 132  # one CTA on each SM of the H100


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


def plan_splits(b: int, p: int, d: int) -> Tuple[int, int]:
    """(S, depth per split) of the kernel's split over D, from the shape alone.

    S is the largest number of splits whose grid of (P tiles x B tiles x S)
    CTAs fits one wave of ``WAVE_CTAS`` (at least 1, at most one split per
    32-deep chunk), then evened out: every split takes the same whole
    number of chunks, the last the rest (never none)."""
    tiles = _cdiv(b, TILE_B) * _cdiv(p, TILE_P)
    chunks = _cdiv(d, CHUNK)
    s = max(1, min(WAVE_CTAS // tiles, chunks))
    per = _cdiv(chunks, s)
    return _cdiv(chunks, per), per * CHUNK


def grid_ctas(b: int, p: int, d: int) -> int:
    """CTAs of the kernel's first launch at this shape."""
    return _cdiv(b, TILE_B) * _cdiv(p, TILE_P) * plan_splits(b, p, d)[0]


def workspace_floats(b: int, p: int, splits: int) -> int:
    """Floats of the kernel's workspace: partial dot products [S, B, P],
    partial sums of squares [S, B] and [S, P], row loss terms [B] and the
    finalize's count of finished rows."""
    return splits * (b * p + b + p) + b + 1


def check_shape(b: int, p: int, d: int, ldx: int) -> None:
    """Raises ValueError unless the kernel takes this shape: any B, P, D >=
    1 and x's row stride ``ldx >= D`` (rows that do not fit 16-byte copies
    take 4-byte ones: ``wide_copies``). Needs no CUDA."""
    if min(b, p, d) < 1:
        raise ValueError(f"empty input: B={b}, P={p}, D={d}")
    if ldx < d:
        raise ValueError(f"x's rows overlap: row stride ldx={ldx} is less than D={d}")


def wide_copies(d: int, ldx: int, x_ptr: int, p_ptr: int) -> bool:
    """Whether the kernel's copies are 16 bytes wide (``cp.async`` of 4
    floats): x's and the prototypes' base addresses 16-byte aligned and
    x's row stride ``ldx`` and the depth D multiples of 4 floats. Else each
    float is copied alone (4 bytes), zero past D. Every shipped ViT-SOM
    config takes the wide copies."""
    return d % 4 == 0 and ldx % 4 == 0 and x_ptr % 16 == 0 and p_ptr % 16 == 0


# ---------------------------------------------------------------------------
# analytic grid geometry
# ---------------------------------------------------------------------------


def _grid_coords(idx: torch.Tensor, cols: int, topology: str):
    row = torch.div(idx, cols, rounding_mode="floor")
    col = idx - row * cols
    if topology == "square":
        return row.float(), col.float()
    odd = (row % 2).float()
    return col.float() + 0.5 * odd, row.float() * _SQRT3_2


def grid_d2_rows(bmu_idx: torch.Tensor, n_prototypes: int, cols: int, topology: str):
    """[B] BMU indices -> [B, P] squared grid distances, computed
    analytically (no [P, P] table)."""
    pa, pb = _grid_coords(
        torch.arange(n_prototypes, device=bmu_idx.device), cols, topology
    )
    ba, bb = _grid_coords(bmu_idx.long(), cols, topology)
    da = ba[:, None] - pa[None, :]
    db = bb[:, None] - pb[None, :]
    return da * da + db * db


# ---------------------------------------------------------------------------
# forward: plain version and kernel
# ---------------------------------------------------------------------------


def temperature_tensor(temperature, device) -> torch.Tensor:
    """The temperature as a 0-d float32 tensor on ``device``: a tensor is
    moved (a no-op where it already lies there), a host float is written by
    a fill kernel (no host-to-device copy), rounded to float32 as the
    kernel's former by-value argument was."""
    if isinstance(temperature, torch.Tensor):
        return temperature.to(device=device, dtype=torch.float32).reshape(())
    return torch.full((), float(temperature), dtype=torch.float32, device=device)


def fused_som_reference(
    x: torch.Tensor,
    prototypes: torch.Tensor,
    temperature,
    cols: int,
    topology: str,
    distance_fcn: str,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of the kernel's forward: (loss, bmu, dist).

    ``temperature`` is a host float or a float32 tensor; either way ``2 T^2``
    is formed in float32 tensor arithmetic, as the kernel forms it, so the
    two give bitwise-equal results. Differentiable through autograd (the
    weights are built from the integer BMU, so no gradient flows through
    them)."""
    if distance_fcn == "cosine":
        xn = x * torch.rsqrt(torch.clamp_min(torch.sum(x * x, dim=1, keepdim=True), 1e-24))
        pn = prototypes * torch.rsqrt(
            torch.clamp_min(torch.sum(prototypes * prototypes, dim=1, keepdim=True), 1e-24)
        )
        dist = 1.0 - xn @ pn.T
    elif distance_fcn == "euclidean":
        x2 = torch.sum(x * x, dim=1, keepdim=True)
        p2 = torch.sum(prototypes * prototypes, dim=1)[None, :]
        dist = torch.sqrt(torch.clamp_min(x2 - 2.0 * (x @ prototypes.T) + p2, 0.0))
    else:
        raise ValueError(f"fused SOM supports euclidean/cosine, got {distance_fcn}")
    b, p = dist.shape
    bmu = torch.argmin(dist, dim=1)
    two_t2 = two_t_squared_tensor(temperature_tensor(temperature, dist.device))
    w = torch.exp(-grid_d2_rows(bmu, p, cols, topology) / two_t2)
    loss = torch.sum(w * dist) / (b * p)
    return loss, bmu, dist


def _kernel_forward(x, prototypes, temperature, cols, topology, distance_fcn):
    global LAUNCHES
    if not prototypes.is_cuda or prototypes.device != x.device:
        raise ValueError("x and prototypes must be on the same CUDA device")
    if x.dtype != torch.float32 or prototypes.dtype != torch.float32:
        raise TypeError("the fused SOM kernel takes float32 x and prototypes")
    if x.ndim != 2 or prototypes.ndim != 2 or x.shape[1] != prototypes.shape[1]:
        raise ValueError(f"bad shapes x {tuple(x.shape)}, prototypes {tuple(prototypes.shape)}")
    if x.stride(1) != 1 or not prototypes.is_contiguous():
        raise ValueError("x needs unit column stride and prototypes must be contiguous")
    b, d = x.shape
    p = prototypes.shape[0]
    check_shape(b, p, d, x.stride(0))
    splits, depth = plan_splits(b, p, d)
    dev = x.device
    dist = torch.empty((b, p), device=dev, dtype=torch.float32)
    bmu = torch.empty((b,), device=dev, dtype=torch.int64)
    workspace = torch.empty((workspace_floats(b, p, splits),), device=dev, dtype=torch.float32)
    loss = torch.empty((), device=dev, dtype=torch.float32)
    temperature = temperature_tensor(temperature, dev)
    lib = _lib()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = lib.som_fused_forward(
            x.data_ptr(), x.stride(0), prototypes.data_ptr(),
            dist.data_ptr(), bmu.data_ptr(), workspace.data_ptr(), loss.data_ptr(),
            b, p, d, splits, depth // CHUNK,
            cols, int(topology == "hexa"), int(distance_fcn == "cosine"),
            temperature.data_ptr(),
            int(wide_copies(d, x.stride(0), x.data_ptr(), prototypes.data_ptr())), stream,
        )
    if rc != 0:
        raise RuntimeError(f"som_fused_forward launch failed with CUDA error {rc}")
    LAUNCHES += 1
    return loss, bmu, dist


def som_fused_forward(x, prototypes, temperature, cols, topology, distance_fcn):
    """The op's forward without autograd: the kernel for CUDA tensors, the
    plain version for CPU tensors."""
    if x.is_cuda:
        return _kernel_forward(x, prototypes, temperature, cols, topology, distance_fcn)
    if x.device.type != "cpu":
        raise ValueError(f"unsupported device {x.device}")
    return fused_som_reference(x, prototypes, temperature, cols, topology, distance_fcn)


# ---------------------------------------------------------------------------
# autograd op
# ---------------------------------------------------------------------------


class FusedSOM(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, prototypes, temperature, cols, topology, distance_fcn):
        temperature = temperature_tensor(temperature, x.device)
        loss, bmu, dist = som_fused_forward(
            x, prototypes, temperature, cols, topology, distance_fcn
        )
        # the temperature is saved as a tensor, never as a host float: a
        # captured step's backward reads the value its forward read
        ctx.save_for_backward(x, prototypes, bmu, dist, temperature)
        ctx.cfg = (cols, topology, distance_fcn)
        ctx.mark_non_differentiable(bmu, dist)
        return loss, bmu, dist

    @staticmethod
    def backward(ctx, g, _g_bmu, _g_dist):
        x, prototypes, bmu, dist, temperature = ctx.saved_tensors
        cols, topology, distance_fcn = ctx.cfg
        b, p = dist.shape
        w = torch.exp(-grid_d2_rows(bmu, p, cols, topology) / two_t_squared_tensor(temperature))
        c = (g / (b * p)) * w  # [B, P]
        if distance_fcn == "euclidean":
            e = torch.where(dist > 0.0, c / dist, torch.zeros_like(c))
            dx = x * torch.sum(e, dim=1, keepdim=True) - e @ prototypes
            dp = prototypes * torch.sum(e, dim=0)[:, None] - e.T @ x
        else:
            xnorm = torch.linalg.norm(x, dim=1, keepdim=True).clamp_min(1e-12)
            pnorm = torch.linalg.norm(prototypes, dim=1, keepdim=True).clamp_min(1e-12)
            xn = x / xnorm
            pn = prototypes / pnorm
            cs = c * (1.0 - dist)  # c * cosine similarity
            dx = -(c @ pn - torch.sum(cs, dim=1, keepdim=True) * xn) / xnorm
            dp = -(c.T @ xn - torch.sum(cs, dim=0)[:, None] * pn) / pnorm
        return dx, dp, None, None, None, None


def make_fused_som(map_size: Tuple[int, int], topology: str, distance_fcn: str):
    """Returns ``fused(x, prototypes, temperature) -> (loss, bmu, distances)``.

    ``temperature`` is a float32 tensor on x's device (the train step
    computes it there from its step tensor; the kernel reads it through a
    pointer) or a host float (the eval step). ``bmu`` and ``distances`` are
    non-differentiable outputs; the gradient reaches ``x`` and
    ``prototypes`` through ``loss``."""
    if distance_fcn not in ("euclidean", "cosine"):
        raise ValueError(
            f"fused SOM kernel supports euclidean/cosine, got {distance_fcn} "
            "(manhattan stays on the plain path)"
        )
    if topology not in ("square", "hexa"):
        raise ValueError(f"Unsupported topology: {topology}")
    cols = int(map_size[1])

    def fused(x, prototypes, temperature):
        return FusedSOM.apply(x, prototypes, temperature, cols, topology, distance_fcn)

    return fused


def make_fused_som_sharded(map_size: Tuple[int, int], topology: str, distance_fcn: str):
    """The data-parallel fused SOM, the counterpart of the JAX
    ``make_fused_som_sharded`` (``vitsom_tpu/ops/som_pallas.py:292``): the
    same kernel on each rank's rows of the batch; the loss is the mean of
    the ranks' means (the JAX ``pmean``; equal spans, so the global mean),
    differentiated as the rank's own mean, whose gradients the trainer
    averages over the ranks (the prototypes' are then the global batch's,
    the JAX package's summed shard contributions); ``bmu`` and
    ``distances`` stay the rank's. Without a process group it is
    ``make_fused_som``."""
    fused = make_fused_som(map_size, topology, distance_fcn)

    def sharded(x, prototypes, temperature):
        loss, bmu, dist = fused(x, prototypes, temperature)
        return dist_lib.mean_value(loss), bmu, dist

    return sharded
