"""Fused SOM step: a hand-written CUDA forward with a closed-form backward.

Replaces the TPU kernel ``vitsom_tpu/ops/som_pallas.py:_som_kernel``
(launched by ``_forward_impl``, wrapped by ``make_fused_som``). For latents
``x [B, D]`` and ``prototypes [P, D]`` the op returns

- ``loss``: mean over B*P of ``w * dist`` with Gaussian neighbourhood
  weights ``w = exp(-d2 / (2 T^2))``, ``d2`` the squared grid distance to
  the BMU, computed analytically from square/hexa grid coordinates;
- ``bmu``: [B] int64 argmin of each row, the first index on a tie;
- ``dist``: [B, P] cosine or euclidean distances.

On a CUDA tensor the forward runs ``csrc/som_fused.cu`` (three launches:
a tiled distance SGEMM with fused norms, a per-row argmin/weights pass and a
fixed-order loss reduction; the source's header gives its design and its
bound on the H100: operations, 1.28 GFLOP of float32 FMA at the 40x40 map).
On a CPU tensor it runs ``fused_som_reference``, the plain PyTorch version
of the same function. A CUDA tensor never falls back to the plain version:
the kernel launches or the call raises.

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
from vitsom_tpu_torch.som.layer import two_t_squared

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
            ctypes.c_void_p, ctypes.c_void_p,  # row_partial, loss
            ctypes.c_int, ctypes.c_int, ctypes.c_int,  # B, P, D
            ctypes.c_int, ctypes.c_int, ctypes.c_int,  # cols, hexa, cosine
            ctypes.c_float,  # temperature
            ctypes.c_void_p,  # stream
        ]
        fn.restype = ctypes.c_int
        _LIB = lib
    return _LIB


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


def fused_som_reference(
    x: torch.Tensor,
    prototypes: torch.Tensor,
    temperature: float,
    cols: int,
    topology: str,
    distance_fcn: str,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of the kernel's forward: (loss, bmu, dist).

    Differentiable through autograd (the weights are built from the
    integer BMU, so no gradient flows through them)."""
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
    w = torch.exp(-grid_d2_rows(bmu, p, cols, topology) / two_t_squared(temperature))
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
    if b < 1 or p < 1 or d < 1:
        raise ValueError(f"empty input: B={b}, P={p}, D={d}")
    dev = x.device
    dist = torch.empty((b, p), device=dev, dtype=torch.float32)
    bmu = torch.empty((b,), device=dev, dtype=torch.int64)
    row_partial = torch.empty((b,), device=dev, dtype=torch.float32)
    loss = torch.empty((), device=dev, dtype=torch.float32)
    lib = _lib()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = lib.som_fused_forward(
            x.data_ptr(), x.stride(0), prototypes.data_ptr(),
            dist.data_ptr(), bmu.data_ptr(), row_partial.data_ptr(), loss.data_ptr(),
            b, p, d, cols, int(topology == "hexa"), int(distance_fcn == "cosine"),
            float(temperature), stream,
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
        loss, bmu, dist = som_fused_forward(
            x, prototypes, temperature, cols, topology, distance_fcn
        )
        ctx.save_for_backward(x, prototypes, bmu, dist)
        ctx.cfg = (float(temperature), cols, topology, distance_fcn)
        ctx.mark_non_differentiable(bmu, dist)
        return loss, bmu, dist

    @staticmethod
    def backward(ctx, g, _g_bmu, _g_dist):
        x, prototypes, bmu, dist = ctx.saved_tensors
        temperature, cols, topology, distance_fcn = ctx.cfg
        b, p = dist.shape
        w = torch.exp(-grid_d2_rows(bmu, p, cols, topology) / two_t_squared(temperature))
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

    ``temperature`` is a host float (the trainer computes it from its step
    counter). ``bmu`` and ``distances`` are non-differentiable outputs; the
    gradient reaches ``x`` and ``prototypes`` through ``loss``."""
    if distance_fcn not in ("euclidean", "cosine"):
        raise ValueError(
            f"fused SOM kernel supports euclidean/cosine, got {distance_fcn} "
            "(manhattan stays on the plain path)"
        )
    if topology not in ("square", "hexa"):
        raise ValueError(f"Unsupported topology: {topology}")
    cols = int(map_size[1])

    def fused(x, prototypes, temperature):
        return FusedSOM.apply(x, prototypes, float(temperature), cols, topology, distance_fcn)

    return fused
