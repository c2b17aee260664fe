"""UMAP for the latent-projection figure, in torch.

Counterpart of ``vitsom_tpu/eval/umap_jax.py`` (the reference projects
latents with umap-learn, cosine metric, n_neighbors 15; neither package
uses umap-learn), step for step:

- exact cosine kNN by row blocks: one ``torch.matmul`` of the normalised
  rows against all points and a ``torch.topk`` a block, on the data's
  device; self removed as the JAX function removes it;
- the smooth-kNN calibration (rho / sigma by bisection), the fuzzy
  simplicial union and the (a, b) curve fit: numpy, copies of the JAX
  package's host code, bitwise equal to it;
- the layout by the batched attract / repel SGD: each epoch every edge
  fires with probability w / max w (a Bernoulli mask) and moves its head
  and tail, then each fired head is pushed from 5 random points. The
  draws come from an explicit ``torch.Generator`` on the device (or from
  ``draws``, a callable epoch -> (fire, negatives), so a test can feed the
  JAX package's own draws). The moves are summed with ``index_add_``
  under ``torch.use_deterministic_algorithms``, which on the card sorts
  the indices and adds each target's terms in edge order instead of with
  atomics: the same seed gives the same layout bitwise. The SGD is
  chaotic: a last-bit difference in one epoch grows to whole units within
  twenty, so its float32 arithmetic is XLA's on the CPU, step for step
  (glibc's ``powf``, which XLA calls for a power; the multiply-adds XLA
  fuses, rounded once; the reciprocal it multiplies by in place of
  dividing by the epoch count). Given the same draws the layout equals
  the JAX package's bitwise;
- ``umap_embed``: kNN, the fuzzy set, umap-learn's pruning of edges that
  would fire less than once, the PCA initialisation (``pca``: the centred
  data's principal axes with sklearn's sign rule, scaled to 10, plus
  1e-4 noise from ``np.random.default_rng(seed)``) and the layout.

The JAX package's draws come from ``jax.random``; a torch generator cannot
reproduce them, so with the same seed the two layouts differ as two UMAP
runs do, and agree given the same draws.
"""

from __future__ import annotations

import math
from typing import Callable, Optional, Tuple

import numpy as np
import torch

SMOOTH_K_TOLERANCE = 1e-5
MIN_K_DIST_SCALE = 1e-3
NEG_SAMPLES = 5
CLIP = 4.0


# ---------------------------------------------------------------------------
# kNN (cosine) by row blocks
# ---------------------------------------------------------------------------


def _knn_cosine(x, k: int, block: int = 2048) -> Tuple[np.ndarray, np.ndarray]:
    """Exact k nearest neighbours under cosine distance, self excluded:
    (indices [N, k] int64, distances [N, k] float32), numpy. A tensor ``x``
    is used on its device, a numpy one on the CPU."""
    xt = torch.as_tensor(x).float().reshape(len(x), -1)
    n = xt.shape[0]
    xn = xt / torch.linalg.norm(xt, dim=1, keepdim=True).clamp_min(1e-12)
    idxs, dists = [], []
    for s in range(0, n, block):
        d = 1.0 - xn[s:s + block] @ xn.T
        neg, idx = torch.topk(-d, k + 1, dim=1)  # includes self at d=0
        idxs.append(idx)
        dists.append(-neg)
    idx = torch.cat(idxs).cpu().numpy()
    dist = torch.cat(dists).cpu().numpy()
    # drop exactly one self entry a row (the first), else the last column
    self_mask = idx == np.arange(n)[:, None]
    keep = np.ones_like(idx, bool)
    first_self = np.where(self_mask.any(axis=1), self_mask.argmax(axis=1), idx.shape[1] - 1)
    keep[np.arange(n), first_self] = False
    return idx[keep].reshape(n, k), np.maximum(dist[keep].reshape(n, k), 0.0)


# ---------------------------------------------------------------------------
# fuzzy simplicial set (numpy, as the JAX package)
# ---------------------------------------------------------------------------


def _smooth_knn_dist(dists: np.ndarray, k: float, n_iter: int = 64):
    """Per-point (rho, sigma): rho = nearest nonzero distance; sigma solves
    sum_j exp(-max(d_ij - rho, 0)/sigma) = log2(k) by bisection."""
    n = dists.shape[0]
    target = math.log2(k)
    rho = np.zeros(n)
    nonzero = dists > 0.0
    has = nonzero.any(axis=1)
    first_nz = np.where(has, np.argmax(nonzero, axis=1), 0)
    rho[has] = dists[has, first_nz[has]]

    lo = np.zeros(n)
    hi = np.full(n, np.inf)
    mid = np.ones(n)
    for _ in range(n_iter):
        psum = np.exp(-np.maximum(dists - rho[:, None], 0.0) / mid[:, None]).sum(1)
        done = np.abs(psum - target) < SMOOTH_K_TOLERANCE
        if done.all():
            break
        too_big = psum > target
        hi = np.where(too_big & ~done, mid, hi)
        lo = np.where(~too_big & ~done, mid, lo)
        mid = np.where(
            too_big, (lo + mid) / 2.0, np.where(np.isinf(hi), mid * 2.0, (mid + hi) / 2.0)
        )
    mean_d = dists.mean()
    mean_row = dists.mean(axis=1)
    floor = np.where(rho > 0.0, MIN_K_DIST_SCALE * mean_row, MIN_K_DIST_SCALE * mean_d)
    return rho, np.maximum(mid, floor)


def fuzzy_simplicial_set(idx: np.ndarray, dists: np.ndarray):
    """Edge list (heads, tails, weights) of the symmetrised fuzzy union
    P + P^T - P o P^T, one edge a pair."""
    n, k = idx.shape
    rho, sigma = _smooth_knn_dist(dists, float(k))
    w = np.exp(-np.maximum(dists - rho[:, None], 0.0) / sigma[:, None])
    rows = np.repeat(np.arange(n, dtype=np.int64), k)
    cols = idx.reshape(-1).astype(np.int64)
    vals = w.reshape(-1)

    # q = P[j, i] for each edge (i, j, p), by binary search over the sorted
    # flat keys (the kNN gives each (i, j) once)
    fwd = rows * n + cols
    rev = cols * n + rows
    sort_idx = np.argsort(fwd)
    sorted_fwd = fwd[sort_idx]
    pos = np.searchsorted(sorted_fwd, rev)
    pos_c = np.minimum(pos, len(sorted_fwd) - 1)
    found = sorted_fwd[pos_c] == rev
    q = np.where(found, vals[sort_idx[pos_c]], 0.0)
    u = vals + q - vals * q
    # the (i < j) copy where both directions exist, else the one that does
    keep = ((rows < cols) | ~found) & (u > 0.0)
    return (
        rows[keep].astype(np.int32),
        cols[keep].astype(np.int32),
        u[keep].astype(np.float32),
    )


def find_ab_params(spread: float = 1.0, min_dist: float = 0.1) -> Tuple[float, float]:
    """Least-squares fit of 1/(1 + a x^{2b}) to the target membership curve
    by a Gauss-Newton loop."""
    xv = np.linspace(0, spread * 3, 300)
    yv = np.where(xv < min_dist, 1.0, np.exp(-(xv - min_dist) / spread))
    a, b = 1.0, 1.0
    for _ in range(200):
        f = 1.0 / (1.0 + a * xv ** (2 * b))
        r = yv - f
        x2b = xv ** (2 * b)
        denom = (1.0 + a * x2b) ** 2
        da = -x2b / denom
        with np.errstate(divide="ignore", invalid="ignore"):
            db = np.where(xv > 0, -2.0 * a * x2b * np.log(xv) / denom, 0.0)
        J = np.stack([da, db], 1)
        g = J.T @ r
        H = J.T @ J + 1e-6 * np.eye(2)
        step = np.linalg.solve(H, g)
        a = float(max(a + step[0], 1e-3))
        b = float(max(b + step[1], 1e-3))
        if np.abs(step).max() < 1e-9:
            break
    return a, b


# ---------------------------------------------------------------------------
# layout
# ---------------------------------------------------------------------------


# glibc's powf (the power XLA emits on the CPU): log2 by a 16-entry table of
# (1/c, log2 c) and a degree-5 polynomial, exp2 by a 32-entry table of
# 2^(i/32) and a degree-3 polynomial, all in float64, rounded once to float32
_LOG2_TAB = [float.fromhex(v) for v in (
    "0x1.661ec79f8f3bep+0", "-0x1.efec65b963019p-2", "0x1.571ed4aaf883dp+0",
    "-0x1.b0b6832d4fca4p-2", "0x1.49539f0f010b0p+0", "-0x1.7418b0a1fb77bp-2",
    "0x1.3c995b0b80385p+0", "-0x1.39de91a6dcf7bp-2", "0x1.30d190c8864a5p+0",
    "-0x1.01d9bf3f2b631p-2", "0x1.25e227b0b8ea0p+0", "-0x1.97c1d1b3b7af0p-3",
    "0x1.1bb4a4a1a343fp+0", "-0x1.2f9e393af3c9fp-3", "0x1.12358f08ae5bap+0",
    "-0x1.960cbbf788d5cp-4", "0x1.0953f419900a7p+0", "-0x1.a6f9db6475fcep-5",
    "0x1.0000000000000p+0", "0x0.0p+0", "0x1.e608cfd9a47acp-1", "0x1.338ca9f24f53dp-4",
    "0x1.ca4b31f026aa0p-1", "0x1.476a9543891bap-3", "0x1.b2036576afce6p-1",
    "0x1.e840b4ac4e4d2p-3", "0x1.9c2d163a1aa2dp-1", "0x1.40645f0c6651cp-2",
    "0x1.886e6037841edp-1", "0x1.88e9c2c1b9ff8p-2", "0x1.767dcf5534862p-1",
    "0x1.ce0a44eb17bccp-2")]
_LOG2_POLY = [float.fromhex(v) for v in (
    "0x1.27616c9496e0bp-2", "-0x1.71969a075c67ap-2", "0x1.ec70a6ca7baddp-2",
    "-0x1.7154748bef6c8p-1", "0x1.71547652ab82bp+0")]
_EXP2_POLY = [float.fromhex(v) for v in (
    "0x1.c6af84b912394p-5", "0x1.ebfce50fac4f3p-3", "0x1.62e42ff0c52d6p-1")]
_EXP2_SHIFT = float.fromhex("0x1.8p+47")  # 0x1.8p+52 / 32
# the bits of 2^(i/32) less i << 47
_EXP2_TAB = [int(np.float64(2.0 ** (i / 32)).view(np.int64)) - (i << 47) for i in range(32)]


def _powf_tables(device):
    """(1/c, log2 c, the 2^(i/32) bits) on ``device``, for ``_pow``."""
    log2 = torch.tensor(_LOG2_TAB, dtype=torch.float64, device=device).reshape(16, 2)
    return log2[:, 0], log2[:, 1], torch.tensor(_EXP2_TAB, dtype=torch.int64, device=device)


def _pow(x: torch.Tensor, exponent: float, tables=None) -> torch.Tensor:
    """float32 ``x ** float32(exponent)`` for x > 0 (0 where x <= 0, which
    the callers mask), as glibc's ``powf`` computes it: XLA's power on the
    CPU, bitwise, on the card too. A correctly rounded power and torch's
    float32 ``pow`` differ from it in the last bit at ~0.07 % and ~2 % of
    inputs, and the layout is chaotic enough to grow such bits to units
    within 20 epochs."""
    invc_t, logc_t, exp2_t = tables if tables is not None else _powf_tables(x.device)
    xs = torch.where(x > 0.0, x, torch.ones_like(x))
    sub = xs < float.fromhex("0x1p-126")  # subnormal: scaled by 2^23 first
    ix = torch.where(sub, xs * float.fromhex("0x1p23"), xs).view(torch.int32).to(torch.int64)
    ix = torch.where(sub, ix - (23 << 23), ix)
    tmp = (ix - 0x3F330000) & 0xFFFFFFFF
    i = (tmp >> 19) % 16
    top = tmp & 0xFF800000
    iz = (ix - top) & 0xFFFFFFFF
    z = torch.where(iz >= 2**31, iz - 2**32, iz).to(torch.int32).view(torch.float32).double()
    k = torch.where(top >= 2**31, top - 2**32, top) >> 23
    r = z * invc_t[i] - 1.0
    y0 = logc_t[i] + k.double()
    a = _LOG2_POLY
    r2 = r * r
    y = a[0] * r + a[1]
    p = a[2] * r + a[3]
    r4 = r2 * r2
    q = a[4] * r + y0
    q = p * r2 + q
    logx = y * r4 + q
    ylogx = float(np.float32(exponent)) * logx
    kd = ylogx + _EXP2_SHIFT
    ki = kd.view(torch.int64)
    kd = kd - _EXP2_SHIFT
    r = ylogx - kd
    t = exp2_t[ki % 32] + (ki << 47)
    s = t.view(torch.float64)
    c = _EXP2_POLY
    out = ((c[0] * r + c[1]) * (r * r) + (c[2] * r + 1.0)) * s
    # |y log2 x| >= 150 leaves float32's range: 0 or inf, as powf gives
    out = torch.where(ylogx >= 128.0, torch.full_like(out, math.inf), out)
    out = torch.where(ylogx <= -150.0, torch.zeros_like(out), out)
    return torch.where(x > 0.0, out, torch.zeros_like(out)).float()


def _one_plus(a: float, p: torch.Tensor) -> torch.Tensor:
    """``a * p + 1`` rounded once, as the fused multiply-add XLA emits on
    the CPU (a float32 ``a * p`` and a float32 product agree exactly in
    float64)."""
    return (float(np.float32(a)) * p.double() + 1.0).float()


def _fused_sq_norms(d: torch.Tensor) -> torch.Tensor:
    """x1 * x1 + x0 * x0 of the last axis (2), rounded once: the fused
    multiply-add of XLA's scalar code on the CPU."""
    return (d[..., 1].double() * d[..., 1].double() + (d[..., 0] * d[..., 0]).double()).float()


def _edge_sq_norms(diff: torch.Tensor) -> torch.Tensor:
    """[E] squared lengths of the edges' [E, 2] differences as XLA sums them
    on the CPU: its 8-lane vector loop adds the two squares, its scalar loop
    over the last E mod 8 edges fuses them."""
    d2 = diff[:, 0] * diff[:, 0] + diff[:, 1] * diff[:, 1]
    tail = diff.shape[0] - diff.shape[0] % 8
    return torch.cat([d2[:tail], _fused_sq_norms(diff[tail:])])


def _attract_grad(d2: torch.Tensor, a: float, b: float, tables) -> torch.Tensor:
    num = float(np.float32(-2.0 * a * b)) * _pow(d2, b - 1.0, tables)
    g = num / _one_plus(a, _pow(d2, b, tables))  # a true division: tensor by tensor
    return torch.where(d2 > 0.0, g, torch.zeros_like(g))


def _repel_grad(d2: torch.Tensor, a: float, b: float, tables) -> torch.Tensor:
    num = torch.full_like(d2, float(np.float32(2.0 * b)))
    g = num / ((0.001 + d2) * _one_plus(a, _pow(d2, b, tables)))
    return torch.where(d2 > 0.0, g, torch.zeros_like(g))


def _add_rows(emb: torch.Tensor, index: torch.Tensor, rows: torch.Tensor) -> None:
    """``emb.index_add_(0, index, rows)`` with deterministic algorithms on
    (module docstring); the caller's setting is restored."""
    was = torch.are_deterministic_algorithms_enabled()
    torch.use_deterministic_algorithms(True)
    try:
        emb.index_add_(0, index, rows)
    finally:
        torch.use_deterministic_algorithms(was)


def _optimize_layout(
    emb0,
    heads: np.ndarray,
    tails: np.ndarray,
    weights: np.ndarray,
    n_epochs: int,
    a: float,
    b: float,
    seed: int,
    neg_samples: int = NEG_SAMPLES,
    initial_alpha: float = 1.0,
    device=None,
    draws: Optional[Callable[[int], Tuple[torch.Tensor, torch.Tensor]]] = None,
) -> np.ndarray:
    """The batched attract / repel SGD of ``umap_jax._optimize_layout`` on
    ``device`` (default the CPU): [N, 2] float32 numpy. ``draws(epoch)``
    replaces the generator's (fire [E] bool, negatives [E, neg_samples]
    int64)."""
    dev = torch.device(device) if device is not None else torch.device("cpu")
    emb = torch.as_tensor(np.asarray(emb0, np.float32)).to(dev).clone()
    n = emb.shape[0]
    heads_t = torch.as_tensor(np.asarray(heads, np.int64)).to(dev)
    tails_t = torch.as_tensor(np.asarray(tails, np.int64)).to(dev)
    # umap-learn schedules an edge every max_w / w epochs; firing with
    # p = w / max_w has the same expected rate
    p_fire = torch.as_tensor(np.asarray(weights / weights.max(), np.float32)).to(dev)
    e = heads_t.shape[0]
    generator = torch.Generator(device=dev).manual_seed(seed)
    f = np.float32
    recip = float(f(1.0 / n_epochs))
    tables = _powf_tables(dev)

    for i in range(n_epochs):
        if draws is not None:
            fire, negs = draws(i)
            fire, negs = fire.to(dev), negs.to(dev)
        else:
            fire = torch.rand(e, generator=generator, device=dev) < p_fire
            negs = torch.randint(0, n, (e, neg_samples), generator=generator, device=dev)
        # alpha * (1 - i / n_epochs) as XLA computes it on the CPU: the
        # division by a constant a product with its float32 reciprocal,
        # fused with the subtraction
        alpha = float(f(initial_alpha) * f(1.0 - i * recip))

        diff = emb[heads_t] - emb[tails_t]
        d2 = _edge_sq_norms(diff)
        g = _attract_grad(d2, a, b, tables)
        upd = torch.clamp(g[:, None] * diff, -CLIP, CLIP)
        upd = torch.where(fire[:, None], upd, torch.zeros_like(upd)) * alpha
        _add_rows(emb, heads_t, upd)
        _add_rows(emb, tails_t, -upd)

        diffn = emb[heads_t][:, None, :] - emb[negs]  # [E, S, 2]
        d2n = _fused_sq_norms(diffn)
        gn = _repel_grad(d2n, a, b, tables)
        updn = torch.clamp(gn[..., None] * diffn, -CLIP, CLIP)
        updn = torch.where(fire[:, None, None], updn, torch.zeros_like(updn))
        # the sum over the negatives of updn * alpha, in order, each term
        # fused into the running sum (a multiply-add), as XLA computes it
        total = updn[:, 0] * alpha
        for j in range(1, neg_samples):
            total = (updn[:, j].double() * alpha + total.double()).float()
        _add_rows(emb, heads_t, total)
    return emb.cpu().numpy()


# ---------------------------------------------------------------------------
# PCA (the initialisation, and the projection's PCA branch)
# ---------------------------------------------------------------------------


def pca(x, n_components: int = 2) -> torch.Tensor:
    """[N, n_components] projection of the centred ``x`` on its principal
    axes, float32 on ``x``'s device (the CPU for a numpy ``x``).

    The axes come from the centred data's singular vectors: the
    eigenvectors of X^T X (or of X X^T, whichever is smaller), in float64,
    with sklearn's sign rule (``svd_flip`` on the rows of Vt: the entry of
    largest magnitude of each axis made positive), so the result does not
    depend on the solver's signs: ``sklearn.decomposition.PCA``'s
    ``fit_transform`` up to its float error, with no scikit-learn."""
    xt = torch.as_tensor(x).reshape(len(x), -1).double()
    xc = xt - xt.mean(dim=0)
    n, d = xc.shape
    if d <= n:
        vals, vecs = torch.linalg.eigh(xc.T @ xc)
        v = vecs[:, torch.argsort(vals, descending=True)[:n_components]]  # [D, c]
    else:
        vals, vecs = torch.linalg.eigh(xc @ xc.T)
        order = torch.argsort(vals, descending=True)[:n_components]
        u = vecs[:, order]
        v = xc.T @ u
        v = v / torch.linalg.norm(v, dim=0, keepdim=True).clamp_min(1e-300)
    rows = torch.argmax(v.abs(), dim=0)
    signs = torch.sign(v[rows, torch.arange(v.shape[1], device=v.device)])
    v = v * torch.where(signs == 0, torch.ones_like(signs), signs)
    return (xc @ v).float()


# ---------------------------------------------------------------------------
# public API
# ---------------------------------------------------------------------------


def layout_inputs(
    x,
    n_neighbors: int = 15,
    n_components: int = 2,
    min_dist: float = 0.1,
    spread: float = 1.0,
    n_epochs: Optional[int] = None,
    seed: int = 0,
) -> dict:
    """Everything ``umap_embed`` hands ``_optimize_layout``: the kNN graph's
    fuzzy edges (pruned), the PCA initialisation and the (a, b) curve, as
    keyword arguments."""
    xt = torch.as_tensor(x).float().reshape(len(x), -1)
    n = xt.shape[0]
    if n <= n_neighbors + 1:
        raise ValueError(f"need more than n_neighbors+1={n_neighbors + 1} points")
    idx, dists = _knn_cosine(xt, n_neighbors)
    heads, tails, weights = fuzzy_simplicial_set(idx, dists)

    if n_epochs is None:
        n_epochs = 500 if n < 10_000 else 200
    # umap-learn prunes edges that would fire less than once
    keep = weights >= weights.max() / float(n_epochs)
    heads, tails, weights = heads[keep], tails[keep], weights[keep]

    emb0 = pca(xt, n_components).cpu().numpy().astype(np.float64)
    emb0 = emb0 / max(np.abs(emb0).max(), 1e-12) * 10.0
    emb0 = emb0 + np.random.default_rng(seed).normal(0, 1e-4, emb0.shape)

    a, b = find_ab_params(spread, min_dist)
    return dict(emb0=emb0.astype(np.float32), heads=heads, tails=tails, weights=weights,
                n_epochs=int(n_epochs), a=a, b=b, seed=seed, device=xt.device)


def umap_embed(x, n_neighbors: int = 15, n_components: int = 2, min_dist: float = 0.1,
               spread: float = 1.0, n_epochs: Optional[int] = None,
               seed: int = 0) -> np.ndarray:
    """UMAP embedding under the cosine metric, the reference's
    ``umap.UMAP(n_neighbors=15, metric='cosine')`` in its defaults: [N, 2]
    float32 numpy. The kNN, the PCA and the layout run on ``x``'s device (a
    tensor; the CPU for a numpy ``x``)."""
    return _optimize_layout(**layout_inputs(x, n_neighbors, n_components, min_dist, spread,
                                            n_epochs, seed))
