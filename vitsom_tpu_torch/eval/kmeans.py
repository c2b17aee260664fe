"""k-means in torch: sklearn's ``KMeans(n_clusters=k, random_state=0,
n_init=10)`` written for the card.

The JAX package clusters latents with ``sklearn.cluster.KMeans``
(``vitsom_tpu/eval/evaluate.py:391-471``); the card's machine has no
scikit-learn, and the port imports none. This is the same algorithm,
step for step, on the data's device:

- the data are centred on their mean first (sklearn fits the centred data
  and adds the mean back to the centres);
- greedy k-means++ seeding: the first centre drawn uniformly, then for
  each further centre ``2 + int(ln k)`` candidates drawn with probability
  proportional to the squared distance to the nearest centre so far, the
  one that lowers the potential most kept;
- Lloyd iterations: labels by the nearest centre (||c||^2 - 2 x.c, the
  first index on a tie), each centre the mean of its points, an empty
  cluster moved onto the point farthest from its centre; stop when the
  labels repeat (strict convergence) or the summed squared centre shift is
  at most ``tol`` times the mean per-feature variance, after at most
  ``max_iter`` iterations, then one more assignment if not strict;
- the best of ``n_init`` seedings by inertia (the first on a tie).

Random draws come from an explicit ``torch.Generator`` on the data's
device, seeded ``random_state``: the same seed gives the same result
bitwise on one card, but not sklearn's draws (its ``RandomState`` stream
cannot be reproduced), so the results match sklearn's by partition and
inertia, not bit for bit. Every reduction is deterministic: the cluster
sums are a one-hot product, not a scatter with atomics, and the seeding's
cumulative sums run on the host in float64.
"""

from __future__ import annotations

import math
from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F


def _sq_distances(rows: torch.Tensor, x: torch.Tensor, x2: torch.Tensor) -> torch.Tensor:
    """[R, N] squared euclidean distances of ``rows`` to every point of
    ``x`` (``x2`` its squared norms), clamped at 0."""
    r2 = (rows * rows).sum(dim=1, keepdim=True)
    return (r2 - 2.0 * (rows @ x.T) + x2[None, :]).clamp_min_(0.0)


def kmeans_plusplus(x: torch.Tensor, k: int, generator: torch.Generator,
                    n_local_trials: Optional[int] = None) -> torch.Tensor:
    """[k] int64 indices of the greedy k-means++ seeds (sklearn's
    ``_kmeans_plusplus`` with unit sample weights). The candidates are
    searched in the host's float64 cumulative sums of the distances."""
    n = x.shape[0]
    if n_local_trials is None:
        n_local_trials = 2 + int(math.log(k))
    x2 = (x * x).sum(dim=1)
    first = torch.randint(n, (1,), generator=generator, device=x.device)
    indices = [first]
    closest = _sq_distances(x[first], x, x2)[0]
    pot = closest.double().sum()
    for _ in range(1, k):
        rand = torch.rand(n_local_trials, generator=generator, device=x.device,
                          dtype=torch.float64) * pot
        cum = np.cumsum(closest.double().cpu().numpy())
        cand = np.minimum(np.searchsorted(cum, rand.cpu().numpy()), n - 1)
        cand = torch.from_numpy(cand).to(x.device)
        d = torch.minimum(closest[None, :], _sq_distances(x[cand], x, x2))
        pots = d.double().sum(dim=1)
        best = torch.argmin(pots)
        pot, closest = pots[best], d[best]
        indices.append(cand[best].reshape(1))
    return torch.cat(indices)


def assign(x: torch.Tensor, centers: torch.Tensor) -> torch.Tensor:
    """[N] int64 label of each point's nearest centre (first on a tie)."""
    c2 = (centers * centers).sum(dim=1)
    return torch.argmin(c2[None, :] - 2.0 * (x @ centers.T), dim=1)


def inertia(x: torch.Tensor, centers: torch.Tensor, labels: torch.Tensor) -> float:
    """Sum of squared distances to the assigned centres, summed in float64."""
    diff = x - centers[labels]
    return float((diff * diff).sum(dim=1).double().sum())


def _update(x: torch.Tensor, centers: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """The new centres: each cluster's mean (a one-hot product: no
    atomics); an empty cluster takes the point farthest from its centre,
    which leaves its old cluster, as sklearn relocates."""
    k = centers.shape[0]
    onehot = F.one_hot(labels, k).to(x.dtype)
    sums = onehot.T @ x
    counts = onehot.sum(dim=0)
    empty = torch.nonzero(counts == 0).flatten().tolist()
    if empty:
        diff = x - centers[labels]
        far_d = (diff * diff).sum(dim=1)
        if float(far_d.max()) > 0.0:
            far = torch.topk(far_d, len(empty)).indices.tolist()
            for new, idx in zip(empty, far):
                old = int(labels[idx])
                sums[old] -= x[idx]
                sums[new] = x[idx]
                counts[new] = 1.0
                counts[old] -= 1.0
    return sums / counts.clamp_min(1.0)[:, None]


def lloyd(x: torch.Tensor, centers: torch.Tensor, max_iter: int, tol: float):
    """Lloyd iterations from ``centers`` (sklearn's ``_kmeans_single_lloyd``):
    returns (centres, labels, inertia, iterations)."""
    labels_old = None
    strict = False
    i = 0
    for i in range(max_iter):
        labels = assign(x, centers)
        new = _update(x, centers, labels)
        shift = ((new - centers) ** 2).sum()
        centers = new
        if labels_old is not None and torch.equal(labels, labels_old):
            strict = True
            break
        if float(shift) <= tol:
            break
        labels_old = labels
    if not strict:
        labels = assign(x, centers)
    return centers, labels, inertia(x, centers, labels), i + 1


class KMeans:
    """``KMeans(n_clusters, random_state=0, n_init=10)`` as sklearn calls it
    (module docstring). ``fit`` sets ``cluster_centers_``, ``labels_``
    (int64 tensors on the data's device), ``inertia_``, ``n_iter_`` and
    ``init_centers_`` (the winning seeding's centres, in the data's
    coordinates)."""

    def __init__(self, n_clusters: int, random_state: int = 0, n_init: int = 10,
                 max_iter: int = 300, tol: float = 1e-4):
        self.n_clusters = n_clusters
        self.random_state = random_state
        self.n_init = n_init
        self.max_iter = max_iter
        self.tol = tol

    def fit(self, x) -> "KMeans":
        x = torch.as_tensor(x)
        if not x.is_floating_point():
            x = x.float()
        x = x.reshape(x.shape[0], -1)
        if x.shape[0] < self.n_clusters:
            raise ValueError(f"{x.shape[0]} samples for {self.n_clusters} clusters")
        tol = float(x.double().var(dim=0, unbiased=False).mean()) * self.tol
        mean = x.mean(dim=0)
        xc = x - mean
        generator = torch.Generator(device=x.device).manual_seed(self.random_state)
        best = None
        for _ in range(self.n_init):
            seeds = xc[kmeans_plusplus(xc, self.n_clusters, generator)]
            centers, labels, score, n_iter = lloyd(xc, seeds, self.max_iter, tol)
            if best is None or score < best[2]:
                best = (centers, labels, score, n_iter, seeds)
        centers, labels, score, n_iter, seeds = best
        self.cluster_centers_ = centers + mean
        self.labels_ = labels
        self.inertia_ = score
        self.n_iter_ = n_iter
        self.init_centers_ = seeds + mean
        return self

    def fit_predict(self, x) -> torch.Tensor:
        return self.fit(x).labels_
