"""The port's UMAP and PCA (``vitsom_tpu_torch/eval/umap.py``) against the
JAX package's ``vitsom_tpu/eval/umap_jax.py`` and sklearn, on the CPU.

Small inputs: three or four gaussian blobs of 20-40 dimensions, 120-240
points, drawn with numpy from a seed. Held:

- ``_knn_cosine``: each row's neighbour set equal to JAX's, distances at
  atol 1e-6 (two float32 products of normalised rows);
- ``_smooth_knn_dist``, ``fuzzy_simplicial_set``, ``find_ab_params``:
  numpy copies, bitwise equal on the same inputs;
- ``_optimize_layout`` fed JAX's own draws (re-derived from
  ``jax.random.key(seed)`` by ``umap_jax.py:214-231``'s split / uniform /
  randint sequence): equal to JAX's layout at atol 1e-4 after 20 epochs at
  n 200 (the coordinates are ~10). The SGD is chaotic: one last-bit
  difference grows to units within twenty epochs, so this holds only because
  the port repeats XLA's CPU arithmetic (glibc's ``powf``, the fused
  multiply-adds); it is bitwise in practice. ``_pow`` equals the C
  library's ``powf`` bitwise over 150000 float32 inputs and four
  exponents;
- ``umap_embed`` separates blobs as ``tests/test_umap.py:71-84`` asks, and
  gives the same layout twice from one seed;
- ``pca`` equal to ``sklearn.decomposition.PCA(2).fit_transform`` up to
  the sign of each component at atol 1e-4 (float32 data; the port solves
  in float64), and with sklearn's sign rule the signs agree too.
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vitsom_tpu.eval import umap_jax
from vitsom_tpu_torch.eval import umap as tumap


@pytest.fixture(autouse=True, scope="module")
def _two_torch_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _blobs(n_per=60, d=20, k=3, seed=0, sep=6.0):
    rng = np.random.default_rng(seed)
    centers = rng.normal(size=(k, d)) * sep
    x = np.concatenate(
        [centers[i] + rng.normal(size=(n_per, d)) for i in range(k)]
    ).astype(np.float32)
    return x, np.repeat(np.arange(k), n_per)


@pytest.mark.parametrize("k", [10, 15])
def test_knn_matches_jax(k):
    x, _ = _blobs(n_per=80, d=32, k=3, seed=3)
    jidx, jd = umap_jax._knn_cosine(x, k)
    tidx, td = tumap._knn_cosine(x, k, block=64)  # several row blocks
    assert tidx.shape == jidx.shape == (len(x), k)
    for r in range(len(x)):
        assert set(tidx[r]) == set(jidx[r]), r
    np.testing.assert_allclose(np.sort(td, 1), np.sort(jd, 1), atol=1e-6, rtol=0)
    assert not (tidx == np.arange(len(x))[:, None]).any()


def test_host_steps_bitwise():
    x, _ = _blobs(n_per=60, d=20, k=3, seed=1)
    idx, dist = umap_jax._knn_cosine(x, 15)
    for a, b in zip(umap_jax._smooth_knn_dist(dist, 15.0), tumap._smooth_knn_dist(dist, 15.0)):
        np.testing.assert_array_equal(a, b)
    for a, b in zip(umap_jax.fuzzy_simplicial_set(idx, dist),
                    tumap.fuzzy_simplicial_set(idx, dist)):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)
    for spread, min_dist in ((1.0, 0.1), (1.5, 0.25)):
        assert umap_jax.find_ab_params(spread, min_dist) == tumap.find_ab_params(spread, min_dist)


def _jax_draws(seed, p_fire, n, n_epochs, neg=5):
    """JAX's layout draws, epoch by epoch (``umap_jax.py:214-231``)."""
    key = jax.random.key(seed)
    out = []
    p = jnp.asarray(p_fire)
    for _ in range(n_epochs):
        key, k1, k2 = jax.random.split(key, 3)
        fire = jax.random.uniform(k1, p.shape) < p
        negs = jax.random.randint(k2, (p.shape[0], neg), 0, n)
        out.append((torch.from_numpy(np.array(fire)),
                    torch.from_numpy(np.array(negs).astype(np.int64))))
    return out


@pytest.mark.parametrize("data_seed", [2, 3])
def test_layout_matches_jax_given_its_draws(data_seed):
    x, _ = _blobs(n_per=50, d=20, k=4, seed=data_seed)  # n 200
    n_epochs, seed = 20, 7
    idx, dist = umap_jax._knn_cosine(x, 10)
    heads, tails, weights = umap_jax.fuzzy_simplicial_set(idx, dist)
    rng = np.random.default_rng(0)
    emb0 = rng.uniform(-10, 10, size=(len(x), 2)).astype(np.float32)
    a, b = umap_jax.find_ab_params(1.0, 0.1)
    want = umap_jax._optimize_layout(emb0, heads, tails, weights, n_epochs, a, b, seed)
    draws = _jax_draws(seed, weights / weights.max(), len(x), n_epochs)
    got = tumap._optimize_layout(emb0, heads, tails, weights, n_epochs, a, b, seed,
                                 draws=lambda i: draws[i])
    assert got.dtype == np.float32 and got.shape == want.shape
    assert np.abs(got - emb0).max() > 1.0  # the layout moved
    np.testing.assert_allclose(got, want, atol=1e-4, rtol=0)


@pytest.mark.parametrize("exponent", [0.8950608781603668 - 1.0, 0.8950608781603668, 2.5, -1.3])
def test_pow_is_the_c_librarys_powf(exponent):
    """``_pow`` against libm's ``powf`` (the power XLA calls on the CPU),
    from normal to subnormal inputs and past float32's range."""
    import ctypes
    import ctypes.util

    libm = ctypes.CDLL(ctypes.util.find_library("m"))
    libm.powf.restype = ctypes.c_float
    libm.powf.argtypes = [ctypes.c_float, ctypes.c_float]
    rng = np.random.default_rng(0)
    x = np.concatenate([rng.uniform(0, 400, 100000) ** rng.uniform(0.5, 1.5, 100000),
                        10.0 ** rng.uniform(-44, 30, 50000)]).astype(np.float32)
    x = x[x > 0]
    e = float(np.float32(exponent))
    want = np.array([libm.powf(float(v), e) for v in x], np.float32)
    got = tumap._pow(torch.from_numpy(x), exponent).numpy()
    np.testing.assert_array_equal(got, want)


def test_layout_deterministic_per_seed():
    x, _ = _blobs(n_per=40, d=20, k=3, seed=4)
    idx, dist = tumap._knn_cosine(x, 10)
    heads, tails, weights = tumap.fuzzy_simplicial_set(idx, dist)
    emb0 = np.random.default_rng(1).uniform(-10, 10, size=(len(x), 2)).astype(np.float32)
    a, b = tumap.find_ab_params()
    runs = [tumap._optimize_layout(emb0, heads, tails, weights, 30, a, b, s) for s in (3, 3, 4)]
    np.testing.assert_array_equal(runs[0], runs[1])
    assert not np.array_equal(runs[0], runs[2])


def test_embedding_separates_blobs():
    """``tests/test_umap.py:71-84``'s check on the port's layout."""
    x, y = _blobs(n_per=60, k=3, seed=1)
    emb = tumap.umap_embed(x, n_neighbors=10, n_epochs=150, seed=0)
    assert emb.shape == (len(x), 2) and np.isfinite(emb).all()
    cents = np.stack([emb[y == i].mean(0) for i in range(3)])
    spread = np.mean([emb[y == i].std() for i in range(3)])
    dmin = min(np.linalg.norm(cents[i] - cents[j]) for i in range(3) for j in range(i + 1, 3))
    assert dmin > 2.0 * spread, (dmin, spread)
    np.testing.assert_array_equal(emb, tumap.umap_embed(x, n_neighbors=10, n_epochs=150, seed=0))


def test_umap_embed_needs_enough_points():
    with pytest.raises(ValueError, match="n_neighbors"):
        tumap.umap_embed(np.zeros((10, 4), np.float32), n_neighbors=15)


@pytest.mark.parametrize("shape", [(240, 20), (40, 60)])
def test_pca_matches_sklearn(shape):
    """Both branches of ``pca``: D <= N (the covariance) and D > N (the
    Gram matrix)."""
    from sklearn.decomposition import PCA

    n, d = shape
    rng = np.random.default_rng(5)
    x = (rng.normal(size=(n, d)) * np.linspace(3.0, 0.5, d)).astype(np.float32)
    want = PCA(n_components=2, random_state=0).fit_transform(x)
    got = tumap.pca(x, 2).numpy()
    assert got.dtype == np.float32 and got.shape == (n, 2)
    for c in range(2):
        sign = math.copysign(1.0, float(got[:, c] @ want[:, c]))
        np.testing.assert_allclose(sign * got[:, c], want[:, c], atol=1e-4, rtol=0)
    np.testing.assert_allclose(got, want, atol=1e-4, rtol=0)
