"""The port's SOM layer and fused SOM op against the JAX package, on the CPU.

The same numpy inputs go through ``vitsom_tpu`` (the fused op through its
Pallas kernel in interpret mode, as ``test_pallas_kernels.py`` runs it) and
through ``vitsom_tpu_torch`` with CPU tensors, where the op's wrapper runs
its plain PyTorch version. The CUDA kernel itself is held against that
plain version on the card by ``chip_smoke.py``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vitsom_tpu.config import SOMConfig
from vitsom_tpu.ops import som_pallas
from vitsom_tpu.som import layer as jsom
from vitsom_tpu_torch.ops import som_fused
from vitsom_tpu_torch.som import layer as tsom


def _t(a):
    return torch.from_numpy(np.array(a))


@pytest.mark.parametrize("topology", ["square", "hexa"])
@pytest.mark.parametrize("map_size", [(8, 8), (5, 9)])
def test_grid_tables_match(topology, map_size):
    np.testing.assert_array_equal(
        tsom.grid_positions(map_size, topology), jsom.grid_positions(map_size, topology)
    )
    np.testing.assert_array_equal(
        tsom.grid_sq_distances(map_size, topology), jsom.grid_sq_distances(map_size, topology)
    )


@pytest.mark.parametrize("distance_fcn", ["manhattan", "euclidean", "cosine"])
def test_layer_functions_match(distance_fcn):
    rng = np.random.default_rng(0)
    b, p, d = 9, 20, 24
    x = rng.normal(size=(b, d)).astype(np.float32)
    protos = (rng.normal(size=(p, d)) * 0.5).astype(np.float32)
    table = jsom.grid_sq_distances((4, 5), "square")
    temp = 2.3

    jd = np.asarray(jsom.compute_distances(jnp.asarray(x), jnp.asarray(protos), distance_fcn))
    td = tsom.compute_distances(_t(x), _t(protos), distance_fcn).numpy()
    np.testing.assert_allclose(td, jd, atol=1e-6, rtol=1e-6)

    jb = np.asarray(jsom.bmu(jnp.asarray(jd)))
    tb = tsom.bmu(_t(jd)).numpy()
    np.testing.assert_array_equal(tb, jb)

    jw = np.asarray(jsom.neighborhood_weights(jnp.asarray(jb), jnp.asarray(table), jnp.float32(temp)))
    tw = tsom.neighborhood_weights(_t(tb), _t(table), temp).numpy()
    np.testing.assert_allclose(tw, jw, atol=1e-6, rtol=1e-6)

    jl = float(jsom.som_loss(jnp.asarray(jw), jnp.asarray(jd)))
    tl = float(tsom.som_loss(_t(jw), _t(jd)))
    np.testing.assert_allclose(tl, jl, atol=1e-6, rtol=1e-6)


def test_bmu_tie_goes_to_first_index():
    d = torch.tensor([[0.5, 0.1, 0.1, 0.3], [0.2, 0.2, 0.2, 0.2]])
    assert tsom.bmu(d).tolist() == [1, 0]


def test_temperature_schedule_matches():
    total = jsom.total_iterations(4915, 128, 500)
    assert tsom.total_iterations(4915, 128, 500) == total
    for it in (0, 1, 37, 1000, 19000):
        j = float(jsom.temperature_schedule(jnp.asarray(it), total, 20.0, 0.001))
        t = tsom.temperature_schedule(it, total, 20.0, 0.001)
        np.testing.assert_allclose(t, j, rtol=1e-6)


@pytest.mark.parametrize("distance_fcn", ["cosine", "euclidean"])
def test_init_prototypes_distribution(distance_fcn):
    cfg = SOMConfig(map_size=(6, 7), distance_fcn=distance_fcn)
    p = tsom.init_prototypes(cfg, 50, torch.Generator().manual_seed(0))
    assert p.shape == (42, 50) and p.dtype == torch.float32
    assert float(p.min()) >= 0.0
    if distance_fcn == "cosine":
        np.testing.assert_allclose(torch.linalg.norm(p, dim=1).numpy(), 1.0, rtol=1e-6)
    else:
        assert float(p.max()) < 1.0 and abs(float(p.mean()) - 0.5) < 0.05


# ---------------------------------------------------------------------------
# fused SOM op (plain version on CPU tensors) vs the Pallas kernel
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("distance_fcn", ["cosine", "euclidean"])
@pytest.mark.parametrize("topology", ["square", "hexa"])
@pytest.mark.parametrize(
    "b,map_size,d",
    [
        (16, (8, 8), 40),
        (8, (12, 11), 130),  # P=132, not a multiple of any tile
        (13, (24, 24), 65),  # odd batch, P=576
    ],
)
def test_fused_som_matches_pallas(distance_fcn, topology, b, map_size, d):
    p = map_size[0] * map_size[1]
    rng = np.random.default_rng(2)
    x = rng.normal(size=(b, d)).astype(np.float32)
    protos = (rng.normal(size=(p, d)) * 0.5).astype(np.float32)
    temp = 3.7

    jfused = som_pallas.make_fused_som(map_size, topology, distance_fcn)
    jl, jb, jd = jax.jit(jfused)(jnp.asarray(x), jnp.asarray(protos), jnp.float32(temp))
    tfused = som_fused.make_fused_som(map_size, topology, distance_fcn)
    tl, tb, td = tfused(_t(x), _t(protos), temp)

    assert tb.dtype == torch.int64
    np.testing.assert_array_equal(tb.numpy(), np.asarray(jb))
    np.testing.assert_allclose(td.numpy(), np.asarray(jd), atol=1e-5, rtol=1e-5)
    np.testing.assert_allclose(float(tl), float(jl), atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("distance_fcn", ["cosine", "euclidean"])
def test_fused_som_grads_match_pallas(distance_fcn):
    map_size, topology, b, d = (6, 7), "square", 12, 33
    p = map_size[0] * map_size[1]
    rng = np.random.default_rng(3)
    x = rng.normal(size=(b, d)).astype(np.float32)
    protos = rng.normal(size=(p, d)).astype(np.float32)
    temp = 1.9

    jfused = som_pallas.make_fused_som(map_size, topology, distance_fcn)
    gx_j, gp_j = jax.grad(
        lambda a, c: jfused(a, c, jnp.float32(temp))[0], argnums=(0, 1)
    )(jnp.asarray(x), jnp.asarray(protos))

    # the op's closed-form backward
    tfused = som_fused.make_fused_som(map_size, topology, distance_fcn)
    xt, pt = _t(x).requires_grad_(), _t(protos).requires_grad_()
    loss, bmu, dist = tfused(xt, pt, temp)
    assert not dist.requires_grad and not bmu.requires_grad
    loss.backward()
    np.testing.assert_allclose(xt.grad.numpy(), np.asarray(gx_j), atol=1e-6, rtol=1e-4)
    np.testing.assert_allclose(pt.grad.numpy(), np.asarray(gp_j), atol=1e-6, rtol=1e-4)

    # autograd through the plain version gives the same gradients
    xr, pr = _t(x).requires_grad_(), _t(protos).requires_grad_()
    som_fused.fused_som_reference(xr, pr, temp, map_size[1], topology, distance_fcn)[0].backward()
    np.testing.assert_allclose(xt.grad.numpy(), xr.grad.numpy(), atol=1e-6, rtol=1e-4)
    np.testing.assert_allclose(pt.grad.numpy(), pr.grad.numpy(), atol=1e-6, rtol=1e-4)


def test_fused_som_takes_strided_latent():
    """The model hands over ``tokens[:, 1:].reshape(B, -1)``, a view whose
    rows are not contiguous; the op must read it as it is."""
    rng = np.random.default_rng(4)
    tokens = _t(rng.normal(size=(5, 10, 4)).astype(np.float32))
    z = tokens[:, 1:].reshape(5, -1)
    assert not z.is_contiguous()
    protos = _t(rng.normal(size=(12, 36)).astype(np.float32))
    fused = som_fused.make_fused_som((3, 4), "hexa", "cosine")
    a = fused(z, protos, 1.3)
    b = fused(z.contiguous(), protos, 1.3)
    for u, v in zip(a, b):
        np.testing.assert_array_equal(u.numpy(), v.numpy())


def test_grid_d2_rows_matches_jax():
    for topology in ("square", "hexa"):
        idx = np.asarray([0, 7, 44, 13], np.int32)
        j = som_pallas.grid_d2_rows(jnp.asarray(idx), 45, 9, topology)
        t = som_fused.grid_d2_rows(_t(idx.astype(np.int64)), 45, 9, topology)
        np.testing.assert_allclose(t.numpy(), np.asarray(j), atol=1e-6, rtol=1e-6)


def test_fused_som_rejects_manhattan():
    with pytest.raises(ValueError):
        som_fused.make_fused_som((8, 8), "square", "manhattan")


def test_fused_som_cpu_path_does_not_launch():
    before = som_fused.LAUNCHES
    rng = np.random.default_rng(5)
    fused = som_fused.make_fused_som((2, 3), "square", "cosine")
    fused(_t(rng.normal(size=(4, 8)).astype(np.float32)),
          _t(rng.normal(size=(6, 8)).astype(np.float32)), 1.0)
    assert som_fused.LAUNCHES == before
