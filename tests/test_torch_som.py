"""The port's SOM layer and fused SOM op against the JAX package, on the CPU.

The same numpy inputs go through ``vitsom_tpu`` (the fused op through its
Pallas kernel in interpret mode, as ``test_pallas_kernels.py`` runs it) and
through ``vitsom_tpu_torch`` with CPU tensors, where the op's wrapper runs
its plain PyTorch version. The CUDA kernel itself is held against that
plain version on the card by ``chip_smoke.py``.
"""

import glob
import os
import re
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vitsom_tpu.config import SOMConfig
from vitsom_tpu.ops import som_pallas
from vitsom_tpu.som import layer as jsom
from vitsom_tpu_torch.config import load_config
from vitsom_tpu_torch.ops import som_fused
from vitsom_tpu_torch.som import layer as tsom

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


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
        (8, (4, 4), 2048),  # deep latent, small map, as the emb-192 configs
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


def _shipped_som_shapes():
    """(B, N, E, P) of every shipped ViT-SOM config's SOM, and bench.py's
    24x24 map on the flagship latent: the latent is N patch tokens of emb E."""
    shapes = set()
    for path in sorted(glob.glob(os.path.join(ROOT, "configs", "vit_som", "*.yaml"))):
        cfg = load_config(path)
        n = (cfg.data.input_size // cfg.vit.patch_size) ** 2
        assert cfg.som_latent_dim() == n * cfg.vit.emb_dim
        shapes.add((cfg.batch_size, n, cfg.vit.emb_dim, cfg.som.map_size[0] * cfg.som.map_size[1]))
    assert len(shapes) == 7
    return sorted(shapes) + [(128, 196, 16, 576)]


@pytest.mark.parametrize("b,n,e,p", _shipped_som_shapes() + [(13, 250, 4, 132), (1, 1, 4, 1)])
def test_plan_splits_covers_depth_in_chunks(b, n, e, p):
    d = n * e
    chunk = som_fused.CHUNK
    splits, depth = som_fused.plan_splits(b, p, d)
    chunks = -(-d // chunk)
    assert splits >= 1 and depth % chunk == 0 and depth >= chunk
    # splits [s depth, (s + 1) depth) cover every chunk once, in order, and
    # the last one is not empty
    assert (splits - 1) * depth < chunks * chunk <= splits * depth
    tiles = -(-b // som_fused.TILE_B) * -(-p // som_fused.TILE_P)
    ctas = som_fused.grid_ctas(b, p, d)
    assert ctas == tiles * splits
    # one wave of one CTA an SM, filled to within evening-out, unless the
    # depth has no chunk left to give a further split
    assert ctas <= som_fused.WAVE_CTAS or splits == 1
    assert ctas >= 0.9 * som_fused.WAVE_CTAS or splits == chunks


def test_plan_splits_at_the_main_path():
    # vit_som_mnist.yaml: B 128, 196 tokens x emb 16, 40x40 map -> 26 tiles,
    # S 5 of 20 chunks (18 in the last), 130 CTAs
    assert som_fused.plan_splits(128, 1600, 3136) == (5, 640)
    assert som_fused.grid_ctas(128, 1600, 3136) == 130


@pytest.mark.parametrize("b,n,e,p", _shipped_som_shapes())
def test_check_shape_accepts_shipped_layouts(b, n, e, p):
    # x is tokens[:, 1:].reshape(B, -1): rows (1 + N) E floats apart,
    # starting E floats into the token buffer
    base = 1 << 20
    som_fused.check_shape(b, p, n * e, (1 + n) * e)
    assert som_fused.wide_copies(n * e, (1 + n) * e, base + 4 * e, base)


def test_check_shape_names_what_it_refuses():
    som_fused.check_shape(8, 16, 64, 64)
    # rows off 16-byte copies are taken, by 4-byte ones
    for d, ldx, x_ptr, p_ptr in ((64, 66, 0, 0), (62, 64, 0, 0), (64, 64, 8, 0), (64, 64, 0, 4)):
        som_fused.check_shape(8, 16, d, ldx)
        assert not som_fused.wide_copies(d, ldx, x_ptr, p_ptr)
    assert som_fused.wide_copies(64, 64, 0, 0)
    with pytest.raises(ValueError, match="ldx"):
        som_fused.check_shape(8, 16, 64, 60)
    with pytest.raises(ValueError, match="empty"):
        som_fused.check_shape(0, 16, 64, 64)


def test_tiles_match_the_kernel_source():
    # plan_splits and the workspace use the kernel's tile sizes; the
    # wrapper also refuses a built library whose sizes differ
    src = (Path(som_fused.__file__).parent / "csrc" / "som_fused.cu").read_text()
    tiles = {k: int(v) for k, v in re.findall(r"constexpr int (kB[MNK]) = (\d+);", src)}
    assert tiles == {"kBM": som_fused.TILE_B, "kBN": som_fused.TILE_P, "kBK": som_fused.CHUNK}


def test_fused_som_cpu_path_does_not_launch():
    before = som_fused.LAUNCHES
    rng = np.random.default_rng(5)
    fused = som_fused.make_fused_som((2, 3), "square", "cosine")
    fused(_t(rng.normal(size=(4, 8)).astype(np.float32)),
          _t(rng.normal(size=(6, 8)).astype(np.float32)), 1.0)
    assert som_fused.LAUNCHES == before
