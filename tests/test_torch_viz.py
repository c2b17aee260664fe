"""The port's figures' numbers, SOM quality metrics and
``interpolate_pos_embed`` against the JAX package, on the CPU.

Held:

- ``cell_label_map`` (majority and last-write-wins) and
  ``prototype_grid_image``: bitwise equal to ``vitsom_tpu/eval/viz.py``'s;
- ``decoded_prototypes``: all P prototypes of a small ViT-SOM (4x5 map,
  patch 7, emb 16, decoder emb 8), weights from the Flax model carried
  across by ``convert.py``, against the JAX model's ``decode_prototypes``
  at atol/rtol 1e-5 (the model tests' tolerance);
- the drawing functions write their PNGs (matplotlib, ``Agg``), and
  ``latent_projection`` falls back to PCA only below the neighbour graph's
  size;
- ``quantization_error`` and ``topographic_error`` on random [B, P]
  distances, numpy and tensor inputs, square and hexa maps: equal to the
  JAX functions (QE at 1e-6 relative: the tensor's mean is a float64 sum,
  numpy's a float32 one);
- ``interpolate_pos_embed`` at 14 -> 16, 14 -> 7 (antialiased) and 8 -> 8
  against ``jax.image.resize(..., "bicubic")`` at atol 1e-6, and the resize
  weights bitwise equal to ``compute_weight_mat``'s.
"""

import functools
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vitsom_tpu.config import Config, DataConfig, SOMConfig, ViTConfig
from vitsom_tpu.eval import metrics as jmetrics
from vitsom_tpu.eval import viz as jviz
from vitsom_tpu.models.vit_som import ViTSOM as JViTSOM
from vitsom_tpu.ops import pos_embed as jpos
from vitsom_tpu_torch import config as tconfig
from vitsom_tpu_torch import convert
from vitsom_tpu_torch.eval import metrics as tmetrics
from vitsom_tpu_torch.eval import viz as tviz
from vitsom_tpu_torch.models.vit_som import ViTSOM as TViTSOM
from vitsom_tpu_torch.ops import pos_embed as tpos
from vitsom_tpu_torch.ops import resize as tresize


@pytest.fixture(autouse=True, scope="module")
def _two_torch_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("mode", ["majority", "last"])
def test_cell_label_map_matches_jax(mode):
    rng = np.random.default_rng(0)
    bmu = rng.integers(0, 30, size=500)
    labels = rng.integers(0, 7, size=500)
    want = jviz.cell_label_map(bmu, labels, 36, mode=mode)
    got = tviz.cell_label_map(bmu, labels, 36, mode=mode)
    assert got.dtype == want.dtype
    np.testing.assert_array_equal(got, want)
    assert (got[30:] == -1).all()


@pytest.mark.parametrize("shape,map_size", [((20, 7, 7, 1), (4, 5)), ((6, 5, 4, 3), (2, 3))])
def test_prototype_grid_image_matches_jax(shape, map_size):
    decoded = np.random.default_rng(1).normal(size=shape).astype(np.float32)
    want = jviz.prototype_grid_image(decoded, map_size)
    got = tviz.prototype_grid_image(decoded, map_size)
    assert got.dtype == want.dtype
    np.testing.assert_array_equal(got, want)


@functools.lru_cache(maxsize=None)
def _vit_som():
    jcfg = Config(
        model_arch="vit_som", total_epochs=2, batch_size=4, gamma=0.005,
        som=SOMConfig(map_size=(4, 5), t_max=5.0, t_min=0.1),
        vit=ViTConfig(patch_size=7, emb_dim=16, depth=1, heads=2, dec_emb_dim=8, dec_depth=1),
        data=DataConfig(dataset="mnist", num_classes=0, num_channels=1, input_size=28),
    ).validate()
    jmodel = JViTSOM(jcfg)
    params = jax.device_get(
        jax.jit(jmodel.init)(jax.random.key(3), jnp.zeros((2, 28, 28, 1)))["params"])
    tcfg = tconfig.config_from_dict(jcfg.to_dict())
    tmodel = TViTSOM(tcfg)
    tmodel.load_state_dict(convert.flax_to_state_dict(params), strict=True)
    return jmodel, params, tcfg, tmodel


def test_decoded_prototypes_match_jax():
    jmodel, params, tcfg, tmodel = _vit_som()
    want = np.asarray(jax.jit(lambda p: jmodel.apply(
        {"params": p}, p["prototypes"], method="decode_prototypes"))(params))
    got = tviz.decoded_prototypes(tmodel, tcfg)
    assert not got.requires_grad and tuple(got.shape) == (20, 28, 28, 1)
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5, rtol=1e-5)


def test_latent_representation_matches_jax():
    jmodel, params, _, tmodel = _vit_som()
    x = np.random.default_rng(2).uniform(size=(3, 28, 28, 1)).astype(np.float32)
    want = np.asarray(jmodel.apply({"params": params}, jnp.asarray(x),
                                   method="get_latent_representation"))
    with torch.no_grad():
        got = tmodel.get_latent_representation(torch.from_numpy(x)).numpy()
    assert got.shape == want.shape == (3, 16 * 16)
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=1e-5)


def test_figures_are_written(tmp_path):
    _, _, tcfg, tmodel = _vit_som()
    rng = np.random.default_rng(4)
    paths = [
        tviz.visualize_decoded_prototypes(tmodel, tcfg, str(tmp_path / "protos.png"), epoch=3),
        tviz.visualize_label_heatmap(rng.integers(0, 20, 100), rng.integers(0, 4, 100), (4, 5),
                                     str(tmp_path / "heat.png")),
        tviz.visualize_latent_projection(rng.normal(size=(60, 8)).astype(np.float32),
                                         rng.integers(0, 3, 60), str(tmp_path / "lat.png")),
        tviz.plot_params_vs_metric(["a", "b"], [1.0, 5.0], [0.5, None], [None, 0.9],
                                   str(tmp_path / "params.png")),
    ]
    for p in paths:
        assert os.path.getsize(p) > 1000, p


def test_latent_projection_methods():
    x = np.random.default_rng(5).normal(size=(40, 6)).astype(np.float32)
    emb, used = tviz.latent_projection(x)
    assert used == "umap" and emb.shape == (40, 2)
    emb, used = tviz.latent_projection(x[:10])  # too few for 15 neighbours
    assert used == "pca" and emb.shape == (10, 2)
    with pytest.raises(ValueError, match="n_neighbors"):
        tviz.latent_projection(x[:10], method="umap")
    with pytest.raises(ValueError, match="unknown"):
        tviz.latent_projection(x, method="tsne")


@pytest.mark.parametrize("topology", ["square", "hexa"])
@pytest.mark.parametrize("tensor", [False, True])
def test_som_quality_metrics_match_jax(topology, tensor):
    rng = np.random.default_rng(6)
    d = rng.uniform(size=(300, 35)).astype(np.float32)
    arg = torch.from_numpy(d) if tensor else d
    want_qe = jmetrics.quantization_error(d)
    assert tmetrics.quantization_error(arg) == pytest.approx(want_qe, rel=1e-6)
    want_te = jmetrics.topographic_error(d, (5, 7), topology)
    assert tmetrics.topographic_error(arg, (5, 7), topology) == want_te
    assert 0.0 < want_te < 1.0


@pytest.mark.parametrize("old,new", [(14, 16), (14, 7), (8, 8)])
def test_interpolate_pos_embed_matches_jax(old, new):
    table = jpos.get_2d_sincos_pos_embed(32, old, cls_token=True)
    want = jpos.interpolate_pos_embed(table, new)
    got = tpos.interpolate_pos_embed(table, new)
    assert got.dtype == np.float32 and got.shape == want.shape == (1 + new * new, 32)
    np.testing.assert_allclose(got, want, atol=1e-6, rtol=0)
    np.testing.assert_array_equal(got[0], table[0])


@pytest.mark.parametrize("n_in,n_out", [(14, 16), (14, 7), (7, 8), (8, 7)])
@pytest.mark.parametrize("kernel,jkernel", [("cubic", "_fill_keys_cubic_kernel"),
                                            ("triangle", "_fill_triangle_kernel")])
def test_resize_weights_bitwise(n_in, n_out, kernel, jkernel):
    from jax._src.image import scale as jscale

    want = np.asarray(jscale.compute_weight_mat(
        n_in, n_out, n_out / n_in, 0.0,  # Python floats, as jax.image.resize passes them
        getattr(jscale, jkernel), True)).T
    np.testing.assert_array_equal(tresize.resize_weights(n_in, n_out, kernel), want)
