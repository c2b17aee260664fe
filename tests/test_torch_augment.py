"""The port's augmentation and eval transform against the JAX package's.

The deterministic halves (the ops, the warps, the matrices, and each random
op's "apply" half at parameters re-derived from the JAX key it was given)
are held against ``vitsom_tpu/data/device_augment.py`` at the bounds
``tests/test_device_augment.py`` holds that module to PIL with (exact, or
within one grey level), and the warps at 1e-4 before rounding (float32
sums in another order). The samplers draw from torch's streams, not JAX's,
so they are held to ``test_device_augment.py``'s distribution bounds; the
eval transform to PIL (the JAX package's host transform) at the bound of
``test_crop_resize_matches_pil_upscale``.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image, ImageEnhance, ImageOps

from vitsom_tpu.config import load_config as jload_config
from vitsom_tpu.data import augment as jaug
from vitsom_tpu.data import device_augment as jda
from vitsom_tpu_torch import config as tconfig
from vitsom_tpu_torch.data import augment as taug
from vitsom_tpu_torch.data import device_augment as tda

CIFAR = "configs/vit_som/vit_som_cifar-10.yaml"


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The port's ops here are many small CPU ops, which torch's thread
    pool slows down when several test workers share the cores; the module
    runs them on one thread and restores the count after."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _img(seed=0, s=32, c=3):
    return np.random.default_rng(seed).integers(0, 256, (s, s, c), np.uint8)


def _smooth_img(s=32):
    yy, xx = np.mgrid[0:s, 0:s]
    return np.stack([(yy * 4 + xx * 2) % 256, 128 + 100 * np.sin(xx / 5.0),
                     (255 - xx * 5) % 256], -1).astype(np.uint8)


def _batch(seed, b=8, s=32):
    return np.random.default_rng(seed).integers(0, 256, (b, s, s, 3), np.uint8).astype(np.float32)


def _t(a):
    return torch.from_numpy(np.asarray(a, np.float32).copy())


# ---------------------------------------------------------------------------
# color ops: against PIL at test_device_augment.py's bounds, and JAX's
# ---------------------------------------------------------------------------


def _run_color(name, x, mag=0.5, signed=False, timm=True):
    """One color op through the port's table-select, on one image."""
    names = tda.TIMM_OPS if timm else tda.TV_OPS
    k = names.index(name)
    out = tda.apply_color_table(_t(x)[None], names, torch.tensor([k]), torch.tensor([mag]),
                                torch.tensor([signed]))
    return out[0].numpy()


def _jax_color(name, x, mag=0.5, signed=False, timm=True):
    names = jda._TIMM_OPS if timm else jda._TV_OPS
    return np.asarray(jda._apply_color_table(
        jnp.asarray(x, jnp.float32), names, jnp.asarray(names.index(name)),
        jnp.asarray(mag, jnp.float32), jnp.asarray(signed), timm))


def _pil(fn, x):
    return np.asarray(fn(Image.fromarray(x))).astype(np.float32)


@pytest.mark.parametrize("name,mag,ref,bound", [
    ("Invert", 0.5, lambda img: ImageOps.invert(img), 0.0),
    ("PosterizeIncreasing", 0.0, lambda img: ImageOps.posterize(img, 4), 0.0),
    ("PosterizeIncreasing", 0.3, lambda img: ImageOps.posterize(img, 3), 0.0),
    ("PosterizeIncreasing", 0.99, lambda img: ImageOps.posterize(img, 1), 0.0),
    ("SolarizeIncreasing", 0.25, lambda img: ImageOps.solarize(img, 256 - 64), 0.0),
    ("SolarizeIncreasing", 0.9, lambda img: ImageOps.solarize(img, 256 - int(0.9 * 256)), 0.0),
    ("SolarizeAdd", 0.5, lambda img: img.point(
        [min(255, i + 55) if i < 128 else i for i in range(256)] * 3), 0.0),
    ("AutoContrast", 0.5, lambda img: ImageOps.autocontrast(img), 1.0),
    ("BrightnessIncreasing", 0.9, lambda img: ImageEnhance.Brightness(img).enhance(1.81), 1.0),
    ("ColorIncreasing", 0.9, lambda img: ImageEnhance.Color(img).enhance(1.81), 1.0),
    ("ContrastIncreasing", 0.9, lambda img: ImageEnhance.Contrast(img).enhance(1.81), 1.0),
    ("SharpnessIncreasing", 0.5, lambda img: ImageEnhance.Sharpness(img).enhance(1.45), 1.0),
])
def test_color_ops_match_pil_and_jax(name, mag, ref, bound):
    x = _img(len(name) * 7 + int(mag * 100))
    got = _run_color(name, x, mag=mag)
    assert np.abs(got - _pil(ref, x)).max() <= bound
    assert np.abs(got - _jax_color(name, x, mag=mag)).max() <= bound


@pytest.mark.parametrize("name,enhancer", [
    ("Brightness", ImageEnhance.Brightness), ("Color", ImageEnhance.Color),
    ("Contrast", ImageEnhance.Contrast), ("Sharpness", ImageEnhance.Sharpness),
])
def test_signed_enhance_ops_match(name, enhancer):
    """The torchvision table's enhance ops with the sign flipped: factor
    1 - 0.9 * mag."""
    x = _img(7)
    got = _run_color(name, x, mag=0.9, signed=True, timm=False)
    assert np.abs(got - _pil(lambda img: enhancer(img).enhance(1.0 - 0.81), x)).max() <= 1.0
    assert np.abs(got - _jax_color(name, x, mag=0.9, signed=True, timm=False)).max() <= 1.0


@pytest.mark.parametrize("mag", [0.0, 0.4, 0.8])
def test_torchvision_posterize_solarize_exact(mag):
    x = _img(12)
    for name in ("Posterize", "Solarize", "Identity"):
        np.testing.assert_array_equal(_run_color(name, x, mag=mag, timm=False),
                                      _jax_color(name, x, mag=mag, timm=False), err_msg=name)


@pytest.mark.parametrize("flat", [False, True])
def test_equalize_exact(flat):
    x = np.full((32, 32, 3), 77, np.uint8) if flat else _img(6)
    got = tda.op_equalize(_t(x)[None])[0].numpy()
    np.testing.assert_array_equal(got, _pil(ImageOps.equalize, x))
    np.testing.assert_array_equal(got, np.asarray(jda.op_equalize(jnp.asarray(x, jnp.float32))))


# ---------------------------------------------------------------------------
# warps and matrices
# ---------------------------------------------------------------------------


def _mats():
    """A batch of general affines: identity, translate, rotate, shears, and
    a crop (axis-aligned)."""
    rows = [np.asarray(jda._identity_mats(1))[0],
            np.asarray(jda._mat_translate_x(jnp.asarray([5.0])))[0],
            np.asarray(jda._mat_rotate(jnp.asarray([17.0]), 32.0))[0],
            np.asarray(jda._mat_shear_x(jnp.asarray([-0.3])))[0],
            np.asarray(jda._mat_shear_y(jnp.asarray([0.2])))[0],
            np.asarray(jda._crop_matrix(jnp.asarray([4]), jnp.asarray([6]),
                                        jnp.asarray([20.0]), jnp.asarray([18.0]), 32))[0]]
    return np.stack(rows).astype(np.float32)


@pytest.mark.parametrize("method", ["bicubic", "bilinear"])
def test_warp_matches_jax(method):
    x = _batch(1, b=6)
    mats = _mats()
    fill = np.asarray([[10.0, 20.0, 30.0]] * 6, np.float32)
    j = np.asarray(jda._warp(jnp.asarray(x), jnp.asarray(mats), 32, method, jnp.asarray(fill)))
    t = tda.warp(_t(x), _t(mats), 32, method, _t(fill)).numpy()
    np.testing.assert_allclose(t, j, atol=1e-4, rtol=0)


def test_warp_axis_aligned_matches_jax_and_warp():
    x = _batch(2, b=4)
    sx = np.asarray([1.0, 0.625, 0.4, 1.1], np.float32)
    off = np.asarray([0.0, 4.0, 9.5, -2.0], np.float32)
    mats = np.zeros((4, 2, 3), np.float32)
    mats[:, 0, 0], mats[:, 1, 1], mats[:, 0, 2], mats[:, 1, 2] = sx, sx * 0.9, off, off + 1
    fill = np.asarray([[1.0, 2.0, 3.0]] * 4, np.float32)
    j = np.asarray(jda._warp_axis_aligned(jnp.asarray(x), jnp.asarray(mats), 32, "bicubic",
                                          jnp.asarray(fill)))
    t = tda.warp_axis_aligned(_t(x), _t(mats), 32, "bicubic", _t(fill)).numpy()
    np.testing.assert_allclose(t, j, atol=1e-4, rtol=0)
    general = tda.warp(_t(x), _t(mats), 32, "bicubic", _t(fill)).numpy()
    np.testing.assert_allclose(t, general, atol=1e-4, rtol=0)


def test_crop_and_geo_matrices_match_jax():
    j, i = np.asarray([0, 4, 9]), np.asarray([3, 0, 7])
    w, h = np.asarray([32.0, 20.0, 11.0], np.float32), np.asarray([30.0, 18.0, 25.0], np.float32)
    np.testing.assert_array_equal(
        tda.crop_matrix(torch.from_numpy(j), torch.from_numpy(i), _t(w), _t(h), 32).numpy(),
        np.asarray(jda._crop_matrix(jnp.asarray(j), jnp.asarray(i), jnp.asarray(w),
                                    jnp.asarray(h), 32)))
    for timm, tnames, jnames in ((True, tda.TIMM_OPS, jda._TIMM_OPS),
                                 (False, tda.TV_OPS, jda._TV_OPS)):
        b = 2 * len(tnames)
        op_idx = np.tile(np.arange(len(tnames)), 2)
        mag = np.linspace(0.05, 1.0, b).astype(np.float32)
        signed = np.arange(b) % 3 == 0
        t = tda.geo_matrix(tnames, torch.from_numpy(op_idx), _t(mag), torch.from_numpy(signed),
                           32.0).numpy()
        jm = np.asarray(jda._geo_matrix(jnames, jnp.asarray(op_idx), jnp.asarray(mag),
                                        jnp.asarray(signed), 32.0, timm))
        np.testing.assert_allclose(t, jm, atol=1e-6, rtol=1e-6)


def test_apply_color_table_batch_matches_jax():
    """Every op of both tables on a batch, each image its own op, level and
    sign (Equalize and the geometric ops pass through the table)."""
    for timm, tnames, jnames in ((True, tda.TIMM_OPS, jda._TIMM_OPS),
                                 (False, tda.TV_OPS, jda._TV_OPS)):
        b = len(tnames)
        x = _batch(3, b=b)
        op_idx = np.arange(b)
        mag = np.random.default_rng(4).uniform(size=b).astype(np.float32)
        signed = np.arange(b) % 2 == 1
        t = tda.apply_color_table(_t(x), tnames, torch.from_numpy(op_idx), _t(mag),
                                  torch.from_numpy(signed)).numpy()
        jfn = jax.vmap(lambda xi, oi, mi, si: jda._apply_color_table(xi, jnames, oi, mi, si, timm))
        jo = np.asarray(jfn(jnp.asarray(x), jnp.asarray(op_idx), jnp.asarray(mag),
                            jnp.asarray(signed)))
        assert np.abs(t - jo).max() <= 1.0


# ---------------------------------------------------------------------------
# the random ops' apply halves at the parameters JAX drew
# ---------------------------------------------------------------------------


def _jax_ra_params(key, b, n_ops, magnitude, mstd, prob, timm):
    """``_ra_layer``'s draws, re-derived from its key as it splits it."""
    k_op, k_apply, k_mag, k_sign = jax.random.split(key, 4)
    op_idx = jax.random.randint(k_op, (b,), 0, n_ops)
    applied = (jax.random.uniform(k_apply, (b,)) < prob if prob < 1.0 else jnp.ones((b,), bool))
    top = 10.0 if timm else 30.0
    m = jnp.clip(magnitude + mstd * jax.random.normal(k_mag, (b,)), 0.0, top) / top
    signed = jax.random.uniform(k_sign, (b,)) < 0.5
    return {"op_idx": torch.from_numpy(np.array(op_idx, np.int64)),
            "applied": torch.from_numpy(np.array(applied)), "mag": _t(m),
            "signed_flip": torch.from_numpy(np.array(signed))}


@pytest.mark.parametrize("timm", [True, False])
def test_ra_layer_apply_matches_jax(timm):
    """A whole RandAugment layer (color table, shared warp, the Equalize
    subset, the applied mask) at JAX's draws: equal up to one grey level
    where a warp's float32 sum lands on a rounding edge, at most 0.2 % of
    values."""
    b = 64
    x = _batch(5, b=b)
    names, jnames = (tda.TIMM_OPS, jda._TIMM_OPS) if timm else (tda.TV_OPS, jda._TV_OPS)
    fill = np.asarray([125.0, 123.0, 114.0] if timm else [0.0, 0.0, 0.0], np.float32)
    mag, mstd, prob = (9.0, 0.5, 0.5) if timm else (9.0, 0.0, 1.0)
    key = jax.random.key(11)
    j = np.asarray(jda._ra_layer(key, jnp.asarray(x), jnames, 32, jnp.asarray(fill), timm=timm,
                                 magnitude=mag, mstd=mstd, prob=prob))
    params = _jax_ra_params(key, b, len(names), mag, mstd, prob, timm)
    t = tda.apply_ra_layer(_t(x), params, names, 32, _t(fill)).numpy()
    diff = np.abs(t - j)
    assert diff.max() <= 1.0 and (diff > 0).mean() <= 2e-3, (diff.max(), (diff > 0).mean())


def test_ra_layer_equalize_cap():
    """More selectors than the cap: the first 24 (in batch order) are
    equalized, the others keep their input, as in the JAX layer."""
    b = 40
    x = _batch(6, b=b)
    k_eq = tda.TIMM_OPS.index("Equalize")
    params = {"op_idx": torch.full((b,), k_eq), "applied": torch.ones(b, dtype=torch.bool),
              "mag": torch.full((b,), 0.5), "signed_flip": torch.zeros(b, dtype=torch.bool)}
    out = tda.apply_ra_layer(_t(x), params, tda.TIMM_OPS, 32, torch.zeros(3)).numpy()
    for i in range(b):
        ref = _pil(ImageOps.equalize, x[i].astype(np.uint8)) if i < 24 else x[i]
        np.testing.assert_array_equal(out[i], ref, err_msg=str(i))


def test_erase_and_flip_apply_match_jax():
    b, shape = 128, (128, 32, 32, 3)
    x = np.random.default_rng(8).normal(size=shape).astype(np.float32)
    key = jax.random.key(21)
    j = np.asarray(jda._random_erase(key, jnp.asarray(x), 0.5, "pixel", 2))
    # the draws of _random_erase, re-derived from its key
    k_p, k_loop = jax.random.split(key)
    do = np.asarray(jax.random.uniform(k_p, (b,)) < 0.5)
    rects = []
    for n in range(2):
        ks = jax.random.split(jax.random.fold_in(k_loop, n), 5)
        target = 1024.0 * jax.random.uniform(ks[0], (b, 10), minval=0.02, maxval=1 / 3)
        aspect = jnp.exp(jax.random.uniform(ks[1], (b, 10), minval=np.log(0.3),
                                            maxval=np.log(3.3)))
        eh, ew = jnp.round(jnp.sqrt(target * aspect)), jnp.round(jnp.sqrt(target / aspect))
        valid = (eh < 32) & (ew < 32)
        first = jnp.argmax(valid, axis=1)
        bidx = jnp.arange(b)
        eh_s, ew_s = eh[bidx, first].astype(jnp.int32), ew[bidx, first].astype(jnp.int32)
        top = jda._randint(ks[2], jnp.zeros((b,), jnp.int32), 32 - eh_s)
        left = jda._randint(ks[3], jnp.zeros((b,), jnp.int32), 32 - ew_s)
        rects.append({
            "ok": torch.from_numpy(np.array(valid[bidx, first]) & do),
            "top": torch.from_numpy(np.array(top, np.int64)),
            "left": torch.from_numpy(np.array(left, np.int64)),
            "eh": torch.from_numpy(np.array(eh_s, np.int64)),
            "ew": torch.from_numpy(np.array(ew_s, np.int64)),
            "fill": _t(jax.random.normal(ks[4], shape)),
        })
    t = tda.apply_erase(_t(x), {"rects": rects}).numpy()
    np.testing.assert_array_equal(t, j)
    assert 0 < (t != x).reshape(b, -1).any(1).sum() < b

    key = jax.random.key(22)
    j = np.asarray(jda._hflip(key, jnp.asarray(x), 0.5))
    flip = torch.from_numpy(np.array(jax.random.uniform(key, (b,)) < 0.5))
    np.testing.assert_array_equal(tda.apply_flip(_t(x), flip).numpy(), j)


# ---------------------------------------------------------------------------
# samplers: distributions (test_device_augment.py's bounds)
# ---------------------------------------------------------------------------


def test_torch_rrc_distribution_matches_jax():
    b = 4096
    mats = tda.sample_torch_rrc(torch.Generator().manual_seed(0), b, 32, 32, 32, "cpu").numpy()
    jm = np.asarray(jda.sample_torch_rrc(jax.random.key(0), b, 32, 32, 32))
    areas = mats[:, 0, 0] * mats[:, 1, 1]
    j_areas = jm[:, 0, 0] * jm[:, 1, 1]
    for q in (0.1, 0.25, 0.5, 0.75, 0.9):
        assert abs(np.quantile(areas, q) - np.quantile(j_areas, q)) < 0.05, q
    # integral boxes inside the image
    w, i = mats[:, 0, 0] * 32, mats[:, 1, 2]
    assert np.allclose(w, np.round(w), atol=1e-4) and (i >= 0).all()
    assert (mats[:, 0, 2] + w <= 32 + 1e-4).all()


def test_tf_rrc_distribution_matches_jax():
    b = 4096
    scale, ratio = (0.08, 1.0), (0.75, 1.3333)
    mats = tda.sample_tf_rrc(torch.Generator().manual_seed(1), b, 32, 32, scale, ratio, 32,
                             "cpu").numpy()
    jm = np.asarray(jda.sample_tf_rrc(jax.random.key(1), b, 32, 32, scale, ratio, 32))
    a, ja = mats[:, 0, 0] * mats[:, 1, 1], jm[:, 0, 0] * jm[:, 1, 1]
    for q in (0.1, 0.25, 0.5, 0.75, 0.9):
        assert abs(np.quantile(a, q) - np.quantile(ja, q)) < 0.05, q
        # the crop's left edge
        assert abs(np.quantile(mats[:, 0, 2], q) - np.quantile(jm[:, 0, 2], q)) <= 1.0, q


def test_randint_is_inclusive():
    g = torch.Generator().manual_seed(2)
    lo = torch.zeros(20000, dtype=torch.int64)
    v = tda.randint(g, lo, torch.full((20000,), 3))
    assert set(v.tolist()) == {0, 1, 2, 3}
    assert abs(float((v == 3).float().mean()) - 0.25) < 0.02


def test_erasing_fraction_matches_prob():
    x = torch.zeros(512, 32, 32, 3)
    p = tda.sample_erase(torch.Generator().manual_seed(1), x.shape, 0.25, "pixel", 1)
    out = tda.apply_erase(x, p)
    erased = float((out.abs().reshape(512, -1).amax(1) > 0).float().mean())
    assert 0.15 < erased < 0.35, erased


def test_hflip_prob():
    x = torch.randn(512, 8, 8, 1, generator=torch.Generator().manual_seed(0))
    out = tda.apply_flip(x, tda.sample_flip(torch.Generator().manual_seed(2), 512, 0.5, "cpu"))
    flipped = float(((out - x).abs().reshape(512, -1).amax(1) > 0).float().mean())
    assert 0.4 < flipped < 0.6


@functools.lru_cache(maxsize=None)
def _jax_pipeline_output():
    """The JAX device pipeline on test_device_augment.py's raw batch, once
    a module."""
    cfg = jload_config(CIFAR)
    raw = np.random.default_rng(3).integers(0, 256, (64, 32, 32, 3), np.uint8)
    out = jax.jit(jda.make_device_train_augment(cfg.data))(jax.random.key(0), jnp.asarray(raw))
    return raw, np.asarray(out)


def test_full_pipeline_stats_match_jax():
    """The whole stack on the same raw batch: the port's output against the
    JAX device pipeline's, in mean (0.35) and spread (std ratio 0.5-1.8),
    test_device_augment.py's bounds against its host pipeline."""
    raw, j = _jax_pipeline_output()
    cfg = tconfig.load_config(CIFAR)
    fn = tda.make_device_train_augment(cfg.data)
    t = fn(torch.Generator().manual_seed(0), torch.from_numpy(raw)).numpy()
    assert t.shape == j.shape == (64, 32, 32, 3) and t.dtype == np.float32
    assert np.isfinite(t).all()
    assert abs(float(t.mean()) - float(j.mean())) < 0.35
    assert 0.5 < float(t.std()) / float(j.std()) < 1.8
    # the same generator state gives the same draws and the same batch
    g = torch.Generator().manual_seed(0)
    params = fn.sample(g, 64, 32, 32, "cpu")
    part = fn.apply(torch.from_numpy(raw[:8]), {k: v[:8] for k, v in params.items()})
    np.testing.assert_array_equal(t[:8], part.numpy())


# ---------------------------------------------------------------------------
# the eval transform against the JAX package's host (PIL) transform
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("smooth", [True, False])
def test_eval_transform_matches_pil(smooth):
    """32 -> 36 bicubic upscale, center crop 32, normalise: before the
    normalisation, mean |d| < 3 and median <= 1 grey level against PIL
    (``test_crop_resize_matches_pil_upscale``'s bound), and the normalised
    output against JAX's host transform at the same bound over 255 * std."""
    imgs = (np.stack([_smooth_img(), np.roll(_smooth_img(), 5, axis=1)]) if smooth
            else np.stack([_img(30), _img(31)]))
    cfg = tconfig.load_config(CIFAR)
    jcfg = jload_config(CIFAR)
    t = taug.make_eval_transform(cfg.data)(torch.from_numpy(imgs)).numpy()
    mean, std = np.asarray(taug.CIFAR_MEAN), np.asarray(taug.CIFAR_STD)
    t_pix = (t * std + mean) * 255.0
    jtf = jaug.make_eval_transform(jcfg.data)
    j = np.stack([jtf(im) for im in imgs])
    j_pix = (j * std + mean) * 255.0
    ref = np.stack([np.asarray(jaug.center_crop_resize(Image.fromarray(im), 32, 0.875))
                    for im in imgs]).astype(np.float32)
    np.testing.assert_allclose(j_pix, ref, atol=1e-3)
    err = np.abs(t_pix - ref)
    assert np.mean(err) < 3.0 and np.median(err) <= 1.0 + 1e-3, (np.mean(err), np.median(err))
    assert t.shape == (2, 32, 32, 3)


def test_norm_stats_and_static_match_jax():
    for ds, c in (("cifar-10", 3), ("cifar-100", 3), ("medmnist", 3), ("svhn", 3),
                  ("mnist", 1), ("tiny-imagenet", 3)):
        assert taug.norm_stats(ds, c) == jaug.norm_stats(ds, c)
    for path in (CIFAR, "configs/vit_som/vit_som_mnist.yaml", "configs/vit/vit_cifar-10.yaml"):
        assert taug.is_static_transform(tconfig.load_config(path).data) == \
            jaug.is_static_transform(jload_config(path).data)
    cfg = tconfig.load_config(CIFAR, {"data.augment.randaug_n": 0,
                                      "data.augment.resize_scale": [1.0, 1.0]})
    assert not taug.is_static_transform(cfg.data)
