"""The train augmentation as batched torch ops on the images' device.

Counterpart of ``vitsom_tpu/data/device_augment.py``, op for op and
formula for formula: pass 1 (TF-style RandomResizedCrop, torchvision-style
RandAugment, flip, from the config), pass 2 (torchvision-semantics RRC,
flip 0.5, timm ``rand-m9-mstd0.5-inc1``), normalisation and timm random
erasing. As there:

- every op runs in the [0, 255] float domain and rounds to integers after
  each op (``torch.round``: half to even, as ``jnp.round``), mimicking
  PIL's uint8 quantisation between stages; the RRC warps are rounded, not
  clipped, as the JAX package leaves them;
- the geometric ops resample with PIL's bicubic (a = -0.5), not torch's
  ``interpolate``/``grid_sample`` (a = -0.75, other edge rules): the
  kernel weights are built densely per axis, out-of-range taps fold onto
  the edge pixels, and an output pixel whose source lies outside the image
  takes the fill (black, or the dataset mean for the timm ops);
- Equalize runs on the first 24 images of a batch that drew it (a stable
  argsort), the rest keep their input.

Each random op is split in two: ``sample_*`` draws its parameters from an
explicit ``torch.Generator`` on the data's device, and ``apply_*`` is a
deterministic function of the images and those parameters, which the
tests hold against the JAX package's arithmetic at the same parameters.
The streams differ from JAX's (Philox against the JAX key streams); the
per-image distributions are the same. ``DeviceTrainAugment`` composes
them: its ``sample`` draws a whole epoch's parameters at once, and its
``apply`` draws nothing and copies nothing from the host, so the data
module captures it as a CUDA graph (``data/pipeline.py``).
"""

from __future__ import annotations

import math
from typing import Dict, List, Optional, Sequence

import torch
import torch.nn.functional as F

from vitsom_tpu_torch.config import DataConfig

# PIL bicubic: the cubic convolution kernel with a = -0.5
CUBIC_A = -0.5
EQUALIZE_CAP = 24
# the live bytes one chunk of the augmentation may hold (the JAX package's
# guard against its dense warp at 224x224; every 32x32 batch is one chunk)
CHUNK_BUDGET_BYTES = 3584 * 2**20


# ---------------------------------------------------------------------------
# resampling (PIL-convention affine warps)
# ---------------------------------------------------------------------------


def cubic_kernel(x: torch.Tensor) -> torch.Tensor:
    a = CUBIC_A
    ax = torch.abs(x)
    return torch.where(
        ax <= 1.0,
        ((a + 2.0) * ax - (a + 3.0)) * ax * ax + 1.0,
        torch.where(ax < 2.0, (((ax - 5.0) * ax + 8.0) * ax - 4.0) * a, torch.zeros_like(ax)),
    )


def linear_kernel(x: torch.Tensor) -> torch.Tensor:
    return torch.clamp(1.0 - torch.abs(x), min=0.0)


def axis_weights(coord: torch.Tensor, n: int, method: str) -> torch.Tensor:
    """Dense weights along one axis: for sample positions ``coord`` [..., P]
    returns [..., P, n] with W[..., p, i] = kernel(coord_p - i); taps past
    either edge fold onto the edge pixel, so each row sums to 1."""
    kern = cubic_kernel if method == "bicubic" else linear_kernel
    radius = 2 if method == "bicubic" else 1
    grid = torch.arange(n, dtype=torch.float32, device=coord.device)
    w = kern(coord[..., None] - grid)
    for off in range(1, radius + 1):
        w[..., 0] += kern(coord - (-off))
        w[..., n - 1] += kern(coord - (n - 1 + off))
    return w


def _fill_or_black(fill: Optional[torch.Tensor], b: int, c: int, dev) -> torch.Tensor:
    if fill is None:
        return torch.zeros((b, c), dtype=torch.float32, device=dev)
    return fill.expand(b, c)


def warp(imgs: torch.Tensor, mats: torch.Tensor, out_size: int, method: str = "bicubic",
         fill: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Batched affine warp of [B, H, W, C] images. ``mats`` [B, 2, 3] map
    OUTPUT pixel centers to INPUT positions, PIL's convention: output index
    (xo, yo) samples ``M @ (xo + .5, yo + .5, 1) - .5`` in input index
    space. Two batched products with the dense per-axis weights."""
    b, h, w, c = imgs.shape
    s = out_size
    o = torch.arange(s, dtype=torch.float32, device=imgs.device) + 0.5
    yo, xo = torch.meshgrid(o, o, indexing="ij")
    xof, yof = xo.reshape(-1), yo.reshape(-1)
    xin = mats[:, 0, 0, None] * xof + mats[:, 0, 1, None] * yof + mats[:, 0, 2, None] - 0.5
    yin = mats[:, 1, 0, None] * xof + mats[:, 1, 1, None] * yof + mats[:, 1, 2, None] - 0.5
    wx = axis_weights(xin, w, method)  # [B, P, W]
    wy = axis_weights(yin, h, method)  # [B, P, H]
    tmp = torch.einsum("bpx,byxc->bpyc", wx, imgs.float())
    out = torch.einsum("bpy,bpyc->bpc", wy, tmp)
    valid = (xin > -0.5) & (xin < w - 0.5) & (yin > -0.5) & (yin < h - 0.5)
    out = torch.where(valid[:, :, None], out, _fill_or_black(fill, b, c, imgs.device)[:, None, :])
    return out.reshape(b, s, s, c)


def warp_axis_aligned(imgs: torch.Tensor, mats: torch.Tensor, out_size: int,
                      method: str = "bicubic", fill: Optional[torch.Tensor] = None) -> torch.Tensor:
    """``warp`` for axis-aligned affines (``mats[:, 0, 1] == mats[:, 1, 0]
    == 0``, every crop matrix): per-axis weights [B, S, W] in place of the
    per-pixel [B, S*S, W], the same arithmetic and the same fill."""
    b, h, w, c = imgs.shape
    o = torch.arange(out_size, dtype=torch.float32, device=imgs.device) + 0.5
    xin = mats[:, 0, 0, None] * o + mats[:, 0, 2, None] - 0.5  # [B, S]
    yin = mats[:, 1, 1, None] * o + mats[:, 1, 2, None] - 0.5
    wx = axis_weights(xin, w, method)  # [B, S, W]
    wy = axis_weights(yin, h, method)  # [B, S, H]
    tmp = torch.einsum("bsx,byxc->bysc", wx, imgs.float())  # [B, H, S, C]
    out = torch.einsum("bty,bysc->btsc", wy, tmp)  # [B, S, S, C]
    valid = (((xin > -0.5) & (xin < w - 0.5))[:, None, :]
             & ((yin > -0.5) & (yin < h - 0.5))[:, :, None])
    return torch.where(valid[..., None], out,
                       _fill_or_black(fill, b, c, imgs.device)[:, None, None, :])


def identity_mats(b: int, device) -> torch.Tensor:
    """[B, 2, 3] identity affines, made on the device (no host copy, so a
    graph can capture it)."""
    return torch.eye(2, 3, dtype=torch.float32, device=device).expand(b, 2, 3).clone()


# ---------------------------------------------------------------------------
# RRC parameter sampling (both reference variants)
# ---------------------------------------------------------------------------


def crop_matrix(j, i, w, h, out_size: int) -> torch.Tensor:
    """Affine out->in of PIL ``resize(box=(j, i, j + w, i + h))``: output
    center xo + .5 maps to ``j + (xo + .5) * w / S``."""
    sx = w / out_size
    sy = h / out_size
    z = torch.zeros_like(sx)
    return torch.stack([torch.stack([sx, z, j.float()], -1),
                        torch.stack([z, sy, i.float()], -1)], -2)


def randint(generator: torch.Generator, minval: torch.Tensor,
            maxval_inclusive: torch.Tensor) -> torch.Tensor:
    """Uniform integers in [minval, maxval_inclusive] with per-element
    bounds, by the floor of a scaled uniform (the JAX package's form)."""
    u = torch.rand(minval.shape, generator=generator, device=minval.device)
    span = (maxval_inclusive - minval + 1).float()
    return minval + torch.minimum(torch.floor(u * span), span - 1.0).to(minval.dtype)


def uniform(generator: torch.Generator, shape, low: float, high: float, device) -> torch.Tensor:
    return low + torch.rand(shape, generator=generator, device=device) * (high - low)


def sample_tf_rrc(generator, b: int, height: int, width: int, scale, ratio, out_size: int,
                  device) -> torch.Tensor:
    """TF/BYOL-style single-draw RRC: no retry, w and h clamped to the
    image; returns the crop matrices [B, 2, 3]."""
    area = float(height * width)
    target = area * uniform(generator, (b,), scale[0], scale[1], device)
    aspect = torch.exp(uniform(generator, (b,), math.log(ratio[0]), math.log(ratio[1]), device))
    w = torch.clamp(torch.round(torch.sqrt(target * aspect)), max=float(width))
    h = torch.clamp(torch.round(torch.sqrt(target / aspect)), max=float(height))
    zeros = torch.zeros(b, dtype=torch.int64, device=device)
    i = randint(generator, zeros, height - h.long())
    j = randint(generator, zeros, width - w.long())
    return crop_matrix(j, i, w, h, out_size)


def sample_torch_rrc(generator, b: int, height: int, width: int, out_size: int, device,
                     scale=(0.08, 1.0), ratio=(3.0 / 4.0, 4.0 / 3.0)) -> torch.Tensor:
    """torchvision-semantics RRC: the first of 10 attempts that fits, else
    a center crop clamped to the ratio bounds; returns [B, 2, 3]."""
    area = float(height * width)
    target = area * uniform(generator, (b, 10), scale[0], scale[1], device)
    aspect = torch.exp(uniform(generator, (b, 10), math.log(ratio[0]), math.log(ratio[1]), device))
    w = torch.round(torch.sqrt(target * aspect))
    h = torch.round(torch.sqrt(target / aspect))
    valid = (w > 0) & (w <= width) & (h > 0) & (h <= height)
    any_valid = valid.any(dim=1)
    first = _first_true(valid)
    w_sel = w.gather(1, first[:, None])[:, 0]
    h_sel = h.gather(1, first[:, None])[:, 0]
    in_ratio = width / height
    if in_ratio < ratio[0]:
        w_fb, h_fb = float(width), float(round(width / ratio[0]))
    elif in_ratio > ratio[1]:
        h_fb, w_fb = float(height), float(round(height * ratio[1]))
    else:
        w_fb, h_fb = float(width), float(height)
    w_out = torch.where(any_valid, w_sel, torch.full_like(w_sel, w_fb))
    h_out = torch.where(any_valid, h_sel, torch.full_like(h_sel, h_fb))
    zeros = torch.zeros(b, dtype=torch.int64, device=device)
    i_rand = randint(generator, zeros, height - h_out.long())
    j_rand = randint(generator, zeros, width - w_out.long())
    i = torch.where(any_valid, i_rand, torch.full_like(i_rand, int((height - h_fb) // 2)))
    j = torch.where(any_valid, j_rand, torch.full_like(j_rand, int((width - w_fb) // 2)))
    return crop_matrix(j, i, w_out, h_out, out_size)


def _first_true(mask: torch.Tensor) -> torch.Tensor:
    """Index of the first True along dim 1 (0 when none), as ``argmax``."""
    return torch.argmax(mask.to(torch.uint8), dim=1)


# ---------------------------------------------------------------------------
# pixel (color) ops: [0, 255] floats, batched [B, S, S, C]; per-image
# parameters are [B] tensors (or Python numbers)
# ---------------------------------------------------------------------------


def _per_image(v, x: torch.Tensor) -> torch.Tensor:
    """A [B] parameter broadcast against [B, S, S, C] (a number passes)."""
    if isinstance(v, torch.Tensor) and v.ndim == 1:
        return v.reshape(-1, *([1] * (x.ndim - 1)))
    return v


def to_l(x: torch.Tensor) -> torch.Tensor:
    """PIL ``convert('L')``: L = (19595 R + 38470 G + 7471 B + 0x8000) >> 16,
    exact in float32 for integer inputs; [B, S, S]."""
    if x.shape[-1] == 1:
        return x[..., 0]
    acc = 19595.0 * x[..., 0] + 38470.0 * x[..., 1] + 7471.0 * x[..., 2] + 32768.0
    return torch.floor(acc / 65536.0)


def _blend(degenerate, x, factor):
    """ImageEnhance: degenerate + factor * (x - degenerate), clipped."""
    return torch.clamp(degenerate + _per_image(factor, x) * (x - degenerate), 0.0, 255.0)


def op_invert(x):
    return 255.0 - x


def op_posterize(x, bits):
    q = 2.0 ** (8.0 - _per_image(bits, x))
    return torch.floor(x / q) * q


def op_solarize(x, thresh):
    return torch.where(x < _per_image(thresh, x), x, 255.0 - x)


def op_solarize_add(x, add, thresh=128.0):
    return torch.where(x < thresh, torch.clamp(x + _per_image(add, x), max=255.0), x)


def op_brightness(x, factor):
    return _blend(torch.zeros_like(x), x, factor)


def op_color(x, factor):
    return _blend(to_l(x)[..., None].expand_as(x), x, factor)


def op_contrast(x, factor):
    mean = torch.round(to_l(x).mean(dim=(1, 2)))
    return _blend(mean.reshape(-1, 1, 1, 1).expand_as(x), x, factor)


def _smooth_kernel(device) -> torch.Tensor:
    """ImageFilter.SMOOTH's [1,1,1;1,5,1;1,1,1] / 13 as a [1, 1, 3, 3]
    conv weight, made on the device."""
    ar = torch.arange(3, device=device)
    center = (ar[:, None] == 1) & (ar[None, :] == 1)
    return ((1.0 + 4.0 * center.float()) / 13.0)[None, None]


def op_sharpness(x, factor):
    """ImageEnhance.Sharpness: blend with ImageFilter.SMOOTH (3x3 kernel
    [1,1,1;1,5,1;1,1,1]/13); PIL leaves the 1-pixel border unfiltered."""
    b, s, _, c = x.shape
    xc = x.permute(0, 3, 1, 2).reshape(b * c, 1, s, s)
    sm = F.conv2d(xc, _smooth_kernel(x.device), padding=1)
    sm = sm.reshape(b, c, s, s).permute(0, 2, 3, 1)
    sm = torch.round(torch.clamp(sm, 0.0, 255.0))
    ar = torch.arange(s, device=x.device)
    edge = (ar == 0) | (ar == s - 1)
    inner = ~(edge[:, None] | edge[None, :])
    return _blend(torch.where(inner[:, :, None], sm, x), x, factor)


def op_autocontrast(x):
    """Per-image, per-channel min/max rescale (cutoff 0)."""
    lo = x.amin(dim=(1, 2), keepdim=True)
    hi = x.amax(dim=(1, 2), keepdim=True)
    scale = 255.0 / torch.clamp(hi - lo, min=1e-12)
    out = torch.clamp(torch.round((x - lo) * scale), 0.0, 255.0)
    return torch.where(hi > lo, out, x)


def op_equalize(x):
    """PIL ImageOps.equalize, per image and channel: step = (npixels -
    count of the highest occupied bin) // 255; lut[i] = (step // 2 +
    sum_{j<i} h[j]) // step; identity when step == 0 or one bin is
    occupied. Integer arithmetic throughout."""
    b, s, _, c = x.shape
    v = x.permute(0, 3, 1, 2).reshape(b * c, s * s)
    vi = torch.clamp(torch.round(v), 0, 255).long()
    hist = torch.zeros((b * c, 256), dtype=torch.int64, device=x.device)
    hist.scatter_add_(1, vi, torch.ones_like(vi))
    nonzero = hist > 0
    last_idx = 255 - torch.argmax(nonzero.flip(1).to(torch.uint8), dim=1)
    last_count = hist.gather(1, last_idx[:, None])[:, 0]
    step = torch.div(s * s - last_count, 255, rounding_mode="floor")
    cum = torch.cumsum(hist, dim=1) - hist
    lut = torch.div(torch.div(step, 2, rounding_mode="floor")[:, None] + cum,
                    torch.clamp(step, min=1)[:, None], rounding_mode="floor")
    out = torch.clamp(lut, 0, 255).gather(1, vi).float()
    use = (step > 0) & (nonzero.sum(dim=1) > 1)
    out = torch.where(use[:, None], out, v)
    return out.reshape(b, c, s, s).permute(0, 2, 3, 1)


# ---------------------------------------------------------------------------
# geometric RA ops -> PIL-convention affine matrices ([B] -> [B, 2, 3])
# ---------------------------------------------------------------------------


def _mat(rows: Sequence[Sequence[torch.Tensor]]) -> torch.Tensor:
    return torch.stack([torch.stack(list(r), -1) for r in rows], -2)


def mat_shear_x(v):
    z, o = torch.zeros_like(v), torch.ones_like(v)
    return _mat([[o, v, z], [z, z + 1.0, z]])


def mat_shear_y(v):
    z, o = torch.zeros_like(v), torch.ones_like(v)
    return _mat([[o, z, z], [v, o, z]])


def mat_translate_x(v_px):
    z, o = torch.zeros_like(v_px), torch.ones_like(v_px)
    return _mat([[o, z, v_px], [z, o, z]])


def mat_translate_y(v_px):
    z, o = torch.zeros_like(v_px), torch.ones_like(v_px)
    return _mat([[o, z, z], [z, o, v_px]])


def mat_rotate(angle_deg, size: float):
    """PIL ``Image.rotate(angle, expand=False)``: counter-clockwise about
    the center (w/2, h/2); maps output -> input."""
    a = -torch.deg2rad(angle_deg)
    cos, sin = torch.cos(a), torch.sin(a)
    cx = cy = size / 2.0
    m02 = cx - cos * cx - sin * cy
    m12 = cy + sin * cx - cos * cy
    return _mat([[cos, sin, m02], [-sin, cos, m12]])


# ---------------------------------------------------------------------------
# RandAugment layers (torchvision-style and timm rand-m9-mstd0.5-inc1)
# ---------------------------------------------------------------------------

TV_OPS = (
    "Identity", "AutoContrast", "Equalize", "Rotate", "Posterize", "Solarize",
    "Color", "Contrast", "Brightness", "Sharpness", "ShearX", "ShearY",
    "TranslateX", "TranslateY",
)
TIMM_OPS = (
    "AutoContrast", "Equalize", "Invert", "Rotate", "PosterizeIncreasing",
    "SolarizeIncreasing", "SolarizeAdd", "ColorIncreasing",
    "ContrastIncreasing", "BrightnessIncreasing", "SharpnessIncreasing",
    "ShearX", "ShearY", "TranslateXRel", "TranslateYRel",
)
GEO = {"Rotate", "ShearX", "ShearY", "TranslateX", "TranslateY",
       "TranslateXRel", "TranslateYRel"}


def enh_factor(mag, signed_flip):
    """Enhance factor 1 +/- 0.9 * mag (``mag`` the [0, 1] level fraction)."""
    v = mag * 0.9
    return 1.0 + torch.where(signed_flip, -v, v)


def _color_op(name: str, x, mag, signed_flip):
    if name == "Identity":
        return x
    if name == "AutoContrast":
        return op_autocontrast(x)
    if name == "Invert":
        return op_invert(x)
    if name == "Posterize":
        # torchvision: bits 8 -> 4 with the magnitude, at least 1
        return op_posterize(x, torch.clamp(torch.floor(8.0 - mag * 4.0), min=1.0))
    if name == "PosterizeIncreasing":
        # timm: 4 - int(level * 4), at least 1
        return op_posterize(x, torch.clamp(4.0 - torch.floor(mag * 4.0), min=1.0))
    if name == "Solarize":
        return op_solarize(x, 255.0 - mag * 255.0)
    if name == "SolarizeIncreasing":
        return op_solarize(x, 256.0 - torch.floor(mag * 256.0))
    if name == "SolarizeAdd":
        return op_solarize_add(x, torch.floor(mag * 110.0))
    enhance = {"Color": op_color, "Contrast": op_contrast, "Brightness": op_brightness,
               "Sharpness": op_sharpness}
    base = name[: -len("Increasing")] if name.endswith("Increasing") else name
    if base not in enhance:
        raise ValueError(name)
    return enhance[base](x, enh_factor(mag, signed_flip))


def apply_color_table(x, names, op_idx, mag, signed_flip):
    """Every color op of ``names`` on the batch, each image taking the one
    its ``op_idx`` names (rounded and clipped), else its input. Geometric
    ops and Equalize are left to ``apply_ra_layer``."""
    out = x
    for k, name in enumerate(names):
        if name in GEO or name == "Equalize":
            continue
        y = torch.round(torch.clamp(_color_op(name, x, mag, signed_flip), 0.0, 255.0))
        out = torch.where(_per_image(op_idx == k, x), y, out)
    return out


def geo_matrix(names, op_idx, mag, signed_flip, size: float) -> torch.Tensor:
    """Per-image affine of the layer's op where it is geometric, else the
    identity; ``mag`` is the [0, 1] level fraction, the sign applied here."""
    mats = identity_mats(op_idx.shape[0], op_idx.device)
    sgn = 1.0 - 2.0 * signed_flip.float()
    for k, name in enumerate(names):
        if name not in GEO:
            continue
        if name == "Rotate":
            m = mat_rotate(sgn * mag * 30.0, size)
        elif name == "ShearX":
            m = mat_shear_x(sgn * mag * 0.3)
        elif name == "ShearY":
            m = mat_shear_y(sgn * mag * 0.3)
        elif name in ("TranslateX", "TranslateXRel"):
            m = mat_translate_x(sgn * mag * 0.45 * size)
        else:
            m = mat_translate_y(sgn * mag * 0.45 * size)
        mats = torch.where((op_idx == k)[:, None, None], m, mats)
    return mats


def sample_ra_layer(generator, b: int, n_ops: int, magnitude: float, mstd: float,
                    prob: float, timm: bool, device) -> Dict[str, torch.Tensor]:
    """One RandAugment layer's draws: the op, whether it applies, the level
    fraction (N(magnitude, mstd) clipped to [0, 10] / 10 for timm, [0, 30]
    / 30 for torchvision) and the sign."""
    op_idx = torch.randint(0, n_ops, (b,), generator=generator, device=device)
    u_apply = torch.rand(b, generator=generator, device=device)
    applied = u_apply < prob if prob < 1.0 else torch.ones(b, dtype=torch.bool, device=device)
    top = 10.0 if timm else 30.0
    normal = torch.randn(b, generator=generator, device=device)
    mag = torch.clamp(magnitude + mstd * normal, 0.0, top) / top
    signed_flip = torch.rand(b, generator=generator, device=device) < 0.5
    return {"op_idx": op_idx, "applied": applied, "mag": mag, "signed_flip": signed_flip}


def apply_ra_layer(x, params, names, size: int, fill: torch.Tensor) -> torch.Tensor:
    """One RandAugment layer at drawn ``params``: the color table, one
    shared geometric warp (rounded), Equalize on the first
    ``EQUALIZE_CAP`` images that drew it, and the input where the layer
    does not apply."""
    b = x.shape[0]
    op_idx, mag, signed_flip = params["op_idx"], params["mag"], params["signed_flip"]
    applied = params["applied"]
    is_geo = torch.zeros(b, dtype=torch.bool, device=x.device)
    for k, name in enumerate(names):
        if name in GEO:
            is_geo |= op_idx == k
    color = apply_color_table(x, names, op_idx, mag, signed_flip)
    mats = geo_matrix(names, op_idx, mag, signed_flip, float(size))
    warped = torch.round(warp(x, mats, size, "bicubic", fill.expand(b, x.shape[-1])))
    out = torch.where(is_geo[:, None, None, None], warped, color)

    want_eq = (op_idx == names.index("Equalize")) & applied
    sel = torch.sort((~want_eq).to(torch.uint8), stable=True).indices[: min(EQUALIZE_CAP, b)]
    eq_full = x.clone()
    eq_full[sel] = op_equalize(x[sel])
    out = torch.where(want_eq[:, None, None, None], eq_full, out)
    return torch.where(applied[:, None, None, None], out, x)


# ---------------------------------------------------------------------------
# random erasing (timm pixel mode) and flips
# ---------------------------------------------------------------------------


def sample_erase(generator, shape, prob: float, mode: str, count: int,
                 scale=(0.02, 1 / 3), ratio=(0.3, 3.3), device=None,
                 fill: bool = True) -> Dict[str, object]:
    """timm RandomErasing's draws for a batch of ``shape`` [B, H, W, C]:
    whether each image is erased, and for each of the ``count`` erasures
    the first of 10 attempts that fits (its height, width, top and left)
    and, with ``fill``, the fill (standard normal in pixel mode, else 0:
    ``erase_fill``)."""
    b, h, w, _ = shape
    do = torch.rand(b, generator=generator, device=device) < prob
    area = float(h * w)
    rects: List[Dict[str, torch.Tensor]] = []
    for _ in range(max(1, count)):
        target = area * uniform(generator, (b, 10), scale[0], scale[1], device)
        aspect = torch.exp(uniform(generator, (b, 10), math.log(ratio[0]), math.log(ratio[1]),
                                   device))
        eh = torch.round(torch.sqrt(target * aspect))
        ew = torch.round(torch.sqrt(target / aspect))
        valid = (eh < h) & (ew < w)
        first = _first_true(valid)[:, None]
        ok = valid.gather(1, first)[:, 0] & do
        eh_s = eh.gather(1, first)[:, 0].long()
        ew_s = ew.gather(1, first)[:, 0].long()
        zeros = torch.zeros(b, dtype=torch.int64, device=device)
        top = randint(generator, zeros, h - eh_s)
        left = randint(generator, zeros, w - ew_s)
        rects.append({"ok": ok, "top": top, "left": left, "eh": eh_s, "ew": ew_s})
        if fill:
            rects[-1]["fill"] = erase_fill(generator, shape, mode, device)
    return {"rects": rects}


def erase_fill(generator, shape, mode: str, device=None, out=None) -> torch.Tensor:
    """RandomErasing's fill of ``shape``: standard normal in pixel mode,
    else zeros (into ``out`` when given)."""
    if mode == "pixel":
        return torch.randn(shape, generator=generator, device=device, out=out)
    return torch.zeros(shape, device=device, out=out)


def apply_erase(x, params) -> torch.Tensor:
    """Each drawn rectangle of an erased image takes its fill."""
    _, h, w, _ = x.shape
    ys = torch.arange(h, device=x.device)[None, :, None]
    xs = torch.arange(w, device=x.device)[None, None, :]
    for r in params["rects"]:
        top, left = r["top"][:, None, None], r["left"][:, None, None]
        mask = ((ys >= top) & (ys < top + r["eh"][:, None, None])
                & (xs >= left) & (xs < left + r["ew"][:, None, None])
                & r["ok"][:, None, None])
        x = torch.where(mask[..., None], r["fill"], x)
    return x


def sample_flip(generator, b: int, prob: float, device) -> torch.Tensor:
    return torch.rand(b, generator=generator, device=device) < prob


def apply_flip(x, flip: torch.Tensor) -> torch.Tensor:
    return torch.where(flip[:, None, None, None], x.flip(2), x)


# ---------------------------------------------------------------------------
# the pipeline
# ---------------------------------------------------------------------------


class DeviceTrainAugment:
    """The train augmentation of a config: TF-RRC + torchvision RandAugment
    + flip (pass 1, from the config), then torch-RRC + flip(0.5) + timm
    rand-m9-mstd0.5-inc1 + normalise + erasing (pass 2, timm's defaults).

    ``sample(generator, n, height, width, device)`` draws every random
    parameter of ``n`` images at once (a flat dict of tensors whose first
    dimension is the image); ``apply(uint8 images [B, H, W, C], params of
    those B images)`` is deterministic and draws nothing, so a CUDA graph
    can capture it and replay it for batch after batch. Per image the
    draws are those of the JAX package's ``make_device_train_augment``;
    Equalize's cap of 24 holds per ``apply`` call, a train batch in the
    JAX package and here. ``__call__(generator, images)`` is ``apply`` at
    fresh draws. A batch whose warps would hold more than
    ``CHUNK_BUDGET_BYTES`` is applied in equal chunks (the JAX package's
    guard; at 32x32 a batch is one chunk)."""

    def __init__(self, data_cfg: DataConfig):
        from vitsom_tpu_torch.data.augment import norm_stats

        self.aug = data_cfg.augment
        self.size = data_cfg.input_size
        self.mean, self.std = norm_stats(data_cfg.dataset, data_cfg.num_channels)
        # timm fills its geometric ops' borders with the dataset mean
        self.timm_fill = [min(255.0, round(255 * float(m))) for m in self.mean]
        self._consts: Dict[torch.device, Dict[str, torch.Tensor]] = {}

    def _layers(self):
        """(key prefix, op names, magnitude, mstd, prob, timm) of each
        RandAugment layer, in order."""
        tv = [(f"tv{i}", TV_OPS, float(self.aug.randaug_m), 0.0, 1.0, False)
              for i in range(self.aug.randaug_n)]
        timm = [(f"timm{i}", TIMM_OPS, 9.0, 0.5, 0.5, True)
                for i in range(2 if self.aug.autoaugment else 0)]
        return tv, timm

    def sample(self, generator, n: int, height: int, width: int, device,
               erase_fill: bool = True) -> Dict[str, torch.Tensor]:
        """Every draw for ``n`` images; without ``erase_fill`` the erasing
        fills (``erase_keys``), [n, S, S, C] each, are left to the caller."""
        aug, size = self.aug, self.size
        c = len(self.mean)
        p = {"rrc1": sample_tf_rrc(generator, n, height, width, tuple(aug.resize_scale),
                                   tuple(aug.resize_ratio), size, device)}
        tv, timm = self._layers()
        for key, names, mag, mstd, prob, is_timm in tv:
            for k, v in sample_ra_layer(generator, n, len(names), mag, mstd, prob, is_timm,
                                        device).items():
                p[f"{key}.{k}"] = v
        if aug.horizontal_flip > 0:
            p["flip1"] = sample_flip(generator, n, aug.horizontal_flip, device)
        p["rrc2"] = sample_torch_rrc(generator, n, size, size, size, device)
        p["flip2"] = sample_flip(generator, n, 0.5, device)
        for key, names, mag, mstd, prob, is_timm in timm:
            for k, v in sample_ra_layer(generator, n, len(names), mag, mstd, prob, is_timm,
                                        device).items():
                p[f"{key}.{k}"] = v
        if aug.reprob > 0:
            erase = sample_erase(generator, (n, size, size, c), aug.reprob, aug.remode,
                                 aug.recount, device=device, fill=erase_fill)
            for j, rect in enumerate(erase["rects"]):
                for k, v in rect.items():
                    p[f"erase{j}.{k}"] = v
        return p

    def erase_keys(self) -> List[str]:
        """The parameter keys of the erasing fills."""
        if self.aug.reprob <= 0:
            return []
        return [f"erase{j}.fill" for j in range(max(1, self.aug.recount))]

    def _constants(self, device) -> Dict[str, torch.Tensor]:
        """The mean, std and fills on ``device``, copied there once (a graph
        captures no host-to-device copy)."""
        dev = torch.device(device)
        if dev not in self._consts:
            self._consts[dev] = {
                "mean": torch.tensor(self.mean, dtype=torch.float32, device=dev),
                "std": torch.tensor(self.std, dtype=torch.float32, device=dev),
                "timm_fill": torch.tensor(self.timm_fill, dtype=torch.float32, device=dev),
                "black": torch.zeros(len(self.mean), dtype=torch.float32, device=dev),
            }
        return self._consts[dev]

    def _apply(self, images, p):
        b, _, _, c = images.shape
        size = self.size
        k = self._constants(images.device)
        black = k["black"].expand(b, c)
        x = torch.round(warp_axis_aligned(images.float(), p["rrc1"], size, "bicubic", black))
        tv, timm = self._layers()
        for key, names, *_ in tv:
            x = apply_ra_layer(x, _sub(p, key), names, size, k["black"])
        if "flip1" in p:
            x = apply_flip(x, p["flip1"])
        x = torch.round(warp_axis_aligned(x, p["rrc2"], size, "bicubic", black))
        x = apply_flip(x, p["flip2"])
        for key, names, *_ in timm:
            x = apply_ra_layer(x, _sub(p, key), names, size, k["timm_fill"])
        x = (x / 255.0 - k["mean"]) / k["std"]
        rects = [_sub(p, f"erase{j}") for j in range(max(1, self.aug.recount))
                 if f"erase{j}.ok" in p]
        if rects:
            x = apply_erase(x, {"rects": rects})
        return x

    def chunk_size(self, b: int, h: int, c: int) -> int:
        """Images a chunk of a [b, h, h, c] batch holds: the most whose
        warps stay within ``CHUNK_BUDGET_BYTES`` (an S x S x max(h, S)
        float32 weight and temporary set of 2 + c planes an image) that
        divides ``b``."""
        per_img = self.size * self.size * max(h, self.size) * 4 * (2 + c)
        chunk = max(1, min(b, CHUNK_BUDGET_BYTES // max(per_img, 1)))
        while b % chunk:
            chunk -= 1
        return chunk

    def apply(self, images: torch.Tensor, params: Dict[str, torch.Tensor]) -> torch.Tensor:
        b, h, _, c = images.shape
        chunk = self.chunk_size(b, h, c)
        if chunk == b:
            return self._apply(images, params)
        return torch.cat([
            self._apply(images[s:s + chunk], {k: v[s:s + chunk] for k, v in params.items()})
            for s in range(0, b, chunk)
        ])

    def __call__(self, generator, images: torch.Tensor) -> torch.Tensor:
        b, h, w, _ = images.shape
        return self.apply(images, self.sample(generator, b, h, w, images.device))


def _sub(params: Dict[str, torch.Tensor], key: str) -> Dict[str, torch.Tensor]:
    """The entries ``key.*`` of a flat parameter dict, without the prefix."""
    pre = key + "."
    return {k[len(pre):]: v for k, v in params.items() if k.startswith(pre)}


def make_device_train_augment(data_cfg: DataConfig) -> DeviceTrainAugment:
    """``fn(generator, uint8 images [B, H, W, C]) -> normalised float32
    [B, S, S, C]`` on the images' device, drawing from ``generator`` (a
    ``torch.Generator`` on that device); ``fn.sample`` / ``fn.apply`` split
    the draws from the arithmetic (``DeviceTrainAugment``)."""
    return DeviceTrainAugment(data_cfg)
