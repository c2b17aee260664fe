"""MobileViT-S in PyTorch: the baseline of ``model_arch: mobile_vit``.

Counterpart of ``vitsom_tpu/models/mobile_vit.py``, module for module and
with its stage list (``STAGES``): a stride-2 conv stem (16), MobileNetV2
inverted residuals (expansion 4, SiLU, BatchNorm), three MobileViT blocks
(transformer dims 144 / 192 / 240, depths 2 / 4 / 3, 4 heads, mlp ratio 2)
that unfold the map into 2x2 patch positions, run pre-norm transformers
across the positions and fold back, a 1x1 conv to 640, global average pool
and a linear head. Images enter NHWC, as in the JAX package; inside, the
maps are NCHW. Where it must match Flax's arithmetic rather than torch's
defaults:

- **SAME padding** (``same_padding``) is worked out per input size, as
  Flax's ``padding="SAME"``: a stride-2 3x3 conv pads (0, 1) on an even
  input and (1, 1) on an odd one, so an asymmetric pad is an ``F.pad``
  before an unpadded conv;
- **BatchNorm** is Flax's (``models/ae.BatchNorm`` over N, H, W; momentum
  0.9, eps 1e-5): the biased batch variance in float32, the running
  averages moved in place by the train step (so a captured step replays
  the update), read in eval;
- **the resize** at a stage whose map is not a multiple of the patch (the
  7x7 stage at 224, 7 -> 8 -> 7) is ``jax.image.resize(..., "bilinear")``:
  its triangle kernel widened by the downsampling factor (antialiasing) and
  each column of weights normalised, built once per size by
  ``scale_and_translate``'s formula in its float32 arithmetic
  (``resize_weights``: the same weights, bitwise) and applied as two
  matrix products, one an axis; their backward is a matrix product too,
  with no atomic scatter, so a graphed step stays bitwise equal to an
  eager one;
- **attention** is Flax's ``MultiHeadDotProductAttention``: the query
  divided by sqrt(head_dim) before the product, softmax, no dropout (the
  JAX model runs it ``deterministic``); query / key / value / out are
  ``nn.Linear`` layers whose weights ``convert.py`` reshapes from Flax's
  [dim, heads, head_dim] and [heads, head_dim, dim];
- **LayerNorm** is ``models/vit.LayerNorm`` at eps 1e-6.

``train.compute_dtype: bfloat16`` computes the convs and transformers in
bfloat16; the parameters, BatchNorm statistics, pool and head stay float32.
``train.remat_blocks`` recomputes the stem and every block in the backward
(``torch.utils.checkpoint``, as the JAX model's ``nn.remat``); BatchNorm
moves its running averages in the first forward only: the recomputation
runs inside ``ae.frozen_statistics``. The model draws no random numbers.
"""

from __future__ import annotations

import contextlib
import math
from typing import Dict, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from vitsom_tpu_torch.config import Config
from vitsom_tpu_torch.models.ae import BatchNorm, frozen_statistics
from vitsom_tpu_torch.models.vit import LayerNorm
from vitsom_tpu_torch.utils import initializers as init

BN_MOMENTUM = 0.9
BN_EPS = 1e-5
LN_EPS = 1e-6
PATCH = 2
NUM_HEADS = 4
MLP_RATIO = 2.0
EXPANSION = 4
STEM = 16
HEAD_CONV = 640
# (kind, features, stride or depth) in call order: "mv2" blocks take
# (features, stride), "mvit" blocks (transformer dim, depth) at the
# channels of the block before them
STAGES = (("mv2", 32, 1),
          ("mv2", 64, 2), ("mv2", 64, 1), ("mv2", 64, 1),
          ("mv2", 96, 2), ("mvit", 144, 2),
          ("mv2", 128, 2), ("mvit", 192, 4),
          ("mv2", 160, 2), ("mvit", 240, 3))


def same_padding(size: int, kernel: int, stride: int) -> Tuple[int, int]:
    """(before, after) padding of Flax's ``SAME`` on an axis of ``size``."""
    out = -(-size // stride)
    total = max((out - 1) * stride + kernel - size, 0)
    return total // 2, total - total // 2


class Conv(nn.Conv2d):
    """Bias-free conv with Flax's ``SAME`` padding, computed in ``dtype``."""

    def __init__(self, c_in: int, c_out: int, kernel: int = 1, stride: int = 1,
                 groups: int = 1, dtype=torch.float32):
        super().__init__(c_in, c_out, kernel, stride=stride, groups=groups, bias=False)
        self.dtype = dtype

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        k, s = self.kernel_size[0], self.stride[0]
        (top, bottom), (left, right) = (same_padding(n, k, s) for n in x.shape[2:])
        w = self.weight.to(self.dtype)
        if (top, left) == (bottom, right):
            return F.conv2d(x.to(self.dtype), w, None, s, (top, left), 1, self.groups)
        x = F.pad(x.to(self.dtype), (left, right, top, bottom))
        return F.conv2d(x, w, None, s, 0, 1, self.groups)


def _bn(features: int) -> BatchNorm:
    return BatchNorm(features, momentum=BN_MOMENTUM, eps=BN_EPS, dims=(0, 2, 3))


class ConvBnSiLU(nn.Module):
    def __init__(self, c_in: int, features: int, kernel: int = 3, stride: int = 1,
                 groups: int = 1, dtype=torch.float32):
        super().__init__()
        self.conv = Conv(c_in, features, kernel, stride, groups, dtype)
        self.bn = _bn(features)

    def forward(self, x: torch.Tensor, train: bool = False) -> torch.Tensor:
        return F.silu(self.bn(self.conv(x), train))


class MV2Block(nn.Module):
    """MobileNetV2 inverted residual: 1x1 expand, 3x3 depthwise, 1x1
    project (linear); residual when the stride is 1 and channels match."""

    def __init__(self, c_in: int, features: int, stride: int = 1,
                 expansion: int = EXPANSION, dtype=torch.float32):
        super().__init__()
        hidden = c_in * expansion
        self.residual = stride == 1 and c_in == features
        self.expand = ConvBnSiLU(c_in, hidden, 1, dtype=dtype)
        self.dw = ConvBnSiLU(hidden, hidden, 3, stride, groups=hidden, dtype=dtype)
        self.project = Conv(hidden, features, 1, dtype=dtype)
        self.project_bn = _bn(features)

    def forward(self, x: torch.Tensor, train: bool = False) -> torch.Tensor:
        y = self.dw(self.expand(x, train), train)
        y = self.project_bn(self.project(y), train)
        return x + y if self.residual else y


class MultiHeadAttention(nn.Module):
    """Flax ``MultiHeadDotProductAttention`` (self-attention, no dropout)
    over the next-to-last axis of [..., N, dim]."""

    def __init__(self, dim: int, num_heads: int = NUM_HEADS, dtype=torch.float32):
        super().__init__()
        self.num_heads = num_heads
        self.head_dim = dim // num_heads
        self.dtype = dtype
        self.query = nn.Linear(dim, dim)
        self.key = nn.Linear(dim, dim)
        self.value = nn.Linear(dim, dim)
        self.out = nn.Linear(dim, dim)
        # the query's divisor, a 0-d tensor: a Python float would become a
        # multiplication by its reciprocal on the card
        self.register_buffer("scale", torch.tensor(math.sqrt(self.head_dim)), persistent=False)

    def _linear(self, layer: nn.Linear, x: torch.Tensor) -> torch.Tensor:
        return F.linear(x, layer.weight.to(self.dtype), layer.bias.to(self.dtype))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        *lead, n, dim = x.shape
        heads = (*lead, n, self.num_heads, self.head_dim)
        q, k, v = (self._linear(lin, x).reshape(heads).transpose(-3, -2)
                   for lin in (self.query, self.key, self.value))
        q = q / self.scale.to(self.dtype)
        p = torch.softmax(q @ k.transpose(-1, -2), dim=-1)
        o = (p @ v).transpose(-3, -2).reshape(*lead, n, dim)
        return self._linear(self.out, o)


class TransformerBlock(nn.Module):
    """Pre-norm attention + MLP (SiLU), as timm's MobileViT transformer."""

    def __init__(self, dim: int, mlp_ratio: float = MLP_RATIO, dtype=torch.float32):
        super().__init__()
        self.dtype = dtype
        self.norm1 = LayerNorm(dim, LN_EPS, dtype)
        self.attn = MultiHeadAttention(dim, NUM_HEADS, dtype)
        self.norm2 = LayerNorm(dim, LN_EPS, dtype)
        self.fc1 = nn.Linear(dim, int(dim * mlp_ratio))
        self.fc2 = nn.Linear(int(dim * mlp_ratio), dim)

    def _linear(self, layer: nn.Linear, x: torch.Tensor) -> torch.Tensor:
        return F.linear(x, layer.weight.to(self.dtype), layer.bias.to(self.dtype))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x + self.attn(self.norm1(x))
        h = F.silu(self._linear(self.fc1, self.norm2(x)))
        return x + self._linear(self.fc2, h)


def _unfold(x: torch.Tensor, p: int) -> Tuple[torch.Tensor, Tuple[int, int]]:
    """[B, d, H, W] -> [B, p*p, (H/p)*(W/p), d], the JAX package's token
    order (one group a pixel position inside the p x p patches)."""
    b, d, h, w = x.shape
    x = x.reshape(b, d, h // p, p, w // p, p).permute(0, 3, 5, 2, 4, 1)
    return x.reshape(b, p * p, (h // p) * (w // p), d), (h, w)


def _fold(x: torch.Tensor, p: int, hw: Tuple[int, int]) -> torch.Tensor:
    """The inverse of ``_unfold``: [B, p*p, N, d] -> [B, d, H, W]."""
    h, w = hw
    b, d = x.shape[0], x.shape[-1]
    x = x.reshape(b, p, p, h // p, w // p, d).permute(0, 5, 3, 1, 4, 2)
    return x.reshape(b, d, h, w)


def resize_weights(in_size: int, out_size: int) -> np.ndarray:
    """[out_size, in_size] float32 weights of ``jax.image.resize``'s
    bilinear resize of one axis (``scale_and_translate``'s
    ``compute_weight_mat``, antialiased, in its float32 arithmetic): the
    triangle kernel at the sample points (i + 0.5) / scale - 0.5, its width
    multiplied by 1 / scale when downsampling, each output's weights
    divided by their sum, zero where the sample point lies outside the
    input."""
    f = np.float32
    inv = 1.0 / (out_size / in_size)  # a Python float there, as here
    sample = (np.arange(out_size, dtype=f) + f(0.5)) * f(inv) - f(0.0) - f(0.5)
    x = np.abs(sample[None, :] - np.arange(in_size, dtype=f)[:, None]) / f(max(inv, 1.0))
    w = np.maximum(f(0.0), f(1.0) - x)  # [in, out]
    total = w.sum(axis=0, keepdims=True, dtype=f)
    w = np.where(np.abs(total) > f(1000.0 * float(np.finfo(np.float32).eps)),
                 w / np.where(total != 0, total, f(1.0)), f(0.0))
    inside = (sample >= f(-0.5)) & (sample <= f(in_size - 0.5))
    return np.where(inside[None, :], w, f(0.0)).T.copy()


# resize weights by (in, out, dtype, device); made in an eager step, before
# a captured step reads them
_RESIZE: Dict[tuple, torch.Tensor] = {}


def _resize_matrix(n_in: int, n_out: int, like: torch.Tensor) -> torch.Tensor:
    key = (n_in, n_out, like.dtype, like.device)
    if key not in _RESIZE:
        _RESIZE[key] = torch.from_numpy(resize_weights(n_in, n_out)).to(
            device=like.device, dtype=like.dtype)
    return _RESIZE[key]


def resize(y: torch.Tensor, h: int, w: int) -> torch.Tensor:
    """``jax.image.resize(..., "bilinear")`` of [B, C, H, W] to [B, C, h, w]:
    one product an axis with ``resize_weights`` in ``y``'s dtype."""
    y = _resize_matrix(y.shape[2], h, y) @ y
    return y @ _resize_matrix(y.shape[3], w, y).T


class MobileViTBlock(nn.Module):
    def __init__(self, channels: int, transformer_dim: int, depth: int, patch: int = PATCH,
                 mlp_ratio: float = MLP_RATIO, dtype=torch.float32):
        super().__init__()
        self.patch = patch
        self.dtype = dtype
        self.local = ConvBnSiLU(channels, channels, 3, dtype=dtype)
        self.local_proj = Conv(channels, transformer_dim, 1, dtype=dtype)
        self.transformer = nn.ModuleList(
            [TransformerBlock(transformer_dim, mlp_ratio, dtype) for _ in range(depth)])
        self.norm = LayerNorm(transformer_dim, LN_EPS, dtype)
        self.proj = ConvBnSiLU(transformer_dim, channels, 1, dtype=dtype)
        self.fuse = ConvBnSiLU(2 * channels, channels, 3, dtype=dtype)

    def forward(self, x: torch.Tensor, train: bool = False) -> torch.Tensor:
        p = self.patch
        y = self.local_proj(self.local(x, train))
        h, w = y.shape[2:]
        nh, nw = math.ceil(h / p) * p, math.ceil(w / p) * p
        resized = (nh, nw) != (h, w)
        if resized:
            y = resize(y, nh, nw)
        tokens, hw = _unfold(y, p)
        for blk in self.transformer:
            tokens = blk(tokens)
        y = _fold(self.norm(tokens), p, hw)
        if resized:
            y = resize(y, h, w)
        y = self.proj(y, train)
        return self.fuse(torch.cat([x, y], dim=1), train)


def _recompute_frozen():
    """``context_fn`` of a checkpointed block: the recomputation in the
    backward moves no running average."""
    return contextlib.nullcontext(), frozen_statistics()


class MobileViTS(nn.Module):
    """mobilevit_s: stem 16; stages (32), (64 x3, s2), (96 + ViT d2/144),
    (128 + ViT d4/192), (160 + ViT d3/240); 1x1 conv 640 -> pool -> fc."""

    def __init__(self, num_classes: int = 1000, dtype=torch.float32, remat: bool = False,
                 in_chans: int = 3):
        super().__init__()
        self.dtype = dtype
        self.remat = remat
        self.stem = ConvBnSiLU(in_chans, STEM, 3, stride=2, dtype=dtype)
        blocks, c = [], STEM
        for kind, a, b in STAGES:
            if kind == "mv2":
                blocks.append(MV2Block(c, a, b, dtype=dtype))
                c = a
            else:
                blocks.append(MobileViTBlock(c, a, b, dtype=dtype))
        self.blocks = nn.ModuleList(blocks)
        self.head_conv = ConvBnSiLU(c, HEAD_CONV, 1, dtype=dtype)
        self.head = nn.Linear(HEAD_CONV, num_classes)

    def reset_parameters(self, generator: Optional[torch.Generator] = None) -> None:
        """Flax's defaults: ``lecun_normal`` conv and Dense kernels, zero
        biases, LayerNorm and BatchNorm scale 1 and bias 0, running mean
        0 and var 1."""
        for m in self.modules():
            if isinstance(m, (nn.Conv2d, nn.Linear)):
                init.lecun_normal_(m.weight, generator)
                if m.bias is not None:
                    nn.init.zeros_(m.bias)
            elif isinstance(m, nn.LayerNorm):
                nn.init.ones_(m.weight)
                nn.init.zeros_(m.bias)
            elif isinstance(m, BatchNorm):
                m.reset_parameters()

    def _run(self, module: nn.Module, x: torch.Tensor, train: bool) -> torch.Tensor:
        if self.remat and torch.is_grad_enabled():
            return checkpoint(module, x, train, use_reentrant=False, preserve_rng_state=False,
                              context_fn=_recompute_frozen)
        return module(x, train)

    def forward(self, x: torch.Tensor, train: bool = False) -> torch.Tensor:
        """[B, H, W, C] -> logits [B, num_classes] (float32); ``train``
        normalises with the batch's statistics and moves the running ones."""
        x = x.permute(0, 3, 1, 2).contiguous()
        x = self._run(self.stem, x, train)
        for blk in self.blocks:
            x = self._run(blk, x, train)
        x = self.head_conv(x, train)
        # pool and head in the parameters' dtype (float32)
        return self.head(x.to(self.head.weight.dtype).mean(dim=(2, 3)))


def build_mobilevit_s(cfg: Config) -> MobileViTS:
    """MobileViT-S of ``cfg``: ``data.num_classes`` outputs,
    ``train.compute_dtype`` and ``train.remat_blocks``."""
    dtype = torch.bfloat16 if cfg.train.compute_dtype == "bfloat16" else torch.float32
    return MobileViTS(cfg.data.num_classes, dtype, cfg.train.remat_blocks,
                      cfg.data.num_channels)
