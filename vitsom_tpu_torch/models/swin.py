"""Swin Transformer baseline in PyTorch.

Counterpart of ``vitsom_tpu/models/swin.py``: patch embedding, (shifted)
window attention with a relative-position bias table, patch merging between
stages, stochastic depth over ``linspace(0, 0.1, sum(depths))``, LayerNorm
(eps 1e-5) and a mean-pool head. Images enter NHWC, as in the JAX package.

``WindowAttention`` has two paths over one parameter set, as there:

- dense-masked: the block's whole token sequence runs one [B, H, N, N]
  attention whose additive bias is the gathered relative-position bias
  plus a constant mask: -1e9 between windows (the softmax weight underflows
  to exactly 0) and the reference's -100 between the regions of a shifted
  window (``dense_attn_constants``);
- windowed: roll, zero-pad to window multiples, partition, per-window
  attention with the shift mask, reverse. The padded tokens take part in
  the softmax as keys, as timm's do, which the dense form cannot express.

The JAX package takes the dense path whenever the resolution divides the
window. The port does too up to ``DENSE_MAX_TOKENS`` tokens; above it
(only ``swin_flowers-17.yaml``'s first stage, 56 x 56 = 3136 tokens) a
[B, H, N, N] float32 tensor is 15 GB at B 128, and the windowed path,
which computes the same function (the JAX package's own test holds the
two paths to 2e-5), runs instead.

The bias gather is a product with a constant one-hot matrix [N*N, T] (T =
(2 w - 1)^2 table rows) instead of an index: the backward of an index
scatters with atomic adds on the card, whose summation order changes from
run to run, while the one-hot product's backward is a plain matrix
product, the same sum at every run. With TF32 off
(``utils/device.resolve_device``) the forward product reproduces each
table entry exactly. The masks and one-hot matrices are non-persistent
buffers built once, so a captured step reads them at fixed addresses.

Drop-path masks come from ``models/stochastic.bernoulli_mask`` when the
forward is given a generator (training); without one the model is
deterministic.

``train.compute_dtype: bfloat16`` follows the JAX package's casts: the patch
embedding, every dense layer and the residual stream compute in bf16, the
LayerNorms take their statistics in float32 and output bf16, the scores
accumulate in float32 and the softmax runs in float32 (its probabilities
cast to bf16 before the product with v), and the final LayerNorm, pool and
head run in float32. Parameters stay float32.
"""

from __future__ import annotations

from functools import lru_cache
from typing import Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from vitsom_tpu_torch.config import Config
from vitsom_tpu_torch.models.stochastic import DropPath
from vitsom_tpu_torch.models.vit import _DTYPES, Dense, LayerNorm, Mlp, patchify
from vitsom_tpu_torch.ops import attention as attention_ops
from vitsom_tpu_torch.utils import initializers as init

LN_EPS = 1e-5  # timm's Swin keeps LayerNorm's default eps
_DENSE_NEG = -1.0e9
# the largest token count a block runs on the dense-masked path (module
# docstring); the shipped configs' dense blocks have 16-784 tokens
DENSE_MAX_TOKENS = 1024


def window_partition(x: torch.Tensor, w: int) -> torch.Tensor:
    """[B, H, W, C] -> [B*nW, w*w, C]."""
    b, h, ww, c = x.shape
    x = x.reshape(b, h // w, w, ww // w, w, c).permute(0, 1, 3, 2, 4, 5)
    return x.reshape(-1, w * w, c)


def window_reverse(x: torch.Tensor, w: int, h: int, ww: int) -> torch.Tensor:
    """[B*nW, w*w, C] -> [B, H, W, C]."""
    b = x.shape[0] // ((h // w) * (ww // w))
    x = x.reshape(b, h // w, ww // w, w, w, -1).permute(0, 1, 3, 2, 4, 5)
    return x.reshape(b, h, ww, -1)


def relative_position_index(w: int) -> np.ndarray:
    """[w*w, w*w] index into the (2w-1)^2 relative-bias table."""
    coords = np.stack(np.meshgrid(np.arange(w), np.arange(w), indexing="ij"))
    coords = coords.reshape(2, -1)
    rel = coords[:, :, None] - coords[:, None, :]  # [2, n, n]
    rel = rel.transpose(1, 2, 0) + (w - 1)
    return (rel[:, :, 0] * (2 * w - 1) + rel[:, :, 1]).astype(np.int32)


def shift_attn_mask(h: int, w_dim: int, window: int, shift: int) -> np.ndarray:
    """[nW, w*w, w*w] additive mask (-100 for cross-region pairs) for
    shifted-window attention."""
    img_mask = np.zeros((1, h, w_dim, 1), np.float32)
    cnt = 0
    for hs in (slice(0, -window), slice(-window, -shift), slice(-shift, None)):
        for ws in (slice(0, -window), slice(-window, -shift), slice(-shift, None)):
            img_mask[:, hs, ws, :] = cnt
            cnt += 1
    x = img_mask.reshape(1, h // window, window, w_dim // window, window, 1)
    mw = x.transpose(0, 1, 3, 2, 4, 5).reshape(-1, window * window)
    mask = mw[:, None, :] - mw[:, :, None]
    return np.where(mask != 0, -100.0, 0.0).astype(np.float32)


@lru_cache(maxsize=None)
def dense_attn_constants(h: int, w_dim: int, window: int, shift: int
                         ) -> Tuple[np.ndarray, np.ndarray]:
    """(mask [N, N] f32, bias_idx [N, N] int32) for N = h * w_dim: the
    dense-masked form of (shifted) window attention. Pairs in different
    windows get -1e9, pairs in one shifted window but different regions
    -100, and ``bias_idx`` maps each same-window pair to its relative
    position's table row (masked pairs point at row 0). Requires h and
    w_dim to be multiples of ``window``."""
    assert h % window == 0 and w_dim % window == 0
    ys, xs = np.mgrid[0:h, 0:w_dim]
    # token (y, x) sits at rolled coords (yr, xr) after roll(-shift, -shift)
    yr = (ys - shift) % h
    xr = (xs - shift) % w_dim
    wid = ((yr // window) * (w_dim // window) + (xr // window)).ravel()
    same = wid[:, None] == wid[None, :]
    mask = np.where(same, 0.0, _DENSE_NEG).astype(np.float32)
    if shift:
        region_img = np.zeros((h, w_dim), np.float32)
        cnt = 0
        sl = (slice(0, -window), slice(-window, -shift), slice(-shift, None))
        for hs in sl:
            for ws in sl:
                region_img[hs, ws] = cnt
                cnt += 1
        region = region_img[yr, xr].ravel()
        cross = same & (region[:, None] != region[None, :])
        mask = np.where(cross, -100.0, mask).astype(np.float32)
    iy = (yr % window).ravel()
    ix = (xr % window).ravel()
    rel = ((iy[:, None] - iy[None, :] + window - 1) * (2 * window - 1)
           + (ix[:, None] - ix[None, :] + window - 1))
    bias_idx = np.where(same, rel, 0).astype(np.int32)
    return mask, bias_idx


def one_hot_rows(index: np.ndarray, size: int) -> torch.Tensor:
    """[M] indices -> [M, size] float32 one-hot rows."""
    flat = np.asarray(index).reshape(-1)
    out = np.zeros((flat.size, size), np.float32)
    out[np.arange(flat.size), flat] = 1.0
    return torch.from_numpy(out)


def _upcast(x: torch.Tensor) -> torch.Tensor:
    """bf16 to float32 (exact); float32 and float64 as they are."""
    return x.to(torch.promote_types(x.dtype, torch.float32))


class WindowAttention(nn.Module):
    """(Shifted-)window attention: ``qkv`` -> ``rel_bias_table`` ->
    ``proj``, one parameter set for both paths (module docstring)."""

    def __init__(self, dim: int, window: int, num_heads: int, attn_impl: str = "xla",
                 dtype=torch.float32):
        super().__init__()
        self.dim = dim
        self.window = window
        self.num_heads = num_heads
        self.attn_impl = attn_impl
        self.dtype = dtype
        self.qkv = Dense(dim, 3 * dim, compute_dtype=dtype)
        self.rel_bias_table = nn.Parameter(torch.zeros((2 * window - 1) ** 2, num_heads))
        self.proj = Dense(dim, dim, compute_dtype=dtype)

    def relative_bias(self, one_hot: torch.Tensor, n: int) -> torch.Tensor:
        """[H, n, n]: the table gathered by the one-hot rows [n*n, T]."""
        return (one_hot @ self.rel_bias_table).reshape(n, n, self.num_heads).permute(2, 0, 1)

    def forward_dense(self, x, mask: torch.Tensor, one_hot: torch.Tensor):
        """x [B, N, C] with the dense mask [N, N] and one-hot [N*N, T]."""
        b, n, c = x.shape
        qkv = self.qkv(x).reshape(b, n, 3, self.num_heads, c // self.num_heads)
        q, k, v = qkv[:, :, 0], qkv[:, :, 1], qkv[:, :, 2]
        bias = self.relative_bias(one_hot, n) + mask[None]
        out, _ = attention_ops.multi_head_attention(q, k, v, impl=self.attn_impl, bias=bias)
        return self.proj(out.reshape(b, n, c).to(self.dtype))

    def forward_windowed(self, x, one_hot: torch.Tensor, mask: Optional[torch.Tensor] = None):
        """x [B*nW, w*w, C], one-hot [(w*w)^2, T], shift mask [nW, w*w, w*w]."""
        bnw, n, c = x.shape
        hd = c // self.num_heads
        qkv = self.qkv(x).reshape(bnw, n, 3, self.num_heads, hd).permute(2, 0, 3, 1, 4)
        q, k, v = qkv[0], qkv[1], qkv[2]  # [bnw, H, n, hd]
        # float32 scores and softmax whatever the compute dtype
        attn = torch.einsum("bhnd,bhmd->bhnm", _upcast(q), _upcast(k)) * hd**-0.5
        attn = attn + self.relative_bias(one_hot, n)[None]
        if mask is not None:
            nw = mask.shape[0]
            attn = attn.reshape(bnw // nw, nw, self.num_heads, n, n) + mask[None, :, None]
            attn = attn.reshape(bnw, self.num_heads, n, n)
        attn = torch.softmax(attn, dim=-1).to(self.dtype)
        out = torch.einsum("bhnm,bhmd->bhnd", _upcast(attn), _upcast(v)).to(self.dtype)
        return self.proj(out.permute(0, 2, 1, 3).reshape(bnw, n, c))


class SwinBlock(nn.Module):
    def __init__(self, dim: int, input_resolution: Tuple[int, int], num_heads: int,
                 window: int, shift: int, mlp_ratio: float = 4.0, drop_path: float = 0.0,
                 attn_impl: str = "xla", force_windowed: bool = False, dtype=torch.float32):
        super().__init__()
        h, w_dim = input_resolution
        self.resolution = (h, w_dim)
        self.window = window = min(window, h, w_dim)
        self.shift = shift = 0 if window >= min(h, w_dim) else shift
        self.dense = (h % window == 0 and w_dim % window == 0 and not force_windowed
                      and h * w_dim <= DENSE_MAX_TOKENS)
        self.norm1 = LayerNorm(dim, eps=LN_EPS, out_dtype=dtype)
        self.attn = WindowAttention(dim, window, num_heads, attn_impl, dtype)
        self.drop_path = DropPath(drop_path)
        self.norm2 = LayerNorm(dim, eps=LN_EPS, out_dtype=dtype)
        self.mlp = Mlp(dim, int(dim * mlp_ratio), dim, dtype=dtype)
        table = (2 * window - 1) ** 2
        if self.dense:
            mask, bias_idx = dense_attn_constants(h, w_dim, window, shift)
            self.register_buffer("attn_mask", torch.from_numpy(mask), persistent=False)
            self.register_buffer("bias_one_hot", one_hot_rows(bias_idx, table), persistent=False)
        else:
            self.pad = ((window - h % window) % window, (window - w_dim % window) % window)
            self.register_buffer("bias_one_hot",
                                 one_hot_rows(relative_position_index(window), table),
                                 persistent=False)
            if shift:
                hp, wp = h + self.pad[0], w_dim + self.pad[1]
                self.register_buffer("attn_mask",
                                     torch.from_numpy(shift_attn_mask(hp, wp, window, shift)),
                                     persistent=False)
            else:
                self.attn_mask = None

    def _windowed(self, x):
        h, w_dim = self.resolution
        b, n, c = x.shape
        window, shift = self.window, self.shift
        x = x.reshape(b, h, w_dim, c)
        pad_h, pad_w = self.pad
        if pad_h or pad_w:
            x = F.pad(x, (0, 0, 0, pad_w, 0, pad_h))
        hp, wp = h + pad_h, w_dim + pad_w
        if shift:
            x = torch.roll(x, shifts=(-shift, -shift), dims=(1, 2))
        xw = self.attn.forward_windowed(window_partition(x, window), self.bias_one_hot,
                                        self.attn_mask)
        x = window_reverse(xw, window, hp, wp)
        if shift:
            x = torch.roll(x, shifts=(shift, shift), dims=(1, 2))
        if pad_h or pad_w:
            x = x[:, :h, :w_dim, :]
        return x.reshape(b, n, c)

    def forward(self, x, generator: Optional[torch.Generator] = None):
        shortcut = x
        x = self.norm1(x)
        if self.dense:
            x = self.attn.forward_dense(x, self.attn_mask, self.bias_one_hot)
        else:
            x = self._windowed(x)
        x = shortcut + self.drop_path(x, generator)
        y = self.mlp(self.norm2(x))
        return x + self.drop_path(y, generator)


class PatchMerging(nn.Module):
    def __init__(self, dim: int, input_resolution: Tuple[int, int], dtype=torch.float32):
        super().__init__()
        self.resolution = input_resolution
        self.norm = LayerNorm(4 * dim, eps=LN_EPS, out_dtype=dtype)
        self.reduction = Dense(4 * dim, 2 * dim, bias=False, compute_dtype=dtype)

    def forward(self, x):
        h, w_dim = self.resolution
        b, n, c = x.shape
        x = x.reshape(b, h, w_dim, c)
        if h % 2 or w_dim % 2:
            x = F.pad(x, (0, 0, 0, w_dim % 2, 0, h % 2))
        x = torch.cat([x[:, 0::2, 0::2], x[:, 1::2, 0::2], x[:, 0::2, 1::2], x[:, 1::2, 1::2]],
                      dim=-1)
        return self.reduction(self.norm(x.reshape(b, -1, 4 * c)))


class SwinTransformer(nn.Module):
    """Blocks are numbered across stages (``blocks.k``, the JAX tree's
    ``SwinBlock_k``); ``merges.s`` follows stage s. ``dtype`` is the compute
    dtype of the patch embedding and the blocks (module docstring)."""

    def __init__(self, img_size: int = 224, patch_size: int = 4, in_chans: int = 3,
                 num_classes: int = 1000, embed_dim: int = 96,
                 depths: Sequence[int] = (2, 2, 6, 2), num_heads: Sequence[int] = (3, 6, 12, 24),
                 window: int = 7, mlp_ratio: float = 4.0, drop_path_rate: float = 0.1,
                 attn_impl: str = "xla", force_windowed: bool = False, dtype=torch.float32):
        super().__init__()
        self.dtype = dtype
        self.patch_size = patch_size
        self.in_chans = in_chans
        self.embed_dim = embed_dim
        self.patch_embed = nn.Conv2d(in_chans, embed_dim, patch_size, stride=patch_size)
        self.patch_norm = LayerNorm(embed_dim, eps=LN_EPS, out_dtype=dtype)
        dpr = np.linspace(0, drop_path_rate, sum(depths))
        res = (img_size // patch_size,) * 2
        dim = embed_dim
        blocks, merges = [], []
        for stage, (depth, heads) in enumerate(zip(depths, num_heads)):
            for i in range(depth):
                blocks.append(SwinBlock(dim, res, heads, window,
                                        0 if i % 2 == 0 else window // 2, mlp_ratio,
                                        float(dpr[len(blocks)]), attn_impl, force_windowed,
                                        dtype))
            if stage < len(depths) - 1:
                merges.append(PatchMerging(dim, res, dtype))
                res = ((res[0] + 1) // 2, (res[1] + 1) // 2)
                dim *= 2
        self.depths = tuple(depths)
        self.blocks = nn.ModuleList(blocks)
        self.merges = nn.ModuleList(merges)
        self.norm = LayerNorm(dim, eps=LN_EPS)
        self.head = nn.Linear(dim, num_classes)

    def reset_parameters(self, generator: Optional[torch.Generator] = None):
        """The JAX package's init: every Dense and conv kernel and the bias
        tables N(0, 0.02) (``trunc_or_normal``), zero biases, unit/zero
        LayerNorms."""
        for m in self.modules():
            if isinstance(m, (nn.Linear, nn.Conv2d)):
                init.normal_(m.weight, 0.02, generator)
                if m.bias is not None:
                    nn.init.zeros_(m.bias)
            elif isinstance(m, nn.LayerNorm):
                nn.init.ones_(m.weight)
                nn.init.zeros_(m.bias)
            elif isinstance(m, WindowAttention):
                init.normal_(m.rel_bias_table, 0.02, generator)

    def forward(self, x, generator: Optional[torch.Generator] = None):
        """[B, H, W, C] -> logits [B, num_classes]; drop-path is live when
        ``generator`` is given."""
        dt = self.dtype
        w = self.patch_embed.weight.permute(0, 2, 3, 1).reshape(self.embed_dim, -1)
        x = self.patch_norm(F.linear(patchify(x, self.patch_size).to(dt), w.to(dt),
                                     self.patch_embed.bias.to(dt)))
        k = 0
        for stage, depth in enumerate(self.depths):
            for _ in range(depth):
                x = self.blocks[k](x, generator)
                k += 1
            if stage < len(self.merges):
                x = self.merges[stage](x)
        # the final LayerNorm (float32 out), pool and head in float32
        return self.head(self.norm(x).mean(dim=1))


def build_swin(cfg: Config, attn_impl: str = "xla", force_windowed: bool = False
               ) -> SwinTransformer:
    """The config's Swin at ``train.compute_dtype``. A biased attention
    takes the eager path whatever ``attn_impl`` says
    (``ops/attention.multi_head_attention``): the attention kernels take no
    bias, as in the JAX package."""
    s = cfg.swin
    return SwinTransformer(
        img_size=cfg.data.input_size, patch_size=s.patch_size, in_chans=cfg.data.num_channels,
        num_classes=cfg.data.num_classes, embed_dim=s.embed_dim, depths=tuple(s.depths),
        num_heads=tuple(s.num_heads), window=s.window_size, mlp_ratio=float(s.mlp_ratio),
        attn_impl=attn_impl, force_windowed=force_windowed,
        dtype=_DTYPES[cfg.train.compute_dtype],
    )
