"""ViT autoencoder (MAE-style, unmasked) in PyTorch.

Counterpart of ``vitsom_tpu/models/vit.py``: encoder = patch embedding +
fixed 2D sincos positions + CLS token + pre-norm transformer blocks; decoder
= linear embed + sincos + blocks + per-patch pixel head + unpatchify.
Images are NHWC at the public functions, as in the JAX package, and
patchify/unpatchify keep the (p, q, c) intra-patch order.

Blocks are deterministic: the reference Block ignores its configs'
``drop_path`` and every dropout knob is 0 in the shipped configs.

``train.compute_dtype: bfloat16`` follows the casts of the JAX package's
mixed precision exactly: parameters stay float32; the patch embedding, every
dense layer and the residual stream compute in bf16 (Flax ``Dense(dtype=
bf16)`` casts input, kernel and bias); the block LayerNorms compute their
statistics and arithmetic in float32 and cast the output to bf16 (Flax
``LayerNorm(dtype=bf16)``), the encoder and decoder norms output float32
(no dtype); the sincos tables are cast to bf16 at the point of use; tokens
leave ``encode_tokens`` as float32 (so the SOM and its kernel see float32)
and the reconstruction is cast to float32.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from vitsom_tpu_torch.ops import attention as attention_ops
from vitsom_tpu_torch.ops.pos_embed import get_2d_sincos_pos_embed
from vitsom_tpu_torch.utils import initializers as init

LN_EPS = 1e-6  # reference uses partial(nn.LayerNorm, eps=1e-6)

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


class Dense(nn.Linear):
    """``nn.Linear`` that computes in ``compute_dtype``: input, weight and
    bias cast to it, as Flax's ``Dense(dtype=...)`` promotes them (float32:
    a plain ``nn.Linear``)."""

    def __init__(self, in_features, out_features, bias=True, compute_dtype=torch.float32):
        super().__init__(in_features, out_features, bias=bias)
        self.compute_dtype = compute_dtype

    def forward(self, x):
        dt = self.compute_dtype
        bias = None if self.bias is None else self.bias.to(dt)
        return F.linear(x.to(dt), self.weight.to(dt), bias)


class LayerNorm(nn.LayerNorm):
    """LayerNorm whose statistics and arithmetic run in float32 whatever the
    input's dtype, with the output cast to ``out_dtype``: Flax's
    ``LayerNorm(dtype=...)`` (float32 in and out: a plain ``nn.LayerNorm``)."""

    def __init__(self, dim, eps=LN_EPS, out_dtype=torch.float32):
        super().__init__(dim, eps=eps)
        self.out_dtype = out_dtype

    def forward(self, x):
        return super().forward(x.float()).to(self.out_dtype)


def patchify(imgs: torch.Tensor, patch_size: int) -> torch.Tensor:
    """[B, H, W, C] -> [B, h*w, p*p*C] with (p, q, c) intra-patch order."""
    b, hh, ww, c = imgs.shape
    p = patch_size
    h, w = hh // p, ww // p
    x = imgs.reshape(b, h, p, w, p, c).permute(0, 1, 3, 2, 4, 5)  # [B, h, w, p, q, c]
    return x.reshape(b, h * w, p * p * c)


def unpatchify(x: torch.Tensor, patch_size: int, channels: int) -> torch.Tensor:
    """[B, h*w, p*p*C] -> [B, H, W, C]."""
    b, n, _ = x.shape
    p = patch_size
    h = w = int(round(n**0.5))
    if h * w != n:
        raise ValueError(f"non-square patch grid of {n} patches")
    x = x.reshape(b, h, w, p, p, channels).permute(0, 1, 3, 2, 4, 5)  # [B, h, p, w, q, c]
    return x.reshape(b, h * p, w * p, channels)


class Mlp(nn.Module):
    def __init__(self, dim: int, hidden_dim: int, out_dim: int, dtype=torch.float32):
        super().__init__()
        self.fc1 = Dense(dim, hidden_dim, compute_dtype=dtype)
        self.fc2 = Dense(hidden_dim, out_dim, compute_dtype=dtype)

    def forward(self, x):
        return self.fc2(F.gelu(self.fc1(x), approximate="none"))


class Attention(nn.Module):
    """Multi-head self-attention. Below dim 128 one fused qkv projection
    (output reshaped [B, N, 3, H, hd]); at dim >= 128 separate q/k/v
    projections, as the JAX package lays them out."""

    def __init__(self, dim: int, num_heads: int, qkv_bias: bool = True, attn_impl: str = "xla",
                 dtype=torch.float32):
        super().__init__()
        self.dim = dim
        self.num_heads = num_heads
        self.attn_impl = attn_impl
        self.compute_dtype = dtype
        self.split_qkv = dim >= 128
        if self.split_qkv:
            self.query = Dense(dim, dim, bias=qkv_bias, compute_dtype=dtype)
            self.key = Dense(dim, dim, bias=qkv_bias, compute_dtype=dtype)
            self.value = Dense(dim, dim, bias=qkv_bias, compute_dtype=dtype)
        else:
            self.qkv = Dense(dim, dim * 3, bias=qkv_bias, compute_dtype=dtype)
        self.proj = Dense(dim, dim, compute_dtype=dtype)

    def forward(self, x, return_attn: bool = False):
        b, n, c = x.shape
        head_dim = self.dim // self.num_heads
        if self.split_qkv:
            q, k, v = (
                lin(x).reshape(b, n, self.num_heads, head_dim)
                for lin in (self.query, self.key, self.value)
            )
        else:
            qkv = self.qkv(x).reshape(b, n, 3, self.num_heads, head_dim)
            q, k, v = qkv[:, :, 0], qkv[:, :, 1], qkv[:, :, 2]
        out, attn = attention_ops.multi_head_attention(
            q, k, v, impl=self.attn_impl, return_attn=return_attn
        )
        return self.proj(out.reshape(b, n, c).to(self.compute_dtype)), attn


class Block(nn.Module):
    """Pre-norm transformer block."""

    def __init__(self, dim, num_heads, mlp_ratio=4.0, qkv_bias=True, attn_impl="xla",
                 dtype=torch.float32):
        super().__init__()
        self.norm1 = LayerNorm(dim, eps=LN_EPS, out_dtype=dtype)
        self.attn = Attention(dim, num_heads, qkv_bias=qkv_bias, attn_impl=attn_impl, dtype=dtype)
        self.norm2 = LayerNorm(dim, eps=LN_EPS, out_dtype=dtype)
        self.mlp = Mlp(dim, int(dim * mlp_ratio), dim, dtype=dtype)

    def forward(self, x):
        x = x + self.attn(self.norm1(x))[0]
        return x + self.mlp(self.norm2(x))


class ViTAutoencoder(nn.Module):
    """Unmasked MAE-style autoencoder."""

    def __init__(
        self,
        img_size: int = 224,
        patch_size: int = 16,
        in_chans: int = 3,
        embed_dim: int = 768,
        depth: int = 12,
        num_heads: int = 12,
        decoder_embed_dim: int = 512,
        decoder_depth: int = 8,
        decoder_num_heads: int = 16,
        mlp_ratio: float = 4.0,
        qkv_bias: bool = True,
        attn_impl: str = "xla",
        remat: bool = False,
        dtype=torch.float32,
    ):
        super().__init__()
        self.patch_size = patch_size
        self.in_chans = in_chans
        self.embed_dim = embed_dim
        self.remat = remat
        self.compute_dtype = dtype
        grid = img_size // patch_size
        self.num_patches = grid * grid
        self.register_buffer(
            "pos_embed",
            torch.from_numpy(get_2d_sincos_pos_embed(embed_dim, grid, cls_token=True)[None]),
            persistent=False,
        )
        self.register_buffer(
            "dec_pos_embed",
            torch.from_numpy(get_2d_sincos_pos_embed(decoder_embed_dim, grid, cls_token=True)[None]),
            persistent=False,
        )
        # holds the OIHW patch-embed weight; applied as patchify + linear
        # (the same function as the strided conv, with no cuDNN algorithm
        # choice and no TF32 in it)
        self.patch_proj = nn.Conv2d(in_chans, embed_dim, patch_size, stride=patch_size)
        self.cls_token = nn.Parameter(torch.zeros(1, 1, embed_dim))
        self.blocks = nn.ModuleList(
            Block(embed_dim, num_heads, mlp_ratio, qkv_bias, attn_impl, dtype)
            for _ in range(depth)
        )
        # no dtype in the JAX package: float32 out whatever comes in
        self.encoder_norm = LayerNorm(embed_dim, eps=LN_EPS)
        self.decoder_embed = Dense(embed_dim, decoder_embed_dim, compute_dtype=dtype)
        self.decoder_blocks = nn.ModuleList(
            Block(decoder_embed_dim, decoder_num_heads, mlp_ratio, qkv_bias, attn_impl, dtype)
            for _ in range(decoder_depth)
        )
        self.decoder_norm = LayerNorm(decoder_embed_dim, eps=LN_EPS)
        self.decoder_pred = Dense(decoder_embed_dim, patch_size**2 * in_chans, compute_dtype=dtype)

    def reset_parameters(self, generator: Optional[torch.Generator] = None):
        """The JAX package's init distributions: xavier-uniform Linears with
        zero bias, xavier-as-linear patch embedding with torch-default bias,
        N(0, 0.02) CLS token, unit/zero LayerNorms."""
        for m in self.modules():
            if isinstance(m, nn.Linear):
                init.xavier_uniform_(m.weight, generator)
                if m.bias is not None:
                    nn.init.zeros_(m.bias)
            elif isinstance(m, nn.LayerNorm):
                nn.init.ones_(m.weight)
                nn.init.zeros_(m.bias)
        for m in self.modules():
            if isinstance(m, Attention) and m.split_qkv:
                # the distribution of the fused [dim, 3*dim] matrix they replace
                for lin in (m.query, m.key, m.value):
                    init.xavier_uniform_(lin.weight, generator, fans=(m.dim, 3 * m.dim))
        init.conv_xavier_as_linear_(self.patch_proj.weight, generator)
        init.torch_default_bias_(
            self.patch_proj.bias, self.in_chans * self.patch_size**2, generator
        )
        init.normal_(self.cls_token, 0.02, generator)

    def _block(self, blk: Block, x):
        if self.remat and torch.is_grad_enabled():
            # recompute the block in the backward pass instead of keeping
            # its [B, H, N, N] residuals; the numerics are identical. The
            # blocks draw no random numbers (module docstring), so not
            # saving and restoring the RNG state is exact, and it keeps the
            # step capturable (reading the CUDA RNG state is refused while
            # a graph is being captured)
            return checkpoint(blk, x, use_reentrant=False, preserve_rng_state=False)
        return blk(x)

    # --- encoder ---

    def patch_embed(self, x):
        """[B, H, W, C] -> [B, h*w, D]."""
        dt = self.compute_dtype
        w = self.patch_proj.weight.permute(0, 2, 3, 1).reshape(self.embed_dim, -1)
        return F.linear(patchify(x, self.patch_size).to(dt), w.to(dt), self.patch_proj.bias.to(dt))

    def encode_tokens(self, x):
        """[B, H, W, C] -> token sequence [B, 1+N, D] after the final norm,
        float32 whatever the compute dtype."""
        dt = self.compute_dtype
        x = self.patch_embed(x) + self.pos_embed[:, 1:, :].to(dt)
        b = x.shape[0]
        cls = (self.cls_token + self.pos_embed[:, :1, :]).to(dt).expand(b, 1, self.embed_dim)
        x = torch.cat([cls, x], dim=1)
        for blk in self.blocks:
            x = self._block(blk, x)
        return self.encoder_norm(x)

    # --- decoder ---

    def forward_decoder(self, tokens):
        """Token sequence [B, 1+N, D] -> per-patch pixels [B, N, p*p*C],
        float32."""
        d = self.decoder_embed(tokens) + self.dec_pos_embed.to(self.compute_dtype)
        for blk in self.decoder_blocks:
            d = self._block(blk, d)
        return self.decoder_pred(self.decoder_norm(d))[:, 1:, :].float()

    def forward(self, x):
        """Returns (cls_token, patch_tokens, recon NHWC)."""
        tokens = self.encode_tokens(x)
        pred = self.forward_decoder(tokens)
        return tokens[:, 0], tokens[:, 1:], unpatchify(pred, self.patch_size, self.in_chans)


def build_vit_autoencoder(cfg, attn_impl: str = "xla") -> ViTAutoencoder:
    """Construct from a ``Config``; decoder heads = encoder heads, as the
    reference wires it. ``train.compute_dtype`` selects the compute dtype
    (module docstring); parameters stay float32."""
    return ViTAutoencoder(
        img_size=cfg.data.input_size,
        patch_size=cfg.vit.patch_size,
        in_chans=cfg.data.num_channels,
        embed_dim=cfg.vit.emb_dim,
        depth=cfg.vit.depth,
        num_heads=cfg.vit.heads,
        decoder_embed_dim=cfg.vit.dec_emb_dim,
        decoder_depth=cfg.vit.dec_depth,
        decoder_num_heads=cfg.vit.heads,
        mlp_ratio=float(cfg.vit.mlp_ratio),
        qkv_bias=cfg.vit.qkv_bias,
        attn_impl=attn_impl,
        remat=cfg.train.remat_blocks,
        dtype=_DTYPES[cfg.train.compute_dtype],
    )
