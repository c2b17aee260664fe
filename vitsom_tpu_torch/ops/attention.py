"""Multi-head attention dispatch.

Counterpart of ``vitsom_tpu/ops/attention.py``. The ``"xla"`` path is plain
eager attention with float32 scores: two batched products and a softmax,
which the JAX package leaves to XLA outside any Pallas kernel.
``"pallas"`` runs the hand-written CUDA forward and backward kernels
(``attention_fused``); ``"hybrid"`` pairs the eager forward with the
backward kernel. Both take float32 or bf16 q, k, v (``compute_dtype:
bfloat16``), the bf16 kernels at the JAX kernels' rounding points. The bf16
impls are XLA ops in the JAX package, so they are torch ops here, not
kernels: ``"xla_bf16"`` (bf16 scores and a bf16 softmax) and
``"xla_bf16s"`` (bf16 scores and probs, float32 softmax arithmetic, a
custom backward that keeps only the bf16 probs).
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from vitsom_tpu_torch.ops.attention_fused import (
    FusedAttention, fused_attention, fused_attention_reference,
)


def xla_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    return_attn: bool = False,
    bias: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """q, k, v: [B, N, H, hd] -> out [B, N, H, hd] (+ optional [B, H, N, N]).

    ``bias``: optional additive [H, N, N] (or broadcastable) term applied to
    the scaled scores before the softmax. The scores and the output are
    float32 whatever the inputs' dtype: bf16 inputs (``compute_dtype:
    bfloat16``) enter both products upcast, which is exact for the products
    and gives the float32 accumulation of the JAX version's
    ``preferred_element_type``; the probs are cast to v's dtype between
    them, as there."""
    head_dim = q.shape[-1]
    scale = head_dim**-0.5
    scores = torch.einsum("bnhd,bmhd->bhnm", q.float(), k.float()) * scale
    if bias is not None:
        scores = scores + bias.to(scores.dtype)[None]
    attn = torch.softmax(scores, dim=-1)
    out = torch.einsum("bhnm,bmhd->bnhd", attn.to(v.dtype).float(), v.float())
    return out, (attn if return_attn else None)


def _bf16_scores(q, k, bias):
    """[B, H, N, N] bf16 scores of bf16 ``q * scale`` and k: one rounding of
    a float32-accumulated product (a bias is added in float32 before it)."""
    scale = q.shape[-1] ** -0.5
    qb = (q * scale).to(torch.bfloat16)
    kb = k.to(torch.bfloat16)
    if bias is None:
        return torch.einsum("bnhd,bmhd->bhnm", qb, kb)
    scores = torch.einsum("bnhd,bmhd->bhnm", qb.float(), kb.float())
    return (scores + bias.float()[None]).to(torch.bfloat16)


def xla_attention_bf16_scores(q, k, v, bias=None) -> Tuple[torch.Tensor, None]:
    """``vitsom_tpu/ops/attention.py:xla_attention_bf16_scores``: the scale
    folded into q, bf16 [B, H, N, N] scores, a bf16 softmax (torch's bf16
    softmax computes in float32 and rounds its output once; XLA's rounds
    between its steps), and a bf16 product with v accumulated in float32.
    Returns the output as float32, as the JAX version does (its values are
    bf16-rounded, the model casts them to bf16 next)."""
    attn = torch.softmax(_bf16_scores(q, k, bias), dim=-1)
    out = torch.einsum("bhnm,bmhd->bnhd", attn, v.to(torch.bfloat16))
    return out.float(), None


class SoftmaxF32MathBf16Store(torch.autograd.Function):
    """``_softmax_f32math_bf16store``: softmax over a bf16 tensor in float32
    arithmetic with a bf16 output. The only saved tensor is the bf16 probs;
    the backward is ``p (g - sum(g p))`` in float32 arithmetic with a bf16
    result, the JAX custom VJP's."""

    @staticmethod
    def forward(ctx, scores):
        probs = torch.softmax(scores.float(), dim=-1).to(torch.bfloat16)
        ctx.save_for_backward(probs)
        return probs

    @staticmethod
    def backward(ctx, g):
        (probs,) = ctx.saved_tensors
        pf = probs.float()
        gf = g.float()
        inner = torch.sum(gf * pf, dim=-1, keepdim=True)
        return (pf * (gf - inner)).to(torch.bfloat16)


def xla_attention_bf16_store(q, k, v, bias=None) -> Tuple[torch.Tensor, None]:
    """``vitsom_tpu/ops/attention.py:xla_attention_bf16_store``: bf16 scores
    and probs in memory, the softmax's arithmetic in float32
    (``SoftmaxF32MathBf16Store``). Returns the output as float32."""
    attn = SoftmaxF32MathBf16Store.apply(_bf16_scores(q, k, bias))
    out = torch.einsum("bhnm,bmhd->bnhd", attn, v.to(torch.bfloat16))
    return out.float(), None


class HybridAttention(FusedAttention):
    """Eager forward, backward kernel: the JAX package's ``hybrid_attention``.

    The forward has the numerics of ``_hybrid_fwd`` (max, exp, denominator,
    ``p / denom``, ``lse = m + log(denom)``), which is the forward kernel's
    plain version, run eagerly on any device. Inside an autograd.Function
    it records no graph, so only the [B, N, D]-sized residuals (q, k, v, o)
    and lse [B, H, N] are kept; the backward (inherited) launches the
    backward kernel on the card. bf16 inputs give ``_hybrid_fwd``'s float32
    output (bf16 attn times bf16 v, accumulated in float32), which is also
    the o the bf16 backward kernel receives, with its float32 cotangent."""

    @staticmethod
    def forward(ctx, q, k, v, heads):
        o, lse = fused_attention_reference(q, k, v, heads)
        ctx.save_for_backward(q, k, v, o, lse)
        ctx.heads = heads
        return o


def hybrid_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """q, k, v: [B, N, H, hd] -> out [B, N, H, hd]."""
    b, n, h, hd = q.shape
    o = HybridAttention.apply(*(x.reshape(b, n, h * hd) for x in (q, k, v)), h)
    return o.reshape(b, n, h, hd)


def multi_head_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    impl: str = "xla",
    return_attn: bool = False,
    bias: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """Dispatch over attention implementations, as the JAX package does.

    ``return_attn=True`` takes the float32 :func:`xla_attention` path
    whatever ``impl`` says (offline visualisation only), and so does a
    ``bias`` with ``pallas``/``hybrid``, whose kernels take none."""
    if impl in ("pallas", "hybrid") and not return_attn and bias is None:
        if impl == "pallas":
            return fused_attention(q, k, v), None
        return hybrid_attention(q, k, v), None
    if impl == "xla_bf16" and not return_attn:
        return xla_attention_bf16_scores(q, k, v, bias=bias)
    if impl == "xla_bf16s" and not return_attn:
        return xla_attention_bf16_store(q, k, v, bias=bias)
    if impl not in ("xla", "pallas", "hybrid", "xla_bf16", "xla_bf16s"):
        raise ValueError(f"unknown attention impl {impl!r}")
    return xla_attention(q, k, v, return_attn=return_attn, bias=bias)
