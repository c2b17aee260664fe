"""Multi-head attention dispatch.

Counterpart of ``vitsom_tpu/ops/attention.py``. The ``"xla"`` path is plain
eager attention in float32: two batched products and a softmax, which the
JAX package leaves to XLA outside any Pallas kernel. ``"pallas"`` runs the
hand-written CUDA forward and backward kernels (``attention_fused``);
``"hybrid"`` pairs the eager forward with the backward kernel. The bf16
impls keep their names so that configs read the same; they are a later
slice of the port (ROADMAP.md Queue 1, bf16 compute path).
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from vitsom_tpu_torch.ops.attention_fused import (
    FusedAttention, fused_attention, fused_attention_reference,
)

_LATER = {
    "xla_bf16": "the bf16 compute path (ROADMAP Queue 1, bf16 attention)",
    "xla_bf16s": "the bf16 compute path (ROADMAP Queue 1, bf16 attention)",
}


def xla_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    return_attn: bool = False,
    bias: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """q, k, v: [B, N, H, hd] -> out [B, N, H, hd] (+ optional [B, H, N, N]).

    ``bias``: optional additive [H, N, N] (or broadcastable) term applied to
    the scaled scores before the softmax."""
    head_dim = q.shape[-1]
    scale = head_dim**-0.5
    scores = torch.einsum("bnhd,bmhd->bhnm", q, k) * scale
    if bias is not None:
        scores = scores + bias.to(scores.dtype)[None]
    attn = torch.softmax(scores, dim=-1)
    out = torch.einsum("bhnm,bmhd->bnhd", attn.to(v.dtype), v)
    return out, (attn if return_attn else None)


class HybridAttention(FusedAttention):
    """Eager forward, backward kernel: the JAX package's ``hybrid_attention``.

    The forward has the numerics of ``_hybrid_fwd`` (max, exp, denominator,
    ``p / denom``, ``lse = m + log(denom)``), which is the forward kernel's
    plain version, run eagerly on any device. Inside an autograd.Function
    it records no graph, so only the [B, N, D]-sized residuals (q, k, v, o)
    and lse [B, H, N] are kept; the backward (inherited) launches the
    backward kernel on the card."""

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
    if impl == "pallas" and not return_attn and bias is None:
        return fused_attention(q, k, v), None
    if impl == "hybrid" and not return_attn and bias is None:
        return hybrid_attention(q, k, v), None
    if impl not in ("xla", "pallas", "hybrid") and not return_attn:
        if impl in _LATER:
            raise NotImplementedError(
                f"attn_impl={impl!r} is not ported yet; it arrives with {_LATER[impl]}"
            )
        raise ValueError(f"unknown attention impl {impl!r}")
    return xla_attention(q, k, v, return_attn=return_attn, bias=bias)
