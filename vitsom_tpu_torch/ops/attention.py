"""Multi-head attention dispatch.

Counterpart of ``vitsom_tpu/ops/attention.py``. The ``"xla"`` path is plain
eager attention in float32: two batched products and a softmax, which the
JAX package leaves to XLA outside any Pallas kernel. The other ``impl`` keys
keep their names so that configs read the same; their kernels are later
items of the port (ROADMAP.md Queue 2 items 2-3, Queue 1 item 4).
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

_LATER = {
    "pallas": "the hand-written attention forward/backward kernels (ROADMAP Queue 2 items 2-3)",
    "hybrid": "the attention backward kernel (ROADMAP Queue 2 item 3)",
    "xla_bf16": "the bf16 compute path (ROADMAP Queue 1 item 4, bf16 attention)",
    "xla_bf16s": "the bf16 compute path (ROADMAP Queue 1 item 4, bf16 attention)",
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


def multi_head_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    impl: str = "xla",
    return_attn: bool = False,
    bias: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """Dispatch over attention implementations; only ``"xla"`` is ported.

    As in the JAX package, ``return_attn=True`` takes the float32
    :func:`xla_attention` path whatever ``impl`` says (offline visualisation
    only)."""
    if impl != "xla" and not return_attn:
        if impl in _LATER:
            raise NotImplementedError(
                f"attn_impl={impl!r} is not ported yet; it arrives with {_LATER[impl]}"
            )
        raise ValueError(f"unknown attention impl {impl!r}")
    return xla_attention(q, k, v, return_attn=return_attn, bias=bias)
