"""ViT-SOM: ViT autoencoder + SOM prototypes, in PyTorch.

Counterpart of ``vitsom_tpu/models/vit_som.py``: the SOM input is the
flattened patch tokens (``use_reduced=False``, all shipped configs) or the
CLS token; the prototypes are a trainable [P, latent] parameter. The
classifier head (``num_classes > 0``) is a later slice of the port.
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from vitsom_tpu_torch.config import Config
from vitsom_tpu_torch.models.vit import build_vit_autoencoder, unpatchify
from vitsom_tpu_torch.som import layer as som
from vitsom_tpu_torch.utils.device import resolve_device


def model_attn_impl(cfg: Config) -> str:
    """``train.attn_impl``, or the impl ``use_pallas_attention`` implies."""
    return cfg.train.attn_impl or ("pallas" if cfg.train.use_pallas_attention else "xla")


class ViTSOM(nn.Module):
    def __init__(self, cfg: Config, attn_impl: str = "xla"):
        super().__init__()
        if cfg.classification:
            raise NotImplementedError(
                "ViT-SOM classification is not ported yet (ROADMAP Queue 1 item 9)"
            )
        self.cfg = cfg
        self.vit = build_vit_autoencoder(cfg, attn_impl=attn_impl)
        self.prototypes = nn.Parameter(
            torch.zeros(cfg.som.n_prototypes, cfg.som_latent_dim())
        )

    def reset_parameters(self, generator: Optional[torch.Generator] = None):
        self.vit.reset_parameters(generator)
        with torch.no_grad():
            self.prototypes.copy_(
                som.init_prototypes(self.cfg.som, self.cfg.som_latent_dim(), generator)
            )

    def som_input(self, cls_token, patch_tokens):
        """[B, N*D] latent in (token, channel) order, or the CLS token."""
        if self.cfg.som.use_reduced:
            return cls_token
        return patch_tokens.reshape(patch_tokens.shape[0], -1)

    def forward(self, x):
        """(cls_token, recon, logits, distances, bmu) on the plain SOM path."""
        cls_token, patches, recon = self.vit(x)
        z = self.som_input(cls_token, patches)
        distances = som.compute_distances(z, self.prototypes, self.cfg.som.distance_fcn)
        return cls_token, recon, None, distances, som.bmu(distances)

    def features(self, x):
        """(cls_token, recon, logits, z) without the distance matrix: the
        entry of the fused SOM op, which takes ``z`` and the prototypes."""
        cls_token, patches, recon = self.vit(x)
        return cls_token, recon, None, self.som_input(cls_token, patches)

    def decode_prototypes(self, prototypes):
        """[P, N*D] -> [P, H, W, C] images through one decoder call (a zero
        CLS token is prepended)."""
        p_count = prototypes.shape[0]
        emb = self.cfg.vit.emb_dim
        tokens = prototypes.reshape(p_count, self.vit.num_patches, emb)
        cls = torch.zeros((p_count, 1, emb), dtype=tokens.dtype, device=tokens.device)
        pred = self.vit.forward_decoder(torch.cat([cls, tokens], dim=1))
        return unpatchify(pred, self.cfg.vit.patch_size, self.cfg.data.num_channels)


def build_vit_som(cfg: Config, device="cuda", seed: int = 0) -> ViTSOM:
    """A freshly initialised ``ViTSOM`` on ``device`` (default: the card).

    The weights are drawn on the CPU from ``torch.Generator().manual_seed(
    seed)`` and then moved, so a seed gives the same model on any device."""
    dev = resolve_device(device)
    model = ViTSOM(cfg, attn_impl=model_attn_impl(cfg))
    model.reset_parameters(torch.Generator().manual_seed(seed))
    return model.to(dev)
