"""ViT-SOM (ViT autoencoder + SOM prototypes + optional classifier head) and
the ViT classification baseline, in PyTorch.

Counterpart of ``vitsom_tpu/models/vit_som.py``: the SOM input is the
flattened patch tokens (``use_reduced=False``, all shipped configs) or the
CLS token; the prototypes are a trainable [P, latent] parameter; with
``data.num_classes > 0`` a linear head (``ClsHead``) maps the CLS token to
logits. ``ViTClassifier`` is the baseline of ``model_arch: vit``: the same
encoder and head, no decoder and no SOM. ``build_model`` also builds
``models/desom.DESOM`` and the baselines (``models/swin.py``,
``models/deit.py``, ``models/mobile_vit.py``).
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from vitsom_tpu_torch.config import Config
from vitsom_tpu_torch.models.deit import DeiT
from vitsom_tpu_torch.models.desom import DESOM
from vitsom_tpu_torch.models.mobile_vit import build_mobilevit_s
from vitsom_tpu_torch.models.swin import build_swin
from vitsom_tpu_torch.models.vit import ClsHead, build_vit_autoencoder, unpatchify
from vitsom_tpu_torch.som import layer as som
from vitsom_tpu_torch.utils.device import resolve_device


def model_attn_impl(cfg: Config) -> str:
    """``train.attn_impl``, or the impl ``use_pallas_attention`` implies;
    ``pallas`` and ``hybrid`` become ``xla`` for Swin (its attention has a
    bias) and DeiT (dropout on the probabilities), whose attention the
    kernels cannot compute, as in the JAX package."""
    impl = cfg.train.attn_impl or ("pallas" if cfg.train.use_pallas_attention else "xla")
    if cfg.model_arch in ("swin", "deit") and impl in ("pallas", "hybrid"):
        return "xla"
    return impl


class ViTSOM(nn.Module):
    def __init__(self, cfg: Config, attn_impl: str = "xla"):
        super().__init__()
        self.cfg = cfg
        self.vit = build_vit_autoencoder(cfg, attn_impl=attn_impl)
        self.prototypes = nn.Parameter(
            torch.zeros(cfg.som.n_prototypes, cfg.som_latent_dim())
        )
        self.cls_head = (
            ClsHead(cfg.vit.emb_dim, cfg.data.num_classes) if cfg.classification else None
        )

    def reset_parameters(self, generator: Optional[torch.Generator] = None):
        self.vit.reset_parameters(generator)
        with torch.no_grad():
            self.prototypes.copy_(
                som.init_prototypes(self.cfg.som, self.cfg.som_latent_dim(), generator)
            )
        if self.cls_head is not None:
            self.cls_head.reset_parameters(generator)

    def som_input(self, cls_token, patch_tokens):
        """[B, N*D] latent in (token, channel) order, or the CLS token."""
        if self.cfg.som.use_reduced:
            return cls_token
        return patch_tokens.reshape(patch_tokens.shape[0], -1)

    def logits(self, cls_token):
        return self.cls_head(cls_token) if self.cls_head is not None else None

    def forward(self, x):
        """(cls_token, recon, logits, distances, bmu) on the plain SOM path."""
        cls_token, patches, recon = self.vit(x)
        z = self.som_input(cls_token, patches)
        distances = som.compute_distances(z, self.prototypes, self.cfg.som.distance_fcn)
        return cls_token, recon, self.logits(cls_token), distances, som.bmu(distances)

    def features(self, x):
        """(cls_token, recon, logits, z) without the distance matrix: the
        entry of the fused SOM op, which takes ``z`` and the prototypes."""
        cls_token, patches, recon = self.vit(x)
        return cls_token, recon, self.logits(cls_token), self.som_input(cls_token, patches)

    def encode(self, x):
        """(logits, z) from the encoder alone. The classification train
        step's loss reads no reconstruction, so XLA drops the decoder from
        the JAX step; this is the port's counterpart of that step's
        forward (the decoder's parameters get zero gradients there)."""
        tokens = self.vit.encode_tokens(x)
        cls_token = tokens[:, 0]
        return self.logits(cls_token), self.som_input(cls_token, tokens[:, 1:])

    def get_latent_representation(self, x):
        """[B, N*D] SOM input (or the CLS token) from the encoder alone: the
        latent of the UMAP figure. The JAX model runs the whole autoencoder
        and XLA drops the unused decoder; here it is never run."""
        tokens = self.vit.encode_tokens(x)
        return self.som_input(tokens[:, 0], tokens[:, 1:])

    def decode_prototypes(self, prototypes):
        """[P, N*D] -> [P, H, W, C] images through one decoder call (a zero
        CLS token is prepended)."""
        p_count = prototypes.shape[0]
        emb = self.cfg.vit.emb_dim
        tokens = prototypes.reshape(p_count, self.vit.num_patches, emb)
        cls = torch.zeros((p_count, 1, emb), dtype=tokens.dtype, device=tokens.device)
        pred = self.vit.forward_decoder(torch.cat([cls, tokens], dim=1))
        return unpatchify(pred, self.cfg.vit.patch_size, self.cfg.data.num_channels)


class ViTClassifier(nn.Module):
    """The ViT classification baseline (``model_arch: vit``): the ViT-SOM
    encoder, CLS token -> ``ClsHead``. The JAX model never calls its
    decoder, so it has no decoder parameters, and neither has this one."""

    def __init__(self, cfg: Config, attn_impl: str = "xla"):
        super().__init__()
        if not cfg.classification:
            raise ValueError("ViTClassifier needs data.num_classes > 0")
        self.cfg = cfg
        self.vit = build_vit_autoencoder(cfg, attn_impl=attn_impl, decoder=False)
        self.cls_head = ClsHead(cfg.vit.emb_dim, cfg.data.num_classes)

    def reset_parameters(self, generator: Optional[torch.Generator] = None):
        self.vit.reset_parameters(generator)
        self.cls_head.reset_parameters(generator)

    def forward(self, x):
        """Logits [B, num_classes]."""
        return self.cls_head(self.vit.forward_features(x))


# model_arch -> a builder of the model from the config
_MODELS = {
    "vit_som": lambda cfg: ViTSOM(cfg, attn_impl=model_attn_impl(cfg)),
    "vit": lambda cfg: ViTClassifier(cfg, attn_impl=model_attn_impl(cfg)),
    "desom": DESOM,
    "swin": lambda cfg: build_swin(cfg, attn_impl=model_attn_impl(cfg)),
    "deit": lambda cfg: DeiT(cfg, attn_impl=model_attn_impl(cfg)),
    "mobile_vit": build_mobilevit_s,
}


def build_model(cfg: Config, device="cuda", seed: int = 0) -> nn.Module:
    """A freshly initialised ``ViTSOM`` (``model_arch: vit_som``),
    ``ViTClassifier`` (``vit``), ``DESOM`` (``desom``, in
    ``models/desom.py``; it takes flattened images), ``SwinTransformer``
    (``swin``, ``models/swin.py``), ``DeiT`` (``deit``, the student,
    ``models/deit.py``) or ``MobileViTS`` (``mobile_vit``,
    ``models/mobile_vit.py``) on ``device`` (default: the card).

    The weights are drawn on the CPU from ``torch.Generator().manual_seed(
    seed)`` and then moved, so a seed gives the same model on any device."""
    if cfg.model_arch not in _MODELS:
        raise NotImplementedError(f"model_arch {cfg.model_arch} is not ported yet")
    dev = resolve_device(device)
    model = _MODELS[cfg.model_arch](cfg)
    model.reset_parameters(torch.Generator().manual_seed(seed))
    return model.to(dev)
