"""DESOM: the MLP autoencoder with a SOM on its bottleneck latent, in
PyTorch.

Counterpart of ``vitsom_tpu/models/desom.py``: the encoder's latent (10-d
in the shipped configs) feeds the SOM, whose prototypes are a trainable
[P, latent] parameter (``som/layer.py`` ``init_prototypes``); the decoder
reconstructs the flattened input; with ``data.num_classes > 0`` a linear
classifier maps the latent to logits, with torch's default Linear init
(``variance_scaling(1/3, fan_in, uniform)``: U(+-1/sqrt(fan_in)) for the
weight and the bias). The input is flattened, [B, C*H*W], as the train
step flattens it.

The SOM distances are the plain ones (``som.compute_distances``; the
shipped configs' manhattan): the JAX package has no kernel for them either.
``train`` selects BatchNorm's batch statistics (the train step) or its
running averages (every other call), as Flax's ``train`` argument does.
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from vitsom_tpu_torch.config import Config
from vitsom_tpu_torch.models.ae import build_autoencoder
from vitsom_tpu_torch.som import layer as som
from vitsom_tpu_torch.utils import initializers


class DESOM(nn.Module):
    def __init__(self, cfg: Config):
        super().__init__()
        self.cfg = cfg
        latent = cfg.som_latent_dim()
        self.autoencoder = build_autoencoder(cfg)
        self.prototypes = nn.Parameter(torch.zeros(cfg.som.n_prototypes, latent))
        self.classifier = (nn.Linear(latent, cfg.data.num_classes)
                           if cfg.classification else None)

    def reset_parameters(self, generator: Optional[torch.Generator] = None) -> None:
        self.autoencoder.reset_parameters(generator)
        latent = self.cfg.som_latent_dim()
        with torch.no_grad():
            self.prototypes.copy_(som.init_prototypes(self.cfg.som, latent, generator))
        if self.classifier is not None:
            # variance_scaling(1/3, fan_in, uniform): bound sqrt(3 / 3 / fan_in)
            initializers.torch_default_bias_(self.classifier.weight, latent, generator)
            initializers.torch_default_bias_(self.classifier.bias, latent, generator)

    def _som(self, z: torch.Tensor):
        distances = som.compute_distances(z, self.prototypes, self.cfg.som.distance_fcn)
        logits = self.classifier(z) if self.classifier is not None else None
        return logits, distances, som.bmu(distances)

    def forward(self, x: torch.Tensor, train: bool = False):
        """x: flattened [B, C*H*W]. Returns (logits or None, z, distances, bmu)."""
        z = self.autoencoder.encode(x, train)
        logits, distances, bmu_idx = self._som(z)
        return logits, z, distances, bmu_idx

    def forward_with_recon(self, x: torch.Tensor, train: bool = False):
        """(logits or None, z, distances, bmu, decoded): the train step's one
        pass, decoding the latent too."""
        z = self.autoencoder.encode(x, train)
        logits, distances, bmu_idx = self._som(z)
        return logits, z, distances, bmu_idx, self.autoencoder.decode(z, train)

    def decode(self, z: torch.Tensor, train: bool = False) -> torch.Tensor:
        return self.autoencoder.decode(z, train)
