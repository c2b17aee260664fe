"""Fully-connected symmetric autoencoder in PyTorch, with Flax's BatchNorm.

Counterpart of ``vitsom_tpu/models/ae.py``: the encoder maps the flattened
input [B, C*H*W] through ``[C*H*W] + encoder_dims`` with the configured
activation (and an optional BatchNorm before it) between layers and none
after the bottleneck; the decoder mirrors the dims. Weights are
Xavier-uniform and biases torch's default uniform, drawn by
``reset_parameters`` from an explicit ``torch.Generator``.

Module names follow the Flax tree (``encoder.dense_i``, ``encoder.bn_i``,
``decoder.dense_i``, ``decoder.bn_i``), so ``vitsom_tpu_torch.convert``
maps ``encoder/dense_i``, ``bn_i`` and their ``batch_stats`` one to one.

``BatchNorm`` is Flax's ``nn.BatchNorm`` (momentum 0.99, epsilon 1e-5,
``use_fast_variance``), not torch's: in train mode it normalises with the
biased batch variance mean(x^2) - mean(x)^2 and moves the running
averages as ``r = 0.99 r + 0.01 batch`` with that same biased variance,
where ``torch.nn.BatchNorm1d`` would store the unbiased variance and read
its momentum the other way round. The update is in place, so a captured
CUDA graph replays it. As in Flax, the caller says which statistics to use
(``train``); the module's ``training`` flag is not read. The statistics
reduce over ``dims`` (N of [B, F] here; N, H and W of an NCHW map in
``models/resnet.py`` and ``models/mobile_vit.py``, with their momentum)
and run in float32 whatever the input's dtype, as Flax computes them; the
output has the input's dtype (float64 stays float64). ``track=False`` (the DeiT teacher) never
writes the running averages, and inside ``frozen_statistics()`` no
BatchNorm writes them: a block recomputed by ``torch.utils.checkpoint`` in
the backward must not move them a second time.
"""

from __future__ import annotations

import contextlib
from typing import Optional, Sequence

import torch
import torch.nn.functional as F
from torch import nn

from vitsom_tpu_torch.config import Config
from vitsom_tpu_torch.utils import initializers


_FROZEN = [0]  # > 0 inside frozen_statistics()


@contextlib.contextmanager
def frozen_statistics():
    """No BatchNorm moves its running averages inside this context (the
    recomputation of a checkpointed block)."""
    _FROZEN[0] += 1
    try:
        yield
    finally:
        _FROZEN[0] -= 1


class BatchNorm(nn.Module):
    """Flax ``nn.BatchNorm`` over ``dims`` (module docstring)."""

    def __init__(self, features: int, momentum: float = 0.99, eps: float = 1e-5,
                 dims: Sequence[int] = (0,), track: bool = True):
        super().__init__()
        self.momentum = momentum
        self.eps = eps
        self.dims = tuple(dims)
        self.track = track
        self.weight = nn.Parameter(torch.ones(features))
        self.bias = nn.Parameter(torch.zeros(features))
        self.register_buffer("running_mean", torch.zeros(features))
        self.register_buffer("running_var", torch.ones(features))

    def reset_parameters(self) -> None:
        with torch.no_grad():
            self.weight.fill_(1.0)
            self.bias.zero_()
            self.running_mean.zero_()
            self.running_var.fill_(1.0)

    @staticmethod
    def batch_statistics(x: torch.Tensor, dims=(0,)):
        """(mean, biased variance mean(x^2) - mean^2 clamped at 0) over ``dims``."""
        mean = x.mean(dim=dims)
        return mean, torch.clamp_min((x * x).mean(dim=dims) - mean * mean, 0.0)

    def normalize(self, x, mean, var, weight, bias) -> torch.Tensor:
        """Flax's ``_normalize``: (x - mean) * (rsqrt(var + eps) * scale) + bias."""
        return (x - mean) * (torch.rsqrt(var + self.eps) * weight) + bias

    def forward(self, x: torch.Tensor, train: bool = False) -> torch.Tensor:
        if train:
            mean, var = self.batch_statistics(
                x.to(torch.promote_types(x.dtype, torch.float32)), self.dims)
            if self.track and not _FROZEN[0]:
                with torch.no_grad():
                    m = self.momentum
                    self.running_mean.copy_(m * self.running_mean + (1.0 - m) * mean)
                    self.running_var.copy_(m * self.running_var + (1.0 - m) * var)
        else:
            mean, var = self.running_mean, self.running_var
        # the per-feature vectors broadcast along the one dim not reduced
        shape = [1 if d in self.dims else -1 for d in range(x.ndim)]
        y = self.normalize(x, mean.reshape(shape), var.reshape(shape),
                           self.weight.reshape(shape), self.bias.reshape(shape))
        return y.to(x.dtype)


class MLPStack(nn.Module):
    """Linear layers ``dims[0] -> ... -> dims[-1]``; between layers the
    optional BatchNorm, then the activation (``relu``; any other name means
    none, as in the JAX package); nothing after the last."""

    def __init__(self, dims: Sequence[int], act: str = "relu", batch_norm: bool = False):
        super().__init__()
        self.dims = tuple(int(d) for d in dims)
        self.act = act
        self.batch_norm = batch_norm
        self.n_layers = len(self.dims) - 1
        for i in range(self.n_layers):
            self.add_module(f"dense_{i}", nn.Linear(self.dims[i], self.dims[i + 1]))
            if batch_norm and i < self.n_layers - 1:
                self.add_module(f"bn_{i}", BatchNorm(self.dims[i + 1]))

    def reset_parameters(self, generator: Optional[torch.Generator] = None) -> None:
        for i in range(self.n_layers):
            dense = getattr(self, f"dense_{i}")
            initializers.xavier_uniform_(dense.weight, generator)
            initializers.torch_default_bias_(dense.bias, self.dims[i], generator)
            if self.batch_norm and i < self.n_layers - 1:
                getattr(self, f"bn_{i}").reset_parameters()

    def forward(self, x: torch.Tensor, train: bool = False) -> torch.Tensor:
        for i in range(self.n_layers):
            x = getattr(self, f"dense_{i}")(x)
            if i < self.n_layers - 1:
                if self.batch_norm:
                    x = getattr(self, f"bn_{i}")(x, train=train)
                if self.act == "relu":
                    x = F.relu(x)
        return x


class Autoencoder(nn.Module):
    """Symmetric MLP autoencoder; the input is flattened, [B, C*H*W]."""

    def __init__(self, input_dim: int, encoder_dims: Sequence[int], act: str = "relu",
                 batch_norm: bool = False):
        super().__init__()
        dims = (int(input_dim),) + tuple(int(d) for d in encoder_dims)
        self.encoder = MLPStack(dims, act, batch_norm)
        self.decoder = MLPStack(tuple(reversed(dims)), act, batch_norm)

    def reset_parameters(self, generator: Optional[torch.Generator] = None) -> None:
        self.encoder.reset_parameters(generator)
        self.decoder.reset_parameters(generator)

    def encode(self, x: torch.Tensor, train: bool = False) -> torch.Tensor:
        return self.encoder(x, train=train)

    def decode(self, z: torch.Tensor, train: bool = False) -> torch.Tensor:
        return self.decoder(z, train=train)

    def forward(self, x: torch.Tensor, train: bool = False) -> torch.Tensor:
        return self.decode(self.encode(x, train), train)


def build_autoencoder(cfg: Config) -> Autoencoder:
    """The config's autoencoder: input ``C * S * S``, ``ae.encoder_dims``,
    ``ae.act``, ``ae.batch_norm``."""
    d = cfg.data
    return Autoencoder(d.num_channels * d.input_size * d.input_size, cfg.ae.encoder_dims,
                       cfg.ae.act, cfg.ae.batch_norm)
