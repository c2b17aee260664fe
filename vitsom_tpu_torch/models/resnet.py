"""ResNet in PyTorch: the DeiT distillation teacher.

Counterpart of ``vitsom_tpu/models/resnet.py``. Modules carry torchvision's
names (``conv1``, ``bn1``, ``layer{s}.{i}.conv{j}`` / ``bn{j}``,
``layer{s}.0.downsample.{0,1}``, ``fc``), so ``load_torch_resnet50`` reads
a torchvision state_dict name for name, and ``torchvision_name_map`` (the
JAX package's map from those names to the Flax tree) carries Flax weights
across (``vitsom_tpu_torch.convert``).

BatchNorm is Flax's (``models/ae.BatchNorm``: the biased batch variance
mean(x^2) - mean(x)^2, eps 1e-5) over N, H and W. The teacher runs as the
JAX step runs it, ``train=True`` with the statistics update dropped: it
normalises with each batch's statistics and writes nothing back, where
``nn.BatchNorm2d`` in train mode would move its running averages.
``train=False`` reads the running averages. Max pooling pads with -inf,
as Flax's ``max_pool`` and ``F.max_pool2d`` both do; the strided 1x1
downsample convs need no padding under Flax's ``SAME``.

Images enter NHWC, as in the JAX package.
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch
import torch.nn.functional as F
from torch import nn

from vitsom_tpu_torch.models.ae import BatchNorm
from vitsom_tpu_torch.utils import initializers as init


class BatchNorm2d(BatchNorm):
    """Flax ``nn.BatchNorm`` over N, H, W of an NCHW tensor; ``train=True``
    uses the batch's statistics and never updates the running averages."""

    def __init__(self, features: int):
        super().__init__(features, dims=(0, 2, 3), track=False)


def _conv(c_in: int, c_out: int, k: int, stride: int = 1) -> nn.Conv2d:
    return nn.Conv2d(c_in, c_out, k, stride=stride, padding=k // 2, bias=False)


class Bottleneck(nn.Module):
    expansion = 4

    def __init__(self, c_in: int, features: int, stride: int = 1, downsample: bool = False):
        super().__init__()
        self.conv1 = _conv(c_in, features, 1)
        self.bn1 = BatchNorm2d(features)
        self.conv2 = _conv(features, features, 3, stride)
        self.bn2 = BatchNorm2d(features)
        self.conv3 = _conv(features, features * 4, 1)
        self.bn3 = BatchNorm2d(features * 4)
        self.downsample = (nn.ModuleList([_conv(c_in, features * 4, 1, stride),
                                          BatchNorm2d(features * 4)]) if downsample else None)

    def forward(self, x, train: bool = False):
        y = F.relu(self.bn1(self.conv1(x), train))
        y = F.relu(self.bn2(self.conv2(y), train))
        y = self.bn3(self.conv3(y), train)
        residual = x if self.downsample is None else self.downsample[1](
            self.downsample[0](x), train)
        return F.relu(y + residual)


class BasicBlock(nn.Module):
    expansion = 1

    def __init__(self, c_in: int, features: int, stride: int = 1, downsample: bool = False):
        super().__init__()
        self.conv1 = _conv(c_in, features, 3, stride)
        self.bn1 = BatchNorm2d(features)
        self.conv2 = _conv(features, features, 3)
        self.bn2 = BatchNorm2d(features)
        self.downsample = (nn.ModuleList([_conv(c_in, features, 1, stride),
                                          BatchNorm2d(features)]) if downsample else None)

    def forward(self, x, train: bool = False):
        y = F.relu(self.bn1(self.conv1(x), train))
        y = self.bn2(self.conv2(y), train)
        residual = x if self.downsample is None else self.downsample[1](
            self.downsample[0](x), train)
        return F.relu(y + residual)


class ResNet(nn.Module):
    """The JAX package's ``ResNet``: every stage's first block downsamples
    (a 1x1 conv + BatchNorm on the residual), stride 2 from the second
    stage on."""

    def __init__(self, stage_sizes: Sequence[int] = (3, 4, 6, 3), block: str = "bottleneck",
                 num_classes: int = 1000):
        super().__init__()
        self.stage_sizes = tuple(stage_sizes)
        self.block = block
        Block = Bottleneck if block == "bottleneck" else BasicBlock
        self.conv1 = _conv(3, 64, 7, 2)
        self.bn1 = BatchNorm2d(64)
        c_in, features = 64, 64
        for stage, n_blocks in enumerate(self.stage_sizes, start=1):
            blocks = []
            for b in range(n_blocks):
                stride = 2 if (stage > 1 and b == 0) else 1
                blocks.append(Block(c_in, features, stride, downsample=(b == 0)))
                c_in = features * Block.expansion
            self.add_module(f"layer{stage}", nn.ModuleList(blocks))
            features *= 2
        self.fc = nn.Linear(c_in, num_classes)

    def reset_parameters(self, generator: Optional[torch.Generator] = None):
        """Flax's defaults: ``lecun_normal`` conv and Dense kernels, a zero
        Dense bias, BatchNorm scale 1, bias 0, running mean 0, var 1."""
        for m in self.modules():
            if isinstance(m, (nn.Conv2d, nn.Linear)):
                init.lecun_normal_(m.weight, generator)
                if m.bias is not None:
                    nn.init.zeros_(m.bias)
            elif isinstance(m, BatchNorm):
                m.reset_parameters()

    def forward(self, x, train: bool = False):
        """[B, H, W, C] -> logits [B, num_classes]."""
        x = x.permute(0, 3, 1, 2)
        x = F.relu(self.bn1(self.conv1(x), train))
        x = F.max_pool2d(x, 3, stride=2, padding=1)
        for stage in range(1, len(self.stage_sizes) + 1):
            for blk in getattr(self, f"layer{stage}"):
                x = blk(x, train)
        return self.fc(x.mean(dim=(2, 3)))


def resnet50(num_classes: int) -> ResNet:
    return ResNet((3, 4, 6, 3), "bottleneck", num_classes)


def resnet34(num_classes: int) -> ResNet:
    return ResNet((3, 4, 6, 3), "basic", num_classes)


def torchvision_name_map(stage_sizes: Sequence[int] = (3, 4, 6, 3),
                         block: str = "bottleneck") -> dict:
    """torchvision module name -> Flax scope path (``Conv_0``/``BatchNorm_0``
    for the stem, ``Bottleneck_k`` numbered across stages, in each
    ``Conv_j``/``BatchNorm_j``, the downsample last), by name, as the JAX
    package's map."""
    n_convs = 3 if block == "bottleneck" else 2
    blk_name = "Bottleneck" if block == "bottleneck" else "BasicBlock"
    m = {"conv1": "Conv_0", "bn1": "BatchNorm_0"}
    blk = 0
    for stage, n_blocks in enumerate(stage_sizes, start=1):
        for i in range(n_blocks):
            t, f = f"layer{stage}.{i}", f"{blk_name}_{blk}"
            for j in range(1, n_convs + 1):
                m[f"{t}.conv{j}"] = f"{f}/Conv_{j - 1}"
                m[f"{t}.bn{j}"] = f"{f}/BatchNorm_{j - 1}"
            if i == 0:
                m[f"{t}.downsample.0"] = f"{f}/Conv_{n_convs}"
                m[f"{t}.downsample.1"] = f"{f}/BatchNorm_{n_convs}"
            blk += 1
    return m


# a torchvision BatchNorm's tensors -> the port's
_BN_NAMES = {"weight": "weight", "bias": "bias", "running_mean": "running_mean",
             "running_var": "running_var"}


def load_torch_resnet50(model: ResNet, pth_path: str) -> int:
    """Copy a torchvision resnet state_dict (``torch.load(...,
    weights_only=True)``; a ``module.`` prefix is dropped) into ``model``
    by name, with strict shape checks; ``fc`` stays as it is (the
    reference's replaced, frozen head). Raises ValueError on a shape
    mismatch, a module without tensors, or a conv/BN tensor left over.
    Returns the number of tensors copied."""
    sd = torch.load(pth_path, map_location="cpu", weights_only=True)
    sd = {k.removeprefix("module."): v for k, v in sd.items()}
    own = model.state_dict()

    def assign(key, value):
        if key not in own:
            raise ValueError(f"the port's ResNet has no tensor {key!r}")
        if tuple(own[key].shape) != tuple(value.shape):
            raise ValueError(f"shape mismatch at {key!r}: port {tuple(own[key].shape)} "
                             f"vs torch {tuple(value.shape)}")
        with torch.no_grad():
            own[key].copy_(value)

    consumed = set()
    for tmod in torchvision_name_map(model.stage_sizes, model.block):
        if f"{tmod}.running_mean" in sd:
            names = [f"{tmod}.{s}" for s in _BN_NAMES]
        elif f"{tmod}.weight" in sd:
            names = [f"{tmod}.weight"]
        else:
            raise ValueError(f"state_dict has no tensors for module {tmod!r}")
        for name in names:
            assign(name, sd[name])
        consumed.update(names)
    leftover = [k for k in sd if k not in consumed and not k.startswith("fc.")
                and not k.endswith("num_batches_tracked")]
    if leftover:
        raise ValueError(f"unconsumed state_dict tensors: {leftover[:8]}")
    return len(consumed)
