"""DeiT: the distillable ViT student, its loss and train step, in PyTorch.

Counterpart of ``vitsom_tpu/models/deit.py``. The student is vit-pytorch's
ViT as the JAX package builds it: patches (p, p, c) -> LayerNorm -> Dense ->
LayerNorm, a CLS token and a learnt position embedding (both N(0, 1)),
embedding dropout at ``vit.attn_drop``, a pre-norm transformer with
head_dim fixed at 64, separate bias-free q/k/v projections, dropout
(``vit.proj_drop``) on the softmax probabilities, after the output
projection and after both MLP layers, exact-erf GELU, and LayerNorms at
Flax's default eps 1e-6. ``train_forward`` appends the distillation token
last and returns (class logits, distill logits); the eval ``forward``
leaves it out.

The train step (``make_deit_train_step``) runs the frozen ResNet-50
teacher (``models/resnet.py``) without gradients, in batch-statistics mode
with nothing written back, and minimises CE * (1 - alpha) + alpha *
distill, the distill term soft (T^2 KL at temperature T) or, with
``distillation.hard``, the CE against the teacher's argmax. The teacher is
read from ``<data.data_dir>/resnet50.pth`` when that file exists, else
drawn from Flax's initialisers with the seed ``train.seed + 13``.

Dropout masks come from ``models/stochastic.bernoulli_mask`` when the
forward is given a generator.

``train.compute_dtype: bfloat16`` runs the embeddings and the transformer
in bf16 as the JAX package does: bf16 dense layers, LayerNorms with float32
statistics and a bf16 output, float32 scores; parameters, the final
LayerNorm and the heads stay float32. ``train.attn_impl`` picks the score
recipe: ``xla`` a float32 softmax, ``xla_bf16`` a bf16 softmax of the bf16
scores, ``xla_bf16s`` float32 softmax arithmetic with bf16 probabilities
(``ops/attention.SoftmaxF32MathBf16Store``); ``models/vit_som.build_model``
turns ``pallas`` and ``hybrid`` into ``xla`` (dropout on the probabilities:
the kernels do not apply).
"""

from __future__ import annotations

import os
from typing import Callable, Dict, Optional

import torch
import torch.nn.functional as F
from torch import nn

from vitsom_tpu_torch.config import Config
from vitsom_tpu_torch.models.resnet import load_torch_resnet50, resnet50
from vitsom_tpu_torch.models.stochastic import Dropout
from vitsom_tpu_torch.models.vit import _DTYPES, Dense, LayerNorm, patchify
from vitsom_tpu_torch.ops.attention import SoftmaxF32MathBf16Store
from vitsom_tpu_torch.train import optim
from vitsom_tpu_torch.train import steps as steps_lib
from vitsom_tpu_torch.utils import initializers as init

LN_EPS = 1e-6  # Flax's LayerNorm default
HEAD_DIM = 64  # vit-pytorch's default dim_head
TEACHER_SEED_OFFSET = 13  # the JAX step draws its random teacher at train.seed + 13


class PreNormLayer(nn.Module):
    """One layer of vit-pytorch's transformer (module docstring)."""

    def __init__(self, dim: int, heads: int, head_dim: int, mlp_dim: int, dropout: float,
                 dtype=torch.float32, attn_impl: str = "xla"):
        super().__init__()
        inner = heads * head_dim
        self.heads = heads
        self.head_dim = head_dim
        self.dtype = dtype
        self.attn_impl = attn_impl
        self.norm1 = LayerNorm(dim, eps=LN_EPS, out_dtype=dtype)
        self.query = Dense(dim, inner, bias=False, compute_dtype=dtype)
        self.key = Dense(dim, inner, bias=False, compute_dtype=dtype)
        self.value = Dense(dim, inner, bias=False, compute_dtype=dtype)
        self.proj = Dense(inner, dim, compute_dtype=dtype)
        self.norm2 = LayerNorm(dim, eps=LN_EPS, out_dtype=dtype)
        self.fc1 = Dense(dim, mlp_dim, compute_dtype=dtype)
        self.fc2 = Dense(mlp_dim, dim, compute_dtype=dtype)
        self.dropout = Dropout(dropout)

    def forward(self, x, generator: Optional[torch.Generator] = None):
        b, n, _ = x.shape
        y = self.norm1(x)
        q, k, v = (lin(y).reshape(b, n, self.heads, self.head_dim)
                   for lin in (self.query, self.key, self.value))
        up = torch.promote_types(q.dtype, torch.float32)  # float32 scores
        scores = torch.einsum("bnhd,bmhd->bhnm", q.to(up), k.to(up)) * self.head_dim**-0.5
        if self.attn_impl == "xla_bf16":
            attn = torch.softmax(scores.to(torch.bfloat16), dim=-1)
        elif self.attn_impl == "xla_bf16s":
            attn = SoftmaxF32MathBf16Store.apply(scores.to(torch.bfloat16))
        else:
            attn = torch.softmax(scores, dim=-1)
        attn = self.dropout(attn, generator)
        out = torch.einsum("bhnm,bmhd->bnhd", attn, v.to(attn.dtype)).reshape(b, n, -1)
        x = x + self.dropout(self.proj(out.to(self.dtype)), generator)
        y = self.dropout(F.gelu(self.fc1(self.norm2(x)), approximate="none"), generator)
        return x + self.dropout(self.fc2(y), generator)


class PreNormTransformer(nn.Module):
    def __init__(self, dim: int, depth: int, heads: int, head_dim: int, mlp_dim: int,
                 dropout: float = 0.0, dtype=torch.float32, attn_impl: str = "xla"):
        super().__init__()
        self.dtype = dtype
        self.layers = nn.ModuleList(
            PreNormLayer(dim, heads, head_dim, mlp_dim, dropout, dtype, attn_impl)
            for _ in range(depth))
        self.norm = LayerNorm(dim, eps=LN_EPS)  # float32 out: feeds the heads

    def forward(self, x, generator: Optional[torch.Generator] = None):
        x = x.to(self.dtype)
        for layer in self.layers:
            x = layer(x, generator)
        return self.norm(x)


class DeiT(nn.Module):
    """The student (module docstring). ``forward`` gives the class logits
    (the eval path), ``train_forward`` also the distill-token logits."""

    def __init__(self, cfg: Config, head_dim: int = HEAD_DIM, attn_impl: str = "xla"):
        super().__init__()
        c = cfg
        dim = c.vit.emb_dim
        self.cfg = cfg
        self.patch_size = c.vit.patch_size
        num_patches = (c.data.input_size // c.vit.patch_size) ** 2
        patch_dim = c.data.num_channels * c.vit.patch_size ** 2
        dtype = _DTYPES[c.train.compute_dtype]
        self.patch_norm_pre = LayerNorm(patch_dim, eps=LN_EPS, out_dtype=dtype)
        self.patch_proj = Dense(patch_dim, dim, compute_dtype=dtype)
        self.patch_norm_post = LayerNorm(dim, eps=LN_EPS, out_dtype=dtype)
        self.pos_embedding = nn.Parameter(torch.zeros(1, num_patches + 1, dim))
        self.cls_token = nn.Parameter(torch.zeros(1, 1, dim))
        self.distill_token = nn.Parameter(torch.zeros(1, 1, dim))
        self.emb_dropout = Dropout(c.vit.attn_drop)  # the reference maps attn_drop here
        self.transformer = PreNormTransformer(dim, c.vit.depth, c.vit.heads, head_dim,
                                              int(dim * c.vit.mlp_ratio), c.vit.proj_drop,
                                              dtype, attn_impl)
        self.mlp_head = nn.Linear(dim, c.data.num_classes)
        self.distill_norm = LayerNorm(dim, eps=LN_EPS)
        self.distill_head = nn.Linear(dim, c.data.num_classes)

    def reset_parameters(self, generator: Optional[torch.Generator] = None):
        """Flax's initialisers: ``lecun_normal`` Dense kernels with zero
        biases; q/k/v from the fused [dim, 3 inner] matrix's xavier-uniform
        (``variance_scaling((C + inner) / (C + 3 inner), fan_avg,
        uniform)`` is that distribution); N(0, 1) tokens and positions;
        unit/zero LayerNorms."""
        for m in self.modules():
            if isinstance(m, nn.Linear):
                init.lecun_normal_(m.weight, generator)
                if m.bias is not None:
                    nn.init.zeros_(m.bias)
            elif isinstance(m, nn.LayerNorm):
                nn.init.ones_(m.weight)
                nn.init.zeros_(m.bias)
        for layer in self.transformer.layers:
            dim, inner = layer.query.in_features, layer.query.out_features
            for lin in (layer.query, layer.key, layer.value):
                init.xavier_uniform_(lin.weight, generator, fans=(dim, 3 * inner))
        for p in (self.pos_embedding, self.cls_token, self.distill_token):
            init.normal_(p, 1.0, generator)

    def _embed(self, x, generator):
        x = self.patch_norm_post(self.patch_proj(self.patch_norm_pre(
            patchify(x, self.patch_size))))
        # the float32 tokens and positions cast to the compute dtype where used
        cls = self.cls_token.to(x.dtype).expand(x.shape[0], 1, x.shape[-1])
        x = torch.cat([cls, x], dim=1)
        x = x + self.pos_embedding[:, : x.shape[1]].to(x.dtype)
        return self.emb_dropout(x, generator)

    def train_forward(self, x, generator: Optional[torch.Generator] = None):
        """(class logits, distill logits) with the distill token appended
        last; dropout is live when ``generator`` is given."""
        x = self._embed(x, generator)
        x = torch.cat([x, self.distill_token.to(x.dtype).expand(x.shape[0], 1, x.shape[-1])],
                      dim=1)
        x = self.transformer(x, generator)
        return self.mlp_head(x[:, 0]), self.distill_head(self.distill_norm(x[:, -1]))

    def forward(self, x):
        """Class logits of the eval path (no distill token, no dropout)."""
        return self.mlp_head(self.transformer(self._embed(x, None))[:, 0])


def soft_distill_loss(distill_logits: torch.Tensor, teacher_logits: torch.Tensor,
                      temperature: float) -> torch.Tensor:
    """T^2 * KL(softmax(teacher/T) || softmax(distill/T)), batch mean, with
    the teacher's probabilities clipped at 1e-12 inside the log."""
    t = temperature
    log_p = torch.log_softmax(distill_logits / t, dim=-1)
    q = torch.softmax(teacher_logits / t, dim=-1)
    kl = torch.sum(q * (torch.log(torch.clamp_min(q, 1e-12)) - log_p), dim=-1)
    return kl.mean() * t**2


_RANDOM_TEACHER_WARNING = (
    "=" * 72 + "\n"
    "WARNING: DeiT teacher is RANDOMLY INITIALIZED — no resnet50.pth "
    "found in {data_dir!r}.\n"
    "The distillation target is noise; the published DeiT accuracy "
    "(0.857, reference README.md:66) is NOT reachable this way.\n"
    "Provide torchvision IMAGENET1K_V2 weights as "
    "{pth!r} for teacher parity (reference models/deit.py:26-32).\n"
    + "=" * 72
)


def build_teacher(cfg: Config, device) -> nn.Module:
    """The frozen ResNet-50 teacher on ``device``: from
    ``<data_dir>/resnet50.pth`` (``load_torch_resnet50``; ``fc`` stays
    random) or, without that file, drawn from Flax's initialisers with the
    seed ``train.seed + 13``, printing the JAX package's warning."""
    teacher = resnet50(cfg.data.num_classes)
    teacher.reset_parameters(torch.Generator().manual_seed(cfg.train.seed + TEACHER_SEED_OFFSET))
    pth = os.path.join(cfg.data.data_dir, "resnet50.pth")
    if os.path.exists(pth):
        n = load_torch_resnet50(teacher, pth)
        print(f"DeiT teacher: loaded pretrained ResNet-50 weights from {pth} ({n} tensors "
              f"mapped; fc stays random)")
    else:
        print(_RANDOM_TEACHER_WARNING.format(data_dir=cfg.data.data_dir, pth=pth))
    return teacher.requires_grad_(False).to(device)


def make_deit_train_step(
    cfg: Config,
    model: DeiT,
    optimizer: torch.optim.Optimizer,
    lr_schedule: Callable[[torch.Tensor], torch.Tensor],
    state: steps_lib.DeviceState,
    generator: torch.Generator,
    teacher: Optional[nn.Module] = None,
):
    """Returns ``train_step(batch) -> metrics row``: the teacher's logits
    without gradients (batch statistics, nothing written back), the
    student's ``train_forward`` with dropout drawn from ``generator``, the
    distillation loss, backward and AdamW at the step ``state.step`` holds;
    writes ``steps.DEIT_METRIC_KEYS`` into the metrics buffer (``train/
    distill_loss`` is the whole loss, as the JAX step names it). The
    teacher is ``build_teacher``'s unless one is given; the step's
    ``teacher`` attribute holds it."""
    teacher = teacher if teacher is not None else build_teacher(cfg, steps_lib.model_device(model))
    alpha = cfg.distillation.alpha
    temp = cfg.distillation.temperature
    hard = cfg.distillation.hard

    def train_step(batch: Dict[str, torch.Tensor]) -> torch.Tensor:
        x, y = batch["image"], batch["label"]
        lr = lr_schedule(state.step)
        optim.set_learning_rate(optimizer, lr)
        optimizer.zero_grad(set_to_none=True)
        with torch.no_grad():
            teacher_logits = teacher(x, train=True)
        logits, distill_logits = model.train_forward(x, generator)
        ce = steps_lib.cross_entropy(logits, y)
        if hard:
            distill = steps_lib.cross_entropy(distill_logits, teacher_logits.argmax(-1))
        else:
            distill = soft_distill_loss(distill_logits, teacher_logits, temp)
        loss = ce * (1 - alpha) + distill * alpha
        loss.backward()
        optimizer.step()
        values = torch.stack([loss.detach(), ce.detach(), lr])
        state.write(values)
        return values

    train_step.teacher = teacher
    return train_step
