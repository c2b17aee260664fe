"""AdamW with the reference's parameter-group semantics, in PyTorch.

Counterpart of ``vitsom_tpu/train/optim.py``:

- ViT backbone parameters (``vit.*``): weight decay 0 for 1-D tensors
  (norms, biases), ``optimizer.weight_decay`` otherwise.
- The SOM prototypes carry no explicit weight decay in the reference, so
  torch.optim.AdamW's default 1e-2 applies: ``default_group_weight_decay``.
- Layer-wise lr scales (``apply_layer_decay``) are off by default, as in
  the reference, which computes them but never applies them.

``torch.optim.AdamW`` with one parameter group per distinct (decay, lr
scale) pair is the same update as optax's ``scale_by_adam ->
add_decayed_weights -> scale_by_learning_rate`` chain: bias-corrected
moments, eps outside the square root, decoupled decay scaled by the lr.

Each group's lr is a 0-d float32 tensor on the parameters' device, which
the train step overwrites in place (``set_learning_rate``), so a CUDA graph
that captured the step replays it with each step's lr. On the card the
optimizer is ``capturable``: its step counts live on the device and the
bias corrections are computed there, in float32, as optax computes them;
the eager run on the card uses the same optimizer, so an eager and a
captured run differ only by the capture. On the CPU (the tests) torch
takes no capturable optimizer; the tensor lr is read on the host there.
"""

from __future__ import annotations

from typing import Dict, List

import torch

from vitsom_tpu_torch.config import Config


def vit_layer_id(name: str, num_layers: int) -> int:
    """Parameter name -> layer index (``get_layer_id_for_vit``);
    ``num_layers`` = depth + 1."""
    parts = name.split(".")
    head = parts[1] if parts[0] == "vit" else parts[0]
    if head in ("cls_token", "patch_proj"):
        return 0
    if head == "blocks":
        return int(parts[2]) + 1
    return num_layers


def build_weight_decay_map(model: torch.nn.Module, cfg: Config) -> Dict[str, float]:
    """Per-parameter decoupled weight-decay coefficients."""
    if cfg.model_arch not in ("vit_som", "vit"):
        raise NotImplementedError(f"the {cfg.model_arch} optimizer groups are not ported yet")
    opt = cfg.optimizer
    out = {}
    for name, p in model.named_parameters():
        if name.startswith("vit."):
            out[name] = 0.0 if p.ndim == 1 else opt.weight_decay
        else:
            out[name] = opt.default_group_weight_decay
    return out


def build_lr_scale_map(model: torch.nn.Module, cfg: Config) -> Dict[str, float]:
    """Per-parameter layer-decay multipliers (1.0 unless ``apply_layer_decay``)."""
    opt = cfg.optimizer
    names = [n for n, _ in model.named_parameters()]
    if not opt.apply_layer_decay or cfg.model_arch not in ("vit_som", "vit"):
        return {n: 1.0 for n in names}
    num_layers = cfg.vit.depth + 1
    return {
        n: opt.layer_decay ** (num_layers - vit_layer_id(n, num_layers))
        if n.startswith("vit.")
        else 1.0
        for n in names
    }


def base_learning_rate(cfg: Config) -> float:
    """lr * batch_size / 256 for vit_som/vit; the raw lr otherwise."""
    if cfg.model_arch in ("vit_som", "vit"):
        return cfg.optimizer.lr * cfg.batch_size / 256.0
    return cfg.optimizer.lr


def set_learning_rate(optimizer: torch.optim.Optimizer, lr: torch.Tensor) -> None:
    """Write ``lr * lr_scale`` into each group's lr tensor, in place (before
    each update); ``lr`` is a 0-d float32 tensor on the parameters' device
    (the train step's), so nothing is read on the host."""
    for group in optimizer.param_groups:
        group["lr"].copy_(lr * group["lr_scale"])


def make_optimizer(cfg: Config, model: torch.nn.Module) -> torch.optim.AdamW:
    """AdamW (or Adam as AdamW without decay) with one group per distinct
    (weight decay, lr scale); each group records its ``lr_scale`` and holds
    its own lr tensor, and the train step calls ``set_learning_rate(opt,
    schedule(step))`` before each update. ``capturable`` on the card."""
    opt = cfg.optimizer
    if cfg.train.adam_mu_dtype != "float32":
        raise NotImplementedError("train.adam_mu_dtype=bfloat16 is not ported yet")
    wd = build_weight_decay_map(model, cfg)
    scale = build_lr_scale_map(model, cfg)
    groups: Dict[tuple, List[torch.nn.Parameter]] = {}
    for name, p in model.named_parameters():
        key = (wd[name] if opt.type == "adamw" else 0.0, scale[name])
        groups.setdefault(key, []).append(p)
    dev = next(model.parameters()).device
    lr = base_learning_rate(cfg)
    param_groups = [
        {"params": ps, "weight_decay": d, "lr_scale": s,
         "lr": torch.full((), lr * s, dtype=torch.float32, device=dev)}
        for (d, s), ps in groups.items()
    ]
    return torch.optim.AdamW(
        param_groups,
        lr=lr,
        betas=(opt.beta_1, opt.beta_2),
        eps=opt.eps,
        capturable=dev.type == "cuda",
    )
