"""AdamW with the reference's parameter-group semantics, in PyTorch.

Counterpart of ``vitsom_tpu/train/optim.py``:

- ViT backbone parameters (``vit.*``): weight decay 0 for 1-D tensors
  (norms, biases), ``optimizer.weight_decay`` otherwise.
- The SOM prototypes carry no explicit weight decay in the reference, so
  torch.optim.AdamW's default 1e-2 applies: ``default_group_weight_decay``.
- Layer-wise lr scales (``apply_layer_decay``) are off by default, as in
  the reference, which computes them but never applies them.
- DESOM (``desom``): no decoupled decay on any parameter, with the
  config's ``adam`` or ``adamw``, at the raw ``optimizer.lr`` (no ``x B /
  256``); its yamls keep the default ``constant`` scheduler.
- The baselines (``swin``, ``deit``, ``mobile_vit``): one flat group with
  ``optimizer.weight_decay`` on every tensor, norms and biases included, at
  the raw ``optimizer.lr``, no layer decay.

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

``train.adam_mu_dtype: bfloat16`` stores the first moment in bf16, as
optax's ``scale_by_adam(mu_dtype=bfloat16)`` does in the JAX package.
``torch.optim.AdamW`` keeps its moments in the parameters' dtype, so that
case takes the port's own update, ``AdamWBf16Mu``, with the same groups and
lr tensors; the float32 case keeps ``torch.optim.AdamW``.
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
    opt = cfg.optimizer
    out = {}
    for name, p in model.named_parameters():
        if cfg.model_arch == "desom":
            out[name] = 0.0
        elif cfg.model_arch in ("swin", "deit", "mobile_vit"):
            out[name] = opt.weight_decay
        elif name.startswith("vit."):
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


class AdamWBf16Mu(torch.optim.Optimizer):
    """AdamW with a bf16 first moment: optax's ``scale_by_adam(mu_dtype=
    bfloat16) -> add_decayed_weights -> scale_by_learning_rate`` at its
    roundings. Per parameter, with g the float32 gradient and m the stored
    bf16 moment:

    - ``m' = (1 - b1) g + bf16(bf16(b1) m)`` in float32 (JAX multiplies the
      bf16 moment by its weakly typed b1 in bf16), ``v' = (1 - b2) g^2 +
      b2 v`` in float32;
    - ``u = (m' / (1 - b1^t)) / (sqrt(v' / (1 - b2^t)) + eps)`` from the
      float32 m', then ``p -= lr (u + wd p)``, lr the group's tensor (the
      layer-decay scale folded in, as in ``set_learning_rate``);
    - ``m = bf16(m')`` stored (round to nearest even).

    Every operation is a tensor operation on the parameters' device (the
    step count included), so the update is capturable in a CUDA graph. Each
    step of the formula is one ``torch._foreach_*`` op over a group's
    parameters, as torch's capturable foreach AdamW does."""

    def __init__(self, params, lr, betas, eps, weight_decay=0.0):
        super().__init__(params, {"lr": lr, "betas": betas, "eps": eps,
                                  "weight_decay": weight_decay, "capturable": True})

    def load_state_dict(self, state_dict):
        """torch casts loaded moments to the parameters' dtype; the first
        moment goes back to bf16, exactly (it was bf16 before)."""
        super().load_state_dict(state_dict)
        for st in self.state.values():
            if "exp_avg" in st:
                st["exp_avg"] = st["exp_avg"].to(torch.bfloat16)

    @torch.no_grad()
    def step(self, closure=None):
        for group in self.param_groups:
            params = [p for p in group["params"] if p.grad is not None]
            if not params:
                continue
            b1, b2 = group["betas"]
            b1_bf16 = float(torch.tensor(b1, dtype=torch.bfloat16))
            lr, eps, wd = group["lr"], group["eps"], group["weight_decay"]
            for p in params:
                st = self.state[p]
                if not st:
                    st["step"] = torch.zeros((), dtype=torch.float32, device=p.device)
                    st["exp_avg"] = torch.zeros_like(p, dtype=torch.bfloat16)
                    st["exp_avg_sq"] = torch.zeros_like(p, dtype=torch.float32)
            grads = [p.grad for p in params]
            ms, vs, steps = ([self.state[p][key] for p in params]
                             for key in ("exp_avg", "exp_avg_sq", "step"))
            torch._foreach_add_(steps, 1)
            # bf16(b1) m is exact in float32, then rounded to bf16 in place
            torch._foreach_mul_(ms, b1_bf16)
            decayed = [torch.empty_like(g) for g in grads]
            torch._foreach_copy_(decayed, ms)
            mu = torch._foreach_mul(grads, 1 - b1)
            torch._foreach_add_(mu, decayed)
            g2 = torch._foreach_mul(grads, grads)
            torch._foreach_mul_(g2, 1 - b2)
            torch._foreach_mul_(vs, b2)
            torch._foreach_add_(vs, g2)
            torch._foreach_copy_(ms, mu)
            # 1 - b^t, per parameter
            bc1, bc2 = torch._foreach_pow(b1, steps), torch._foreach_pow(b2, steps)
            for bc in (bc1, bc2):
                torch._foreach_sub_(bc, 1)
                torch._foreach_neg_(bc)
            den = torch._foreach_div(vs, bc2)
            torch._foreach_sqrt_(den)
            torch._foreach_add_(den, eps)
            torch._foreach_div_(mu, bc1)
            torch._foreach_div_(mu, den)
            if wd:
                torch._foreach_add_(mu, torch._foreach_mul(params, wd))
            torch._foreach_mul_(mu, lr)
            torch._foreach_sub_(params, mu)
        return None


def make_optimizer(cfg: Config, model: torch.nn.Module) -> torch.optim.Optimizer:
    """AdamW (or Adam as AdamW without decay) with one group per distinct
    (weight decay, lr scale); each group records its ``lr_scale`` and holds
    its own lr tensor, and the train step calls ``set_learning_rate(opt,
    schedule(step))`` before each update. ``capturable`` on the card.
    ``train.adam_mu_dtype: bfloat16`` gives ``AdamWBf16Mu``."""
    opt = cfg.optimizer
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
    if cfg.train.adam_mu_dtype == "bfloat16":
        return AdamWBf16Mu(param_groups, lr=lr, betas=(opt.beta_1, opt.beta_2), eps=opt.eps)
    return torch.optim.AdamW(
        param_groups,
        lr=lr,
        betas=(opt.beta_1, opt.beta_2),
        eps=opt.eps,
        capturable=dev.type == "cuda",
    )
