"""How far the prototype decode moves its pixels when one op's output moves
by one float32 ulp.

``ViTSOM.decode_prototypes`` runs in float64 here (every compute dtype
float64), so the decode adds no rounding of its own. One run per op adds
one float32 ulp (of the element's float32 value, with a seeded random
sign) to every element of that op's output, in every decoder block at
once:

- ``attention``: the attention op's output (``multi_head_attention``,
  before the projection);
- ``layernorm``: each decoder LayerNorm (both of a block's, and the final
  ``decoder_norm``);
- ``mlp``: each block's MLP output;
- ``head``: the pixel head (``decoder_pred``);
- ``unpatchify``: the decoded pixels themselves.

A last run perturbs all of them together, a stand-in for float32's
rounding at each op. For each it prints max |delta pixels|, the largest ulp
injected, their ratio (the amplification) and max |delta| in ulps of the
largest pixel, then one JSON line. It also prints the decoder LayerNorms'
largest gain, 1 / sqrt(var + eps) of a row, for the prepended zero CLS
token and for the patch tokens apart: a row whose channels (four at
``dec_emb_dim`` 4) nearly agree is divided by a small deviation. The
decoder returns float32, as in the model, so deltas are whole float32 ulps
of the pixels. Run (the CPU is enough, float64 being
exact to the question)::

    python -m vitsom_tpu_torch.eval.decode_conditioning --device cpu \\
        --config configs/vit_som/vit_som_mnist.yaml
"""

from __future__ import annotations

import argparse
import json
from typing import Dict, Optional

import numpy as np
import torch

from vitsom_tpu_torch.config import load_config
from vitsom_tpu_torch.models.vit_som import build_model
from vitsom_tpu_torch.ops import attention as attention_ops

OPS = ("attention", "layernorm", "mlp", "head", "unpatchify")


def float32_ulp(x: torch.Tensor) -> torch.Tensor:
    """The spacing of float32 above |x| at each element, as x's dtype."""
    a = x.abs().float()
    return (torch.nextafter(a, torch.full_like(a, float("inf"))) - a).to(x.dtype)


class Perturber:
    """Adds +-1 float32 ulp to the outputs of the ops named in ``active``;
    records the largest ulp added."""

    def __init__(self, seed: int):
        self.rng = np.random.default_rng(seed)
        self.active = set()
        self.injected = 0.0

    def __call__(self, name: str, x: torch.Tensor) -> torch.Tensor:
        if name not in self.active:
            return x
        ulp = float32_ulp(x)
        sign = torch.from_numpy(self.rng.choice([-1.0, 1.0], size=tuple(x.shape))).to(x)
        self.injected = max(self.injected, float(ulp.max()))
        return x + sign * ulp


def _hook(perturb: Perturber, name: str):
    def hook(_module, _inputs, output):
        return perturb(name, output)
    return hook


def float64_model(model: torch.nn.Module) -> torch.nn.Module:
    """``model`` in float64, every compute dtype float64."""
    model = model.double()
    for mod in model.modules():
        if hasattr(mod, "compute_dtype"):
            mod.compute_dtype = torch.float64
        if hasattr(mod, "out_dtype"):
            mod.out_dtype = torch.float64
    return model


def measure(config: str, device: str = "cuda", seed: int = 0,
            overrides: Optional[Dict] = None) -> Dict[str, dict]:
    """{op: {"max_abs_delta", "max_ulp_injected", "amplification",
    "delta_in_pixel_ulps"}} for each op of OPS and "all" (every op at
    once), on a model built from ``seed``; the pixels' largest
    magnitude under "pixels_max_abs", the decoder LayerNorms' largest gain
    under "layernorm_max_gain" ({"cls": ..., "patches": ...})."""
    cfg = load_config(config, overrides=overrides)
    model = float64_model(build_model(cfg, device=device, seed=seed)).eval()
    vit = model.vit
    perturb = Perturber(seed)
    gains = {"cls": 0.0, "patches": 0.0}

    def record_gain(module, inputs):
        gain = (inputs[0].var(-1, unbiased=False) + module.eps).rsqrt()  # [P, 1 + N]
        gains["cls"] = max(gains["cls"], float(gain[:, 0].max()))
        gains["patches"] = max(gains["patches"], float(gain[:, 1:].max()))

    norms = [m for blk in vit.decoder_blocks for m in (blk.norm1, blk.norm2)]
    norms.append(vit.decoder_norm)
    handles = [m.register_forward_pre_hook(record_gain) for m in norms]
    for blk in vit.decoder_blocks:
        handles += [blk.norm1.register_forward_hook(_hook(perturb, "layernorm")),
                    blk.norm2.register_forward_hook(_hook(perturb, "layernorm")),
                    blk.mlp.register_forward_hook(_hook(perturb, "mlp"))]
    handles += [vit.decoder_norm.register_forward_hook(_hook(perturb, "layernorm")),
                vit.decoder_pred.register_forward_hook(_hook(perturb, "head"))]
    attention = attention_ops.multi_head_attention

    def perturbed_attention(*args, **kwargs):
        out, attn = attention(*args, **kwargs)
        return perturb("attention", out), attn

    def decode():
        with torch.no_grad():
            pixels = model.decode_prototypes(model.prototypes)
        return perturb("unpatchify", pixels)

    attention_ops.multi_head_attention = perturbed_attention
    try:
        base = decode()
        scale = float(base.abs().max())
        pixel_ulp = float(float32_ulp(torch.tensor(scale, dtype=torch.float64)))
        out = {"pixels_max_abs": scale, "layernorm_max_gain": dict(gains)}
        for name in (*OPS, "all"):
            perturb.active = set(OPS) if name == "all" else {name}
            perturb.injected = 0.0
            delta = float((decode() - base).abs().max())
            out[name] = {"max_abs_delta": delta, "max_ulp_injected": perturb.injected,
                         "amplification": delta / perturb.injected,
                         "delta_in_pixel_ulps": delta / pixel_ulp}
        return out
    finally:
        attention_ops.multi_head_attention = attention
        perturb.active = set()
        for h in handles:
            h.remove()


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--config", default="configs/vit_som/vit_som_mnist.yaml")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)
    res = measure(args.config, args.device, args.seed)
    gain = res["layernorm_max_gain"]
    print(f"pixels: max |x| = {res['pixels_max_abs']:.6e}; decoder LayerNorm gain at most "
          f"{gain['cls']:.3f} (CLS row), {gain['patches']:.3f} (patch rows)")
    for name in (*OPS, "all"):
        r = res[name]
        print(f"{name:10s} max|delta pixels|={r['max_abs_delta']:.3e} "
              f"largest ulp injected={r['max_ulp_injected']:.3e} "
              f"amplification={r['amplification']:.3f} "
              f"delta={r['delta_in_pixel_ulps']:.2f} pixel ulps")
    print(json.dumps(res))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
