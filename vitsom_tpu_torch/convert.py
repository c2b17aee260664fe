"""Carry ViT-SOM parameters between the JAX package's layout and the port's.

``flax_to_state_dict`` turns a Flax parameter tree (nested dicts, or a flat
dict with ``/``-joined keys such as ``vit/block_0/Attention_0/Dense_0/kernel``)
of numpy-convertible arrays into the port's ``state_dict``;
``state_dict_to_flax`` is its exact inverse (a flat ``/``-keyed dict of numpy
arrays). The layout rules:

- a Dense ``kernel [in, out]`` becomes ``weight [out, in]``;
- the patch-embedding conv kernel, HWIO, becomes OIHW;
- a LayerNorm ``scale`` becomes ``weight``;
- ``prototypes`` and ``cls_token`` carry over as they are.

Module names: ``block_i``/``dec_block_i`` -> ``blocks.i``/``decoder_blocks.i``;
``LayerNorm_0/1`` -> ``norm1/2``; ``Mlp_0/Dense_0/1`` -> ``mlp.fc1/fc2``;
in ``Attention_0``, ``Dense_0`` is the fused qkv and ``Dense_1`` the output
projection below dim 128, while at dim >= 128 the named ``query/key/value``
projections come first and ``Dense_0`` is the output projection.

``block_weights_from_flax`` and ``block_weights`` map one transformer block,
Flax or the port's, onto the weight dict of the fused block op
(``ops/block_fused.py``).
"""

from __future__ import annotations

import re
from typing import Dict, Mapping

import numpy as np
import torch

_BLOCK_RE = re.compile(r"^(block|dec_block)_(\d+)$")
_BLOCK_SUB = {
    "LayerNorm_0": "norm1",
    "LayerNorm_1": "norm2",
    "Mlp_0/Dense_0": "mlp.fc1",
    "Mlp_0/Dense_1": "mlp.fc2",
    "Attention_0/query": "attn.query",
    "Attention_0/key": "attn.key",
    "Attention_0/value": "attn.value",
}


def flatten(tree: Mapping, prefix: str = "") -> Dict[str, object]:
    """Nested dict -> flat dict with ``/``-joined keys (flat input passes)."""
    out = {}
    for k, v in tree.items():
        key = f"{prefix}/{k}" if prefix else str(k)
        if isinstance(v, Mapping):
            out.update(flatten(v, key))
        else:
            out[key] = v
    return out


def _split_blocks(flat_keys) -> set:
    """Block prefixes (``vit/block_0``) whose attention has named q/k/v."""
    return {k.split("/Attention_0/query/")[0] for k in flat_keys if "/Attention_0/query/" in k}


def _module_path(path: str, split: set) -> str:
    """Flax module path (without the leaf name) -> torch module path."""
    parts = path.split("/")
    if parts[0] != "vit":
        return path
    if len(parts) > 1 and _BLOCK_RE.match(parts[1]):
        kind, idx = _BLOCK_RE.match(parts[1]).groups()
        head = f"vit.{'blocks' if kind == 'block' else 'decoder_blocks'}.{idx}"
        sub = "/".join(parts[2:])
        if sub in _BLOCK_SUB:
            return f"{head}.{_BLOCK_SUB[sub]}"
        if sub == "Attention_0/Dense_0":
            is_split = "/".join(parts[:2]) in split
            return f"{head}.attn.{'proj' if is_split else 'qkv'}"
        if sub == "Attention_0/Dense_1":
            return f"{head}.attn.proj"
        raise KeyError(f"unknown block parameter path {path}")
    return ".".join(parts)


_LEAF_NAMES = {"kernel": "weight", "scale": "weight", "bias": "bias", "cls_token": "cls_token"}


def key_map(flax_keys) -> Dict[str, str]:
    """Flat Flax parameter paths -> the port's ``state_dict`` names."""
    flax_keys = list(flax_keys)
    split = _split_blocks(flax_keys)
    out = {}
    for key in flax_keys:
        mod, _, leaf = key.rpartition("/")
        if not mod:  # top-level leaf: prototypes
            out[key] = leaf
        elif leaf in _LEAF_NAMES:
            out[key] = f"{_module_path(mod, split)}.{_LEAF_NAMES[leaf]}"
        else:
            raise KeyError(f"unknown parameter {key}")
    return out


def flax_to_state_dict(params: Mapping) -> Dict[str, torch.Tensor]:
    """Flax ViT-SOM parameters -> the port's ``state_dict``."""
    flat = {k: np.asarray(v) for k, v in flatten(params).items()}
    out = {}
    for key, name in key_map(flat).items():
        arr = flat[key]
        if key.endswith("/kernel"):
            if arr.ndim == 4:  # conv HWIO -> OIHW
                arr = arr.transpose(3, 2, 0, 1)
            elif arr.ndim == 2:  # Dense [in, out] -> [out, in]
                arr = arr.T
            else:
                raise ValueError(f"unexpected kernel rank {arr.ndim} at {key}")
        out[name] = torch.from_numpy(np.ascontiguousarray(arr).copy())
    return out


def block_weights_from_flax(params: Mapping) -> Dict[str, torch.Tensor]:
    """A Flax ``Block``'s parameters (nested, or flat with ``/``-joined keys)
    -> the fused block's weights (``ops/block_fused.WEIGHT_NAMES``, each
    ``[in, out]``). At dim >= 128 the named ``query/key/value`` projections
    are concatenated into ``qkv_kernel [D, 3D]`` and ``Dense_0`` is the
    output projection; below, ``Dense_0`` is the fused qkv and ``Dense_1``
    the projection."""
    flat = {k: np.asarray(v) for k, v in flatten(params).items()}
    if "Attention_0/query/kernel" in flat:
        qkv = [np.concatenate([flat[f"Attention_0/{nm}/{leaf}"] for nm in ("query", "key", "value")],
                              axis=-1) for leaf in ("kernel", "bias")]
        proj = "Attention_0/Dense_0"
    else:
        qkv = [flat[f"Attention_0/Dense_0/{leaf}"] for leaf in ("kernel", "bias")]
        proj = "Attention_0/Dense_1"
    arrays = {
        "ln1_scale": flat["LayerNorm_0/scale"], "ln1_bias": flat["LayerNorm_0/bias"],
        "qkv_kernel": qkv[0], "qkv_bias": qkv[1],
        "proj_kernel": flat[f"{proj}/kernel"], "proj_bias": flat[f"{proj}/bias"],
        "ln2_scale": flat["LayerNorm_1/scale"], "ln2_bias": flat["LayerNorm_1/bias"],
        "fc1_kernel": flat["Mlp_0/Dense_0/kernel"], "fc1_bias": flat["Mlp_0/Dense_0/bias"],
        "fc2_kernel": flat["Mlp_0/Dense_1/kernel"], "fc2_bias": flat["Mlp_0/Dense_1/bias"],
    }
    return {k: torch.from_numpy(np.ascontiguousarray(v).copy()) for k, v in arrays.items()}


def block_weights(blk) -> Dict[str, torch.Tensor]:
    """The port's ``models/vit.Block`` -> the fused block's weights, as views
    of its parameters (``nn.Linear`` weights transposed to ``[in, out]``; a
    ``torch.cat`` of the split q/k/v projections at dim >= 128), so gradients
    through ``ops/block_fused.FusedBlock`` reach the module's parameters."""
    attn = blk.attn
    lins = (attn.query, attn.key, attn.value) if attn.split_qkv else (attn.qkv,)
    if any(lin.bias is None for lin in lins):
        raise ValueError("the fused block carries a qkv bias; this block has none")
    if attn.split_qkv:
        qkv_kernel = torch.cat([lin.weight.t() for lin in lins], dim=1)
        qkv_bias = torch.cat([lin.bias for lin in lins])
    else:
        qkv_kernel, qkv_bias = attn.qkv.weight.t(), attn.qkv.bias
    return {
        "ln1_scale": blk.norm1.weight, "ln1_bias": blk.norm1.bias,
        "qkv_kernel": qkv_kernel, "qkv_bias": qkv_bias,
        "proj_kernel": attn.proj.weight.t(), "proj_bias": attn.proj.bias,
        "ln2_scale": blk.norm2.weight, "ln2_bias": blk.norm2.bias,
        "fc1_kernel": blk.mlp.fc1.weight.t(), "fc1_bias": blk.mlp.fc1.bias,
        "fc2_kernel": blk.mlp.fc2.weight.t(), "fc2_bias": blk.mlp.fc2.bias,
    }


def state_dict_to_flax(state_dict: Mapping[str, torch.Tensor]) -> Dict[str, np.ndarray]:
    """The port's ``state_dict`` -> flat ``/``-keyed Flax parameters."""
    split = {
        k.split(".attn.query.")[0] for k in state_dict if ".attn.query." in k
    }
    inv_sub = {v: k for k, v in _BLOCK_SUB.items()}
    out = {}
    for key, t in state_dict.items():
        arr = t.detach().cpu().numpy()
        if key == "prototypes":
            out[key] = arr.copy()
            continue
        if key == "vit.cls_token":
            out["vit/cls_token"] = arr.copy()
            continue
        mod, _, leaf = key.rpartition(".")
        m = re.match(r"^vit\.(blocks|decoder_blocks)\.(\d+)\.(.+)$", mod)
        if m:
            kind, idx, sub = m.groups()
            head = f"vit/{'block' if kind == 'blocks' else 'dec_block'}_{idx}"
            if sub in inv_sub:
                fpath = f"{head}/{inv_sub[sub]}"
            elif sub == "attn.qkv":
                fpath = f"{head}/Attention_0/Dense_0"
            elif sub == "attn.proj":
                is_split = f"vit.{kind}.{idx}" in split
                fpath = f"{head}/Attention_0/{'Dense_0' if is_split else 'Dense_1'}"
            else:
                raise KeyError(f"unknown block parameter {key}")
        else:
            fpath = mod.replace(".", "/")
        is_norm = "norm" in fpath.rsplit("/", 1)[-1] or "LayerNorm" in fpath
        if leaf == "weight" and is_norm:
            out[f"{fpath}/scale"] = arr.copy()
        elif leaf == "weight":
            if arr.ndim == 4:  # OIHW -> HWIO
                arr = arr.transpose(2, 3, 1, 0)
            else:
                arr = arr.T
            out[f"{fpath}/kernel"] = np.ascontiguousarray(arr)
        elif leaf == "bias":
            out[f"{fpath}/bias"] = arr.copy()
        else:
            raise KeyError(f"unknown parameter {key}")
    return out
