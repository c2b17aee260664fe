"""Carry ViT-SOM and DESOM parameters between the JAX package's layout and
the port's.

``flax_to_state_dict`` turns a Flax parameter tree (nested dicts, or a flat
dict with ``/``-joined keys such as ``vit/block_0/Attention_0/Dense_0/kernel``)
of numpy-convertible arrays into the port's ``state_dict``;
``state_dict_to_flax`` is its exact inverse (a flat ``/``-keyed dict of numpy
arrays). The layout rules:

- a Dense ``kernel [in, out]`` becomes ``weight [out, in]``;
- the patch-embedding conv kernel, HWIO, becomes OIHW;
- a LayerNorm ``scale`` becomes ``weight``;
- ``prototypes`` and ``cls_token`` carry over as they are.

The classifier head's ``cls_head/Dense_0`` is the port's ``cls_head``
(``ViTSOM`` with ``num_classes > 0``, ``ViTClassifier``).

DESOM's tree maps path for path (``autoencoder/encoder/dense_0`` ->
``autoencoder.encoder.dense_0``, ``autoencoder/decoder/bn_1``, ``classifier``);
its Flax ``batch_stats`` (``.../bn_i/mean`` and ``var``) are the BatchNorm
buffers ``running_mean`` and ``running_var``: ``flax_to_state_dict(params,
batch_stats)`` takes them, ``batch_stats_to_flax`` gives them back.

Module names: ``block_i``/``dec_block_i`` -> ``blocks.i``/``decoder_blocks.i``;
``LayerNorm_0/1`` -> ``norm1/2``; ``Mlp_0/Dense_0/1`` -> ``mlp.fc1/fc2``;
in ``Attention_0``, ``Dense_0`` is the fused qkv and ``Dense_1`` the output
projection below dim 128, while at dim >= 128 the named ``query/key/value``
projections come first and ``Dense_0`` is the output projection.

The baselines (Swin, the DeiT student, its ResNet teacher and MobileViT-S)
go through ``baseline_to_state_dict`` / ``state_dict_to_baseline``. In
MobileViT, conv kernels go HWIO -> OIHW (a depthwise [k, k, 1, C] to
[C, 1, k, k]) and Flax's attention projections, query / key / value
kernels [dim, heads, head_dim] with biases [heads, head_dim] and the out
kernel [heads, head_dim, dim], become ``nn.Linear`` weights [heads *
head_dim, dim] and [dim, heads * head_dim]; its ``batch_stats`` are the
BatchNorm buffers.

``block_weights_from_flax`` and ``block_weights`` map one transformer block,
Flax or the port's, onto the weight dict of the fused block op
(``ops/block_fused.py``).
"""

from __future__ import annotations

import re
from typing import Dict, Mapping, Optional

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


# the Flax ClsHead's one Dense is the port's ClsHead (an nn.Linear)
_CLS_HEAD = ("cls_head/Dense_0", "cls_head")


def _module_path(path: str, split: set) -> str:
    """Flax module path (without the leaf name) -> torch module path."""
    if path == _CLS_HEAD[0]:
        return _CLS_HEAD[1]
    parts = path.split("/")
    if parts[0] != "vit":
        return ".".join(parts)
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


_BATCH_STATS = {"mean": "running_mean", "var": "running_var"}


def flax_to_state_dict(params: Mapping, batch_stats: Optional[Mapping] = None
                       ) -> Dict[str, torch.Tensor]:
    """Flax ViT-SOM or DESOM parameters (and DESOM's ``batch_stats``) -> the
    port's ``state_dict``."""
    out = {}
    for key, arr in flatten(batch_stats or {}).items():
        mod, _, leaf = key.rpartition("/")
        out[f"{mod.replace('/', '.')}.{_BATCH_STATS[leaf]}"] = torch.from_numpy(
            np.array(arr, dtype=np.float32))
    flat = {k: np.asarray(v) for k, v in flatten(params).items()}
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


def batch_stats_to_flax(state_dict: Mapping[str, torch.Tensor]) -> Dict[str, np.ndarray]:
    """The port's BatchNorm buffers -> flat ``/``-keyed Flax ``batch_stats``."""
    inv = {v: k for k, v in _BATCH_STATS.items()}
    out = {}
    for key, t in state_dict.items():
        mod, _, leaf = key.rpartition(".")
        if leaf in inv:
            out[f"{mod.replace('.', '/')}/{inv[leaf]}"] = t.detach().cpu().numpy().copy()
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
    """The port's ``state_dict`` -> flat ``/``-keyed Flax parameters (the
    BatchNorm buffers are ``batch_stats_to_flax``'s)."""
    split = {
        k.split(".attn.query.")[0] for k in state_dict if ".attn.query." in k
    }
    inv_sub = {v: k for k, v in _BLOCK_SUB.items()}
    out = {}
    for key, t in state_dict.items():
        if key.rpartition(".")[2] in ("running_mean", "running_var"):
            continue
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
        elif mod == _CLS_HEAD[1]:
            fpath = _CLS_HEAD[0]
        else:
            fpath = mod.replace(".", "/")
        last = fpath.rsplit("/", 1)[-1]
        is_norm = "norm" in last or "LayerNorm" in fpath or last.startswith("bn_")
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


# ---------------------------------------------------------------------------
# the baselines: Swin, the DeiT student and the ResNet teacher
# ---------------------------------------------------------------------------

# (Flax module path, torch module path) templates; {k} is an index
_SWIN_MODULES = [
    ("Conv_0", "patch_embed"), ("LayerNorm_0", "patch_norm"), ("LayerNorm_1", "norm"),
    ("Dense_0", "head"),
    ("SwinBlock_{k}/LayerNorm_0", "blocks.{k}.norm1"),
    ("SwinBlock_{k}/LayerNorm_1", "blocks.{k}.norm2"),
    ("SwinBlock_{k}/WindowAttention_0/Dense_0", "blocks.{k}.attn.qkv"),
    ("SwinBlock_{k}/WindowAttention_0/Dense_1", "blocks.{k}.attn.proj"),
    ("SwinBlock_{k}/WindowAttention_0", "blocks.{k}.attn"),
    ("SwinBlock_{k}/Dense_0", "blocks.{k}.mlp.fc1"),
    ("SwinBlock_{k}/Dense_1", "blocks.{k}.mlp.fc2"),
    ("PatchMerging_{k}/LayerNorm_0", "merges.{k}.norm"),
    ("PatchMerging_{k}/Dense_0", "merges.{k}.reduction"),
]
_DEIT_MODULES = [
    (name, name) for name in ("", "patch_norm_pre", "patch_proj", "patch_norm_post",
                              "mlp_head", "distill_norm", "distill_head")
] + [(f"transformer/{nm}_{{k}}", f"transformer.layers.{{k}}.{nm}")
     for nm in ("query", "key", "value")]
# in each layer of the DeiT transformer Flax numbers two LayerNorms and
# three Dense layers across the loop; the final LayerNorm comes last
_DEIT_NORMS = ("norm1", "norm2")
_DEIT_DENSES = ("proj", "fc1", "fc2")


def _template_map(templates, path: str, forward: bool) -> Optional[str]:
    """Map ``path`` through the first matching (flax, torch) template."""
    for flax_t, torch_t in templates:
        src, dst = (flax_t, torch_t) if forward else (torch_t, flax_t)
        m = re.fullmatch(re.escape(src).replace(r"\{k\}", r"(?P<k>\d+)"), path)
        if m:
            return dst.format(**m.groupdict())
    return None


def _deit_module(path: str, depth: int, forward: bool) -> str:
    hit = _template_map(_DEIT_MODULES, path, forward)
    if hit is not None:
        return hit
    if forward:
        m = re.fullmatch(r"transformer/(LayerNorm|Dense)_(\d+)", path)
        if m:
            kind, j = m.group(1), int(m.group(2))
            if kind == "LayerNorm" and j == 2 * depth:
                return "transformer.norm"
            n = 2 if kind == "LayerNorm" else 3
            names = _DEIT_NORMS if kind == "LayerNorm" else _DEIT_DENSES
            return f"transformer.layers.{j // n}.{names[j % n]}"
    else:
        if path == "transformer.norm":
            return f"transformer/LayerNorm_{2 * depth}"
        m = re.fullmatch(r"transformer\.layers\.(\d+)\.(\w+)", path)
        if m and m.group(2) in _DEIT_NORMS + _DEIT_DENSES:
            i, name = int(m.group(1)), m.group(2)
            if name in _DEIT_NORMS:
                return f"transformer/LayerNorm_{2 * i + _DEIT_NORMS.index(name)}"
            return f"transformer/Dense_{3 * i + _DEIT_DENSES.index(name)}"
    raise KeyError(f"unknown deit module {path!r}")


def _resnet_layout(keys):
    """(stage_sizes, block) of a ResNet from its Flax paths (blocks
    numbered across stages; a stage's first block has the downsample conv,
    ``Conv_3`` in a Bottleneck, ``Conv_2`` in a BasicBlock) or from its
    torch names (``layer{s}.{i}``; a Bottleneck has ``conv3``)."""
    keys = list(keys)
    flax_blocks = {}
    for k in keys:
        m = re.match(r"(Bottleneck|BasicBlock)_(\d+)/(\w+)/", k)
        if m:
            flax_blocks.setdefault((m.group(1), int(m.group(2))), set()).add(m.group(3))
    if flax_blocks:
        block = next(iter(flax_blocks))[0]
        down = "Conv_3" if block == "Bottleneck" else "Conv_2"
        starts = [i for (_, i), mods in sorted(flax_blocks.items()) if down in mods]
        sizes = [b - a for a, b in zip(starts, starts[1:] + [len(flax_blocks)])]
        return tuple(sizes), block.lower()
    counts = {}
    for k in keys:
        m = re.match(r"layer(\d+)\.(\d+)\.", k)
        if m:
            counts[int(m.group(1))] = max(counts.get(int(m.group(1)), 0), int(m.group(2)) + 1)
    block = "bottleneck" if any(".conv3." in k for k in keys) else "basic"
    return tuple(counts[s] for s in sorted(counts)), block


def _resnet_modules(keys) -> Dict[str, str]:
    """Flax module path -> torch module path of a ResNet (the teacher)."""
    from vitsom_tpu_torch.models.resnet import torchvision_name_map

    out = {f: t for t, f in torchvision_name_map(*_resnet_layout(keys)).items()}
    out["Dense_0"] = "fc"
    return out


def _mobile_vit_modules() -> Dict[str, str]:
    """Flax module path -> torch module path of MobileViT-S (Flax numbers
    ``MV2Block_i`` and ``MobileViTBlock_j`` in call order, the port indexes
    ``blocks`` along ``STAGES``)."""
    from vitsom_tpu_torch.models.mobile_vit import STAGES

    def cbs(f, t):
        return [(f"{f}/Conv_0", f"{t}.conv"), (f"{f}/BatchNorm_0", f"{t}.bn")]

    pairs = cbs("ConvBnSiLU_0", "stem") + cbs("ConvBnSiLU_1", "head_conv") + [("Dense_0", "head")]
    seen = {"mv2": 0, "mvit": 0}
    for i, (kind, _, depth) in enumerate(STAGES):
        t = f"blocks.{i}"
        if kind == "mv2":
            f = f"MV2Block_{seen[kind]}"
            pairs += (cbs(f"{f}/ConvBnSiLU_0", f"{t}.expand") + cbs(f"{f}/ConvBnSiLU_1", f"{t}.dw")
                      + [(f"{f}/Conv_0", f"{t}.project"), (f"{f}/BatchNorm_0", f"{t}.project_bn")])
        else:
            f = f"MobileViTBlock_{seen[kind]}"
            pairs += (cbs(f"{f}/ConvBnSiLU_0", f"{t}.local") + cbs(f"{f}/ConvBnSiLU_1", f"{t}.proj")
                      + cbs(f"{f}/ConvBnSiLU_2", f"{t}.fuse")
                      + [(f"{f}/Conv_0", f"{t}.local_proj"), (f"{f}/LayerNorm_0", f"{t}.norm")])
            for k in range(depth):
                fb, tb = f"{f}/TransformerBlock_{k}", f"{t}.transformer.{k}"
                pairs += [(f"{fb}/LayerNorm_0", f"{tb}.norm1"), (f"{fb}/LayerNorm_1", f"{tb}.norm2"),
                          (f"{fb}/Dense_0", f"{tb}.fc1"), (f"{fb}/Dense_1", f"{tb}.fc2")]
                pairs += [(f"{fb}/MultiHeadDotProductAttention_0/{proj}", f"{tb}.attn.{proj}")
                          for proj in ("query", "key", "value", "out")]
        seen[kind] += 1
    return dict(pairs)


def _baseline_modules(arch: str, keys):
    """A function (module path, forward) -> module path for ``arch``, for a
    model whose parameters have the names ``keys`` (Flax or torch)."""
    if arch == "swin":
        def swin(path, forward):
            hit = _template_map(_SWIN_MODULES, path, forward)
            if hit is None:
                raise KeyError(f"unknown swin module {path!r}")
            return hit
        return swin
    if arch == "deit":
        depth = sum(1 for k in keys if re.search(r"(^|[/.])query(_\d+)?[/.]", k))
        return lambda path, forward: _deit_module(path, depth, forward)
    if arch in ("resnet", "mobile_vit"):
        table = _resnet_modules(keys) if arch == "resnet" else _mobile_vit_modules()
        inverse = {t: f for f, t in table.items()}
        return lambda path, forward: (table if forward else inverse)[path]
    raise ValueError(f"no baseline converter for {arch!r}")


def baseline_to_state_dict(arch: str, params: Mapping, batch_stats: Optional[Mapping] = None
                           ) -> Dict[str, torch.Tensor]:
    """Flax parameters (and the teacher's ``batch_stats``) of ``arch``
    (``swin``, ``deit`` or ``resnet``) -> the port's ``state_dict``: Dense
    kernels transposed, conv kernels HWIO -> OIHW, LayerNorm / BatchNorm
    ``scale`` -> ``weight``, ``mean`` / ``var`` -> ``running_mean`` /
    ``running_var``, every other leaf (``rel_bias_table``, the DeiT tokens
    and ``pos_embedding``) as it is; MobileViT's attention projections
    flattened over their heads (module docstring)."""
    flat = {k: np.asarray(v) for k, v in flatten(params).items()}
    module = _baseline_modules(arch, flat)
    out = {}
    for key, arr in flat.items():
        mod, _, leaf = key.rpartition("/")
        tmod = module(mod, True)
        if arch == "mobile_vit" and "/MultiHeadDotProductAttention_0/" in key:
            # kernels [dim, H, hd] and out [H, hd, dim], biases [H, hd]
            if mod.endswith("/out"):
                arr = arr.reshape(-1, arr.shape[-1]) if leaf == "kernel" else arr
            else:
                arr = arr.reshape(*arr.shape[:-2], -1)
        if leaf == "kernel":
            arr = arr.transpose(3, 2, 0, 1) if arr.ndim == 4 else arr.T
        name = {"kernel": "weight", "scale": "weight"}.get(leaf, leaf)
        out[f"{tmod}.{name}" if tmod else name] = torch.from_numpy(
            np.ascontiguousarray(arr).copy())
    for key, arr in flatten(batch_stats or {}).items():
        mod, _, leaf = key.rpartition("/")
        out[f"{module(mod, True)}.{_BATCH_STATS[leaf]}"] = (
            torch.from_numpy(np.array(arr, dtype=np.float32)))
    return out


def state_dict_to_baseline(arch: str, state_dict: Mapping[str, torch.Tensor]):
    """The inverse of ``baseline_to_state_dict``: (flat ``/``-keyed Flax
    parameters, flat ``batch_stats``) as numpy arrays. A 1-D ``weight`` is
    a norm's ``scale``, a 2-D or 4-D one a kernel; MobileViT's attention
    projections regain their head axes."""
    module = _baseline_modules(arch, state_dict)
    inv_stats = {v: k for k, v in _BATCH_STATS.items()}
    params, stats = {}, {}
    for key, t in state_dict.items():
        arr = t.detach().cpu().numpy()
        mod, _, leaf = key.rpartition(".")
        fmod = module(mod, False)
        if leaf in inv_stats:
            stats[f"{fmod}/{inv_stats[leaf]}"] = arr.copy()
            continue
        if leaf == "weight":
            if arr.ndim == 1:
                leaf = "scale"
            else:
                leaf = "kernel"
                arr = arr.transpose(2, 3, 1, 0) if arr.ndim == 4 else arr.T
        proj = re.search(r"\.attn\.(query|key|value|out)$", mod) if arch == "mobile_vit" else None
        if proj:
            from vitsom_tpu_torch.models.mobile_vit import NUM_HEADS

            if proj.group(1) == "out":
                arr = arr.reshape(NUM_HEADS, -1, arr.shape[-1]) if leaf == "kernel" else arr
            else:
                arr = arr.reshape(*arr.shape[:-1], NUM_HEADS, -1)
        params[f"{fmod}/{leaf}" if fmod else leaf] = np.ascontiguousarray(arr).copy()
    return params, stats
