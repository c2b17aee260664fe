"""Where the time of the port's train step (ViT-SOM, DESOM, ViT, Swin,
DeiT) goes, on one card.

    python -m vitsom_tpu_torch.train.profile_step [--config PATH] [--steps 20] \
        [--override train.attn_impl=pallas] [--trace out/trace.json]

Builds ``--config`` (default ``configs/vit_som/vit_som_mnist.yaml``, the
flagship, as shipped) with any ``--override key=value`` (yaml-parsed, as
the trainer's command line takes them) on its synthetic stand-in data
(``build_datamodule``: mnist-family clustering, and classification as
shipped, the 80/20 split augmented on the device; the clustering of other
datasets, e.g. ``--override data.num_classes=0`` on a cifar config:
``raw_synthetic_datamodule``, un-augmented), and measures the trainer's
step in both of its modes: ``eager`` (the step body
called step by step, ``Trainer.fit(eager=True)``) and ``graphed`` (one
captured step replayed, ``Trainer.fit``). For each mode it warms up, then
prints:

1. ``wall``: host-clock milliseconds a step over ``--steps`` steps of
   ``fit``, continuing the epoch (its one metrics read included, and an
   epoch gather where an epoch ends inside the window; a synchronisation
   at the end), and the median of the trainer's own ``step_ms`` (CUDA
   events between step ends), with no profiler attached. An augmented
   classification config's synthetic split is sized so that one epoch
   holds every measured step: its epoch fill (gather + augmentation) runs
   once, in the first warm-up, and no validation falls inside a window. On
   the static classification path (``desom_flowers17.yaml``) an epoch fill
   is one gather, so the split keeps its size and the windows hold their
   epochs' gathers, as the clustering configs' do; validation is turned
   off (``train.eval_every_n_epochs``), so none falls in a window;
2. ``profile``: ``torch.profiler`` over ``--steps`` more steps of each
   mode, in one profiler session (a second session in one process has
   recorded no kernels): device busy time a step (the sum of kernel
   times), kernels a step, the device's idle share of the profiled wall
   time, the busy time of the fused SOM and the attention kernels, the
   kernel count of each hand-written kernel, and the kernels with the most
   device time. The modes' kernels are told apart by a marker kernel
   (``torch.cuda._sleep``'s spin kernel) run alone between them, with a
   synchronisation on each side: on the device's clock every eager kernel
   ends before it starts and every graphed one starts after it. CUPTI
   records the kernels a graph replay runs, so the graphed counts show the
   hand-written kernels executing under replay.

The last line is one JSON object with both modes' numbers. ``--trace``
writes the Chrome trace. Needs a CUDA card; imports nothing of JAX.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import sys
import time

import torch

from vitsom_tpu_torch.config import load_config
from vitsom_tpu_torch.data.augment import is_static_transform
from vitsom_tpu_torch.data.synthetic import (
    MNIST_FAMILY, build_datamodule, raw_synthetic_datamodule,
)
from vitsom_tpu_torch.models.vit_som import model_attn_impl
from vitsom_tpu_torch.train.trainer import Trainer

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
FLAGSHIP = os.path.join(ROOT, "configs", "vit_som", "vit_som_mnist.yaml")
WARMUP_STEPS = 10
# the hand-written kernels of the train path, found by name
KERNELS = ("som_partial_kernel", "som_finalize_kernel", "attn_fwd_kernel",
           "attn_fwd_mma_kernel", "attn_bwd_kernel", "attn_bwd_mma_kernel")
MODES = ("eager", "graphed")
MARKER = "spin_kernel"  # torch.cuda._sleep's kernel, run between the modes


def _on_device(e) -> bool:
    return str(getattr(e, "device_type", "")).endswith("CUDA")


def _annotation(e) -> bool:
    return getattr(e, "is_user_annotation", False)


def _fit(tr: Trainer, mode: str, n: int):
    """``n`` steps of ``fit`` in ``mode``, continuing the current epoch."""
    return tr.fit(max_steps=tr.step + n, eager=mode == "eager", new_epoch=False)


def _wall(tr: Trainer, mode: str, n: int) -> dict:
    torch.cuda.synchronize()
    done = len(tr.step_ms)
    t0 = time.perf_counter()
    _fit(tr, mode, n)
    torch.cuda.synchronize()
    wall = (time.perf_counter() - t0) * 1e3 / n
    return {"wall_ms_per_step": wall,
            "step_ms_median": statistics.median(tr.step_ms[done:])}


def _summary(kernels, n: int, prof_wall_ms: float) -> dict:
    """Busy time, idle share, counts and tagged kernels of one mode's
    device events."""
    busy_us = sum(e.time_range.elapsed_us() for e in kernels)
    out = {
        "device_busy_ms_per_step": busy_us / 1e3 / n,
        "profiled_wall_ms_per_step": prof_wall_ms / n,
        "device_idle_share": 1 - busy_us / 1e3 / prof_wall_ms,
        "kernels_per_step": len(kernels) / n,
        "kernel_counts": {}, "kernel_ms_per_step": {},
    }
    for name in KERNELS:
        hit = [e for e in kernels if name in e.name]
        out["kernel_counts"][name] = len(hit)
        out["kernel_ms_per_step"][name] = sum(e.time_range.elapsed_us() for e in hit) / 1e3 / n
    return out


def profile(config: str, overrides: dict, n: int, trace=None) -> dict:
    """Measures both modes of the train step (module docstring) and returns
    their numbers."""
    over = {"data.allow_synthetic": True, "data.synthetic_size": 4096, **overrides}
    cfg = load_config(config, over)
    if cfg.classification and is_static_transform(cfg.data):
        cfg = load_config(config, {**over, "train.eval_every_n_epochs": 10**9})
    elif cfg.classification and "data.synthetic_size" not in overrides:
        # one epoch holds every step measured (with a margin for the val
        # share), so no epoch fill (augmentation) or validation falls in a
        # measured window
        rows = (2 * WARMUP_STEPS + 4 * n + 1) * cfg.batch_size * 2
        cfg = load_config(config, {**over, "data.synthetic_size": rows})
    ported = cfg.data.dataset in MNIST_FAMILY or cfg.classification
    dm = (build_datamodule if ported else raw_synthetic_datamodule)(cfg, "cuda")
    tr = Trainer(cfg, device="cuda", dm=dm)
    print(f"device: {torch.cuda.get_device_name(0)} torch={torch.__version__} "
          f"config={os.path.basename(config)} map={cfg.som.map_size} batch={cfg.batch_size} "
          f"compute={cfg.train.compute_dtype} remat={cfg.train.remat_blocks} steps={n} "
          f"attn_impl={model_attn_impl(cfg)}", flush=True)

    result = {"config": os.path.basename(config), "overrides": overrides,
              "attn_impl": model_attn_impl(cfg), "steps": n}
    for mode in MODES:
        _fit(tr, mode, WARMUP_STEPS)
        result[mode] = _wall(tr, mode, n)
        r = result[mode]
        print(f"wall[{mode}]: wall_ms_per_step={r['wall_ms_per_step']:.4f} "
              f"step_ms_median={r['step_ms_median']:.4f} "
              f"images_per_s={cfg.batch_size / r['wall_ms_per_step'] * 1e3:.1f}", flush=True)

    from torch.profiler import ProfilerActivity, profile as torch_profile, record_function

    walls = {}
    with torch_profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for mode in MODES:
            torch.cuda.synchronize()
            if mode != MODES[0]:
                torch.cuda._sleep(1000)
                torch.cuda.synchronize()
            with record_function(f"profile_step:{mode}"):
                t0 = time.perf_counter()
                _fit(tr, mode, n)
                torch.cuda.synchronize()
                walls[mode] = (time.perf_counter() - t0) * 1e3
    kernels = [e for e in prof.events() if _on_device(e) and not _annotation(e)]
    markers = [e for e in kernels if MARKER in e.name]
    if len(markers) != 1:
        raise RuntimeError(f"found {len(markers)} {MARKER} kernels between the modes, not 1")
    split = markers[0].time_range.start
    by_mode = {"eager": [e for e in kernels if e.time_range.start < split],
               "graphed": [e for e in kernels if e.time_range.start > split]}
    for mode in MODES:
        result[mode].update(_summary(by_mode[mode], n, walls[mode]))
        r = result[mode]
        print(f"profile[{mode}]: device_busy_ms_per_step={r['device_busy_ms_per_step']:.4f} "
              f"profiled_wall_ms_per_step={r['profiled_wall_ms_per_step']:.4f} "
              f"device_idle_share={r['device_idle_share']:.4f} "
              f"kernels_per_step={r['kernels_per_step']:.1f}", flush=True)
        print(f"profile[{mode}]: hand-written kernels over {n} steps: "
              + " ".join(f"{k}={c} ({r['kernel_ms_per_step'][k]:.4f} ms/step)"
                         for k, c in r["kernel_counts"].items() if c), flush=True)
        tops = {}
        for e in by_mode[mode]:
            t = tops.setdefault(e.name, [0.0, 0])
            t[0] += e.time_range.elapsed_us()
            t[1] += 1
        for name, (us, count) in sorted(tops.items(), key=lambda kv: -kv[1][0])[:12]:
            print(f"  [{mode}] {us / 1e3 / n:9.4f} ms/step  x{count / n:6.1f}  {name[:100]}",
                  flush=True)
    if trace:
        os.makedirs(os.path.dirname(os.path.abspath(trace)), exist_ok=True)
        prof.export_chrome_trace(trace)
    return result


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--config", type=str, default=FLAGSHIP,
                    help="config yaml (default: the flagship vit_som_mnist.yaml)")
    ap.add_argument("--steps", type=int, default=20)
    ap.add_argument("--trace", type=str, default=None, help="write the Chrome trace here")
    ap.add_argument("--override", action="append", default=[],
                    help="dotted config override key=value (yaml-parsed)")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("FAIL: no CUDA device", file=sys.stderr)
        return 1

    import yaml

    overrides = {}
    for ov in args.override:
        k, _, v = ov.partition("=")
        overrides[k] = yaml.safe_load(v)
    result = profile(args.config, overrides, args.steps, args.trace)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
