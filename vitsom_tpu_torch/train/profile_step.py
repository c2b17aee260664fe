"""Where the time of the port's ViT-SOM train step goes, on one card.

    python -m vitsom_tpu_torch.train.profile_step [--steps 20] [--trace out/trace.json] \
        [--override train.attn_impl=pallas]

Builds the flagship config (``configs/vit_som/vit_som_mnist.yaml`` as
shipped, with any ``--override key=value``, yaml-parsed as the trainer's
command line takes them) on synthetic MNIST-shaped data, warms up, then
prints:

1. ``wall``: the median step time of the trainer's own step, host clock,
   synchronised after each step, with no profiler attached;
2. ``profile``: ``torch.profiler`` over ``--steps`` more of the same
   steps: device busy time per step (the sum of kernel times), kernels
   launched per step, the device's idle share of the profiled wall time,
   the device-side span of the optimizer's own ``Optimizer.step`` range
   (which ``torch.optim`` records; from its first kernel's start to its
   last kernel's end, gaps included), the share of busy time in the fused
   SOM and the attention kernels, and the kernels with the most device
   time. ``--trace`` writes the Chrome trace.

Needs a CUDA card; imports nothing of JAX.
"""

from __future__ import annotations

import argparse
import os
import statistics
import sys
import time

import torch

from vitsom_tpu_torch.config import load_config
from vitsom_tpu_torch.models.vit_som import model_attn_impl
from vitsom_tpu_torch.train.trainer import Trainer

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def _device_us(evt) -> float:
    for name in ("self_device_time_total", "self_cuda_time_total"):
        if hasattr(evt, name):
            return float(getattr(evt, name))
    return 0.0


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=20)
    ap.add_argument("--trace", type=str, default=None, help="write the Chrome trace here")
    ap.add_argument("--override", action="append", default=[],
                    help="dotted config override key=value (yaml-parsed)")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("FAIL: no CUDA device", file=sys.stderr)
        return 1

    import yaml

    overrides = {"data.allow_synthetic": True, "data.synthetic_size": 4096}
    for ov in args.override:
        k, _, v = ov.partition("=")
        overrides[k] = yaml.safe_load(v)
    cfg = load_config(os.path.join(ROOT, "configs/vit_som/vit_som_mnist.yaml"), overrides)
    tr = Trainer(cfg, device="cuda")
    batches = list(tr.dm.train_batches(torch.Generator().manual_seed(0)))
    n = args.steps
    print(f"device: {torch.cuda.get_device_name(0)} torch={torch.__version__} "
          f"map={cfg.som.map_size} batch={cfg.batch_size} steps={n} "
          f"attn_impl={model_attn_impl(cfg)}", flush=True)

    step = 0

    def run_step():
        nonlocal step
        tr.train_step(step, batches[step % len(batches)])
        step += 1

    for _ in range(10):
        run_step()
    torch.cuda.synchronize()

    walls = []
    for _ in range(n):
        t0 = time.perf_counter()
        run_step()
        torch.cuda.synchronize()
        walls.append((time.perf_counter() - t0) * 1e3)
    wall = statistics.median(walls)
    print(f"wall: median_step_ms={wall:.4f} images_per_s={cfg.batch_size / wall * 1e3:.1f}",
          flush=True)

    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(n):
            run_step()
        torch.cuda.synchronize()
        prof_wall = (time.perf_counter() - t0) * 1e3

    def on_device(e):
        return str(getattr(e, "device_type", "")).endswith("CUDA")

    def annotation(e):
        return getattr(e, "is_user_annotation", False)

    # kernels only: GPU-side user annotations (the optimizer's step range)
    # also carry device time and would count it twice
    averages = [e for e in prof.key_averages() if on_device(e) and _device_us(e) > 0]
    rows = [e for e in averages if not annotation(e)]
    busy_us = sum(_device_us(e) for e in rows)
    kernels = [e for e in prof.events() if on_device(e) and not annotation(e)]
    print(
        f"profile: device_busy_ms_per_step={busy_us / 1e3 / n:.4f} "
        f"profiled_wall_ms_per_step={prof_wall / n:.4f} "
        f"device_idle_share={1 - busy_us / 1e3 / prof_wall:.4f} "
        f"kernels_per_step={len(kernels) / n:.1f}",
        flush=True,
    )
    for label, tag in (("som_fused_kernels", "som_"), ("attention_fwd_kernel", "attn_fwd_kernel"),
                       ("attention_bwd_kernel", "attn_bwd_kernel")):
        us = sum(_device_us(e) for e in rows if tag in e.key)
        print(f"profile: {label}_ms_per_step={us / 1e3 / n:.4f} "
              f"share_of_busy={us / max(busy_us, 1e-9):.4f}", flush=True)
    opt_us = sum(_device_us(e) for e in averages if annotation(e) and "Optimizer.step" in e.key)
    print(f"profile: optimizer_step_device_span_ms_per_step={opt_us / 1e3 / n:.4f}"
          if opt_us else "profile: optimizer_step_device_span_ms_per_step=not recorded",
          flush=True)
    for e in sorted(rows, key=_device_us, reverse=True)[:20]:
        print(f"  {_device_us(e) / 1e3 / n:9.4f} ms/step  x{e.count / n:6.1f}  {e.key[:110]}",
              flush=True)
    if args.trace:
        os.makedirs(os.path.dirname(os.path.abspath(args.trace)), exist_ok=True)
        prof.export_chrome_trace(args.trace)
    return 0


if __name__ == "__main__":
    sys.exit(main())
