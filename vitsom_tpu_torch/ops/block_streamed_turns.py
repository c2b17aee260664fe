"""Times the fused block's kernels of source trees in turns on one card.

    python3 -m vitsom_tpu_torch.ops.block_streamed_turns [--shapes S] TREE [TREE ...]

Each TREE is a checkout of the repository (``.`` for this one), or a copy
of one with an edited ``ops/csrc/block_streamed.cu``. The trees are timed
in the order given, each in a fresh interpreter whose working directory and
first import path is the tree, so each builds and runs its own kernels on
this file's inputs: compare two versions as A B B A in one run, on one
card. Each turn prints one line ``TURN {json}``: the tree, the card's name
and power limit (``nvidia-smi``), and at each (B, N, D, heads, mlp_ratio)
of SHAPES the design ``block_plan`` gives each direction, the milliseconds
of the forward (``fwd``) and the backward (``bwd``), each the median of
RUNS calls with the L2 flushed before each (``attention_bf16_turns.
time_ms``), the streamed kernels' grid, and a digest of the outputs y, dx
and the 12 weight gradients (``sha1``: equal digests in two trees are
bitwise-equal outputs). The inputs are ``chip_smoke.block_inputs``'s at
seed 7000 + D (phase 12's).
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys

# (B, N, D, heads, mlp_ratio): the vit_som_cifar-10 encoder and decoder
# blocks, and the encoder block at N 257 (tiny-imagenet, cifar-100)
SHAPES = [(128, 65, 192, 3, 4.0), (128, 65, 96, 3, 4.0), (128, 257, 192, 3, 4.0)]


def turn(shapes) -> dict:
    """One tree's times (the working directory's package)."""
    import hashlib

    import torch

    from chip_smoke import block_inputs, block_weights
    from vitsom_tpu_torch.ops import block_fused
    from vitsom_tpu_torch.ops.attention_bf16_turns import L2_FLUSH_BYTES, _smi, time_ms

    dev = torch.device("cuda")
    flush = torch.empty(L2_FLUSH_BYTES // 4, device=dev)
    out = {"tree": os.getcwd(), "card": _smi(), "times": {}}
    for shape in shapes:
        b, n, d, h, ratio = shape
        m = int(d * ratio)
        blk, x, dy = block_inputs(shape, 7000 + d, dev)
        w = {k: v.detach() for k, v in block_weights(blk).items()}
        y = block_fused._kernel_forward(x, w, h)
        dx, dw = block_fused._kernel_backward(x, dy, w, h)
        digest = hashlib.sha1(b"".join(
            t.contiguous().view(torch.int32).cpu().numpy().tobytes()
            for t in (y, dx, *dw.values()))).hexdigest()
        plans = {side: block_fused.block_plan(b, n, d, h, m, side == "bwd")
                 for side in ("fwd", "bwd")}
        out["times"][str(shape)] = {
            "design": plans,
            "fwd": time_ms(torch, lambda: block_fused._kernel_forward(x, w, h), flush),
            "bwd": time_ms(torch, lambda: block_fused._kernel_backward(x, dy, w, h), flush),
            "grid": {side: block_fused.streamed_grid(side == "bwd")
                     for side, plan in plans.items() if plan == "streamed"},
            "sha1": digest,
        }
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("trees", nargs="*", help="checkouts to time, in this order")
    ap.add_argument("--shapes", default=None,
                    help='shapes to time in place of SHAPES: "B,N,D,H,ratio;B,N,D,H,ratio"')
    ap.add_argument("--turn", action="store_true", help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    shapes = (SHAPES if args.shapes is None else
              [tuple(int(x) for x in s.split(",")[:4]) + (float(s.split(",")[4]),)
               for s in args.shapes.split(";")])
    if args.turn:
        sys.path.insert(0, os.getcwd())  # the tree's package, not this file's
        print("TURN " + json.dumps(turn(shapes)), flush=True)
        return 0
    if not args.trees:
        ap.error("name at least one tree")
    for tree in args.trees:
        env = dict(os.environ, PYTHONPATH=os.path.abspath(tree))
        proc = subprocess.run(
            [sys.executable, os.path.abspath(__file__), "--turn"]
            + ([] if args.shapes is None else ["--shapes", args.shapes]),
            cwd=tree, env=env, capture_output=True, text=True)
        lines = [x for x in proc.stdout.splitlines() if x.startswith("TURN ")]
        if proc.returncode != 0 or not lines:
            print(proc.stdout[-4000:] + proc.stderr[-4000:], file=sys.stderr)
            return 1
        print(lines[-1], flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
