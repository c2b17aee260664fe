"""Times the bf16 attention kernels of source trees in turns on one card.

    python3 -m vitsom_tpu_torch.ops.attention_bf16_turns [--k2] [--shapes S] [--shares SEEDS]
        [--float32] TREE [TREE ...]

Each TREE is a checkout of the repository (``.`` for this one). The trees
are timed in the order given, each in a fresh interpreter whose working
directory and first import path is the tree, so each runs and builds its
own ``vitsom_tpu_torch`` kernels while the inputs and the timing are this
file's: compare two versions as A B B A in one run, on one card. Each turn
prints one line ``TURN {json}``: the tree, the card's name and power limit
(``nvidia-smi``), and at each of SHAPES the milliseconds of the bf16
forward (``fwd``), below hd 32 up to N 320 the two-pass forward there too
(``fwd_two_pass``: the register tier 0, which the wrapper passes only past
N 320), the backward on bf16 o and do (``bwd``) and on float32 o and do
(``bwd_hybrid``), and SDPA's forward and backward on the same bf16 tensors
(``sdpa_fwd``, ``sdpa_bwd``): each the median of RUNS calls, with
the L2 flushed before each, timed by CUDA events around calls issued in
chunks behind a spin kernel (as ``chip_smoke.time_call``). With ``--k2``
each turn also runs ``profile_step`` on the flagship under bf16 with
``pallas`` (``k2_graphed_step_ms``: its graphed median step ms). The inputs
are q, k, v as the model hands them over: bf16 slices of one [B, N, 3, D]
buffer, made on the card from a seed. ``--shapes "B,N,H,hd;B,N,H,hd"``
times those shapes in place of SHAPES.

With ``--shares SEEDS`` a turn times nothing: at each shape, from each of
SEEDS seeds, it runs the bf16 backward on the forward kernel's bf16 o and
lse and a bf16 do (``pallas``), and gives for dq, dk and dv the share of
elements more than 1 bf16 ulp from ``chip_smoke.bwd_rounded64`` (the tree's
own), the kernel's (``kernel``) beside the float32 plain version's
(``plain``), and a digest of the kernel's outputs (``sha1``: equal digests
in two trees are bitwise-equal outputs); a head dim the tree refuses gives
its error.

With ``--float32`` a turn times the float32 kernels in place of the bf16
ones: at each shape the forward (``fwd``) and the backward on its o and
lse (``bwd``), on float32 q, k, v sliced from one [B, N, 3, D] buffer as
the model hands them over, and a digest of o, lse, dq, dk, dv (``sha1``).
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys

# (B, N, H, hd): the flagship's encoder and decoder, USPS's, SVHN's
# encoder, the JAX tests' row shapes, the one-pass forward's largest N and N
# past it (the two-pass form; the flagship at patch size 1: N 785)
SHAPES = [(128, 197, 2, 8), (128, 197, 2, 2), (128, 65, 2, 8), (128, 65, 2, 2),
          (128, 257, 2, 8), (2, 33, 2, 16), (1, 9, 1, 8), (128, 320, 2, 8), (128, 400, 2, 8),
          (128, 785, 2, 8), (128, 785, 2, 2)]
RUNS = 30
L2_FLUSH_BYTES = 128 << 20  # > the H100's 50 MB L2


def _smi() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()


def time_ms(torch, fn, flush, runs=RUNS, chunk=5, warmup=5) -> float:
    """The median device ms of one call of ``fn``: CUDA events around each
    call, the calls issued ``chunk`` at a time behind a spin kernel that
    holds the card until the chunk is queued (a chunk that was not held is
    dropped and the spin doubled), ``flush`` zeroed before each call."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    spin, times = 20_000_000, []
    while len(times) < runs:
        if spin > 2**31:
            raise RuntimeError("could not hold the card while issuing the timed calls")
        torch.cuda._sleep(spin)
        pairs = []
        for _ in range(chunk):
            flush.zero_()
            a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            a.record()
            fn()
            b.record()
            pairs.append((a, b))
        held = not pairs[0][0].query()
        torch.cuda.synchronize()
        if not held:
            spin *= 2
            continue
        times += [a.elapsed_time(b) for a, b in pairs]
    return statistics.median(times[:runs])


def _two_pass(af, q, k, v, h):
    """The bf16 forward with the register tier 0 (below hd 32: the two-pass
    form at any N)."""
    tiers = af.bf16_hmma_score_tiles
    af.bf16_hmma_score_tiles = lambda n: 0
    try:
        return af._kernel_forward(q, k, v, h)
    finally:
        af.bf16_hmma_score_tiles = tiers


def shares(shapes, seeds: int) -> dict:
    """One tree's 1-ulp shares of the bf16 backward (``--shares``)."""
    import hashlib

    import torch

    from chip_smoke import bf16_ulp, bwd_rounded64
    from vitsom_tpu_torch.ops import attention_fused as af

    dev = torch.device("cuda")
    out = {"tree": os.getcwd(), "card": _smi(), "shares": {}}
    for shape in shapes:
        b, n, h, hd = shape
        d = h * hd
        for seed in range(seeds):
            g = torch.Generator(device=dev).manual_seed(6000 + n + hd + 1000 * seed)
            buf = torch.randn(b, n, 3, d, generator=g, device=dev).to(torch.bfloat16)
            q, k, v = buf[:, :, 0], buf[:, :, 1], buf[:, :, 2]
            do = torch.randn(b, n, d, generator=g, device=dev).to(torch.bfloat16)
            key = f"{shape} seed {seed}"
            try:
                o, lse = af._kernel_forward(q, k, v, h)
            except ValueError as e:
                out["shares"][key] = str(e)
                continue
            grads = af._kernel_backward(q, k, v, o, lse, do, h)
            plain = af.fused_attention_bwd_reference(q, k, v, o, lse, do, h)
            ref = bwd_rounded64(q, k, v, o, lse, do, h)
            row = {"sha1": hashlib.sha1(b"".join(
                x.view(torch.int16).cpu().numpy().tobytes() for x in grads)).hexdigest()}
            for name, a, p, r in zip(("dq", "dk", "dv"), grads, plain, ref):
                ulp = bf16_ulp(r.double())
                row[name] = {
                    "kernel": float(((a.double() - r.double()).abs() > ulp).double().mean()),
                    "plain": float(((p.double() - r.double()).abs() > ulp).double().mean())}
            out["shares"][key] = row
    return out


def turn(k2: bool, shapes) -> dict:
    """One tree's times (the working directory's package)."""
    import torch
    import torch.nn.functional as F

    from vitsom_tpu_torch.ops import attention_fused as af

    dev = torch.device("cuda")
    flush = torch.empty(L2_FLUSH_BYTES // 4, device=dev)
    out = {"tree": os.getcwd(), "card": _smi(), "times": {}}
    for shape in shapes:
        b, n, h, hd = shape
        d = h * hd
        g = torch.Generator(device=dev).manual_seed(6000 + n + hd)
        buf = torch.randn(b, n, 3, d, generator=g, device=dev).to(torch.bfloat16)
        q, k, v = buf[:, :, 0], buf[:, :, 1], buf[:, :, 2]
        do32 = torch.randn(b, n, d, generator=g, device=dev)
        do = do32.to(torch.bfloat16)
        o, lse = af._kernel_forward(q, k, v, h)
        ho, hlse = af.fused_attention_reference(q, k, v, h)
        heads_first = [x.reshape(b, n, h, hd).transpose(1, 2).contiguous() for x in (q, k, v)]
        leaves = [x.clone().requires_grad_() for x in heads_first]
        do_t = do.reshape(b, n, h, hd).transpose(1, 2).contiguous()
        so = F.scaled_dot_product_attention(*leaves)
        fns = {
            "fwd": lambda: af._kernel_forward(q, k, v, h),
            **({"fwd_two_pass": lambda: _two_pass(af, q, k, v, h)} if hd < 32 and n <= 320
               else {}),
            "bwd": lambda: af._kernel_backward(q, k, v, o, lse, do, h),
            "bwd_hybrid": lambda: af._kernel_backward(q, k, v, ho, hlse, do32, h),
            "sdpa_fwd": lambda: F.scaled_dot_product_attention(*heads_first),
            "sdpa_bwd": lambda: torch.autograd.grad(so, leaves, do_t, retain_graph=True),
        }
        out["times"][str(shape)] = {key: time_ms(torch, fn, flush) for key, fn in fns.items()}
    if k2:
        proc = subprocess.run(
            [sys.executable, "-m", "vitsom_tpu_torch.train.profile_step", "--steps", "20",
             "--override", "train.attn_impl=pallas",
             "--override", "train.compute_dtype=bfloat16"],
            capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(f"profile_step failed: {proc.stderr[-2000:]}")
        res = json.loads(proc.stdout.strip().splitlines()[-1])
        out["k2_graphed_step_ms"] = res["graphed"]["step_ms_median"]
    return out


def turn_float32(shapes) -> dict:
    """One tree's float32 times and digests (``--float32``)."""
    import hashlib

    import torch

    from vitsom_tpu_torch.ops import attention_fused as af

    dev = torch.device("cuda")
    flush = torch.empty(L2_FLUSH_BYTES // 4, device=dev)
    out = {"tree": os.getcwd(), "card": _smi(), "times": {}}
    for shape in shapes:
        b, n, h, hd = shape
        d = h * hd
        g = torch.Generator(device=dev).manual_seed(6000 + n + hd)
        buf = torch.randn(b, n, 3, d, generator=g, device=dev)
        q, k, v = buf[:, :, 0], buf[:, :, 1], buf[:, :, 2]
        do = torch.randn(b, n, d, generator=g, device=dev)
        o, lse = af._kernel_forward(q, k, v, h)
        grads = af._kernel_backward(q, k, v, o, lse, do, h)
        digest = hashlib.sha1(b"".join(
            x.contiguous().view(torch.int32).cpu().numpy().tobytes()
            for x in (o, lse, *grads))).hexdigest()
        out["times"][str(shape)] = {
            "fwd": time_ms(torch, lambda: af._kernel_forward(q, k, v, h), flush),
            "bwd": time_ms(torch, lambda: af._kernel_backward(q, k, v, o, lse, do, h), flush),
            "sha1": digest}
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("trees", nargs="*", help="checkouts to time, in this order")
    ap.add_argument("--k2", action="store_true", help="also the flagship's bf16 graphed step")
    ap.add_argument("--shapes", default=None,
                    help='shapes to time in place of SHAPES: "B,N,H,hd;B,N,H,hd"')
    ap.add_argument("--shares", type=int, default=0,
                    help="seeds of the backward's 1-ulp shares at each shape, in place of times")
    ap.add_argument("--float32", action="store_true",
                    help="time the float32 kernels (and digest their outputs) in place of bf16")
    ap.add_argument("--turn", action="store_true", help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    shapes = (SHAPES if args.shapes is None else
              [tuple(int(x) for x in s.split(",")) for s in args.shapes.split(";")])
    if args.turn:
        sys.path.insert(0, os.getcwd())  # the tree's package, not this file's
        out = (turn_float32(shapes) if args.float32 else
               shares(shapes, args.shares) if args.shares else turn(args.k2, shapes))
        print("TURN " + json.dumps(out), flush=True)
        return 0
    if not args.trees:
        ap.error("name at least one tree")
    for tree in args.trees:
        env = dict(os.environ, PYTHONPATH=os.path.abspath(tree))
        proc = subprocess.run(
            [sys.executable, os.path.abspath(__file__), "--turn"] + (["--k2"] if args.k2 else [])
            + ([] if args.shapes is None else ["--shapes", args.shapes])
            + (["--shares", str(args.shares)] if args.shares else [])
            + (["--float32"] if args.float32 else []),
            cwd=tree, env=env, capture_output=True, text=True)
        lines = [x for x in proc.stdout.splitlines() if x.startswith("TURN ")]
        if proc.returncode != 0 or not lines:
            print(proc.stdout[-4000:] + proc.stderr[-4000:], file=sys.stderr)
            return 1
        print(lines[-1], flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
