"""Repeats the smoke's phase-H3 hold (``deit_cifar-10``, graphed against
eager) and reports whether every repetition gives the same bits.

    python3 -m vitsom_tpu_torch.train.graphed_eager_repeat [--reps N] [--load]

Each repetition first fills most of the card's free memory with one of
NaN, 0, random bits or 1e30 and releases it (empty_cache), so that a read
of memory nothing wrote would show; then it builds ``chip_smoke``'s H3
trainer (the seeded ``resnet50.pth`` teacher, the mask probe), runs
H_HOLD_STEPS graphed steps, an eager trainer of the same config over the
same data, and compares the two. It prints, a repetition, the steps whose
losses are bitwise equal, the first that is not, the parameters that
differ and a digest of each run's final parameters and buffers. The last
line is ``BITWISE=True`` when every run of every repetition has one
digest, and the exit code is then 0. ``--load`` keeps the card busy with
float32 products from a second process on two streams meanwhile; that
process is stopped at the end. Runs on the card only.
"""

from __future__ import annotations

import argparse
import hashlib
import os
import subprocess
import sys
import tempfile
import time

POISONS = (float("nan"), 0.0, "random", 1e30)
LOAD_CODE = (
    "import torch\n"
    "a = torch.randn(4096, 4096, device='cuda')\n"
    "streams = (torch.cuda.Stream(), torch.cuda.Stream())\n"
    "while True:\n"
    "    for s in streams:\n"
    "        with torch.cuda.stream(s):\n"
    "            for _ in range(4):\n"
    "                a = torch.tanh(a @ a * 1e-2)\n"
    "    torch.cuda.synchronize()\n"
)


def digest(model) -> str:
    h = hashlib.sha256()
    for _, t in [*model.named_parameters(), *model.named_buffers()]:
        h.update(t.detach().cpu().numpy().tobytes())
    return h.hexdigest()[:16]


def poison(value) -> None:
    """Writes ``value`` over 60 % of the card's free memory and returns it."""
    import torch

    free, _ = torch.cuda.mem_get_info()
    t = torch.empty(int(free * 0.6) // 4, dtype=torch.float32, device="cuda")
    if value == "random":
        t.view(torch.int32).random_()
    else:
        t.fill_(value)
    torch.cuda.synchronize()
    del t
    torch.cuda.empty_cache()


def repetition(dev, root, rep):
    """One H3 hold; returns the graphed and eager runs' digests."""
    import numpy as np
    import torch

    import chip_smoke as cs

    d = os.path.join(root, f"h3_data_{rep}")
    os.makedirs(d)
    cs.write_torchvision_resnet50(os.path.join(d, "resnet50.pth"), seed=13)
    cfg = cs.baseline_cfg(cs.DEIT_CIFAR, root, {"data.data_dir": d,
                                               "data.synthetic_size": cs.H_SIZE})
    cs.MaskProbe.install()
    try:
        tr, probe = cs.baseline_trainer(f"rep{rep}", cs.DEIT_CIFAR, cfg, dev)
        probe.activate()
        hg = tr.fit(max_steps=cs.H_HOLD_STEPS)
        tr_e, probe_e = cs.baseline_trainer(f"rep{rep}_eager", cs.DEIT_CIFAR, cfg, dev,
                                            dm=tr.dm)
        probe_e.activate()
        he = tr_e.fit(max_steps=cs.H_HOLD_STEPS, eager=True)
        losses = {}
        for k in ("train/distill_loss", "train/cls_loss"):
            a, b = np.asarray(hg[k]), np.asarray(he[k])
            unequal = np.flatnonzero(a != b)
            losses[k] = (f"{len(a) - len(unequal)}/{len(a)} bitwise equal, first unequal "
                         f"{int(unequal[0]) if len(unequal) else None}")
        differing = [n for (n, pg), (_, pe) in zip(tr.model.named_parameters(),
                                                   tr_e.model.named_parameters())
                     if not torch.equal(pg, pe)]
        dg, de = digest(tr.model), digest(tr_e.model)
        print(f"rep {rep}: losses {losses}; parameters differing {len(differing)} "
              f"{differing[:5]}; digest graphed={dg} eager={de}", flush=True)
        del tr, tr_e, probe, probe_e
    finally:
        cs.MaskProbe.uninstall()
    torch.cuda.empty_cache()
    return dg, de


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--reps", type=int, default=12)
    p.add_argument("--load", action="store_true",
                   help="a second process keeps the card busy meanwhile")
    args = p.parse_args(argv)
    import torch

    import chip_smoke as cs
    from vitsom_tpu_torch.utils.device import resolve_device

    dev = resolve_device("cuda")
    print(f"card: {cs.nvidia_smi_line()} torch={torch.__version__} load={args.load}", flush=True)
    load = None
    if args.load:
        load = subprocess.Popen([sys.executable, "-c", LOAD_CODE], stdout=subprocess.DEVNULL,
                                stderr=subprocess.DEVNULL)
        time.sleep(10)  # its context and first products are up
    seen = set()
    try:
        with tempfile.TemporaryDirectory() as root:
            for rep in range(args.reps):
                value = POISONS[rep % len(POISONS)]
                t0 = time.perf_counter()
                poison(value)
                seen.update(repetition(dev, root, rep))
                print(f"rep {rep}: poison={value} {time.perf_counter() - t0:.1f} s", flush=True)
    finally:
        if load is not None:
            load.kill()
            load.wait()
    print(f"digests: {sorted(seen)}", flush=True)
    print(f"BITWISE={len(seen) == 1}", flush=True)
    return 0 if len(seen) == 1 else 1


if __name__ == "__main__":
    sys.exit(main())
