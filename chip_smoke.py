"""Drive the PyTorch port's main path on one NVIDIA GPU and check it.

Run from the repository root on a machine with a CUDA card:

    python3 chip_smoke.py

Phases, each printing its own lines; any failure exits non-zero:

1. device: requires CUDA; prints the card's name and power limit;
2. build: compiles the port's CUDA sources with nvcc (sm_90a), one nvcc
   per source, all started together, and prints ptxas's register and spill
   lines; counts the tensor-core instructions in the SASS (``cuobjdump``
   beside nvcc) of the SOM kernel, which fails without a TF32 wgmma
   (HGMMA), of the two hd >= 32 attention kernels, which fail without a
   TF32 mma (HMMA or HGMMA), and of every instantiation of the fused block's
   ``block_fwd_kernel`` and ``block_bwd_kernel``, which fail without a TF32
   mma (HMMA); fails without ``cuobjdump``;
3. kernel vs plain: the fused SOM kernel against its plain PyTorch version
   on the card at every shipped ViT-SOM SOM shape (``SOM_SHAPES``: B, D =
   patch tokens x emb, P) and one ragged shape (B 13, D 1000, P 132), x the
   strided patch-token view of a [B, 1 + N, E] token buffer. Cosine and
   euclidean x square and hexa at P 1600 and 576 and at the ragged shape;
   cosine/square elsewhere, with euclidean added at D 37632. Distances and
   loss to 1e-5, BMUs equal outside near ties, distances and loss bitwise
   equal across two runs; the kernel's distances also against a float64
   evaluation, at most twice the plain float32 version's error there plus
   1e-7 (so a product short of float32 accuracy, one or two TF32 products
   in place of three, fails at every shape). The op's closed-form gradients
   against autograd
   through the plain version (atol 1e-6, rtol 1e-4, and the largest
   difference at most 1e-4 of the largest gradient) at P 1600 and at
   D 37632, P 196, on rows close to their BMU, where the cosine distances
   are also held to 1e-5, and all of them against float64 as above;
4. train: the flagship config ``configs/vit_som/vit_som_mnist.yaml`` as
   shipped (full width, 40x40 map, batch 128, float32) on synthetic
   MNIST-shaped data for 40 steps through ``Trainer.fit``, which runs two
   eager warm-up steps, captures the third as a CUDA graph and replays it
   for the rest, then the clustering eval; the kernel's launch count over
   that run (the wrappers count in Python, so a replay adds nothing: see
   below) must equal 3 + eval batches, and the attention kernels must not
   run (the yaml's attention is ``xla``);
   A (``graph_xla``). the same 40 steps from the same seed run eagerly
   (``fit(eager=True)``: the same step body, batches and kernels, step by
   step): every step's three losses and every final parameter equal the
   graphed run's within rtol 1e-5 (bitwise expected; the largest
   differences are printed), with both runs' median ms a step and
   images/s beside the card's name and power limit;
5. timings: the device time of the kernel, its plain version and one
   library product (the median of 30 CUDA-event timed calls each, the card
   held by a spin while the host issues them; L2 flushed before each call,
   and again with the inputs resident in L2) at every shape of
   ``SOM_SHAPES``, with the split count S and the CTAs of the kernel's
   grid, against the card's bound: three TF32 tensor-core products per
   float32-accurate product (3 * 2 B P D at 495 TFLOP/s) or the bytes at
   3.35 TB/s, whichever is longer, beside the FP32 non-tensor figure
   (2 B P D at 67 TFLOP/s);
6. attention kernels vs plain: the forward kernel's o and lse and the
   backward kernel's dq, dk, dv against their plain PyTorch versions
   (atol/rtol 1e-5, the JAX tests' tolerance), and the gradients also
   against autograd through ``xla_attention``, at every encoder and decoder
   shape of a shipped ViT config (``ATTN_SHAPES``: hd 8 and 2 at N 197, 65
   and 257; hd 64 and 32 at N 65 and 197, B 128, and at N 257, B 512) and
   the JAX tests' row shapes (2, 33, 2, 16) and (1, 9, 1, 8)
   (``ATTN_TEST_SHAPES``), with q, k, v both as strided views of a fused
   qkv buffer and contiguous, and at an hd 2 shape whose views start 4
   bytes off an 8-byte boundary (``ATTN_ODD_SHAPES``: the row kernels'
   4-byte copies; 16- and 8-byte copies run at the other row shapes); two
   runs of each kernel must agree bitwise; each output's error against a
   float64 evaluation may be at most twice the plain float32 version's
   there plus 1e-7 (``F64_FACTOR``, ``F64_SLACK``), which a product short of
   float32 accuracy fails. There both backwards take the float64 forward's
   o and lse rounded to float32, so each is held on its own arithmetic: a
   backward handed the plain forward's lse recomputes p from scores that
   round differently from the ones that lse normalised, an error the plain
   backward, whose scores are that forward's to the bit, does not have.
   ``scaled_dot_product_attention``'s float64 error is printed beside them;
7. train with ``train.attn_impl: pallas``: phase 4's run again, graphed,
   with the attention kernels. Its step-0 losses must equal phase 4's
   within rtol 1e-5 (same seed, same first batch), and every kernel's
   launch count must equal what the code implies (below);
   A (``graph_pallas``). phase A's hold of that run against its eager run;
8. train with ``train.attn_impl: hybrid`` for 10 steps at full width,
   graphed: the forward kernel never runs, the backward kernel once per
   block a step;
9. attention timings: each kernel, its plain version and one library call
   (``scaled_dot_product_attention`` and its gradient, which the port never
   calls) at all 12 shapes of ``ATTN_SHAPES`` (``ATTN_TIMED``: the six
   hd >= 32 shapes, then the six row shapes), L2 flushed, with phase 5's
   timer, against the bound: the largest of the operations 4 B H N^2 hd (forward) and 10 B H N^2 hd
   (backward), as three TF32 products at 495 TFLOP/s for the tensor-core
   kernels (hd >= 32) and at the FP32 67 TFLOP/s for the row kernels
   (printed for both), the B H N^2 exponentials (one a pair, forward and
   backward) at 16 a clock an SM at 1.98 GHz, and the bytes at 3.35 TB/s;
   for each row kernel its CTAs, threads, shared memory, copy width and
   resident CTAs an SM;
10. fused block kernels vs plain: the forward kernel's y against its plain
   version (atol 2e-5, rtol 1e-5, ``tests/test_block_pallas.py:64``) and
   against the port's eager ``models/vit.Block``; the backward kernel's dx
   and 12 weight gradients against its plain version (the closed form) and
   against autograd through the eager Block (atol 2e-5, rtol 1e-4,
   ``:89-94``, and the largest difference at most 1e-4 of the largest
   gradient), at (B, N, D, H, mlp_ratio) = (128, 197, 16, 2, 4) and
   (128, 197, 4, 2, 4) (the flagship's encoder and decoder blocks at full
   width) and the JAX tests' (8, 197, 16, 2, 4), (4, 65, 24, 3, 4),
   (3, 17, 16, 2, 2), (4, 33, 16, 2, 4); two runs of each kernel must agree
   bitwise; y, dx and each of the 12 gradients may be at most
   ``BLOCK_F64_FACTOR`` (5) times the plain float32 version's error against
   a float64 evaluation of the plain version, plus ``F64_SLACK``, which a
   product short of 3xTF32 fails by a factor of hundreds. Weights are
   xavier-uniform with biases and LayerNorm parameters 0.02 off their init;
   the cotangent is a standard normal at the JAX tests' shapes (their own)
   and a standard normal over B at B 128, the cotangent
   of a batch-mean loss: a unit cotangent summed over 128 x 197 rows gives
   weight gradients of ~400, where two float32 summation orders already
   differ by more than atol 2e-5;
11. the fused block on the flagship's activations, the slice's main path:
   phase 4's trained model runs one eval batch while every block's input is
   captured (4 encoder, 2 decoder blocks); each goes through
   ``make_fused_block`` with ``block_weights(blk)`` and is held against
   ``blk(x)`` at phase 10's bounds; then a fixed cotangent is backpropagated
   through the first encoder and the first decoder block both ways and the
   parameters' and inputs' gradients compared;
12. block timings at the two flagship shapes: each kernel (the backward with
   its reduction launch), its plain version, and the port's eager Block
   (forward under no_grad, and forward + backward) with ``attn_impl`` xla
   and pallas, L2 flushed, against the bound, with each kernel's CTAs,
   threads and shared memory. No single PyTorch call computes a block, so
   the eager xla Block stands in the ``library_ms`` column. The bound is the
   largest of three terms: the operations as three TF32 products at 495
   TFLOP/s (the kernels' products run on the tensor cores, but for attention
   at hd 2 on the FP32 cores; the FP32 figure at 67 TFLOP/s is printed
   beside it), the B H N^2 exponentials (one a
   pair, forward and backward, as in phase 9) at 16 a clock an SM, and the
   bytes. Operations: forward 2 B N (4 D^2 + 2 D M) + 4 B H N^2 hd;
   backward the forward + 4 B N (4 D^2 + 2 D M) (each product's input and
   weight gradients) + 8 B H N^2 hd (dv = p^T do, dp = do v^T, dq = ds k,
   dk = ds^T q); bytes x and y (x, dy and dx) and the weights (in the
   backward also their summed gradients). The backward kernel's second
   q k^T (p recomputed from lse), its second exponential of each pair and
   its [B, W] partial gradients are artifacts of its design, not of the
   function, and are not counted.
13. the emb-192 ViT-SOM: ``configs/vit_som/vit_som_cifar-10.yaml`` at its
   full widths and depth (emb 192, depth 12, 3 heads: hd 64; decoder emb 96,
   depth 2: hd 32; N 65; 4x4 map, SOM latent 64 x 192; batch 128, float32,
   no remat) on the clustering objective (``data.num_classes`` 0: the
   yaml's 10 select the classification head, not ported) with un-augmented
   synthetic 32x32x3 images (the cifar transforms are not ported), 20 steps
   and the clustering eval with ``xla`` attention, then with ``pallas``:
   step-0 losses equal within rtol 1e-5, launch counts equal to the formula
   below, recon loss falling, losses finite, reconstructions [128, 32, 32,
   3]; median step ms and images/s of both are printed. Both runs graphed.
B. ``bench.py``'s configuration: the flagship yaml with the overrides of
   ``bench.py:38-59`` (``BENCH_OVERRIDES``: 24x24 map, ``compute_dtype:
   bfloat16``, ``attn_impl: xla_bf16``, no remat, the fused SOM), cut to
   the phase-4 data (4096 + 819 synthetic images, not 70000) and 40 steps
   (not 500 epochs); graphed with the clustering eval, then held against
   its eager run as phase A holds the flagship; recon loss falling, losses
   finite, parameters float32, purity and NMI printed;
C. the kernels under replay: ``vitsom_tpu_torch.train.profile_step`` (a
   process of its own each: one profiler session a process) profiles R =
   20 eager steps and R replays of the flagship with ``xla`` and with
   ``pallas`` and of phase B's configuration; each hand-written kernel's
   count in the profiler's records (CUPTI records a graph's kernels) must
   be R times its count a step in both modes: the SOM's two launches once
   a step, and with ``pallas`` the attention forward 12 times and the
   backward 6 times a step. Wall and device busy ms a step, the idle share
   and the kernels a step of each are printed beside the card's name and
   power limit.

The launch counts below count what the wrappers issue from Python. A
graphed run of S > 2 steps issues its two warm-up steps and the one step
it captures (the capture records the launches; each replay runs them
again, unseen by Python), so there S stands for 3; an eager run issues
all S. Launch counts on a train run of S steps and E eval batches, with one
attention call per block (A = depth + dec_depth = 6 on the flagship) and
remat_blocks (each block's forward runs again in the backward): the fused
SOM kernel runs S + E times; with ``pallas`` the attention forward kernel
runs (2 S + E) A times and the backward kernel S A times; with ``hybrid``
the forward kernel 0 times and the backward kernel S A times. No train run
launches a block kernel. The cifar-10 config has no remat (A = 14): its
``pallas`` run of S steps and E eval batches launches the attention
forward kernel (S + E) 14 times, the backward S 14 times (each launch of
the backward at N 65 is one kernel; at N 197 and 257 its dq partials add a
second, counted with it) and the SOM kernel S + E times. Phase 11
launches the block forward kernel once per flagship block plus once for
each of the two blocks it backpropagates through (6 + 2 = 8), and the
backward kernel once for each of those (2).

The last lines are the ``kernels`` JSON (the attention kernels' rows: the
cifar-10 ``pallas`` run's launches and the (128, 65, 3, 64) timings), the
nvidia-smi line and the result. The whole script takes about 3 minutes on
an H100, the builds included (block.cu, the longest, about 28 s).
"""

from __future__ import annotations

import copy
import json
import math
import os
import statistics
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch
import torch.nn.functional as F

from vitsom_tpu_torch.config import load_config
from vitsom_tpu_torch.convert import block_weights
from vitsom_tpu_torch.data.synthetic import build_datamodule, raw_synthetic_datamodule
from vitsom_tpu_torch.models.vit import Block
from vitsom_tpu_torch.models.vit_som import model_attn_impl
from vitsom_tpu_torch.ops import _build, attention_fused, block_fused, som_fused
from vitsom_tpu_torch.ops.attention import xla_attention
from vitsom_tpu_torch.som import layer as som
from vitsom_tpu_torch.train import steps as steps_lib
from vitsom_tpu_torch.train.trainer import WARMUP_STEPS, Trainer
from vitsom_tpu_torch.utils import initializers
from vitsom_tpu_torch.utils.device import resolve_device

ROOT = os.path.dirname(os.path.abspath(__file__))
CONFIG = os.path.join(ROOT, "configs", "vit_som", "vit_som_mnist.yaml")
CIFAR_CONFIG = os.path.join(ROOT, "configs", "vit_som", "vit_som_cifar-10.yaml")
TRAIN_STEPS = 40
HYBRID_STEPS = 10
CIFAR_STEPS = 20
PROFILE_STEPS = 20  # R: the graph replays (and eager steps) profile_step profiles
# bench.py:38-59's overrides of the flagship yaml, the configuration behind
# the repo's BENCH_*.json; the smoke cuts its data (70000 synthetic images)
# to SYNTHETIC_SIZE and its 500 epochs to TRAIN_STEPS steps
BENCH_OVERRIDES = {
    "som.map_size": [24, 24], "train.use_pallas_som": True,
    "train.compute_dtype": "bfloat16", "train.attn_impl": "xla_bf16",
    "train.remat_blocks": False,
}
# a graphed run's per-step losses and final parameters against the eager
# run's (the same step body and kernels: bitwise equality is expected)
GRAPH_RTOL = 1e-5
KERNEL_SOURCES = ("som_fused", "attention", "block")
# (B, N, H, hd): every encoder and decoder attention shape of a shipped ViT
# config (B, N from the yaml; heads 2 and 3)
ATTN_SHAPES = [
    (128, 197, 2, 8), (128, 197, 2, 2),    # vit_som_mnist, _fmnist (the flagship)
    (128, 65, 2, 8), (128, 65, 2, 2),      # vit_som_usps
    (128, 257, 2, 8), (128, 257, 2, 2),    # vit_som_svhn
    (128, 65, 3, 64), (128, 65, 3, 32),    # vit_som_cifar-10, _cifar-100, vit_cifar-10
    (128, 197, 3, 64), (128, 197, 3, 32),  # vit_som_medmnist, _flowers-17, _flowers-102
    (512, 257, 3, 64), (512, 257, 3, 32),  # vit_som_tiny-imagenet, vit_cifar-100, vit_svhn
]
# the JAX tests' row-kernel shapes (tests/test_pallas_kernels.py:48, :69):
# hd 16, and N 9, a ragged row count
ATTN_TEST_SHAPES = [(2, 33, 2, 16), (1, 9, 1, 8)]
# an hd 2 shape whose q, k, v rows start 4 bytes off an 8-byte boundary (row
# stride 3 D + 1 floats): the row kernels' 4-byte copies
ATTN_ODD_SHAPES = [(128, 197, 2, 2)]
# the tensor-core kernels' shapes (hd >= 32) and the six row-kernel shapes
ATTN_TIMED = [s for s in ATTN_SHAPES if s[3] >= 32] + ATTN_SHAPES[:6]
# the cifar-10 run's encoder shape: the kernels JSON line's attention rows
ATTN_MAIN = (128, 65, 3, 64)
# (B, N, D, H, mlp_ratio): the flagship's encoder and decoder blocks at full
# width, then the JAX tests' blocks (tests/test_block_pallas.py:46-53, :68)
BLOCK_SHAPES = [(128, 197, 16, 2, 4.0), (128, 197, 4, 2, 4.0), (8, 197, 16, 2, 4.0),
                (4, 65, 24, 3, 4.0), (3, 17, 16, 2, 2.0), (4, 33, 16, 2, 4.0)]
BLOCK_TIMED = BLOCK_SHAPES[:2]
BLOCK_Y_TOL = (2e-5, 1e-5)
BLOCK_GRAD_TOL = (2e-5, 1e-4)
# The block kernels' outputs against float64 may be at most this factor of
# the plain float32 version's error, plus F64_SLACK. The earlier FP32 block
# kernels (one row a thread) already read 1.65-4.64x at y and above 2 at nine
# of the 14 outputs (PERF.md, section 6): the kernels sum rows and columns in
# long float32 chains, where the plain version's cuBLAS products and torch
# sums sum in blocks. A product short of 3xTF32 reads far above it (a 1xTF32
# mutant, same section).
BLOCK_F64_FACTOR = 5.0
FIRST_LOSSES = ("train/recon_loss", "train/som_loss", "train/total_loss")
SYNTHETIC_SIZE = 4096  # + 819 test images, concatenated for clustering
# (B, N, E, map) of every shipped ViT-SOM SOM: its latent is the N patch
# tokens of emb E, D = N * E; the first is the main path's
SOM_SHAPES = [
    (128, 196, 16, (40, 40)),   # vit_som_mnist, _fmnist
    (128, 196, 16, (24, 24)),   # bench.py's 24x24 map
    (128, 256, 16, (40, 40)),   # vit_som_svhn
    (128, 64, 16, (40, 40)),    # vit_som_usps
    (128, 64, 192, (4, 4)),     # vit_som_cifar-10
    (128, 64, 192, (14, 14)),   # vit_som_cifar-100
    (128, 196, 192, (14, 14)),  # vit_som_medmnist, _flowers-17, _flowers-102
    (512, 256, 192, (14, 14)),  # vit_som_tiny-imagenet
]
# B 13, D 1000 (not a multiple of the 32-deep chunk), P 132: every edge mask
# and a short last split
SOM_RAGGED = (13, 250, 4, (12, 11))
SOM_FULL_MATRIX = SOM_SHAPES[:2] + [SOM_RAGGED]  # cosine/euclidean x square/hexa
SOM_EUCLIDEAN = SOM_SHAPES[6]  # euclidean beside cosine at D 37632
SOM_GRAD = [SOM_SHAPES[0], SOM_EUCLIDEAN]
TOL = 1e-5
# the kernel's distance error against float64 may be at most this factor of
# the plain float32 version's, plus the slack
F64_FACTOR, F64_SLACK = 2.0, 1e-7
GRAD_ATOL, GRAD_RTOL, GRAD_REL_TO_MAX = 1e-6, 1e-4, 1e-4
TIMED_RUNS = 30
L2_FLUSH_BYTES = 128 << 20  # > the H100's 50 MB L2
# H100 SXM published peaks (NVIDIA data sheet, dense, 700 W)
FP32_FLOPS = 67e12
TF32_FLOPS = 495e12  # tensor cores; a float32-accurate 3xTF32 product is 3 of them
HBM_BYTES_PER_S = 3.35e12
# the boost clock behind FP32_FLOPS (132 SMs x 128 FP32 lanes x 2 x 1.98 GHz)
# and the SFU's exponentials a clock an SM (compute capability 9.0)
SM_CLOCK_HZ = 1.98e9
SFU_EXP_PER_CLOCK = 16


class SmokeFailure(Exception):
    pass


def check(cond, msg):
    if not cond:
        raise SmokeFailure(msg)


def nvidia_smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    )
    return out.stdout.strip().splitlines()[0]


def allclose_err(a, b, atol, rtol):
    """(max |a - b|, whether |a - b| <= atol + rtol * |b| everywhere)."""
    diff = (a - b).abs()
    return float(diff.max()), bool((diff <= atol + rtol * b.abs()).all())


def time_call(fn, flush=None, runs=TIMED_RUNS, chunk=5, warmup=5):
    """(device_ms, host_ms) of one call of ``fn`` on the card.

    ``device_ms`` is the median over ``runs`` calls of a CUDA-event pair
    around each call. The calls are issued in chunks of ``chunk``, each
    behind a spin kernel (``torch.cuda._sleep``) that holds the card until
    the host has issued the whole chunk, so the events time the card's work
    and not the host's Python and launches (a plain version's host work
    outlasts its kernels). A chunk whose first event had already completed
    when the host finished issuing it was not held: it is discarded and the
    spin doubled. Chunks stay small, so the launch queue never fills and
    blocks the host. ``host_ms`` is the host time to issue one call.

    With ``flush`` (a buffer larger than the 50 MB L2), the buffer is
    zeroed before each call, outside its event pair, so the call finds its
    inputs in device memory and not in L2, as the train step's SOM forward
    finds the prototypes after the optimizer has streamed all parameters
    and moments. Without it the inputs stay resident in L2 across calls."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    spin, device, host = 20_000_000, [], []
    while len(device) < runs:
        check(spin <= 2**31, "could not hold the card while issuing the timed calls")
        torch.cuda._sleep(spin)
        pairs = []
        t0 = time.perf_counter()
        for _ in range(chunk):
            if flush is not None:
                flush.zero_()
            a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            a.record()
            fn()
            b.record()
            pairs.append((a, b))
        issue_ms = (time.perf_counter() - t0) * 1e3 / chunk
        held = not pairs[0][0].query()
        torch.cuda.synchronize()
        if not held:
            spin *= 2
            continue
        device += [a.elapsed_time(b) for a, b in pairs]
        host.append(issue_ms)
    return statistics.median(device[:runs]), statistics.median(host)


def som_dims(shape):
    """(B, D, P, map) of a ``SOM_SHAPES`` entry."""
    b, n, e, map_size = shape
    return b, n * e, map_size[0] * map_size[1], map_size


def inputs(shape, seed, dev):
    """x [B, D] laid out as the model hands it over: the patch tokens of a
    [B, 1 + N, E] token buffer, a view whose rows are N*E + E floats apart;
    and prototypes [P, D]."""
    b, n, e, _ = shape
    _, d, p, _ = som_dims(shape)
    g = torch.Generator(device=dev).manual_seed(seed)
    tokens = torch.randn(b, 1 + n, e, generator=g, device=dev)
    x = tokens[:, 1:].reshape(b, d)
    protos = torch.randn(p, d, generator=g, device=dev) * 0.5
    return x, protos


def grad_inputs(shape, seed, dev):
    """Inputs whose BMUs are unambiguous: row b is prototype j_b plus noise
    of a fifth of its size. On plain random inputs a row's two nearest
    prototypes can lie within float32 rounding of each other (the euclidean
    distances are ~60 and differ by ~1e-4 between two summation orders over
    D), so the kernel and the plain version may pick different BMUs and
    hence other weights for that row; here both backward passes see the same
    BMUs, and the comparison tests the backward alone. Needs P >= B."""
    b, _, p, _ = som_dims(shape)
    noise, protos = inputs(shape, seed, dev)
    g = torch.Generator(device=dev).manual_seed(seed + 1)
    j = torch.randperm(p, generator=g, device=dev)[:b]
    return protos[j] + 0.1 * noise, protos


def near_ties(dist, distance):
    """(rows exempt from the BMU check, rows whose two smallest distances lie
    within the absolute TOL): on such rows the BMU may flip between two
    summation orders. Cosine distances are ~1 and use the absolute TOL.
    Euclidean distances are ~60 at these inputs, and two summation orders
    over D already differ by up to ~1e-5 there, so for them the margin is
    widened on purpose to TOL * max(|d|, 1)."""
    top2 = torch.topk(dist, 2, dim=1, largest=False).values
    gap = top2[:, 1] - top2[:, 0]
    absolute = gap <= TOL
    if distance == "cosine":
        return absolute, absolute
    return gap <= TOL * top2[:, 0].abs().clamp_min(1.0), absolute


def float64_err(kd, rd, exact):
    """(the kernel's, the plain version's largest error against the float64
    values ``exact``, whether the kernel's is within F64_FACTOR of the plain
    version's plus F64_SLACK)."""
    kerr = float((kd.double() - exact).abs().max())
    perr = float((rd.detach().double() - exact).abs().max())
    return kerr, perr, kerr <= F64_FACTOR * perr + F64_SLACK


def som_shape_label(shape):
    b, d, p, map_size = som_dims(shape)
    splits, depth = som_fused.plan_splits(b, p, d)
    return (f"B={b} D={d} P={p} ({map_size[0]}x{map_size[1]}) S={splits} "
            f"split_depth={depth} ctas={som_fused.grid_ctas(b, p, d)}")


def phase_kernel_vs_plain(dev):
    """Phase 3; returns the largest distance/loss error."""
    worst = 0.0
    temp = 3.7
    for idx, shape in enumerate(SOM_SHAPES + [SOM_RAGGED]):
        b, d, p, map_size = som_dims(shape)
        cols = map_size[1]
        label = som_shape_label(shape)
        cases = [("cosine", "square")]
        if shape in SOM_FULL_MATRIX:
            cases = [(dist, top) for dist in ("cosine", "euclidean") for top in ("square", "hexa")]
        elif shape == SOM_EUCLIDEAN:
            cases.append(("euclidean", "square"))
        x, protos = inputs(shape, 1000 + idx, dev)
        exact = {}  # float64 distances, to show each float32 version's own error
        for distance, topology in cases:
            kl, kb, kd = som_fused._kernel_forward(x, protos, temp, cols, topology, distance)
            kl2, _, kd2 = som_fused._kernel_forward(x, protos, temp, cols, topology, distance)
            rl, rb, rd = som_fused.fused_som_reference(x, protos, temp, cols, topology, distance)
            if distance not in exact:
                exact[distance] = som_fused.fused_som_reference(
                    x.double(), protos.double(), temp, cols, topology, distance)[2]
            torch.cuda.synchronize()
            derr, dok = allclose_err(kd, rd, TOL, TOL)
            near_tie, near_tie_abs = near_ties(rd, distance)
            mismatch = (kb != rb) & ~near_tie
            # the loss with the kernel's BMUs over the plain distances: equal
            # to the plain loss wherever the BMUs agree
            w = torch.exp(
                -som_fused.grid_d2_rows(kb, p, cols, topology) / som.two_t_squared(temp)
            )
            ref_loss = torch.sum(w * rd) / (b * p)
            lerr, lok = allclose_err(kl, ref_loss, TOL, TOL)
            same = torch.equal(kl, kl2) and torch.equal(kd, kd2)
            kerr, perr, f64_ok = float64_err(kd, rd, exact[distance])
            worst = max(worst, derr, lerr)
            print(
                f"kernel_vs_plain {label} {distance} {topology}: dist_max_abs_err={derr:.3e} "
                f"loss={float(kl):.7f} plain_loss={float(rl):.7f} loss_abs_err={lerr:.3e} "
                f"bmu_mismatch={int(mismatch.sum())} near_tie_rows={int(near_tie.sum())} "
                f"near_tie_rows_abs={int(near_tie_abs.sum())} deterministic={same} "
                f"float64: kernel_err={kerr:.3e} plain_err={perr:.3e}",
                flush=True,
            )
            where = f"B={b} D={d} P={p} {distance} {topology}"
            check(dok, f"distances disagree at {where}: {derr}")
            check(f64_ok, f"distances further from float64 than {F64_FACTOR} x the plain "
                          f"version's + {F64_SLACK} at {where}: {kerr} vs {perr}")
            check(lok, f"loss disagrees at {where}: {lerr}")
            check(int(mismatch.sum()) == 0, f"BMU mismatch at {where}")
            check(same, f"two kernel runs gave different losses or distances at {where}")
            check(kb.dtype == torch.int64 and kd.shape == (b, p), "bad output dtype/shape")

    for shape in SOM_GRAD:
        b, d, p, map_size = som_dims(shape)
        cols = map_size[1]
        for distance in ("cosine", "euclidean"):
            x, protos = grad_inputs(shape, 2000 + d + p, dev)
            xk, pk = x.clone().requires_grad_(), protos.clone().requires_grad_()
            kl, kb, kd = som_fused.FusedSOM.apply(xk, pk, temp, cols, "square", distance)
            kl.backward()
            xr, pr = x.clone().requires_grad_(), protos.clone().requires_grad_()
            rl, rb, rd = som_fused.fused_som_reference(xr, pr, temp, cols, "square", distance)
            rl.backward()
            where = f"B={b} D={d} P={p} {distance}"
            check(torch.equal(kb, rb), f"BMUs differ on the gradient inputs at {where}")
            # rows close to their BMU, as trained latents are: the cosine
            # distances hold to the same bound; the euclidean ones cancel
            # |x|^2 - 2 x.p + |p|^2 to a small difference, where the plain
            # version itself is ~1e-4 off float64, so they are held only
            # against float64, relative to the plain version's error there
            d64 = som_fused.fused_som_reference(
                x.double(), protos.double(), temp, cols, "square", distance)[2]
            derr, dok = allclose_err(kd, rd.detach(), TOL, TOL)
            kerr, perr, f64_ok = float64_err(kd, rd, d64)
            print(
                f"near_bmu {where}: dist_max_abs_err={derr:.3e} float64: "
                f"kernel_err={kerr:.3e} plain_err={perr:.3e}",
                flush=True,
            )
            if distance == "cosine":
                check(dok, f"distances disagree near the BMUs at {where}: {derr}")
            check(f64_ok, f"distances near the BMUs further from float64 than {F64_FACTOR} x "
                          f"the plain version's + {F64_SLACK} at {where}: {kerr} vs {perr}")
            for name, a, r in (("dx", xk.grad, xr.grad), ("dp", pk.grad, pr.grad)):
                err, ok = allclose_err(a, r, GRAD_ATOL, GRAD_RTOL)
                scale = float(r.abs().max())
                # atol 1e-6 alone exceeds the cosine gradients (~1e-7)
                ok = ok and err <= GRAD_REL_TO_MAX * scale
                print(
                    f"grad_vs_autograd {where} {name}: max_abs_err={err:.3e} "
                    f"max_abs_grad={scale:.3e} rel_to_max={err / max(scale, 1e-30):.3e}",
                    flush=True,
                )
                check(ok, f"{name} disagrees at {where}: {err}")
    return worst


def reset_launches():
    som_fused.LAUNCHES = 0
    attention_fused.LAUNCHES_FWD = 0
    attention_fused.LAUNCHES_BWD = 0
    block_fused.LAUNCHES_FWD = 0
    block_fused.LAUNCHES_BWD = 0


def read_launches():
    return {"som_fused": som_fused.LAUNCHES, "attention_fwd": attention_fused.LAUNCHES_FWD,
            "attention_bwd": attention_fused.LAUNCHES_BWD,
            "block_fwd": block_fused.LAUNCHES_FWD, "block_bwd": block_fused.LAUNCHES_BWD}


def issued_steps(steps, eager):
    """Train steps whose launches the wrappers' counters see: every eager
    step; of a graphed run, the WARMUP_STEPS eager steps and the one
    captured (its replays launch no Python)."""
    return steps if eager or steps <= WARMUP_STEPS else WARMUP_STEPS + 1


def expected_launches(cfg, impl, steps, eval_batches):
    """What the code implies (module docstring): one attention call per
    block; with remat each block's forward runs again in the backward; the
    eval runs the forward only, under no_grad."""
    per_forward = cfg.vit.depth + cfg.vit.dec_depth
    passes = 2 if cfg.train.remat_blocks else 1
    return {
        "som_fused": steps + eval_batches,
        "attention_fwd": (steps * passes + eval_batches) * per_forward if impl == "pallas" else 0,
        "attention_bwd": steps * per_forward if impl in ("pallas", "hybrid") else 0,
        "block_fwd": 0,
        "block_bwd": 0,
    }


def train_run(dev, label, impl, steps, evaluate, config=CONFIG, make_dm=build_datamodule,
              data="synthetic MNIST-shaped images", extra=None, eager=False):
    """Trains ``config`` (attention ``impl``, or as shipped when None; more
    overrides in ``extra``) for ``steps`` steps on the data module
    ``make_dm`` builds, as replays of one captured step (``eager``: the
    step body step by step) and, with ``evaluate``, runs the clustering
    eval; prints and checks what every train phase checks. Returns (cfg,
    dm, trainer, hist, launches)."""
    over = {"data.allow_synthetic": True, "data.synthetic_size": SYNTHETIC_SIZE, **(extra or {})}
    if impl is not None:
        over["train.attn_impl"] = impl
    cfg = load_config(config, over)
    impl = model_attn_impl(cfg)
    print(
        f"{label}: config {os.path.basename(config)} map={cfg.som.map_size} emb={cfg.vit.emb_dim} "
        f"depth={cfg.vit.depth} dec_emb={cfg.vit.dec_emb_dim} dec_depth={cfg.vit.dec_depth} "
        f"heads={cfg.vit.heads} patch={cfg.vit.patch_size} batch={cfg.batch_size} "
        f"distance={cfg.som.distance_fcn} use_pallas_som={cfg.train.use_pallas_som} "
        f"remat={cfg.train.remat_blocks} compute={cfg.train.compute_dtype} attn_impl={impl} "
        f"num_classes={cfg.data.num_classes} data={data} "
        f"mode={'eager' if eager else 'graphed'}",
        flush=True,
    )
    dm = make_dm(cfg, dev)
    trainer = Trainer(cfg, device=dev, dm=dm)
    n_params = sum(p.numel() for p in trainer.model.parameters())
    eval_batches = dm.n_train // cfg.batch_size if evaluate else 0

    reset_launches()
    t0 = time.perf_counter()
    hist = trainer.fit(max_steps=steps, eager=eager)
    res = trainer.evaluate() if evaluate else None
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = read_launches()
    want = expected_launches(cfg, impl, issued_steps(trainer.step, eager), eval_batches)
    check(eager or trainer.step <= WARMUP_STEPS or trainer.graph is not None,
          f"{label}: the graphed run captured no graph")

    recon = hist["train/recon_loss"]
    total = hist["train/total_loss"]
    step_ms = statistics.median(trainer.step_ms[5:])
    print(
        f"{label}: params={n_params} images={dm.n_train} steps={trainer.step} "
        f"recon_loss first={recon[0]:.6f} last={recon[-1]:.6f} "
        f"total_loss last={total[-1]:.6f} som_loss last={hist['train/som_loss'][-1]:.6f}",
        flush=True,
    )
    print(
        f"{label}: median_step_ms={step_ms:.4f} images_per_s={cfg.batch_size / step_ms * 1e3:.1f} "
        f"(steps 6-{trainer.step}, CUDA events between step ends) wall_s={wall:.3f}",
        flush=True,
    )
    if res is not None:
        print(
            f"{label} eval: purity={res['purity']:.4f} nmi={res['nmi']:.4f} "
            f"batches={eval_batches} inference_s={res['inference_time']:.4f}",
            flush=True,
        )
        check(0.0 <= res["purity"] <= 1.0 and 0.0 <= res["nmi"] <= 1.0, "bad purity/NMI")
    print(
        f"{label} launches: " + " ".join(f"{k}={v} (expected {want[k]})" for k, v in launches.items())
        + f" [train steps {trainer.step} ({issued_steps(trainer.step, eager)} issued from "
        f"Python, the rest graph replays), eval batches {eval_batches}]",
        flush=True,
    )
    check(trainer.step == steps, f"trained {trainer.step} steps, not {steps}")
    check(all(math.isfinite(v) for v in total), "non-finite total loss")
    check(all(math.isfinite(v) for v in hist["train/som_loss"]), "non-finite SOM loss")
    check(recon[-1] < recon[0], f"recon loss did not fall: {recon[0]} -> {recon[-1]}")
    check(launches == want, f"{label}: launch counts {launches} != {want}")
    return cfg, dm, trainer, hist, launches


def phase_train(dev):
    """Phase 4; returns (the SOM kernel's launch count over the main path,
    the step-0 losses, the run: train_run's tuple)."""
    run = train_run(dev, "train", None, TRAIN_STEPS, evaluate=True)
    cfg, dm, trainer, hist, launches = run

    # the kernel-based eval step against the plain SOM path on one batch
    model = trainer.model
    batch = next(dm.eval_batches())
    temp = trainer.current_temperature()
    out = steps_lib.make_vit_som_eval_step(cfg, model)(batch, temp)
    with torch.no_grad():
        _, recon_img, _, dist, bmu = model(batch["image"])
        table = torch.from_numpy(som.grid_sq_distances(cfg.som.map_size, cfg.som.topology)).to(dev)
        # the plain loss at the kernel's BMUs: equal to the plain path's
        # wherever the BMUs agree, and still comparable on a near tie
        ref_som = som.som_loss(som.neighborhood_weights(out["bmu"], table, temp), dist)
    near_tie, near_tie_abs = near_ties(dist, cfg.som.distance_fcn)
    mism = int(((out["bmu"] != bmu) & ~near_tie).sum())
    serr = abs(float(out["som_loss"]) - float(ref_som))
    print(
        f"eval_step_vs_plain: bmu_mismatch={mism} near_tie_rows={int(near_tie.sum())} "
        f"near_tie_rows_abs={int(near_tie_abs.sum())} "
        f"som_loss_abs_err={serr:.3e} recon_shape={tuple(recon_img.shape)}",
        flush=True,
    )
    check(mism == 0 and serr <= TOL + TOL * abs(float(ref_som)), "eval step disagrees with plain path")
    check(tuple(recon_img.shape) == (cfg.batch_size, 28, 28, 1), "bad recon shape")
    return launches["som_fused"], {k: float(hist[k][0]) for k in FIRST_LOSSES}, run


def check_first_losses(label, hist, xla_first):
    """The step-0 losses of ``hist`` against the xla run's, within rtol TOL."""
    for k in FIRST_LOSSES:
        a, b = float(hist[k][0]), xla_first[k]
        rel = abs(a - b) / max(abs(b), 1e-30)
        print(f"{label} step0 {k}={a:.8f} xla={b:.8f} rel_err={rel:.3e}", flush=True)
        check(rel <= TOL, f"{label} step-0 {k} differs from the xla run: {a} vs {b}")


def phase_train_attention(dev, impl, steps, evaluate, xla_first):
    """Phases 7 and 8; returns the run (train_run's tuple)."""
    run = train_run(dev, f"train_{impl}", impl, steps, evaluate)
    check_first_losses(f"train_{impl}", run[3], xla_first)
    return run


def phase_graphed_vs_eager(dev, label, impl, graphed, smi, extra=None):
    """Phases A and B: the graphed run ``graphed`` (train_run's tuple)
    against an eager run of the same config, seed and steps (the same step
    body, batches and kernels): every step's three losses and every final
    parameter within rtol GRAPH_RTOL (bitwise equality expected; the largest
    differences are printed). Prints both runs' median ms a step and
    images/s beside the card's name and power limit."""
    cfg, _, tr_g, hist_g, _ = graphed
    _, _, tr_e, hist_e, _ = train_run(dev, f"{label}_eager", impl, tr_g.step, False,
                                      extra=extra, eager=True)
    for k in FIRST_LOSSES:
        a, b = np.asarray(hist_g[k]), np.asarray(hist_e[k])
        check(a.shape == b.shape, f"{label}: {k} has {a.shape} steps graphed, {b.shape} eager")
        diff = np.abs(a - b)
        rel = float((diff / np.maximum(np.abs(b), 1e-30)).max())
        print(f"{label} graphed_vs_eager {k}: steps={len(a)} max_abs_diff={diff.max():.3e} "
              f"max_rel_diff={rel:.3e} bitwise_equal_steps={int((a == b).sum())}", flush=True)
        check(rel <= GRAPH_RTOL, f"{label}: graphed {k} differs from eager by {rel:.3e}")
    worst, equal, total = (0.0, ""), 0, 0
    for (name, pg), (_, pe) in zip(tr_g.model.named_parameters(), tr_e.model.named_parameters()):
        d = (pg.detach() - pe.detach()).abs()
        rel = float((d / pe.detach().abs().clamp_min(1e-30)).max())
        worst = max(worst, (rel, name))
        equal += int((d == 0).sum())
        total += d.numel()
        check(bool((d <= GRAPH_RTOL * pe.detach().abs()).all()),
              f"{label}: final parameter {name} differs graphed vs eager (max rel {rel:.3e})")
    print(f"{label} graphed_vs_eager params: max_rel_diff={worst[0]:.3e} ({worst[1]}) "
          f"bitwise_equal={equal}/{total}", flush=True)
    for mode, tr in (("graphed", tr_g), ("eager", tr_e)):
        ms = statistics.median(tr.step_ms[5:])
        print(f"{label} {mode}: median_step_ms={ms:.4f} images_per_s={cfg.batch_size / ms * 1e3:.1f} "
              f"(steps 6-{tr.step}, CUDA events between step ends) card: {smi}", flush=True)


def phase_bench(dev, smi):
    """Phase B: bench.py's configuration (BENCH_OVERRIDES), graphed with the
    clustering eval, then held against its eager run as phase A holds the
    flagship."""
    run = train_run(dev, "bench", None, TRAIN_STEPS, evaluate=True, extra=BENCH_OVERRIDES)
    cfg, _, trainer, _, _ = run
    check(cfg.train.compute_dtype == "bfloat16" and model_attn_impl(cfg) == "xla_bf16"
          and not cfg.train.remat_blocks and tuple(cfg.som.map_size) == (24, 24),
          "phase B did not build bench.py's configuration")
    check(next(trainer.model.parameters()).dtype == torch.float32, "bf16 parameters")
    phase_graphed_vs_eager(dev, "bench", None, run, smi, extra=BENCH_OVERRIDES)


def profile_run(label, overrides):
    """``profile_step`` on the flagship yaml with ``overrides``, in a process
    of its own (one profiler session a process); returns its JSON line."""
    cmd = [sys.executable, "-m", "vitsom_tpu_torch.train.profile_step", "--config", CONFIG,
           "--steps", str(PROFILE_STEPS)]
    for k, v in overrides.items():
        cmd += ["--override", f"{k}={json.dumps(v)}"]
    out = subprocess.run(cmd, cwd=ROOT, capture_output=True, text=True, timeout=600)
    lines = out.stdout.strip().splitlines()
    for line in lines[:-1]:
        print(f"profile_step[{label}]: {line}", flush=True)
    check(out.returncode == 0 and lines,
          f"profile_step[{label}] failed ({out.returncode}): {out.stderr[-2000:]}")
    return json.loads(lines[-1])


def phase_profiles(smi):
    """Phase C: the kernels that execute under replay. ``profile_step``
    profiles PROFILE_STEPS eager steps and PROFILE_STEPS replays of the
    captured step of the flagship with ``xla`` and with ``pallas`` and of
    bench.py's configuration; each hand-written kernel's count in the
    profiler's records must be R times its count a step (the flagship's and
    the bench configuration's attention runs the row kernels, hd 8 and 2),
    in both modes. Prints wall and device busy ms a step, the idle share
    and the kernels a step beside the card's name and power limit."""
    for label, over in (("xla", {}), ("pallas", {"train.attn_impl": "pallas"}),
                        ("bench", BENCH_OVERRIDES)):
        res = profile_run(label, over)
        cfg = load_config(CONFIG, {"data.allow_synthetic": True, **over})
        per = expected_launches(cfg, model_attn_impl(cfg), PROFILE_STEPS, 0)
        want = {"som_partial_kernel": per["som_fused"], "som_finalize_kernel": per["som_fused"],
                "attn_fwd_kernel": per["attention_fwd"], "attn_fwd_mma_kernel": 0,
                "attn_bwd_kernel": per["attention_bwd"], "attn_bwd_mma_kernel": 0}
        for mode in ("eager", "graphed"):
            r = res[mode]
            print(f"profile {label} {mode}: wall_ms_per_step={r['wall_ms_per_step']:.4f} "
                  f"images_per_s={cfg.batch_size / r['wall_ms_per_step'] * 1e3:.1f} "
                  f"step_ms_median={r['step_ms_median']:.4f} "
                  f"device_busy_ms_per_step={r['device_busy_ms_per_step']:.4f} "
                  f"device_idle_share={r['device_idle_share']:.4f} "
                  f"kernels_per_step={r['kernels_per_step']:.1f} card: {smi}", flush=True)
            print(f"profile {label} {mode} kernels over R={PROFILE_STEPS}: "
                  + " ".join(f"{k}={r['kernel_counts'][k]} (expected {v})" for k, v in want.items()),
                  flush=True)
            check(r["kernel_counts"] == want,
                  f"profile {label} {mode}: kernel counts {r['kernel_counts']} != {want}")


def phase_train_cifar(dev):
    """Phase 13: the emb-192 ViT-SOM at full width; returns the pallas run's
    launch counts.

    ``configs/vit_som/vit_som_cifar-10.yaml`` at its full widths and depth
    (emb 192, depth 12, 3 heads, decoder emb 96 and depth 2, 4x4 map, SOM
    latent D = 64 x 192, batch 128, float32, no remat), trained on the
    clustering objective (``data.num_classes`` 0: the yaml's 10 select the
    classification head, which is not ported) on un-augmented synthetic
    32x32x3 images (the cifar transforms and augmentation are not ported),
    once with
    ``xla`` and once with ``pallas`` attention, CIFAR_STEPS steps and the
    clustering eval each. The pallas run's step-0 losses equal the xla
    run's within rtol 1e-5 and its launch counts the formula (module
    docstring); its reconstructions of one eval batch are finite and
    [128, 32, 32, 3]."""
    data = "un-augmented synthetic 32x32x3 images (cifar transforms not ported)"
    first, launches = None, None
    for impl in ("xla", "pallas"):
        label = f"cifar10_{impl}"
        cfg, dm, trainer, hist, launches = train_run(
            dev, label, impl, CIFAR_STEPS, True, config=CIFAR_CONFIG,
            make_dm=raw_synthetic_datamodule, data=data, extra={"data.num_classes": 0})
        if first is None:
            first = {k: float(hist[k][0]) for k in FIRST_LOSSES}
        else:
            check_first_losses(label, hist, first)
        with torch.no_grad():
            _, recon_img, _, dist, _ = trainer.model(next(dm.eval_batches())["image"])
        shape = (cfg.batch_size, cfg.data.input_size, cfg.data.input_size, cfg.data.num_channels)
        print(f"{label}: recon_shape={tuple(recon_img.shape)} dist_shape={tuple(dist.shape)}",
              flush=True)
        check(tuple(recon_img.shape) == shape == (128, 32, 32, 3), "bad cifar-10 recon shape")
        check(bool(torch.isfinite(recon_img).all()), "non-finite cifar-10 reconstruction")
        del trainer, dm
    return launches


def attn_inputs(shape, seed, dev, layout):
    """q, k, v [B, N, D] and a cotangent do. ``layout`` "strided": q, k, v
    are views of one [B, N, 3, D] buffer, rows 3 D floats apart, as the
    model's fused qkv projection hands them over below dim 128; "odd": views
    of a [B, N, 3 D + 1] buffer from float 1 on, so every row starts 4 bytes
    off an 8-byte boundary; "contiguous": three tensors."""
    b, n, h, hd = shape
    d = h * hd
    g = torch.Generator(device=dev).manual_seed(seed)
    if layout == "strided":
        buf = torch.randn(b, n, 3, d, generator=g, device=dev)
        q, k, v = buf[:, :, 0], buf[:, :, 1], buf[:, :, 2]
    elif layout == "odd":
        buf = torch.randn(b, n, 3 * d + 1, generator=g, device=dev)
        q, k, v = (buf[:, :, 1 + i * d:1 + (i + 1) * d] for i in range(3))
    else:
        q, k, v = (torch.randn(b, n, d, generator=g, device=dev) for _ in range(3))
    return q, k, v, torch.randn(b, n, d, generator=g, device=dev)


def sdpa_grads(q, k, v, do, heads):
    """o and (dq, dk, dv) of ``scaled_dot_product_attention`` in the kernels'
    [B, N, D] layout (the yardstick's float64 error; the port never calls it)."""
    b, n, d = q.shape
    leaves = [x.detach().reshape(b, n, heads, d // heads).transpose(1, 2).contiguous()
              .requires_grad_() for x in (q, k, v)]
    out = F.scaled_dot_product_attention(*leaves)
    grads = torch.autograd.grad(out, leaves, do.reshape(b, n, heads, d // heads).transpose(1, 2))
    return tuple(x.detach().transpose(1, 2).reshape(b, n, d) for x in (out, *grads))


def phase_attention_vs_plain(dev):
    """Phase 6; returns the largest forward and backward errors."""
    worst = {"attention_fwd": 0.0, "attention_bwd": 0.0}
    cases = [(s, layout) for s in ATTN_SHAPES + ATTN_TEST_SHAPES
             for layout in ("strided", "contiguous")]
    for shape, layout in cases + [(s, "odd") for s in ATTN_ODD_SHAPES]:
        b, n, h, hd = shape
        q, k, v, do = attn_inputs(shape, 4000 + n + hd, dev, layout)
        o, lse = attention_fused._kernel_forward(q, k, v, h)
        o2, lse2 = attention_fused._kernel_forward(q, k, v, h)
        ro, rlse = attention_fused.fused_attention_reference(q, k, v, h)
        # the backward on the plain forward's residuals, beside its plain version
        grads = attention_fused._kernel_backward(q, k, v, ro, rlse, do, h)
        grads2 = attention_fused._kernel_backward(q, k, v, ro, rlse, do, h)
        rgrads = attention_fused.fused_attention_bwd_reference(q, k, v, ro, rlse, do, h)
        leaves = [x.detach().reshape(b, n, h, hd).requires_grad_() for x in (q, k, v)]
        xo, _ = xla_attention(*leaves)
        agrads = torch.autograd.grad(xo, leaves, do.reshape(b, n, h, hd))
        # float64 outputs: each float32 version's own error; both
        # backwards take the float64 forward's o and lse rounded to float32
        q64, k64, v64, do64 = (x.double() for x in (q, k, v, do))
        eo, else64 = attention_fused.fused_attention_reference(q64, k64, v64, h)
        exact = (eo, else64, *attention_fused.fused_attention_bwd_reference(
            q64, k64, v64, eo, else64, do64, h))
        res = (eo.float(), else64.float())
        kgrads = attention_fused._kernel_backward(q, k, v, *res, do, h)
        pgrads = attention_fused.fused_attention_bwd_reference(q, k, v, *res, do, h)
        sdpa = sdpa_grads(q, k, v, do, h)
        torch.cuda.synchronize()
        errs = {"o": allclose_err(o, ro, TOL, TOL), "lse": allclose_err(lse, rlse, TOL, TOL)}
        for name, a, r, x in zip(("dq", "dk", "dv"), grads, rgrads, agrads):
            errs[name] = allclose_err(a, r, TOL, TOL)
            errs[name + "_vs_autograd"] = allclose_err(a, x.reshape(b, n, h * hd), TOL, TOL)
        f64 = {}
        for name, a, r, e in zip(("o", "lse", "dq", "dk", "dv"), (o, lse, *kgrads),
                                 (ro, rlse, *pgrads), exact):
            f64[name] = float64_err(a, r, e)
        sdpa_f64 = [float((x.double() - e).abs().max())
                    for x, e in zip(sdpa, (eo, *exact[2:]))]
        same = (torch.equal(o, o2) and torch.equal(lse, lse2)
                and all(torch.equal(a, c) for a, c in zip(grads, grads2)))
        if hd not in attention_fused.MMA_HEAD_DIMS:
            width = attention_fused.row_copy_width((q, k, v, ro, do), hd)
            check(layout != "odd" or width == 4, f"odd views at {shape} copy {width} bytes")
            layout += f", {width}-byte row copies"
            print(f"attention_row_launch (B,N,H,hd)={shape} {layout}: (CTAs, threads, "
                  f"smem bytes, resident CTAs an SM) forward "
                  f"{attention_fused.row_launch(b, n, h, hd, False, width)} backward "
                  f"{attention_fused.row_launch(b, n, h, hd, True, width)}", flush=True)
        print(
            f"attention_vs_plain (B,N,H,hd)={shape} {layout}: "
            + " ".join(f"{k}_max_abs_err={e:.3e}" for k, (e, _) in errs.items())
            + f" deterministic={same}",
            flush=True,
        )
        print(
            f"attention_vs_float64 (B,N,H,hd)={shape} {layout}: "
            + " ".join(f"{k}: kernel={ke:.3e} plain={pe:.3e}" for k, (ke, pe, _) in f64.items())
            + " sdpa: " + " ".join(f"{k}={e:.3e}" for k, e in zip(("o", "dq", "dk", "dv"), sdpa_f64)),
            flush=True,
        )
        for k, (e, ok) in errs.items():
            check(ok, f"attention {k} disagrees at {shape} {layout}: {e}")
            side = "attention_fwd" if k in ("o", "lse") else "attention_bwd"
            worst[side] = max(worst[side], e)
        for k, (ke, pe, ok) in f64.items():
            check(ok, f"attention {k} further from float64 than {F64_FACTOR} x the plain "
                      f"version's + {F64_SLACK} at {shape} {layout}: {ke} vs {pe}")
        check(same, f"two attention kernel runs differ at {shape} {layout}")
        check(o.shape == (b, n, h * hd) and lse.shape == (b, h, n), "bad attention output shape")
        del q64, k64, v64, do64, exact, eo, else64, sdpa, res, kgrads, pgrads
    return worst


def sdpa_backend(q, k, v) -> str:
    """The backend PyTorch's dispatcher picks for these inputs (printed
    beside the library time only)."""
    choose = getattr(torch, "_fused_sdp_choice", None)
    if choose is None:
        return "not reported"
    from torch.nn.attention import SDPBackend

    names = {m.value: name for name, m in SDPBackend.__members__.items()}
    return names.get(int(choose(q, k, v)), "unknown")


def phase_attention_timings(dev):
    """Phase 9; returns {(shape, kernel name): row} of the timed shapes
    (``ATTN_TIMED``).

    The kernels and plain versions take the main path's layout (strided
    views below dim 128); the library call takes pre-transposed contiguous
    [B, H, N, hd] tensors. Bytes count each input and output once; the
    JAX CostEstimate's 7*B*N*D*4 backward bytes leaves out one tensor.
    Exponentials: one a (query, key) pair, forward and backward alike."""
    rows = {}
    l2_flush = torch.empty(L2_FLUSH_BYTES // 4, device=dev)
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    exp_per_s = sms * SFU_EXP_PER_CLOCK * SM_CLOCK_HZ
    for shape in ATTN_TIMED:
        b, n, h, hd = shape
        d = h * hd
        layout = "strided" if d < 128 else "contiguous"
        q, k, v, do = attn_inputs(shape, 5000 + n + hd, dev, layout)
        o, lse = attention_fused._kernel_forward(q, k, v, h)
        heads_first = [x.reshape(b, n, h, hd).transpose(1, 2).contiguous() for x in (q, k, v)]
        leaves = [x.clone().requires_grad_() for x in heads_first]
        do_t = do.reshape(b, n, h, hd).transpose(1, 2).contiguous()
        sdpa_out = F.scaled_dot_product_attention(*leaves)
        cases = {
            "attention_fwd": (
                {"kernel": lambda: attention_fused._kernel_forward(q, k, v, h),
                 "plain": lambda: attention_fused.fused_attention_reference(q, k, v, h),
                 "library": lambda: F.scaled_dot_product_attention(*heads_first)},
                4 * b * h * n * n * hd, 16 * b * n * d + 4 * b * h * n, b * h * n * n,
                sdpa_backend(*heads_first),
            ),
            "attention_bwd": (
                {"kernel": lambda: attention_fused._kernel_backward(q, k, v, o, lse, do, h),
                 "plain": lambda: attention_fused.fused_attention_bwd_reference(
                     q, k, v, o, lse, do, h),
                 "library": lambda: torch.autograd.grad(
                     sdpa_out, leaves, do_t, retain_graph=True)},
                10 * b * h * n * n * hd, 32 * b * n * d + 4 * b * h * n, b * h * n * n,
                sdpa_backend(*leaves),
            ),
        }
        tensor = hd in attention_fused.MMA_HEAD_DIMS
        for name, (fns, flops, nbytes, n_exp, backend) in cases.items():
            t = {key: time_call(fn, l2_flush)[0] for key, fn in fns.items()}
            # the tensor-core kernels do a float32-accurate product as three
            # TF32 products; the row kernels run on the FP32 cores
            t_fp32 = flops / FP32_FLOPS * 1e3
            t_ops = 3 * flops / TF32_FLOPS * 1e3 if tensor else t_fp32
            t_exp = n_exp / exp_per_s * 1e3
            t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
            bound_ms = max(t_ops, t_exp, t_bytes)
            bound_by = "bytes" if t_bytes >= max(t_ops, t_exp) else "operations"
            detail = ("bytes" if bound_by == "bytes" else
                      "exponentials" if t_exp > t_ops else "3xTF32" if tensor else "fp32")
            two_pass = name == "attention_bwd" and not tensor
            launch = ""
            if not tensor:
                width = attention_fused.row_copy_width(
                    (q, k, v) if name == "attention_fwd" else (q, k, v, o, do), hd)
                ctas, threads, smem, resident = attention_fused.row_launch(
                    b, n, h, hd, name == "attention_bwd", width)
                launch = (f" ctas={ctas} threads={threads} smem_bytes={smem} "
                          f"resident_ctas_per_sm={resident} row_copy_bytes={width}")
            print(
                f"timing {name} (B,N,H,hd)={shape} ({layout}, "
                f"L2 flushed): kernel_ms={t['kernel']:.5f} plain_ms={t['plain']:.5f} "
                f"library_ms={t['library']:.5f} (sdpa backend {backend}) "
                f"bound_ms={bound_ms:.5f} ({detail}: {flops / 1e6:.1f} MFLOP "
                + (f"as 3xTF32 {t_ops:.5f} ms" if tensor else f"fp32 {t_ops:.5f} ms")
                + f", {nbytes / 1e6:.3f} MB {t_bytes:.5f} ms; fp32_non_tensor_ms={t_fp32:.5f}; "
                f"exp needed={n_exp / 1e6:.3f} M at {sms} SMs x {SFU_EXP_PER_CLOCK} a clock x "
                f"{SM_CLOCK_HZ / 1e9:.2f} GHz {t_exp:.5f} ms"
                + (f", the kernel computes {2 * n_exp / 1e6:.3f} M in its two passes" if two_pass else "")
                + f") kernel_share_of_bound={bound_ms / t['kernel']:.4f} "
                f"kernel_vs_library={t['kernel'] / t['library']:.3f}" + launch,
                flush=True,
            )
            rows[(shape, name)] = dict(ms=t["kernel"], plain_ms=t["plain"],
                                       library_ms=t["library"], bound_ms=bound_ms,
                                       bound_by=bound_by)
        del q, k, v, do, o, lse, heads_first, leaves, do_t, sdpa_out
    return rows


def phase_timings(dev):
    """Phase 5; returns the row of the main path's shape (the first of
    SOM_SHAPES).

    Each function is timed with L2 flushed before each call (``ms``, the
    main path's condition) and with its inputs resident in L2 (``warm``).
    The temperature is a device tensor, as the train step hands it over (a
    host float would add a fill kernel to every timed call)."""
    rows = {}
    temp = torch.full((), 3.7, device=dev)
    l2_flush = torch.empty(L2_FLUSH_BYTES // 4, device=dev)
    for idx, shape in enumerate(SOM_SHAPES):
        b, d, p, map_size = som_dims(shape)
        cols = map_size[1]
        x, protos = inputs(shape, 3000 + idx, dev)
        xn = x / x.norm(dim=1, keepdim=True)
        pn_t = (protos / protos.norm(dim=1, keepdim=True)).T
        fns = {
            "kernel": lambda: som_fused._kernel_forward(x, protos, temp, cols, "square", "cosine"),
            "plain": lambda: som_fused.fused_som_reference(x, protos, temp, cols, "square", "cosine"),
            "library": lambda: torch.matmul(xn, pn_t),
        }
        cold = {k: time_call(fn, l2_flush)[0] for k, fn in fns.items()}
        warm = {k: time_call(fn) for k, fn in fns.items()}
        flops = 2.0 * b * p * d
        nbytes = (b * d + p * d + b * p) * 4 + b * 8 + 4
        t_ops = 3 * flops / TF32_FLOPS * 1e3
        t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
        bound_ms = max(t_ops, t_bytes)
        bound_by = "operations" if t_ops >= t_bytes else "bytes"
        print(
            f"timing {som_shape_label(shape)} cosine square (L2 flushed): "
            f"kernel_ms={cold['kernel']:.5f} plain_ms={cold['plain']:.5f} "
            f"library_ms={cold['library']:.5f} bound_ms={bound_ms:.5f} ({bound_by}: "
            f"3xTF32 {3 * flops / 1e9:.3f} GFLOP {t_ops:.5f} ms, {nbytes / 1e6:.2f} MB "
            f"{t_bytes:.5f} ms) fp32_non_tensor_ms={flops / FP32_FLOPS * 1e3:.5f} "
            f"kernel_share_of_bound={bound_ms / cold['kernel']:.4f} "
            f"kernel_vs_library={cold['kernel'] / cold['library']:.3f}",
            flush=True,
        )
        print(
            f"timing B={b} D={d} P={p} inputs in L2: "
            + " ".join(f"{k}_ms={v[0]:.5f}" for k, v in warm.items())
            + "; host_ms to issue one call: " + " ".join(f"{k}={v[1]:.5f}" for k, v in warm.items()),
            flush=True,
        )
        rows[idx] = dict(ms=cold["kernel"], plain_ms=cold["plain"], library_ms=cold["library"],
                         bound_ms=bound_ms, bound_by=bound_by)
        del x, protos, xn, pn_t
    return rows[0]


def block_inputs(shape, seed, dev):
    """(the port's eager Block, x, the cotangent dy) at ``shape``: xavier-
    uniform weights, biases and LayerNorm parameters 0.02 off their init;
    dy over B at B 128 (module docstring, phase 10)."""
    b, n, d, h, ratio = shape
    g = torch.Generator().manual_seed(seed)
    blk = Block(d, h, ratio)
    with torch.no_grad():
        for name, p in blk.named_parameters():
            if p.ndim == 2:
                initializers.xavier_uniform_(p, g)
            else:
                p.copy_(float(name.endswith("norm1.weight") or name.endswith("norm2.weight"))
                        + 0.02 * torch.randn(p.shape, generator=g))
    x = torch.randn(b, n, d, generator=g)
    dy = torch.randn(b, n, d, generator=g) / (b if b >= 128 else 1)
    return blk.to(dev), x.to(dev), dy.to(dev)


def block_param_grads(blk):
    """The eager Block's parameter gradients in the fused weight layout."""
    shadow = copy.deepcopy(blk)
    with torch.no_grad():
        for p, q in zip(shadow.parameters(), blk.parameters()):
            p.copy_(q.grad)
    return {k: v.detach() for k, v in block_weights(shadow).items()}


def grad_err(a, b):
    """(max |a - b|, within atol 2e-5 / rtol 1e-4 everywhere and at most 1e-4
    of max |b|)."""
    err, ok = allclose_err(a, b, *BLOCK_GRAD_TOL)
    return err, ok and err <= GRAD_REL_TO_MAX * float(b.abs().max())


def phase_block_vs_plain(dev):
    """Phase 10; returns the largest forward and backward errors against the
    plain versions."""
    worst = {"block_fwd": 0.0, "block_bwd": 0.0}
    for shape in BLOCK_SHAPES:
        b, n, d, h, ratio = shape
        blk, x, dy = block_inputs(shape, 6000 + n + d, dev)
        w = {k: v.detach() for k, v in block_weights(blk).items()}
        y = block_fused._kernel_forward(x, w, h)
        y2 = block_fused._kernel_forward(x, w, h)
        yr = block_fused.fused_block_reference(x, w, h)
        dx, dw = block_fused._kernel_backward(x, dy, w, h)
        dx2, dw2 = block_fused._kernel_backward(x, dy, w, h)
        dxr, dwr = block_fused.fused_block_bwd_reference(x, dy, w, h)
        xl = x.clone().requires_grad_()
        ye = blk(xl)
        ye.backward(dy)
        dwa = block_param_grads(blk)
        # float64: each output's error against a float64 evaluation of the
        # plain version, beside the plain float32 version's own
        w64 = {k: v.double() for k, v in w.items()}
        y64 = block_fused.fused_block_reference(x.double(), w64, h)
        dx64, dw64 = block_fused.fused_block_bwd_reference(x.double(), dy.double(), w64, h)
        f64 = {"y": float64_err(y, yr, y64), "dx": float64_err(dx, dxr, dx64)}
        f64.update({k: float64_err(dw[k], dwr[k], dw64[k]) for k in block_fused.WEIGHT_NAMES})
        torch.cuda.synchronize()
        errs = {"y": allclose_err(y, yr, *BLOCK_Y_TOL),
                "y_vs_eager": allclose_err(y, ye.detach(), *BLOCK_Y_TOL),
                "dx": grad_err(dx, dxr), "dx_vs_autograd": grad_err(dx, xl.grad)}
        rel = 0.0
        for name in block_fused.WEIGHT_NAMES:
            errs[name] = grad_err(dw[name], dwr[name])
            errs[name + "_vs_autograd"] = grad_err(dw[name], dwa[name])
            rel = max(rel, errs[name][0] / float(dwr[name].abs().max()))
        same = (torch.equal(y, y2) and torch.equal(dx, dx2)
                and all(torch.equal(dw[k], dw2[k]) for k in dw))
        wname = max(block_fused.WEIGHT_NAMES, key=lambda k: errs[k][0])
        aname = max(block_fused.WEIGHT_NAMES, key=lambda k: errs[k + "_vs_autograd"][0])
        print(
            f"block_vs_plain (B,N,D,H,mlp)={shape} dy_std={float(dy.std()):.4f}: "
            f"y_max_abs_err={errs['y'][0]:.3e} y_vs_eager={errs['y_vs_eager'][0]:.3e} "
            f"dx={errs['dx'][0]:.3e} dx_vs_autograd={errs['dx_vs_autograd'][0]:.3e} "
            f"weight_grads: worst={errs[wname][0]:.3e} ({wname}) "
            f"worst_vs_autograd={errs[aname + '_vs_autograd'][0]:.3e} ({aname}) "
            f"rel_to_max={rel:.3e} "
            f"max_abs_grad={max(float(g.abs().max()) for g in dwr.values()):.3e} "
            f"deterministic={same}",
            flush=True,
        )
        print(f"block_vs_float64 (B,N,D,H,mlp)={shape}: "
              + " ".join(f"{k}={ke / max(pe, 1e-30):.2f}" for k, (ke, pe, _) in f64.items())
              + f" (kernel / plain float32 error; largest kernel error "
              f"{max(ke for ke, _, _ in f64.values()):.3e})", flush=True)
        for k, (ke, pe, _) in f64.items():
            check(ke <= BLOCK_F64_FACTOR * pe + F64_SLACK,
                  f"block {k} further from float64 than {BLOCK_F64_FACTOR} x the plain version's + "
                  f"{F64_SLACK} at {shape}: {ke} vs {pe}")
        for k, (e, ok) in errs.items():
            check(ok, f"block {k} disagrees at {shape}: {e}")
            side = "block_fwd" if k in ("y", "y_vs_eager") else "block_bwd"
            if not k.endswith("_vs_autograd") and k != "y_vs_eager":
                worst[side] = max(worst[side], e)
        check(same, f"two block kernel runs differ at {shape}")
        check(y.shape == x.shape and dx.shape == x.shape, "bad block output shape")
        check(all(tuple(dw[k].shape) == tuple(w[k].shape) for k in w), "bad weight grad shape")
    return worst


def phase_block_flagship(dev, trainer, dm):
    """Phase 11: the fused block on the flagship's own activations; returns
    the launch counts of that run."""
    vit = trainer.model.vit
    blocks = list(vit.blocks) + list(vit.decoder_blocks)
    captured = []
    hooks = [blk.register_forward_pre_hook(lambda mod, args: captured.append(args[0].detach().clone()))
             for blk in blocks]
    with torch.no_grad():
        vit(next(dm.eval_batches())["image"])
    for hook in hooks:
        hook.remove()
    check(len(captured) == len(blocks) == 6, f"captured {len(captured)} block inputs, not 6")

    def fused_for(blk, x):
        ratio = blk.mlp.fc1.out_features / blk.attn.dim
        return block_fused.make_fused_block(blk.attn.dim, blk.attn.num_heads, ratio, x.shape[1])

    reset_launches()
    for idx, (blk, x) in enumerate(zip(blocks, captured)):
        with torch.no_grad():
            y = fused_for(blk, x)(x, block_weights(blk))
            ye = blk(x)
        torch.cuda.synchronize()
        err, ok = allclose_err(y, ye, *BLOCK_Y_TOL)
        kind = "encoder" if idx < len(vit.blocks) else "decoder"
        print(f"block_flagship {kind} block {idx} x={tuple(x.shape)} |x|max={float(x.abs().max()):.3f}: "
              f"y_vs_eager max_abs_err={err:.3e}", flush=True)
        check(ok, f"fused block {idx} disagrees with the eager block: {err}")
    for idx in (0, len(vit.blocks)):
        blk, x = blocks[idx], captured[idx]
        g = torch.Generator(device=dev).manual_seed(8000 + idx)
        cot = torch.randn(x.shape, generator=g, device=dev) / x.shape[0]
        blk.zero_grad(set_to_none=True)
        xf = x.clone().requires_grad_()
        fused_for(blk, x)(xf, block_weights(blk)).backward(cot)
        fused = {name: p.grad.clone() for name, p in blk.named_parameters()}
        blk.zero_grad(set_to_none=True)
        xe = x.clone().requires_grad_()
        blk(xe).backward(cot)
        torch.cuda.synchronize()
        errs = {"dx": grad_err(xf.grad, xe.grad)}
        errs.update({name: grad_err(fused[name], p.grad) for name, p in blk.named_parameters()})
        blk.zero_grad(set_to_none=True)
        wname = max(errs, key=lambda k: errs[k][0])
        print(f"block_flagship grads block {idx}: dx_max_abs_err={errs['dx'][0]:.3e} "
              f"worst={errs[wname][0]:.3e} ({wname}) params={len(errs) - 1}", flush=True)
        for k, (e, ok) in errs.items():
            check(ok, f"fused block {idx} gradient {k} disagrees with autograd: {e}")
    launches = read_launches()
    want = {"som_fused": 0, "attention_fwd": 0, "attention_bwd": 0,
            "block_fwd": len(blocks) + 2, "block_bwd": 2}
    print("block_flagship launches: "
          + " ".join(f"{k}={v} (expected {want[k]})" for k, v in launches.items()), flush=True)
    check(launches == want, f"block launch counts {launches} != {want}")
    return launches


def phase_block_timings(dev):
    """Phase 12; returns {(shape, kernel name): row} of the timed shapes."""
    rows = {}
    l2_flush = torch.empty(L2_FLUSH_BYTES // 4, device=dev)
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    exp_per_s = sms * SFU_EXP_PER_CLOCK * SM_CLOCK_HZ
    for shape in BLOCK_TIMED:
        b, n, d, h, ratio = shape
        m, hd = int(d * ratio), d // h
        blk, x, dy = block_inputs(shape, 7000 + d, dev)
        blk_pallas = Block(d, h, ratio, attn_impl="pallas").to(dev)
        blk_pallas.load_state_dict(blk.state_dict())
        w = {k: v.detach() for k, v in block_weights(blk).items()}
        xl = x.clone().requires_grad_()

        def eager_fwd(mod):
            with torch.no_grad():
                return mod(x)

        def eager_fwd_bwd(mod):
            return torch.autograd.grad(mod(xl), [xl, *mod.parameters()], dy)

        n_w = sum(v.numel() for v in w.values())
        products = 2 * b * n * (4 * d * d + 2 * d * m)
        fwd_flops = products + 4 * b * h * n * n * hd
        cases = {
            "block_fwd": (
                {"kernel": lambda: block_fused._kernel_forward(x, w, h),
                 "plain": lambda: block_fused.fused_block_reference(x, w, h),
                 "eager_xla": lambda: eager_fwd(blk),
                 "eager_pallas": lambda: eager_fwd(blk_pallas)},
                fwd_flops, 4 * (2 * b * n * d + n_w),
            ),
            "block_bwd": (
                {"kernel": lambda: block_fused._kernel_backward(x, dy, w, h),
                 "plain": lambda: block_fused.fused_block_bwd_reference(x, dy, w, h),
                 "eager_xla": lambda: eager_fwd_bwd(blk),
                 "eager_pallas": lambda: eager_fwd_bwd(blk_pallas)},
                fwd_flops + 2 * products + 8 * b * h * n * n * hd,
                4 * (3 * b * n * d + 2 * n_w),
            ),
        }
        n_exp = b * h * n * n  # one a (query, key) pair, forward and backward alike
        for name, (fns, flops, nbytes) in cases.items():
            t = {key: time_call(fn, l2_flush)[0] for key, fn in fns.items()}
            # a float32-accurate product takes least time as three TF32
            # products on the tensor cores (the kernels' form, but for the
            # FP32 attention at hd 2); the FP32 figure is printed beside it
            t_fp32 = flops / FP32_FLOPS * 1e3
            t_ops = 3 * flops / TF32_FLOPS * 1e3
            t_exp = n_exp / exp_per_s * 1e3
            t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
            bound_ms = max(t_ops, t_exp, t_bytes)
            bound_by = "bytes" if t_bytes >= max(t_ops, t_exp) else "operations"
            detail = ("bytes" if bound_by == "bytes" else
                      "exponentials" if t_exp > t_ops else "3xTF32")
            eager = "forward" if name == "block_fwd" else "forward + backward"
            threads = (block_fused.fwd_threads(n) if name == "block_fwd"
                       else block_fused.bwd_threads(n))
            print(
                f"timing {name} (B,N,D,H,M)={(b, n, d, h, m)} (L2 flushed): "
                f"kernel_ms={t['kernel']:.5f} plain_ms={t['plain']:.5f} "
                f"eager_block_xla_ms={t['eager_xla']:.5f} eager_block_pallas_ms={t['eager_pallas']:.5f} "
                f"(eager Block {eager}) bound_ms={bound_ms:.5f} ({detail}: {flops / 1e6:.1f} MFLOP "
                f"as 3xTF32 {t_ops:.5f} ms, {nbytes / 1e6:.3f} MB {t_bytes:.5f} ms; "
                f"fp32_non_tensor_ms={t_fp32:.5f}; exp needed={n_exp / 1e6:.3f} M at {sms} SMs x "
                f"{SFU_EXP_PER_CLOCK} a clock x {SM_CLOCK_HZ / 1e9:.2f} GHz {t_exp:.5f} ms) "
                f"kernel_share_of_bound={bound_ms / t['kernel']:.4f} ctas={b} threads={threads} "
                f"smem_bytes={block_fused.smem_bytes(n, d, h, m, name == 'block_bwd')}",
                flush=True,
            )
            rows[(shape, name)] = dict(ms=t["kernel"], plain_ms=t["plain"],
                                       library_ms=t["eager_xla"], bound_ms=bound_ms,
                                       bound_by=bound_by)
    return rows


def phase_build():
    """Phase 2: one nvcc per source, all started together."""
    t0 = time.perf_counter()
    with ThreadPoolExecutor(len(KERNEL_SOURCES)) as pool:
        infos = dict(zip(KERNEL_SOURCES, pool.map(_build.build, KERNEL_SOURCES)))
    print(f"build: {time.perf_counter() - t0:.2f} s for "
          + ", ".join(f"{name}.cu ({info['seconds']:.2f} s)" for name, info in infos.items()),
          flush=True)
    for name, info in infos.items():
        for line in info["log"].splitlines():
            if any(w in line for w in ("entry function", "registers", "spill")) or (
                    "error" in line.lower()):
                print(f"build[{name}]: {line.strip()}", flush=True)
    # the SOM kernel's, the hd >= 32 attention kernels' and every block
    # kernel instantiation's products must run on the tensor cores in TF32
    # (wgmma: HGMMA; mma.sync: HMMA in SASS)
    cuobjdump = os.path.join(os.path.dirname(_build._nvcc()), "cuobjdump")
    check(os.path.isfile(cuobjdump), f"no cuobjdump beside nvcc to inspect the SASS: {cuobjdump}")
    for name, kernels, kinds in (
            ("som_fused", ("som_partial_kernel",), ("HGMMA",)),
            ("attention", ("attn_fwd_mma_kernel", "attn_bwd_mma_kernel"), ("HMMA", "HGMMA")),
            ("block", ("block_fwd_kernel", "block_bwd_kernel"), ("HMMA",))):
        sass = subprocess.run([cuobjdump, "-sass", infos[name]["path"]], capture_output=True,
                              text=True, check=True).stdout
        ops, function = {}, None  # {function: {instruction: count}}
        for line in sass.splitlines():
            if "Function :" in line:
                function = line.split("Function :", 1)[1].strip()
                ops[function] = {}
            for word in line.replace(";", " ").split():
                if function and word.startswith(("HGMMA", "HMMA")):
                    ops[function][word] = ops[function].get(word, 0) + 1
        for kernel in kernels:
            found = {f: c for f, c in ops.items() if kernel in f}
            check(found, f"{name}.cu: no {kernel} in the SASS")
            for function, counts in found.items():
                print(f"build[{name}]: tensor-core instructions of {function}: {counts}", flush=True)
                check(any(op.startswith(kinds) and "TF32" in op for op in counts),
                      f"{function} has no TF32 {'/'.join(kinds)} in its SASS")


def main() -> int:
    if not torch.cuda.is_available():
        print("FAIL: torch.cuda.is_available() is false", file=sys.stderr)
        return 1
    try:
        dev = resolve_device("cuda")
        smi = nvidia_smi_line()
        print(f"device: {torch.cuda.get_device_name(0)} count={torch.cuda.device_count()} "
              f"torch={torch.__version__} cuda={torch.version.cuda}", flush=True)
        print(f"nvidia-smi: {smi}", flush=True)

        phase_build()
        max_err = phase_kernel_vs_plain(dev)
        som_launches, xla_first, flagship = phase_train(dev)
        phase_graphed_vs_eager(dev, "graph_xla", None, flagship, smi)
        timing = phase_timings(dev)
        attn_err = phase_attention_vs_plain(dev)
        run = phase_train_attention(dev, "pallas", TRAIN_STEPS, True, xla_first)
        phase_graphed_vs_eager(dev, "graph_pallas", "pallas", run, smi)
        del run
        phase_train_attention(dev, "hybrid", HYBRID_STEPS, False, xla_first)
        attn_timing = phase_attention_timings(dev)
        block_err = phase_block_vs_plain(dev)
        block_launches = phase_block_flagship(dev, flagship[2], flagship[1])
        block_timing = phase_block_timings(dev)
        cifar = phase_train_cifar(dev)
        phase_bench(dev, smi)
        phase_profiles(smi)
    except SmokeFailure as e:
        print(f"FAIL: {e}", file=sys.stderr)
        return 1

    kernels = [{
        "name": "som_fused",
        "route": "cuda",
        "source": "vitsom_tpu_torch/ops/csrc/som_fused.cu",
        "replaces": "vitsom_tpu/ops/som_pallas.py:95",
        "launches": som_launches,
        "max_abs_err": max_err,
        **timing,
    }]
    for name, replaces in (("attention_fwd", "vitsom_tpu/ops/attention_pallas.py:100"),
                           ("attention_bwd", "vitsom_tpu/ops/attention_pallas.py:163")):
        kernels.append({
            "name": name,
            "route": "cuda",
            "source": "vitsom_tpu_torch/ops/csrc/attention.cu",
            "replaces": replaces,
            "launches": cifar[name],
            "max_abs_err": attn_err[name],
            **attn_timing[(ATTN_MAIN, name)],
        })
    for name, replaces in (("block_fwd", "vitsom_tpu/ops/block_pallas.py:226"),
                           ("block_bwd", "vitsom_tpu/ops/block_pallas.py:235")):
        kernels.append({
            "name": name,
            "route": "cuda",
            "source": "vitsom_tpu_torch/ops/csrc/block.cu",
            "replaces": replaces,
            "launches": block_launches[name],
            "max_abs_err": block_err[name],
            **block_timing[(BLOCK_TIMED[0], name)],
        })
    print(json.dumps({"kernels": kernels}), flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
