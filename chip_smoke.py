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
   below) must equal 3 + eval batches (a warm-up batch and 38), and the
   attention kernels must not
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
   no remat) on the clustering objective (``data.num_classes`` 0; phase D
   runs the yaml as shipped, with its 10 classes) with un-augmented
   synthetic 32x32x3 images (``raw_synthetic_datamodule``: the clustering of
   an augmented dataset is not ported), 20 steps
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
   10 eager steps and R replays of the flagship with ``xla`` and with
   ``pallas`` and of phase B's configuration; each hand-written kernel's
   count in the profiler's records (CUPTI records a graph's kernels) must
   be R times its count a step in both modes: the SOM's two launches once
   a step, and with ``pallas`` the attention forward 12 times and the
   backward 6 times a step. Wall and device busy ms a step, the idle share
   and the kernels a step of each are printed beside the card's name and
   power limit.
D. classification as shipped: ``configs/vit_som/vit_som_cifar-10.yaml``
   (``data.num_classes`` 10, label smoothing 0.1, the full augmentation
   stack on the device, the 80/20 split) at full width and depth on
   synthetic cifar-shaped data at the real split sizes (``data.
   synthetic_size`` 50000: 40000 train, 10000 val, 10000 test rows; 312
   steps an epoch). With ``pallas`` attention: one full epoch graphed (each
   epoch's batches augmented into the epoch buffer before the steps, by
   replays of one captured augmentation at the epoch's draws, held against
   eager calls at three batches), the validation after it, then the test eval (accuracy,
   precision, recall, F1) after the val split is released. With ``xla``:
   the first CLS_STEPS steps graphed, then the same steps eagerly (the
   eager hold: the augmented epoch buffers bitwise equal, every step's
   three losses and every final parameter within rtol 1e-5). Then
   ``configs/vit/vit_cifar-10.yaml`` (the ViT baseline) with ``pallas``,
   CLS_STEPS graphed steps and its test eval. Checks: step-0 losses of
   ``xla`` and ``pallas`` equal within rtol 1e-5; every loss finite; the
   step-0 ``cls_loss`` within 0.3 of ln 10; val and test accuracy in [0,
   1]; the augmented epoch buffer finite, each channel's mean within 1 of
   0 and its std in (0.3, 2); the wrappers' launch counts equal the
   formula below; and ``profile_step`` on the ``pallas`` configuration (R
   = 10 replays, as phase C) counts R times a step's kernels. Prints ms a
   step and images/s graphed and eager, the augmentation's ms an epoch,
   validation and test ms and the test metrics beside the card's name and
   power limit.
E. the family at its shipped shapes (``phase_family``), every run graphed
   with ``pallas`` attention on synthetic data: E1, this slice's main
   path, ``configs/vit_som/vit_som_tiny-imagenet.yaml`` as shipped (emb
   192, depth 12, 3 heads, patch 4: attention at (512, 257, 3, 64) with
   the backward's dq partials; B 512; 200 classes; the SOM at (512, 49152,
   196); the whole augmentation at 64x64) on 4096 + 819 images (the
   90/10 split: 3686 / 410 / 819, 7 steps an epoch): one epoch,
   validation and the test eval, the captured augmentation held against
   its eager calls, the same epoch eagerly (graphed equal to eager within
   GRAPH_RTOL, parameters included), 3 steps with ``xla`` (step-0 losses
   equal within rtol 1e-5) and ``profile_step`` on it; E2
   ``vit_som_flowers-102.yaml`` (224x224, patch 16, N 197, B 128; the
   augmentation in chunks of 16 images, captured as one graph and held
   against its eager calls) and E3 ``vit_som_svhn.yaml`` (emb 16: the row
   kernels at N 257; a 40x40 map), each one epoch of 8 steps (1280 +
   256 images), validation and the test eval; E4 ``vit_tiny-imagenet.yaml``
   on E1's data, one epoch and the test eval; E5 every other yaml of the
   family (``vit_som`` cifar-100, medmnist, flowers-17, fmnist, usps;
   ``vit`` cifar-100, svhn, medmnist, flowers-17, flowers-102): 3 steps
   and one eval batch each (a classification split of 15 B / 4 images, so
   the 3 steps are an epoch and its validation one ragged batch; the two
   B-512 flowers ViTs so augment 1536 images, not 3277; the clustering
   yamls on 320 + 64 images and the eval step on one batch). Losses
   finite; launch counts equal the formula below; step ms, images/s,
   augmentation, validation and test ms beside the card's name and power
   limit;
F. DESOM (``phase_desom``; no kernel: its manhattan SOM is eager in both
   packages, and every wrapper's count must stay 0): F1
   ``configs/desom/desom_mnist.yaml`` as shipped (784-500-500-2000-10, an
   8x8 manhattan map, B 128, adam) for 40 steps and the clustering eval,
   held against its eager run; F2 the same with ``ae.batch_norm`` true for
   10 steps, graphed against eager with BatchNorm's running mean and var
   held too; F3 ``desom_flowers17.yaml`` as shipped (the static 224x224
   path: the train rows eval-transformed once; input 150528, 17 classes,
   B 256; 12 steps an epoch) for one epoch, validation and the test eval,
   and ``profile_step`` on it; F4 ``desom_fmnist.yaml`` and
   ``desom_usps.yaml``, 3 steps and the clustering eval each.
G. the dataset readers, checkpoints, TensorBoard and the N-run protocol
   (``phase_protocol``), on files the phase writes from the seed into a
   temporary directory in their published formats, read with no fallback
   (``data.allow_synthetic`` false): G1 small files of MNIST IDX (raw and
   gzipped), cifar-10 and cifar-100 pickles, ``pathmnist.npz``,
   ``reutersidf10k.npy`` and svhn ``.mat`` through ``load_raw``, bitwise
   equal to what was written (svhn's label 10 -> 0, the NHWC transposes);
   it prints which formats this machine cannot read (usps needs h5py, the
   jpg sources PIL) and why, which is no failure. G2 the flagship protocol:
   MNIST as gzipped IDX files of 60000 + 10000 images, ``vit_som_mnist.yaml``
   as shipped for one epoch (546 graphed steps), two runs (the protocol's
   5 runs and the yaml's epochs cut) through ``trainer.main`` with
   ``--json-out``, its trainer wrapped (``ProtocolProbe``): the device
   images equal the IDX bytes / 255; the clustering eval just before
   ``save_checkpoint("last")`` equals the protocol's eval from the
   restored state; the restored parameters, AdamW moments and step counts,
   lr tensors and device step equal the saved ones bitwise, at the same
   addresses; each run's event file holds the JAX trainer's tags at the
   epoch's last step; the JSON the harness's keys (``peak_memory_gb`` from
   ``torch.cuda.max_memory_allocated``); the SOM launches 2 x (3 + 2 x 547)
   (each run's steps, the hold's eval and the protocol's). G3 a restore
   into a captured step: a flagship trainer on G2's files runs 20 graphed
   steps, saves, runs 20 more (state S); restored to step 20 with its
   graph captured, its next 20 steps are replays only and reach S bitwise;
   a fresh trainer restored from the same checkpoint reaches S after its
   warm-up and capture. G4 ``vit_som_cifar-10.yaml`` as shipped with
   ``pallas`` attention from the python pickles of 50000 + 10000 images,
   two epochs, one run through ``trainer.main``: the ``best`` checkpoint
   equals the parameters copied after the validation with the highest
   ``val/accuracy``; the test eval runs; the event file holds the JAX
   tags (train, hp, perf and val) at both epochs' last steps; the launch
   counts equal the formula below (this slice's main path). Prints the
   read, write, save and restore times, the checkpoint bytes, the epoch's
   images/s and the peak memory beside the card's name and power limit.
H. the Swin and DeiT baselines (``phase_baselines``) as shipped on
   synthetic data, every run graphed with its dropout or drop-path masks
   drawn inside the captured step from the trainer's CUDA generator
   (registered with the graph). No kernel is on their path (the attention
   kernels take no bias and no dropout on the probabilities, as in the
   JAX package): every H run must launch 0 SOM, attention and block
   kernels. A ``MaskProbe`` wraps the port's one mask function so that
   each draw also adds its kept count to a device counter and copies its
   first 128 entries into a device row of its step: ops of the step, which
   the graph replays. H1 ``configs/swin/swin_cifar-10.yaml`` (embed 96,
   depths 2-2-6-2, heads 3-6-12-24, patch 2: 256 tokens, window 4, every
   block on the dense-masked path; B 128; 50000 + 10000 images, 312 steps
   an epoch): epoch 0 graphed (lr 0: every parameter bitwise as built),
   validation, a ``save_checkpoint``, then 40 steps of epoch 1 (lr
   base_lr / 20) held against a fresh trainer restored from that
   checkpoint and run eagerly (losses, parameters and the recorded masks
   within GRAPH_RTOL, bitwise in practice), the rest of epoch 1,
   validation and the test eval; no two steps' recorded masks equal, and
   each site's kept share over all 624 steps within 5 binomial sigmas of
   its keep rate (printed by drop-path rate). H2 ``swin_medmnist.yaml``
   (B 512, 28/4 = 7x7 tokens padded to 8x8 on the windowed path, then 4x4
   dense; 1536 train rows: 3 steps an epoch, so steps 3-9 train at
   base_lr e / 25) 10 graphed steps against 10 eager ones, then the test
   eval. H3 ``deit_cifar-10.yaml`` (emb 192, depth 12, 3 heads of 64,
   dropout 0.1 at 49 sites a step) with a ``resnet50.pth`` the phase
   writes from the seed in torchvision's names into a temporary
   ``data_dir``: the teacher's 265 mapped tensors equal what was written;
   40 graphed steps against 40 eager ones (and their masks), the rest of
   the epoch, validation and the test eval; the CE and the distillation
   term printed. H4 the other seven yamls (``swin_cifar-100``, ``_svhn``,
   ``_tiny-imagenet`` at B 512, ``_flowers-17`` at 224; ``deit_cifar-100``,
   ``_svhn``, ``_flowers-17``; ``swin_medmnist`` is H2) through
   ``cls_run``: 3 graphed steps and one ragged validation batch each.
   ``profile_step`` on H1 and H3 (wall, busy, idle share, kernels a step).
I. MobileViT-S and the host augmentation path (``phase_mobile_vit``). No
   kernel is on MobileViT's path (its attention is Flax's
   ``MultiHeadDotProductAttention``, plain products, as in the JAX
   package): every MobileViT run must launch 0 SOM, attention and block
   kernels. I1, the slice's main path: ``mobile_vit_cifar-10.yaml`` as
   shipped (224x224, B 128, Flax BatchNorm moved in place inside the
   captured step) on 50000 + 10000 synthetic images, the epoch streamed
   (312 steps; its 24 GB buffer passes ``pipeline.STREAM_BYTES``: each
   batch's captured augmentation replays into a one-batch buffer just
   before its step): 2 warm-up steps, the capture and 20 replays; the last
   streamed batch against eager calls at its draws; a checkpoint, then 10
   more replays held bitwise against a fresh trainer restored from it and
   run eagerly (losses, parameters, running statistics, AdamW, device
   state); ``profile_step`` (R = 10) with the augmentation off (the static
   path's resident rows), which times the step alone. I5 the same yaml
   with ``train.remat_blocks`` on against off, 3 replays each on
   I1's data (2 warm-up steps, the capture, 3 replays): equal within
   GRAPH_RTOL, running statistics included, the replays' ms printed. I2
   one epoch of the yaml on 1280 + 256 images (8 steps, a whole-epoch
   fill), validation and the test eval on the running statistics. I3
   ``mobile_vit_svhn.yaml`` (73257 + 14651 images: 457 steps an epoch,
   35 GB unstreamed) and ``_cifar-100``, 3 graphed steps each, with the
   peak memory. I4 the host path: a flowers-17 jpg dir in its published
   layout (``jpg/image_0001.jpg`` on, 80 images a class of 240-500 px,
   cut to 6 classes: 384 train rows, 3 steps an epoch) written from the
   seed into a temporary directory; ``mobile_vit_flowers-17.yaml`` and
   ``vit_som_flowers-17.yaml`` (the fused SOM kernel on the host path, its
   launches counted) each train 2 graphed epochs with validation and the
   test eval, every batch the step read equal to the host batch
   ``train_batches`` makes again; the host ms between batches, the
   trainer's waits and the worker count are printed beside
   ``os.cpu_count()``; ``profile_step`` (R = 10) on ``vit_som_cifar-10``
   with ``data.device_augment: false`` (the 32x32 images through the host
   path): the device's idle share while the steps wait for the host, and
   the SOM kernel's count under replay.

The launch counts below count what the wrappers issue from Python. A
graphed run of S > 2 steps issues its two warm-up steps and the one step
it captures (the capture records the launches; each replay runs them
again, unseen by Python), so there S stands for 3; an eager run issues
all S. E counts every eval batch, and each clustering eval and test eval
runs one warm-up batch first (counted in E); a split smaller than a batch
is one ragged batch. Launch counts on a train run of S steps and E eval
batches, with one
attention call per block (A = depth + dec_depth = 6 on the flagship) and
remat_blocks (each block's forward runs again in the backward): the fused
SOM kernel runs S + E times; with ``pallas`` the attention forward kernel
runs (2 S + E) A times and the backward kernel S A times; with ``hybrid``
the forward kernel 0 times and the backward kernel S A times. No train run
launches a block kernel. The cifar-10 config has no remat (A = 14): its
``pallas`` run of S steps and E eval batches launches the attention
forward kernel (S + E) 14 times, the backward S 14 times (each launch of
the backward at N 65 is one kernel; at N 197 and 257 its dq partials add a
second, counted with it) and the SOM kernel S + E times. A
classification train step runs the encoder only (its loss reads no
reconstruction; depth 12, no remat), the eval step the encoder and the
decoder: phase D's ViT-SOM ``pallas`` run of S steps and E eval batches
(the val batches of each validation, the test batches and the one warm-up
batch of the test eval) launches the attention forward kernel 12 S + 14 E
times, the backward 12 S times and the SOM kernel S + E times; the ViT
baseline (no decoder, no SOM) the forward 12 S + 12 E times, the backward
12 S times and the SOM kernel never. Phase 11
launches the block forward kernel once per flagship block plus once for
each of the two blocks it backpropagates through (6 + 2 = 8), and the
backward kernel once for each of those (2).

The last lines are the ``kernels`` JSON (the SOM and attention kernels'
``launches``: phase G4's protocol run, the last path all these kernels are on,
with every path's count under ``launches_by_path``, the phase-H paths and
phase I's MobileViT paths at 0, I4's ViT-SOM host run with its SOM
launches; the SOM row's timings at (512,
49152, 196) and the attention rows' at (512, 257, 3, 64), phase E1's
shapes), the nvidia-smi line and the result. The whole script takes about
13 minutes on an H100 (phase I about 4, its 224x224 augmentation ~0.9 s a
batch), the builds included (block.cu, the longest, about 28 s);
``PhaseClock`` prints each group of phases' seconds.
"""

from __future__ import annotations

import copy
import functools
import gzip
import importlib.util
import json
import math
import os
import pickle
import statistics
import struct
import subprocess
import sys
import tempfile
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch
import torch.nn.functional as F

from vitsom_tpu_torch.config import DataConfig, load_config
from vitsom_tpu_torch.convert import block_weights
from vitsom_tpu_torch.data import datasets
from vitsom_tpu_torch.data.synthetic import build_datamodule, raw_synthetic_datamodule
from vitsom_tpu_torch.models import stochastic
from vitsom_tpu_torch.models.vit import Block
from vitsom_tpu_torch.models.vit_som import model_attn_impl
from vitsom_tpu_torch.ops import _build, attention_fused, block_fused, som_fused
from vitsom_tpu_torch.ops.attention import xla_attention
from vitsom_tpu_torch.som import layer as som
from vitsom_tpu_torch.train import steps as steps_lib
from vitsom_tpu_torch.train import trainer as trainer_mod
from vitsom_tpu_torch.train.trainer import WARMUP_STEPS, Trainer
from vitsom_tpu_torch.utils import initializers, tb_writer
from vitsom_tpu_torch.utils.device import resolve_device

ROOT = os.path.dirname(os.path.abspath(__file__))
CONFIG = os.path.join(ROOT, "configs", "vit_som", "vit_som_mnist.yaml")
CIFAR_CONFIG = os.path.join(ROOT, "configs", "vit_som", "vit_som_cifar-10.yaml")
VIT_CONFIG = os.path.join(ROOT, "configs", "vit", "vit_cifar-10.yaml")
# phase D: cifar-10's 50000 train images (40000 train + 10000 val after the
# 80/20 split) and a 10000-image test split (synthetic_size // 5)
CLS_SYNTHETIC_SIZE = 50000
CLS_STEPS = 40  # the xla run, its eager hold and the ViT baseline
CLS_LOSSES = ("train/cls_loss", "train/som_loss", "train/total_loss")
TRAIN_STEPS = 40
HYBRID_STEPS = 10
# phases E and F: the family's and DESOM's yamls
FAMILY = os.path.join(ROOT, "configs", "vit_som")
VIT_FAMILY = os.path.join(ROOT, "configs", "vit")
TINY_CONFIG = os.path.join(FAMILY, "vit_som_tiny-imagenet.yaml")
FLOWERS_CONFIG = os.path.join(FAMILY, "vit_som_flowers-102.yaml")
SVHN_CONFIG = os.path.join(FAMILY, "vit_som_svhn.yaml")
VIT_TINY_CONFIG = os.path.join(VIT_FAMILY, "vit_tiny-imagenet.yaml")
# E5: every other yaml of the family, 3 graphed steps each
E5_CONFIGS = [os.path.join(FAMILY, f"vit_som_{n}.yaml")
              for n in ("cifar-100", "medmnist", "flowers-17", "fmnist", "usps")] + [
    os.path.join(VIT_FAMILY, f"vit_{n}.yaml")
    for n in ("cifar-100", "svhn", "medmnist", "flowers-17", "flowers-102")]
# E2, E3: one epoch of 8 steps (synthetic_size 1280 at B 128: 1024 train
# rows), as short as PROFILE_STEPS, to keep the smoke near half its time
# limit
E_STEPS = 8
E5_STEPS = 3
DESOM = os.path.join(ROOT, "configs", "desom")
DESOM_MNIST = os.path.join(DESOM, "desom_mnist.yaml")
DESOM_FLOWERS = os.path.join(DESOM, "desom_flowers17.yaml")
DESOM_BN_STEPS = 10
CIFAR_STEPS = 20
PROFILE_STEPS = 10  # R: the graph replays (and eager steps) profile_step profiles
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
# the main path's (phase E1, vit_som_tiny-imagenet) encoder shape: the
# kernels JSON line's attention rows
ATTN_MAIN = (512, 257, 3, 64)
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
SOM_MAIN = 7  # the main path's (phase E1) SOM: the kernels JSON line's SOM row
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
    eval runs the forward only, under no_grad. A classification train step
    runs the encoder only, the ViT-SOM eval step the decoder too; the ViT
    baseline has no decoder and no SOM."""
    som_model = cfg.model_arch == "vit_som"
    eval_blocks = cfg.vit.depth + (cfg.vit.dec_depth if som_model else 0)
    train_blocks = cfg.vit.depth if cfg.classification else eval_blocks
    passes = 2 if cfg.train.remat_blocks else 1
    return {
        "som_fused": steps + eval_batches if som_model else 0,
        "attention_fwd": (steps * passes * train_blocks + eval_batches * eval_blocks
                          if impl == "pallas" else 0),
        "attention_bwd": steps * train_blocks if impl in ("pallas", "hybrid") else 0,
        "block_fwd": 0,
        "block_bwd": 0,
    }


def describe(cfg) -> str:
    """The model's widths as a run's first line prints them."""
    if cfg.model_arch == "swin":
        w = cfg.swin
        return (f"model=swin embed={w.embed_dim} depths={list(w.depths)} "
                f"heads={list(w.num_heads)} patch={w.patch_size} window={w.window_size}")
    if cfg.model_arch == "deit":
        return (f"model=deit emb={cfg.vit.emb_dim} depth={cfg.vit.depth} heads={cfg.vit.heads} "
                f"head_dim=64 patch={cfg.vit.patch_size} dropout={cfg.vit.proj_drop} "
                f"emb_dropout={cfg.vit.attn_drop} distill={cfg.distillation}")
    if cfg.model_arch == "mobile_vit":
        return ("model=mobile_vit (MobileViT-S: stem 16, mv2 32-160, transformer dims "
                "144/192/240, depths 2/4/3, 4 heads, head conv 640)")
    if cfg.model_arch == "desom":
        d = cfg.data
        return (f"model=desom ae={[d.num_channels * d.input_size ** 2, *cfg.ae.encoder_dims]} "
                f"act={cfg.ae.act} batch_norm={cfg.ae.batch_norm} map={cfg.som.map_size} "
                f"optimizer={cfg.optimizer.type} lr={cfg.optimizer.lr}")
    return (f"model={cfg.model_arch} map={cfg.som.map_size} emb={cfg.vit.emb_dim} "
            f"depth={cfg.vit.depth} dec_emb={cfg.vit.dec_emb_dim} dec_depth={cfg.vit.dec_depth} "
            f"heads={cfg.vit.heads} patch={cfg.vit.patch_size}")


def steady_ms(step_ms):
    """The median step time from the sixth step on (the warm-up steps, the
    capture and the first replays excluded), or of every step of a shorter
    run."""
    return statistics.median(step_ms[5:] or step_ms)


def steady_steps(n):
    """The steps ``steady_ms`` reads, as printed."""
    return f"steps 6-{n}" if n > 5 else f"steps 1-{n}"


def eval_batch_count(n, batch_size):
    """The eval batches of an ``n``-row split: drop-last, or the whole split
    as one ragged batch when it is smaller than one batch."""
    return n // batch_size if n >= batch_size else 1


def train_run(dev, label, impl, steps, evaluate, config=CONFIG, make_dm=build_datamodule,
              data="synthetic MNIST-shaped images", extra=None, eager=False, falls=True):
    """Trains ``config`` (attention ``impl``, or as shipped when None; more
    overrides in ``extra``) for ``steps`` steps on the data module
    ``make_dm`` builds, as replays of one captured step (``eager``: the
    step body step by step) and, with ``evaluate``, runs the clustering
    eval (one warm-up batch, then every batch); prints and checks what
    every train phase checks (with ``falls``, that the recon loss fell).
    Returns (cfg, dm, trainer, hist, launches)."""
    over = {"data.allow_synthetic": True, "data.synthetic_size": SYNTHETIC_SIZE, **(extra or {})}
    if impl is not None:
        over["train.attn_impl"] = impl
    cfg = load_config(config, over)
    impl = model_attn_impl(cfg)
    print(
        f"{label}: config {os.path.basename(config)} {describe(cfg)} batch={cfg.batch_size} "
        f"distance={cfg.som.distance_fcn} use_pallas_som={cfg.train.use_pallas_som} "
        f"remat={cfg.train.remat_blocks} compute={cfg.train.compute_dtype} attn_impl={impl} "
        f"num_classes={cfg.data.num_classes} data={data} "
        f"mode={'eager' if eager else 'graphed'}",
        flush=True,
    )
    dm = make_dm(cfg, dev)
    trainer = Trainer(cfg, device=dev, dm=dm)
    n_params = sum(p.numel() for p in trainer.model.parameters())
    eval_batches = eval_batch_count(dm.n_train, cfg.batch_size) + 1 if evaluate else 0

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
    step_ms = steady_ms(trainer.step_ms)
    print(
        f"{label}: params={n_params} images={dm.n_train} steps={trainer.step} "
        f"recon_loss first={recon[0]:.6f} last={recon[-1]:.6f} "
        f"total_loss last={total[-1]:.6f} som_loss last={hist['train/som_loss'][-1]:.6f}",
        flush=True,
    )
    print(
        f"{label}: median_step_ms={step_ms:.4f} images_per_s={cfg.batch_size / step_ms * 1e3:.1f} "
        f"({steady_steps(trainer.step)}, CUDA events between step ends) wall_s={wall:.3f}",
        flush=True,
    )
    if res is not None:
        print(
            f"{label} eval: purity={res['purity']:.4f} nmi={res['nmi']:.4f} "
            f"batches={eval_batches} (one a warm-up) inference_s={res['inference_time']:.4f}",
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
    check(all(math.isfinite(v) for v in recon), "non-finite recon loss")
    check(not falls or recon[-1] < recon[0], f"recon loss did not fall: {recon[0]} -> {recon[-1]}")
    check(launches == want, f"{label}: launch counts {launches} != {want}")
    return cfg, dm, trainer, hist, launches


def phase_train(dev):
    """Phase 4; returns (the step-0 losses, the run: train_run's tuple)."""
    run = train_run(dev, "train", None, TRAIN_STEPS, evaluate=True)
    cfg, dm, trainer, hist, _ = run

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
    return {k: float(hist[k][0]) for k in FIRST_LOSSES}, run


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


def phase_graphed_vs_eager(dev, label, impl, graphed, smi, extra=None, config=CONFIG):
    """Phases A, B and F: the graphed run ``graphed`` (train_run's tuple)
    against an eager run of the same config, seed and steps (the same step
    body, batches and kernels): every step's three losses and every final
    parameter and buffer within rtol GRAPH_RTOL (bitwise equality expected;
    the largest differences are printed). Prints both runs' median ms a
    step and images/s beside the card's name and power limit."""
    cfg, _, tr_g, hist_g, _ = graphed
    _, _, tr_e, hist_e, _ = train_run(dev, f"{label}_eager", impl, tr_g.step, False,
                                      config=config, extra=extra, eager=True)
    compare_runs(label, cfg, tr_g, hist_g, tr_e, hist_e, FIRST_LOSSES, smi)


def compare_runs(label, cfg, tr_g, hist_g, tr_e, hist_e, losses, smi):
    """A graphed run's ``losses`` at every step and final parameters against
    its eager run's, within rtol GRAPH_RTOL (phases A, B, D), and both
    runs' median ms a step and images/s."""
    for k in losses:
        a, b = np.asarray(hist_g[k]), np.asarray(hist_e[k])
        check(a.shape == b.shape, f"{label}: {k} has {a.shape} steps graphed, {b.shape} eager")
        diff = np.abs(a - b)
        rel = float((diff / np.maximum(np.abs(b), 1e-30)).max())
        print(f"{label} graphed_vs_eager {k}: steps={len(a)} max_abs_diff={diff.max():.3e} "
              f"max_rel_diff={rel:.3e} bitwise_equal_steps={int((a == b).sum())}", flush=True)
        check(rel <= GRAPH_RTOL, f"{label}: graphed {k} differs from eager by {rel:.3e}")
    worst, equal, total = (0.0, ""), 0, 0
    named_g = [*tr_g.model.named_parameters(), *tr_g.model.named_buffers()]
    named_e = [*tr_e.model.named_parameters(), *tr_e.model.named_buffers()]
    check([n for n, _ in named_g] == [n for n, _ in named_e], f"{label}: models differ")
    for (name, pg), (_, pe) in zip(named_g, named_e):
        d = (pg.detach() - pe.detach()).abs()
        rel = float((d / pe.detach().abs().clamp_min(1e-30)).max())
        worst = max(worst, (rel, name))
        equal += int((d == 0).sum())
        total += d.numel()
        check(bool((d <= GRAPH_RTOL * pe.detach().abs()).all()),
              f"{label}: final {name} differs graphed vs eager (max rel {rel:.3e})")
    n_buffers = sum(b.numel() for _, b in tr_g.model.named_buffers())
    print(f"{label} graphed_vs_eager params and buffers ({n_buffers} buffer values): "
          f"max_rel_diff={worst[0]:.3e} ({worst[1]}) bitwise_equal={equal}/{total}", flush=True)
    for mode, tr in (("graphed", tr_g), ("eager", tr_e)):
        ms = steady_ms(tr.step_ms)
        print(f"{label} {mode}: median_step_ms={ms:.4f} images_per_s={cfg.batch_size / ms * 1e3:.1f} "
              f"({steady_steps(tr.step)}, CUDA events between step ends) card: {smi}", flush=True)


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


def profile_run(label, overrides, config=CONFIG):
    """``profile_step`` on ``config`` (the flagship yaml) with ``overrides``,
    in a process of its own (one profiler session a process); returns its
    JSON line."""
    cmd = [sys.executable, "-m", "vitsom_tpu_torch.train.profile_step", "--config", config,
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


def profile_check(label, config, over, smi):
    """``profile_step`` on ``config`` with ``over`` (profile_run), its
    numbers printed beside the card's name and power limit, and each
    hand-written kernel's count under R = PROFILE_STEPS steps held to R
    times its count a step, in both modes (the hd <= 16 configurations run
    the row kernels, hd >= 32 the tensor-core kernels). Returns the JSON."""
    res = profile_run(label, over, config)
    cfg = load_config(config, {"data.allow_synthetic": True, **over})
    per = expected_launches(cfg, model_attn_impl(cfg), PROFILE_STEPS, 0)
    mma = cfg.vit.emb_dim // cfg.vit.heads >= 32
    want = {"som_partial_kernel": per["som_fused"], "som_finalize_kernel": per["som_fused"],
            "attn_fwd_kernel": 0 if mma else per["attention_fwd"],
            "attn_fwd_mma_kernel": per["attention_fwd"] if mma else 0,
            "attn_bwd_kernel": 0 if mma else per["attention_bwd"],
            "attn_bwd_mma_kernel": per["attention_bwd"] if mma else 0}
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
    return res


def phase_profiles(smi):
    """Phase C: the kernels that execute under replay. ``profile_step``
    profiles PROFILE_STEPS eager steps and PROFILE_STEPS replays of the
    captured step of the flagship with ``xla`` and with ``pallas`` and of
    bench.py's configuration (``profile_check``; the flagship's and the
    bench configuration's attention runs the row kernels, hd 8 and 2)."""
    for label, over in (("xla", {}), ("pallas", {"train.attn_impl": "pallas"}),
                        ("bench", BENCH_OVERRIDES)):
        profile_check(label, CONFIG, over, smi)


def phase_train_cifar(dev):
    """Phase 13: the emb-192 ViT-SOM at full width; returns the pallas run's
    launch counts.

    ``configs/vit_som/vit_som_cifar-10.yaml`` at its full widths and depth
    (emb 192, depth 12, 3 heads, decoder emb 96 and depth 2, 4x4 map, SOM
    latent D = 64 x 192, batch 128, float32, no remat), trained on the
    clustering objective (``data.num_classes`` 0; phase D trains the yaml's
    classification as shipped) on un-augmented synthetic 32x32x3 images
    (``raw_synthetic_datamodule``), once with
    ``xla`` and once with ``pallas`` attention, CIFAR_STEPS steps and the
    clustering eval each. The pallas run's step-0 losses equal the xla
    run's within rtol 1e-5 and its launch counts the formula (module
    docstring); its reconstructions of one eval batch are finite and
    [128, 32, 32, 3]."""
    data = "un-augmented synthetic 32x32x3 images (clustering objective)"
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


def cls_run(dev, label, config, impl, steps, dm=None, eager=False, evaluate=True,
            size=CLS_SYNTHETIC_SIZE):
    """Trains ``config`` as shipped (classification, augmentation on the
    device, or the static path's train rows transformed once) with
    attention ``impl`` (None: as shipped) on ``size`` synthetic images
    (``dm``, or a new classification data module) for ``steps`` steps
    (None: one epoch), graphed or ``eager``; a finished epoch validates,
    and ``evaluate`` runs the test eval (one warm-up batch, then every
    batch). Prints and checks what phase D checks of every run. Returns
    (cfg, dm, trainer, hist, launches, test metrics or None)."""
    over = {"data.allow_synthetic": True, "data.synthetic_size": size}
    if impl is not None:
        over["train.attn_impl"] = impl
    cfg = load_config(config, over)
    aug = cfg.data.augment
    print(
        f"{label}: config {os.path.basename(config)} {describe(cfg)} batch={cfg.batch_size} "
        f"num_classes={cfg.data.num_classes} input={cfg.data.input_size}x"
        f"{cfg.data.input_size}x{cfg.data.num_channels} "
        f"smoothing={cfg.optimizer.smoothing} use_pallas_som={cfg.train.use_pallas_som} "
        f"attn_impl={model_attn_impl(cfg)} augment=(randaug_n={aug.randaug_n} "
        f"autoaugment={aug.autoaugment} reprob={aug.reprob} flip={aug.horizontal_flip}) "
        f"mode={'eager' if eager else 'graphed'}",
        flush=True,
    )
    if dm is None:
        t0 = time.perf_counter()
        dm = build_datamodule(cfg, dev)
        print(f"{label}: data train={dm.n_train} val={dm.split_len('val')} "
              f"test={dm.split_len('test')} steps_per_epoch={dm.steps_per_epoch} "
              f"static={dm.static} built in {time.perf_counter() - t0:.2f} s", flush=True)
    trainer = Trainer(cfg, device=dev, dm=dm)
    steps = dm.steps_per_epoch if steps is None else steps

    reset_launches()
    hist = trainer.fit(max_steps=steps, eager=eager)
    res = trainer.evaluate() if evaluate else None
    torch.cuda.synchronize()
    launches = read_launches()
    bs = cfg.batch_size
    eval_batches = (len(trainer.val_history) * eval_batch_count(dm.split_len("val"), bs)
                    + (eval_batch_count(dm.split_len("test"), bs) + 1 if evaluate else 0))
    want = expected_launches(cfg, model_attn_impl(cfg), issued_steps(trainer.step, eager),
                             eval_batches)
    check(eager or trainer.graph is not None, f"{label}: the graphed run captured no graph")
    check(trainer.step == steps, f"{label}: trained {trainer.step} steps, not {steps}")

    keys = steps_lib.metric_keys(cfg)
    losses = [k for k in keys if k.endswith("_loss")]
    step_ms = steady_ms(trainer.step_ms)
    first_cls = float(hist["train/cls_loss"][0])
    print(f"{label}: steps={trainer.step} "
          + " ".join(f"{k[6:]} first={hist[k][0]:.6f} last={hist[k][-1]:.6f}" for k in losses),
          flush=True)
    print(f"{label}: median_step_ms={step_ms:.4f} images_per_s={bs / step_ms * 1e3:.1f} "
          f"({steady_steps(trainer.step)}, CUDA events between step ends) augmentation_ms_per_epoch="
          + ",".join(f"{v:.1f}" for v in trainer.fill_ms)
          + f" ({dm.steps_per_epoch} batches of {bs} gathered"
          + (" from the transformed rows" if dm.static else " and augmented")
          + " into the epoch buffer)", flush=True)
    for v in trainer.val_history:
        print(f"{label} validation epoch {v['epoch']} (step {v['step']}): "
              + " ".join(f"{k}={v[k]:.6f}" for k in sorted(v) if k.startswith("val/"))
              + f" ms={v['seconds'] * 1e3:.1f} "
              f"batches={eval_batch_count(dm.split_len('val'), bs)} "
              f"(the first includes the val split's transform)", flush=True)
        check(0.0 <= v["val/accuracy"] <= 1.0, f"{label}: val accuracy {v['val/accuracy']}")
        check(all(math.isfinite(v[k]) for k in v if k.startswith("val/")),
              f"{label}: non-finite validation numbers")
    if res is not None:
        print(f"{label} test: accuracy={res['accuracy']:.6f} precision={res['precision']:.6f} "
              f"recall={res['recall']:.6f} f1={res['f1']:.6f} "
              f"ms={res['inference_time'] * 1e3:.1f} "
              f"batches={eval_batch_count(dm.split_len('test'), bs)} "
              f"(after one warm-up batch)", flush=True)
        check(0.0 <= res["accuracy"] <= 1.0, f"{label}: test accuracy {res['accuracy']}")
    print(f"{label} launches: " + " ".join(f"{k}={v} (expected {want[k]})"
                                           for k, v in launches.items())
          + f" [train steps {trainer.step} ({issued_steps(trainer.step, eager)} issued from "
          f"Python), eval batches {eval_batches}]", flush=True)
    for k in losses:
        check(all(math.isfinite(v) for v in hist[k]), f"{label}: non-finite {k}")
    # the ViT and Swin heads start near 0 (std 0.02), so their first CE is
    # near ln K; DESOM's classifier starts at torch's Linear init on an O(1)
    # latent; DeiT's lecun-normal head gives logits of std ~1 on its
    # normalised token, ~0.5 above ln K
    near = {"desom": None, "deit": 1.0, "mobile_vit": 1.0}.get(cfg.model_arch, 0.3)
    check(near is None or abs(first_cls - math.log(cfg.data.num_classes)) <= near,
          f"{label}: step-0 cls_loss {first_cls} is not within {near} of "
          f"ln {cfg.data.num_classes}")
    check(launches == want, f"{label}: launch counts {launches} != {want}")

    images = trainer.epoch_images["image"]
    mean = images.mean(dim=(0, 1, 2))
    std = images.std(dim=(0, 1, 2))
    print(f"{label}: epoch buffer {tuple(images.shape)} channel mean="
          + ",".join(f"{float(m):.4f}" for m in mean) + " std="
          + ",".join(f"{float(d):.4f}" for d in std), flush=True)
    check(bool(torch.isfinite(images).all()), f"{label}: non-finite augmented images")
    check(bool((mean.abs() < 1).all() and (std > 0.3).all() and (std < 2).all()),
          f"{label}: the augmented images leave the normalised domain")
    return cfg, dm, trainer, hist, launches, res


def hold_augmentation(dm, trainer):
    """The captured augmentation (replays of one graph, batch after batch)
    against eager calls of the same ops at the same draws, at the first,
    middle and last batch of ``trainer``'s epoch buffer: bitwise equality
    expected; held to one grey level on at most 0.1 % of the values."""
    bs = trainer.cfg.batch_size
    grey = 1.0 / (255.0 * min(dm.augment.std))
    ms, worst, frac = [], 0.0, 0.0
    for k in (0, dm.steps_per_epoch // 2, dm.steps_per_epoch - 1):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        eager = dm.augment_batch_eagerly(k)
        torch.cuda.synchronize()
        ms.append((time.perf_counter() - t0) * 1e3)
        diff = (trainer.epoch_images["image"][k * bs:(k + 1) * bs] - eager).abs()
        worst = max(worst, float(diff.max()))
        frac = max(frac, float((diff > 0).float().mean()))
    s, c = dm.train_x.shape[1], dm.train_x.shape[3]
    chunk = dm.augment.chunk_size(bs, s, c)
    print(f"augmentation {s}x{s}x{c} -> {dm.augment.size}: graphed_vs_eager "
          f"max_abs_diff={worst:.3e} (one grey level "
          f"{grey:.3e}) differing_share={frac:.3e} eager_ms_per_batch="
          + ",".join(f"{v:.2f}" for v in ms)
          + f" graphed_ms_per_batch={trainer.fill_ms[0] / dm.steps_per_epoch:.3f} "
          f"(fill_epoch's {trainer.fill_ms[0]:.1f} ms / {dm.steps_per_epoch} batches, the "
          f"epoch's draws, gathers and copies included) chunks_per_batch={bs // chunk} "
          f"of {chunk} images", flush=True)
    check(worst <= grey * 1.001 and frac <= 1e-3,
          f"the captured augmentation differs from its eager calls: {worst} on {frac}")


def phase_classification(dev, smi):
    """Phase D; returns {path: launch counts} of its ``pallas`` runs."""
    _, dm, tr, hist, launches, _ = cls_run(dev, "cls_pallas", CIFAR_CONFIG, "pallas", None)
    first = {k: float(hist[k][0]) for k in CLS_LOSSES}
    hold_augmentation(dm, tr)
    del tr
    cfg, _, tr_g, hist_g, _, _ = cls_run(dev, "cls_xla", CIFAR_CONFIG, "xla", CLS_STEPS, dm,
                                         evaluate=False)
    for k in CLS_LOSSES:
        a, b = float(hist_g[k][0]), first[k]
        rel = abs(a - b) / max(abs(b), 1e-30)
        print(f"cls_xla step0 {k}={a:.8f} pallas={b:.8f} rel_err={rel:.3e}", flush=True)
        check(rel <= TOL, f"cls step-0 {k}: xla {a} vs pallas {b}")
    _, _, tr_e, hist_e, _, _ = cls_run(dev, "cls_xla_eager", CIFAR_CONFIG, "xla", CLS_STEPS, dm,
                                       eager=True, evaluate=False)
    same = all(torch.equal(tr_g.epoch_images[k], tr_e.epoch_images[k]) for k in ("image", "label"))
    print(f"cls graphed_vs_eager: augmented epoch buffers bitwise equal={same}", flush=True)
    check(same, "the eager hold's augmented epoch buffer differs from the graphed run's")
    compare_runs("cls", cfg, tr_g, hist_g, tr_e, hist_e, CLS_LOSSES, smi)
    del tr_g, tr_e
    _, _, _, _, vit_launches, _ = cls_run(dev, "vit_pallas", VIT_CONFIG, "pallas", CLS_STEPS, dm)
    del dm
    profile_check("cls_pallas", CIFAR_CONFIG, {"train.attn_impl": "pallas"}, smi)
    return {"classification_pallas": launches, "vit_baseline_pallas": vit_launches}


def family_size(cfg, steps):
    """The synthetic_size whose split holds one epoch of ``steps`` steps and
    a val split of fewer rows than a batch (so one ragged val batch): N =
    15 B / 4 gives 3 B train rows and 3 B / 4 val rows at 80/20."""
    check(steps == 3 and cfg.data.dataset != "tiny-imagenet", "family_size is for E5's splits")
    return 15 * cfg.batch_size // 4


def family_quick_run(dev, config, smi):
    """E5: ``config`` as shipped with ``pallas`` attention, E5_STEPS graphed
    steps and one eval batch: for classification the epoch is those steps
    (``family_size``) and the validation after it is one ragged batch; for
    clustering (320 + 64 synthetic images: three batches) the eval step
    runs on the first batch of the concat. Returns the launch counts."""
    label = "e5_" + os.path.basename(config)[:-5]
    cfg = load_config(config, {"data.allow_synthetic": True})
    if cfg.classification:
        _, dm, tr, hist, launches, _ = cls_run(dev, label, config, "pallas", E5_STEPS,
                                               evaluate=False,
                                               size=family_size(cfg, E5_STEPS))
        check(len(tr.val_history) == 1 and dm.split_len("val") < cfg.batch_size,
              f"{label}: expected one ragged validation batch")
        del tr, dm
        return launches
    cfg, dm, tr, hist, launches = train_run(
        dev, label, "pallas", E5_STEPS, False, config=config,
        extra={"data.synthetic_size": 320}, falls=False)
    check(dm.steps_per_epoch == E5_STEPS, f"{label}: {dm.steps_per_epoch} steps an epoch")
    reset_launches()
    out = tr.eval_step(next(dm.eval_batches()), tr.current_temperature())
    torch.cuda.synchronize()
    got = read_launches()
    want = expected_launches(cfg, "pallas", 0, 1)
    print(f"{label} eval batch: som_loss={float(out['som_loss']):.6f} "
          f"recon_loss={float(out['recon_loss']):.6f} launches={got} (expected {want}) "
          f"card: {smi}", flush=True)
    check(math.isfinite(float(out["total_loss"])) and got == want,
          f"{label}: eval batch {got} != {want} or non-finite")
    del tr, dm
    return {k: launches[k] + got[k] for k in launches}


def phase_family(dev, smi):
    """Phase E, the family at its shipped shapes; returns {path: launch
    counts}, E1's (the main path) under ``tiny_imagenet_pallas``.

    E1: ``vit_som_tiny-imagenet.yaml`` as shipped with ``pallas`` (emb 192,
    depth 12, 3 heads, patch 4: N 257, B 512, 200 classes, a 14x14 map:
    the SOM at (512, 49152, 196), the whole augmentation at 64x64) on 4096
    + 819 synthetic images (3686 / 410 / 819 after the 90/10 split: 7 steps
    an epoch): one graphed epoch, validation (one ragged batch) and the
    test eval; the captured augmentation against its eager calls; the same
    7 steps eagerly (graphed equal to eager within GRAPH_RTOL, parameters
    included); 3 graphed steps with ``xla`` (step-0 losses equal within
    rtol 1e-5). E4: ``vit_tiny-imagenet.yaml`` on the same data, one
    graphed epoch (7 steps) and the test eval. E2: ``vit_som_flowers-
    102.yaml`` (224x224, patch 16: N 197, B 128, 102 classes; the
    augmentation in 16-image chunks) on 1280 + 256 images: one graphed
    epoch of 8 steps, validation and the test eval, and the captured 224
    augmentation against its eager calls. E3: ``vit_som_svhn.yaml`` (emb
    16, patch 2: the row kernels at N 257; a 40x40 map) likewise, 8 steps.
    E5: every other yaml of the family, ``family_quick_run``. Every
    trainer, graph and data module is released before the next run."""
    paths = {}
    _, dm, tr_g, hist_g, launches, _ = cls_run(dev, "tiny_imagenet_pallas", TINY_CONFIG,
                                               "pallas", None, size=SYNTHETIC_SIZE)
    paths["tiny_imagenet_pallas"] = launches
    check(dm.steps_per_epoch == 7 and dm.split_len("val") == 410,
          f"E1: {dm.steps_per_epoch} steps, {dm.split_len('val')} val rows")
    first = {k: float(hist_g[k][0]) for k in CLS_LOSSES}
    hold_augmentation(dm, tr_g)
    cfg, _, tr_e, hist_e, _, _ = cls_run(dev, "tiny_imagenet_pallas_eager", TINY_CONFIG,
                                         "pallas", None, dm, eager=True, evaluate=False,
                                         size=SYNTHETIC_SIZE)
    compare_runs("tiny_imagenet", cfg, tr_g, hist_g, tr_e, hist_e, CLS_LOSSES, smi)
    del tr_g, tr_e
    torch.cuda.empty_cache()
    _, _, tr, hist, _, _ = cls_run(dev, "tiny_imagenet_xla", TINY_CONFIG, "xla", E5_STEPS, dm,
                                   evaluate=False, size=SYNTHETIC_SIZE)
    for k in CLS_LOSSES:
        a, b = float(hist[k][0]), first[k]
        rel = abs(a - b) / max(abs(b), 1e-30)
        print(f"tiny_imagenet_xla step0 {k}={a:.8f} pallas={b:.8f} rel_err={rel:.3e}", flush=True)
        check(rel <= TOL, f"E1 step-0 {k}: xla {a} vs pallas {b}")
    del tr
    torch.cuda.empty_cache()
    _, _, tr, _, paths["vit_tiny_imagenet_pallas"], _ = cls_run(
        dev, "vit_tiny_imagenet_pallas", VIT_TINY_CONFIG, "pallas", None, dm,
        size=SYNTHETIC_SIZE)
    del tr, dm
    torch.cuda.empty_cache()
    for label, config in (("flowers102_pallas", FLOWERS_CONFIG), ("svhn_pallas", SVHN_CONFIG)):
        _, dm, tr, _, paths[label], _ = cls_run(dev, label, config, "pallas", None,
                                                size=E_STEPS * 160)
        check(dm.steps_per_epoch == E_STEPS, f"{label}: {dm.steps_per_epoch} steps an epoch")
        if config == FLOWERS_CONFIG:
            hold_augmentation(dm, tr)
        del tr, dm
        torch.cuda.empty_cache()
    for config in E5_CONFIGS:
        paths["e5_" + os.path.basename(config)[:-5]] = family_quick_run(dev, config, smi)
        torch.cuda.empty_cache()
    profile_check("tiny_imagenet_pallas", TINY_CONFIG, {"train.attn_impl": "pallas"}, smi)
    return paths


def phase_desom(dev, smi):
    """Phase F, DESOM (no kernel: its manhattan SOM is eager in both
    packages, so every wrapper's count must stay 0).

    F1: ``desom_mnist.yaml`` as shipped (784-500-500-2000-10, an 8x8
    manhattan map, B 128, adam at a constant lr 1e-3) on 4096 + 819
    synthetic MNIST-shaped images: TRAIN_STEPS graphed steps and the
    clustering eval, then the same steps eagerly (losses, parameters within
    GRAPH_RTOL). F2: the same with ``ae.batch_norm`` true, DESOM_BN_STEPS
    steps, graphed against eager with the running mean and var held too.
    F3: ``desom_flowers17.yaml`` as shipped (the static 224x224 path:
    150528-500-500-2000-10, 17 classes, B 256) on 4096 + 819 images (3277
    / 819 / 819: 12 steps an epoch): one graphed epoch, validation and the
    test eval, and ``profile_step`` on it. F4: ``desom_fmnist.yaml`` and
    ``desom_usps.yaml`` (B 256): E5_STEPS graphed steps and the clustering
    eval each."""
    run = train_run(dev, "desom_mnist", None, TRAIN_STEPS, True, config=DESOM_MNIST,
                    data="synthetic MNIST-shaped images")
    phase_graphed_vs_eager(dev, "desom_mnist", None, run, smi, config=DESOM_MNIST)
    del run
    bn = {"ae.batch_norm": True}
    run = train_run(dev, "desom_mnist_bn", None, DESOM_BN_STEPS, False, config=DESOM_MNIST,
                    extra=bn)
    check(any("running_var" in n for n, _ in run[2].model.named_buffers()), "F2: no BatchNorm")
    phase_graphed_vs_eager(dev, "desom_mnist_bn", None, run, smi, extra=bn, config=DESOM_MNIST)
    del run
    torch.cuda.empty_cache()
    _, dm, tr, _, launches, _ = cls_run(dev, "desom_flowers17", DESOM_FLOWERS, None, None,
                                        size=SYNTHETIC_SIZE)
    check(dm.static and dm.steps_per_epoch == 12, "F3: not the static path's 12 steps")
    check(sum(launches.values()) == 0, f"F3: a kernel ran: {launches}")
    del tr, dm
    torch.cuda.empty_cache()
    for name in ("desom_fmnist", "desom_usps"):
        train_run(dev, name, None, E5_STEPS, True, config=os.path.join(DESOM, f"{name}.yaml"),
                  falls=False)
        torch.cuda.empty_cache()
    profile_check("desom_flowers17", DESOM_FLOWERS, {}, smi)


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
    """Phase 5; returns the row of the main path's shape (SOM_SHAPES[SOM_MAIN],
    phase E1's).

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
    return rows[SOM_MAIN]


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


# ---------------------------------------------------------------------------
# phase G: the dataset readers, checkpoints, TensorBoard logging and the
# N-run protocol, on dataset files written from the seed in their published
# formats (no synthetic fallback: data.allow_synthetic stays false)
# ---------------------------------------------------------------------------

G2_RUNS = 2  # the protocol's n_runs (5 shipped), cut
G3_STEPS = 20
G4_EPOCHS = 2
G4_OVER = {"train.attn_impl": "pallas"}
# the flagship's (and any ViT-SOM clustering run's) TensorBoard tags at an
# epoch's last step, as the JAX trainer writes them
PROTOCOL_TAGS = steps_lib.METRIC_KEYS + ("perf/images_per_sec_per_chip",)
CLS_VAL_TAGS = ("val/accuracy", "val/cls_loss", "val/som_loss", "val/recon_loss",
                "val/total_loss")


def write_idx(path, arr):
    """An IDX file (big-endian dims, then the bytes), gzipped for a .gz path."""
    header = struct.pack(">I", (0x08 << 8) | arr.ndim) + struct.pack(f">{arr.ndim}I", *arr.shape)
    opener = (lambda p: gzip.open(p, "wb", compresslevel=6)) if path.endswith(".gz") else (
        lambda p: open(p, "wb"))
    with opener(path) as f:
        f.write(header)
        f.write(np.ascontiguousarray(arr, dtype=np.uint8).tobytes())


def write_mnist(d, raw, gz):
    """``raw`` (uint8 [N, 28, 28, 1] images, labels) as MNIST's four IDX
    files in ``d``."""
    os.makedirs(d, exist_ok=True)
    ext = ".gz" if gz else ""
    for stem, x, y in (("train", raw.train_x, raw.train_y), ("t10k", raw.test_x, raw.test_y)):
        write_idx(os.path.join(d, f"{stem}-images-idx3-ubyte{ext}"), x[..., 0])
        write_idx(os.path.join(d, f"{stem}-labels-idx1-ubyte{ext}"), y.astype(np.uint8))


def write_cifar(root, raw, hundred=False):
    """``raw`` (uint8 NHWC) as the python pickles of cifar-10 (five train
    batches and a test batch) or cifar-100 (train, test): [N, 3072] CHW rows
    and a label list."""
    d = os.path.join(root, "cifar-100-python" if hundred else "cifar-10-batches-py")
    os.makedirs(d, exist_ok=True)
    key = b"fine_labels" if hundred else b"labels"
    train = np.array_split(np.arange(len(raw.train_y)), 1 if hundred else 5)
    files = [("train" if hundred else f"data_batch_{i + 1}", raw.train_x[idx], raw.train_y[idx])
             for i, idx in enumerate(train)]
    files.append(("test" if hundred else "test_batch", raw.test_x, raw.test_y))
    for name, x, y in files:
        with open(os.path.join(d, name), "wb") as f:
            pickle.dump({b"data": x.transpose(0, 3, 1, 2).reshape(len(x), -1),
                         key: [int(v) for v in y]}, f, protocol=4)


def splits_equal(a, b):
    return all(getattr(a, k).dtype == getattr(b, k).dtype
               and np.array_equal(getattr(a, k), getattr(b, k))
               for k in ("train_x", "train_y", "test_x", "test_y"))


def timed_read(cfg_data):
    t0 = time.perf_counter()
    raw = datasets.load_raw(cfg_data)
    return raw, time.perf_counter() - t0


def phase_readers(root):
    """G1: small files of each format the card's machine can read, through
    ``load_raw`` with no fallback, bitwise against what was written (the
    readers' own transforms applied: CHW -> HWC, HWCN -> NHWC, svhn's label
    10 -> 0, reuters' 80/20 cut); prints which formats this machine cannot
    read and why."""
    from scipy.io import savemat

    rng = np.random.default_rng(12)

    def images(n, shape):
        return rng.integers(0, 256, size=(n, *shape), dtype=np.uint8)

    def labels(n, k):
        return rng.integers(0, k, size=n).astype(np.int64)

    cases = []
    for gz in (False, True):
        raw = datasets.ArraySplits(images(12, (28, 28, 1)), labels(12, 10),
                                   images(7, (28, 28, 1)), labels(7, 10))
        d = os.path.join(root, "g1", "gz" if gz else "raw")
        write_mnist(os.path.join(d, "mnist"), raw, gz)
        cases.append(("mnist idx" + (".gz" if gz else ""), "mnist", d, raw))
    for hundred in (False, True):
        raw = datasets.ArraySplits(images(10, (32, 32, 3)), labels(10, 100 if hundred else 10),
                                   images(4, (32, 32, 3)), labels(4, 100 if hundred else 10))
        d = os.path.join(root, "g1", "cifar")
        write_cifar(d, raw, hundred)
        cases.append(("cifar-100 pickles" if hundred else "cifar-10 pickles",
                      "cifar-100" if hundred else "cifar-10", d, raw))
    d = os.path.join(root, "g1", "npz")
    os.makedirs(d)
    raw = datasets.ArraySplits(images(6, (28, 28, 3)), labels(6, 9), images(3, (28, 28, 3)),
                               labels(3, 9))
    np.savez(os.path.join(d, "pathmnist.npz"), train_images=raw.train_x,
             train_labels=raw.train_y[:, None], test_images=raw.test_x,
             test_labels=raw.test_y[:, None])
    cases.append(("pathmnist.npz", "medmnist", d, raw))
    x, y = rng.random((10, 2000)), labels(10, 4)
    np.save(os.path.join(d, "reutersidf10k.npy"), {"data": x, "label": y[:, None]})
    x32 = x.astype(np.float32)
    cases.append(("reutersidf10k.npy", "reuters-10k", d,
                  datasets.ArraySplits(x32[:8], y[:8], x32[8:], y[8:])))
    want = []
    for f, n in (("train_32x32.mat", 9), ("test_32x32.mat", 5)):
        x, y = images(n, (32, 32, 3)), rng.integers(1, 11, size=n)
        y[0] = 10
        savemat(os.path.join(d, f), {"X": x.transpose(1, 2, 3, 0),
                                     "y": y[:, None].astype(np.uint8)})
        want += [x, np.where(y == 10, 0, y).astype(np.int64)]
    cases.append(("svhn .mat", "svhn", d, datasets.ArraySplits(*want)))
    for label, name, d, want in cases:
        got, seconds = timed_read(DataConfig(dataset=name, data_dir=d))
        same = splits_equal(got, want)
        print(f"G1 {label}: load_raw({name}) train={got.train_x.shape} {got.train_x.dtype} "
              f"test={got.test_x.shape} bitwise_equal_to_written={same} "
              f"read_ms={seconds * 1e3:.2f}", flush=True)
        check(same, f"G1: {label} read back differs from what was written")
    for formats, lib in (("usps (usps.h5)", "h5py"),
                         ("flowers-17, flowers-102, tiny-imagenet (jpg)", "PIL")):
        if importlib.util.find_spec(lib) is None:
            print(f"G1 {formats}: not readable on this machine: {lib} is not installed (the "
                  f"reader raises its ImportError; nothing substitutes for it)", flush=True)
        else:
            print(f"G1 {formats}: {lib} is installed", flush=True)


def tensors_of(tr):
    """[(name, tensor)] of everything a checkpoint holds, the live tensors."""
    out = list(tr.model.state_dict().items())
    for i, p in enumerate(tr.model.parameters()):
        out += [(f"adamw.{i}.{k}", v) for k, v in tr.optimizer.state[p].items()]
    out += [(f"lr.{i}", g["lr"]) for i, g in enumerate(tr.optimizer.param_groups)]
    out += [(f"state.{k}", getattr(tr.state, k)) for k in ("step", "epoch_start", "metrics")]
    return out


def snapshot(tr):
    return {k: v.detach().clone() for k, v in tensors_of(tr)}


def same_state(label, a, b):
    """Checks two snapshots bitwise; prints the count."""
    check(a.keys() == b.keys(), f"{label}: other tensors")
    differ = [k for k in a if not torch.equal(a[k], b[k])]
    values = sum(v.numel() for v in a.values())
    print(f"{label}: {len(a)} tensors ({values} values: parameters, buffers, AdamW moments and "
          f"step counts, lr tensors, device step, epoch start, metrics rows) bitwise_equal="
          f"{not differ}" + (f" first_differing={differ[:3]}" if differ else ""), flush=True)
    check(not differ, f"{label}: {differ[:3]} differ")


class ProtocolProbe(Trainer):
    """The trainer the protocol ``main`` builds, with holds around what it
    does: the clustering eval just before ``save_checkpoint("last")``, a
    snapshot of the saved tensors, the time and bytes of each save, the
    restored tensors against the snapshot (bitwise, at the same addresses)
    and a copy of the parameters after each validation."""

    instances = []
    on_init = None

    def __init__(self, *args, **kw):
        super().__init__(*args, **kw)
        self.saves, self.epoch_copies = [], []
        ProtocolProbe.instances.append(self)
        if ProtocolProbe.on_init is not None:
            ProtocolProbe.on_init(self)

    def save_checkpoint(self, tag="last", params=None, batch_stats=None):
        if tag == "last" and not self.cfg.classification:
            self.before_save = self.evaluate()
        self.saved = snapshot(self)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        path = super().save_checkpoint(tag, params, batch_stats)
        ms = (time.perf_counter() - t0) * 1e3
        self.saves.append((tag, ms, os.path.getsize(os.path.join(path, "state.pt"))))
        return path

    def restore_checkpoint(self, tag="last", path=None):
        held = [v.data_ptr() for _, v in tensors_of(self)]
        t0 = time.perf_counter()
        super().restore_checkpoint(tag, path)
        torch.cuda.synchronize()
        self.restore_ms = (time.perf_counter() - t0) * 1e3
        same_state(f"restore {tag}", snapshot(self), self.saved)
        check([v.data_ptr() for _, v in tensors_of(self)] == held,
              "the restore rebound a tensor a captured step reads")

    def validate(self, epoch):
        out = super().validate(epoch)
        if out is not None:
            self.epoch_copies.append({k: v.detach().clone()
                                      for k, v in self.model.state_dict().items()})
        return out


def run_protocol(label, argv, on_init=None):
    """``trainer.main(argv)`` with ``ProtocolProbe`` as its trainer; returns
    (the runs' results, the probes, the launch counts, the JSON written)."""
    json_path = argv[argv.index("--json-out") + 1]
    ProtocolProbe.instances, ProtocolProbe.on_init = [], on_init
    trainer_mod.Trainer = ProtocolProbe
    print(f"{label}: python -m vitsom_tpu_torch.train.trainer " + " ".join(argv), flush=True)
    try:
        reset_launches()
        t0 = time.perf_counter()
        results = trainer_mod.main(argv)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = read_launches()
    finally:
        trainer_mod.Trainer = Trainer
        ProtocolProbe.on_init = None
    with open(json_path) as f:
        payload = json.load(f)
    print(f"{label}: protocol wall_s={wall:.3f} json={json.dumps(payload)}", flush=True)
    return results, ProtocolProbe.instances, launches, payload


def check_events(label, tr, tags):
    """The run's event file holds exactly ``tags`` at the steps each epoch
    ends; returns its scalars."""
    spe = tr.dm.steps_per_epoch
    want = {(t, spe * (e + 1)) for t in tags for e in range(tr.epochs_done)}
    got = tb_writer.read_scalar_events(tr.logger.path)
    have = {(t, s) for t, s, _ in got}
    print(f"{label} events: {tr.logger.path} records={len(got)} "
          f"tags={sorted({t for t, _ in have})} "
          f"steps={sorted({s for _, s in have})} equal_to_the_jax_set={have == want}", flush=True)
    check(have == want, f"{label}: event tags {sorted(have ^ want)[:6]} differ from the JAX set")
    return got


def phase_protocol_flagship(dev, root, smi):
    """G2: ``vit_som_mnist.yaml`` as shipped from gzipped IDX files of 60000
    + 10000 images, one epoch, two runs through the protocol ``main``.
    Returns (the data dir, the launch counts)."""
    mnist = datasets.make_synthetic(DataConfig(dataset="mnist", synthetic_size=60000))
    raw = datasets.ArraySplits(mnist.train_x, mnist.train_y, mnist.test_x[:10000],
                               mnist.test_y[:10000])
    d = os.path.join(root, "mnist_full")
    t0 = time.perf_counter()
    write_mnist(os.path.join(d, "mnist"), raw, gz=True)
    sizes = sum(os.path.getsize(os.path.join(d, "mnist", f))
                for f in os.listdir(os.path.join(d, "mnist")))
    got, read_s = timed_read(DataConfig(dataset="mnist", data_dir=d))
    print(f"G2 data: MNIST as four gzipped IDX files, {sizes} bytes, written in "
          f"{time.perf_counter() - t0 - read_s:.3f} s; load_raw read them in {read_s:.3f} s "
          f"(gunzip + parse of 60000 + 10000 28x28 images)", flush=True)
    check(splits_equal(got, raw), "G2: the gzipped IDX files read back differ")
    u8 = torch.from_numpy(np.concatenate([raw.train_x, raw.test_x])).to(dev)
    want_images = u8.float() / 255.0
    want_labels = torch.from_numpy(np.concatenate([raw.train_y, raw.test_y])).to(dev)
    exact = torch.from_numpy(np.concatenate([raw.train_x, raw.test_x]).astype(np.float32)
                             / np.float32(255)).to(dev)

    def hold_images(tr):
        same = torch.equal(tr.dm.images, want_images) and torch.equal(tr.dm.labels, want_labels)
        ulp = float((tr.dm.images - exact).abs().max())
        print(f"G2 run {tr.run_id}: device images {tuple(tr.dm.images.shape)} equal the IDX "
              f"bytes / 255 (as the module divides on the card) bitwise={same}; max |diff| to "
              f"numpy's correctly rounded division {ulp:.3e}", flush=True)
        check(same, "G2: the device images are not the IDX bytes / 255")

    argv = ["--config", CONFIG, "--epochs", "1", "--runs", str(G2_RUNS),
            "--json-out", os.path.join(root, "g2.json"),
            "--override", f"data.data_dir={d}",
            "--override", f"train.checkpoint_dir={os.path.join(root, 'g2_states')}",
            "--override", f"train.log_dir={os.path.join(root, 'g2_logs')}"]
    results, probes, launches, payload = run_protocol("G2", argv, hold_images)
    cfg = probes[0].cfg
    check(len(probes) == G2_RUNS and not cfg.data.allow_synthetic, "G2: not two file-backed runs")
    evals = eval_batch_count(probes[0].dm.n_train, cfg.batch_size) + 1
    want = expected_launches(cfg, model_attn_impl(cfg), G2_RUNS * issued_steps(
        probes[0].step, False), G2_RUNS * 2 * evals)
    for tr, res in zip(probes, results):
        check(tr.graph is not None and tr.step == tr.dm.steps_per_epoch,
              "G2: a run was not one graphed epoch")
        (tag, save_ms, nbytes), = tr.saves
        scalars = check_events(f"G2 run {tr.run_id}", tr, PROTOCOL_TAGS)
        ips = [v for t, _, v in scalars if t == "perf/images_per_sec_per_chip"][0]
        same_eval = all(res[k] == tr.before_save[k] for k in ("purity", "nmi"))
        print(f"G2 run {tr.run_id}: steps={tr.step} median_step_ms={res['median_step_ms']:.4f} "
              f"epoch_s={tr.dm.steps_per_epoch * cfg.batch_size / ips:.3f} "
              f"perf/images_per_sec_per_chip={ips:.1f} checkpoint {tag}: {nbytes} bytes "
              f"save_ms={save_ms:.1f} restore_ms={tr.restore_ms:.1f}; from the restored state "
              f"purity={res['purity']:.6f} nmi={res['nmi']:.6f}, just before the save "
              f"purity={tr.before_save['purity']:.6f} nmi={tr.before_save['nmi']:.6f} "
              f"equal={same_eval} run_s={res['run_seconds']:.3f}", flush=True)
        check(same_eval, "G2: the restored state evaluates otherwise than the saved one")
    keys = {"purity", "nmi", "run_duration", "inference_time", "images_per_sec_per_chip",
            "peak_memory_gb"}
    check(set(payload) == keys and all(len(v) == G2_RUNS and all(map(math.isfinite, v))
                                       for v in payload.values()),
          f"G2: --json-out holds {sorted(payload)}, not the harness's keys")
    print(f"G2: peak_memory_gb={payload.get('peak_memory_gb')} (torch.cuda.max_memory_allocated) "
          f"{smi}", flush=True)
    print("G2 launches: " + " ".join(f"{k}={v} (expected {want[k]})" for k, v in launches.items())
          + f" [{G2_RUNS} runs x (3 issued steps + 2 clustering evals of {evals} batches: the "
          f"hold's, just before the save, and the protocol's, after the restore)]", flush=True)
    check(launches == want, f"G2: launch counts {launches} != {want}")
    return d, launches


def phase_restore_captured(dev, d, root):
    """G3: a checkpoint restored into a trainer whose step is captured, and
    into a fresh one, continues bitwise as the uninterrupted run."""
    cfg = load_config(CONFIG, {"data.data_dir": d,
                               "train.checkpoint_dir": os.path.join(root, "g3_states"),
                               "train.log_dir": os.path.join(root, "g3_logs")})
    dm = build_datamodule(cfg, dev)
    tr = Trainer(cfg, device=dev, dm=dm)
    tr.fit(max_steps=G3_STEPS)
    check(tr.graph is not None, "G3: no graph was captured")
    tr.save_checkpoint("g3")
    tr.fit(max_steps=2 * G3_STEPS, new_epoch=False)
    uninterrupted = snapshot(tr)
    graph, held = tr.graph, [v.data_ptr() for _, v in tensors_of(tr)]
    tr.restore_checkpoint("g3")
    check(tr.graph is graph and [v.data_ptr() for _, v in tensors_of(tr)] == held,
          "G3: the restore replaced the graph or rebound a tensor")
    reset_launches()
    tr.fit(max_steps=2 * G3_STEPS)
    replays_only = read_launches()["som_fused"] == 0
    print(f"G3: restored step {G3_STEPS} into the captured trainer, then {G3_STEPS} steps "
          f"(graph replays only: {replays_only})", flush=True)
    check(replays_only, "G3: the restored trainer issued a step from Python")
    same_state("G3 captured trainer", snapshot(tr), uninterrupted)
    fresh = Trainer(cfg, device=dev, dm=dm)
    fresh.restore_checkpoint("g3")
    fresh.fit(max_steps=2 * G3_STEPS)
    check(fresh.graph is not None, "G3: the fresh trainer captured no graph")
    same_state(f"G3 fresh trainer ({WARMUP_STEPS} warm-up steps, a capture, replays)",
               snapshot(fresh), uninterrupted)


def phase_protocol_cifar(dev, root, smi):
    """G4: ``vit_som_cifar-10.yaml`` as shipped with ``pallas`` attention
    from python pickles of 50000 + 10000 images, two epochs, one run through
    the protocol ``main``. Returns the launch counts."""
    raw = datasets.make_synthetic(DataConfig(dataset="cifar-10", num_classes=10,
                                             num_channels=3, input_size=32,
                                             synthetic_size=50000))
    t0 = time.perf_counter()
    write_cifar(root, raw)
    written = time.perf_counter() - t0
    got, read_s = timed_read(DataConfig(dataset="cifar-10", data_dir=root))
    print(f"G4 data: cifar-10 as six python pickles (50000 + 10000 32x32x3 images), written in "
          f"{written:.3f} s; load_raw read them in {read_s:.3f} s", flush=True)
    check(splits_equal(got, raw), "G4: the pickles read back differ")
    argv = ["--config", CIFAR_CONFIG, "--epochs", str(G4_EPOCHS), "--runs", "1",
            "--json-out", os.path.join(root, "g4.json"),
            "--override", f"data.data_dir={root}",
            "--override", f"train.checkpoint_dir={os.path.join(root, 'g4_states')}",
            "--override", f"train.log_dir={os.path.join(root, 'g4_logs')}"]
    for k, v in G4_OVER.items():
        argv += ["--override", f"{k}={v}"]
    results, (tr,), launches, payload = run_protocol("G4", argv)
    cfg, dm, res = tr.cfg, tr.dm, results[0]
    bs = cfg.batch_size
    check(tr.graph is not None and tr.epochs_done == G4_EPOCHS, "G4: not two graphed epochs")
    accs = [v["val/accuracy"] for v in tr.val_history]
    best = int(np.argmax(accs))
    ck = torch.load(os.path.join(tr.checkpoint_dir("best"), "state.pt"), map_location=dev,
                    weights_only=True)
    same = all(torch.equal(ck["model"][k], v) for k, v in tr.epoch_copies[best].items())
    print(f"G4: val/accuracy by epoch {accs}; the best checkpoint equals the parameters copied "
          f"after epoch {best}'s validation bitwise={same}; saves (tag, ms, bytes) {tr.saves}; "
          f"test accuracy={res['accuracy']:.6f} f1={res['f1']:.6f} "
          f"median_step_ms={res['median_step_ms']:.4f} augmentation_ms_per_epoch="
          + ",".join(f"{v:.1f}" for v in res["fill_ms_per_epoch"]), flush=True)
    check(same and len(tr.epoch_copies) == G4_EPOCHS,
          "G4: the best checkpoint is not the best epoch's")
    check(0.0 <= res["accuracy"] <= 1.0, "G4: no test accuracy")
    scalars = check_events("G4", tr, steps_lib.metric_keys(cfg) + (
        "perf/images_per_sec_per_chip",) + CLS_VAL_TAGS)
    print("G4: perf/images_per_sec_per_chip by epoch "
          + ",".join(f"{v:.1f}" for t, _, v in scalars if t == "perf/images_per_sec_per_chip")
          + f" peak_memory_gb={payload.get('peak_memory_gb')} {smi}", flush=True)
    keys = {"accuracy", "precision", "recall", "f1", "run_duration", "inference_time",
            "images_per_sec_per_chip", "peak_memory_gb"}
    check(set(payload) == keys, f"G4: --json-out holds {sorted(payload)}")
    evals = (G4_EPOCHS * eval_batch_count(dm.split_len("val"), bs)
             + eval_batch_count(dm.split_len("test"), bs) + 1)
    want = expected_launches(cfg, model_attn_impl(cfg), issued_steps(tr.step, False), evals)
    print("G4 launches: " + " ".join(f"{k}={v} (expected {want[k]})" for k, v in launches.items())
          + f" [3 issued steps, eval batches {evals}: two validations, the test eval and its "
          f"warm-up batch]", flush=True)
    check(launches == want, f"G4: launch counts {launches} != {want}")
    return launches


def phase_protocol(dev, smi):
    """Phase G; returns {path: launch counts} of G2 and G4."""
    with tempfile.TemporaryDirectory() as root:
        phase_readers(root)
        d, flagship = phase_protocol_flagship(dev, root, smi)
        phase_restore_captured(dev, d, root)
        cifar = phase_protocol_cifar(dev, root, smi)
    return {"protocol_flagship": flagship, "protocol_cifar10_pallas": cifar}


# ---------------------------------------------------------------------------
# phase H: the Swin and DeiT baselines (drop-path and dropout inside the
# captured step, the ResNet-50 teacher), no kernel on their path
# ---------------------------------------------------------------------------

BASELINES = os.path.join(ROOT, "configs")
SWIN_CIFAR = os.path.join(BASELINES, "swin", "swin_cifar-10.yaml")
SWIN_MEDMNIST = os.path.join(BASELINES, "swin", "swin_medmnist.yaml")
DEIT_CIFAR = os.path.join(BASELINES, "deit", "deit_cifar-10.yaml")
# H4: the other eight yamls, 3 graphed steps and one eval batch each
H4_CONFIGS = [os.path.join(BASELINES, "swin", f"swin_{n}.yaml")
              for n in ("cifar-100", "svhn", "tiny-imagenet", "flowers-17")] + [
    os.path.join(BASELINES, "deit", f"deit_{n}.yaml")
    for n in ("cifar-100", "svhn", "flowers-17")]
H_HOLD_STEPS = 40  # H1, H3: graphed against eager
H2_STEPS = 10
MASK_RECORD = 128  # the first entries of each mask kept a step (a Swin drop-path mask whole)
MASK_SIGMAS = 5.0
RESNET_WIDTHS = (64, 128, 256, 512)
RESNET_SIZES = (3, 4, 6, 3)


class MaskProbe:
    """Records what a trainer's dropout / drop-path masks were, from inside
    its steps, captured ones included: ``stochastic.bernoulli_mask`` is
    wrapped so that each call (site k of the step) also adds the mask's
    kept count to a device counter and copies its first MASK_RECORD
    entries into row ``step - epoch_start`` of a device buffer. The copies
    are ops of the step, so a captured graph replays them with its masks.
    One probe is active at a time (``activate``); the graph of a trainer
    keeps writing into the buffers of the probe it was captured with."""

    active = None
    _original = None

    def __init__(self, tr, label):
        self.tr, self.label = tr, label
        self.sites = []  # (keep, numel) a site, in call order
        self.k = 0
        self.kept = None
        self.rows = None
        step = tr.train_step

        @functools.wraps(step)  # keeps the step's attributes (DeiT's teacher)
        def probed(batch):
            self.k = 0
            return step(batch)

        tr.train_step = probed

    @classmethod
    def install(cls):
        if cls._original is None:
            cls._original = stochastic.bernoulli_mask

            def recorded(keep, shape, generator, device):
                m = cls._original(keep, shape, generator, device)
                if cls.active is not None:
                    cls.active.record(m, keep)
                return m

            stochastic.bernoulli_mask = recorded

    @classmethod
    def uninstall(cls):
        if cls._original is not None:
            stochastic.bernoulli_mask = cls._original
            cls._original, cls.active = None, None

    def activate(self):
        MaskProbe.active = self

    def record(self, m, keep):
        k, n = self.k, m.numel()
        self.k += 1
        if len(self.sites) <= k:
            self.sites.append((float(keep), n))
        if self.kept is None or k >= self.kept.shape[0]:
            grow = max(64, 2 * k + 2)
            kept = torch.zeros(grow, dtype=torch.int64, device=m.device)
            rows = torch.zeros((grow, self.tr.dm.steps_per_epoch, MASK_RECORD), dtype=torch.bool,
                               device=m.device)
            if self.kept is not None:
                kept[: self.kept.shape[0]] = self.kept
                rows[: self.rows.shape[0]] = self.rows
            self.kept, self.rows = kept, rows
        self.kept[k].add_(m.sum())
        first = m.reshape(-1)[:MASK_RECORD]
        self.rows[k, :, : first.numel()].index_copy_(0, self.tr.state.row().reshape(1),
                                                     first.reshape(1, -1))

    def check(self, steps, rows):
        """The kept share of each site over ``steps`` steps within
        MASK_SIGMAS binomial sigmas of its keep rate (printed per rate), and
        the recorded masks of consecutive rows in ``rows`` different."""
        kept = self.kept[: len(self.sites)].cpu().numpy()
        by_rate, worst = {}, 0.0
        for (keep, n), c in zip(self.sites, kept):
            draws = n * steps
            z = (c / draws - keep) / math.sqrt(keep * (1 - keep) / draws)
            worst = max(worst, abs(z))
            r = by_rate.setdefault(round(1 - keep, 6), [0, 0, 0.0])
            r[0] += int(c)
            r[1] += draws
            r[2] = max(r[2], abs(z))
        recorded = self.rows[: len(self.sites), :rows].cpu()
        same = [int(torch.equal(recorded[:, i], recorded[:, i + 1])) for i in range(rows - 1)]
        print(f"{self.label} masks: {len(self.sites)} sites a step over {steps} steps; by rate "
              + "; ".join(f"p={p:.6f} kept={c}/{d} share={c / d:.6f} max|z|={z:.2f}"
                          for p, (c, d, z) in sorted(by_rate.items()))
              + f"; consecutive replays with equal masks {sum(same)}/{rows - 1}", flush=True)
        check(worst <= MASK_SIGMAS, f"{self.label}: a site's kept share is {worst:.2f} sigma off")
        check(sum(same) == 0, f"{self.label}: masks repeat between steps")
        return recorded


def write_torchvision_resnet50(path, seed):
    """A state_dict with torchvision resnet50's names and shapes, drawn from
    ``seed``, saved at ``path``; returns it."""
    g = torch.Generator().manual_seed(seed)
    sd = {}

    def add_bn(name, c):
        sd[f"{name}.weight"] = 1.0 + 0.1 * torch.randn(c, generator=g)
        sd[f"{name}.bias"] = 0.1 * torch.randn(c, generator=g)
        sd[f"{name}.running_mean"] = torch.randn(c, generator=g)
        sd[f"{name}.running_var"] = torch.rand(c, generator=g) + 0.5
        sd[f"{name}.num_batches_tracked"] = torch.tensor(0)

    def conv(*shape):
        fan_in = shape[1] * shape[2] * shape[3]
        return torch.randn(*shape, generator=g) * math.sqrt(2.0 / fan_in)

    sd["conv1.weight"] = conv(64, 3, 7, 7)
    add_bn("bn1", 64)
    c_in = 64
    for s, (w, n) in enumerate(zip(RESNET_WIDTHS, RESNET_SIZES), start=1):
        for i in range(n):
            pre = f"layer{s}.{i}"
            sd[f"{pre}.conv1.weight"] = conv(w, c_in, 1, 1)
            add_bn(f"{pre}.bn1", w)
            sd[f"{pre}.conv2.weight"] = conv(w, w, 3, 3)
            add_bn(f"{pre}.bn2", w)
            sd[f"{pre}.conv3.weight"] = conv(4 * w, w, 1, 1)
            add_bn(f"{pre}.bn3", 4 * w)
            if i == 0:
                sd[f"{pre}.downsample.0.weight"] = conv(4 * w, c_in, 1, 1)
                add_bn(f"{pre}.downsample.1", 4 * w)
            c_in = 4 * w
    sd["fc.weight"] = 0.01 * torch.randn(1000, 2048, generator=g)
    sd["fc.bias"] = torch.zeros(1000)
    torch.save(sd, path)
    return sd


def baseline_cfg(config, root, extra=None):
    """``config`` as shipped on its synthetic stand-in (50000 + 10000
    images unless ``extra`` says otherwise), checkpoints and events under
    ``root``."""
    return load_config(config, {"data.allow_synthetic": True,
                                "data.synthetic_size": CLS_SYNTHETIC_SIZE,
                                "train.checkpoint_dir": os.path.join(root, "states"),
                                "train.log_dir": os.path.join(root, "logs"), **(extra or {})})


def baseline_trainer(label, config, cfg, dev, dm=None, probe=True):
    """A trainer of ``cfg`` (from the yaml ``config``; a new data module
    unless ``dm``), with a MaskProbe; prints the run's first line."""
    aug = cfg.data.augment
    print(f"{label}: config {os.path.basename(config)} {describe(cfg)} "
          f"batch={cfg.batch_size} num_classes={cfg.data.num_classes} "
          f"input={cfg.data.input_size}x{cfg.data.input_size}x{cfg.data.num_channels} "
          f"smoothing={cfg.optimizer.smoothing} lr={cfg.optimizer.lr} "
          f"warmup_epochs={cfg.optimizer.warmup_epochs} attn_impl={model_attn_impl(cfg)} "
          f"augment=(randaug_n={aug.randaug_n} autoaugment={aug.autoaugment} "
          f"reprob={aug.reprob})", flush=True)
    if dm is None:
        t0 = time.perf_counter()
        dm = build_datamodule(cfg, dev)
        print(f"{label}: data train={dm.n_train} val={dm.split_len('val')} "
              f"test={dm.split_len('test')} steps_per_epoch={dm.steps_per_epoch} built in "
              f"{time.perf_counter() - t0:.2f} s", flush=True)
    tr = Trainer(cfg, device=dev, dm=dm)
    return tr, (MaskProbe(tr, label) if probe else None)


def zero_launches(label, launches):
    print(f"{label} launches: {launches} (expected all 0: no kernel is on the path)", flush=True)
    check(sum(launches.values()) == 0, f"{label}: a kernel ran: {launches}")


def hold_masks(label, probe_g, probe_e, rows):
    """The graphed run's recorded masks equal the eager run's, row by row."""
    g = probe_g.rows[: len(probe_g.sites), :rows].cpu()
    e = probe_e.rows[: len(probe_e.sites), :rows].cpu()
    same = probe_g.sites == probe_e.sites and torch.equal(g, e)
    print(f"{label}: the replays' recorded masks equal the eager steps' ({rows} steps x "
          f"{len(probe_g.sites)} sites x {MASK_RECORD} entries): {same}", flush=True)
    check(same, f"{label}: the graphed run drew other masks than the eager run")


def print_test(label, res):
    print(f"{label} test: accuracy={res['accuracy']:.6f} precision={res['precision']:.6f} "
          f"recall={res['recall']:.6f} f1={res['f1']:.6f} ms={res['inference_time'] * 1e3:.1f}",
          flush=True)
    check(0.0 <= res["accuracy"] <= 1.0, f"{label}: test accuracy {res['accuracy']}")


def print_epochs(label, tr, smi, probe=True):
    for v in tr.val_history:
        print(f"{label} validation epoch {v['epoch']} (step {v['step']}): "
              + " ".join(f"{k}={v[k]:.6f}" for k in sorted(v) if k.startswith("val/"))
              + f" ms={v['seconds'] * 1e3:.1f}", flush=True)
        check(all(math.isfinite(v[k]) for k in v if k.startswith("val/")),
              f"{label}: non-finite validation numbers")
    ms = steady_ms(tr.step_ms)
    print(f"{label}: median_step_ms={ms:.4f} images_per_s={tr.cfg.batch_size / ms * 1e3:.1f} "
          f"({steady_steps(tr.step)}, CUDA events between step ends"
          + (", mask probe on) " if probe else ") ")
          + "augmentation_ms_per_epoch=" + ",".join(f"{v:.1f}" for v in tr.fill_ms)
          + f" card: {smi}", flush=True)


def phase_swin_cifar(dev, root, smi):
    """H1 (module docstring). Returns the launch counts of the whole run."""
    cfg = baseline_cfg(SWIN_CIFAR, root)
    tr, probe = baseline_trainer("h1_swin_cifar10", SWIN_CIFAR, cfg, dev)
    spe = tr.dm.steps_per_epoch
    blocks = tr.model.blocks
    print(f"h1_swin_cifar10: params={sum(p.numel() for p in tr.model.parameters())} "
          f"blocks dense={[b.dense for b in blocks]} tokens="
          f"{[b.resolution[0] * b.resolution[1] for b in blocks]} drop_path="
          f"{[round(b.drop_path.rate, 6) for b in blocks]}", flush=True)
    check(all(b.dense for b in blocks), "H1: the dense-masked path did not run everywhere")
    start = {n: p.detach().clone() for n, p in tr.model.named_parameters()}
    probe.activate()
    reset_launches()
    t0 = time.perf_counter()
    h0 = tr.fit(max_steps=spe)
    epoch0_s = time.perf_counter() - t0
    same = all(torch.equal(p, start[n]) for n, p in tr.model.named_parameters())
    print(f"h1_swin_cifar10 epoch 0: {spe} graphed steps at lr {set(h0['hp/lr'].tolist())} in "
          f"{epoch0_s:.3f} s (fill, steps, validation); parameters bitwise unchanged={same}; "
          f"cls_loss first={h0['train/cls_loss'][0]:.6f} last={h0['train/cls_loss'][-1]:.6f}",
          flush=True)
    check(same and np.all(h0["hp/lr"] == 0.0), "H1: epoch 0 moved the parameters")
    tr.save_checkpoint("epoch0")
    h1 = tr.fit(max_steps=spe + H_HOLD_STEPS)
    lr1 = float(np.float32(cfg.optimizer.lr) * np.float32(1.0 / cfg.optimizer.warmup_epochs))
    # the eager hold: a fresh trainer restored at the end of epoch 0
    tr_e, probe_e = baseline_trainer("h1_swin_cifar10_eager", SWIN_CIFAR, cfg, dev, dm=tr.dm)
    tr_e.restore_checkpoint("epoch0")
    probe_e.activate()
    h1e = tr_e.fit(max_steps=spe + H_HOLD_STEPS, eager=True)
    probe.activate()
    compare_runs("h1_swin_cifar10", cfg, tr, h1, tr_e, h1e, ("train/cls_loss",), smi)
    hold_masks("h1_swin_cifar10", probe, probe_e, H_HOLD_STEPS)
    del tr_e, probe_e
    torch.cuda.empty_cache()
    h1b = tr.fit(max_steps=2 * spe, new_epoch=False)
    lrs = np.concatenate([h1["hp/lr"], h1b["hp/lr"]])
    print(f"h1_swin_cifar10 epoch 1: lr {sorted(set(lrs.tolist()))} (base_lr / "
          f"{cfg.optimizer.warmup_epochs} = {lr1:.9g}); cls_loss first={h1['train/cls_loss'][0]:.6f} "
          f"last={h1b['train/cls_loss'][-1]:.6f}", flush=True)
    check(np.allclose(lrs, lr1, rtol=1e-6, atol=0), "H1: epoch 1 does not train at base_lr / 20")
    check(np.all(np.isfinite(np.concatenate([h0["train/cls_loss"], h1["train/cls_loss"],
                                             h1b["train/cls_loss"]]))), "H1: non-finite loss")
    probe.check(tr.step, spe)
    res = tr.evaluate()
    torch.cuda.synchronize()
    launches = read_launches()
    print_epochs("h1_swin_cifar10", tr, smi)
    print_test("h1_swin_cifar10", res)
    check(len(tr.val_history) == 2, "H1: not two validations")
    zero_launches("h1_swin_cifar10", launches)
    return launches


def phase_swin_medmnist(dev, root, smi):
    """H2: ``swin_medmnist.yaml`` (B 512, the windowed path padded 7 -> 8)
    graphed against eager for H2_STEPS steps (3 an epoch: epochs 1-3 train
    at base_lr * e / 25), then the test eval."""
    size = 15 * 512 // 4  # 1536 train rows: 3 steps an epoch; one ragged val batch
    over = {"data.synthetic_size": size}
    cfg = baseline_cfg(SWIN_MEDMNIST, root, over)
    tr, _ = baseline_trainer("h2_swin_medmnist", SWIN_MEDMNIST, cfg, dev, probe=False)
    blocks = tr.model.blocks
    check([b.dense for b in blocks] == [False, False, True, True],
          "H2: the first stage did not take the windowed path")
    reset_launches()
    hg = tr.fit(max_steps=H2_STEPS)
    res = tr.evaluate()
    torch.cuda.synchronize()
    launches = read_launches()
    tr_e, _ = baseline_trainer("h2_swin_medmnist_eager", SWIN_MEDMNIST, cfg, dev, dm=tr.dm,
                               probe=False)
    he = tr_e.fit(max_steps=H2_STEPS, eager=True)
    print(f"h2_swin_medmnist: blocks dense={[b.dense for b in blocks]} pad="
          f"{[getattr(b, 'pad', None) for b in blocks]} lr={hg['hp/lr'].tolist()}", flush=True)
    check(hg["hp/lr"].max() > 0, "H2: no step trained")
    compare_runs("h2_swin_medmnist", cfg, tr, hg, tr_e, he, ("train/cls_loss",), smi)
    print_test("h2_swin_medmnist", res)
    zero_launches("h2_swin_medmnist", launches)
    return launches


def phase_deit_cifar(dev, root, smi):
    """H3 (module docstring). Returns the launch counts of the epoch run."""
    d = os.path.join(root, "h3_data")
    os.makedirs(d)
    written = write_torchvision_resnet50(os.path.join(d, "resnet50.pth"), seed=13)
    cfg = baseline_cfg(DEIT_CIFAR, root, {"data.data_dir": d})
    tr, probe = baseline_trainer("h3_deit_cifar10", DEIT_CIFAR, cfg, dev)
    own = tr.train_step.teacher.state_dict()
    mapped = [k for k in written if not k.startswith("fc.")
              and not k.endswith("num_batches_tracked")]
    equal = all(torch.equal(own[k], written[k].to(dev)) for k in mapped)
    print(f"h3_deit_cifar10: teacher ResNet-50 from {os.path.basename(d)}/resnet50.pth: "
          f"{len(mapped)} tensors mapped, each equal to what was written={equal}; fc random; "
          f"student params={sum(p.numel() for p in tr.model.parameters())}", flush=True)
    check(equal and len(mapped) == 265, "H3: the teacher is not the written resnet50.pth")
    probe.activate()
    reset_launches()
    hg = tr.fit(max_steps=H_HOLD_STEPS)
    tr_e, probe_e = baseline_trainer("h3_deit_cifar10_eager", DEIT_CIFAR, cfg, dev, dm=tr.dm)
    probe_e.activate()
    he = tr_e.fit(max_steps=H_HOLD_STEPS, eager=True)
    probe.activate()
    compare_runs("h3_deit_cifar10", cfg, tr, hg, tr_e, he,
                 ("train/distill_loss", "train/cls_loss"), smi)
    hold_masks("h3_deit_cifar10", probe, probe_e, H_HOLD_STEPS)
    del tr_e, probe_e
    torch.cuda.empty_cache()
    spe = tr.dm.steps_per_epoch
    h = tr.fit(max_steps=spe, new_epoch=False)
    res = tr.evaluate()
    torch.cuda.synchronize()
    launches = read_launches()
    a = cfg.distillation.alpha
    total = np.concatenate([hg["train/distill_loss"], h["train/distill_loss"]])
    ce = np.concatenate([hg["train/cls_loss"], h["train/cls_loss"]])
    distill = (total - (1 - a) * ce) / a
    print(f"h3_deit_cifar10: CE first={ce[0]:.6f} last={ce[-1]:.6f}; distill (T^2 KL, "
          f"T={cfg.distillation.temperature}) first={distill[0]:.6f} last={distill[-1]:.6f}; "
          f"loss first={total[0]:.6f} last={total[-1]:.6f}", flush=True)
    check(np.all(np.isfinite(total)) and np.all(distill >= -1e-5), "H3: bad losses")
    probe.check(tr.step, H_HOLD_STEPS)
    print_epochs("h3_deit_cifar10", tr, smi)
    print_test("h3_deit_cifar10", res)
    zero_launches("h3_deit_cifar10", launches)
    return launches


def quick_size(cfg):
    """A synthetic_size whose split gives E5_STEPS steps an epoch and a val
    split smaller than a batch (one ragged batch)."""
    check(E5_STEPS == 3, "quick_size is for 3 steps")
    b = cfg.batch_size
    # 90/10 split: 4 B rows give 3.6 B train rows; 80/20: 15 B / 4 give 3 B
    return 4 * b if cfg.data.dataset == "tiny-imagenet" else 15 * b // 4


def phase_baselines(dev, smi):
    """Phase H; returns {path: launch counts}."""
    paths = {}
    with tempfile.TemporaryDirectory() as root:
        for label, run in (("h1_swin_cifar10", phase_swin_cifar),
                           ("h2_swin_medmnist", phase_swin_medmnist),
                           ("h3_deit_cifar10", phase_deit_cifar)):
            MaskProbe.install()
            try:
                paths[label] = run(dev, root, smi)
            finally:
                MaskProbe.uninstall()
            torch.cuda.empty_cache()
        for config in H4_CONFIGS:
            label = "h4_" + os.path.basename(config)[:-5]
            cfg = load_config(config, {"data.allow_synthetic": True})
            _, dm, tr, _, launches, _ = cls_run(dev, label, config, None, E5_STEPS,
                                                evaluate=False, size=quick_size(cfg))
            check(dm.steps_per_epoch == E5_STEPS and len(tr.val_history) == 1
                  and dm.split_len("val") < cfg.batch_size,
                  f"{label}: expected {E5_STEPS} steps and one ragged validation batch")
            zero_launches(label, launches)
            paths[label] = launches
            del tr, dm
            torch.cuda.empty_cache()
    for label, config in (("h1_swin_cifar10", SWIN_CIFAR), ("h3_deit_cifar10", DEIT_CIFAR)):
        profile_check(label, config, {}, smi)
    return paths


# ---------------------------------------------------------------------------
# phase I: MobileViT-S and the host augmentation path
# ---------------------------------------------------------------------------

MOBILE_VIT = os.path.join(ROOT, "configs", "mobile_vit")
MV_CIFAR = os.path.join(MOBILE_VIT, "mobile_vit_cifar-10.yaml")
MV_FLOWERS = os.path.join(MOBILE_VIT, "mobile_vit_flowers-17.yaml")
VIT_SOM_FLOWERS = os.path.join(FAMILY, "vit_som_flowers-17.yaml")
# I3: the full splits' synthetic sizes (svhn's 73257 train images: 58606
# train rows after the 80/20 split, 457 steps an epoch)
I3_CONFIGS = ((os.path.join(MOBILE_VIT, "mobile_vit_svhn.yaml"), 73257),
              (os.path.join(MOBILE_VIT, "mobile_vit_cifar-100.yaml"), CLS_SYNTHETIC_SIZE))
I1_GRAPHED = 20  # replays after the warm-up steps and the capture
I1_HOLD = 10  # steps from the restored checkpoint, graphed and eager
I2_SIZE = 1280  # 1024 train rows (8 steps), 256 val, 256 test
I3_STEPS = 3
I4_CLASSES = 6  # flowers-17's 80 images a class: 480 images, 3 steps of 128 an epoch
I4_EPOCHS = 2
I5_STEPS = WARMUP_STEPS + 1 + 3  # 3 replays after the capture
# the augmentation off, so that profile_step times the step alone (at 224
# the augmentation is 5x the step): the static path's resident train rows
STATIC_AUGMENT = {"data.augment.randaug_n": 0, "data.augment.resize_scale": [1.0, 1.0],
                  "data.augment.resize_ratio": [1.0, 1.0], "data.augment.reprob": 0,
                  "data.augment.horizontal_flip": 0, "data.augment.autoaugment": False}


def mobile_vit_cfg(config, root, extra=None):
    cfg = baseline_cfg(config, root, extra)
    print(f"config {os.path.basename(config)} {describe(cfg)} batch={cfg.batch_size} "
          f"num_classes={cfg.data.num_classes} input={cfg.data.input_size} "
          f"compute={cfg.train.compute_dtype} remat={cfg.train.remat_blocks} "
          f"smoothing={cfg.optimizer.smoothing} lr={cfg.optimizer.lr} "
          f"scheduler={cfg.optimizer.scheduler}", flush=True)
    return cfg


def check_first_ce(label, hist, cfg):
    first = float(hist["train/cls_loss"][0])
    check(all(math.isfinite(v) for v in hist["train/cls_loss"]), f"{label}: non-finite loss")
    # a lecun-normal head on the pooled 640 features: logits of std ~1
    check(abs(first - math.log(cfg.data.num_classes)) <= 1.0,
          f"{label}: step-0 cls_loss {first} is not within 1 of ln {cfg.data.num_classes}")


def phase_mobile_vit_main(dev, root, smi):
    """I1 (module docstring). Returns (launch counts of the 23-step run,
    its data module)."""
    label = "i1_mobile_vit_cifar10"
    cfg = mobile_vit_cfg(MV_CIFAR, root)
    t0 = time.perf_counter()
    dm = build_datamodule(cfg, dev)
    print(f"{label}: data train={dm.n_train} val={dm.split_len('val')} "
          f"test={dm.split_len('test')} steps_per_epoch={dm.steps_per_epoch} "
          f"streams={dm.streams} built in {time.perf_counter() - t0:.2f} s", flush=True)
    check(dm.streams and dm.steps_per_epoch == 312, f"{label}: not the streamed 312-step epoch")
    torch.cuda.reset_peak_memory_stats(dev)
    tr = Trainer(cfg, device=dev, dm=dm)
    steps = WARMUP_STEPS + 1 + I1_GRAPHED
    reset_launches()
    hist = tr.fit(max_steps=steps)
    torch.cuda.synchronize()
    launches = read_launches()
    peak = torch.cuda.max_memory_allocated(dev) / 1e9
    check(tr.graph is not None and tr.step == steps, f"{label}: no graphed run")
    check_first_ce(label, hist, cfg)
    ms = steady_ms(tr.step_ms)
    aug = statistics.median(tr.stream_ms)
    print(f"{label}: steps={steps} cls_loss first={hist['train/cls_loss'][0]:.6f} "
          f"last={hist['train/cls_loss'][-1]:.6f} median_step_ms={ms:.4f} "
          f"images_per_s={cfg.batch_size / ms * 1e3:.1f} ({steady_steps(steps)}, CUDA events "
          f"from the batch in place to the step's end) augmentation_ms_per_batch={aug:.2f} "
          f"(median of {len(tr.stream_ms)} streamed replays; the epoch's draws "
          f"{tr.fill_ms[0] - sum(tr.stream_ms):.1f} ms) peak_memory_gb={peak:.3f} card: {smi}",
          flush=True)
    last = dm.augment_batch_eagerly(steps - 1)
    grey = 1.0 / (255.0 * min(dm.augment.std))
    diff = (tr.epoch_images["image"] - last).abs()
    print(f"{label}: the streamed batch {steps - 1} against eager calls at its draws: "
          f"max_abs_diff={float(diff.max()):.3e} differing_share="
          f"{float((diff > 0).float().mean()):.3e} (one grey level {grey:.3e})", flush=True)
    check(float(diff.max()) <= grey * 1.001 and float((diff > 0).float().mean()) <= 1e-3,
          f"{label}: the streamed augmentation differs from its eager calls")
    zero_launches(label, launches)
    tr.save_checkpoint("mid")
    hist_g = tr.fit(max_steps=steps + I1_HOLD, new_epoch=False)
    state_g = snapshot(tr)
    del tr
    torch.cuda.empty_cache()
    tr_e = Trainer(cfg, device=dev, dm=dm)
    tr_e.restore_checkpoint("mid")
    hist_e = tr_e.fit(max_steps=steps + I1_HOLD, eager=True)
    same = all(np.array_equal(hist_g[k], hist_e[k]) for k in hist_g)
    print(f"{label}: {I1_HOLD} graphed steps against {I1_HOLD} eager steps from the checkpoint "
          f"at step {steps}: losses bitwise_equal={same} eager median_step_ms="
          f"{statistics.median(tr_e.step_ms):.4f}", flush=True)
    check(same, f"{label}: the graphed losses differ from the eager ones")
    same_state(label, state_g, snapshot(tr_e))
    del tr_e
    torch.cuda.empty_cache()
    profile_check(label, MV_CIFAR, STATIC_AUGMENT, smi)
    return launches, dm


def write_flowers17(root, classes, seed):
    """flowers-17's published layout: ``jpg/image_0001.jpg`` on, 80 images a
    class in name order, of sizes 240-500 px."""
    from PIL import Image

    rng = np.random.default_rng(seed)
    d = os.path.join(root, "jpg")
    os.makedirs(d)
    tints = rng.integers(0, 256, size=(classes, 3))
    for i in range(classes * 80):
        h, w = (int(v) for v in rng.integers(240, 500, size=2))
        img = np.clip(tints[i // 80] + rng.normal(0, 40, size=(h, w, 3)), 0, 255)
        Image.fromarray(img.astype(np.uint8)).save(os.path.join(d, f"image_{i + 1:04d}.jpg"),
                                                   quality=90)


def host_run(dev, label, config, data_dir, root, smi):
    """I4: ``config`` from the jpg dir for I4_EPOCHS epochs, graphed, with
    validation and the test eval; every batch the step read equals the
    host batch ``train_batches`` makes again, to the bit. Returns the
    launch counts."""
    cfg = mobile_vit_cfg(config, root, {"data.data_dir": data_dir,
                                        "data.allow_synthetic": False,
                                        "total_epochs": I4_EPOCHS})
    t0 = time.perf_counter()
    dm = build_datamodule(cfg, dev)
    print(f"{label}: data from {data_dir} train={dm.n_train} val={dm.split_len('val')} "
          f"test={dm.split_len('test')} steps_per_epoch={dm.steps_per_epoch} host={dm.host} "
          f"sizes={len({x.shape for x in dm.train_x})} built in "
          f"{time.perf_counter() - t0:.2f} s workers={dm._workers()} "
          f"os.cpu_count={os.cpu_count()}", flush=True)
    check(dm.host and dm.train_x.dtype == object and dm.steps_per_epoch == 3,
          f"{label}: not the host path's 3 steps an epoch")
    tr = Trainer(cfg, device=dev, dm=dm)
    consumed = []
    stream = dm.stream_batch

    def recording(index, out):
        stream(index, out)
        consumed.append(out["image"].cpu())

    dm.stream_batch = recording
    reset_launches()
    t0 = time.perf_counter()
    hist = tr.fit()
    seconds = time.perf_counter() - t0
    res = tr.evaluate()
    torch.cuda.synchronize()
    launches = read_launches()
    check(tr.graph is not None and tr.epochs_done == I4_EPOCHS, f"{label}: no graphed epochs")
    check_first_ce(label, hist, cfg)
    host = [b["image"] for e in range(I4_EPOCHS) for b in dm.train_batches(e, tr.host_seed)]
    same = len(host) == len(consumed) and all(
        torch.equal(c, torch.from_numpy(h)) for c, h in zip(consumed, host))
    bs = cfg.batch_size
    eval_batches = (len(tr.val_history) * eval_batch_count(dm.split_len("val"), bs)
                    + eval_batch_count(dm.split_len("test"), bs) + 1)
    want = expected_launches(cfg, model_attn_impl(cfg), issued_steps(tr.step, False),
                             eval_batches)
    print(f"{label}: {tr.step} steps in {seconds:.2f} s (fit, validation included); "
          f"the device batches equal the host arrays bitwise={same} ({len(consumed)} batches); "
          f"host_ms_between_batches=" + ",".join(f"{v:.1f}" for v in dm.host_batch_ms)
          + " trainer_wait_ms=" + ",".join(f"{v:.1f}" for v in tr.host_wait_ms)
          + f" step_ms=" + ",".join(f"{v:.2f}" for v in tr.step_ms)
          + f" device_wait_ms=" + ",".join(f"{v:.1f}" for v in tr.stream_ms)
          + f" card: {smi}", flush=True)
    print_epochs(label, tr, smi, probe=False)
    print_test(label, res)
    print(f"{label} launches: " + " ".join(f"{k}={v} (expected {want[k]})"
                                           for k, v in launches.items())
          + f" [train steps {tr.step} ({issued_steps(tr.step, False)} issued), eval batches "
          f"{eval_batches}]", flush=True)
    check(same, f"{label}: a device batch differs from its host array")
    check(launches == want, f"{label}: launch counts {launches} != {want}")
    dm.close()
    return launches


def phase_mobile_vit(dev, smi):
    """Phase I; returns {path: launch counts}."""
    paths = {}
    with tempfile.TemporaryDirectory() as root:
        paths["i1_mobile_vit_cifar10"], dm = phase_mobile_vit_main(dev, root, smi)
        # I5: remat on against off, 3 replays each on I1's data
        runs = {}
        for remat in (False, True):
            label = f"i5_mobile_vit_cifar10_remat_{str(remat).lower()}"
            cfg = mobile_vit_cfg(MV_CIFAR, root, {"train.remat_blocks": remat})
            tr = Trainer(cfg, device=dev, dm=dm)
            torch.cuda.reset_peak_memory_stats(dev)
            reset_launches()
            hist = tr.fit(max_steps=I5_STEPS)
            torch.cuda.synchronize()
            paths[label] = read_launches()
            zero_launches(label, paths[label])
            check(tr.graph is not None and tr.model.remat == remat, f"{label}: not graphed")
            runs[remat] = (hist, snapshot(tr))
            print(f"{label}: step_ms=" + ",".join(f"{v:.3f}" for v in tr.step_ms)
                  + f" (the replays' median {statistics.median(tr.step_ms[-3:]):.3f}) "
                  f"peak_memory_gb={torch.cuda.max_memory_allocated(dev) / 1e9:.3f} "
                  f"card: {smi}", flush=True)
            del tr
            torch.cuda.empty_cache()
        (h0, s0), (h1, s1) = runs[False], runs[True]
        loss_err = max(float(np.max(np.abs(h1[k] - h0[k]) / np.maximum(np.abs(h0[k]), 1e-30)))
                       for k in h0)
        worst = max(float(((s1[k].double() - s0[k].double()).abs()
                           / (1e-30 + s0[k].double().abs())).max()) for k in s0
                    if s0[k].is_floating_point())
        print(f"i5: remat against no remat after {I5_STEPS} steps (3 replays): losses rel "
              f"{loss_err:.3e}, parameters, running statistics and AdamW moments largest rel "
              f"{worst:.3e} (bound {GRAPH_RTOL})", flush=True)
        check(loss_err <= GRAPH_RTOL and all(
            torch.allclose(s1[k], s0[k], rtol=GRAPH_RTOL, atol=0) for k in s0),
            "i5: remat changes the step")
        dm.close()
        del dm
        torch.cuda.empty_cache()
        # I2: one epoch of the cut split, validation and the test eval
        _, dm, tr, _, paths["i2_mobile_vit_cifar10_epoch"], res = cls_run(
            dev, "i2_mobile_vit_cifar10_epoch", MV_CIFAR, None, None, size=I2_SIZE)
        check(dm.steps_per_epoch == 8 and len(tr.val_history) == 1 and not dm.streams,
              "i2: expected one whole-epoch fill of 8 steps and its validation")
        bn = tr.model.blocks[0].expand.bn
        check(not torch.equal(bn.running_var, torch.ones_like(bn.running_var)),
              "i2: the running statistics did not move")
        zero_launches("i2_mobile_vit_cifar10_epoch", paths["i2_mobile_vit_cifar10_epoch"])
        del tr, dm
        torch.cuda.empty_cache()
        # I3: the other full splits, 3 steps each, the peak memory
        for config, size in I3_CONFIGS:
            label = "i3_" + os.path.basename(config)[:-5]
            cfg = mobile_vit_cfg(config, root, {"data.synthetic_size": size})
            torch.cuda.reset_peak_memory_stats(dev)
            t0 = time.perf_counter()
            dm = build_datamodule(cfg, dev)
            tr = Trainer(cfg, device=dev, dm=dm)
            reset_launches()
            hist = tr.fit(max_steps=I3_STEPS)
            torch.cuda.synchronize()
            paths[label] = read_launches()
            check(dm.streams and tr.graph is not None, f"{label}: not streamed and graphed")
            check_first_ce(label, hist, cfg)
            print(f"{label}: train={dm.n_train} steps_per_epoch={dm.steps_per_epoch} "
                  f"streams={dm.streams} step_ms=" + ",".join(f"{v:.3f}" for v in tr.step_ms)
                  + f" augmentation_ms_per_batch=" + ",".join(f"{v:.1f}" for v in tr.stream_ms)
                  + f" peak_memory_gb={torch.cuda.max_memory_allocated(dev) / 1e9:.3f} "
                  f"(an unstreamed epoch buffer: "
                  f"{dm.steps_per_epoch * cfg.batch_size * 224 * 224 * 3 * 4 / 1e9:.1f} GB) "
                  f"seconds={time.perf_counter() - t0:.1f} card: {smi}", flush=True)
            zero_launches(label, paths[label])
            dm.close()
            del tr, dm
            torch.cuda.empty_cache()
        # I4: the host path from a jpg dir
        data = os.path.join(root, "flowers17")
        t0 = time.perf_counter()
        write_flowers17(data, I4_CLASSES, seed=17)
        print(f"i4: wrote {I4_CLASSES * 80} jpgs in flowers-17's layout in "
              f"{time.perf_counter() - t0:.2f} s", flush=True)
        paths["i4_mobile_vit_flowers17_host"] = host_run(
            dev, "i4_mobile_vit_flowers17_host", MV_FLOWERS, data, root, smi)
        zero_launches("i4_mobile_vit_flowers17_host", paths["i4_mobile_vit_flowers17_host"])
        paths["i4_vit_som_flowers17_host"] = host_run(
            dev, "i4_vit_som_flowers17_host", VIT_SOM_FLOWERS, data, root, smi)
        check(paths["i4_vit_som_flowers17_host"]["som_fused"] > 0,
              "i4: the SOM kernel did not run on the host path")
    # the host path's steps under the profiler: cifar-10's 32x32 images
    # through the host transform (data.device_augment false)
    profile_check("i4_vit_som_cifar10_host", CIFAR_CONFIG, {"data.device_augment": False}, smi)
    return paths


class PhaseClock:
    """Prints each group of phases' host seconds and the total so far."""

    def __init__(self):
        self.t0 = self.last = time.perf_counter()

    def __call__(self, name):
        now = time.perf_counter()
        print(f"phase {name}: {now - self.last:.1f} s (total {now - self.t0:.1f} s)", flush=True)
        self.last = now


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

        clock = PhaseClock()
        phase_build()
        clock("build")
        max_err = phase_kernel_vs_plain(dev)
        xla_first, flagship = phase_train(dev)
        phase_graphed_vs_eager(dev, "graph_xla", None, flagship, smi)
        timing = phase_timings(dev)
        clock("3-5, A")
        attn_err = phase_attention_vs_plain(dev)
        run = phase_train_attention(dev, "pallas", TRAIN_STEPS, True, xla_first)
        flagship_pallas = run[4]
        phase_graphed_vs_eager(dev, "graph_pallas", "pallas", run, smi)
        del run
        phase_train_attention(dev, "hybrid", HYBRID_STEPS, False, xla_first)
        attn_timing = phase_attention_timings(dev)
        clock("6-9")
        block_err = phase_block_vs_plain(dev)
        block_launches = phase_block_flagship(dev, flagship[2], flagship[1])
        block_timing = phase_block_timings(dev)
        clock("10-12")
        cifar = phase_train_cifar(dev)
        clock("13")
        cls_paths = phase_classification(dev, smi)
        clock("D")
        family_paths = phase_family(dev, smi)
        clock("E")
        phase_desom(dev, smi)
        clock("F")
        phase_bench(dev, smi)
        phase_profiles(smi)
        clock("B, C")
        protocol_paths = phase_protocol(dev, smi)
        clock("G")
        baseline_paths = phase_baselines(dev, smi)
        clock("H")
        mobile_paths = phase_mobile_vit(dev, smi)
        clock("I")
    except SmokeFailure as e:
        print(f"FAIL: {e}", file=sys.stderr)
        return 1

    # launches: phase G4's protocol run of vit_som_cifar-10 from its
    # pickles (pallas), the last path with these kernels on it and, by path,
    # every train run that launches the kernel and every phase-H run (Swin
    # and DeiT: no kernel is on their path, their counts are 0)
    paths = {"flagship_xla": flagship[4], "flagship_pallas": flagship_pallas,
             "cifar10_clustering_pallas": cifar, **cls_paths, **family_paths,
             **protocol_paths}
    main_path = protocol_paths["protocol_cifar10_pallas"]

    def by_path(name):
        out = {path: counts[name] for path, counts in paths.items() if counts[name]}
        out.update({path: counts[name] for path, counts in baseline_paths.items()})
        out.update({path: counts[name] for path, counts in mobile_paths.items()})
        return out

    kernels = [{
        "name": "som_fused",
        "route": "cuda",
        "source": "vitsom_tpu_torch/ops/csrc/som_fused.cu",
        "replaces": "vitsom_tpu/ops/som_pallas.py:95",
        "launches": main_path["som_fused"],
        "launches_by_path": by_path("som_fused"),
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
            "launches": main_path[name],
            "launches_by_path": by_path(name),
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
            "launches_by_path": by_path(name),
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
