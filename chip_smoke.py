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
   ``block_fwd_kernel`` and ``block_bwd_kernel`` and of its streamed
   ``block_fwd_streamed`` and ``block_bwd_streamed``, which fail without a
   TF32 mma (HMMA), of the three hd >= 32 bf16 attention kernels (the one- and
   two-pass forwards, the backward), which fail without a bf16 wgmma
   (HGMMA ... BF16), and of the three hd <= 16 bf16 ones (every
   instantiation), which fail without a bf16 mma.sync (HMMA ... BF16);
   fails without ``cuobjdump``;
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
   (3, 17, 16, 2, 2), (4, 33, 16, 2, 4) (the resident design, csrc/block.cu),
   and since slice 23 the streamed design's (csrc/block_streamed.cu) twelve
   (``BLOCK_SHAPES``: emb 192 at N 65, 197, 257, its decoder, N 785 and
   1025, hd 4, 12, 192, D 768 with M 3072; (8, 400, 16, 2, 4) runs the
   resident forward and the streamed backward), each line naming the design
   ``block_fused.block_plan`` gave each direction; an output that misses
   a float32 yardstick (the plain version, eager autograd) must meet these
   tolerances against the float64 evaluation and be no further from it
   than the yardstick (the line names it; two float32 sums over 2050 rows
   can differ by more than atol 2e-5); two runs of each kernel must agree
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
12. block timings at the two flagship shapes and, since slice 23, the
   streamed design at the vit_som_cifar-10 encoder (128, 65, 192, 3, 4) and
   at N 257 (tiny-imagenet, cifar-100): each kernel (the resident backward
   with its reduction launch; the streamed kernels' persistent grid and
   workspace bytes printed), its plain version, and the port's eager Block
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
13b (since slice 23; inside phase 13, on its xla run's model). The fused
   block on the emb-192 path, as phase 11 on the flagship's: every block
   input of ``vit_som_cifar-10.yaml`` captured on an eval batch (12 encoder
   blocks of D 192, M 768 and 2 decoder blocks of D 96, M 384; 3 heads,
   N 65, B 128), all 14 through ``make_fused_block`` against the eager
   blocks, the backward of blocks 0 and 12 against autograd, the design of
   each printed (all streamed), launches held to the count of calls
   (``block_fwd_streamed`` 16, ``block_bwd_streamed`` 2);
13. the emb-192 ViT-SOM: ``configs/vit_som/vit_som_cifar-10.yaml`` at its
   full widths and depth (emb 192, depth 12, 3 heads: hd 64; decoder emb 96,
   depth 2: hd 32; N 65; 4x4 map, SOM latent 64 x 192; batch 128, float32,
   no remat) on the clustering objective (``data.num_classes`` 0; phase D
   runs the yaml as shipped, with its 10 classes) on the clustering split of
   an augmented dataset (``pipeline.ClusteringDataModule``: 10667 + 2133
   synthetic 32x32x3 images, 12800 rows, the yaml's train transform on the
   device, the captured augmentation held against eager calls), 20 steps
   with ``xla`` attention, then with ``pallas``, and the clustering eval of
   each on 4096 rows (3414 + 682 images) through the train transform on the
   host (``default_rng(0)``, in order, as the JAX package evaluates a
   train-mode split): step-0 losses equal within rtol 1e-5, launch counts
   of the steps and of the eval equal to the formula below, recon loss
   falling, losses finite, reconstructions [128, 32, 32, 3]; median step ms
   and images/s of both are printed. Both runs graphed.
M. data parallelism (``parallel/``). M1: phase 7's flagship ``pallas``
   run again (40 graphed steps and the eval) inside a one-rank NCCL group
   made in the smoke's own process, so the step takes the data-parallel
   path (the fused SOM's loss, the gradients and the metrics' losses
   all-reduced) with its all-reduces captured: its losses and every tensor
   of its state bitwise equal to phase 7's; both graphed step times
   printed. M2: two gloo ranks on the one card as child processes
   (``m2_rank``: torchrun's environment, a group over ``tcp``), the
   flagship with ``pallas`` for 8 eager steps (a gloo collective cannot be
   captured) at a local batch of 64, the sharded eval, k-means and the
   validation metrics: the ranks' parameters equal, and held against a
   one-rank run of the same seed at atol 5e-5 / rtol 1e-4 (the JAX
   data-parallel test's); purity, NMI, k-means and the validation metrics
   equal on both ranks; each rank's launches equal to the formula. A rank
   that fails prints its output and the phase fails.
B. ``bench.py``'s configuration: the flagship yaml with the overrides of
   ``bench.py:38-59`` (``BENCH_OVERRIDES``: 24x24 map, ``compute_dtype:
   bfloat16``, ``attn_impl: xla_bf16``, no remat, the fused SOM), cut to
   the phase-4 data (4096 + 819 synthetic images, not 70000) and 40 steps
   (not 500 epochs); graphed with the clustering eval, then held against
   its eager run as phase A holds the flagship; recon loss falling, losses
   finite, parameters float32, purity and NMI printed;
C. the kernels under replay: ``vitsom_tpu_torch.train.profile_step`` (a
   process of its own each: one profiler session a process) profiles R =
   PROFILE_STEPS (5) eager steps and R replays of the flagship with
   ``xla`` and with
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
   kernels at N 257; a 40x40 map), each one epoch of E_STEPS (4) steps
   (640 + 128 images), validation and the test eval; E4 ``vit_tiny-imagenet.yaml``
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
   block on the dense-masked path; B 128; H_SIZE = 12800 + 2560 images,
   80 steps an epoch): epoch 0 graphed (lr 0: every parameter bitwise as
   built),
   validation, a ``save_checkpoint``, then 40 steps of epoch 1 (lr
   base_lr / 20) held against a fresh trainer restored from that
   checkpoint and run eagerly (losses, parameters and the recorded masks
   within GRAPH_RTOL, bitwise in practice), the rest of epoch 1,
   validation and the test eval; no two steps' recorded masks equal, and
   each site's kept share over all 160 steps within 5 binomial sigmas of
   its keep rate (printed by drop-path rate). H2 ``swin_medmnist.yaml``
   (B 512, 28/4 = 7x7 tokens padded to 8x8 on the windowed path, then 4x4
   dense; 1536 train rows: 3 steps an epoch, so steps 3-9 train at
   base_lr e / 25) 10 graphed steps against 10 eager ones, then the test
   eval. H3 ``deit_cifar-10.yaml`` (emb 192, depth 12, 3 heads of 64,
   dropout 0.1 at 49 sites a step; H_SIZE images) with a ``resnet50.pth`` the phase
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
   before its step): 2 warm-up steps, the capture and I1_GRAPHED (5)
   replays; the last streamed batch against eager calls at its draws; a
   checkpoint, then I1_HOLD (4) more replays held bitwise against a fresh
   trainer restored from it and
   run eagerly (losses, parameters, running statistics, AdamW, device
   state); ``profile_step`` (R = PROFILE_STEPS) with the augmentation off
   (the static
   path's resident rows), which times the step alone. I5 the same yaml
   with ``train.remat_blocks`` on against off, 3 replays each on
   I1's data (2 warm-up steps, the capture, 3 replays): equal within
   GRAPH_RTOL, running statistics included, the replays' ms printed. I2
   one epoch of the yaml on I2_SIZE = 640 + 128 images (4 steps, a
   whole-epoch fill), validation and the test eval on the running statistics. I3
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
   ``os.cpu_count()``; ``profile_step`` (R = PROFILE_STEPS) on ``vit_som_cifar-10``
   with ``data.device_augment: false`` (the 32x32 images through the host
   path): the device's idle share while the steps wait for the host, and
   the SOM kernel's count under replay.
J. checkpoint evaluation (``phase_eval``, inside phase G's temporary
   directory, after G4), through ``eval_checkpoint.main`` as a user calls
   it, its trainer kept by ``EvalProbe``. J1 G2's last run's ``last``
   checkpoint (``vit_som_mnist.yaml`` as shipped, ``xla``, the 60000 +
   10000 IDX images) with ``--figures-dir``: purity and NMI equal to G2's
   restored eval; the SOM kernel's launches 547 + 546 + 64 (the clustering
   eval with its warm-up batch, the BMU pass, the distance pass over 8192
   rows); the kernel's distances against the plain ``compute_distances``
   of the same latents at 1e-5 (QE at rtol 1e-5, each TE term equal but on
   near ties within 1e-5, counted); the blocked kNN of the 4096 projection
   latents against a float64 kNN (sets equal but at a 15th/16th near tie,
   distances at 1e-5) and its ms; the UMAP graph, the layout and
   ``umap_embed`` timed, two layouts from one seed bitwise; the 1600
   decoded prototypes [1600, 28, 28, 1] against the plain decode of a
   host copy at 1e-5, each one's error against a float64 decode printed;
   the figures' paths and bytes, or the line that matplotlib is missing.
   J2 the same prototypes decoded with ``train.attn_impl: pallas`` (2
   forward launches), each launch's o held against the plain version on
   its own q, k, v at 1e-5 and against float64 (F64_FACTOR, F64_SLACK);
   the decode's distance to J1's and to the float64 decode printed; the
   forward kernel at (1600, 197, 2, 2) against its plain version at 1e-5,
   timed with its plain version and SDPA against its bound (phase 9's).
   J3 G4's state saved as ``last`` after G4's test eval: the same test
   metrics, bitwise; launches SOM 79 and attention forward 79 x 14. J4
   ``desom_mnist.yaml`` as shipped, one graphed epoch on G2's files, saved,
   then ``eval_checkpoint`` with k-means (every count 0); the k-means twice
   from one seed bitwise; its labels (but near ties) and inertia (rtol
   1e-5) against a float64 plain Lloyd from the same k-means++ seeds.
K. bf16 inputs to the attention kernels, the bf16 models and optimizer
   state, after phase I (no trainer of an earlier phase held). K1
   (``phase_attention_bf16``): the bf16 kernels (``csrc/attention_bf16.cu``)
   against their plain versions at (128, 197, 2, 8), (128, 197, 2, 2),
   (128, 65, 3, 64) contiguous, (128, 65, 3, 32) strided, (512, 257, 3, 64)
   contiguous, (512, 257, 3, 32) strided, (128, 65, 2, 8), (128, 65, 2, 2)
   and the JAX tests' (2, 33, 2, 16) and (1, 9, 1, 8) (strided below D 128;
   each shape's kernels, ``bf16_kernel``, printed: below hd 32 the
   tensor-core row kernels, from 32 up the wgmma ones; below hd 32 the
   two-pass forward from N 73), past the wgmma one-pass forward's 320
   keys (the two-pass forwards) (128, 400, 2, 8), P1's
   (512, 1025, 3, 64) and P2's (128, 785, 2, 8) and (128, 785, 2, 2), and,
   untimed, ``K1_VARIANTS``: (128, 197, 2, 2) and (128, 197, 2, 8) with q,
   k, v rows 2 bytes off a 4-byte boundary (the tensor-core row kernels'
   2-byte loads), (128, 197, 2, 8), (128, 197, 2, 2), (128, 400, 2, 8),
   (512, 1025, 3, 64), (128, 785, 2, 8) and (128, 785, 2, 2) with a quarter
   of the keys far from every query (some p in float32's subnormal range),
   forward and backward (the references over batch slices of at most
   K1_REF_SCORES scores), the
   backward on a bf16 o and do (``pallas``)
   and on a float32 o and do (``hybrid``): within 1 bf16 ulp on all but 0.1
   % of the elements and atol/rtol 1e-2 everywhere, lse within 1e-5 (the
   backwards' 1-ulp share against ``bwd_rounded64``, their plain version
   evaluated in float64 between its bf16 roundings, and within atol/rtol
   1e-2 of the plain version too; the far (512, 1025, 3, 64) a second time
   from another seed; ``K1_LIMITS``, the float32 backward's largest N at
   hd 2, 8, 16, without the 1-ulp bound), each output's error against
   float64 on the same bf16 inputs at most
   F64_FACTOR times the plain version's plus F64_SLACK; two runs bitwise
   equal; each timed with L2 flushed beside its plain version and SDPA on
   the same bf16 tensors (backend named), against the bound (bytes at 3.35
   TB/s, bf16 tensor-core operations at 989 TFLOP/s or the exponentials,
   the longest), and at ``K1_HYBRID_TIMED`` ((512, 257, 3, 64), (128,
   197, 2, 8), (128, 197, 2, 2), (128, 785, 2, 8)) the backward on the
   float32 o and do too. K2 ``vit_som_mnist.yaml`` + bf16
   + ``pallas`` (the bf16 tensor-core row kernels at hd 8 and 2):
   TRAIN_STEPS graphed steps held against eager, launches equal to the
   formula below, ``profile_step`` (each block's launches counted under
   the kernel its head dim takes). K3
   ``vit_som_tiny-imagenet.yaml`` + bf16 + ``pallas`` (B 512, the bf16
   tensor-core kernels at hd 64): K3_STEPS graphed steps, launches equal to
   the formula, the step ms beside E1's float32 one. P1-P3
   (``phase_long_sequences``, after K3), at full width under bf16:
   P1 ``vit_tiny-imagenet.yaml`` + ``vit.patch_size`` 2 (N 1025, 3 heads
   of 64, depth 12, B 512: the two-pass wgmma forward and the wgmma
   backward) and P2 ``vit_som_mnist.yaml`` + ``vit.patch_size`` 1 (N 785,
   hd 8 and 2: the two-pass mma.sync forward and the mma.sync backward; the
   SOM at (128, 12544, 1600)) with ``pallas``, P3 the flagship with
   ``hybrid`` (the mma.sync backward on float32 o and do): K3_STEPS graphed
   steps, launches equal to the formula, the step ms and peak memory, the
   same steps eagerly (losses and final parameters within GRAPH_RTOL), and
   the step-0 losses within P_XLA_RTOL of one eager ``xla`` step's. K4 ``swin_cifar-10``
   and ``deit_cifar-10`` with the JAX scoreboard's overrides (bf16,
   ``xla_bf16``; ``experiments/run_family_bench.py``): K4_STEPS graphed
   steps against eager, masks held as in H, float32 parameters and logits,
   no kernel. K5 ``bench.py``'s configuration + ``train.adam_mu_dtype:
   bfloat16``: TRAIN_STEPS steps, every first moment bf16, held against
   eager, the step ms beside B's.
Q. every head dim the JAX kernel takes, and the SOM at any depth
   (``phase_head_dims``): the float32 and bf16 attention kernels, forward,
   backward and (bf16) on hybrid's float32 o and do, at hd 1, 3, 4, 5, 12,
   17, 24, 25, 28, 31, 36, 40, 80, 96, 128, 192 (Q_HEAD_DIMS) and N 9, 65,
   197, 257, 321, 1025, on strided q, k, v views of one qkv buffer (B by
   ``q_batch``, 2 heads), and on views one element off their buffer's
   16-byte boundaries at hd 4, 24, 96, 192, against their plain versions as
   phases 6 and K1 hold them (float32 1e-5 and the float64 rule; bf16 1 ulp
   on all but 0.1 % against ``bwd_rounded64``, atol/rtol 1e-2, lse 1e-5,
   the float64 rule), two runs bitwise; the float32 kernels at tier 32 (hd
   25, 28, 31, 32) and N 9, 65 from 20 seeds more (the row kernels since
   slice 23) and N 1025 from 5 (the 3xTF32 kernels), their float64 ratios
   printed and every miss raised (Q_EDGE, Q_EDGE_LONG); bf16 hd 1 at (2,
   1025, 2, 1) from 5 seeds, the backward's share past 1 ulp of
   ``bwd_rounded64`` at most 1e-3 in dq, dk and dv (Q_HD1); every launch
   counted against its call; the SOM kernel
   on 4-byte copies at (B 12, D 33, P 42) and D 3137 from a row stride of
   3139 floats, one float into its buffer (B 128, P 1600), as phase 3 holds
   it. Q_TIMED in both dtypes beside SDPA, L2 flushed, each timed call held
   against the plain version's output. Then the heads overrides on the
   trainer, K3_STEPS graphed steps each held against eager, launches equal
   to the formula, step 0 against one eager ``xla`` step: the flagship at
   ``vit.heads: 4`` (hd 4 and 1) with ``pallas`` in float32 (within TOL)
   and bf16 (P_XLA_RTOL), and ``vit_som_tiny-imagenet.yaml`` at
   ``vit.heads: 2`` (hd 96 and 48, emb 192, B 512, depth cut from 12 to 2,
   printed) in bf16.

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
backward kernel once for each of those (2); phase 13b launches the
streamed forward once per cifar-10 block plus twice more (14 + 2 = 16) and
the streamed backward twice. Under ``compute_dtype:
bfloat16`` (K2, K3, P1-P3) the same counts go to the bf16 kernels, and
the float32 kernels' are 0.

Phase M1 launches what phase 7 does; each M2 rank issues all 8 of its
eager steps (S = 8) at B 64.

The last lines are the ``kernels`` JSON (the SOM and float32 attention
kernels' ``launches``: phase G4's protocol run, the last path all these
kernels are on; the bf16 attention kernels' K3's; with every path's count
under ``launches_by_path``, the phase-H, K4 paths and phase I's MobileViT
paths and J4 at 0, I4's ViT-SOM host run with its SOM launches, J1-J3's;
the SOM row's timings at (512, 49152, 196) and the attention rows' at
(512, 257, 3, 64), phase E1's and K3's shapes; the resident block rows at
the flagship encoder, the streamed rows (``block_fwd_streamed``,
``block_bwd_streamed``) with phase 13b's launches at the cifar-10 encoder
(128, 65, 192, 3, 4); then phase Q's designs on
its trainer paths, each with the path, its encoder's shape and that
path's launches), the nvidia-smi line and the result. The whole script takes about 14 minutes on an H100, the builds
included; ``PhaseClock`` prints each group of phases' seconds and the
card's memory. Any failure prints ``FAIL in phase <group>: <error>`` and
its traceback on standard output and standard error, and exits 1.
"""

from __future__ import annotations

import copy
import faulthandler
import functools
import gc
import gzip
import importlib.util
import json
import math
import os
import pickle
import signal
import socket
import statistics
import struct
import subprocess
import sys
import tempfile
import time
import traceback
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch
import torch.nn.functional as F

from vitsom_tpu_torch.config import DataConfig, load_config
from vitsom_tpu_torch.convert import block_weights
from vitsom_tpu_torch.data import datasets
from vitsom_tpu_torch.data.pipeline import ClusteringDataModule
from vitsom_tpu_torch.data.synthetic import build_datamodule
from vitsom_tpu_torch.eval import eval_checkpoint, metrics, umap, viz
from vitsom_tpu_torch.eval import evaluate as eval_lib
from vitsom_tpu_torch.eval.kmeans import KMeans
from vitsom_tpu_torch.models import stochastic
from vitsom_tpu_torch.models.vit import Block
from vitsom_tpu_torch.models.vit_som import model_attn_impl
from vitsom_tpu_torch.ops import _build, attention_fused, block_fused, som_fused
from vitsom_tpu_torch.ops.attention import xla_attention
from vitsom_tpu_torch.parallel import distributed as dist_lib
from vitsom_tpu_torch.som import layer as som
from vitsom_tpu_torch.train import optim as optim_lib
from vitsom_tpu_torch.train import profile_step
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
# E2, E3: one epoch of 4 steps (synthetic_size 640 at B 128: 512 train
# rows), to keep the smoke within its time budget
E_STEPS = 4
E5_STEPS = 3
DESOM = os.path.join(ROOT, "configs", "desom")
DESOM_MNIST = os.path.join(DESOM, "desom_mnist.yaml")
DESOM_FLOWERS = os.path.join(DESOM, "desom_flowers17.yaml")
DESOM_BN_STEPS = 10
CIFAR_STEPS = 20
# phase 13: the clustering split of 10667 + 2133 synthetic cifar-10 images
# (12800 rows, 100 steps an epoch) augmented on the device; the eval on
# 3414 + 682 = 4096 rows through the host train transform
C13_SIZE = 10667
C13_EVAL_SIZE = 3414
# phase M2: two gloo ranks on the one card, the flagship for 8 steps
M2_STEPS = 8
M2_WORLD = 2
# the JAX data-parallel test's tolerance (tests/test_pallas_kernels.py:305)
DP_ATOL, DP_RTOL = 5e-5, 1e-4
# R: the graph replays (and eager steps) profile_step profiles
PROFILE_STEPS = 5
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
KERNEL_SOURCES = ("som_fused", "attention", "attention_bf16", "block", "block_streamed")
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
# the emb-192 shapes (hd 64 on the tensor cores; hd 32 on them until slice
# 22, on the row kernels since slice 23) and the six row-kernel shapes
ATTN_TIMED = [s for s in ATTN_SHAPES if s[3] >= 32] + ATTN_SHAPES[:6]
# the main path's (phase E1, vit_som_tiny-imagenet) encoder shape: the
# kernels JSON line's attention rows
ATTN_MAIN = (512, 257, 3, 64)
# (B, N, D, H, mlp_ratio): the flagship's encoder and decoder blocks at full
# width, then the JAX tests' blocks (tests/test_block_pallas.py:46-53, :68):
# the resident design (csrc/block.cu); then the streamed design's
# (csrc/block_streamed.cu, since slice 23): the vit_som_cifar-10 encoder and
# decoder blocks, emb 192 at N 197 (flowers, medmnist) and 257 (cifar-100,
# tiny-imagenet), the port's CPU test shape, the flagship block past N 256
# (P2's patch-1 override: its forward at N 400 stays resident), hd 4 with M
# 60, hd 12, hd 192, N 1025, and the limits (D 768, M 3072, hd 192)
BLOCK_SHAPES = [(128, 197, 16, 2, 4.0), (128, 197, 4, 2, 4.0), (8, 197, 16, 2, 4.0),
                (4, 65, 24, 3, 4.0), (3, 17, 16, 2, 2.0), (4, 33, 16, 2, 4.0),
                (128, 65, 192, 3, 4.0), (128, 65, 96, 3, 4.0), (128, 197, 192, 3, 4.0),
                (128, 257, 192, 3, 4.0), (2, 9, 128, 2, 4.0), (8, 400, 16, 2, 4.0),
                (8, 785, 16, 2, 4.0), (3, 17, 20, 5, 3.0), (2, 33, 12, 1, 4.0),
                (2, 65, 384, 2, 4.0), (2, 1025, 192, 3, 4.0), (2, 9, 768, 4, 4.0)]
# the flagship's blocks (resident), then the cifar-10 encoder block at N 65
# and the tiny-imagenet / cifar-100 one at N 257 (streamed)
BLOCK_TIMED = BLOCK_SHAPES[:2] + [(128, 65, 192, 3, 4.0), (128, 257, 192, 3, 4.0)]
# the streamed design's row of the kernels JSON line: the cifar-10 encoder
BLOCK_STREAMED_MAIN = (128, 65, 192, 3, 4.0)
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
    attention_fused.LAUNCHES_FWD_BF16 = 0
    attention_fused.LAUNCHES_BWD_BF16 = 0
    block_fused.LAUNCHES_FWD = 0
    block_fused.LAUNCHES_BWD = 0
    block_fused.LAUNCHES_FWD_STREAMED = 0
    block_fused.LAUNCHES_BWD_STREAMED = 0


def read_launches():
    return {"som_fused": som_fused.LAUNCHES, "attention_fwd": attention_fused.LAUNCHES_FWD,
            "attention_bwd": attention_fused.LAUNCHES_BWD,
            "attention_fwd_bf16": attention_fused.LAUNCHES_FWD_BF16,
            "attention_bwd_bf16": attention_fused.LAUNCHES_BWD_BF16,
            "block_fwd": block_fused.LAUNCHES_FWD, "block_bwd": block_fused.LAUNCHES_BWD,
            "block_fwd_streamed": block_fused.LAUNCHES_FWD_STREAMED,
            "block_bwd_streamed": block_fused.LAUNCHES_BWD_STREAMED}


def issued_steps(steps, eager):
    """Train steps whose launches the wrappers' counters see: every eager
    step; of a graphed run, the WARMUP_STEPS eager steps and the one
    captured (its replays launch no Python)."""
    return steps if eager or steps <= WARMUP_STEPS else WARMUP_STEPS + 1


def expected_launches(cfg, impl, steps, eval_batches, part="all"):
    """What the code implies (module docstring): one attention call per
    block; with remat each block's forward runs again in the backward; the
    eval runs the forward only, under no_grad. A classification train step
    runs the encoder only, the ViT-SOM eval step the decoder too; the ViT
    baseline has no decoder and no SOM. Under ``compute_dtype: bfloat16``
    the attention launches are the bf16 kernels'. ``part`` "encoder" or
    "decoder" counts the attention launches of those blocks alone."""
    som_model = cfg.model_arch == "vit_som"
    enc = 0 if part == "decoder" else cfg.vit.depth
    dec = cfg.vit.dec_depth if som_model and part != "encoder" else 0
    eval_blocks = enc + dec
    train_blocks = enc if cfg.classification else eval_blocks
    passes = 2 if cfg.train.remat_blocks else 1
    fwd = steps * passes * train_blocks + eval_batches * eval_blocks if impl == "pallas" else 0
    bwd = steps * train_blocks if impl in ("pallas", "hybrid") else 0
    bf16 = cfg.train.compute_dtype == "bfloat16"
    return {
        "som_fused": steps + eval_batches if som_model else 0,
        "attention_fwd": 0 if bf16 else fwd,
        "attention_bwd": 0 if bf16 else bwd,
        "attention_fwd_bf16": fwd if bf16 else 0,
        "attention_bwd_bf16": bwd if bf16 else 0,
        "block_fwd": 0,
        "block_bwd": 0,
        "block_fwd_streamed": 0,
        "block_bwd_streamed": 0,
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
    runs' median ms a step and images/s. Every loss and tensor is compared
    and printed before the first miss raises; the message names the first
    step whose losses differ and the tensors that miss."""
    summary, misses = [], []
    for k in losses:
        a, b = np.asarray(hist_g[k]), np.asarray(hist_e[k])
        check(a.shape == b.shape, f"{label}: {k} has {a.shape} steps graphed, {b.shape} eager")
        diff = np.abs(a - b)
        rel = float((diff / np.maximum(np.abs(b), 1e-30)).max())
        first = np.flatnonzero(a != b)
        summary.append(f"{k} bitwise_equal_steps={int((a == b).sum())}/{len(a)} first_unequal_step="
                       f"{int(first[0]) if len(first) else None}")
        print(f"{label} graphed_vs_eager {k}: steps={len(a)} max_abs_diff={diff.max():.3e} "
              f"max_rel_diff={rel:.3e} bitwise_equal_steps={int((a == b).sum())}", flush=True)
        if not rel <= GRAPH_RTOL:  # a NaN misses too
            misses.append(f"graphed {k} differs from eager by {rel:.3e}")
    worst, equal, total, unequal = (0.0, ""), 0, 0, []
    named_g = [*tr_g.model.named_parameters(), *tr_g.model.named_buffers()]
    named_e = [*tr_e.model.named_parameters(), *tr_e.model.named_buffers()]
    check([n for n, _ in named_g] == [n for n, _ in named_e], f"{label}: models differ")
    for (name, pg), (_, pe) in zip(named_g, named_e):
        d = (pg.detach() - pe.detach()).abs()
        rel = float((d / pe.detach().abs().clamp_min(1e-30)).max())
        worst = max(worst, (rel, name))
        n_equal = int((d == 0).sum())
        equal += n_equal
        total += d.numel()
        if n_equal < d.numel():
            unequal.append((rel, name, d.numel() - n_equal, float(d.max())))
        if not bool((d <= GRAPH_RTOL * pe.detach().abs()).all()):
            misses.append(f"final {name} differs graphed vs eager (max rel {rel:.3e})")
    n_buffers = sum(b.numel() for _, b in tr_g.model.named_buffers())
    unequal.sort(reverse=True)
    summary.append(f"tensors not bitwise equal {len(unequal)}/{len(named_g)}, the worst (max rel, "
                   f"name, values unequal, max abs): "
                   + "; ".join(f"{r:.3e} {n} {c} {m:.3e}" for r, n, c, m in unequal[:5]))
    print(f"{label} graphed_vs_eager params and buffers ({n_buffers} buffer values): "
          f"max_rel_diff={worst[0]:.3e} ({worst[1]}) bitwise_equal={equal}/{total}", flush=True)
    print(f"{label} graphed_vs_eager summary: " + "; ".join(summary), flush=True)
    check(not misses, f"{label}: " + "; ".join(misses[:3]) + f" ({len(misses)} misses; "
          + "; ".join(summary) + ")")
    for mode, tr in (("graphed", tr_g), ("eager", tr_e)):
        ms = steady_ms(tr.step_ms)
        print(f"{label} {mode}: median_step_ms={ms:.4f} images_per_s={cfg.batch_size / ms * 1e3:.1f} "
              f"({steady_steps(tr.step)}, CUDA events between step ends) card: {smi}", flush=True)


def phase_bench(dev, smi):
    """Phase B: bench.py's configuration (BENCH_OVERRIDES), graphed with the
    clustering eval, then held against its eager run as phase A holds the
    flagship. Returns the graphed run's median step ms."""
    run = train_run(dev, "bench", None, TRAIN_STEPS, evaluate=True, extra=BENCH_OVERRIDES)
    cfg, _, trainer, _, _ = run
    check(cfg.train.compute_dtype == "bfloat16" and model_attn_impl(cfg) == "xla_bf16"
          and not cfg.train.remat_blocks and tuple(cfg.som.map_size) == (24, 24),
          "phase B did not build bench.py's configuration")
    check(next(trainer.model.parameters()).dtype == torch.float32, "bf16 parameters")
    phase_graphed_vs_eager(dev, "bench", None, run, smi, extra=BENCH_OVERRIDES)
    return steady_ms(trainer.step_ms)


# each profile runs in a fresh interpreter (profile_process), started one
# profile ahead so its imports overlap the phases before it
_NEXT_PROFILE = None


def profile_process():
    """A fresh interpreter, in a session of its own so that whatever it
    starts (a host path's fork server and workers) ends with it, that
    imports ``profile_step`` (no CUDA) and then runs ``profile_step.main``
    on the argument list it reads from its standard input (a JSON line)."""
    code = ("import json, sys\n"
            "from vitsom_tpu_torch.train import profile_step\n"
            "sys.exit(profile_step.main(json.loads(sys.stdin.readline())))")
    return subprocess.Popen([sys.executable, "-c", code], cwd=ROOT, stdin=subprocess.PIPE,
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
                            start_new_session=True)


def end_session(proc):
    """Kills what is left of ``proc``'s session and reaps ``proc``."""
    try:
        os.killpg(proc.pid, signal.SIGKILL)
    except ProcessLookupError:
        pass
    proc.wait()


def profile_run(label, overrides, config=CONFIG):
    """``profile_step`` on ``config`` (the flagship yaml) with ``overrides``,
    in a process of its own (one profiler session a process); returns its
    JSON line."""
    global _NEXT_PROFILE
    argv = ["--config", config, "--steps", str(PROFILE_STEPS)]
    for k, v in overrides.items():
        argv += ["--override", f"{k}={json.dumps(v)}"]
    proc, _NEXT_PROFILE = _NEXT_PROFILE or profile_process(), None
    try:
        stdout, stderr = proc.communicate(json.dumps(argv) + "\n", timeout=600)
    finally:
        end_session(proc)
    _NEXT_PROFILE = profile_process()
    lines = stdout.strip().splitlines()
    for line in lines[:-1]:
        print(f"profile_step[{label}]: {line}", flush=True)
    check(proc.returncode == 0 and lines,
          f"profile_step[{label}] failed ({proc.returncode}): {stderr[-2000:]}")
    return json.loads(lines[-1])


def profile_check(label, config, over, smi):
    """``profile_step`` on ``config`` with ``over`` (profile_run), its
    numbers printed beside the card's name and power limit, and each
    hand-written kernel's count under R = PROFILE_STEPS steps held to R
    times its count a step, in both modes (float32: each block's launches go
    to the row kernels where ``row_kernels`` says, hd <= 24 and, since slice
    23, the emb-192 decoders' hd 32, else to the tensor-core kernels; under
    bf16 to the kernel ``model_bf16_kernel`` names). Returns the JSON."""
    res = profile_run(label, over, config)
    cfg = load_config(config, {"data.allow_synthetic": True, **over})
    per = expected_launches(cfg, model_attn_impl(cfg), PROFILE_STEPS, 0)
    tokens = (cfg.data.input_size // cfg.vit.patch_size) ** 2 + 1
    want = {"som_partial_kernel": per["som_fused"], "som_finalize_kernel": per["som_fused"]}
    for side in ("fwd", "bwd"):
        want.update({f"attn_{side}_kernel": 0, f"attn_{side}_mma_kernel": 0})
        want.update({k: 0 for k in BF16_KERNELS if k.startswith(f"attn_{side}_")})
        for part, hd in model_head_dims(cfg):  # each block's launches, by its kernel
            part_launches = expected_launches(cfg, model_attn_impl(cfg), PROFILE_STEPS, 0, part)
            rows = attention_fused.row_kernels(tokens, hd)
            want[f"attn_{side}_{'' if rows else 'mma_'}kernel"] += part_launches[
                f"attention_{side}"]
            want[model_bf16_kernel(cfg, hd, side == "bwd")] += part_launches[
                f"attention_{side}_bf16"]
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


def model_head_dims(cfg):
    """[(part, head dim)] of a ViT model's attention blocks: the encoder's,
    and a ViT-SOM's decoder's (the same heads over dec_emb_dim)."""
    parts = [("encoder", cfg.vit.emb_dim // cfg.vit.heads)]
    if cfg.model_arch == "vit_som":
        parts.append(("decoder", cfg.vit.dec_emb_dim // cfg.vit.heads))
    return parts


# the bf16 attention kernels as the profiler names them
BF16_KERNELS = tuple(k for k in profile_step.KERNELS if k.endswith("_bf16"))


def model_bf16_kernel(cfg, hd, backward):
    """The bf16 kernel (``bf16_kernel``) a model's block at head dim ``hd``
    runs, forward or backward, over the patches and the CLS token."""
    n = (cfg.data.input_size // cfg.vit.patch_size) ** 2 + 1
    return attention_fused.bf16_kernel(n, hd, backward)


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
    """Phase 13: the emb-192 ViT-SOM at full width on the clustering of an
    augmented dataset; returns (the pallas run's launch counts (its train
    steps and its eval), phase 13b's block launch counts).

    ``configs/vit_som/vit_som_cifar-10.yaml`` at its full widths and depth
    (emb 192, depth 12, 3 heads, decoder emb 96 and depth 2, 4x4 map, SOM
    latent D = 64 x 192, batch 128, float32, no remat) on the clustering
    objective (``data.num_classes`` 0; phase D trains the yaml's
    classification as shipped): ``build_datamodule`` gives the clustering
    module (``pipeline.ClusteringDataModule``: train and test concatenated,
    C13_SIZE + its test images, the yaml's train transform on the device,
    the captured augmentation held against eager calls), once with ``xla``
    and once with ``pallas`` attention, CIFAR_STEPS steps each, graphed.
    The eval runs on a module of 4096 rows (C13_EVAL_SIZE + its test
    images) whose rows go through the train transform on the host, in
    order, from ``default_rng(0)`` (the JAX package's evaluation of a
    train-mode split), once for both runs. The pallas run's step-0 losses
    equal the xla run's within rtol 1e-5 and its launch counts the formula
    (module docstring); its reconstructions of one eval batch are finite
    and [128, 32, 32, 3]. Phase 13b (``phase_block_cifar``) runs on the xla
    run's trained model."""
    over = {"data.num_classes": 0, "data.synthetic_size": C13_SIZE}
    eval_cfg = load_config(CIFAR_CONFIG, {"data.allow_synthetic": True, "data.num_classes": 0,
                                          "data.synthetic_size": C13_EVAL_SIZE})
    eval_dm = build_datamodule(eval_cfg, dev)
    t0 = time.perf_counter()
    rows = eval_dm.images.shape[0]
    host_s = time.perf_counter() - t0
    check(isinstance(eval_dm, ClusteringDataModule) and rows == 4096 and not eval_dm.static,
          f"phase 13's eval module: {type(eval_dm).__name__} of {rows} rows")
    print(f"cifar10 clustering eval: {rows} rows through the host train transform in "
          f"{host_s:.3f} s (default_rng(0), in order)", flush=True)
    data = "synthetic 32x32x3 images, clustering split augmented on the device"
    first, launches, block_launches = None, None, None
    for impl in ("xla", "pallas"):
        label = f"cifar10_{impl}"
        cfg, dm, trainer, hist, launches = train_run(
            dev, label, impl, CIFAR_STEPS, False, config=CIFAR_CONFIG, data=data, extra=over)
        check(isinstance(dm, ClusteringDataModule) and dm.augment is not None
              and not dm.host and not dm.streams and dm.n_train == 12800,
              f"{label}: not the device-augmented clustering module ({type(dm).__name__})")
        if first is None:
            first = {k: float(hist[k][0]) for k in FIRST_LOSSES}
        else:
            check_first_losses(label, hist, first)
            hold_augmentation(dm, trainer)
        eval_batches = eval_batch_count(rows, cfg.batch_size) + 1
        reset_launches()
        trainer.model.eval()
        p, n, dt = eval_lib.evaluate_clustering(trainer.eval_step, eval_dm,
                                                trainer.current_temperature())
        trainer.model.train()
        torch.cuda.synchronize()
        eval_launches = read_launches()
        want = expected_launches(cfg, model_attn_impl(cfg), 0, eval_batches)
        print(f"{label} eval (host train transform): purity={p:.4f} nmi={n:.4f} "
              f"batches={eval_batches} (one a warm-up) inference_s={dt:.4f} launches: "
              + " ".join(f"{k}={v} (expected {want[k]})" for k, v in eval_launches.items()),
              flush=True)
        check(0.0 <= p <= 1.0 and 0.0 <= n <= 1.0, "bad purity/NMI")
        check(eval_launches == want, f"{label} eval: launch counts {eval_launches} != {want}")
        launches = {k: launches[k] + eval_launches[k] for k in launches}
        with torch.no_grad():
            _, recon_img, _, dist, _ = trainer.model(next(eval_dm.eval_batches())["image"])
        shape = (cfg.batch_size, cfg.data.input_size, cfg.data.input_size, cfg.data.num_channels)
        print(f"{label}: recon_shape={tuple(recon_img.shape)} dist_shape={tuple(dist.shape)}",
              flush=True)
        check(tuple(recon_img.shape) == shape == (128, 32, 32, 3), "bad cifar-10 recon shape")
        check(bool(torch.isfinite(recon_img).all()), "non-finite cifar-10 reconstruction")
        if impl == "xla":
            t1 = time.perf_counter()
            block_launches = phase_block_cifar(dev, trainer, eval_dm)
            print(f"phase 13b (block_cifar): {time.perf_counter() - t1:.1f} s", flush=True)
        del trainer, dm
    return launches, block_launches


# ---------------------------------------------------------------------------
# phase M: data parallelism (parallel/), a one-rank NCCL group here, two
# gloo ranks on the one card as child processes
# ---------------------------------------------------------------------------


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def phase_dp_nccl(dev, p7, smi):
    """M1: the flagship ``pallas`` run of phase 7 again (TRAIN_STEPS steps
    graphed, the clustering eval) inside a one-rank NCCL group made in
    this process: the data-parallel path (the fused SOM's loss, the
    gradients and the metrics' losses all-reduced), its all-reduces
    captured with the step. Its losses and every tensor of its state
    (parameters, AdamW moments, step counts, lr tensors, device step,
    metrics rows) must equal phase 7's bitwise; its graphed step ms is
    printed beside phase 7's. Returns its launch counts."""
    import torch.distributed as dist

    torch.cuda.set_device(0)
    dist.init_process_group("nccl", init_method=f"tcp://127.0.0.1:{free_port()}",
                            world_size=1, rank=0)
    try:
        check(dist_lib.initialized() and dist_lib.capturable() and dist_lib.process_count() == 1,
              "M1: no one-rank NCCL group")
        cfg, _, tr, hist, launches = train_run(dev, "m1_dp_nccl_pallas", "pallas", TRAIN_STEPS,
                                               True)
        check(tr.graph is not None and tr.world == 1, "M1: the data-parallel step was not captured")
        for k in FIRST_LOSSES:
            check(np.array_equal(hist[k], p7["hist"][k]),
                  f"M1: {k} differs from phase 7's non-data-parallel run")
        same_state("m1 dp (one-rank NCCL group) vs phase 7", snapshot(tr), p7["state"])
        ms = steady_ms(tr.step_ms)
        print(f"m1: graphed step with the all-reduces captured median_step_ms={ms:.4f} "
              f"({steady_steps(tr.step)}) against phase 7's non-data-parallel "
              f"{p7['step_ms']:.4f} card: {smi}", flush=True)
        del tr
        gc.collect()
    finally:
        dist.destroy_process_group()
    check(not dist_lib.initialized(), "M1: the group outlived the phase")
    return launches


def m2_rank(spec_path: str) -> int:
    """One rank of M2 (a child process: torchrun's environment, rank
    ``RANK`` of M2_WORLD on ``cuda:0``): joins a gloo group, trains the
    flagship with ``pallas`` for M2_STEPS steps (eagerly: a gloo collective
    cannot be captured; the launches counted and held to the formula), runs
    the sharded clustering eval, k-means on the SOM latents and
    ``validation_metrics``, and writes its final parameters and numbers
    into the spec's directory."""
    import torch.distributed as dist

    with open(spec_path) as f:
        spec = json.load(f)
    dev = resolve_device("cuda:0")
    torch.cuda.set_device(dev)
    dist.init_process_group("gloo", init_method="env://")
    rank = dist.get_rank()
    cfg = load_config(CONFIG, spec["overrides"])
    tr = Trainer(cfg, device=dev)
    check(tr.world == M2_WORLD and not dist_lib.capturable() and tr.dm.batch == 64,
          f"rank {rank}: world {tr.world}, local batch {tr.dm.batch}")
    reset_launches()
    hist = tr.fit(max_steps=M2_STEPS)
    torch.cuda.synchronize()
    launches = read_launches()
    want = expected_launches(cfg, model_attn_impl(cfg), M2_STEPS, 0)
    check(launches == want, f"rank {rank}: launch counts {launches} != {want}")
    check(tr.graph is None, f"rank {rank}: a gloo step was captured")
    res = tr.evaluate()
    temp = tr.current_temperature()
    tr.model.eval()

    @torch.no_grad()
    def latent_step(batch, temperature=None):
        return {"latent": tr.model.get_latent_representation(batch["image"])}

    km = eval_lib.evaluate_kmeans(latent_step, tr.dm, temperature=temp)
    vm = eval_lib.validation_metrics(tr.eval_step, tr.dm, "train", temp)
    torch.save({k: v.detach().cpu() for k, v in tr.model.state_dict().items()},
               os.path.join(spec["out"], f"rank{rank}.pt"))
    with open(os.path.join(spec["out"], f"rank{rank}.json"), "w") as f:
        json.dump({"purity": res["purity"], "nmi": res["nmi"], "kmeans": [km[0], km[1]],
                   "val": vm, "launches": launches, "step_ms": tr.step_ms,
                   "total_loss": hist["train/total_loss"].tolist(),
                   "gloo_cuda": bool(next(tr.model.parameters()).is_cuda)}, f)
    dist.barrier()
    dist.destroy_process_group()
    print(f"m2 rank {rank}: done", flush=True)
    return 0


def phase_dp_gloo(dev, smi):
    """M2: two gloo ranks on the one card, child processes (m2_rank), the
    flagship at full width with ``pallas`` for M2_STEPS steps and the
    sharded eval; the collectives take the CUDA tensors as they are. The
    two ranks' final parameters are equal to each other and held against
    a one-rank run of the same seed and steps here (eager, no group) at the
    JAX data-parallel test's tolerance (DP_ATOL, DP_RTOL); purity, NMI,
    k-means and the validation metrics equal on both ranks. A rank that
    fails prints its output and the phase fails. Returns rank 0's launch
    counts."""
    over = {"data.allow_synthetic": True, "data.synthetic_size": SYNTHETIC_SIZE,
            "train.attn_impl": "pallas"}
    _, _, ref, ref_hist, _ = train_run(dev, "m2_one_rank", "pallas", M2_STEPS, False,
                                       eager=True, falls=False)
    ref_state = {k: v.detach().cpu() for k, v in ref.model.state_dict().items()}
    del ref
    out = tempfile.mkdtemp(prefix="smoke_m2_")
    spec = {"out": out, "overrides": {**over, "train.mesh_shape": [M2_WORLD],
                                      "train.checkpoint_dir": os.path.join(out, "states"),
                                      "train.log_dir": os.path.join(out, "logs")}}
    spec_path = os.path.join(out, "spec.json")
    with open(spec_path, "w") as f:
        json.dump(spec, f)
    port = free_port()
    code = "import sys, chip_smoke\nsys.exit(chip_smoke.m2_rank(sys.argv[1]))"
    procs = []
    t0 = time.perf_counter()
    try:
        for rank in range(M2_WORLD):
            env = {**os.environ, "RANK": str(rank), "WORLD_SIZE": str(M2_WORLD),
                   "LOCAL_RANK": "0", "MASTER_ADDR": "127.0.0.1", "MASTER_PORT": str(port)}
            procs.append(subprocess.Popen([sys.executable, "-c", code, spec_path], cwd=ROOT,
                                          env=env, stdout=subprocess.PIPE,
                                          stderr=subprocess.STDOUT, text=True,
                                          start_new_session=True))
        logs = [proc.communicate(timeout=600)[0] for proc in procs]
    finally:
        for proc in procs:
            end_session(proc)
    wall = time.perf_counter() - t0
    for rank, (proc, log) in enumerate(zip(procs, logs)):
        if proc.returncode != 0:
            print(f"m2 rank {rank} output:\n{log[-8000:]}", flush=True)
        check(proc.returncode == 0, f"M2: rank {rank} exited {proc.returncode}")
    res = []
    for rank in range(M2_WORLD):
        with open(os.path.join(out, f"rank{rank}.json")) as f:
            res.append(json.load(f))
    states = [torch.load(os.path.join(out, f"rank{r}.pt"), weights_only=True)
              for r in range(M2_WORLD)]
    check(all(torch.equal(states[0][k], states[1][k]) for k in states[0]),
          "M2: the ranks' parameters differ")
    worst, name = 0.0, ""
    for k, v in ref_state.items():
        d = (states[0][k] - v).abs()
        excess = float((d - DP_ATOL - DP_RTOL * v.abs()).max())
        if float(d.max()) >= worst:
            worst, name = float(d.max()), k
        check(excess <= 0.0, f"M2: {k} differs from the one-rank run by {float(d.max()):.3e}")
    loss_diff = max(abs(a - b) for a, b in zip(res[0]["total_loss"], ref_hist["train/total_loss"]))
    for key in ("purity", "nmi", "kmeans", "val"):
        check(res[0][key] == res[1][key], f"M2: {key} differs between the ranks")
    ms = statistics.median(res[0]["step_ms"])
    print(f"m2: {M2_WORLD} gloo ranks on one card (collectives on CUDA tensors: "
          f"{res[0]['gloo_cuda']}), {M2_STEPS} eager steps, local batch 64: final parameters "
          f"against the one-rank run max_abs_diff={worst:.3e} ({name}) within atol {DP_ATOL} "
          f"rtol {DP_RTOL}; total_loss max_abs_diff={loss_diff:.3e}; purity={res[0]['purity']:.4f} "
          f"nmi={res[0]['nmi']:.4f} kmeans={res[0]['kmeans']} val={res[0]['val']} equal on both "
          f"ranks; rank 0 median_step_ms={ms:.4f} (eager, gloo through the host) wall_s={wall:.1f} "
          f"card: {smi}", flush=True)
    return res[0]["launches"]


def cls_run(dev, label, config, impl, steps, dm=None, eager=False, evaluate=True,
            size=CLS_SYNTHETIC_SIZE, extra=None):
    """Trains ``config`` as shipped (classification, augmentation on the
    device, or the static path's train rows transformed once) with
    attention ``impl`` (None: as shipped) on ``size`` synthetic images
    (``dm``, or a new classification data module) for ``steps`` steps
    (None: one epoch), graphed or ``eager``; a finished epoch validates,
    and ``evaluate`` runs the test eval (one warm-up batch, then every
    batch). ``extra``: more overrides. Prints and checks what phase D
    checks of every run. Returns (cfg, dm, trainer, hist, launches, test
    metrics or None)."""
    over = {"data.allow_synthetic": True, "data.synthetic_size": size, **(extra or {})}
    if impl is not None:
        over["train.attn_impl"] = impl
    cfg = load_config(config, over)
    aug = cfg.data.augment
    print(
        f"{label}: config {os.path.basename(config)} {describe(cfg)} batch={cfg.batch_size} "
        f"num_classes={cfg.data.num_classes} input={cfg.data.input_size}x"
        f"{cfg.data.input_size}x{cfg.data.num_channels} "
        f"smoothing={cfg.optimizer.smoothing} use_pallas_som={cfg.train.use_pallas_som} "
        f"compute={cfg.train.compute_dtype} attn_impl={model_attn_impl(cfg)} augment=(randaug_n={aug.randaug_n} "
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
    augmentation in 16-image chunks) on 640 + 128 images: one graphed
    epoch of E_STEPS steps, validation and the test eval, and the captured 224
    augmentation against its eager calls. E3: ``vit_som_svhn.yaml`` (emb
    16, patch 2: the row kernels at N 257; a 40x40 map) likewise.
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
        if attention_fused.row_kernels(n, hd):
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
        tensor = not attention_fused.row_kernels(n, hd)
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
    plain versions, by design ({"block_fwd": ..., "block_fwd_streamed": ...,
    ...})."""
    worst = {f"block_{side}{suffix}": 0.0 for side in ("fwd", "bwd")
             for suffix in ("", "_streamed")}
    for shape in BLOCK_SHAPES:
        b, n, d, h, ratio = shape
        m = int(d * ratio)
        plans = {side: block_fused.block_plan(b, n, d, h, m, side == "bwd")
                 for side in ("fwd", "bwd")}
        t0 = time.perf_counter()
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
        # each output against the plain version and eager autograd at the
        # plain tolerances. Two float32 evaluations of a long sum of large
        # terms can differ by more than these: at (2, 1025, 192, 3) fc1's
        # and fc2's weight gradients sum 2050 rows of O(1) terms, and the
        # kernel misses the plain version by more than atol 2e-5 where the
        # gradient is near 0 while half the plain's distance from float64.
        # An output that misses a float32 yardstick passes only within the
        # same tolerances of the float64 evaluation and no further from it
        # than the yardstick
        held_f64 = []

        def against(fn, key, a, ref, exact):
            err, ok = fn(a, ref)
            if ok:
                return err, ok
            held_f64.append(key)
            closer = (float((a.double() - exact).abs().max())
                      <= float((ref.double() - exact).abs().max()))
            return err, fn(a, exact)[1] and closer

        def y_err(a, b):
            return allclose_err(a, b, *BLOCK_Y_TOL)

        errs = {"y": against(y_err, "y", y, yr, y64),
                "y_vs_eager": against(y_err, "y_vs_eager", y, ye.detach(), y64),
                "dx": against(grad_err, "dx", dx, dxr, dx64),
                "dx_vs_autograd": against(grad_err, "dx_vs_autograd", dx, xl.grad, dx64)}
        rel = 0.0
        for name in block_fused.WEIGHT_NAMES:
            errs[name] = against(grad_err, name, dw[name], dwr[name], dw64[name])
            errs[name + "_vs_autograd"] = against(grad_err, name + "_vs_autograd", dw[name],
                                                  dwa[name], dw64[name])
            rel = max(rel, errs[name][0] / float(dwr[name].abs().max()))
        same = (torch.equal(y, y2) and torch.equal(dx, dx2)
                and all(torch.equal(dw[k], dw2[k]) for k in dw))
        wname = max(block_fused.WEIGHT_NAMES, key=lambda k: errs[k][0])
        aname = max(block_fused.WEIGHT_NAMES, key=lambda k: errs[k + "_vs_autograd"][0])
        print(
            f"block_vs_plain (B,N,D,H,mlp)={shape} design fwd={plans['fwd']} "
            f"bwd={plans['bwd']} dy_std={float(dy.std()):.4f}: "
            f"y_max_abs_err={errs['y'][0]:.3e} y_vs_eager={errs['y_vs_eager'][0]:.3e} "
            f"dx={errs['dx'][0]:.3e} dx_vs_autograd={errs['dx_vs_autograd'][0]:.3e} "
            f"weight_grads: worst={errs[wname][0]:.3e} ({wname}) "
            f"worst_vs_autograd={errs[aname + '_vs_autograd'][0]:.3e} ({aname}) "
            f"rel_to_max={rel:.3e} "
            f"max_abs_grad={max(float(g.abs().max()) for g in dwr.values()):.3e} "
            f"deterministic={same} seconds={time.perf_counter() - t0:.2f}"
            + (f" held_against_float64={','.join(held_f64)} (off their float32 yardstick: "
               f"within the tolerance of float64 and closer to it)" if held_f64 else ""),
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
            side = "fwd" if k in ("y", "y_vs_eager") else "bwd"
            key = f"block_{side}{'_streamed' if plans[side] == 'streamed' else ''}"
            if not k.endswith("_vs_autograd") and k != "y_vs_eager":
                worst[key] = max(worst[key], e)
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
    want = {"som_fused": 0, "attention_fwd": 0, "attention_bwd": 0, "attention_fwd_bf16": 0,
            "attention_bwd_bf16": 0, "block_fwd": len(blocks) + 2, "block_bwd": 2,
            "block_fwd_streamed": 0, "block_bwd_streamed": 0}
    print("block_flagship launches: "
          + " ".join(f"{k}={v} (expected {want[k]})" for k, v in launches.items()), flush=True)
    check(launches == want, f"block launch counts {launches} != {want}")
    return launches


def phase_block_cifar(dev, trainer, dm):
    """Phase 13b, beside 11 on the emb-192 path: the fused block on
    ``vit_som_cifar-10.yaml``'s own activations at full width (12 encoder
    blocks of D 192, 3 heads, M 768 and 2 decoder blocks of D 96, 3 heads, M
    384, N 65, B 128), every block's input captured on an eval batch of
    phase 13's ``xla`` trainer: all 14 through ``make_fused_block`` against
    the eager blocks, the backward of blocks 0 and 12 against autograd,
    every call on the design ``block_plan`` names (the streamed one at these
    shapes). Returns the launch counts of that run."""
    vit = trainer.model.vit
    blocks = list(vit.blocks) + list(vit.decoder_blocks)
    captured = []
    hooks = [blk.register_forward_pre_hook(lambda mod, args: captured.append(args[0].detach().clone()))
             for blk in blocks]
    with torch.no_grad():
        vit(next(dm.eval_batches())["image"])
    for hook in hooks:
        hook.remove()
    check(len(captured) == len(blocks) == 14, f"captured {len(captured)} block inputs, not 14")

    def fused_for(blk, x):
        ratio = blk.mlp.fc1.out_features / blk.attn.dim
        return block_fused.make_fused_block(blk.attn.dim, blk.attn.num_heads, ratio, x.shape[1])

    def design(blk, x, backward):
        return block_fused.block_plan(x.shape[0], x.shape[1], blk.attn.dim, blk.attn.num_heads,
                                      blk.mlp.fc1.out_features, backward)

    want = dict.fromkeys(read_launches(), 0)
    reset_launches()
    for idx, (blk, x) in enumerate(zip(blocks, captured)):
        with torch.no_grad():
            y = fused_for(blk, x)(x, block_weights(blk))
            ye = blk(x)
        torch.cuda.synchronize()
        err, ok = allclose_err(y, ye, *BLOCK_Y_TOL)
        kind = "encoder" if idx < len(vit.blocks) else "decoder"
        plan = design(blk, x, False)
        want["block_fwd_streamed" if plan == "streamed" else "block_fwd"] += 1
        print(f"block_cifar {kind} block {idx} x={tuple(x.shape)} D={blk.attn.dim} "
              f"heads={blk.attn.num_heads} M={blk.mlp.fc1.out_features} design={plan} "
              f"|x|max={float(x.abs().max()):.3f}: y_vs_eager max_abs_err={err:.3e}", flush=True)
        check(ok, f"cifar fused block {idx} disagrees with the eager block: {err}")
    for idx in (0, len(vit.blocks)):
        blk, x = blocks[idx], captured[idx]
        g = torch.Generator(device=dev).manual_seed(8100 + idx)
        cot = torch.randn(x.shape, generator=g, device=dev) / x.shape[0]
        blk.zero_grad(set_to_none=True)
        xf = x.clone().requires_grad_()
        fused_for(blk, x)(xf, block_weights(blk)).backward(cot)
        for backward in (False, True):
            plan = design(blk, x, backward)
            side = "bwd" if backward else "fwd"
            want[f"block_{side}_streamed" if plan == "streamed" else f"block_{side}"] += 1
        # the gradients in the fused layout, as phase 10 holds them: at emb
        # 192 the Block keeps q, k, v apart, and the key bias's gradient is
        # exactly 0 (softmax takes no shift of every key), float32 noise in
        # any evaluation, which no bound relative to its own largest value
        # can hold; in qkv_bias it sits beside the query's and value's
        fused = block_param_grads(blk)
        blk.zero_grad(set_to_none=True)
        xe = x.clone().requires_grad_()
        blk(xe).backward(cot)
        torch.cuda.synchronize()
        eager = block_param_grads(blk)
        errs = {"dx": grad_err(xf.grad, xe.grad)}
        errs.update({name: grad_err(fused[name], eager[name]) for name in block_fused.WEIGHT_NAMES})
        blk.zero_grad(set_to_none=True)
        wname = max(errs, key=lambda k: errs[k][0])
        print(f"block_cifar grads block {idx} design={design(blk, x, True)}: "
              f"dx_max_abs_err={errs['dx'][0]:.3e} worst={errs[wname][0]:.3e} ({wname}) "
              f"weights={len(errs) - 1} (fused layout)", flush=True)
        for k, (e, ok) in errs.items():
            check(ok, f"cifar fused block {idx} gradient {k} disagrees with autograd: {e}")
    launches = read_launches()
    print("block_cifar launches: "
          + " ".join(f"{k}={v} (expected {want[k]})" for k, v in launches.items()), flush=True)
    check(launches == want, f"cifar block launch counts {launches} != {want}")
    check(want["block_fwd_streamed"] == 16 and want["block_bwd_streamed"] == 2,
          f"the cifar blocks did not all run the streamed design: {want}")
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
            backward = name == "block_bwd"
            design = block_fused.block_plan(b, n, d, h, m, backward)
            if design == "resident":
                threads = block_fused.fwd_threads(n) if not backward else block_fused.bwd_threads(n)
                launch = (f"ctas={b} threads={threads} "
                          f"smem_bytes={block_fused.smem_bytes(n, d, h, m, backward)}")
            else:
                ctas, per_sm, n_sm = block_fused.streamed_grid(backward)
                launch = (f"ctas={ctas} ({per_sm} an SM x {n_sm} SMs, persistent) "
                          f"threads={block_fused.STREAMED_THREADS} workspace_bytes="
                          f"{block_fused.workspace_bytes(b, n, d, h, m, backward)}")
            print(
                f"timing {name} {design} (B,N,D,H,M)={(b, n, d, h, m)} (L2 flushed): "
                f"kernel_ms={t['kernel']:.5f} plain_ms={t['plain']:.5f} "
                f"eager_block_xla_ms={t['eager_xla']:.5f} eager_block_pallas_ms={t['eager_pallas']:.5f} "
                f"(eager Block {eager}) bound_ms={bound_ms:.5f} ({detail}: {flops / 1e6:.1f} MFLOP "
                f"as 3xTF32 {t_ops:.5f} ms, {nbytes / 1e6:.3f} MB {t_bytes:.5f} ms; "
                f"fp32_non_tensor_ms={t_fp32:.5f}; exp needed={n_exp / 1e6:.3f} M at {sms} SMs x "
                f"{SFU_EXP_PER_CLOCK} a clock x {SM_CLOCK_HZ / 1e9:.2f} GHz {t_exp:.5f} ms) "
                f"kernel_share_of_bound={bound_ms / t['kernel']:.4f} {launch}",
                flush=True,
            )
            rows[(shape, name)] = dict(ms=t["kernel"], plain_ms=t["plain"],
                                       library_ms=t["eager_xla"], bound_ms=bound_ms,
                                       bound_by=bound_by)
    return rows


def sass_tensor_ops(cuobjdump, path):
    """{function: {instruction: count}} of the HGMMA and HMMA instructions
    in a built library's SASS (``cuobjdump -sass``)."""
    sass = subprocess.run([cuobjdump, "-sass", path], capture_output=True, text=True,
                          check=True).stdout
    ops, function = {}, None
    for line in sass.splitlines():
        if "Function :" in line:
            function = line.split("Function :", 1)[1].strip()
            ops[function] = {}
        for word in line.replace(";", " ").split():
            if function and word.startswith(("HGMMA", "HMMA")):
                ops[function][word] = ops[function].get(word, 0) + 1
    return ops


def phase_build():
    """Phase 2: one nvcc per source, all started together, each source's
    SASS read (cuobjdump, ~7 s for attention_bf16's) as soon as it is
    built."""
    cuobjdump = os.path.join(os.path.dirname(_build._nvcc()), "cuobjdump")
    check(os.path.isfile(cuobjdump), f"no cuobjdump beside nvcc to inspect the SASS: {cuobjdump}")

    def build(name):
        info = _build.build(name)
        return info, sass_tensor_ops(cuobjdump, info["path"])

    t0 = time.perf_counter()
    with ThreadPoolExecutor(len(KERNEL_SOURCES)) as pool:
        built = dict(zip(KERNEL_SOURCES, pool.map(build, KERNEL_SOURCES)))
    infos = {name: info for name, (info, _) in built.items()}
    tensor_ops = {name: ops for name, (_, ops) in built.items()}  # {source: {function: ops}}
    print(f"build: {time.perf_counter() - t0:.2f} s for "
          + ", ".join(f"{name}.cu ({info['seconds']:.2f} s)" for name, info in infos.items())
          + " (the SASS read included)", flush=True)
    for name, info in infos.items():
        for line in info["log"].splitlines():
            if any(w in line for w in ("entry function", "registers", "spill")) or (
                    "error" in line.lower()):
                print(f"build[{name}]: {line.strip()}", flush=True)
    # the SOM kernel's, the hd >= 25 attention kernels' and every block
    # kernel instantiation's products must run on the tensor cores in TF32
    # (wgmma: HGMMA; mma.sync: HMMA in SASS), the bf16 attention kernels'
    # in bf16, on wgmma from hd 17 up and on mma.sync below
    for name, kernels, kinds, dtype in (
            ("som_fused", ("som_partial_kernel",), ("HGMMA",), "TF32"),
            ("attention", ("attn_fwd_mma_kernel", "attn_bwd_mma_kernel"), ("HMMA", "HGMMA"),
             "TF32"),
            ("attention_bf16", ("attn_fwd_mma_bf16", "attn_fwd_mma2_bf16", "attn_bwd_mma_bf16"),
             ("HGMMA",), "BF16"),
            ("attention_bf16", ("attn_fwd_hmma_bf16", "attn_fwd_hmma2_bf16", "attn_bwd_hmma_bf16"),
             ("HMMA",), "BF16"),
            ("block", ("block_fwd_kernel", "block_bwd_kernel"), ("HMMA",), "TF32"),
            ("block_streamed", ("block_fwd_streamed", "block_bwd_streamed"), ("HMMA",),
             "TF32")):
        ops = tensor_ops[name]
        for kernel in kernels:
            found = {f: c for f, c in ops.items() if kernel in f}
            check(found, f"{name}.cu: no {kernel} in the SASS")
            for function, counts in found.items():
                print(f"build[{name}]: tensor-core instructions of {function}: {counts}", flush=True)
                check(any(op.startswith(kinds) and dtype in op for op in counts),
                      f"{function} has no {dtype} {'/'.join(kinds)} in its SASS")


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
    return d, launches, probes[-1], results[-1]


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
    return launches, tr, res


def phase_protocol(dev, smi, clock):
    """Phases G and J (J restores G's checkpoints, in G's temporary
    directory); returns {path: launch counts} of G2, G4 and J1-J4."""
    with tempfile.TemporaryDirectory() as root:
        phase_readers(root)
        d, flagship, g2_trainer, g2_res = phase_protocol_flagship(dev, root, smi)
        phase_restore_captured(dev, d, root)
        cifar, g4_trainer, g4_res = phase_protocol_cifar(dev, root, smi)
        clock("J")
        j_paths = phase_eval(dev, root, d, g2_trainer, g2_res, g4_trainer, g4_res, smi)
        del g2_trainer, g4_trainer
        release_trainers(dev)
    return {"protocol_flagship": flagship, "protocol_cifar10_pallas": cifar, **j_paths}


def release_trainers(dev):
    """Drops the trainers the probes keep (G4's, J's last), collects them
    and returns their cached blocks to the card, so the later phases'
    captures find the memory an earlier smoke left them; prints what was
    held before and after."""
    before = torch.cuda.memory_allocated(dev), torch.cuda.memory_reserved(dev)
    ProtocolProbe.instances, EvalProbe.last = [], None
    gc.collect()
    torch.cuda.empty_cache()
    after = torch.cuda.memory_allocated(dev), torch.cuda.memory_reserved(dev)
    print(f"after G and J: allocated {before[0] / 1e9:.3f} GB, reserved {before[1] / 1e9:.3f} GB; "
          f"with the probes' trainers released: allocated {after[0] / 1e9:.3f} GB, reserved "
          f"{after[1] / 1e9:.3f} GB", flush=True)


# ---------------------------------------------------------------------------
# phase J: checkpoint evaluation (eval_checkpoint: QE / TE, k-means, the
# figures) on phase G's checkpoints
# ---------------------------------------------------------------------------

J_TIE = 1e-5  # the kernel's distances' tolerance: the margin of a near tie
J_DECODE_SHAPE = (1600, 197, 2, 2)  # the decoder's attention over 1600 prototypes


class EvalProbe(Trainer):
    """The trainer ``eval_checkpoint.main`` builds, kept for the holds."""

    last = None

    def __init__(self, *args, **kw):
        super().__init__(*args, **kw)
        EvalProbe.last = self


def run_eval(label, argv):
    """``eval_checkpoint.main(argv)`` with its trainer kept; returns (the
    results, the trainer, the launch counts, the host seconds)."""
    print(f"{label}: python -m vitsom_tpu_torch.eval.eval_checkpoint " + " ".join(argv),
          flush=True)
    eval_checkpoint.Trainer = EvalProbe
    try:
        reset_launches()
        t0 = time.perf_counter()
        res = eval_checkpoint.main(argv)
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        launches = read_launches()
    finally:
        eval_checkpoint.Trainer = Trainer
    print(f"{label}: {seconds:.3f} s, results " + json.dumps(res), flush=True)
    return res, EvalProbe.last, launches, seconds


def check_launches(label, launches, want, why):
    print(f"{label} launches: " + " ".join(f"{k}={v} (expected {want[k]})"
                                           for k, v in launches.items()) + f" [{why}]", flush=True)
    check(launches == want, f"{label}: launch counts {launches} != {want}")


def cuda_ms(fn):
    """(fn's result, the host ms it took, ending in a synchronize)."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, (time.perf_counter() - t0) * 1e3


def top3_gaps(dist):
    """Per row, the smallest gap among its three smallest distances."""
    top3 = torch.topk(dist, 3, dim=1, largest=False).values
    return torch.minimum(top3[:, 1] - top3[:, 0], top3[:, 2] - top3[:, 1])


def hold_qe_te(label, tr, res):
    """QE from the kernel's distances against the plain distances of the
    same latents; TE row by row, differing only on near ties."""
    cfg = tr.cfg
    n = min(eval_checkpoint.kept_rows(tr), eval_checkpoint.DISTANCE_SAMPLES)
    t = tr.current_temperature()
    kernel = eval_checkpoint.distances(tr, n, t)
    with torch.no_grad():
        z = eval_checkpoint.latents(tr, n)
        plain = som.compute_distances(z, tr.model.prototypes, cfg.som.distance_fcn)
    err, ok = allclose_err(kernel, plain, TOL, TOL)
    qe_plain = metrics.quantization_error(plain)
    pos = torch.from_numpy(som.grid_positions(tuple(cfg.som.map_size), cfg.som.topology)).to(
        kernel.device)
    thresh = 2.0 + 1e-6 if cfg.som.topology == "square" else 1.0 + 1e-6

    def far(d):
        o = torch.topk(d, 2, dim=1, largest=False).indices
        return ((pos[o[:, 0]] - pos[o[:, 1]]) ** 2).sum(dim=1) > thresh

    differ = far(kernel) != far(plain)
    ties = top3_gaps(plain) <= J_TIE
    te_plain = metrics.topographic_error(plain, cfg.som.map_size, cfg.som.topology)
    print(f"{label}: distances of {n} rows, kernel vs plain max|diff|={err:.3e} (atol/rtol "
          f"{TOL}) ok={ok}; QE kernel={res['quantization_error']:.8f} plain={qe_plain:.8f}; "
          f"TE kernel={res['topographic_error']:.6f} plain={te_plain:.6f}; rows whose TE term "
          f"differs {int(differ.sum())}, all near ties (three smallest within {J_TIE}): "
          f"{bool((~differ | ties).all())} (near-tie rows {int(ties.sum())})", flush=True)
    check(ok, f"{label}: the kernel's distances differ from the plain ones")
    check(abs(res["quantization_error"] - qe_plain) <= TOL * abs(qe_plain),
          f"{label}: QE {res['quantization_error']} != plain {qe_plain}")
    check(bool((~differ | ties).all()), f"{label}: a TE term differs outside a near tie")
    check(abs(res["topographic_error"] - te_plain) <= int(differ.sum()) / n + 1e-12,
          f"{label}: TE {res['topographic_error']} != plain {te_plain}")


def hold_knn_umap(label, tr):
    """The blocked kNN of the projection's latents against a float64 kNN;
    two UMAP layouts from one seed bitwise; the kNN and layout ms."""
    n = min(eval_checkpoint.kept_rows(tr), eval_checkpoint.LATENT_SAMPLES)
    lat = eval_checkpoint.latents(tr, n)
    k = 15
    (idx, dist), knn_ms = cuda_ms(lambda: umap._knn_cosine(lat, k))
    x = lat.double()
    xn = x / x.norm(dim=1, keepdim=True).clamp_min(1e-12)
    full = 1.0 - xn @ xn.T
    full.fill_diagonal_(math.inf)
    ref = torch.topk(full, k + 1, dim=1, largest=False)
    ref_idx, ref_d = ref.indices[:, :k].cpu().numpy(), ref.values.cpu().numpy()
    boundary = (ref_d[:, k] - ref_d[:, k - 1]) <= J_TIE
    same = np.array([set(a) == set(b) for a, b in zip(idx, ref_idx)])
    d_err = float(np.abs(np.sort(dist, 1) - ref_d[:, :k]).max())
    print(f"{label}: kNN of {n} latents (D {lat.shape[1]}, k {k}) in {knn_ms:.3f} ms; "
          f"neighbour sets equal to float64's on {int(same.sum())} rows, the rest "
          f"{int((~same).sum())} all near ties at the 15th/16th ({bool((same | boundary).all())}); "
          f"distances max|diff| {d_err:.3e}", flush=True)
    check(bool((same | boundary).all()), f"{label}: kNN sets differ outside a near tie")
    check(d_err <= J_TIE, f"{label}: kNN distances off by {d_err}")
    inputs, prep_ms = cuda_ms(lambda: umap.layout_inputs(lat, seed=0))
    a, layout_ms = cuda_ms(lambda: umap._optimize_layout(**inputs))
    b, embed_ms = cuda_ms(lambda: umap.umap_embed(lat, seed=0))
    same_layout = np.array_equal(a, b)
    print(f"{label}: UMAP of {n} latents: graph + PCA {prep_ms:.1f} ms, layout "
          f"({inputs['n_epochs']} epochs, {len(inputs['heads'])} edges) {layout_ms:.1f} ms, "
          f"umap_embed {embed_ms:.1f} ms; two layouts from seed 0 bitwise_equal={same_layout}, "
          f"finite={bool(np.isfinite(a).all())}", flush=True)
    check(same_layout and np.isfinite(a).all(), f"{label}: the UMAP layout is not deterministic")


def print_figures(label, figdir):
    if importlib.util.find_spec("matplotlib") is None:
        print(f"{label}: matplotlib is not installed on this machine: no figure was drawn "
              f"(eval_checkpoint said which; their numbers are held above)", flush=True)
        return
    files = sorted(os.listdir(figdir))
    print(f"{label}: figures " + ", ".join(
        f"{f} {os.path.getsize(os.path.join(figdir, f))} bytes" for f in files), flush=True)
    check(len(files) == 3 and all(os.path.getsize(os.path.join(figdir, f)) > 1000
                                  for f in files), f"{label}: figures {files}")


def float64_decode(model):
    """The prototypes decoded by a float64 copy of ``model`` (every compute
    dtype float64; the output rounded to float32 as the decoder returns
    it), on its device, as float64."""
    m = copy.deepcopy(model).double()
    for mod in m.modules():
        if hasattr(mod, "compute_dtype"):
            mod.compute_dtype = torch.float64
    with torch.no_grad():
        return m.decode_prototypes(m.prototypes).double()


def decode_err(decoded, exact):
    """(max |decoded - exact|, max |exact|)."""
    return float((decoded.double() - exact).abs().max()), float(exact.abs().max())


def phase_eval_flagship(dev, root, g2_trainer, g2_res, smi):
    """J1: ``eval_checkpoint`` on G2's last run's ``last`` checkpoint
    (``vit_som_mnist.yaml`` as shipped, ``xla``, 60000 + 10000 IDX images).
    Its SOM kernel launches: the clustering eval's warm-up batch and its
    546 batches, the BMU pass's 546 and the distance pass's 64 (8192 rows).
    Returns (the trainer, its xla decode, the float64 decode, the launch
    counts)."""
    figdir = os.path.join(root, "j1_figures")
    res, tr, launches, _ = run_eval("J1", ["--checkpoint", g2_trainer.checkpoint_dir("last"),
                                           "--figures-dir", figdir])
    cfg, bs = tr.cfg, tr.cfg.batch_size
    n_keep = eval_checkpoint.kept_rows(tr)
    evals = eval_batch_count(tr.dm.n_train, bs) + 1
    passes = n_keep // bs + math.ceil(min(n_keep, eval_checkpoint.DISTANCE_SAMPLES) / bs)
    want = expected_launches(cfg, model_attn_impl(cfg), 0, evals + passes)
    check_launches("J1", launches, want, f"{evals} eval batches (1 warm-up) + "
                   f"{n_keep // bs} BMU batches + {passes - n_keep // bs} distance batches")
    same = all(res[k] == g2_res[k] for k in ("purity", "nmi"))
    print(f"J1: purity={res['purity']:.6f} nmi={res['nmi']:.6f}, G2's restored eval "
          f"purity={g2_res['purity']:.6f} nmi={g2_res['nmi']:.6f} equal={same} {smi}", flush=True)
    check(same, "J1: the checkpoint evaluates otherwise than G2's restored state")
    hold_qe_te("J1", tr, res)
    hold_knn_umap("J1", tr)
    decoded, decode_ms = cuda_ms(lambda: viz.decoded_prototypes(tr.model, cfg))
    cpu_model = copy.deepcopy(tr.model).cpu()
    with torch.no_grad():
        on_host = cpu_model.decode_prototypes(cpu_model.prototypes)
    err, ok = allclose_err(decoded.cpu(), on_host, TOL, TOL)
    exact = float64_decode(tr.model)
    xerr, scale = decode_err(decoded, exact)
    herr, _ = decode_err(on_host.to(dev), exact)
    print(f"J1: decoded prototypes {tuple(decoded.shape)} in one call, {decode_ms:.3f} ms; "
          f"against the plain decode on the host max|diff|={err:.3e} (atol/rtol {TOL}) ok={ok}; "
          f"max|value| {scale:.4f}, float64 errors: card {xerr:.3e}, host {herr:.3e}",
          flush=True)
    check(tuple(decoded.shape) == (1600, 28, 28, 1) and ok, "J1: the decoded prototypes differ")
    print_figures("J1", figdir)
    return tr, decoded, exact, launches


def phase_eval_decode_pallas(dev, tr, decoded_xla, exact):
    """J2: the decoder's attention kernel at the prototype batch: the 1600
    prototypes decoded with ``train.attn_impl: pallas`` (2 forward launches,
    one a decoder block): each launch's o against the plain version on
    the same q, k, v at 1e-5 and against float64 within F64_FACTOR of the
    plain version's error plus F64_SLACK; the decode's distance to J1's
    ``xla`` decode and to the float64 decode printed (J1's own float32
    decode is 4e-5 from float64 there, so 1e-5 between two float32 decodes
    cannot hold); the kernel against its plain version at (1600, 197, 2,
    2) on random strided inputs, timed. Returns (the launch
    counts, the timing row, the kernel's error)."""
    from vitsom_tpu_torch.config import apply_overrides
    from vitsom_tpu_torch.models.vit_som import build_model

    cfg = apply_overrides(tr.cfg, {"train.attn_impl": "pallas"}).validate()
    model = build_model(cfg, dev)
    model.load_state_dict(tr.model.state_dict())
    kernel_forward, seen = attention_fused._kernel_forward, []

    def recording(q, k, v, heads):
        out = kernel_forward(q, k, v, heads)
        seen.append((q.clone(), k.clone(), v.clone(), heads, out[0].clone()))
        return out

    attention_fused._kernel_forward = recording
    try:
        reset_launches()
        decoded = viz.decoded_prototypes(model, cfg)
        torch.cuda.synchronize()
        launches = read_launches()
    finally:
        attention_fused._kernel_forward = kernel_forward
    want = {"som_fused": 0, "attention_fwd": cfg.vit.dec_depth, "attention_bwd": 0,
            "attention_fwd_bf16": 0, "attention_bwd_bf16": 0, "block_fwd": 0, "block_bwd": 0,
            "block_fwd_streamed": 0, "block_bwd_streamed": 0}
    check_launches("J2", launches, want, f"one decode call, {cfg.vit.dec_depth} decoder blocks")
    diff = float((decoded - decoded_xla).abs().max())
    perr, scale = decode_err(decoded, exact)
    xerr, _ = decode_err(decoded_xla, exact)
    print(f"J2: pallas decode against J1's xla decode max|diff|={diff:.3e} (max|value| "
          f"{scale:.4f}); against the float64 decode: pallas {perr:.3e}, xla {xerr:.3e} (the "
          f"decode turns last-bit differences inside into ~1e-4 at the pixels: the kernel is "
          f"held below on each call's own inputs)", flush=True)
    check(decoded.shape == decoded_xla.shape and bool(torch.isfinite(decoded).all()),
          "J2: the pallas decode is not finite")
    for i, (q, k, v, heads, o) in enumerate(seen):
        o_p, _ = attention_fused.fused_attention_reference(q, k, v, heads)
        o_64, _ = attention_fused.fused_attention_reference(q.double(), k.double(), v.double(),
                                                            heads)
        err, close = allclose_err(o, o_p, TOL, TOL)
        kerr, perr, f64_ok = float64_err(o, o_p, o_64)
        print(f"J2: decoder block {i}'s attention at {tuple(q.shape)} (the decode's own q, k, v): "
              f"kernel vs plain max|diff| {err:.3e} ok={close}; against float64 kernel {kerr:.3e} "
              f"plain {perr:.3e} (within {F64_FACTOR} x plain + {F64_SLACK}: {f64_ok})",
              flush=True)
        check(close and f64_ok, f"J2: decoder block {i}'s attention kernel is off")
    b, n, h, hd = J_DECODE_SHAPE
    d = h * hd
    q, k, v, _ = attn_inputs(J_DECODE_SHAPE, 7100, dev, "strided")
    o, lse = attention_fused._kernel_forward(q, k, v, h)
    o_p, lse_p = attention_fused.fused_attention_reference(q, k, v, h)
    kerr, kok = allclose_err(o, o_p, TOL, TOL)
    lerr, lok = allclose_err(lse, lse_p, TOL, TOL)
    heads_first = [x.reshape(b, n, h, hd).transpose(1, 2).contiguous() for x in (q, k, v)]
    l2_flush = torch.empty(L2_FLUSH_BYTES // 4, device=dev)
    t = {key: time_call(fn, l2_flush)[0] for key, fn in (
        ("kernel", lambda: attention_fused._kernel_forward(q, k, v, h)),
        ("plain", lambda: attention_fused.fused_attention_reference(q, k, v, h)),
        ("library", lambda: F.scaled_dot_product_attention(*heads_first)))}
    flops, nbytes, n_exp = 4 * b * h * n * n * hd, 16 * b * n * d + 4 * b * h * n, b * h * n * n
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    t_ops = flops / FP32_FLOPS * 1e3
    t_exp = n_exp / (sms * SFU_EXP_PER_CLOCK * SM_CLOCK_HZ) * 1e3
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    bound_ms = max(t_ops, t_exp, t_bytes)
    bound_by = "bytes" if t_bytes >= max(t_ops, t_exp) else "operations"
    print(f"J2: attention_fwd (B,N,H,hd)={J_DECODE_SHAPE} (strided): o max|diff| {kerr:.3e} "
          f"ok={kok}, lse {lerr:.3e} ok={lok}; L2 flushed kernel_ms={t['kernel']:.5f} "
          f"plain_ms={t['plain']:.5f} library_ms={t['library']:.5f} (sdpa backend "
          f"{sdpa_backend(*heads_first)}) bound_ms={bound_ms:.5f} ({bound_by}: fp32 {t_ops:.5f} "
          f"ms, exponentials {t_exp:.5f} ms, {nbytes / 1e6:.3f} MB {t_bytes:.5f} ms) "
          f"kernel_share_of_bound={bound_ms / t['kernel']:.4f}", flush=True)
    check(kok and lok, "J2: the attention kernel differs from its plain version")
    return launches


def phase_eval_cifar(dev, g4_trainer, g4_res):
    """J3: ``eval_checkpoint`` on G4's state (``vit_som_cifar-10.yaml``,
    ``pallas``) saved as ``last`` right after G4's own test eval of it: the
    same test metrics; the test eval's 78 batches + 1 warm-up launch the SOM
    kernel once and the attention forward 14 times (encoder 12 + decoder 2)
    each."""
    path = g4_trainer.save_checkpoint("last")
    res, tr, launches, _ = run_eval("J3", ["--checkpoint", path])
    cfg = tr.cfg
    evals = eval_batch_count(tr.dm.split_len("test"), cfg.batch_size) + 1
    want = expected_launches(cfg, model_attn_impl(cfg), 0, evals)
    check_launches("J3", launches, want, f"{evals} test batches (1 warm-up)")
    keys = ("accuracy", "precision", "recall", "f1")
    same = all(res[k] == g4_res[k] for k in keys)
    print("J3: " + " ".join(f"{k}={res[k]:.6f} (G4 {g4_res[k]:.6f})" for k in keys)
          + f" equal={same}", flush=True)
    check(same and set(res) == set(keys) | {"inference_time"}, "J3: other test metrics than G4's")
    return launches


def plain_lloyd64(x, centers, max_iter=300, tol=1e-4):
    """Lloyd's algorithm in float64, written plainly: sklearn's stopping
    rule (labels repeat, or the summed squared centre shift within tol x
    the mean per-feature variance), then a last assignment."""
    x, c = x.double(), centers.double()
    limit = float(x.var(dim=0, unbiased=False).mean()) * tol
    prev, strict = None, False
    for _ in range(max_iter):
        lab = torch.cdist(x, c).argmin(dim=1)
        new = torch.stack([x[lab == j].mean(dim=0) if bool((lab == j).any()) else c[j]
                           for j in range(c.shape[0])])
        shift = float(((new - c) ** 2).sum())
        c = new
        if prev is not None and torch.equal(lab, prev):
            strict = True
            break
        if shift <= limit:
            break
        prev = lab
    if not strict:
        lab = torch.cdist(x, c).argmin(dim=1)
    return lab, float(((x - c[lab]) ** 2).sum()), c


def phase_eval_desom(dev, root, d, smi):
    """J4: ``desom_mnist.yaml`` as shipped trained one graphed epoch on G2's
    IDX files, saved, then ``eval_checkpoint`` with k-means (no kernel: the
    launch counts stay 0). The k-means twice from one seed, bitwise; its
    labels and inertia against a float64 plain Lloyd from the same
    k-means++ centres."""
    cfg = load_config(DESOM_MNIST, {"data.data_dir": d,
                                    "train.checkpoint_dir": os.path.join(root, "j4_states"),
                                    "train.log_dir": os.path.join(root, "j4_logs")})
    trainer = Trainer(cfg, device=dev)
    trainer.fit(max_steps=trainer.dm.steps_per_epoch)
    check(trainer.graph is not None, "J4: the epoch was not graphed")
    path = trainer.save_checkpoint("last")
    res, tr, launches, seconds = run_eval("J4", ["--checkpoint", path])
    check_launches("J4", launches, {k: 0 for k in launches}, "DESOM: no kernel on its path")
    keys = {"purity", "nmi", "inference_time", "quantization_error", "topographic_error",
            "kmeans_purity", "kmeans_nmi"}
    check(set(res) == keys and all(math.isfinite(v) for v in res.values()),
          f"J4: results {sorted(res)}")
    batches = list(tr.dm.eval_batches())
    x = torch.cat([tr.eval_step(b)["latent"] for b in batches])
    y = torch.cat([b["label"] for b in batches]).cpu().numpy()
    k = len(np.unique(y))
    fits = []
    for _ in range(2):
        km, ms = cuda_ms(lambda: KMeans(n_clusters=k, random_state=0, n_init=10).fit(x))
        fits.append((km, ms))
    (a, a_ms), (b, b_ms) = fits
    same = (torch.equal(a.labels_, b.labels_) and torch.equal(a.cluster_centers_,
                                                            b.cluster_centers_)
            and a.inertia_ == b.inertia_)
    labels = a.labels_.cpu().numpy()
    lab64, inertia64, c64 = plain_lloyd64(x, a.init_centers_)
    d64 = torch.cdist(x.double(), c64)
    top2 = torch.topk(d64 ** 2, 2, dim=1, largest=False).values
    ties = (top2[:, 1] - top2[:, 0]) <= J_TIE * top2[:, 0].clamp_min(1.0)
    differ = lab64 != a.labels_
    print(f"J4: k-means (k {k}, {x.shape[0]} latents of {x.shape[1]}) purity="
          f"{metrics.purity(y, labels):.6f} nmi={metrics.nmi(y, labels):.6f} "
          f"inertia={a.inertia_:.6f} iterations={a.n_iter_} fit_ms={a_ms:.1f},{b_ms:.1f}; "
          f"two fits from seed 0 bitwise_equal={same}; eval_checkpoint kmeans_purity="
          f"{res['kmeans_purity']:.6f} kmeans_nmi={res['kmeans_nmi']:.6f}; float64 plain Lloyd "
          f"from the same seeds: inertia {inertia64:.6f} (rel diff "
          f"{abs(a.inertia_ - inertia64) / inertia64:.3e}), labels differing on "
          f"{int(differ.sum())} rows, all near ties: {bool((~differ | ties).all())}; "
          f"eval_checkpoint {seconds:.3f} s {smi}", flush=True)
    check(same, "J4: k-means is not deterministic")
    check(res["kmeans_purity"] == metrics.purity(y, labels), "J4: k-means purity differs")
    check(bool((~differ | ties).all()), "J4: k-means labels differ outside a near tie")
    check(abs(a.inertia_ - inertia64) <= 1e-5 * inertia64, "J4: k-means inertia off")
    return launches


def phase_eval(dev, root, d, g2_trainer, g2_res, g4_trainer, g4_res, smi):
    """Phase J; returns {path: launch counts} of J1-J4."""
    tr, decoded, exact, j1 = phase_eval_flagship(dev, root, g2_trainer, g2_res, smi)
    j2 = phase_eval_decode_pallas(dev, tr, decoded, exact)
    del tr, decoded, exact
    j3 = phase_eval_cifar(dev, g4_trainer, g4_res)
    j4 = phase_eval_desom(dev, root, d, smi)
    return {"eval_flagship": j1, "eval_prototype_decode_pallas": j2,
            "eval_cifar10_pallas": j3, "eval_desom_kmeans": j4}


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
H_SIZE = 12800  # H1, H3: 10240 train rows (80 steps an epoch)
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
    cfg = baseline_cfg(SWIN_CIFAR, root, {"data.synthetic_size": H_SIZE})
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
    cfg = baseline_cfg(DEIT_CIFAR, root, {"data.data_dir": d, "data.synthetic_size": H_SIZE})
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
# I1, I2: short, as the 224 augmentation costs 0.91 s a batch
I1_GRAPHED = 5  # replays after the warm-up steps and the capture
I1_HOLD = 4  # steps from the restored checkpoint, graphed and eager
I2_SIZE = 640  # 512 train rows (4 steps), 128 val, 128 test
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
    try:
        return _host_run(dev, label, cfg, dm, data_dir, t0, smi)
    finally:
        dm.close()  # the worker pool ends with the run, also on a failure


def _host_run(dev, label, cfg, dm, data_dir, t0, smi):
    """``host_run``'s run and checks on the host-path data module ``dm``."""
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
                  f"memory at the capture (after the trainer returned the cached blocks): "
                  f"{tr.capture_memory} card: {smi}", flush=True)
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
        check(dm.steps_per_epoch == 4 and len(tr.val_history) == 1 and not dm.streams,
              "i2: expected one whole-epoch fill of 4 steps and its validation")
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


# ---------------------------------------------------------------------------
# phase K: bf16 inputs to the attention kernels, the flagship and
# tiny-imagenet under bf16 with them, Swin and DeiT under bf16, the bf16
# first moment
# ---------------------------------------------------------------------------

# the bf16 kernels' shapes: the flagship's encoder and decoder (hd 8, 2),
# cifar-10's (hd 64, 32), tiny-imagenet's encoder and decoder (hd 64, 32,
# B 512), USPS's encoder and decoder (hd 8, 2) and the JAX tests' row
# shapes (hd 16, and N 9)
K1_SHAPES = [(128, 197, 2, 8), (128, 197, 2, 2), (128, 65, 3, 64), (128, 65, 3, 32),
             (512, 257, 3, 64), (512, 257, 3, 32), (128, 65, 2, 8), (128, 65, 2, 2)]
K1_SHAPES += ATTN_TEST_SHAPES
# N past 320, the wgmma one-pass forward's most: the two-pass forwards
# (mma.sync below hd 32, from N 73 on; wgmma from 32 up) and the backwards there: (128, 400, 2, 8), P1's
# (512, 1025, 3, 64), P2's (128, 785, 2, 8) and (128, 785, 2, 2)
K1_SHAPES += [(128, 400, 2, 8), (512, 1025, 3, 64), (128, 785, 2, 8), (128, 785, 2, 2)]
# (shape, layout) beside K1_SHAPES' model layout, held but not timed:
# "odd", q, k, v rows 2 bytes off a 4-byte boundary (row stride 3 D + 1:
# the tensor-core row kernels' 2-byte loads); "far", a quarter of the keys
# far from every query (k1_inputs), so that their p = exp(s - m) run from
# normal floats through float32's subnormals (below 2^-126) to 0
K1_VARIANTS = [((128, 197, 2, 2), "odd"), ((128, 197, 2, 8), "odd"),
               ((128, 197, 2, 8), "far"), ((128, 400, 2, 8), "far"),
               ((512, 1025, 3, 64), "far"), ((128, 785, 2, 8), "far"), ((128, 785, 2, 2), "far"),
               ((128, 197, 2, 2), "far")]
# (shape, layout) held once more from a second seed: the far keys at N
# 1025, where the plain backward's own float32 noise is largest
K1_SECOND_SEED = [((512, 1025, 3, 64), "far")]
# untimed, layout "limit": the largest N the float32 kernels' backward
# takes at hd 2, 8 and 16, which bf16 takes too (B 1). Held to atol/rtol
# 1e-2 and the float64 rule; the share past 1 ulp is printed, not held:
# past N ~4096 the float32 plain is itself up to 2.5e-3 past 1 ulp of
# bwd_rounded64 (its sums over N keys round differently), so the share no
# longer tells the kernel's rounding from the plain version's
K1_LIMITS = [(1, 9685, 1, 2), (1, 3228, 2, 8), (1, 1709, 2, 16)]
K1_MAIN = (512, 257, 3, 64)  # K3's encoder shape: the kernels JSON line's bf16 rows
K1_FLAGSHIP = (128, 197, 2, 8)  # K2's encoder shape: hybrid's backward timed here too
# the shapes whose backward on hybrid's float32 o and do is timed too: K3's,
# K2's and P3's encoder and decoder (N 197), P2's encoder on them (N 785)
K1_HYBRID_TIMED = (K1_MAIN, K1_FLAGSHIP, (128, 197, 2, 2), (128, 785, 2, 8))
# the references (plain and float64) in slices of at most this many scores
# B H N^2, the plain versions timed so too, 5 times, not 30, past it, a
# call at a time: (512, 1025, 3, 64)'s float64 scores alone take 12.9 GB
K1_REF_SCORES = 2**27
BF16_FLOPS = 989e12  # H100 SXM dense bf16 tensor-core peak (NVIDIA data sheet, 700 W)
BF16 = {"train.compute_dtype": "bfloat16"}
# the JAX scoreboard's Swin and DeiT rows (experiments/run_family_bench.py)
K4_OVERRIDES = {**BF16, "train.attn_impl": "xla_bf16"}
K3_STEPS = WARMUP_STEPS + 1 + 3  # 3 replays after the capture
K4_STEPS = 20  # graphed against eager
# P1-P3's step-0 losses against the xla attention's under bf16: the bf16
# train-step bound of tests/test_torch_bf16.py (attention rounded at other
# points moves a loss by bf16 noise, not by float32 rounding)
P_XLA_RTOL = 2e-3


def bf16_ulp(x):
    """The bf16 spacing at each element of ``x`` (8 significant bits)."""
    return torch.exp2(torch.floor(torch.log2(x.abs().clamp_min(2.0**-126))) - 7)


def bf16_close(a, b, ulp_share=1e-3):
    """(max |a - b|, share of elements more than 1 bf16 ulp of ``b`` apart,
    whether within atol/rtol 1e-2 everywhere and 1 ulp on all but
    ``ulp_share`` of the elements, or None: no bound on that share):
    ``tests/test_torch_attention_bf16.py``'s bound."""
    a, b = a.double(), b.double()
    d = (a - b).abs()
    share = float((d > bf16_ulp(b)).double().mean())
    ok = (bool((d <= 1e-2 + 1e-2 * b.abs()).all())
          and (ulp_share is None or share <= ulp_share))
    return float(d.max()), share, ok


def bwd_rounded64(q, k, v, o, lse, do, heads):
    """The bf16 backward's plain version (``fused_attention_bwd_reference``)
    evaluated in float64 between its bf16 roundings (bf16(p) for dv,
    bf16(ds)), on the same q, k, v, o, lse and do: K1's yardstick for the
    backwards' 1-ulp share. Where a key's terms nearly cancel (K1's far
    keys), float32 noise in s and in the sums over N flips the plain
    version's own roundings of p and ds, so at N 1025 it lies past 1 ulp
    of this evaluation on nearly as many elements as the kernel does; K1
    prints all three shares."""
    b, n, d = q.shape
    scale = (d // heads) ** -0.5
    qh, kh, vh, oh, doh = (x.reshape(b, n, heads, d // heads).double()
                           for x in (q, k, v, o, do))
    p = torch.exp(torch.einsum("bnhd,bmhd->bhnm", qh, kh) * scale - lse.double()[..., None])
    dv = torch.einsum("bhnm,bnhd->bmhd", p.to(torch.bfloat16).double(), doh)
    dp = torch.einsum("bnhd,bmhd->bhnm", doh, vh)
    delta = (doh * oh).sum(-1).transpose(1, 2)[..., None]
    ds = (p * (dp - delta) * scale).to(torch.bfloat16).double()
    dq = torch.einsum("bhnm,bmhd->bnhd", ds, kh)
    dk = torch.einsum("bhnm,bnhd->bmhd", ds, qh)
    return tuple(x.reshape(b, n, d).to(torch.bfloat16) for x in (dq, dk, dv))


def k1_inputs(shape, seed, dev, layout="model"):
    """bf16 q, k, v (strided views of one [B, N, 3, D] buffer below D 128,
    as the model hands them over; else contiguous; K1_VARIANTS' "odd" and
    "far" layouts below D 128), a bf16 cotangent (of ``pallas``'s bf16 o)
    and a float32 one (of ``hybrid``'s float32 o). "far": in each head's
    first column q is 16 and k 0, but -14, -14.5, ... -19.5 at every fourth
    key, times sqrt(hd / 8): those keys' scaled scores lie about 79 to 110
    below the rest at every hd, which score on the other columns as
    usual."""
    b, n, h, hd = shape
    d = h * hd
    q, k, v, do = attn_inputs(shape, seed, dev, "strided" if d < 128 else "contiguous")
    if layout == "far":
        q, k = q.clone(), k.clone()
        cols = torch.arange(h, device=dev) * hd
        j = torch.arange(n, device=dev)
        q[:, :, cols] = 16.0
        far = (-14.0 - 0.5 * (j // 4 % 12)) * math.sqrt(hd / 8)
        k[:, :, cols] = torch.where(j % 4 == 3, far, 0.0)[None, :, None]
    if layout == "odd":
        buf = torch.cat((q[..., :1], q, k, v), dim=2).to(torch.bfloat16)
        q, k, v = (buf[:, :, 1 + i * d:1 + (i + 1) * d] for i in range(3))
    elif d < 128:
        buf = torch.stack((q, k, v), dim=2).to(torch.bfloat16)
        q, k, v = buf[:, :, 0], buf[:, :, 1], buf[:, :, 2]
    else:
        q, k, v = (x.to(torch.bfloat16) for x in (q, k, v))
    return q, k, v, do.to(torch.bfloat16), do


def by_batch(fn, rows, *xs):
    """``fn(*xs)`` over slices of ``rows`` batch rows (every x batch-first),
    its outputs (a tensor or a tuple of them) concatenated along the batch:
    K1's references at its largest shapes in bounded memory."""
    if rows >= xs[0].shape[0]:
        return fn(*xs)
    parts = [fn(*(x[i:i + rows] for x in xs)) for i in range(0, xs[0].shape[0], rows)]
    if isinstance(parts[0], torch.Tensor):
        return torch.cat(parts)
    return tuple(torch.cat(z) for z in zip(*parts))


def phase_attention_bf16(dev):
    """K1: each bf16 kernel against its plain bf16 version on the card,
    forward (o, lse) and backward (dq, dk, dv) on a bf16 o and do
    (``pallas``) and on a float32 o and do (``hybrid``), at K1_SHAPES and
    K1_VARIANTS (the "far" ones also check that some p lie in float32's
    subnormal range): the CPU tests' bound
    (``bf16_close``; lse within 1e-5; a backward's 1-ulp share against
    ``bwd_rounded64``, atol/rtol 1e-2 against both) and the float64 rule (each output's
    error against a float64 evaluation on the same bf16 inputs at most
    F64_FACTOR times the plain version's plus F64_SLACK; the backwards take
    the float64 forward's o and lse, rounded); two runs bitwise equal. Then
    each of K1_SHAPES timed with L2 flushed
    beside its plain version and SDPA on bf16 (backend named), against the
    bound: bytes at 3.35 TB/s, bf16 tensor-core operations at 989 TFLOP/s
    (4 B H N^2 hd forward, 10 B H N^2 hd backward) or the B H N^2
    exponentials at 16 a clock an SM, whichever is longest; at K1_MAIN and
    K1_HYBRID_TIMED the backward on hybrid's float32 o and do too
    (``attention_bwd_bf16_hybrid``, printed only). The references run over
    batch slices of at most K1_REF_SCORES scores (``by_batch``). Returns
    ({(shape, name): row}, {name: largest error against plain})."""
    rows, worst = {}, {"attention_fwd_bf16": 0.0, "attention_bwd_bf16": 0.0}
    l2_flush = torch.empty(L2_FLUSH_BYTES // 4, device=dev)
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    exp_per_s = sms * SFU_EXP_PER_CLOCK * SM_CLOCK_HZ
    runs = ([(s, "model", 0) for s in K1_SHAPES] + [(s, lay, 0) for s, lay in K1_VARIANTS]
            + [(s, lay, 1) for s, lay in K1_SECOND_SEED] + [(s, "limit", 0) for s in K1_LIMITS])
    for shape, layout, reseed in runs:
        b, n, h, hd = shape
        d = h * hd
        q, k, v, do, do32 = k1_inputs(shape, 6000 + n + hd + 7919 * reseed, dev, layout)
        label = (f"{shape}" + ("" if layout == "model" else f" {layout}")
                 + (" second seed" if reseed else ""))
        rows_ref = max(1, K1_REF_SCORES // (h * n * n))
        ulp_share = None if layout == "limit" else 1e-3

        def fwd_ref(*x):
            return attention_fused.fused_attention_reference(*x, h)

        def bwd_ref(*x):
            return attention_fused.fused_attention_bwd_reference(*x, h)

        o, lse = attention_fused._kernel_forward(q, k, v, h)
        o2, lse2 = attention_fused._kernel_forward(q, k, v, h)
        ho, hlse = by_batch(fwd_ref, rows_ref, q, k, v)
        po, plse = ho.to(torch.bfloat16), hlse
        q64, k64, v64 = (x.double() for x in (q, k, v))
        eo, else64 = by_batch(fwd_ref, rows_ref, q64, k64, v64)
        exact = {kind: by_batch(bwd_ref, rows_ref, q64, k64, v64, eo, else64, g.double())
                 for kind, g in (("pallas", do), ("hybrid", do32))}
        errs = {"o": bf16_close(o, po, ulp_share)}
        e_lse = float((lse - plse).abs().max())
        errs["lse"] = (e_lse, 0.0, e_lse <= TOL + TOL * float(plse.abs().max()))
        f64 = {}
        for name, a, r, e in (("o", o, po, eo), ("lse", lse, plse, else64)):
            f64[name] = (float((a.double() - e).abs().max()), float((r.double() - e).abs().max()))
        same = torch.equal(o, o2) and torch.equal(lse, lse2)
        # a backward's shares past 1 ulp: kernel against plain, kernel and
        # plain against bwd_rounded64
        shares = {}
        for kind, (ro, rlse, g) in (("pallas", (po, plse, do)), ("hybrid", (ho, hlse, do32))):
            grads = attention_fused._kernel_backward(q, k, v, ro, rlse, g, h)
            again = attention_fused._kernel_backward(q, k, v, ro, rlse, g, h)
            pgrads = by_batch(bwd_ref, rows_ref, q, k, v, ro, rlse, g)
            mgrads = by_batch(functools.partial(bwd_rounded64, heads=h), rows_ref,
                              q, k, v, ro, rlse, g)
            same = same and all(torch.equal(x, y) for x, y in zip(grads, again))
            res = (eo.to(ro.dtype), else64.float())
            kgrads = attention_fused._kernel_backward(q, k, v, *res, g, h)
            rgrads = by_batch(bwd_ref, rows_ref, q, k, v, *res, g)
            for name, a, r, m, kg, rg, e in zip(("dq", "dk", "dv"), grads, pgrads, mgrads,
                                                kgrads, rgrads, exact[kind]):
                e_plain, sh_plain, _ = bf16_close(a, r)
                _, sh_m, ok_m = bf16_close(a, m, ulp_share)
                gap = (a.double() - r.double()).abs()
                within = bool((gap <= 1e-2 + 1e-2 * r.double().abs()).all())
                errs[f"{kind}_{name}"] = (e_plain, sh_plain, ok_m and within)
                shares[f"{kind}_{name}"] = (sh_plain, sh_m, bf16_close(r, m)[1])
                f64[f"{kind}_{name}"] = (float((kg.double() - e).abs().max()),
                                         float((rg.double() - e).abs().max()))
        if layout == "far":
            # the share of p = exp(s - lse) in float32's subnormal range
            # [2^-149, 2^-126), in float64
            sub = 0
            for i in range(0, b, rows_ref):
                p64 = torch.exp(torch.einsum("bqhd,bkhd->bhqk",
                                             q64[i:i + rows_ref].reshape(-1, n, h, hd),
                                             k64[i:i + rows_ref].reshape(-1, n, h, hd))
                                * hd**-0.5 - else64[i:i + rows_ref, ..., None])
                sub += int(((p64 < 2.0**-126) & (p64 >= 2.0**-149)).sum())
                del p64
            sub /= b * h * n * n
            print(f"k1 far (B,N,H,hd)={shape}: share of p in [2^-149, 2^-126) {sub:.4e}",
                  flush=True)
            check(sub > 0, f"k1: no p in float32's subnormal range at {label}")
        torch.cuda.synchronize()
        print(f"k1 attention_bf16_vs_plain (B,N,H,hd)={label}: "
              + " ".join(f"{key}_max_abs_err={e:.3e} beyond_1ulp={sh:.2e}"
                         for key, (e, sh, _) in errs.items())
              + f" deterministic={same}", flush=True)
        print(f"k1 attention_bf16_bwd_beyond_1ulp (B,N,H,hd)={label} (kernel vs plain, kernel "
              f"vs bwd_rounded64, plain vs bwd_rounded64; limit {ulp_share} on the second): "
              + " ".join(f"{key}={a:.2e}/{m:.2e}/{pm:.2e}" for key, (a, m, pm) in shares.items()),
              flush=True)
        print(f"k1 attention_bf16_vs_float64 (B,N,H,hd)={label}: "
              + " ".join(f"{key}: kernel={ke:.3e} plain={pe:.3e}"
                         for key, (ke, pe) in f64.items()), flush=True)
        for key, (e, sh, ok) in errs.items():
            check(ok, f"k1: bf16 attention {key} disagrees with plain at {label}: {e} "
                      f"({shares.get(key, sh)})")
            side = "attention_fwd_bf16" if key in ("o", "lse") else "attention_bwd_bf16"
            worst[side] = max(worst[side], e)
        for key, (ke, pe) in f64.items():
            check(ke <= F64_FACTOR * pe + F64_SLACK,
                  f"k1: bf16 attention {key} further from float64 than {F64_FACTOR} x the plain "
                  f"version's + {F64_SLACK} at {label}: {ke} vs {pe}")
        check(same, f"k1: two bf16 attention kernel runs differ at {label}")
        del q64, k64, v64, eo, else64, exact
        plan = (f"hmma_plan(chunks, warps)={attention_fused.bf16_hmma_plan(n)} "
                f"score_tiles={attention_fused.bf16_hmma_score_tiles(n)}" if hd < 32 else
                f"mma_plan(fwd CTAs, key blocks, bwd CTAs)={attention_fused.bf16_mma_plan(n)}")
        print(f"k1 kernels (B,N,H,hd)={label}: forward={attention_fused.bf16_kernel(n, hd)} "
              f"backward={attention_fused.bf16_kernel(n, hd, True)} {plan} smem_bytes "
              f"fwd/bwd/hybrid_bwd={attention_fused.bf16_smem_bytes(n, hd, False)}"
              f"/{attention_fused.bf16_smem_bytes(n, hd, True)}"
              f"/{attention_fused.bf16_smem_bytes(n, hd, True, True)}", flush=True)
        if layout != "model":
            del q, k, v, do, do32, o, lse, po, plse, ho, hlse
            continue

        heads_first = [x.reshape(b, n, h, hd).transpose(1, 2).contiguous() for x in (q, k, v)]
        leaves = [x.clone().requires_grad_() for x in heads_first]
        do_t = do.reshape(b, n, h, hd).transpose(1, 2).contiguous()
        sdpa_out = F.scaled_dot_product_attention(*leaves)
        cases = {
            "attention_fwd_bf16": (
                {"kernel": lambda: attention_fused._kernel_forward(q, k, v, h),
                 "plain": lambda: by_batch(fwd_ref, rows_ref, q, k, v),
                 "library": lambda: F.scaled_dot_product_attention(*heads_first)},
                4 * b * h * n * n * hd, 8 * b * n * d + 4 * b * h * n),
            "attention_bwd_bf16": (
                {"kernel": lambda: attention_fused._kernel_backward(q, k, v, po, plse, do, h),
                 "plain": lambda: by_batch(bwd_ref, rows_ref, q, k, v, po, plse, do),
                 "library": lambda: torch.autograd.grad(
                     sdpa_out, leaves, do_t, retain_graph=True)},
                10 * b * h * n * n * hd, 16 * b * n * d + 4 * b * h * n),
        }
        if shape in K1_HYBRID_TIMED:
            # hybrid: float32 o and do (4 bytes an element each)
            cases["attention_bwd_bf16_hybrid"] = (
                {"kernel": lambda: attention_fused._kernel_backward(q, k, v, ho, hlse, do32, h),
                 "plain": lambda: by_batch(bwd_ref, rows_ref, q, k, v, ho, hlse, do32),
                 "library": cases["attention_bwd_bf16"][0]["library"]},
                10 * b * h * n * n * hd, 20 * b * n * d + 4 * b * h * n)
        backend = sdpa_backend(*heads_first)
        big = b * h * n * n > K1_REF_SCORES
        for name, (fns, flops, nbytes) in cases.items():
            # a plain call in slices issues hundreds of kernels: one call a
            # held chunk, or the launch queue fills behind the spin
            t = {key: time_call(fn, l2_flush, **({"runs": 5, "warmup": 1, "chunk": 1}
                                                 if big and key == "plain" else {}))[0]
                 for key, fn in fns.items()}
            t_ops = flops / BF16_FLOPS * 1e3
            t_exp = b * h * n * n / exp_per_s * 1e3
            t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
            bound_ms = max(t_ops, t_exp, t_bytes)
            bound_by = "bytes" if t_bytes >= max(t_ops, t_exp) else "operations"
            detail = ("bytes" if bound_by == "bytes" else
                      "exponentials" if t_exp > t_ops else "bf16 tensor-core operations")
            print(f"k1 timing {name} (B,N,H,hd)={shape} (L2 flushed): "
                  f"kernel_ms={t['kernel']:.5f} plain_ms={t['plain']:.5f} "
                  f"library_ms={t['library']:.5f} (sdpa bf16, backend {backend}) "
                  f"bound_ms={bound_ms:.5f} ({detail}: {flops / 1e6:.1f} MFLOP at bf16 "
                  f"{t_ops:.5f} ms, {nbytes / 1e6:.3f} MB {t_bytes:.5f} ms, "
                  f"{b * h * n * n / 1e6:.3f} M exp {t_exp:.5f} ms) "
                  f"kernel_share_of_bound={bound_ms / t['kernel']:.4f} "
                  f"kernel_vs_library={t['kernel'] / t['library']:.3f}", flush=True)
            rows[(shape, name)] = dict(ms=t["kernel"], plain_ms=t["plain"],
                                       library_ms=t["library"], bound_ms=bound_ms,
                                       bound_by=bound_by)
        del q, k, v, do, do32, o, lse, po, plse, ho, hlse, heads_first, leaves, do_t, sdpa_out
    return rows, worst


def phase_flagship_bf16(dev, smi):
    """K2: ``vit_som_mnist.yaml`` + ``compute_dtype: bfloat16`` +
    ``pallas`` (the bf16 tensor-core row kernels at hd 8 and 2):
    TRAIN_STEPS graphed steps with the clustering eval, launches equal to
    the formula, held against its eager run as phase A holds the flagship,
    and
    ``profile_step`` on it. Returns the graphed run's launch counts."""
    run = train_run(dev, "k2_flagship_bf16_pallas", "pallas", TRAIN_STEPS, True, extra=BF16)
    check(run[0].train.compute_dtype == "bfloat16" and run[4]["attention_fwd_bf16"] > 0,
          "K2: the bf16 kernels did not run")
    phase_graphed_vs_eager(dev, "k2_flagship_bf16_pallas", "pallas", run, smi, extra=BF16)
    profile_check("k2_flagship_bf16_pallas", CONFIG, {"train.attn_impl": "pallas", **BF16}, smi)
    return run[4]


def phase_tiny_bf16(dev, smi):
    """K3: ``vit_som_tiny-imagenet.yaml`` (B 512, emb 192, 3 heads of 64:
    the bf16 tensor-core kernels at (512, 257, 3, 64)) + ``compute_dtype:
    bfloat16`` + ``pallas`` on SYNTHETIC_SIZE images: K3_STEPS graphed
    steps (2 warm-up steps, the capture, 3 replays) without the eval; the
    launches equal to the formula (12 bf16 forward and 12 bf16 backward
    launches a step the counters see) and the median step ms printed beside
    the card's line, for E1's float32 step in the same run. Returns the
    launch counts: the kernels JSON line's bf16 rows."""
    cfg, dm, tr, _, launches, _ = cls_run(dev, "k3_tiny_imagenet_bf16_pallas", TINY_CONFIG,
                                          "pallas", K3_STEPS, evaluate=False,
                                          size=SYNTHETIC_SIZE, extra=BF16)
    check(cfg.train.compute_dtype == "bfloat16" and launches["attention_fwd_bf16"] > 0
          and launches["attention_bwd_bf16"] > 0, "K3: the bf16 kernels did not run")
    print(f"k3_tiny_imagenet_bf16_pallas: graphed median_step_ms={steady_ms(tr.step_ms):.4f} "
          f"(bf16, pallas; E1 above: float32) card: {smi}", flush=True)
    del tr, dm
    torch.cuda.empty_cache()
    return launches


def model_params(tr):
    """{name: a copy} of a trainer's parameters and buffers."""
    return {n: t.detach().clone() for n, t in
            [*tr.model.named_parameters(), *tr.model.named_buffers()]}


def long_run(dev, label, config, impl, extra, eager=False, steps=K3_STEPS, dm=None):
    """One P path's run (``cls_run`` for the ViT classifier, ``train_run``
    for ViT-SOM) without the eval, under bf16: (cfg, dm, hist, the step-0
    losses' keys, launches, the median step ms, the peak memory in GB, the
    parameters and buffers). Its trainer, and with it a captured graph's
    memory pool, is released before it returns, so the next run has the
    card's memory."""
    torch.cuda.reset_peak_memory_stats(dev)
    if load_config(config).classification:
        cfg, dm, tr, hist, launches, _ = cls_run(dev, label, config, impl, steps, dm=dm,
                                                 eager=eager, evaluate=False,
                                                 size=SYNTHETIC_SIZE, extra={**BF16, **extra})
        keys = [k for k in steps_lib.metric_keys(cfg) if k.endswith("_loss")]
    else:
        cfg, dm, tr, hist, launches = train_run(dev, label, impl, steps, False, config=config,
                                                extra={**BF16, **extra}, eager=eager,
                                                falls=False)
        keys = list(FIRST_LOSSES)
    torch.cuda.synchronize()
    out = (cfg, dm, hist, keys, launches, steady_ms(tr.step_ms),
           torch.cuda.max_memory_allocated(dev) / 1e9, model_params(tr))
    del tr
    gc.collect()
    torch.cuda.empty_cache()
    return out


def phase_long_sequences(dev, smi):
    """P1-P3: the bf16 attention kernels past 320 keys and on hybrid's
    float32 o and do, each through the trainer at full width:
    P1 ``vit_tiny-imagenet.yaml`` + ``vit.patch_size`` 2 (N 1025, emb 192,
    3 heads of 64, depth 12, B 512: the two-pass wgmma forward and the wgmma
    backward) with ``pallas``; P2 ``vit_som_mnist.yaml`` + ``vit.patch_size``
    1 (N 785: the encoder's hd 8 and the decoder's hd 2 on the two-pass
    mma.sync forward and the mma.sync backward; the SOM kernel at (128,
    12544, 1600)) with ``pallas``; P3 the flagship with ``hybrid`` (the
    mma.sync backward on float32 o and do at hd 8 and 2). Each: K3_STEPS
    graphed steps (2 warm-up steps, the capture, 3 replays) without the
    eval, launches equal to the formula, the median step ms and the peak
    memory printed; the same steps eagerly (every step's losses and every
    final parameter and buffer within GRAPH_RTOL of the graphed run's); one
    eager step with ``xla`` attention under bf16 (P1 with
    ``train.remat_blocks``, which leaves the forward and its losses as
    they are: without it the xla scores of 12 blocks take ~77 GB), whose
    step-0 losses the graphed run's hold within rtol P_XLA_RTOL. Returns
    {path: launches}."""
    paths = {}
    for label, config, impl, extra in (
            ("p1_vit_tiny_imagenet_patch2_bf16_pallas", VIT_TINY_CONFIG, "pallas",
             {"vit.patch_size": 2}),
            ("p2_flagship_patch1_bf16_pallas", CONFIG, "pallas", {"vit.patch_size": 1}),
            ("p3_flagship_bf16_hybrid", CONFIG, "hybrid", {})):
        paths[label] = bf16_path(dev, smi, label, config, impl, extra)
    return paths


def bf16_path(dev, smi, label, config, impl, extra):
    """One P or Q path under bf16 (``phase_long_sequences``' docstring):
    K3_STEPS graphed steps with launches equal to the formula, the same
    steps eagerly within GRAPH_RTOL, and one eager ``xla`` step whose
    step-0 losses the graphed run's hold within rtol P_XLA_RTOL. Returns
    the graphed run's launch counts."""
    cfg, dm, hist, keys, launches, ms, peak, params = long_run(dev, label, config, impl,
                                                               extra)
    n = (cfg.data.input_size // cfg.vit.patch_size) ** 2 + 1
    kernels = {side: sorted({attention_fused.bf16_kernel(n, hd, side == "bwd")
                             for _, hd in model_head_dims(cfg)}) for side in ("fwd", "bwd")}
    print(f"{label}: N={n} head dims {[hd for _, hd in model_head_dims(cfg)]} kernels "
          f"forward={kernels['fwd'] if impl == 'pallas' else 'none (hybrid: eager)'} "
          f"backward={kernels['bwd']} graphed median_step_ms={ms:.4f} "
          f"images_per_s={cfg.batch_size / ms * 1e3:.1f} peak_memory_gb={peak:.3f} "
          f"(torch.cuda.max_memory_allocated) card: {smi}", flush=True)
    check(launches["attention_bwd_bf16"] > 0
          and (impl == "hybrid") == (launches["attention_fwd_bf16"] == 0),
          f"{label}: the bf16 kernels did not run as {impl} runs them")
    _, _, hist_e, _, _, ms_e, _, params_e = long_run(dev, label + "_eager", config, impl,
                                                     extra, eager=True, dm=dm)
    for k in keys:
        a, b = np.asarray(hist[k]), np.asarray(hist_e[k])
        rel = float((np.abs(a - b) / np.maximum(np.abs(b), 1e-30)).max())
        print(f"{label} graphed_vs_eager {k}: steps={len(a)} max_rel_diff={rel:.3e} "
              f"bitwise_equal_steps={int((a == b).sum())}", flush=True)
        check(a.shape == b.shape and rel <= GRAPH_RTOL,
              f"{label}: graphed {k} differs from eager by {rel:.3e}")
    worst = max((float(((params[k] - params_e[k]).abs()
                        / params_e[k].abs().clamp_min(1e-30)).max()), k) for k in params)
    print(f"{label} graphed_vs_eager params and buffers: max_rel_diff={worst[0]:.3e} "
          f"({worst[1]}) eager median_step_ms={ms_e:.4f}", flush=True)
    check(all(bool(((params[k] - params_e[k]).abs()
                    <= GRAPH_RTOL * params_e[k].abs()).all()) for k in params),
          f"{label}: final parameters differ graphed vs eager ({worst})")
    remat = {"train.remat_blocks": True} if cfg.classification else {}
    _, _, hist_x, _, _, _, _, _ = long_run(dev, label + "_xla_step0", config, "xla",
                                           {**extra, **remat}, eager=True, steps=1, dm=dm)
    for k in keys:
        a, b = float(hist[k][0]), float(hist_x[k][0])
        rel = abs(a - b) / max(abs(b), 1e-30)
        print(f"{label} step0 {k}={a:.8f} xla={b:.8f} rel_err={rel:.3e}", flush=True)
        check(rel <= P_XLA_RTOL, f"{label}: step-0 {k} differs from xla's: {a} vs {b}")
    del dm, params, params_e
    torch.cuda.empty_cache()
    return launches


def phase_baselines_bf16(dev, smi):
    """K4: ``swin_cifar-10`` and ``deit_cifar-10`` with the JAX
    scoreboard's overrides (bf16, ``xla_bf16``) on H_SIZE synthetic
    images: K4_STEPS graphed steps against K4_STEPS eager ones (losses,
    parameters and the recorded masks, as H holds them; Swin's first epoch
    trains at lr 0, DeiT's at its cosine), float32 parameters and logits;
    no kernel on the path. The graphed median step ms stands beside H1's
    and H3's float32 ones. Returns {path: launch counts}."""
    paths = {}
    with tempfile.TemporaryDirectory() as root:
        for label, config, losses in (
                ("k4_swin_cifar10_bf16", SWIN_CIFAR, ("train/cls_loss",)),
                ("k4_deit_cifar10_bf16", DEIT_CIFAR, ("train/distill_loss", "train/cls_loss"))):
            MaskProbe.install()
            try:
                cfg = baseline_cfg(config, root, {**K4_OVERRIDES, "data.synthetic_size": H_SIZE})
                tr, probe = baseline_trainer(label, config, cfg, dev)
                check(next(tr.model.parameters()).dtype == torch.float32, f"{label}: bf16 params")
                probe.activate()
                reset_launches()
                hg = tr.fit(max_steps=K4_STEPS)
                torch.cuda.synchronize()
                paths[label] = read_launches()
                tr_e, probe_e = baseline_trainer(label + "_eager", config, cfg, dev, dm=tr.dm)
                probe_e.activate()
                he = tr_e.fit(max_steps=K4_STEPS, eager=True)
                probe.activate()
                compare_runs(label, cfg, tr, hg, tr_e, he, losses, smi)
                hold_masks(label, probe, probe_e, K4_STEPS)
                with torch.no_grad():
                    logits = tr.model(tr.dm.epoch_batch(tr.epoch_images,
                                                        torch.zeros((), dtype=torch.int64,
                                                                    device=dev))["image"])
                print(f"{label}: {describe(cfg)} compute={cfg.train.compute_dtype} attn_impl="
                      f"{model_attn_impl(cfg)} cls_loss first={hg['train/cls_loss'][0]:.6f} "
                      f"last={hg['train/cls_loss'][-1]:.6f} logits dtype={logits.dtype}",
                      flush=True)
                check(logits.dtype == torch.float32 and bool(torch.isfinite(logits).all()),
                      f"{label}: the logits are not finite float32")
                zero_launches(label, paths[label])
                del tr, tr_e, probe, probe_e
            finally:
                MaskProbe.uninstall()
            torch.cuda.empty_cache()
    return paths


def phase_bench_bf16_mu(dev, smi, bench_ms):
    """K5: ``bench.py``'s configuration + ``train.adam_mu_dtype: bfloat16``
    (the port's ``AdamWBf16Mu``): TRAIN_STEPS graphed steps with the
    clustering eval, every first moment bf16 and second moment float32,
    held against its eager run; the step ms beside phase B's."""
    extra = {**BENCH_OVERRIDES, "train.adam_mu_dtype": "bfloat16"}
    run = train_run(dev, "k5_bench_bf16_mu", None, TRAIN_STEPS, True, extra=extra)
    tr = run[2]
    st = [tr.optimizer.state[p] for g in tr.optimizer.param_groups for p in g["params"]]
    dtypes = {(s["exp_avg"].dtype, s["exp_avg_sq"].dtype) for s in st}
    print(f"k5_bench_bf16_mu: optimizer {type(tr.optimizer).__name__}, {len(st)} parameters, "
          f"moment dtypes {sorted(str(d) for d in dtypes)}; graphed median_step_ms="
          f"{steady_ms(tr.step_ms):.4f} beside phase B's {bench_ms:.4f} (float32 first moment) "
          f"card: {smi}", flush=True)
    check(isinstance(tr.optimizer, optim_lib.AdamWBf16Mu)
          and dtypes == {(torch.bfloat16, torch.float32)}, "K5: the first moment is not bf16")
    phase_graphed_vs_eager(dev, "k5_bench_bf16_mu", None, run, smi, extra=extra)
    return run[4]


# ---------------------------------------------------------------------------
# phase Q: every head dim the JAX kernel takes, and the SOM at any depth
# ---------------------------------------------------------------------------

# the head dims held (each design's edges and the shipped widths' heads
# overrides: 1 and 4 the flagship's at vit.heads 4, 12, 24, 96 and 192 the
# emb-192 configs' at vit.heads 16, 8, 2 and 1, 80 and 128 the public
# ViTs'; 25, 28 and 31 the 3xTF32 kernels' lower edge, padded to tier 32)
# at each sequence length, float32 and bf16, forward, backward and hybrid's
# float32 o and do
Q_HEAD_DIMS = (1, 3, 4, 5, 12, 17, 24, 25, 28, 31, 36, 40, 80, 96, 128, 192)
# tier 32 (hd 25-31 padded, and 32 as shipped) where the float64 rule came
# nearest: short N, since slice 23 on the row kernels (the 3xTF32 kernels
# broke the rule on 5 of these 160 (hd, N, seed)), from Q_EDGE_SEEDS more
# seeds; and N 1025, on the 3xTF32 kernels, from Q_EDGE_LONG_SEEDS. Each
# held to 1e-5 against plain, bitwise, and to the float64 rule
Q_EDGE = [(hd, n) for hd in (25, 28, 31, 32) for n in (9, 65)]
Q_EDGE_SEEDS = 20
Q_EDGE_LONG = [(hd, 1025) for hd in (25, 28, 31, 32)]
Q_EDGE_LONG_SEEDS = 5
# the padded bf16 tier 2 at hd 1, N 1025, B 2 (4100 elements an output, one
# 0.024 %): the backward's share past 1 ulp of bwd_rounded64 at most
# Q_HD1_SHARE over Q_HD1_SEEDS seeds (the inputs of ops/
# attention_bf16_turns.py --shares: seed s there is s - 1)
Q_HD1 = (2, 1025, 2, 1)
Q_HD1_SEEDS = 5
Q_HD1_SHARE = 1e-3
Q_SEQ = (9, 65, 197, 257, 321, 1025)
Q_HEADS = 2
# B of a hold: at least 2, and enough rows that each output holds
# Q_ELEMENTS elements, so the bf16 bound's 0.1 % past 1 ulp is 16 of them
# (at B 2, hd 1, N 1025 an output holds 4100: one element is 0.024 %)
Q_ELEMENTS = 1 << 14
# views one element off their buffer's 16-byte boundaries (every copy
# narrower than 16 bytes) at a head dim at its tier in each design
Q_ODD = [(2, 197, 2, hd) for hd in (4, 24, 96, 192)]
# timed beside SDPA: the flagship at vit.heads 4 (encoder, decoder),
# tiny-imagenet at vit.heads 2 and 1 and 16 (encoder), hd 128, and hd 24
# beside 16 at (128, 197, 8): the bf16 wgmma kernels from hd 17 against the
# mma.sync row kernels below
Q_TIMED = [(128, 197, 4, 4), (128, 197, 4, 1), (512, 257, 2, 96), (512, 257, 1, 192),
           (512, 257, 16, 12), (512, 257, 2, 128), (128, 197, 8, 24), (128, 197, 8, 16)]
# the SOM off 16-byte copies: the JAX tests' (B, P, D) at ldx D (map 6 x
# 7), and D 3137 from a row stride of 3139 floats, one float into its
# buffer (map 40 x 40, the flagship's B)
Q_SOM = [((12, 33, 42, (6, 7)), 33, 0), ((128, 3137, 1600, (40, 40)), 3139, 1)]
Q_FLAGSHIP_HEADS = {"vit.heads": 4}
Q_TINY = {"vit.heads": 2, "vit.depth": 2}


def q_batch(n, hd):
    """Q_HEADS heads of ``hd`` at ``n`` tokens: the batch of a hold."""
    return max(2, -(-Q_ELEMENTS // (Q_HEADS * n * hd)))


def q_design(dtype, hd, n):
    """The design a call at ``hd`` and ``n`` runs: float32 rows (1-24, and
    25-32 up to N 880), mma (25-64), mma_sliced (65-192); bf16 hmma (1-16),
    wgmma1-3 (the head in 1-3 column tiles)."""
    if dtype == torch.float32:
        tier = attention_fused.head_tier(hd)
        return ("rows" if attention_fused.row_kernels(n, hd) else "mma" if tier <= 64
                else "mma_sliced")
    tier = attention_fused.bf16_tier(hd)
    return "hmma" if tier <= 16 else f"wgmma{tier // 64}"


def q_inputs(shape, seed, dev, layout, dtype):
    """q, k, v (strided views of one [B, N, 3, D] buffer, as the model
    slices them; or "odd": one element into a [B, N, 3 D + 1] buffer) in
    ``dtype``, and a float32 cotangent."""
    b, n, h, hd = shape
    d = h * hd
    g = torch.Generator(device=dev).manual_seed(seed)
    if layout == "odd":
        buf = torch.randn(b, n, 3 * d + 1, generator=g, device=dev).to(dtype)
        q, k, v = (buf[:, :, 1 + i * d:1 + (i + 1) * d] for i in range(3))
    else:
        buf = torch.randn(b, n, 3, d, generator=g, device=dev).to(dtype)
        q, k, v = buf[:, :, 0], buf[:, :, 1], buf[:, :, 2]
    return q, k, v, torch.randn(b, n, d, generator=g, device=dev)


def q_hold_float32(shape, layout, dev, seed=0, hold_f64=True):
    """The float32 kernels at ``shape`` against their plain versions (1e-5)
    and float64 (at most F64_FACTOR x the plain version's error +
    F64_SLACK, unless not ``hold_f64``; the backward on the float64
    forward's o and lse), two runs bitwise equal. Returns ({"fwd": err,
    "bwd": err}, the largest float64 ratio, kernel's error over the plain
    version's, the outputs past the float64 rule)."""
    b, n, h, hd = shape
    q, k, v, do = q_inputs(shape, 7000 + n + hd + 1000 * seed, dev, layout, torch.float32)
    o, lse = attention_fused._kernel_forward(q, k, v, h)
    o2, lse2 = attention_fused._kernel_forward(q, k, v, h)
    ro, rlse = attention_fused.fused_attention_reference(q, k, v, h)
    grads = attention_fused._kernel_backward(q, k, v, ro, rlse, do, h)
    again = attention_fused._kernel_backward(q, k, v, ro, rlse, do, h)
    rgrads = attention_fused.fused_attention_bwd_reference(q, k, v, ro, rlse, do, h)
    q64, k64, v64, do64 = (x.double() for x in (q, k, v, do))
    eo, else64 = attention_fused.fused_attention_reference(q64, k64, v64, h)
    exact = (eo, else64, *attention_fused.fused_attention_bwd_reference(
        q64, k64, v64, eo, else64, do64, h))
    res = (eo.float(), else64.float())
    kgrads = attention_fused._kernel_backward(q, k, v, *res, do, h)
    pgrads = attention_fused.fused_attention_bwd_reference(q, k, v, *res, do, h)
    errs = {"o": allclose_err(o, ro, TOL, TOL), "lse": allclose_err(lse, rlse, TOL, TOL)}
    for name, a, r in zip(("dq", "dk", "dv"), grads, rgrads):
        errs[name] = allclose_err(a, r, TOL, TOL)
    f64 = {name: float64_err(a, r, e) for name, a, r, e in
           zip(("o", "lse", "dq", "dk", "dv"), (o, lse, *kgrads), (ro, rlse, *pgrads), exact)}
    same = (torch.equal(o, o2) and torch.equal(lse, lse2)
            and all(torch.equal(x, y) for x, y in zip(grads, again)))
    ratio = max(ke / pe for ke, pe, _ in f64.values() if pe > 0)
    label = (f"(B,N,H,hd)={shape} float32 {layout} {q_design(torch.float32, hd, n)}"
             + (f" seed {seed}" if seed else ""))
    print(f"q attention_vs_plain {label}: "
          + " ".join(f"{key}={e:.2e}" for key, (e, _) in errs.items())
          + " float64 kernel/plain: "
          + " ".join(f"{key}={ke:.2e}/{pe:.2e}" for key, (ke, pe, _) in f64.items())
          + f" ratio={ratio:.3f} deterministic={same}", flush=True)
    for key, (e, ok) in errs.items():
        check(ok, f"Q: float32 attention {key} disagrees with plain at {label}: {e}")
    for key, (ke, pe, ok) in f64.items():
        check(ok or not hold_f64, f"Q: float32 attention {key} further from float64 than "
                                  f"{F64_FACTOR} x the plain version's + {F64_SLACK} at "
                                  f"{label}: {ke} vs {pe}")
    check(same, f"Q: two float32 attention kernel runs differ at {label}")
    return ({"fwd": max(errs["o"][0], errs["lse"][0]),
             "bwd": max(errs[x][0] for x in ("dq", "dk", "dv"))}, ratio,
            [key for key, (_, _, ok) in f64.items() if not ok])


def q_hold_bf16(shape, layout, dev):
    """The bf16 kernels at ``shape`` against their plain versions, as K1
    holds them: o within 1 bf16 ulp on all but 0.1 % and atol/rtol 1e-2,
    lse 1e-5; the backwards on bf16 o and do (``pallas``) and on float32
    ones (``hybrid``) within 1 ulp of ``bwd_rounded64`` on all but 0.1 %
    and atol/rtol 1e-2 of plain; the float64 rule; two runs bitwise equal.
    Returns {"fwd": err, "bwd": err}."""
    b, n, h, hd = shape
    q, k, v, do32 = q_inputs(shape, 8000 + n + hd, dev, layout, torch.bfloat16)
    do = do32.to(torch.bfloat16)
    o, lse = attention_fused._kernel_forward(q, k, v, h)
    o2, lse2 = attention_fused._kernel_forward(q, k, v, h)
    ho, hlse = attention_fused.fused_attention_reference(q, k, v, h)
    po = ho.to(torch.bfloat16)
    q64, k64, v64 = (x.double() for x in (q, k, v))
    eo, else64 = attention_fused.fused_attention_reference(q64, k64, v64, h)
    errs = {"o": bf16_close(o, po)}
    e_lse = float((lse - hlse).abs().max())
    errs["lse"] = (e_lse, 0.0, e_lse <= TOL + TOL * float(hlse.abs().max()))
    f64 = {"o": (float((o.double() - eo).abs().max()), float((po.double() - eo).abs().max())),
           "lse": (float((lse.double() - else64).abs().max()),
                   float((hlse.double() - else64).abs().max()))}
    same = torch.equal(o, o2) and torch.equal(lse, lse2)
    for kind, (ro, g) in (("pallas", (po, do)), ("hybrid", (ho, do32))):
        grads = attention_fused._kernel_backward(q, k, v, ro, hlse, g, h)
        again = attention_fused._kernel_backward(q, k, v, ro, hlse, g, h)
        pgrads = attention_fused.fused_attention_bwd_reference(q, k, v, ro, hlse, g, h)
        mgrads = bwd_rounded64(q, k, v, ro, hlse, g, h)
        same = same and all(torch.equal(x, y) for x, y in zip(grads, again))
        exact = attention_fused.fused_attention_bwd_reference(q64, k64, v64, eo, else64,
                                                              g.double(), h)
        res = (eo.to(ro.dtype), else64.float())
        kgrads = attention_fused._kernel_backward(q, k, v, *res, g, h)
        rgrads = attention_fused.fused_attention_bwd_reference(q, k, v, *res, g, h)
        for name, a, r, m, kg, rg, e in zip(("dq", "dk", "dv"), grads, pgrads, mgrads, kgrads,
                                            rgrads, exact):
            e_plain, _, _ = bf16_close(a, r)
            _, sh_m, ok_m = bf16_close(a, m)
            gap = (a.double() - r.double()).abs()
            within = bool((gap <= 1e-2 + 1e-2 * r.double().abs()).all())
            errs[f"{kind}_{name}"] = (e_plain, sh_m, ok_m and within)
            f64[f"{kind}_{name}"] = (float((kg.double() - e).abs().max()),
                                     float((rg.double() - e).abs().max()))
    label = f"(B,N,H,hd)={shape} bf16 {layout} {q_design(torch.bfloat16, hd, n)}"
    print(f"q attention_bf16_vs_plain {label}: "
          + " ".join(f"{key}={e:.2e}/{sh:.1e}" for key, (e, sh, _) in errs.items())
          + " float64 kernel/plain: "
          + " ".join(f"{key}={ke:.2e}/{pe:.2e}" for key, (ke, pe) in f64.items())
          + f" deterministic={same} kernels={attention_fused.bf16_kernel(n, hd, views=(q, k, v))}"
          f"/{attention_fused.bf16_kernel(n, hd, True)}", flush=True)
    for key, (e, sh, ok) in errs.items():
        check(ok, f"Q: bf16 attention {key} disagrees with plain at {label}: {e} (share past "
                  f"1 ulp {sh})")
    for key, (ke, pe) in f64.items():
        check(ke <= F64_FACTOR * pe + F64_SLACK,
              f"Q: bf16 attention {key} further from float64 than {F64_FACTOR} x the plain "
              f"version's + {F64_SLACK} at {label}: {ke} vs {pe}")
    check(same, f"Q: two bf16 attention kernel runs differ at {label}")
    return {"fwd": max(errs["o"][0], errs["lse"][0]),
            "bwd": max(e for key, (e, _, _) in errs.items() if key not in ("o", "lse"))}


def q_hold_hd1(dev):
    """The padded bf16 tier 2 at Q_HD1 (hd 1) from Q_HD1_SEEDS seeds: the
    backward on the forward kernel's bf16 o and lse and a bf16 do
    (``pallas``), each of dq, dk, dv more than 1 bf16 ulp from
    ``bwd_rounded64`` on at most Q_HD1_SHARE of its elements (the plain
    version's share printed beside it)."""
    b, n, h, hd = Q_HD1
    d = h * hd
    worst = 0.0
    for seed in range(1, 1 + Q_HD1_SEEDS):
        g = torch.Generator(device=dev).manual_seed(6000 + n + hd + 1000 * (seed - 1))
        buf = torch.randn(b, n, 3, d, generator=g, device=dev).to(torch.bfloat16)
        q, k, v = buf[:, :, 0], buf[:, :, 1], buf[:, :, 2]
        do = torch.randn(b, n, d, generator=g, device=dev).to(torch.bfloat16)
        o, lse = attention_fused._kernel_forward(q, k, v, h)
        grads = attention_fused._kernel_backward(q, k, v, o, lse, do, h)
        plain = attention_fused.fused_attention_bwd_reference(q, k, v, o, lse, do, h)
        ref = bwd_rounded64(q, k, v, o, lse, do, h)
        shares = {}
        for name, a, p, r in zip(("dq", "dk", "dv"), grads, plain, ref):
            ulp = bf16_ulp(r.double())
            shares[name] = (float(((a.double() - r.double()).abs() > ulp).double().mean()),
                            float(((p.double() - r.double()).abs() > ulp).double().mean()))
        worst = max(worst, *(kern for kern, _ in shares.values()))
        print(f"q bf16 hd 1 (B,N,H,hd)={Q_HD1} seed {seed}: share past 1 ulp of bwd_rounded64 "
              f"kernel/plain " + " ".join(f"{k}={a:.2e}/{p:.2e}" for k, (a, p) in shares.items())
              + f" kernel={attention_fused.bf16_kernel(n, hd, True)}", flush=True)
        for name, (kern, _) in shares.items():
            check(kern <= Q_HD1_SHARE, f"Q: bf16 hd 1 {name} past 1 ulp of bwd_rounded64 on "
                                       f"{kern} of its elements at {Q_HD1} seed {seed}")
    return worst


def q_hold_som(dev):
    """The SOM kernel off 16-byte copies (Q_SOM) against its plain version
    and float64, as phase 3 holds it: distances within 1e-5, BMUs equal up
    to near ties, the loss at the kernel's BMUs within 1e-5, two runs
    bitwise equal, cosine and euclidean. Returns the largest error."""
    worst, temp = 0.0, 3.7
    for (b, d, p, map_size), ldx, offset in Q_SOM:
        g = torch.Generator(device=dev).manual_seed(9000 + d)
        buf = torch.randn(b, ldx, generator=g, device=dev)
        x = buf[:, offset:offset + d]
        protos = torch.randn(p, d, generator=g, device=dev) * 0.5
        wide = som_fused.wide_copies(d, x.stride(0), x.data_ptr(), protos.data_ptr())
        check(not wide, f"Q: the SOM at D {d}, ldx {ldx} takes 16-byte copies")
        cols = map_size[1]
        for distance in ("cosine", "euclidean"):
            kl, kb, kd = som_fused._kernel_forward(x, protos, temp, cols, "square", distance)
            kl2, _, kd2 = som_fused._kernel_forward(x, protos, temp, cols, "square", distance)
            rl, rb, rd = som_fused.fused_som_reference(x, protos, temp, cols, "square", distance)
            exact = som_fused.fused_som_reference(x.double(), protos.double(), temp, cols,
                                                  "square", distance)[2]
            derr, dok = allclose_err(kd, rd, TOL, TOL)
            near_tie, _ = near_ties(rd, distance)
            mismatch = int(((kb != rb) & ~near_tie).sum())
            w = torch.exp(-som_fused.grid_d2_rows(kb, p, cols, "square") / som.two_t_squared(temp))
            lerr, lok = allclose_err(kl, torch.sum(w * rd) / (b * p), TOL, TOL)
            kerr, perr, f64_ok = float64_err(kd, rd, exact)
            same = torch.equal(kl, kl2) and torch.equal(kd, kd2)
            where = f"B={b} D={d} P={p} ldx={ldx} offset={offset} {distance}"
            print(f"q som_vs_plain {where} (4-byte copies): dist_max_abs_err={derr:.3e} "
                  f"loss_abs_err={lerr:.3e} bmu_mismatch={mismatch} "
                  f"near_tie_rows={int(near_tie.sum())} float64: kernel_err={kerr:.3e} "
                  f"plain_err={perr:.3e} deterministic={same}", flush=True)
            check(dok and lok and mismatch == 0 and f64_ok and same,
                  f"Q: the SOM kernel disagrees with plain at {where}")
            worst = max(worst, derr, lerr)
    return worst


def q_timed_err(name, shape, kernel_out, plain_out, rounded=None):
    """The timed call's outputs at ``shape`` held against the plain
    version's on the same inputs: float32 within TOL; bf16 as
    ``q_hold_bf16`` holds them (o within 1 ulp on all but 0.1 % and
    atol/rtol 1e-2, lse TOL; dq, dk, dv within 1 ulp of ``rounded``, the
    ``bwd_rounded64`` values, on all but 0.1 % and atol/rtol 1e-2 of
    plain). Returns the largest |kernel - plain|."""
    errs = []
    bf16 = kernel_out[0].dtype == torch.bfloat16
    for i, (a, r) in enumerate(zip(kernel_out, plain_out)):
        if not bf16:
            e, ok = allclose_err(a, r, TOL, TOL)
        elif rounded is None and i == 1:  # the bf16 forward's float32 lse
            e = float((a - r).abs().max())
            ok = e <= TOL + TOL * float(r.abs().max())
        elif rounded is None:
            e, _, ok = bf16_close(a, r.to(torch.bfloat16))
        else:
            e, _, _ = bf16_close(a, r)
            _, share, ok = bf16_close(a, rounded[i])
            ok = ok and bool((a.double() - r.double()).abs().le(
                1e-2 + 1e-2 * r.double().abs()).all())
        check(ok, f"Q: the timed {name} at {shape} disagrees with plain: {e}")
        errs.append(e)
    return max(errs)


def q_timings(dev):
    """Q_TIMED in both dtypes, L2 flushed: kernel, plain version and SDPA
    (the library call, same dtype) beside the bound: bytes at 3.35 TB/s,
    operations (float32: 3 TF32 products at 495 TFLOP/s from hd 25, FP32
    at 67 below; bf16 at 989), or the exponentials at 16 a clock an SM,
    the longest. Each kernel's output is held against the plain version's
    at its shape (``q_timed_err``). Returns {(shape, kernel name): row}."""
    rows = {}
    l2_flush = torch.empty(L2_FLUSH_BYTES // 4, device=dev)
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    exp_per_s = sms * SFU_EXP_PER_CLOCK * SM_CLOCK_HZ
    for shape in Q_TIMED:
        b, n, h, hd = shape
        d = h * hd
        for dtype in (torch.float32, torch.bfloat16):
            q, k, v, do32 = q_inputs(shape, 9500 + n + hd, dev, "strided", dtype)
            do = do32.to(dtype)
            o, lse = attention_fused._kernel_forward(q, k, v, h)
            rows_ref = max(1, K1_REF_SCORES // (h * n * n))
            heads_first = [x.reshape(b, n, h, hd).transpose(1, 2).contiguous() for x in (q, k, v)]
            leaves = [x.clone().requires_grad_() for x in heads_first]
            do_t = do.reshape(b, n, h, hd).transpose(1, 2).contiguous()
            sdpa_out = F.scaled_dot_product_attention(*leaves)
            size = torch.finfo(dtype).bits // 8

            def fwd_ref(*x):
                return attention_fused.fused_attention_reference(*x, h)

            def bwd_ref(*x):
                return attention_fused.fused_attention_bwd_reference(*x, h)

            bf16 = dtype == torch.bfloat16
            suffix = "_bf16" if bf16 else ""
            cases = {
                f"attention_fwd{suffix}": (
                    {"kernel": lambda: attention_fused._kernel_forward(q, k, v, h),
                     "plain": lambda: by_batch(fwd_ref, rows_ref, q, k, v),
                     "library": lambda: F.scaled_dot_product_attention(*heads_first)},
                    4 * b * h * n * n * hd, 4 * size * b * n * d + 4 * b * h * n),
                f"attention_bwd{suffix}": (
                    {"kernel": lambda: attention_fused._kernel_backward(q, k, v, o, lse, do, h),
                     "plain": lambda: by_batch(bwd_ref, rows_ref, q, k, v, o, lse, do),
                     "library": lambda: torch.autograd.grad(sdpa_out, leaves, do_t,
                                                            retain_graph=True)},
                    10 * b * h * n * n * hd, 8 * size * b * n * d + 4 * b * h * n),
            }
            big = b * h * n * n > K1_REF_SCORES
            design = q_design(dtype, hd, n)
            for name, (fns, flops, nbytes) in cases.items():
                rounded = (by_batch(lambda *x: bwd_rounded64(*x, h), rows_ref, q, k, v, o, lse,
                                    do) if bf16 and "_bwd" in name else None)
                err = q_timed_err(name, shape, fns["kernel"](), fns["plain"](), rounded)
                del rounded
                t = {key: time_call(fn, l2_flush, **({"runs": 5, "warmup": 1, "chunk": 1}
                                                     if big and key == "plain" else
                                                     {"runs": 10}))[0]
                     for key, fn in fns.items()}
                if bf16:
                    t_ops, unit = flops / BF16_FLOPS * 1e3, "bf16 tensor-core operations"
                elif design == "rows":
                    t_ops, unit = flops / FP32_FLOPS * 1e3, "fp32"
                else:
                    t_ops, unit = 3 * flops / TF32_FLOPS * 1e3, "3xTF32"
                t_exp = b * h * n * n / exp_per_s * 1e3
                t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
                bound_ms = max(t_ops, t_exp, t_bytes)
                bound_by = "bytes" if t_bytes >= max(t_ops, t_exp) else "operations"
                detail = ("bytes" if bound_by == "bytes" else
                          "exponentials" if t_exp > t_ops else unit)
                print(f"q timing {name} (B,N,H,hd)={shape} {design} (L2 flushed): "
                      f"kernel_ms={t['kernel']:.5f} plain_ms={t['plain']:.5f} "
                      f"library_ms={t['library']:.5f} (sdpa {str(dtype)[6:]}, backend "
                      f"{sdpa_backend(*heads_first)}) bound_ms={bound_ms:.5f} ({detail}: "
                      f"{flops / 1e6:.1f} MFLOP {t_ops:.5f} ms, {nbytes / 1e6:.3f} MB "
                      f"{t_bytes:.5f} ms, {b * h * n * n / 1e6:.3f} M exp {t_exp:.5f} ms) "
                      f"kernel_share_of_bound={bound_ms / t['kernel']:.4f} "
                      f"kernel_vs_library={t['kernel'] / t['library']:.3f} "
                      f"max_abs_err={err:.3e} (kernel against plain)", flush=True)
                rows[(shape, name)] = dict(max_abs_err=err, ms=t["kernel"], plain_ms=t["plain"],
                                           library_ms=t["library"], bound_ms=bound_ms,
                                           bound_by=bound_by)
            del q, k, v, do, do32, o, lse, heads_first, leaves, do_t, sdpa_out
    return rows


def q_holds(dev):
    """Phase Q's kernel holds: every Q_HEAD_DIMS x Q_SEQ at (``q_batch``, N,
    Q_HEADS, hd) and Q_ODD, float32 and bf16, Q_EDGE from Q_EDGE_SEEDS and
    Q_EDGE_LONG from Q_EDGE_LONG_SEEDS more seeds (float32; the float64
    ratios printed, every miss raised after the sweep), Q_HD1
    (``q_hold_hd1``), then the SOM (Q_SOM). The launches of each wrapper are
    counted and must equal its calls. Returns ({(dtype, design, side):
    largest error}, SOM error)."""
    worst = {}
    reset_launches()
    calls = {"attention_fwd": 0, "attention_bwd": 0, "attention_fwd_bf16": 0,
             "attention_bwd_bf16": 0}
    cases = [((q_batch(n, hd), n, Q_HEADS, hd), "strided") for hd in Q_HEAD_DIMS for n in Q_SEQ]
    for shape, layout in cases + [(s, "odd") for s in Q_ODD]:
        hd = shape[3]
        for dtype, hold in ((torch.float32, q_hold_float32), (torch.bfloat16, q_hold_bf16)):
            errs = hold(shape, layout, dev)
            if dtype == torch.float32:
                errs = errs[0]
            for side, e in errs.items():
                key = (str(dtype)[6:], q_design(dtype, hd, shape[1]), side)
                worst[key] = max(worst.get(key, 0.0), e)
            bf16 = dtype == torch.bfloat16
            calls["attention_fwd_bf16" if bf16 else "attention_fwd"] += 2
            calls["attention_bwd_bf16" if bf16 else "attention_bwd"] += 6 if bf16 else 3
    misses = []
    for (hd, n), seeds in ([(e, Q_EDGE_SEEDS) for e in Q_EDGE]
                           + [(e, Q_EDGE_LONG_SEEDS) for e in Q_EDGE_LONG]):
        shape = (q_batch(n, hd), n, Q_HEADS, hd)
        ratios, past = [], []
        design = q_design(torch.float32, hd, n)
        for seed in range(1, 1 + seeds):
            errs, ratio, outside = q_hold_float32(shape, "strided", dev, seed, hold_f64=False)
            ratios.append(ratio)
            past += [f"seed {seed} {key}" for key in outside]
            for side, e in errs.items():
                key = ("float32", design, side)
                worst[key] = max(worst.get(key, 0.0), e)
            calls["attention_fwd"] += 2
            calls["attention_bwd"] += 3
        misses += [f"{shape} {miss}" for miss in past]
        print(f"q tier 32 {design} (B,N,H,hd)={shape}: float64 error ratio kernel/plain over "
              f"seeds 1-{seeds}: max {max(ratios):.3f} median "
              f"{statistics.median(ratios):.3f}; past the float64 rule ({F64_FACTOR} x plain + "
              f"{F64_SLACK}): {', '.join(past) or 'none'}", flush=True)
    check(not misses, f"Q: tier 32 past the float64 rule at {', '.join(misses)}")
    q_hold_hd1(dev)
    calls["attention_fwd_bf16"] += Q_HD1_SEEDS
    calls["attention_bwd_bf16"] += Q_HD1_SEEDS
    som_err = q_hold_som(dev)
    torch.cuda.synchronize()
    launches = read_launches()
    calls["som_fused"] = 2 * 2 * len(Q_SOM)
    print("q launches: " + " ".join(f"{k}={launches[k]} (calls {v})" for k, v in calls.items()),
          flush=True)
    check(all(launches[k] == v for k, v in calls.items()),
          f"Q: launches {launches} differ from the calls {calls}")
    return worst, som_err


def phase_head_dims(dev, smi):
    """Phase Q: ``q_holds``, ``q_timings``, then the heads overrides on the
    trainer: the flagship at vit.heads 4 (hd 4 and 1) with ``pallas`` in
    float32 (K3_STEPS graphed steps, launches equal to the formula, held
    against its eager run; one eager ``xla`` step's losses within rtol TOL
    of its step 0) and in bf16 (``bf16_path``), and ``vit_som_tiny-imagenet.
    yaml`` at vit.heads 2 (hd 96 and 48) at full width (emb 192, B 512),
    depth cut from 12 to 2, with ``pallas`` in bf16. Returns (holds' errors,
    SOM error, timings, {path: launches})."""
    t0 = time.perf_counter()
    worst, som_err = q_holds(dev)
    t_holds = time.perf_counter() - t0
    timing = q_timings(dev)
    t_timing = time.perf_counter() - t0 - t_holds
    paths = {}
    label = "q_flagship_heads4_pallas"
    run = train_run(dev, label, "pallas", K3_STEPS, False, extra=Q_FLAGSHIP_HEADS, falls=False)
    check([hd for _, hd in model_head_dims(run[0])] == [4, 1], f"{label}: not hd 4 and 1")
    paths[label] = run[4]
    phase_graphed_vs_eager(dev, label, "pallas", run, smi, extra=Q_FLAGSHIP_HEADS)
    xla = train_run(dev, label + "_xla_step0", "xla", 1, False, extra=Q_FLAGSHIP_HEADS,
                    eager=True, falls=False)
    check_first_losses(label, run[3], {k: float(xla[3][k][0]) for k in FIRST_LOSSES})
    del run, xla
    torch.cuda.empty_cache()
    paths["q_flagship_heads4_bf16_pallas"] = bf16_path(
        dev, smi, "q_flagship_heads4_bf16_pallas", CONFIG, "pallas", Q_FLAGSHIP_HEADS)
    cut = load_config(TINY_CONFIG, Q_TINY)
    print(f"q_tiny_imagenet_heads2: {os.path.basename(TINY_CONFIG)} at vit.heads 2: emb "
          f"{cut.vit.emb_dim}, dec_emb {cut.vit.dec_emb_dim}, head dims "
          f"{[hd for _, hd in model_head_dims(cut)]}, B {cut.batch_size}; depth cut from "
          f"{load_config(TINY_CONFIG).vit.depth} to {cut.vit.depth} (dec_depth "
          f"{cut.vit.dec_depth} as shipped)", flush=True)
    paths["q_tiny_imagenet_heads2_bf16_pallas"] = bf16_path(
        dev, smi, "q_tiny_imagenet_heads2_bf16_pallas", TINY_CONFIG, "pallas", Q_TINY)
    print(f"phase Q: holds {t_holds:.1f} s, timings {t_timing:.1f} s, trainer paths "
          f"{time.perf_counter() - t0 - t_holds - t_timing:.1f} s, total "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    return worst, som_err, timing, paths


class PhaseClock:
    """Times groups of phases: ``clock(name)`` ends the group running,
    printing its host seconds, the total so far and the card's memory
    (allocated and reserved by the caching allocator, free on the card),
    and begins the group ``name``, which a failure names."""

    def __init__(self, name):
        self.t0 = self.last = time.perf_counter()
        self.name = name

    def __call__(self, name):
        now = time.perf_counter()
        memory = ""
        if torch.cuda.is_initialized():
            free, _ = torch.cuda.mem_get_info()
            memory = (f"; memory allocated {torch.cuda.memory_allocated() / 1e9:.2f} GB, "
                      f"reserved {torch.cuda.memory_reserved() / 1e9:.2f} GB, "
                      f"free {free / 1e9:.2f} GB")
        print(f"phase {self.name}: {now - self.last:.1f} s (total {now - self.t0:.1f} s)"
              + memory, flush=True)
        self.last = now
        self.name = name


def stop_processes():
    """Ends every process the smoke started that is still there: the
    interpreter waiting for a next profile, a host pool's workers left by
    a failed phase, then the fork server they came from and the resource
    tracker, which would otherwise end only after this process has."""
    import multiprocessing as mp
    from multiprocessing import forkserver, resource_tracker

    global _NEXT_PROFILE
    if _NEXT_PROFILE is not None:
        end_session(_NEXT_PROFILE)
        _NEXT_PROFILE = None

    for proc in mp.active_children():
        proc.terminate()
        proc.join(10)
        if proc.is_alive():
            proc.kill()
            proc.join()
    forkserver._forkserver._stop()
    resource_tracker._resource_tracker._stop()


def main() -> int:
    if not torch.cuda.is_available():
        print("FAIL: torch.cuda.is_available() is false", file=sys.stderr)
        return 1
    # a SIGTERM (a time limit) prints every thread's stack before it ends
    faulthandler.enable()
    faulthandler.register(signal.SIGTERM, chain=True)
    clock = PhaseClock("device")
    try:
        return run_smoke(clock)
    except Exception as e:  # noqa: BLE001 - named, printed, exit 1
        msg = f"FAIL in phase {clock.name}: {type(e).__name__}: {e}\n{traceback.format_exc()}"
        print(msg, flush=True)
        print(msg, file=sys.stderr, flush=True)
        return 1
    finally:
        stop_processes()


def run_smoke(clock) -> int:
    dev = resolve_device("cuda")
    smi = nvidia_smi_line()
    print(f"device: {torch.cuda.get_device_name(0)} count={torch.cuda.device_count()} "
          f"torch={torch.__version__} cuda={torch.version.cuda}", flush=True)
    print(f"nvidia-smi: {smi}", flush=True)

    clock("build")
    phase_build()
    clock("3-5, A")
    max_err = phase_kernel_vs_plain(dev)
    xla_first, flagship = phase_train(dev)
    phase_graphed_vs_eager(dev, "graph_xla", None, flagship, smi)
    timing = phase_timings(dev)
    clock("6-9")
    attn_err = phase_attention_vs_plain(dev)
    run = phase_train_attention(dev, "pallas", TRAIN_STEPS, True, xla_first)
    flagship_pallas = run[4]
    p7 = {"state": snapshot(run[2]), "hist": run[3], "step_ms": steady_ms(run[2].step_ms)}
    phase_graphed_vs_eager(dev, "graph_pallas", "pallas", run, smi)
    del run
    phase_train_attention(dev, "hybrid", HYBRID_STEPS, False, xla_first)
    attn_timing = phase_attention_timings(dev)
    clock("10-12")
    block_err = phase_block_vs_plain(dev)
    block_launches = phase_block_flagship(dev, flagship[2], flagship[1])
    block_timing = phase_block_timings(dev)
    clock("13")
    cifar, cifar_blocks = phase_train_cifar(dev)
    clock("M")
    m_paths = {"m1_flagship_dp_nccl_pallas": phase_dp_nccl(dev, p7, smi),
               "m2_flagship_dp_gloo_pallas_rank0": phase_dp_gloo(dev, smi)}
    del p7
    clock("D")
    cls_paths = phase_classification(dev, smi)
    clock("E")
    family_paths = phase_family(dev, smi)
    clock("F")
    phase_desom(dev, smi)
    clock("B, C")
    bench_ms = phase_bench(dev, smi)
    phase_profiles(smi)
    clock("G")
    protocol_paths = phase_protocol(dev, smi, clock)
    clock("H")
    baseline_paths = phase_baselines(dev, smi)
    clock("I")
    mobile_paths = phase_mobile_vit(dev, smi)
    clock("K1")
    k1_timing, k1_err = phase_attention_bf16(dev)
    clock("K2")
    k_paths = {"k2_flagship_bf16_pallas": phase_flagship_bf16(dev, smi)}
    clock("K3")
    k_paths["k3_tiny_imagenet_bf16_pallas"] = phase_tiny_bf16(dev, smi)
    clock("P")
    k_paths.update(phase_long_sequences(dev, smi))
    clock("K4")
    k4_paths = phase_baselines_bf16(dev, smi)
    clock("K5")
    k_paths["k5_bench_bf16_mu"] = phase_bench_bf16_mu(dev, smi, bench_ms)
    clock("Q")
    q_err, q_som_err, q_timing, q_paths = phase_head_dims(dev, smi)
    clock("kernels")

    # launches: phase G4's protocol run of vit_som_cifar-10 from its
    # pickles (pallas), the last path with these kernels on it and, by path,
    # every train run that launches the kernel and every phase-H run (Swin
    # and DeiT: no kernel is on their path, their counts are 0); the bf16
    # attention kernels' main path is K3, tiny-imagenet under bf16
    paths = {"flagship_xla": flagship[4], "flagship_pallas": flagship_pallas,
             "cifar10_clustering_pallas": cifar, "block_cifar10_vit_som": cifar_blocks, **m_paths, **cls_paths, **family_paths,
             **protocol_paths, **k_paths, **q_paths}
    main_path = protocol_paths["protocol_cifar10_pallas"]
    main_bf16 = k_paths["k3_tiny_imagenet_bf16_pallas"]

    # paths with no kernel on them, listed with their zeros
    kernel_free = {**baseline_paths, **mobile_paths, **k4_paths,
                   "eval_desom_kmeans": protocol_paths["eval_desom_kmeans"]}

    def by_path(name):
        out = {path: counts[name] for path, counts in paths.items() if counts.get(name)}
        out.update({path: counts.get(name, 0) for path, counts in kernel_free.items()})
        return out

    kernels = [{
        "name": "som_fused",
        "route": "cuda",
        "source": "vitsom_tpu_torch/ops/csrc/som_fused.cu",
        "replaces": "vitsom_tpu/ops/som_pallas.py:95",
        "launches": main_path["som_fused"],
        "launches_by_path": by_path("som_fused"),
        "max_abs_err": max(max_err, q_som_err),
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
    # the streamed design on the emb-192 path (phase 13b: vit_som_cifar-10's
    # 14 blocks), its error the largest of phase 10's streamed holds, its
    # times at the cifar-10 encoder block (phase 12)
    for name, base, replaces in (
            ("block_fwd_streamed", "block_fwd", "vitsom_tpu/ops/block_pallas.py:226"),
            ("block_bwd_streamed", "block_bwd", "vitsom_tpu/ops/block_pallas.py:235")):
        kernels.append({
            "name": name,
            "route": "cuda",
            "source": "vitsom_tpu_torch/ops/csrc/block_streamed.cu",
            "replaces": replaces,
            "path": "block_cifar10_vit_som",
            "shape": list(BLOCK_STREAMED_MAIN),
            "launches": cifar_blocks[name],
            "launches_by_path": by_path(name),
            "max_abs_err": block_err[name],
            **block_timing[(BLOCK_STREAMED_MAIN, base)],
        })
    for name, replaces in (("attention_fwd_bf16", "vitsom_tpu/ops/attention_pallas.py:100"),
                           ("attention_bwd_bf16", "vitsom_tpu/ops/attention_pallas.py:163")):
        kernels.append({
            "name": name,
            "route": "cuda",
            "source": "vitsom_tpu_torch/ops/csrc/attention_bf16.cu",
            "replaces": replaces,
            "launches": main_bf16[name],
            "launches_by_path": by_path(name),
            "max_abs_err": k1_err[name],
            **k1_timing[(K1_MAIN, name)],
        })
    # phase Q's designs on its trainer paths (the heads overrides): the
    # launches of the graphed run whose model runs them, the error and times
    # at the run's encoder shape, and the largest error of the design's holds
    for name, base, path, shape, design in (
            ("attention_fwd_q_rows", "attention_fwd", "q_flagship_heads4_pallas",
             (128, 197, 4, 4), ("float32", "rows")),
            ("attention_bwd_q_rows", "attention_bwd", "q_flagship_heads4_pallas",
             (128, 197, 4, 4), ("float32", "rows")),
            ("attention_fwd_bf16_q_hmma", "attention_fwd_bf16", "q_flagship_heads4_bf16_pallas",
             (128, 197, 4, 4), ("bfloat16", "hmma")),
            ("attention_bwd_bf16_q_hmma", "attention_bwd_bf16", "q_flagship_heads4_bf16_pallas",
             (128, 197, 4, 4), ("bfloat16", "hmma")),
            ("attention_fwd_bf16_q_wgmma2", "attention_fwd_bf16",
             "q_tiny_imagenet_heads2_bf16_pallas", (512, 257, 2, 96), ("bfloat16", "wgmma2")),
            ("attention_bwd_bf16_q_wgmma2", "attention_bwd_bf16",
             "q_tiny_imagenet_heads2_bf16_pallas", (512, 257, 2, 96), ("bfloat16", "wgmma2"))):
        side = "bwd" if "_bwd" in name else "fwd"
        kernels.append({
            "name": name,
            "route": "cuda",
            "source": ("vitsom_tpu_torch/ops/csrc/attention_bf16.cu" if base.endswith("_bf16")
                       else "vitsom_tpu_torch/ops/csrc/attention.cu"),
            "replaces": ("vitsom_tpu/ops/attention_pallas.py:163" if side == "bwd"
                         else "vitsom_tpu/ops/attention_pallas.py:100"),
            "path": path,
            "shape": list(shape),
            "launches": q_paths[path][base],
            **q_timing[(shape, base)],
            "holds_max_abs_err": q_err[(*design, side)],
        })
    clock("result")
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
