"""ViT-SOM, DESOM (clustering and classification), ViT, Swin, DeiT and
MobileViT trainer in PyTorch, and its command line.

Counterpart of ``vitsom_tpu/train/trainer.py`` and
``experiments/benchmarking/train.py`` for every ``model_arch``: ``vit_som``,
``desom``, ``vit``, ``swin``, ``deit`` and ``mobile_vit``. Clustering trains on the train + test concat and
evaluates purity and NMI there; classification (``data.num_classes > 0``)
trains on the 80/20 split (augmented on the device, or transformed once
where the train transform is static), validates after each epoch
(``best_val_accuracy``) and evaluates accuracy, precision, recall and F1
on the test split from the last state, saving the ``best`` checkpoint
whenever ``val/accuracy`` improves. DESOM's and MobileViT's BatchNorm
running averages are buffers of the model, moved in place by the train
step and read by the eval step. The TPU dispatch keys (``train.epochs_per_dispatch``,
``scan_splits``, ...) are read and ignored.

Each finished epoch logs the mean of each step metric and
``perf/images_per_sec_per_chip`` at the epoch's last step to a TensorBoard
event file under ``<log_dir>/<model_arch>/<dataset>/run_<id>``, with the
JAX trainer's tags; validation logs ``val/*`` at the same step, and DESOM
logs its input, reconstruction and decoded-prototype grids every
``train.log_images_every_n_epochs`` epochs.

Swin's drop-path and DeiT's dropout draw their masks inside the train step
from a CUDA generator the trainer owns (``_dropout``, seeded ``seed +
7919``; ``models/stochastic.py``). The trainer registers it with the
captured step (``CUDAGraph.register_generator_state``): each replay reads
the generator's seed and offset at its start and advances the offset by
what one step draws, so the replays draw the same masks as eager steps
from the same state, and no mask is drawn outside the graph. Swin trains
with its own lr schedule (``schedules.make_swin_lr_schedule_tensor``,
which is 0 for the first epoch); DeiT builds its frozen teacher in its
train step (``models/deit.py``).

Checkpoints (``save_checkpoint`` / ``restore_checkpoint``, at
``<checkpoint_dir>/<model_arch>/<dataset>_run<id>_<tag>``) hold the
parameters and buffers (DESOM's BatchNorm statistics), AdamW's moments,
step counts and lr tensors, the device step, the epoch's start, its
metrics rows, the data generators' states at the epoch's start and the
dropout generator's state at the save (``torch.save``; read with
``weights_only=True``), beside the config as
``vitsom_config.yaml``. A restore copies into the tensors the trainer
already holds, never rebinding one: a captured step reads its tensors at
fixed addresses, and would go on reading the old ones. The next ``fit``
refills the restored epoch from the saved generator states and continues
it from the restored step, so a restored run steps as the uninterrupted
one did, whether or not its step was already captured.

The JAX trainer compiles a whole epoch into one program (``_build_epoch_fn``:
one permutation and bulk gather of the epoch's batches, a ``lax.scan`` of
the train step, one dispatch). The port's counterpart on the card is a CUDA
graph of one train step:

1. at each epoch start, outside the graph, the epoch's shuffled batches are
   gathered into a fixed buffer (``DataModule.fill_epoch``; for
   classification each batch is augmented there, eagerly, with draws from
   a generator on the device, and its labels fill a second buffer) and the
   device state's ``epoch_start`` is set to the global step. Where the
   data module streams (``dm.streams``: a device-augmented epoch past
   ``pipeline.STREAM_BYTES``, or the host augmentation path), the fill
   only draws, and each batch reaches a one-batch buffer just before its
   step (``dm.stream_batch``): a replay of the captured augmentation, or
   the host path's next batch (seeded ``train.seed + 1000 * run_id``, as
   the JAX trainer's ``train_batches``) copied from pinned memory;
2. the first ``WARMUP_STEPS`` steps run eagerly on a side stream, which
   creates AdamW's moments and the cuBLAS workspaces (they are real steps,
   kept in the history);
3. the next step is captured once with ``torch.cuda.graph``: it reads its
   batch from the buffer at the device index ``step - epoch_start``,
   computes its schedules from the device step (``train/steps.py``), and
   writes its metrics into the device metrics buffer;
4. every later step is one replay of that graph: one launch in place of
   several hundred.

The host reads the metrics buffer once an epoch (the JAX loop's one pull a
dispatch). A failed capture raises; nothing falls back to the eager loop.
``fit(eager=True)`` runs the same step body eagerly on the card (the
reference the graphed run is held against), and on the CPU ``fit`` is
always eager.

Data parallelism (the counterpart of the JAX trainer's ``data`` mesh,
``parallel/``): launched by torchrun, or given a process group its caller
made, the trainer runs on ``world`` ranks, each on its card
(``cuda:LOCAL_RANK``) or the CPU. ``train.mesh_shape`` ``[n]`` must be the
world size and ``batch_size`` must split over it, else the trainer raises.
Every rank builds the same weights and draws the same permutations,
augmentation parameters and dropout masks; each takes its rows of every
global batch (``DataSpan``), averages the gradients over the ranks
before the optimizer's step, and writes the global batch's losses
(``train/steps.py``), so N ranks take the one-rank run's steps. On an
NCCL group the collectives are captured with the step (the communicator
created by one eager collective first); a gloo group trains eagerly. The
evaluation scores each rank's span and gathers the outputs
(``eval/evaluate.py``). Rank 0 alone writes checkpoints (between
barriers), events and the protocol's JSON; images/s a chip divide by the
world size:

    torchrun --nproc_per_node 2 -m vitsom_tpu_torch.train.trainer \\
        --config configs/vit_som/vit_som_mnist.yaml --synthetic --epochs 1

``main`` is the N-run protocol of ``experiments/benchmarking/train.py``:
for each run the state directory is cleared, the data module built and
the model trained inside the run's timed duration; a clustering run then
saves ``last``, restores it and evaluates purity and NMI from the restored
state, a classification run evaluates the in-memory model on the test
split; the end prints each metric's "Mean (Std)" over the runs
(``aggregate_runs``) and ``--json-out`` writes the harness's per-run
lists. Run on the card (the default device), from files:

    python -m vitsom_tpu_torch.train.trainer \\
        --config configs/vit_som/vit_som_mnist.yaml \\
        --override data.data_dir=/path/to/datasets --runs 5 --json-out runs.json

or on the synthetic stand-in:

    python -m vitsom_tpu_torch.train.trainer \\
        --config configs/vit_som/vit_som_mnist.yaml --synthetic --max-steps 30
    python -m vitsom_tpu_torch.train.trainer \\
        --config configs/vit_som/vit_som_cifar-10.yaml --synthetic --max-steps 30
    python -m vitsom_tpu_torch.train.trainer \\
        --config configs/desom/desom_mnist.yaml --synthetic --epochs 3
    python -m vitsom_tpu_torch.train.trainer \\
        --config configs/swin/swin_cifar-10.yaml --synthetic --epochs 2
    python -m vitsom_tpu_torch.train.trainer \\
        --config configs/deit/deit_cifar-10.yaml --synthetic --max-steps 30 \\
        --override data.data_dir=/path/with/resnet50.pth
"""

from __future__ import annotations

import argparse
import gc
import json
import os
import shutil
import time
import warnings
from typing import Dict, List, Optional

import numpy as np
import torch

from vitsom_tpu_torch.config import Config, config_from_dict, load_config
from vitsom_tpu_torch.data.synthetic import build_datamodule
from vitsom_tpu_torch.eval import evaluate as eval_lib
from vitsom_tpu_torch.eval.metrics import aggregate_runs
from vitsom_tpu_torch.models.deit import make_deit_train_step
from vitsom_tpu_torch.models.vit_som import build_model
from vitsom_tpu_torch.parallel import distributed as dist_lib
from vitsom_tpu_torch.parallel import mesh as mesh_lib
from vitsom_tpu_torch.som import layer as som
from vitsom_tpu_torch.train import optim, schedules
from vitsom_tpu_torch.train import steps as steps_lib
from vitsom_tpu_torch.utils.device import resolve_device
from vitsom_tpu_torch.utils.logging import MetricLogger

# eager steps before the capture: the first creates AdamW's moments, the
# second runs with every lazily created buffer and workspace in place
WARMUP_STEPS = 2
# the models whose train step draws dropout or drop-path masks
STOCHASTIC = ("swin", "deit")
DROPOUT_SEED_OFFSET = 7919  # the JAX package's dropout_base_key(train.seed + 7919)

# ---------------------------------------------------------------------------
# checkpoints: the embedded config (the reference's save_hyperparameters)
# ---------------------------------------------------------------------------

CKPT_CONFIG_FILE = "vitsom_config.yaml"
CKPT_STATE_FILE = "state.pt"

# fields that define the parameter structure: a mismatch is fatal
_STRUCTURAL_KEYS = ("model_arch", "som", "vit", "ae", "swin", "distillation")
_STRUCTURAL_DATA_KEYS = ("num_classes", "num_channels", "input_size")


def save_checkpoint_config(ckpt_path: str, cfg: Config) -> None:
    """Write the full config into the checkpoint directory, as the JAX
    package's ``save_checkpoint_config`` writes it."""
    import yaml

    with open(os.path.join(ckpt_path, CKPT_CONFIG_FILE), "w") as f:
        yaml.safe_dump(cfg.to_dict(), f)


def load_checkpoint_config(ckpt_path: str) -> Optional[Config]:
    """The config embedded in a checkpoint (None when it has none)."""
    import yaml

    path = os.path.join(ckpt_path, CKPT_CONFIG_FILE)
    if not os.path.exists(path):
        return None
    with open(path) as f:
        return config_from_dict(yaml.safe_load(f))


def check_checkpoint_config(ckpt_path: str, cfg: Config) -> None:
    """Raise when the checkpoint's embedded config differs from ``cfg`` on
    a field that defines the parameter structure; warn when it differs on
    the schedules' fields (``total_epochs``, ``batch_size``, ``gamma``,
    ``optimizer``), which change the run but not the structure."""
    saved = load_checkpoint_config(ckpt_path)
    if saved is None:
        return
    a, b = saved.to_dict(), cfg.to_dict()
    hard = [k for k in _STRUCTURAL_KEYS if a[k] != b[k]] + [
        f"data.{k}" for k in _STRUCTURAL_DATA_KEYS if a["data"][k] != b["data"][k]
    ]
    if hard:
        raise ValueError(
            f"checkpoint at {ckpt_path} was saved with a different model config "
            f"(mismatched: {', '.join(hard)}); refusing to restore"
        )
    soft = [k for k in ("total_epochs", "batch_size", "gamma", "optimizer") if a[k] != b[k]]
    if soft:
        warnings.warn(
            f"checkpoint config differs on non-structural fields ({', '.join(soft)}): "
            f"schedules (lr/temperature/gamma) derived from the current config will "
            f"not match the training run"
        )


def memory_state(device) -> Dict[str, int]:
    """The caching allocator's counters that bear on a capture (allocation
    retries, device frees where the build counts them, bytes reserved and
    allocated) and the card's free and total bytes."""
    stats = torch.cuda.memory_stats(device)
    free, total = torch.cuda.mem_get_info(device)
    keys = ("num_alloc_retries", "num_device_alloc", "num_device_free", "num_ooms",
            "reserved_bytes.all.current", "allocated_bytes.all.current")
    return {**{k: int(stats[k]) for k in keys if k in stats}, "free_bytes": int(free),
            "total_bytes": int(total)}


class Trainer:
    """Trains one ViT-SOM, DESOM, ViT, Swin or DeiT run on one device
    (default: the card), or its rank's part of it under data parallelism
    (module docstring).

    The weights come from ``train.seed + run_id`` through a
    ``torch.Generator``; the epoch permutations from a second generator with
    the same seed, the augmentation's draws from a third, on the device,
    with the same seed, and the dropout masks from a fourth, on the device,
    seeded ``seed + 7919``."""

    def __init__(self, cfg: Config, device="cuda", dm=None, run_id: int = 0):
        self.cfg = cfg
        self.device = resolve_device(device)
        # under torchrun: joins the process group (module docstring)
        dist_lib.maybe_initialize(self.device)
        self.device = dist_lib.local_device(self.device)
        self.world = mesh_lib.data_parallel_size(cfg)
        self.rank = dist_lib.process_index()
        self.dm = dm if dm is not None else build_datamodule(cfg, self.device)
        if self.world > 1:
            self.dm.shard(self.rank, self.world)
        if self.dm.steps_per_epoch < 1:
            raise ValueError(
                f"{self.dm.n_train} samples give no batch of {cfg.batch_size}"
            )
        seed = cfg.train.seed + run_id
        self.model = build_model(cfg, self.device, seed=seed)
        self.statics = steps_lib.StepStatics(
            self.dm.steps_per_epoch, cfg.total_epochs, self.dm.n_train, cfg.batch_size
        )
        make_schedule = (schedules.make_swin_lr_schedule_tensor if cfg.model_arch == "swin"
                         else schedules.make_lr_schedule_tensor)
        self.lr_schedule = make_schedule(
            cfg.optimizer, cfg.total_epochs, self.dm.steps_per_epoch,
            optim.base_learning_rate(cfg),
        )
        self._dropout = torch.Generator(device=self.device).manual_seed(
            seed + DROPOUT_SEED_OFFSET)
        self.optimizer = optim.make_optimizer(cfg, self.model)
        self.state = steps_lib.DeviceState(
            self.device, self.dm.steps_per_epoch, steps_lib.metric_keys(cfg)
        )
        if dist_lib.initialized():
            dist_lib.average_before_step(self.optimizer)
            self.state.average_losses()
        if cfg.model_arch in ("vit", "swin", "mobile_vit"):
            # the JAX trainer trains vit without label smoothing
            smoothing = cfg.optimizer.smoothing if cfg.model_arch != "vit" else 0.0
            self.train_step = steps_lib.make_classifier_train_step(
                cfg, self.model, self.optimizer, self.lr_schedule, smoothing, self.state,
                self._dropout if cfg.model_arch == "swin" else None,
            )
            self.eval_step = steps_lib.make_classifier_eval_step(cfg, self.model)
        elif cfg.model_arch == "deit":
            self.train_step = make_deit_train_step(
                cfg, self.model, self.optimizer, self.lr_schedule, self.state, self._dropout)
            self.eval_step = steps_lib.make_classifier_eval_step(cfg, self.model)
        elif cfg.model_arch == "desom":
            self.train_step = steps_lib.make_desom_train_step(
                cfg, self.model, self.optimizer, self.statics, self.lr_schedule, self.state
            )
            self.eval_step = steps_lib.make_desom_eval_step(cfg, self.model)
        else:
            self.train_step = steps_lib.make_vit_som_train_step(
                cfg, self.model, self.optimizer, self.statics, self.lr_schedule, self.state
            )
            self.eval_step = steps_lib.make_vit_som_eval_step(cfg, self.model)
        self.step = 0  # the host's count of the steps issued; state.step's value
        self.step_ms: List[float] = []
        # each epoch's fill_epoch (gather + augmentation); a streamed
        # epoch's draws and its batches' augmentation (stream_ms) summed
        self.fill_ms: List[float] = []
        # a streamed step's time before it: the augmentation replay, or the
        # device's wait for the host batch and its copy; and on the host
        # path the host ms the trainer waited for each batch
        self.stream_ms: List[float] = []
        self.host_wait_ms: List[float] = []
        self.val_history: List[Dict[str, float]] = []
        self.best_val_accuracy = -1.0
        self.graph: Optional[torch.cuda.CUDAGraph] = None
        self.capture_memory: Optional[Dict[str, int]] = None  # memory_state() at the capture
        self._warm = 0
        self.epoch_images = self.dm.epoch_buffer()
        self._shuffle = torch.Generator().manual_seed(seed)
        self._augment = torch.Generator(device=self.device).manual_seed(seed)
        self._epoch_pos = self.dm.steps_per_epoch  # steps run from the epoch buffer
        self.epochs_done = 0
        self.run_id = run_id
        # the host path's batches are a function of (seed, epoch, batch)
        self.host_seed = cfg.train.seed + 1000 * run_id
        self._epoch_index = -1  # the current epoch's number, counted at its fill
        # rank 0 writes the events; the others keep the history only
        self.logger = MetricLogger(os.path.join(
            cfg.train.log_dir, cfg.model_arch, cfg.data.dataset, f"run_{run_id}")
            if dist_lib.is_primary() else None)
        # the data generators' states at the current epoch's fill (what a
        # checkpoint keeps), the host time of that fill, and the states of a
        # restored checkpoint, from which the next fit refills its epoch
        self._epoch_rng = self._rng_states()
        self._epoch_t0 = time.perf_counter()
        self._resume = None

    def current_temperature(self) -> float:
        return som.temperature_schedule(
            self.step, self.statics.total_iterations_float,
            self.cfg.som.t_max, self.cfg.som.t_min,
        )

    def _rng_states(self):
        return self._shuffle.get_state(), self._augment.get_state()

    def _fill(self, start: int = 0) -> None:
        """The current epoch's fill (module docstring), the host path's
        stream starting at batch ``start``."""
        if self.dm.host:
            self.dm.start_host_epoch(self._epoch_index, self.host_seed, start)
        else:
            self.dm.fill_epoch(self._shuffle, self.epoch_images, self._augment)

    def _buffered_step(self):
        """The step body on the epoch buffer's batch ``step - epoch_start``:
        what the eager loop calls and what the graph captures."""
        return self.train_step(self.dm.epoch_batch(self.epoch_images, self.state.row()))

    def _warm_up_step(self) -> None:
        side = torch.cuda.Stream(self.device)
        side.wait_stream(torch.cuda.current_stream(self.device))
        with torch.cuda.stream(side):
            self._buffered_step()
        torch.cuda.current_stream(self.device).wait_stream(side)
        self._warm += 1

    def _capture(self) -> None:
        """Captures one step; the capture runs nothing. A step that cannot
        be captured raises here, with the card's memory state before and
        after the capture in its message.

        Before it: dead Python cycles are collected, so no CUDA object they
        hold is freed by the collector inside the capture (torch's graph
        context no longer collects by default), and the card is synchronised
        and the allocator's free cached blocks returned, as the graph
        context does too; ``capture_memory`` then records what the capture
        starts from."""
        self.optimizer.zero_grad(set_to_none=True)
        dist_lib.warm_up(self.device)
        gc.collect()
        torch.cuda.synchronize(self.device)
        torch.cuda.empty_cache()
        self.capture_memory = memory_state(self.device)
        graph = torch.cuda.CUDAGraph()
        if self.cfg.model_arch in STOCHASTIC:
            # each replay draws from the generator's state at its start
            graph.register_generator_state(self._dropout)
        try:
            with torch.cuda.graph(graph):
                self._buffered_step()
        except RuntimeError as e:
            raise RuntimeError(
                f"capturing the {self.cfg.model_arch} step failed; memory before the capture: "
                f"{self.capture_memory}, after: {memory_state(self.device)}") from e
        self.graph = graph

    def _graphed_step(self) -> None:
        if self._warm < WARMUP_STEPS:
            self._warm_up_step()
            return
        if self.graph is None:
            self._capture()
        self.graph.replay()

    def fit(self, max_steps: Optional[int] = None, eager: bool = False,
            new_epoch: bool = True) -> Dict[str, np.ndarray]:
        """Train for ``total_epochs`` epochs, or until the global step count
        reaches ``max_steps``. Returns the per-step metrics as arrays
        (``metric_keys(cfg)``). For classification, each epoch that runs to
        its end is followed by validation (``validate``).

        On the card the steps run as replays of one captured step (module
        docstring); ``eager=True`` calls the same step body eagerly, step by
        step. On the CPU the steps always run eagerly. A call starts a new
        epoch; with ``new_epoch=False`` it first runs the rest of the
        current one (``profile_step`` times steps without an epoch fill).

        ``self.step_ms`` gets each step's time: on the card, the device time
        between the ends of consecutive steps (CUDA events, no per-step
        synchronisation); on the CPU, the host time of the step. The epoch
        fills (gather, augmentation) and validation fall outside them;
        ``self.fill_ms`` gets each fill's time on the same clock. Where the
        epoch streams, a step's time starts when its batch is in place,
        ``self.stream_ms`` gets the time before it, and the epoch's
        ``fill_ms`` entry adds them up.

        After ``restore_checkpoint`` the call first refills the restored
        epoch from the saved generator states (outside the timings) and
        continues it from the restored step. Each finished epoch logs its
        metrics (module docstring)."""
        cfg = self.cfg
        self.model.train()
        cuda = self.device.type == "cuda"
        graphed = cuda and not eager and dist_lib.capturable()
        spe = self.dm.steps_per_epoch
        streams = self.dm.streams
        rows, step_marks = [], []
        keys = self.state.keys
        log_every = max(1, cfg.train.log_every_n_steps)
        fills = 0
        if self._resume is not None:
            fills = self._refill_restored_epoch()
            new_epoch = False
        while True:
            fill = new_epoch or self._epoch_pos >= spe
            n = spe if fill else spe - self._epoch_pos
            if max_steps is not None:
                n = min(n, max_steps - self.step)
            if n <= 0 or (fill and fills == cfg.total_epochs):
                break
            new_epoch = False
            marks = [_mark(cuda)]
            fill_mark = None
            if fill:
                self._epoch_rng = self._rng_states()
                self._epoch_t0 = time.perf_counter()
                self._epoch_index += 1
                self._fill()
                self.state.epoch_start.fill_(self.step)
                self._epoch_pos = 0
                fills += 1
                fill_mark = marks[0]
                marks = [_mark(cuda)]
            first, first_row = self.step, self._epoch_pos
            ready = []  # where streamed, each step's batch in place
            for i in range(n):
                if streams:
                    t0 = time.perf_counter()
                    self.dm.stream_batch(first_row + i, self.epoch_images)
                    if self.dm.host:
                        self.host_wait_ms.append((time.perf_counter() - t0) * 1e3)
                    ready.append(_mark(cuda))
                if graphed:
                    self._graphed_step()
                else:
                    self._buffered_step()
                marks.append(_mark(cuda))
                self.step += 1
            self._epoch_pos += n
            step_marks.append((fill_mark, marks, ready))
            # one device-to-host read a call and epoch (a copy: on the CPU
            # the next epoch overwrites the buffer)
            epoch_rows = self.state.metrics[first_row:first_row + n].to("cpu", copy=True).numpy()
            rows.append(epoch_rows)
            for i in range(n):
                if (first + i) % log_every == 0:
                    shown = {k: round(v, 6)
                             for k, v in steps_lib.metrics_dict(epoch_rows[i], keys).items()}
                    print(f"step {first + i}: {shown}", flush=True)
            if self._epoch_pos == spe:
                self.epochs_done += 1
                epoch_all = (epoch_rows if first_row == 0
                             else self.state.metrics[:spe].to("cpu", copy=True).numpy())
                self._log_epoch(epoch_all)
                self._maybe_log_images(self.epochs_done - 1)
                if cfg.classification:
                    self.validate(self.epochs_done - 1)
        if cuda:
            torch.cuda.synchronize(self.device)
        self.logger.flush()
        for fill_mark, marks, ready in step_marks:
            if fill_mark is not None:
                self.fill_ms.append(_elapsed_ms(fill_mark, marks[0], cuda))
            if ready:
                waits = [_elapsed_ms(a, b, cuda) for a, b in zip(marks, ready)]
                self.stream_ms += waits
                if not self.fill_ms:  # an epoch restored from a checkpoint
                    self.fill_ms.append(0.0)
                self.fill_ms[-1] += sum(waits)
                self.step_ms += [_elapsed_ms(a, b, cuda) for a, b in zip(ready, marks[1:])]
            else:
                self.step_ms += [_elapsed_ms(a, b, cuda) for a, b in zip(marks, marks[1:])]
        return steps_lib.stack_metrics(rows, keys)

    def validate(self, epoch: int) -> Optional[Dict[str, float]]:
        """After epoch ``epoch`` (0-based) of a classification run, every
        ``train.eval_every_n_epochs`` epochs: ``validation_metrics`` on the
        val split at the current temperature; updates
        ``best_val_accuracy`` and appends to ``val_history`` (with the
        host seconds it took; the first call includes the val split's
        transform); logs the ``val/*`` scalars at the current step and, when
        ``val/accuracy`` beats every earlier validation, saves the state as
        the ``best`` checkpoint, as the JAX trainer's ``_maybe_validate``."""
        if (epoch + 1) % self.cfg.train.eval_every_n_epochs != 0:
            return None
        self.model.eval()
        t0 = time.perf_counter()
        scalars = eval_lib.validation_metrics(
            self.eval_step, self.dm, "val", self.current_temperature()
        )
        seconds = time.perf_counter() - t0  # the metrics' host copy waits for the device
        self.model.train()
        self.logger.log_scalars(scalars, step=self.step)
        if scalars["val/accuracy"] > self.best_val_accuracy:
            self.best_val_accuracy = scalars["val/accuracy"]
            self.save_checkpoint(tag="best")
        self.val_history.append({"epoch": epoch, "step": self.step, "seconds": seconds,
                                 **scalars})
        print(f"validation epoch {epoch}: " + ", ".join(
            f"{k}={v:.6f}" for k, v in scalars.items()), flush=True)
        return scalars

    def evaluate(self) -> Dict[str, float]:
        """From the current state: purity and NMI of the BMUs over the
        clustering split, or, for classification, accuracy, precision,
        recall and F1 over the test split, after the cached val split is
        released (the test split is transformed in its place)."""
        self.model.eval()
        try:
            if self.cfg.classification:
                self.dm.release("val")
                acc, prec, rec, f1, dt = eval_lib.evaluate_classification(
                    self.eval_step, self.dm, "test", self.current_temperature()
                )
                return {"accuracy": acc, "precision": prec, "recall": rec, "f1": f1,
                        "inference_time": dt}
            p, n, dt = eval_lib.evaluate_clustering(
                self.eval_step, self.dm, self.current_temperature()
            )
            return {"purity": p, "nmi": n, "inference_time": dt}
        finally:
            self.model.train()

    # -- logging ---------------------------------------------------------------

    def _log_epoch(self, rows: np.ndarray) -> None:
        """The epoch's mean of each step metric and its images a second
        (the epoch's images over the host time from its fill to its
        metrics' read), at the epoch's last step, as the JAX trainer logs a
        dispatch of one epoch."""
        seconds = time.perf_counter() - self._epoch_t0
        means = rows.astype(np.float64).mean(axis=0)
        scalars = {k: float(v) for k, v in zip(self.state.keys, means)}
        scalars["perf/images_per_sec_per_chip"] = (
            self.dm.steps_per_epoch * self.cfg.batch_size / seconds / self.world)
        self.logger.log_scalars(scalars, step=self.step)

    def _maybe_log_images(self, epoch: int) -> None:
        """DESOM's input, reconstruction and decoded-prototype grids (the
        first 16 train images, unshuffled) every
        ``train.log_images_every_n_epochs`` epochs, as the JAX trainer's
        ``_maybe_log_images``."""
        cfg = self.cfg
        every = cfg.train.log_images_every_n_epochs
        if cfg.model_arch != "desom" or every <= 0 or (epoch + 1) % every != 0:
            return
        s, c = cfg.data.input_size, cfg.data.num_channels
        images = self.dm.train_images if cfg.classification else self.dm.images
        n_show = min(16, images.shape[0])
        x = images[:n_show].reshape(n_show, -1)
        with torch.no_grad():
            decoded = self.model.forward_with_recon(x)[4].cpu().numpy()
            protos = self.model.decode(self.model.prototypes).cpu().numpy()

        def grid(flat, rows, cols):
            imgs = np.clip(flat.reshape(-1, s, s, c), 0.0, 1.0)[: rows * cols]
            canvas = np.zeros((rows * s, cols * s, c), np.float32)
            for i in range(min(len(imgs), rows * cols)):
                r, cl = divmod(i, cols)
                canvas[r * s:(r + 1) * s, cl * s:(cl + 1) * s] = imgs[i]
            return canvas

        self.logger.log_image("images/input", grid(x.cpu().numpy(), 4, 4), self.step)
        self.logger.log_image("images/reconstruction", grid(decoded, 4, 4), self.step)
        rows, cols = cfg.som.map_size
        self.logger.log_image("images/decoded_prototypes", grid(protos, rows, cols), self.step)

    # -- checkpoints -----------------------------------------------------------

    def checkpoint_dir(self, tag: str) -> str:
        return os.path.abspath(os.path.join(
            self.cfg.train.checkpoint_dir, self.cfg.model_arch,
            f"{self.cfg.data.dataset}_run{self.run_id}_{tag}"))

    def save_checkpoint(self, tag: str = "last", params=None, batch_stats=None) -> str:
        """Write the trainer's state (module docstring) and the config to
        ``checkpoint_dir(tag)``; returns the directory. ``params`` /
        ``batch_stats`` ({name: tensor} of the parameters / buffers)
        replace the model's own, as in the JAX trainer; the optimizer state
        and the step always come from the trainer."""
        path = self.checkpoint_dir(tag)
        # rank 0 writes, between barriers: no rank reads a half-written one
        dist_lib.barrier()
        if dist_lib.is_primary():
            self._write_checkpoint(path, params, batch_stats)
        dist_lib.barrier()
        return path

    def _write_checkpoint(self, path: str, params, batch_stats) -> None:
        os.makedirs(path, exist_ok=True)
        model = dict(self.model.state_dict())
        model.update(params or {})
        model.update(batch_stats or {})
        shuffle, augment = self._epoch_rng
        payload = {
            "model": model,
            "optimizer": self.optimizer.state_dict(),
            "step": self.state.step,
            "epoch_start": self.state.epoch_start,
            "metrics": self.state.metrics,
            "shuffle_rng": shuffle,
            "augment_rng": augment,
            "epoch_index": self._epoch_index,
            # consumed a step, so kept as it is now, not at the epoch's fill
            "dropout_rng": self._dropout.get_state(),
        }
        # a whole file or none: written beside, then renamed
        tmp = os.path.join(path, f"{CKPT_STATE_FILE}.{os.getpid()}.tmp")
        torch.save(payload, tmp)
        os.replace(tmp, os.path.join(path, CKPT_STATE_FILE))
        save_checkpoint_config(path, self.cfg)

    def restore_checkpoint(self, tag: str = "last", path: Optional[str] = None) -> None:
        """Copy a checkpoint (``path``, or ``checkpoint_dir(tag)``) into the
        trainer's own tensors: parameters and buffers, AdamW's moments,
        step counts and lr tensors (created here when the optimizer has not
        stepped yet), the device step, epoch start and metrics rows; sets
        the host step. Raises on a structural config mismatch
        (``check_checkpoint_config``)."""
        path = path or self.checkpoint_dir(tag)
        check_checkpoint_config(path, self.cfg)
        ck = torch.load(os.path.join(path, CKPT_STATE_FILE), map_location=self.device,
                        weights_only=True)
        with torch.no_grad():
            own = self.model.state_dict()
            if set(own) != set(ck["model"]):
                raise ValueError(f"checkpoint at {path} holds other tensors than the model")
            for name, t in own.items():
                t.copy_(ck["model"][name])
            self._restore_optimizer(ck["optimizer"])
            for name in ("step", "epoch_start", "metrics"):
                getattr(self.state, name).copy_(ck[name])
        # set in place: a captured step holds this generator's state
        self._dropout.set_state(ck["dropout_rng"].cpu())
        self.step = int(ck["step"])
        self.epochs_done = self.step // self.dm.steps_per_epoch
        epoch_start = int(ck["epoch_start"])
        self._resume = (ck["shuffle_rng"].cpu(), ck["augment_rng"].cpu(), epoch_start,
                        int(ck.get("epoch_index", epoch_start // self.dm.steps_per_epoch)))

    def _restore_optimizer(self, saved: Dict) -> None:
        """AdamW's state copied into its existing tensors, parameter by
        parameter in group order; a parameter without state yet gets copies
        of the saved tensors, on the devices AdamW keeps them on (the step
        count on the card only when capturable)."""
        groups = self.optimizer.param_groups
        if len(groups) != len(saved["param_groups"]):
            raise ValueError("checkpoint has other optimizer groups than the trainer")
        for group, sg in zip(groups, saved["param_groups"]):
            if len(group["params"]) != len(sg["params"]):
                raise ValueError("checkpoint has other optimizer groups than the trainer")
            group["lr"].copy_(sg["lr"])
            for p, idx in zip(group["params"], sg["params"]):
                own = self.optimizer.state[p]
                if idx not in saved["state"]:
                    # saved before its first step: zero moments and count
                    # are what AdamW would create
                    for value in own.values():
                        value.zero_()
                    continue
                for key, value in saved["state"][idx].items():
                    if key in own:
                        own[key].copy_(value)
                    elif key == "step":
                        own[key] = value.to(p.device if group["capturable"] else "cpu",
                                            torch.float32, copy=True)
                    else:
                        own[key] = value.to(p.device, copy=True)

    def _refill_restored_epoch(self) -> int:
        """Refill the restored checkpoint's epoch into the epoch buffer from
        its saved generator states (on the host path: restart its stream at
        the restored batch) and place the next step at its restored row;
        returns the epochs begun, the restored one included."""
        shuffle, augment, epoch_start, self._epoch_index = self._resume
        self._resume = None
        self._shuffle.set_state(shuffle)
        self._augment.set_state(augment)
        self._epoch_rng = self._rng_states()
        self._epoch_t0 = time.perf_counter()
        self._epoch_pos = self.step - epoch_start
        self._fill(start=self._epoch_pos)
        return epoch_start // self.dm.steps_per_epoch + 1


def _mark(cuda: bool):
    if cuda:
        ev = torch.cuda.Event(enable_timing=True)
        ev.record()
        return ev
    return time.perf_counter()


def _elapsed_ms(a, b, cuda: bool) -> float:
    return a.elapsed_time(b) if cuda else (b - a) * 1e3


def clear_directory(directory: str) -> None:
    """Remove ``directory`` with everything in it and create it empty."""
    if os.path.exists(directory):
        shutil.rmtree(directory)
    os.makedirs(directory, exist_ok=True)


PROTOCOL_KEYS = ("accuracy", "precision", "recall", "f1", "purity", "nmi", "run_duration",
                 "inference_time", "images_per_sec_per_chip", "peak_memory_gb")


def main(argv=None):
    """The N-run protocol (module docstring). Prints one JSON line a run
    and the aggregate; returns the runs' JSON dicts."""
    parser = argparse.ArgumentParser(
        description="vitsom-tpu PyTorch trainer (ViT-SOM and DESOM clustering and "
                    "classification, ViT, Swin, DeiT): the N-run train/eval protocol")
    parser.add_argument("--config", type=str, required=True)
    parser.add_argument("--runs", type=int, default=None, help="override train.n_runs")
    parser.add_argument("--epochs", type=int, default=None, help="override total_epochs")
    parser.add_argument("--batch-size", type=int, default=None)
    parser.add_argument("--synthetic", action="store_true",
                        help="use the synthetic stand-in where the dataset files are missing")
    parser.add_argument("--override", action="append", default=[],
                        help="dotted config override key=value (yaml-parsed)")
    parser.add_argument("--max-steps", type=int, default=None,
                        help="stop each run after this many train steps")
    parser.add_argument("--device", type=str, default="cuda",
                        help="torch device: a card on a multi-card host (cuda:1), "
                             "or cpu for a cut-down run")
    parser.add_argument("--json-out", type=str, default=None,
                        help="write each protocol metric's per-run values here")
    args = parser.parse_args(argv)

    import yaml

    overrides = {}
    if args.epochs is not None:
        overrides["total_epochs"] = args.epochs
    if args.batch_size is not None:
        overrides["batch_size"] = args.batch_size
    if args.runs is not None:
        overrides["train.n_runs"] = args.runs
    if args.synthetic:
        overrides["data.allow_synthetic"] = True
    for ov in args.override:
        k, _, v = ov.partition("=")
        overrides[k] = yaml.safe_load(v)
    cfg = load_config(args.config, overrides=overrides)
    device = resolve_device(args.device)
    dist_lib.maybe_initialize(device)
    device = dist_lib.local_device(device)
    world = mesh_lib.data_parallel_size(cfg)
    cuda = device.type == "cuda"
    n_runs, dataset = cfg.train.n_runs, cfg.data.dataset
    print(f"model={cfg.model_arch} dataset={dataset} epochs={cfg.total_epochs} "
          f"batch={cfg.batch_size} runs={n_runs} cls={cfg.classification}", flush=True)

    all_metrics = {k: [] for k in PROTOCOL_KEYS}
    states_dir = os.path.join(cfg.train.checkpoint_dir, cfg.model_arch)
    results = []
    for run_id in range(n_runs):
        print(f"Starting run {run_id + 1} for {dataset}...", flush=True)
        if cuda:
            torch.cuda.reset_peak_memory_stats(device)
        start = time.perf_counter()
        dist_lib.barrier()
        if dist_lib.is_primary():
            clear_directory(states_dir)
        dist_lib.barrier()
        dm = build_datamodule(cfg, device)
        trainer = Trainer(cfg, device=device, dm=dm, run_id=run_id)
        t_fit = time.perf_counter()
        hist = trainer.fit(max_steps=args.max_steps)  # ends in a synchronize on the card
        fit_seconds = time.perf_counter() - t_fit
        run_duration = time.perf_counter() - start
        print(f"Run {run_id + 1} duration: {run_duration:.2f} seconds", flush=True)
        if cfg.classification:
            res = trainer.evaluate()
        else:
            # the reference's clustering protocol: save last, reload, evaluate
            trainer.save_checkpoint(tag="last")
            trainer.restore_checkpoint(tag="last")
            res = trainer.evaluate()
        trainer.logger.close()
        for k in ("accuracy", "precision", "recall", "f1", "purity", "nmi", "inference_time"):
            if k in res:
                all_metrics[k].append(res[k])
        all_metrics["run_duration"].append(run_duration)
        all_metrics["images_per_sec_per_chip"].append(
            trainer.step * cfg.batch_size / fit_seconds / world)
        if cuda:  # the CPU has no peak counter: the key is left out
            all_metrics["peak_memory_gb"].append(torch.cuda.max_memory_allocated(device) / 1e9)
        step_ms = float(np.median(trainer.step_ms)) if trainer.step_ms else float("nan")
        loss = "train/cls_loss" if cfg.classification else "train/recon_loss"
        res.update({
            "run": run_id,
            "steps": trainer.step,
            f"first_{loss[6:]}": float(hist[loss][0]),
            f"last_{loss[6:]}": float(hist[loss][-1]),
            "median_step_ms": step_ms,
            "fill_ms_per_epoch": trainer.fill_ms,
            "best_val_accuracy": trainer.best_val_accuracy,
            "images_per_sec": cfg.batch_size / step_ms * 1e3,
            "run_seconds": run_duration,
            "device": str(torch.cuda.get_device_name(device) if cuda else "cpu"),
        })
        print(json.dumps(res), flush=True)
        results.append(res)
        dm.close()
        del trainer, dm  # the next run's peak memory counts its own tensors only

    agg = aggregate_runs(all_metrics)
    if n_runs > 1:
        print(f"\n--- Aggregated Results Across {n_runs} Runs for {dataset} ---")
    for key, (mean, std) in agg.items():
        if key in ("run_duration", "inference_time"):
            print(f"Avg {key.capitalize()} (Std): {mean:.2f}s ({std:.2f}s)")
        else:
            print(f"{key.capitalize()} Mean (Std): {mean:.4f} ({std:.4f})")
    summary = {k: agg[k] for k in (("accuracy", "f1") if cfg.classification else ("purity", "nmi"))}
    print(json.dumps({"runs": len(results), "mean_std": summary}), flush=True)
    if args.json_out and dist_lib.is_primary():
        with open(args.json_out, "w") as f:
            json.dump({k: list(map(float, v)) for k, v in all_metrics.items() if v}, f, indent=2)
    return results


if __name__ == "__main__":
    main()
