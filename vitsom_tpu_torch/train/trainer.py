"""ViT-SOM, DESOM (clustering and classification) and ViT-classifier
trainer in PyTorch, and its command line.

Counterpart of ``vitsom_tpu/train/trainer.py`` and
``experiments/benchmarking/train.py`` for ``model_arch`` ``vit_som``,
``desom`` and ``vit``. Clustering trains on the train + test concat and
evaluates purity and NMI there; classification (``data.num_classes > 0``)
trains on the 80/20 split (augmented on the device, or transformed once
where the train transform is static), validates after each epoch
(``best_val_accuracy``) and evaluates accuracy, precision, recall and F1
on the test split from the last state. DESOM's BatchNorm running averages
are buffers of the model, moved in place by the train step and read by the
eval step. Checkpoints (and so the save of the best validation state),
TensorBoard (and so DESOM's image grids, ``train.log_images_every_n_epochs``)
and the multi-run harness's aggregation files are later slices of the port;
their config keys are read and ignored, as are the TPU dispatch keys
(``train.epochs_per_dispatch``, ``scan_splits``, ...).

The JAX trainer compiles a whole epoch into one program (``_build_epoch_fn``:
one permutation and bulk gather of the epoch's batches, a ``lax.scan`` of
the train step, one dispatch). The port's counterpart on the card is a CUDA
graph of one train step:

1. at each epoch start, outside the graph, the epoch's shuffled batches are
   gathered into a fixed buffer (``DataModule.fill_epoch``; for
   classification each batch is augmented there, eagerly, with draws from
   a generator on the device, and its labels fill a second buffer) and the
   device state's ``epoch_start`` is set to the global step;
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

Run on the card (the default device):

    python -m vitsom_tpu_torch.train.trainer \\
        --config configs/vit_som/vit_som_mnist.yaml --synthetic --max-steps 30
    python -m vitsom_tpu_torch.train.trainer \\
        --config configs/vit_som/vit_som_cifar-10.yaml --synthetic --max-steps 30
    python -m vitsom_tpu_torch.train.trainer \\
        --config configs/desom/desom_mnist.yaml --synthetic --epochs 3
"""

from __future__ import annotations

import argparse
import json
import time
from typing import Dict, List, Optional

import numpy as np
import torch

from vitsom_tpu_torch.config import Config, load_config
from vitsom_tpu_torch.data.synthetic import build_datamodule
from vitsom_tpu_torch.eval import evaluate as eval_lib
from vitsom_tpu_torch.models.vit_som import build_model
from vitsom_tpu_torch.som import layer as som
from vitsom_tpu_torch.train import optim, schedules
from vitsom_tpu_torch.train import steps as steps_lib
from vitsom_tpu_torch.utils.device import resolve_device

# eager steps before the capture: the first creates AdamW's moments, the
# second runs with every lazily created buffer and workspace in place
WARMUP_STEPS = 2


class Trainer:
    """Trains one ViT-SOM, DESOM or ViT-classifier run on one device
    (default: the card).

    The weights come from ``train.seed + run_id`` through a
    ``torch.Generator``; the epoch permutations from a second generator with
    the same seed, and the augmentation's draws from a third, on the
    device, with the same seed."""

    def __init__(self, cfg: Config, device="cuda", dm=None, run_id: int = 0):
        if cfg.model_arch not in ("vit_som", "vit", "desom"):
            raise NotImplementedError(
                f"the port trains vit_som, desom and vit (later slices: the other "
                f"baselines), not {cfg.model_arch}"
            )
        self.cfg = cfg
        self.device = resolve_device(device)
        self.dm = dm if dm is not None else build_datamodule(cfg, self.device)
        if self.dm.steps_per_epoch < 1:
            raise ValueError(
                f"{self.dm.n_train} samples give no batch of {cfg.batch_size}"
            )
        seed = cfg.train.seed + run_id
        self.model = build_model(cfg, self.device, seed=seed)
        self.statics = steps_lib.StepStatics(
            self.dm.steps_per_epoch, cfg.total_epochs, self.dm.n_train, cfg.batch_size
        )
        self.lr_schedule = schedules.make_lr_schedule_tensor(
            cfg.optimizer, cfg.total_epochs, self.dm.steps_per_epoch,
            optim.base_learning_rate(cfg),
        )
        self.optimizer = optim.make_optimizer(cfg, self.model)
        self.state = steps_lib.DeviceState(
            self.device, self.dm.steps_per_epoch, steps_lib.metric_keys(cfg)
        )
        if cfg.model_arch == "vit":
            # the JAX trainer trains vit without label smoothing
            self.train_step = steps_lib.make_classifier_train_step(
                cfg, self.model, self.optimizer, self.lr_schedule, 0.0, self.state
            )
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
        self.fill_ms: List[float] = []  # each epoch's fill_epoch (gather + augmentation)
        self.val_history: List[Dict[str, float]] = []
        self.best_val_accuracy = -1.0
        self.graph: Optional[torch.cuda.CUDAGraph] = None
        self._warm = 0
        self.epoch_images = self.dm.epoch_buffer()
        self._shuffle = torch.Generator().manual_seed(seed)
        self._augment = torch.Generator(device=self.device).manual_seed(seed)
        self._epoch_pos = self.dm.steps_per_epoch  # steps run from the epoch buffer
        self.epochs_done = 0

    def current_temperature(self) -> float:
        return som.temperature_schedule(
            self.step, self.statics.total_iterations_float,
            self.cfg.som.t_max, self.cfg.som.t_min,
        )

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
        be captured raises here."""
        self.optimizer.zero_grad(set_to_none=True)
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            self._buffered_step()
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
        ``self.fill_ms`` gets each fill's time on the same clock."""
        cfg = self.cfg
        self.model.train()
        cuda = self.device.type == "cuda"
        graphed = cuda and not eager
        spe = self.dm.steps_per_epoch
        rows, step_marks, fill_marks = [], [], []
        keys = self.state.keys
        log_every = max(1, cfg.train.log_every_n_steps)
        fills = 0
        while True:
            fill = new_epoch or self._epoch_pos >= spe
            n = spe if fill else spe - self._epoch_pos
            if max_steps is not None:
                n = min(n, max_steps - self.step)
            if n <= 0 or (fill and fills == cfg.total_epochs):
                break
            new_epoch = False
            marks = [_mark(cuda)]
            if fill:
                self.dm.fill_epoch(self._shuffle, self.epoch_images, self._augment)
                self.state.epoch_start.fill_(self.step)
                self._epoch_pos = 0
                fills += 1
                marks.append(_mark(cuda))
                fill_marks.append(marks[:])
            first, first_row = self.step, self._epoch_pos
            for _ in range(n):
                if graphed:
                    self._graphed_step()
                else:
                    self._buffered_step()
                marks.append(_mark(cuda))
                self.step += 1
            self._epoch_pos += n
            step_marks.append(marks[-n - 1:])
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
                if cfg.classification:
                    self.validate(self.epochs_done - 1)
        if cuda:
            torch.cuda.synchronize(self.device)
        for a, b in fill_marks:
            self.fill_ms.append(_elapsed_ms(a, b, cuda))
        for marks in step_marks:
            self.step_ms += [_elapsed_ms(a, b, cuda) for a, b in zip(marks, marks[1:])]
        return steps_lib.stack_metrics(rows, keys)

    def validate(self, epoch: int) -> Optional[Dict[str, float]]:
        """After epoch ``epoch`` (0-based) of a classification run, every
        ``train.eval_every_n_epochs`` epochs: ``validation_metrics`` on the
        val split at the current temperature; updates
        ``best_val_accuracy`` and appends to ``val_history`` (with the
        host seconds it took; the first call includes the val split's
        transform). The save of
        the best state waits for checkpoints in the port."""
        if (epoch + 1) % self.cfg.train.eval_every_n_epochs != 0:
            return None
        self.model.eval()
        t0 = time.perf_counter()
        scalars = eval_lib.validation_metrics(
            self.eval_step, self.dm, "val", self.current_temperature()
        )
        seconds = time.perf_counter() - t0  # the metrics' host copy waits for the device
        self.model.train()
        self.best_val_accuracy = max(self.best_val_accuracy, scalars["val/accuracy"])
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


def _mark(cuda: bool):
    if cuda:
        ev = torch.cuda.Event(enable_timing=True)
        ev.record()
        return ev
    return time.perf_counter()


def _elapsed_ms(a, b, cuda: bool) -> float:
    return a.elapsed_time(b) if cuda else (b - a) * 1e3


def main(argv=None):
    parser = argparse.ArgumentParser(
        description="vitsom-tpu PyTorch trainer (ViT-SOM and DESOM clustering and "
                    "classification, ViT)")
    parser.add_argument("--config", type=str, required=True)
    parser.add_argument("--runs", type=int, default=None, help="override train.n_runs")
    parser.add_argument("--epochs", type=int, default=None, help="override total_epochs")
    parser.add_argument("--batch-size", type=int, default=None)
    parser.add_argument("--synthetic", action="store_true",
                        help="use the synthetic stand-in dataset")
    parser.add_argument("--override", action="append", default=[],
                        help="dotted config override key=value (yaml-parsed)")
    parser.add_argument("--max-steps", type=int, default=None,
                        help="stop each run after this many train steps")
    parser.add_argument("--device", type=str, default="cuda",
                        help="torch device: a card on a multi-card host (cuda:1), "
                             "or cpu for a cut-down run")
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
    dm = build_datamodule(cfg, device)

    results = []
    for run_id in range(cfg.train.n_runs):
        t0 = time.perf_counter()
        trainer = Trainer(cfg, device=device, dm=dm, run_id=run_id)
        hist = trainer.fit(max_steps=args.max_steps)
        res = trainer.evaluate()
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
            "run_seconds": time.perf_counter() - t0,
            "device": str(torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu"),
        })
        print(json.dumps(res), flush=True)
        results.append(res)
    summary = {
        k: (float(np.mean([r[k] for r in results])), float(np.std([r[k] for r in results])))
        for k in (("accuracy", "f1") if cfg.classification else ("purity", "nmi"))
    }
    print(json.dumps({"runs": len(results), "mean_std": summary}), flush=True)
    return results


if __name__ == "__main__":
    main()
