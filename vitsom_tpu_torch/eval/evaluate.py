"""Evaluation: clustering (BMU purity/NMI) and classification.

Counterpart of ``vitsom_tpu/eval/evaluate.py``:

- ``evaluate_clustering``: a forward pass over the clustering (train +
  test concat) split in drop-last batches (the whole split, ragged, when
  it is smaller than one batch), the BMUs kept on the device and moved to
  the host once, timed after one warm-up batch;
- ``evaluate_classification``: argmax of the logits over a split (the
  test split by default) -> accuracy and macro precision/recall/F1, timed
  after one warm-up batch;
- ``validation_metrics``: the per-epoch validation pass, ``val/accuracy``
  and the mean of each per-batch ``*_loss`` of the eval step as
  ``val/<name>`` (DESOM's eval step reports none);
- ``evaluate_kmeans``: k-means (``eval/kmeans.py``, sklearn's algorithm on
  the data's device) on the eval step's ``latent`` over the clustering
  split -> purity and NMI, timed after one warm-up batch.

The classification splits are the device-resident, eval-transformed
arrays of ``data/pipeline.ClassificationDataModule``; a split smaller than
one batch keeps its ragged batch, a larger one drops it, as in the JAX
package.

Under data parallelism over more than one rank each evaluator takes the
JAX package's multi-process branch (``_multihost_span_eval``): every rank
scores its span of the split truncated to a multiple of the world size
(``dm.span_eval_batches``: all its rows, the last batch ragged; for
``validation_metrics`` whole batches, as the JAX branch trims them), one
warm-up batch first, and the BMUs, latents, predictions, labels and each
rank's mean losses are gathered over the ranks, so every rank computes the
same purity, NMI, k-means and validation metrics.
"""

from __future__ import annotations

import time
from typing import Callable, Dict, Optional, Tuple

import numpy as np
import torch

from vitsom_tpu_torch.eval import metrics
from vitsom_tpu_torch.eval.kmeans import KMeans
from vitsom_tpu_torch.parallel import distributed as dist_lib


def _synchronize(batch) -> None:
    if batch["image"].is_cuda:
        torch.cuda.synchronize(batch["image"].device)


def _sharded() -> bool:
    return dist_lib.process_count() > 1


def _span_eval(eval_step: Callable, dm, split: str, temperature,
               outputs: Callable[[Dict, Dict], Dict[str, torch.Tensor]], whole_batches=False):
    """The sharded evaluation (module docstring): ``outputs(out, batch)``
    of each of this rank's batches, concatenated, with the labels, then
    gathered over the ranks. Returns ({name: [n] tensor}, seconds: the
    forward passes and the gather, after the warm-up batch)."""
    batches = list(dm.span_eval_batches(split))
    if whole_batches:
        batches = [b for b in batches if len(b["label"]) == dm.cfg.batch_size] or batches
    if not batches:
        raise ValueError(f"the {split} span of rank {dist_lib.process_index()} gave no batch")
    eval_step(batches[0], temperature)
    _synchronize(batches[0])
    start = time.perf_counter()
    parts = [outputs(eval_step(b, temperature), b) for b in batches]
    local = {k: torch.cat([p[k] for p in parts]) for k in parts[0]}
    local["label"] = torch.cat([b["label"] for b in batches])
    gathered = {k: dist_lib.all_gather_rows(v) for k, v in local.items()}
    _synchronize(batches[0])
    return gathered, time.perf_counter() - start


def evaluate_clustering(
    eval_step: Callable, dm, temperature: float, drop_last: bool = True
) -> Tuple[float, float, float]:
    """Returns (purity, nmi, seconds). A split smaller than one batch is
    evaluated whole, as the JAX package does. One batch runs first, outside
    the clock; the time covers the forward passes and the transfer of the
    BMUs, ending in a host copy that waits for the device. Sharded over
    the ranks (module docstring), the spans' BMUs are gathered."""
    if _sharded():
        g, dt = _span_eval(eval_step, dm, "train", temperature, lambda o, b: {"bmu": o["bmu"]})
        y_true, y_pred = g["label"].cpu().numpy(), g["bmu"].cpu().numpy()
        p, n = metrics.purity(y_true, y_pred), metrics.nmi(y_true, y_pred)
        print(f"Purity: {p:.3f}, NMI: {n:.3f}, Inference Time: {dt:.3f}")
        return p, n, dt
    if dm.n_train < dm.cfg.batch_size:
        drop_last = False
    batches = list(dm.eval_batches(drop_last=drop_last))
    if not batches:
        raise ValueError(f"a split of {dm.n_train} samples gave no batch")
    eval_step(batches[0], temperature)
    _synchronize(batches[0])
    start = time.perf_counter()
    preds = [eval_step(batch, temperature)["bmu"] for batch in batches]
    y_pred = torch.cat(preds).cpu().numpy()
    dt = time.perf_counter() - start
    y_true = torch.cat([b["label"] for b in batches]).cpu().numpy()
    p = metrics.purity(y_true, y_pred)
    n = metrics.nmi(y_true, y_pred)
    print(f"Purity: {p:.3f}, NMI: {n:.3f}, Inference Time: {dt:.3f}")
    return p, n, dt


def evaluate_kmeans(eval_step: Callable, dm, n_clusters: Optional[int] = None,
                    temperature=None) -> Tuple[float, float, float]:
    """(purity, nmi, seconds) of ``KMeans(k, random_state=0, n_init=10)``
    on the eval step's ``latent`` over the clustering split's drop-last
    batches (a split smaller than one batch whole), k = ``n_clusters`` or
    the number of distinct labels. One batch runs first, outside the clock;
    the time covers the forward passes and the fit, as in the JAX package
    (``vitsom_tpu/eval/evaluate.py:391``). Sharded over the ranks (module
    docstring), the spans' latents are gathered and every rank fits the
    same k-means."""
    if _sharded():
        g, span_dt = _span_eval(eval_step, dm, "train", temperature,
                                lambda o, b: {"latent": o["latent"]})
        start = time.perf_counter() - span_dt
        x, y_true = g["latent"], g["label"].cpu().numpy()
    else:
        batches = list(dm.eval_batches(drop_last=dm.n_train >= dm.cfg.batch_size))
        if not batches:
            raise ValueError(f"a split of {dm.n_train} samples gave no batch")
        eval_step(batches[0], temperature)
        _synchronize(batches[0])
        start = time.perf_counter()
        x = torch.cat([eval_step(b, temperature)["latent"] for b in batches])
        y_true = torch.cat([b["label"] for b in batches]).cpu().numpy()
    k = n_clusters or len(np.unique(y_true))
    y_pred = KMeans(n_clusters=k, random_state=0, n_init=10).fit_predict(x).cpu().numpy()
    p = metrics.purity(y_true, y_pred)
    n = metrics.nmi(y_true, y_pred)
    dt = time.perf_counter() - start
    print(f"Purity (KMeans): {p:.3f}, NMI (KMeans): {n:.3f}, Inference Time: {dt:.3f}")
    return p, n, dt


def _batches(dm, split: str):
    """The split's eval batches: drop-last unless it is smaller than one
    batch."""
    return list(dm.eval_batches(split, drop_last=dm.split_len(split) >= dm.cfg.batch_size))


def evaluate_classification(
    eval_step: Callable, dm, split: str = "test", temperature=None
) -> Tuple[float, float, float, float, float]:
    """(accuracy, precision, recall, f1, seconds) of the argmax of the
    logits over ``split``. The split is transformed before the clock
    starts, and one batch runs first as a warm-up; the time covers the
    forward passes and the transfer of the predictions. Sharded over the
    ranks (module docstring), the spans' predictions are gathered."""
    if _sharded():
        g, dt = _span_eval(eval_step, dm, split, temperature,
                           lambda o, b: {"pred": o["logits"].argmax(dim=-1)})
        y_true, y_pred = g["label"].cpu().numpy(), g["pred"].cpu().numpy()
        m = metrics.classification_metrics(y_true, y_pred)
        print(
            f"Accuracy: {m['accuracy']:.3f}, Precision: {m['precision']:.3f}, "
            f"Recall: {m['recall']:.3f}, F1-score: {m['f1']:.3f}, Inference Time: {dt:.3f}"
        )
        return m["accuracy"], m["precision"], m["recall"], m["f1"], dt
    batches = _batches(dm, split)
    if not batches:
        raise ValueError(f"the {split} split gave no batch")
    eval_step(batches[0], temperature)
    _synchronize(batches[0])
    start = time.perf_counter()
    preds = [eval_step(b, temperature)["logits"].argmax(dim=-1) for b in batches]
    y_pred = torch.cat(preds).cpu().numpy()
    dt = time.perf_counter() - start
    y_true = torch.cat([b["label"] for b in batches]).cpu().numpy()
    m = metrics.classification_metrics(y_true, y_pred)
    print(
        f"Accuracy: {m['accuracy']:.3f}, Precision: {m['precision']:.3f}, "
        f"Recall: {m['recall']:.3f}, F1-score: {m['f1']:.3f}, Inference Time: {dt:.3f}"
    )
    return m["accuracy"], m["precision"], m["recall"], m["f1"], dt


def validation_metrics(eval_step: Callable, dm, split: str = "val",
                       temperature=None) -> Dict[str, float]:
    """``val/accuracy`` and ``val/<loss>`` (the mean over batches of each
    ``*_loss`` the eval step returns) over ``split``, with one
    device-to-host transfer. Sharded over the ranks (module docstring):
    each rank's whole batches, its predictions and labels gathered, and
    each loss the mean of the ranks' means, as the JAX branch averages
    them."""
    if _sharded():
        return _sharded_validation(eval_step, dm, split, temperature)
    preds, trues, losses = [], [], []
    for batch in _batches(dm, split):
        o = eval_step(batch, temperature)
        preds.append(o["logits"].argmax(dim=-1))
        trues.append(batch["label"])
        names = sorted(k for k in o if k.endswith("_loss"))
        if names:
            losses.append(torch.stack([o[k] for k in names]))
    if not preds:
        raise ValueError(f"the {split} split gave no batch")
    correct = (torch.cat(preds) == torch.cat(trues)).double().mean()
    parts = [correct.reshape(1)]
    if losses:
        parts.append(torch.stack(losses).double().mean(dim=0))
    host = torch.cat(parts).cpu()
    out = {"val/accuracy": float(host[0])}
    out.update({f"val/{k}": float(v) for k, v in zip(names, host[1:])})
    return out


def _sharded_validation(eval_step: Callable, dm, split: str, temperature) -> Dict[str, float]:
    """``validation_metrics`` sharded over the ranks (its docstring)."""
    names = []

    def outputs(o, b):
        names[:] = sorted(k for k in o if k.endswith("_loss"))
        losses = [o[k].reshape(1).double() for k in names]
        return {"pred": o["logits"].argmax(dim=-1),
                "losses": torch.cat(losses).reshape(1, -1) if losses
                else torch.zeros((1, 0), dtype=torch.float64, device=b["label"].device)}

    g, _ = _span_eval(eval_step, dm, split, temperature, outputs, whole_batches=True)
    # gathered: every rank's batches' losses; each rank's mean, then theirs
    per_rank = g["losses"].view(dist_lib.process_count(), -1, len(names)).mean(dim=1)
    host = torch.cat([(g["pred"] == g["label"]).double().mean().reshape(1),
                      per_rank.mean(dim=0)]).cpu()
    out = {"val/accuracy": float(host[0])}
    out.update({f"val/{k}": float(v) for k, v in zip(names, host[1:])})
    return out
