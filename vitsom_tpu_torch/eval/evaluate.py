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
"""

from __future__ import annotations

import time
from typing import Callable, Dict, Optional, Tuple

import numpy as np
import torch

from vitsom_tpu_torch.eval import metrics
from vitsom_tpu_torch.eval.kmeans import KMeans


def _synchronize(batch) -> None:
    if batch["image"].is_cuda:
        torch.cuda.synchronize(batch["image"].device)


def evaluate_clustering(
    eval_step: Callable, dm, temperature: float, drop_last: bool = True
) -> Tuple[float, float, float]:
    """Returns (purity, nmi, seconds). A split smaller than one batch is
    evaluated whole, as the JAX package does. One batch runs first, outside
    the clock; the time covers the forward passes and the transfer of the
    BMUs, ending in a host copy that waits for the device."""
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
    (``vitsom_tpu/eval/evaluate.py:391``; its multi-host branch is not
    ported)."""
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
    forward passes and the transfer of the predictions."""
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
    device-to-host transfer."""
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
