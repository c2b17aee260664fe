"""Clustering evaluation: BMU index as cluster id, purity + NMI.

Counterpart of ``vitsom_tpu/eval/evaluate.evaluate_clustering``: a forward
pass over the clustering (train + test concat) split in drop-last batches,
the BMUs kept on the device and moved to the host once.
"""

from __future__ import annotations

import time
from typing import Callable, Tuple

import torch

from vitsom_tpu_torch.data.synthetic import DataModule
from vitsom_tpu_torch.eval import metrics


def evaluate_clustering(
    eval_step: Callable, dm: DataModule, temperature: float, drop_last: bool = True
) -> Tuple[float, float, float]:
    """Returns (purity, nmi, seconds); the time covers the forward passes
    and the transfer of the BMUs, ending in a host copy that waits for the
    device."""
    start = time.perf_counter()
    preds, trues = [], []
    for batch in dm.eval_batches(drop_last=drop_last):
        preds.append(eval_step(batch, temperature)["bmu"])
        trues.append(batch["label"])
    if not preds:
        raise ValueError(f"a split of {dm.n_train} samples gave no batch")
    y_pred = torch.cat(preds).cpu().numpy()
    y_true = torch.cat(trues).cpu().numpy()
    dt = time.perf_counter() - start
    p = metrics.purity(y_true, y_pred)
    n = metrics.nmi(y_true, y_pred)
    print(f"Purity: {p:.3f}, NMI: {n:.3f}, Inference Time: {dt:.3f}")
    return p, n, dt
