"""Clustering and classification metrics (numpy), the port's own copy.

Same definitions as ``vitsom_tpu/eval/metrics.py``:

- ``purity``: each cluster adopts its most common true label; the score is
  the fraction of points whose adopted label matches their true one;
- ``nmi``: normalised mutual information with arithmetic-mean
  normalisation (sklearn's default);
- ``classification_metrics``: accuracy and macro precision, recall and F1.
"""

from __future__ import annotations

from typing import Dict

import numpy as np


def contingency(y_true: np.ndarray, y_pred: np.ndarray) -> np.ndarray:
    """[n_clusters, n_labels] count matrix over the observed id ranges."""
    y_true = np.asarray(y_true).astype(np.int64).reshape(-1)
    y_pred = np.asarray(y_pred).astype(np.int64).reshape(-1)
    d = int(max(y_pred.max(), y_true.max())) + 1
    w = np.zeros((d, d), dtype=np.int64)
    np.add.at(w, (y_pred, y_true), 1)
    return w


def purity(y_true: np.ndarray, y_pred: np.ndarray) -> float:
    y_true = np.asarray(y_true).astype(np.int64).reshape(-1)
    y_pred = np.asarray(y_pred).astype(np.int64).reshape(-1)
    if y_true.size != y_pred.size:
        raise ValueError(f"{y_true.size} labels but {y_pred.size} predictions")
    mapping = contingency(y_true, y_pred).argmax(axis=1)
    return float(np.mean(mapping[y_pred] == y_true))


def _entropy(counts: np.ndarray) -> float:
    p = counts[counts > 0].astype(np.float64)
    p = p / p.sum()
    return float(-(p * np.log(p)).sum())


def nmi(y_true: np.ndarray, y_pred: np.ndarray) -> float:
    """NMI with arithmetic normalisation (sklearn default)."""
    w = contingency(y_true, y_pred).astype(np.float64)
    n = w.sum()
    if n == 0:
        return 0.0
    pi = w.sum(axis=1)  # cluster sizes
    pj = w.sum(axis=0)  # label sizes
    h_pred = _entropy(pi)
    h_true = _entropy(pj)
    nz = w > 0
    pij = w[nz] / n
    outer = (pi[:, None] * pj[None, :])[nz] / (n * n)
    mi = float((pij * np.log(pij / outer)).sum())
    denom = 0.5 * (h_pred + h_true)
    if denom <= 0:
        return 0.0 if mi == 0 else 1.0
    return float(np.clip(mi / denom, 0.0, 1.0))


def classification_metrics(y_true: np.ndarray, y_pred: np.ndarray) -> Dict[str, float]:
    """Accuracy + macro precision/recall/F1 over the classes seen in either
    array; a class whose precision or recall has a zero denominator is left
    out of that mean (and of F1's), sklearn's ``zero_division=np.nan``."""
    y_true = np.asarray(y_true).reshape(-1)
    y_pred = np.asarray(y_pred).reshape(-1)
    classes = np.unique(np.concatenate([y_true, y_pred]))
    accuracy = float(np.mean(y_true == y_pred))
    precisions, recalls, f1s = [], [], []
    for c in classes:
        tp = float(np.sum((y_pred == c) & (y_true == c)))
        fp = float(np.sum((y_pred == c) & (y_true != c)))
        fn = float(np.sum((y_pred != c) & (y_true == c)))
        prec = tp / (tp + fp) if (tp + fp) > 0 else np.nan
        rec = tp / (tp + fn) if (tp + fn) > 0 else np.nan
        if np.isnan(prec) or np.isnan(rec):
            f1 = np.nan
        else:
            f1 = 2 * prec * rec / (prec + rec) if (prec + rec) > 0 else 0.0
        precisions.append(prec)
        recalls.append(rec)
        f1s.append(f1)
    return {
        "accuracy": accuracy,
        "precision": float(np.nanmean(precisions)),
        "recall": float(np.nanmean(recalls)),
        "f1": float(np.nanmean(f1s)),
    }
