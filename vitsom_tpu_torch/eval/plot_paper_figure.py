"""The paper's params-vs-metric figure.

Counterpart of ``experiments/plot_paper_figure.py``: the reference's table
values (``PAPER_ROWS``, the port's own copy), or a csv of results with the
columns ``name,params_m,purity,accuracy`` (an empty purity or accuracy is
none), drawn by ``eval/viz.plot_params_vs_metric``. It is on no train or
eval path, and matplotlib is imported only to draw (``viz._pyplot``):

    python -m vitsom_tpu_torch.eval.plot_paper_figure [--csv results.csv] \\
        [--out img/params_vs_metric.pdf]
"""

from __future__ import annotations

import argparse
import csv
from typing import List, Optional, Tuple

from vitsom_tpu_torch.eval.viz import plot_params_vs_metric

Row = Tuple[str, float, Optional[float], Optional[float]]

# model, params (M), purity (clustering) or None, accuracy (classification)
# or None: the reference README's tables and ``tools/plot.py``
PAPER_ROWS: List[Row] = [
    ("DESOM", 0.63, 0.934, None),
    ("ViT-SOM-24", 2.2, 0.936, None),
    ("ViT-SOM-40", 5.4, 0.955, None),
    ("ViT-SOM-cls", 5.5, None, 0.920),
    ("ViT", 5.3, None, 0.915),
    ("Swin-T", 27.6, None, 0.918),
    ("DeiT-T", 5.7, None, 0.905),
    ("MobileViT-S", 5.6, None, 0.912),
]


def read_rows(path: str) -> List[Row]:
    """The rows of a ``name,params_m,purity,accuracy`` csv."""
    with open(path) as f:
        return [(r["name"], float(r["params_m"]),
                 float(r["purity"]) if r.get("purity") else None,
                 float(r["accuracy"]) if r.get("accuracy") else None)
                for r in csv.DictReader(f)]


def main(argv=None) -> str:
    p = argparse.ArgumentParser(description="the paper's params-vs-metric figure")
    p.add_argument("--csv", type=str, default=None,
                   help="csv with columns name,params_m,purity,accuracy")
    p.add_argument("--out", type=str, default="img/params_vs_metric.pdf")
    args = p.parse_args(argv)
    rows = read_rows(args.csv) if args.csv else PAPER_ROWS
    out = plot_params_vs_metric(
        names=[r[0] for r in rows],
        n_params_m=[r[1] for r in rows],
        purity=[r[2] for r in rows],
        accuracy=[r[3] for r in rows],
        out_path=args.out,
    )
    print(f"wrote {out}")
    return out


if __name__ == "__main__":
    main()
