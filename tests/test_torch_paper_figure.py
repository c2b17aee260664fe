"""The paper-figure script (``vitsom_tpu_torch/eval/plot_paper_figure.py``)
against ``experiments/plot_paper_figure.py``, on the CPU: the same table
rows, and a figure written from a csv of results (matplotlib's Agg
backend)."""

import importlib.util
import os

from vitsom_tpu_torch.eval import plot_paper_figure

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _jax_script():
    spec = importlib.util.spec_from_file_location(
        "jax_plot_paper_figure", os.path.join(ROOT, "experiments", "plot_paper_figure.py"))
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def test_paper_rows_match_the_jax_script():
    assert plot_paper_figure.PAPER_ROWS == _jax_script().PAPER_ROWS


def test_figure_from_csv(tmp_path):
    csv_path = tmp_path / "results.csv"
    csv_path.write_text("name,params_m,purity,accuracy\n"
                        "ViT-SOM-24,2.2,0.5,\nViT,5.3,,0.25\nDESOM,0.63,0.9,\n")
    assert plot_paper_figure.read_rows(str(csv_path)) == [
        ("ViT-SOM-24", 2.2, 0.5, None), ("ViT", 5.3, None, 0.25), ("DESOM", 0.63, 0.9, None)]
    out = tmp_path / "fig" / "params_vs_metric.pdf"
    assert plot_paper_figure.main(["--csv", str(csv_path), "--out", str(out)]) == str(out)
    assert out.is_file() and out.read_bytes()[:4] == b"%PDF"
    png = tmp_path / "paper.png"
    plot_paper_figure.main(["--out", str(png)])
    assert png.read_bytes()[:8] == b"\x89PNG\r\n\x1a\n"
