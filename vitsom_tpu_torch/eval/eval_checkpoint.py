"""Evaluate a saved checkpoint: the port's counterpart of
``experiments/tests/eval_checkpoint.py`` (behind the reference's ``make
test model=<m> dataset=<d>``).

Restores a checkpoint into a ``Trainer`` (no fit: the restored state is
evaluated as it was saved) and reports

- clustering: purity, NMI and the inference time (``Trainer.evaluate``),
  the quantization and topographic errors on the distances of the first
  ``min(n_keep, 8192)`` images of the clustering split (n_keep its
  drop-last length), k-means purity and NMI on DESOM's latents, and with
  ``--figures-dir`` the label heatmap, the decoded-prototype grid
  (``vit_som`` with ``use_reduced: false``) and the latent projection of
  the first ``min(n_keep, 4096)`` latents;
- classification: accuracy and macro precision, recall and F1 on the test
  split.

ViT-SOM's distances come from the fused SOM op (on the card, the kernel,
which returns them beside the BMUs; manhattan maps from the plain
distances, as the eval step takes them); DESOM's from its eager manhattan
SOM, BatchNorm on its running averages, as its eval step reads them.

On the card (the default; without CUDA it raises unless ``--cpu``):

    python -m vitsom_tpu_torch.eval.eval_checkpoint \\
        --checkpoint experiments/states/vit_som/mnist_run0_last --figures-dir img/
    python -m vitsom_tpu_torch.eval.eval_checkpoint \\
        --config configs/desom/desom_mnist.yaml --synthetic --cpu

With ``--checkpoint`` the config embedded in the checkpoint directory is
used unless ``--config`` is given (then the trainer's structural check
guards a mismatch). Drawing needs matplotlib; where it is not installed
the figures' numeric parts (the cell labels, the decoded prototypes, the
projection) are still computed, one line says what was not drawn, and
nothing is drawn in its place.
"""

from __future__ import annotations

import argparse
import importlib.util
import os
from typing import Dict, Tuple

import numpy as np
import torch

from vitsom_tpu_torch.config import apply_overrides, load_config
from vitsom_tpu_torch.data.synthetic import build_datamodule
from vitsom_tpu_torch.eval import evaluate as eval_lib
from vitsom_tpu_torch.eval import metrics, viz
from vitsom_tpu_torch.ops import som_fused
from vitsom_tpu_torch.som import layer as som
from vitsom_tpu_torch.train.trainer import Trainer, load_checkpoint_config
from vitsom_tpu_torch.utils.device import resolve_device

DISTANCE_SAMPLES = 8192  # rows of the [n, P] distance matrix for QE / TE
LATENT_SAMPLES = 4096  # latents of the projection figure


def kept_rows(trainer: Trainer) -> int:
    """The clustering split's drop-last length (all of it when it is
    smaller than one batch)."""
    n, bs = trainer.dm.n_train, trainer.cfg.batch_size
    return (n // bs) * bs or n


def _row_batches(trainer: Trainer, n: int):
    bs = trainer.cfg.batch_size
    images = trainer.dm.images
    return [images[s:s + bs] for s in range(0, n, bs)]


def bmu_pass(trainer: Trainer, temperature) -> Tuple[np.ndarray, np.ndarray]:
    """(BMUs, labels) of the clustering split's drop-last rows through the
    restored eval step, one host copy each."""
    n = kept_rows(trainer)
    trainer.model.eval()
    bmus = [trainer.eval_step({"image": x}, temperature)["bmu"]
            for x in _row_batches(trainer, n)]
    return torch.cat(bmus).cpu().numpy(), trainer.dm.labels[:n].cpu().numpy()


@torch.no_grad()
def latents(trainer: Trainer, n: int) -> torch.Tensor:
    """[n', latent] SOM inputs of the split's first rows, batch by batch
    (n' = n rounded up to whole batches, at most the split): ViT-SOM's
    encoder alone, DESOM's encoder on the flattened images."""
    model = trainer.model
    model.eval()
    if trainer.cfg.model_arch == "vit_som":
        return torch.cat([model.get_latent_representation(x) for x in _row_batches(trainer, n)])
    return torch.cat([model(x.reshape(x.shape[0], -1))[1] for x in _row_batches(trainer, n)])


@torch.no_grad()
def distances(trainer: Trainer, n: int, temperature) -> torch.Tensor:
    """[n', P] SOM distances of the split's first rows: ViT-SOM's from the
    fused SOM op (the kernel on the card) on the encoder's latents, or the
    plain manhattan distances; DESOM's from its eager SOM."""
    cfg, model = trainer.cfg, trainer.model
    model.eval()
    if cfg.model_arch != "vit_som":
        return torch.cat([model(x.reshape(x.shape[0], -1))[2] for x in _row_batches(trainer, n)])
    if cfg.som.distance_fcn in ("euclidean", "cosine"):
        fused = som_fused.make_fused_som(cfg.som.map_size, cfg.som.topology,
                                         cfg.som.distance_fcn)
        return torch.cat([fused(model.get_latent_representation(x), model.prototypes,
                                temperature)[2] for x in _row_batches(trainer, n)])
    return torch.cat([som.compute_distances(model.get_latent_representation(x),
                                            model.prototypes, cfg.som.distance_fcn)
                      for x in _row_batches(trainer, n)])


def figures(trainer: Trainer, bmu: np.ndarray, labels: np.ndarray, out_dir: str) -> None:
    """The three figures: their numbers (the cell labels, the decoded
    prototypes of ``vit_som`` without ``use_reduced``, the projection of
    the first latents), then, where matplotlib is installed, each drawn to
    ``out_dir``."""
    cfg = trainer.cfg
    map_size = tuple(cfg.som.map_size)
    cells = viz.cell_label_map(bmu, labels, map_size[0] * map_size[1])
    canvas = None
    if cfg.model_arch == "vit_som" and not cfg.som.use_reduced:
        decoded = viz.decoded_prototypes(trainer.model, cfg).cpu().numpy()
        canvas = viz.prototype_grid_image(decoded, map_size)
    lat = latents(trainer, min(kept_rows(trainer), LATENT_SAMPLES))
    emb, used = viz.latent_projection(lat)
    names = ["heatmap"] + (["prototypes"] if canvas is not None else []) + ["latents"]
    if importlib.util.find_spec("matplotlib") is None:
        print(f"matplotlib is not installed on this machine: not drawn: {', '.join(names)} "
              f"(computed: the labels of {len(cells)} cells"
              f"{', the decoded prototypes' if canvas is not None else ''}, the {used} "
              f"projection of {len(lat)} latents)")
        return
    stem = os.path.join(out_dir, f"{cfg.model_arch}_{cfg.data.dataset}")
    viz.draw_heatmap(cells, map_size, f"{stem}_heatmap.png")
    if canvas is not None:
        viz.draw_prototype_grid(canvas, map_size, f"{stem}_prototypes.png")
    viz.draw_projection(emb, labels[:len(lat)], used, f"{stem}_latents.png")
    print(f"figures written to {out_dir}")


def main(argv=None) -> Dict[str, float]:
    parser = argparse.ArgumentParser(description="vitsom-tpu PyTorch checkpoint evaluation")
    parser.add_argument("--config", type=str, default=None)
    parser.add_argument("--checkpoint", type=str, default=None,
                        help="checkpoint directory; its embedded config is used when "
                             "--config is absent")
    parser.add_argument("--tag", type=str, default="last", help="checkpoint tag (last/best)")
    parser.add_argument("--run-id", type=int, default=0)
    parser.add_argument("--synthetic", action="store_true")
    parser.add_argument("--cpu", action="store_true",
                        help="run on the CPU (the default is the card)")
    parser.add_argument("--figures-dir", type=str, default=None,
                        help="write the figures here (clustering only)")
    parser.add_argument("--no-kmeans", action="store_true")
    parser.add_argument("--override", action="append", default=[],
                        help="dotted config override key=value (yaml-parsed)")
    args = parser.parse_args(argv)
    device = resolve_device("cpu" if args.cpu else "cuda")

    import yaml

    overrides = {"data.allow_synthetic": True} if args.synthetic else {}
    for ov in args.override:
        k, _, v = ov.partition("=")
        overrides[k] = yaml.safe_load(v)
    if args.config is not None:
        cfg = load_config(args.config, overrides=overrides or None)
    elif args.checkpoint is not None:
        cfg = load_checkpoint_config(args.checkpoint)
        if cfg is None:
            parser.error(f"no embedded config in {args.checkpoint}: pass --config")
        if overrides:
            cfg = apply_overrides(cfg, overrides).validate()
    else:
        parser.error("one of --config / --checkpoint is required")
    dm = build_datamodule(cfg, device)
    trainer = Trainer(cfg, device=device, dm=dm, run_id=args.run_id)
    trainer.restore_checkpoint(tag=args.tag, path=args.checkpoint)
    print(f"restored {cfg.model_arch}/{cfg.data.dataset} checkpoint '{args.tag}' "
          f"at step {trainer.step}")

    results = trainer.evaluate()
    for k, v in results.items():
        print(f"{k}: {v:.4f}")
    if cfg.classification:
        return results

    temperature = trainer.current_temperature()
    bmu, y = bmu_pass(trainer, temperature)
    dist = distances(trainer, min(kept_rows(trainer), DISTANCE_SAMPLES), temperature)
    qe = metrics.quantization_error(dist)
    te = metrics.topographic_error(dist, cfg.som.map_size, cfg.som.topology)
    print(f"quantization_error: {qe:.4f}")
    print(f"topographic_error: {te:.4f}")
    results.update({"quantization_error": qe, "topographic_error": te})

    if not args.no_kmeans and cfg.model_arch == "desom":
        kp, kn, _ = eval_lib.evaluate_kmeans(trainer.eval_step, dm, temperature=temperature)
        results.update({"kmeans_purity": kp, "kmeans_nmi": kn})

    if args.figures_dir:
        figures(trainer, bmu, y, args.figures_dir)
    trainer.logger.close()
    return results


if __name__ == "__main__":
    main()
