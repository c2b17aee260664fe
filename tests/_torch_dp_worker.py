"""Worker of the port's 2-rank data-parallel tests (tests/test_torch_parallel.py).

Launched as ``python tests/_torch_dp_worker.py <spec.json>`` with
torchrun's environment set by the parent (``RANK``, ``WORLD_SIZE``,
``LOCAL_RANK``, ``MASTER_ADDR``, ``MASTER_PORT``): joins the gloo group
through ``parallel.distributed.maybe_initialize`` and, on the CPU, runs

- the data-parallel fused SOM (``som_fused.make_fused_som_sharded``, its
  plain version) on the rank's rows of the spec's inputs, with the
  gradients averaged over the ranks;
- the port's BatchNorm in train mode on the rank's rows, with the
  gradients averaged over the ranks;
- a ``Trainer`` fit of the spec's config from the spec's initial weights,
  then the sharded evaluators (``evaluate``, ``validation_metrics`` and
  ``evaluate_kmeans`` on the CLS token), each rank writing into its own
  directories; then the N-run protocol (``trainer.main``) for 2 steps into
  shared directories;

and saves what the parent compares to ``<out>/rank<r>.pt``.
"""

import json
import os
import sys

sys.path.insert(0, os.path.abspath(os.path.join(os.path.dirname(__file__), "..")))

import numpy as np  # noqa: E402
import torch  # noqa: E402


def sharded_som(spec, rank, world):
    from vitsom_tpu_torch.ops import som_fused
    from vitsom_tpu_torch.parallel import distributed as dist_lib

    data = np.load(spec["som_inputs"])
    out = {}
    for fcn in ("cosine", "euclidean"):
        x = torch.from_numpy(data["x"])[dist_lib.local_span(len(data["x"]), rank, world)]
        x = x.clone().requires_grad_(True)
        protos = torch.from_numpy(data["protos"]).clone().requires_grad_(True)
        fused = som_fused.make_fused_som_sharded(tuple(spec["som_map"]), "square", fcn)
        loss, bmu, dist = fused(x, protos, torch.tensor(float(data["temp"])))
        loss.backward()
        dist_lib.average_gradients([protos])
        out[fcn] = {"loss": loss.detach(), "bmu": dist_lib.all_gather_rows(bmu),
                    "dist": dist_lib.all_gather_rows(dist.detach()),
                    "dx": dist_lib.all_gather_rows(x.grad), "dp": protos.grad}
    return out


def sharded_batchnorm(spec, rank, world):
    from vitsom_tpu_torch.models.ae import BatchNorm
    from vitsom_tpu_torch.parallel import distributed as dist_lib

    data = np.load(spec["bn_inputs"])
    span = dist_lib.local_span(len(data["x"]), rank, world)
    bn = BatchNorm(data["x"].shape[1])
    with torch.no_grad():
        bn.weight.copy_(torch.from_numpy(data["scale"]))
        bn.bias.copy_(torch.from_numpy(data["bias"]))
    x = torch.from_numpy(data["x"])[span].clone().requires_grad_(True)
    y = bn(x, train=True)
    (y * torch.from_numpy(data["cot"])[span]).mean().backward()
    dist_lib.average_gradients(bn.parameters())
    return {"y": dist_lib.all_gather_rows(y.detach()), "dx": dist_lib.all_gather_rows(x.grad),
            "dscale": bn.weight.grad, "dbias": bn.bias.grad,
            "mean": bn.running_mean.clone(), "var": bn.running_var.clone()}


def fit(spec, rank):
    from vitsom_tpu_torch.config import load_config
    from vitsom_tpu_torch.eval import evaluate as eval_lib
    from vitsom_tpu_torch.train.trainer import Trainer

    over = {**spec["overrides"],
            "train.checkpoint_dir": os.path.join(spec["out"], f"states{rank}"),
            "train.log_dir": os.path.join(spec["out"], f"logs{rank}")}
    cfg = load_config(spec["config"], over)
    tr = Trainer(cfg, device="cpu")
    tr.model.load_state_dict(torch.load(spec["init"], weights_only=True))
    hist = tr.fit()
    res = tr.evaluate()
    temp = tr.current_temperature()
    tr.model.eval()
    vm = eval_lib.validation_metrics(tr.eval_step, tr.dm, "train", temp)

    @torch.no_grad()
    def latent_step(batch, temperature=None):
        return {"latent": tr.model.features(batch["image"])[0]}

    km = eval_lib.evaluate_kmeans(latent_step, tr.dm, temperature=temp)
    tr.save_checkpoint("last")
    tr.logger.close()
    return {"state": {k: v.detach().clone() for k, v in tr.model.state_dict().items()},
            "steps": tr.step, "world": tr.world, "total_loss": hist["train/total_loss"],
            "purity": res["purity"], "nmi": res["nmi"], "val": vm,
            "kmeans": [km[0], km[1]]}


def protocol(spec, rank):
    """The N-run protocol under the group (``trainer.main``): one run of 2
    steps into shared directories, the JSON written by rank 0 alone."""
    from vitsom_tpu_torch.train import trainer

    argv = ["--config", spec["config"], "--device", "cpu", "--runs", "1", "--max-steps", "2",
            "--json-out", os.path.join(spec["out"], f"protocol{rank}.json")]
    for k, v in {**spec["overrides"], "train.checkpoint_dir": os.path.join(spec["out"], "pstates"),
                 "train.log_dir": os.path.join(spec["out"], "plogs")}.items():
        argv += ["--override", f"{k}={json.dumps(v)}"]
    res = trainer.main(argv)[0]
    return {"purity": res["purity"], "nmi": res["nmi"], "steps": res["steps"]}


def main(spec_path):
    from vitsom_tpu_torch.parallel import distributed as dist_lib

    torch.set_num_threads(1)
    with open(spec_path) as f:
        spec = json.load(f)
    assert dist_lib.maybe_initialize("cpu")
    rank, world = dist_lib.process_index(), dist_lib.process_count()
    assert world == int(os.environ["WORLD_SIZE"]) and not dist_lib.capturable()
    result = {"som": sharded_som(spec, rank, world), "bn": sharded_batchnorm(spec, rank, world),
              "fit": fit(spec, rank), "main": protocol(spec, rank)}
    torch.save(result, os.path.join(spec["out"], f"rank{rank}.pt"))
    dist_lib.barrier()
    print(f"rank {rank} done")


if __name__ == "__main__":
    main(sys.argv[1])
