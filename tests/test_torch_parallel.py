"""Data parallelism over ``torch.distributed`` (``vitsom_tpu_torch/parallel``)
against the JAX package's data-parallel mesh, on the CPU.

Two gloo ranks are spawned once for the module (``tests/_torch_dp_worker.py``,
each with a 300 s timeout), as ``tests/test_multihost.py`` spawns its two
JAX processes. Held:

- the span functions equal ``vitsom_tpu.parallel.distributed``'s on a grid
  of sizes; a ``train.mesh_shape`` other than the world size raises, and
  so does a batch that does not split over the ranks;
- the 2-rank fused SOM (its plain version) against the JAX
  ``make_fused_som_sharded`` on the 8-device CPU mesh, cosine and
  euclidean, at ``tests/test_pallas_kernels.py``'s tolerances: the loss
  (the ranks' mean) at rtol 1e-6, the gathered BMUs equal and distances at
  1e-5 / 1e-6, the prototype gradients (averaged over the ranks) and the
  input gradients at rtol 1e-4 / atol 1e-7 (a rank differentiates its own
  mean, so its input gradient is the world size times the global mean's);
- the 2-rank BatchNorm (forward, gradients, running averages) against
  Flax's ``nn.BatchNorm`` over the global batch, at 1e-6;
- a 2-rank ``Trainer`` fit with ``tests/_multihost_worker.py``'s
  overrides, from the JAX trainer's initial weights: the final parameters
  against the port's own 1-rank fit at the JAX data-parallel test's
  tolerance (atol 5e-5, rtol 1e-4, ``tests/test_pallas_kernels.py:305``),
  and against the JAX ``Trainer`` on ``train.mesh_shape: [8]`` at the
  update bound the port's train tests hold against JAX everywhere (2 x
  steps x lr: the two draw their epochs' permutations from different
  generators); purity, NMI, k-means and ``validation_metrics`` equal on
  both ranks; rank 1 writes no file, in the trainer and in the N-run
  protocol (``trainer.main``);
- a dropout mask on a rank is its rows of the one-rank mask;
- the epoch buffers of 2 ranks concatenated batch by batch equal the
  1-rank buffer bitwise (the clustering module, the augmented
  classification and clustering modules and the streamed epoch), and the
  host path's and the sharded evaluation's rows equal the JAX process of
  the same index's.
"""

import json
import os
import socket
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vitsom_tpu.config import load_config as jload_config
from vitsom_tpu.data import pipeline as jpipeline
from vitsom_tpu.data.pipeline import build_datamodule as jbuild_datamodule
from vitsom_tpu.ops import som_pallas
from vitsom_tpu.parallel import distributed as jdist
from vitsom_tpu.train import schedules as jsched
from vitsom_tpu.train import optim as joptim
from vitsom_tpu_torch import convert
from vitsom_tpu_torch.config import load_config
from vitsom_tpu_torch.data import pipeline as tpipeline
from vitsom_tpu_torch.data.synthetic import build_datamodule
from vitsom_tpu_torch.parallel import distributed as dist_lib
from vitsom_tpu_torch.parallel import mesh as mesh_lib
from vitsom_tpu_torch.train.trainer import Trainer

REPO = os.path.abspath(os.path.join(os.path.dirname(__file__), ".."))
MNIST = "configs/vit_som/vit_som_mnist.yaml"
CIFAR = "configs/vit_som/vit_som_cifar-10.yaml"
WORLD = 2
# tests/_multihost_worker.py's MULTIHOST_TEST_OVERRIDES (that module
# imports JAX at its top, which a gloo worker does not need)
FIT_OVERRIDES = {
    "total_epochs": 2, "batch_size": 16, "som.map_size": [4, 4], "vit.depth": 2,
    "vit.emb_dim": 16, "vit.heads": 2, "vit.dec_depth": 1, "data.allow_synthetic": True,
    "data.synthetic_size": 64, "train.n_runs": 1, "train.use_pallas_som": True,
}
SOM_MAP = (8, 8)
SMALL_CIFAR = {"data.allow_synthetic": True, "data.synthetic_size": 40, "batch_size": 8,
               "vit.emb_dim": 16, "vit.depth": 1, "vit.heads": 2, "vit.dec_emb_dim": 8,
               "vit.dec_depth": 1, "som.map_size": [2, 2]}


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _jax_fit_cfg(tmp, mesh):
    return jload_config(MNIST, {**FIT_OVERRIDES, "train.mesh_shape": [mesh],
                                "train.checkpoint_dir": str(tmp / f"jstates{mesh}"),
                                "train.log_dir": str(tmp / f"jlogs{mesh}")})


@pytest.fixture(scope="module")
def dp(tmp_path_factory):
    """The 2-rank results, the inputs they were given, the JAX 8-device
    trainer after its fit and the initial weights."""
    from vitsom_tpu.train.trainer import Trainer as JTrainer

    tmp = tmp_path_factory.mktemp("dp")
    rng = np.random.default_rng(11)
    p = SOM_MAP[0] * SOM_MAP[1]
    np.savez(tmp / "som.npz", x=rng.normal(size=(16, 40)).astype(np.float32),
             protos=rng.normal(size=(p, 40)).astype(np.float32), temp=np.float32(2.3))
    np.savez(tmp / "bn.npz", x=(rng.normal(size=(16, 6)) * 2 + 1).astype(np.float32),
             scale=rng.uniform(0.5, 1.5, size=6).astype(np.float32),
             bias=rng.normal(size=6).astype(np.float32),
             cot=rng.normal(size=(16, 6)).astype(np.float32))
    jcfg = _jax_fit_cfg(tmp, 8)
    jt = JTrainer(jcfg, dm=jbuild_datamodule(jcfg), run_id=0)
    assert jt.mesh.devices.size == 8
    init = convert.flax_to_state_dict(jax.device_get(jt.state.params))
    torch.save(init, tmp / "init.pt")
    spec = {"out": str(tmp), "som_inputs": str(tmp / "som.npz"), "som_map": SOM_MAP,
            "bn_inputs": str(tmp / "bn.npz"), "config": MNIST, "init": str(tmp / "init.pt"),
            "overrides": {**FIT_OVERRIDES, "train.mesh_shape": [WORLD]}}
    (tmp / "spec.json").write_text(json.dumps(spec))
    port = _free_port()
    procs = []
    for rank in range(WORLD):
        env = {k: v for k, v in os.environ.items() if k != "XLA_FLAGS"}
        env.update(RANK=str(rank), WORLD_SIZE=str(WORLD), LOCAL_RANK=str(rank),
                   MASTER_ADDR="127.0.0.1", MASTER_PORT=str(port))
        procs.append(subprocess.Popen(
            [sys.executable, os.path.join(REPO, "tests/_torch_dp_worker.py"),
             str(tmp / "spec.json")], cwd=REPO, env=env, stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True))
    jt.fit(progress=False)  # the JAX fit runs while the ranks work
    logs = []
    try:
        for proc in procs:
            logs.append(proc.communicate(timeout=300)[0])
    finally:
        for proc in procs:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
    for proc, log in zip(procs, logs):
        assert proc.returncode == 0, f"rank failed:\n{log[-4000:]}"
    ranks = [torch.load(tmp / f"rank{r}.pt", weights_only=False) for r in range(WORLD)]
    return {"ranks": ranks, "tmp": tmp, "jt": jt, "init": init}


@pytest.mark.parametrize("n", [0, 7, 8, 64, 70000, 70001, 69999])
@pytest.mark.parametrize("pcount", [1, 2, 3, 8])
def test_span_functions_match_jax(n, pcount):
    assert dist_lib.truncate_to_multiple(n, pcount) == jdist.truncate_to_multiple(n, pcount)
    m = dist_lib.truncate_to_multiple(n, pcount)
    idx = np.random.default_rng(n).permutation(m)
    for pidx in range(pcount):
        assert dist_lib.local_span(m, pidx, pcount) == jdist.local_span(m, pidx, pcount)
        np.testing.assert_array_equal(dist_lib.local_batch_indices(idx, pidx, pcount),
                                      jdist.local_batch_indices(idx, pidx, pcount))
    if n % pcount:
        with pytest.raises(ValueError):
            dist_lib.local_span(n, 0, pcount)


def test_mesh_shape_is_honoured_or_raises(monkeypatch):
    """One process (no group): ``mesh_shape`` [1] or unset trains; [2]
    raises where the JAX trainer would take fewer devices than asked."""
    over = {"data.allow_synthetic": True, "data.synthetic_size": 64, "batch_size": 16}
    assert not dist_lib.initialized() and dist_lib.process_count() == 1
    for shape in (None, [1]):
        cfg = load_config(MNIST, {**over, "train.mesh_shape": shape})
        assert mesh_lib.data_parallel_size(cfg) == 1
    cfg = load_config(MNIST, {**over, "train.mesh_shape": [2]})
    with pytest.raises(ValueError, match="mesh_shape"):
        Trainer(cfg, device="cpu")
    with pytest.raises(ValueError, match="mesh_shape"):
        mesh_lib.data_parallel_size(load_config(MNIST, {**over, "train.mesh_shape": [1, 1]}))
    # batch 16 over 3 ranks, as the JAX trainer's batch_size % n_dev
    monkeypatch.setattr(dist_lib, "process_count", lambda: 3)
    with pytest.raises(ValueError, match="divide evenly"):
        mesh_lib.data_parallel_size(load_config(MNIST, over))


@pytest.mark.parametrize("fcn", ["cosine", "euclidean"])
def test_sharded_fused_som_matches_jax(dp, fcn):
    from jax.sharding import Mesh

    data = np.load(dp["tmp"] / "som.npz")
    mesh = Mesh(np.asarray(jax.devices()), ("data",))
    assert mesh.devices.size == 8
    sharded = som_pallas.make_fused_som_sharded(SOM_MAP, "square", fcn, mesh)
    x, protos, temp = jnp.asarray(data["x"]), jnp.asarray(data["protos"]), jnp.float32(data["temp"])
    loss, bmu, dist = jax.jit(sharded)(x, protos, temp)
    dx, dp_ = jax.jit(jax.grad(lambda x, p: sharded(x, p, temp)[0], argnums=(0, 1)))(x, protos)
    for r in dp["ranks"]:
        t = r["som"][fcn]
        np.testing.assert_allclose(float(t["loss"]), float(loss), rtol=1e-6)
        np.testing.assert_array_equal(t["bmu"].numpy(), np.asarray(bmu))
        np.testing.assert_allclose(t["dist"].numpy(), np.asarray(dist), rtol=1e-5, atol=1e-6)
        np.testing.assert_allclose(t["dp"].numpy(), np.asarray(dp_), rtol=1e-4, atol=1e-7)
        np.testing.assert_allclose(t["dx"].numpy() / WORLD, np.asarray(dx), rtol=1e-4, atol=1e-7)


def test_sharded_batchnorm_matches_flax_global_batch(dp):
    import flax.linen as nn

    data = np.load(dp["tmp"] / "bn.npz")
    bn = nn.BatchNorm(use_running_average=False, momentum=0.99, epsilon=1e-5)
    x = jnp.asarray(data["x"])
    variables = bn.init(jax.random.key(0), x)
    params = {"scale": jnp.asarray(data["scale"]), "bias": jnp.asarray(data["bias"])}

    def loss(params, x):
        y, upd = bn.apply({"params": params, "batch_stats": variables["batch_stats"]}, x,
                          mutable=["batch_stats"])
        return (y * data["cot"]).mean(), (y, upd["batch_stats"])

    (_, (y, stats)), (g, gx) = jax.value_and_grad(loss, argnums=(0, 1), has_aux=True)(params, x)
    for r in dp["ranks"]:
        t = r["bn"]
        np.testing.assert_allclose(t["y"].numpy(), np.asarray(y), atol=1e-6, rtol=1e-6)
        np.testing.assert_allclose(t["dx"].numpy() / WORLD, np.asarray(gx), atol=1e-6, rtol=1e-6)
        np.testing.assert_allclose(t["dscale"].numpy(), np.asarray(g["scale"]), atol=1e-6, rtol=1e-6)
        np.testing.assert_allclose(t["dbias"].numpy(), np.asarray(g["bias"]), atol=1e-6, rtol=1e-6)
        np.testing.assert_allclose(t["mean"].numpy(), np.asarray(stats["mean"]), atol=1e-6, rtol=1e-6)
        np.testing.assert_allclose(t["var"].numpy(), np.asarray(stats["var"]), atol=1e-6, rtol=1e-6)


def test_two_rank_fit_matches_one_rank_and_jax(dp, tmp_path):
    r0, r1 = (r["fit"] for r in dp["ranks"])
    assert r0["world"] == r1["world"] == WORLD and r0["steps"] == r1["steps"] == 16
    # the ranks hold the same model and wrote the same (global) losses
    for k in r0["state"]:
        assert torch.equal(r0["state"][k], r1["state"][k]), k
    np.testing.assert_array_equal(r0["total_loss"], r1["total_loss"])
    # the port's one-rank fit of the same config and weights
    cfg = load_config(MNIST, {**FIT_OVERRIDES, "train.checkpoint_dir": str(tmp_path / "s"),
                              "train.log_dir": str(tmp_path / "l")})
    tr = Trainer(cfg, device="cpu")
    tr.model.load_state_dict(dp["init"])
    hist = tr.fit()
    assert tr.step == 16
    np.testing.assert_allclose(r0["total_loss"], hist["train/total_loss"], rtol=1e-4, atol=5e-5)
    for k, v in tr.model.state_dict().items():
        np.testing.assert_allclose(r0["state"][k].numpy(), v.numpy(), atol=5e-5, rtol=1e-4,
                                   err_msg=k)
    # the JAX trainer on the 8-device mesh, from the same weights
    jt = dp["jt"]
    final = convert.flax_to_state_dict(jax.device_get(jt.state.params))
    jcfg = jt.cfg
    sched = jsched.make_lr_schedule(jcfg.optimizer, jcfg.total_epochs, 8,
                                    joptim.base_learning_rate(jcfg))
    lr_max = max(float(sched(jnp.asarray(s))) for s in range(16))
    for k, v in final.items():
        t_upd = (r0["state"][k] - dp["init"][k]).numpy()
        j_upd = (v - dp["init"][k]).numpy()
        np.testing.assert_allclose(t_upd, j_upd, atol=2 * 16 * lr_max, rtol=0, err_msg=k)


def test_sharded_evaluation_is_global_on_every_rank(dp):
    r0, r1 = (r["fit"] for r in dp["ranks"])
    assert 0.0 <= r0["purity"] <= 1.0
    assert (r0["purity"], r0["nmi"]) == (r1["purity"], r1["nmi"])
    assert r0["kmeans"] == r1["kmeans"]
    assert r0["val"] == r1["val"]
    assert set(r0["val"]) == {"val/accuracy", "val/som_loss", "val/recon_loss", "val/total_loss"}


def test_only_rank_zero_writes(dp):
    """Each rank's trainer writes into its own directories, and the
    protocol into shared ones: rank 1 writes nothing."""
    tmp = dp["tmp"]
    assert not (tmp / "states1").exists() and not (tmp / "logs1").exists()
    assert (tmp / "protocol0.json").is_file() and not (tmp / "protocol1.json").exists()
    m0, m1 = (r["main"] for r in dp["ranks"])
    assert m0 == m1 and m0["steps"] == 2
    assert (tmp / "pstates" / "vit_som" / "mnist_run0_last" / "state.pt").is_file()
    assert len(list((tmp / "plogs").rglob("events.out.tfevents.*"))) == 1
    ckpt = tmp / "states0" / "vit_som" / "mnist_run0_last"
    assert (ckpt / "state.pt").is_file() and (ckpt / "vitsom_config.yaml").is_file()
    events = list((tmp / "logs0").rglob("events.out.tfevents.*"))
    assert len(events) == 1 and events[0].stat().st_size > 0


def test_masks_are_the_global_batch_rows(monkeypatch):
    """A dropout or drop-path mask on rank r of 2 is rows r of the mask the
    one-rank run draws from the same generator state."""
    from vitsom_tpu_torch.models import stochastic

    full = stochastic.bernoulli_mask(0.7, (8, 3, 5), torch.Generator().manual_seed(3), "cpu")
    for rank in range(WORLD):
        monkeypatch.setattr(dist_lib, "process_index", lambda: rank)
        monkeypatch.setattr(dist_lib, "process_count", lambda: WORLD)
        part = stochastic.bernoulli_mask(0.7, (4, 3, 5), torch.Generator().manual_seed(3), "cpu")
        assert torch.equal(part, full[rank * 4:(rank + 1) * 4])


def _concat_ranks(bufs, batch):
    """The ranks' epoch rows, batch after batch: each global batch is rank
    0's rows of it, then rank 1's."""
    per = [b.view(-1, batch // WORLD, *b.shape[1:]) for b in bufs]
    return torch.cat(per, dim=1).reshape(-1, *bufs[0].shape[1:])


@pytest.mark.parametrize("kind", ["mnist", "cifar_cls", "cifar_cluster", "cifar_streamed"])
def test_rank_buffers_make_the_one_rank_epoch(kind, monkeypatch):
    path, over = ((MNIST, {"data.allow_synthetic": True, "data.synthetic_size": 64,
                           "batch_size": 16}) if kind == "mnist"
                  else (CIFAR, {**SMALL_CIFAR, "data.num_classes": 10 if kind == "cifar_cls"
                                else 0}))
    cfg = load_config(path, over)
    if kind == "cifar_streamed":
        monkeypatch.setattr(tpipeline, "STREAM_BYTES", 1024)
    mods = [build_datamodule(cfg, device="cpu") for _ in range(WORLD + 1)]
    for r, dm in enumerate(mods[1:]):
        dm.shard(r, WORLD)
        assert dm.batch == cfg.batch_size // WORLD
    bufs = [dm.epoch_buffer() for dm in mods]
    for dm, buf in zip(mods, bufs):
        dm.fill_epoch(torch.Generator().manual_seed(1), buf, torch.Generator().manual_seed(2))
    if kind == "mnist":
        assert torch.equal(_concat_ranks(bufs[1:], cfg.batch_size), bufs[0])
        return
    assert torch.equal(_concat_ranks([b["label"] for b in bufs[1:]], cfg.batch_size),
                       bufs[0]["label"])
    if kind != "cifar_streamed":
        assert torch.equal(_concat_ranks([b["image"] for b in bufs[1:]], cfg.batch_size),
                           bufs[0]["image"])
        return
    assert all(dm.streams for dm in mods)
    for s in range(mods[0].steps_per_epoch):
        for dm, buf in zip(mods, bufs):
            dm.stream_batch(s, buf)
        assert torch.equal(torch.cat([b["image"] for b in bufs[1:]]), bufs[0]["image"])


@pytest.mark.parametrize("workers", [0, 2])
def test_host_path_rows_match_jax_process(workers, monkeypatch):
    """The host path's batches and the augmented clustering split's eval
    span of rank r equal the JAX package's on process r of 2 (its own rows
    through its own seeding, not the one-process images)."""
    over = {**SMALL_CIFAR, "data.num_classes": 0, "data.device_augment": False,
            "data.num_workers": workers}
    jdm = jpipeline.build_datamodule(jload_config(CIFAR, over))
    tdm = build_datamodule(load_config(CIFAR, over), device="cpu")
    try:
        for rank in range(WORLD):
            monkeypatch.setattr(jax, "process_count", lambda: WORLD)
            monkeypatch.setattr(jax, "process_index", lambda: rank)
            tdm.shard(rank, WORLD)
            jb = list(jdm.train_batches(0, seed=4))
            tb = list(tdm.train_batches(0, seed=4))
            assert len(jb) == len(tb) == tdm.steps_per_epoch
            for a, b in zip(jb, tb):
                np.testing.assert_array_equal(b["image"], a["image"])
                np.testing.assert_array_equal(b["label"], a["label"])
            from vitsom_tpu.eval import evaluate as jevaluate

            x, y = jevaluate._local_eval_span(jdm, jdm.train, True)
            span = list(tdm.span_eval_batches())
            np.testing.assert_array_equal(torch.cat([b["image"] for b in span]).numpy(), x)
            np.testing.assert_array_equal(torch.cat([b["label"] for b in span]).numpy(), y)
    finally:
        tdm.close()
        jpipeline.close_pools(jdm)
