"""The port's k-means, ``evaluate_kmeans`` and checkpoint evaluation
(``vitsom_tpu_torch/eval/{kmeans,evaluate,eval_checkpoint}.py``) against
sklearn and the JAX package, on the CPU.

Held:

- ``KMeans`` on well-separated blobs: the same partition as sklearn's
  ``KMeans(random_state=0, n_init=10)`` (NMI 1 between the two) with the
  inertia at rtol 1e-5 (float32 data; both sum in their own order); on
  overlapping data (local optima differ by seed), the inertia at most 1.01
  x sklearn's; the same seed twice bitwise; an empty cluster relocated;
- ``evaluate_kmeans`` on latents that both packages' eval steps compute
  the same way from the same images (a fixed projection plus a label
  offset: one well-defined optimum): purity and NMI equal to the JAX
  ``evaluate_kmeans`` (which fits sklearn's k-means), the drop-last batches
  and the JAX print line;
- ``eval_checkpoint.main(["--checkpoint", dir, "--cpu", ...])`` on a tiny
  DESOM (with and without BatchNorm) and a tiny ViT-SOM (4x4 map, one
  block each side) whose weights come from the Flax model through
  ``convert.py``: purity, NMI, QE and TE equal the JAX functions' on the
  same parameters and arrays at 1e-6, the figures written with
  ``--figures-dir``; a restore with no fit evaluates as the trainer that
  saved it, a classification checkpoint included. The JAX script's distance pass drops ``batch_stats``
  (``experiments/tests/eval_checkpoint.py:126``), so it raises for a
  BatchNorm DESOM, which the port evaluates on its running averages.
"""

import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import traverse_util

from vitsom_tpu.config import load_config as jload_config
from vitsom_tpu.data.pipeline import build_datamodule as jbuild_datamodule
from vitsom_tpu.eval import evaluate as jevaluate
from vitsom_tpu.eval import metrics as jmetrics
from vitsom_tpu.models.desom import DESOM as JDESOM
from vitsom_tpu.models.vit_som import ViTSOM as JViTSOM
from vitsom_tpu_torch import convert
from vitsom_tpu_torch.config import load_config
from vitsom_tpu_torch.data.synthetic import build_datamodule
from vitsom_tpu_torch.eval import eval_checkpoint
from vitsom_tpu_torch.eval import evaluate as tevaluate
from vitsom_tpu_torch.eval import metrics as tmetrics
from vitsom_tpu_torch.eval.kmeans import KMeans
from vitsom_tpu_torch.train.trainer import Trainer

DESOM = "configs/desom/desom_mnist.yaml"
MNIST = "configs/vit_som/vit_som_mnist.yaml"
SMALL = {"data.allow_synthetic": True, "data.synthetic_size": 64, "batch_size": 16,
         "som.map_size": [4, 4]}
KINDS = {
    "desom": (DESOM, {"ae.encoder_dims": [32, 8]}),
    "desom_batchnorm": (DESOM, {"ae.encoder_dims": [32, 8], "ae.batch_norm": True}),
    "vit_som": (MNIST, {"vit.depth": 1, "vit.emb_dim": 8, "vit.heads": 2, "vit.patch_size": 7,
                        "vit.dec_emb_dim": 4, "vit.dec_depth": 1}),
}


@pytest.fixture(autouse=True, scope="module")
def _two_torch_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _blobs(n_per, d, k, seed, sep):
    rng = np.random.default_rng(seed)
    centers = rng.normal(size=(k, d)) * sep
    x = np.concatenate([centers[i] + rng.normal(size=(n_per, d)) for i in range(k)])
    return x.astype(np.float32), np.repeat(np.arange(k), n_per)


# ---------------------------------------------------------------------------
# k-means
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("k,d", [(3, 5), (6, 10)])
def test_kmeans_matches_sklearn_on_blobs(k, d):
    from sklearn.cluster import KMeans as SKMeans

    x, y = _blobs(70, d, k, seed=k, sep=8.0)
    sk = SKMeans(n_clusters=k, random_state=0, n_init=10).fit(x)
    km = KMeans(n_clusters=k, random_state=0, n_init=10).fit(torch.from_numpy(x))
    labels = km.labels_.numpy()
    assert tmetrics.nmi(sk.labels_, labels) == pytest.approx(1.0, abs=1e-12)
    assert tmetrics.purity(y, labels) == 1.0
    assert km.inertia_ == pytest.approx(sk.inertia_, rel=1e-5)
    assert km.cluster_centers_.shape == (k, d) and km.n_iter_ >= 1


def test_kmeans_overlapping_inertia_near_sklearn():
    from sklearn.cluster import KMeans as SKMeans

    x, _ = _blobs(80, 6, 5, seed=11, sep=1.0)
    sk = SKMeans(n_clusters=8, random_state=0, n_init=10).fit(x)
    km = KMeans(n_clusters=8, random_state=0, n_init=10).fit(torch.from_numpy(x))
    assert km.inertia_ <= 1.01 * sk.inertia_, (km.inertia_, sk.inertia_)


def test_kmeans_deterministic_per_seed():
    x = torch.from_numpy(_blobs(50, 4, 4, seed=2, sep=1.5)[0])
    a, b = (KMeans(4, random_state=3).fit(x) for _ in range(2))
    assert torch.equal(a.labels_, b.labels_) and torch.equal(a.cluster_centers_,
                                                            b.cluster_centers_)
    assert a.inertia_ == b.inertia_ and torch.equal(a.init_centers_, b.init_centers_)


def test_kmeans_relocates_an_empty_cluster():
    """Lloyd from seeds one of which no point is nearest to: sklearn moves
    that centre onto the point farthest from its own centre."""
    from vitsom_tpu_torch.eval import kmeans

    x = torch.tensor([[0.0], [0.1], [0.2], [10.0], [10.1], [30.0]])
    centers = torch.tensor([[0.1], [10.0], [100.0]])
    out, labels, inertia, _ = kmeans.lloyd(x, centers, max_iter=10, tol=0.0)
    assert labels.tolist() == [0, 0, 0, 1, 1, 2]
    assert out.flatten().tolist() == pytest.approx([0.1, 10.05, 30.0])
    assert inertia == pytest.approx(0.02 + 0.005, abs=1e-5)


def _latent(x, label, w, offsets):
    """The latent both packages' test eval steps compute: a fixed
    projection of the flattened image plus a large offset by label."""
    return x.reshape(x.shape[0], -1) @ w + offsets[label]


def test_evaluate_kmeans_matches_jax(capsys):
    over = {"data.allow_synthetic": True, "data.synthetic_size": 100, "batch_size": 16}
    jcfg = jload_config(DESOM, over)
    tcfg = load_config(DESOM, over)
    rng = np.random.default_rng(0)
    w = (rng.normal(size=(784, 6)) * 0.05).astype(np.float32)
    offsets = (rng.normal(size=(10, 6)) * 20.0).astype(np.float32)

    def jstep(params, batch, t, batch_stats=None):
        return {"latent": _latent(batch["image"], batch["label"], jnp.asarray(w),
                                  jnp.asarray(offsets))}

    def tstep(batch, t=None):
        return {"latent": _latent(batch["image"], batch["label"], torch.from_numpy(w),
                                  torch.from_numpy(offsets))}

    jdm = jbuild_datamodule(jcfg)
    tdm = build_datamodule(tcfg, "cpu")
    jp, jn, _ = jevaluate.evaluate_kmeans(jax.jit(jstep), {}, jdm)
    tp, tn, dt = tevaluate.evaluate_kmeans(tstep, tdm)
    assert tp == pytest.approx(jp, abs=1e-12) and tn == pytest.approx(jn, abs=1e-12)
    assert 0.9 < tp <= 1.0 and dt > 0.0
    assert "Purity (KMeans): " in capsys.readouterr().out


# ---------------------------------------------------------------------------
# eval_checkpoint
# ---------------------------------------------------------------------------


def _setup(kind, tmp_path):
    """A port trainer on the CPU holding the Flax model's weights (and
    moved BatchNorm statistics), saved as ``last``; returns (trainer, the
    Flax model, its variables, the checkpoint dir)."""
    path, over = KINDS[kind]
    over = {**SMALL, **over, "train.checkpoint_dir": str(tmp_path / "states"),
            "train.log_dir": str(tmp_path / "logs")}
    tcfg = load_config(path, over)
    jcfg = jload_config(path, over)
    if tcfg.model_arch == "desom":
        jmodel = JDESOM(jcfg)
        v = jax.jit(jmodel.init)(jax.random.key(1), jnp.zeros((2, 784)))
    else:
        jmodel = JViTSOM(jcfg)
        v = jax.jit(jmodel.init)(jax.random.key(1), jnp.zeros((2, 28, 28, 1)))
    variables = jax.device_get(dict(v))
    if "batch_stats" in variables:
        rng = np.random.default_rng(9)
        flat = traverse_util.flatten_dict(variables["batch_stats"], sep="/")
        for k, s in flat.items():
            shift = rng.normal(scale=0.2, size=s.shape).astype(np.float32)
            flat[k] = s + (np.abs(shift) if k.endswith("var") else shift)
        variables["batch_stats"] = traverse_util.unflatten_dict(flat, sep="/")
    tr = Trainer(tcfg, device="cpu", run_id=0)
    tr.model.load_state_dict(
        convert.flax_to_state_dict(variables["params"], variables.get("batch_stats")),
        strict=True)
    return tr, jmodel, variables, tr.save_checkpoint("last")


def _jax_reference(tr, jmodel, variables):
    """Purity, NMI, QE and TE from the JAX model and the JAX metrics on the
    port's clustering arrays (the drop-last rows, distances of the first
    8192)."""
    cfg = tr.cfg
    n = eval_checkpoint.kept_rows(tr)
    x = tr.dm.images[:n].numpy()
    y = tr.dm.labels[:n].numpy()
    if cfg.model_arch == "desom":
        _, _, dist, bmu = jmodel.apply(variables, jnp.asarray(x.reshape(n, -1)))
    else:
        _, _, _, dist, bmu = jmodel.apply(variables, jnp.asarray(x))
    dist = np.asarray(dist)[:eval_checkpoint.DISTANCE_SAMPLES]
    return {"purity": jmetrics.purity(y, np.asarray(bmu)), "nmi": jmetrics.nmi(y, np.asarray(bmu)),
            "quantization_error": jmetrics.quantization_error(dist),
            "topographic_error": jmetrics.topographic_error(dist, cfg.som.map_size,
                                                            cfg.som.topology)}


@pytest.mark.parametrize("kind", ["desom", "desom_batchnorm", "vit_som"])
def test_eval_checkpoint_matches_jax(kind, tmp_path, capsys):
    tr, jmodel, variables, ckpt = _setup(kind, tmp_path)
    figs = tmp_path / "figures"
    results = eval_checkpoint.main(["--checkpoint", ckpt, "--cpu", "--figures-dir", str(figs)])
    want = _jax_reference(tr, jmodel, variables)
    for k, v in want.items():
        assert results[k] == pytest.approx(v, rel=1e-6, abs=1e-6), k
    keys = {"purity", "nmi", "inference_time", "quantization_error", "topographic_error"}
    if tr.cfg.model_arch == "desom":
        keys |= {"kmeans_purity", "kmeans_nmi"}
        assert 0.0 <= results["kmeans_purity"] <= 1.0
    assert set(results) == keys
    # a restore with no fit evaluates as the trainer that saved it
    saved = tr.evaluate()
    assert (results["purity"], results["nmi"]) == (saved["purity"], saved["nmi"])
    stem = f"{tr.cfg.model_arch}_{tr.cfg.data.dataset}"
    names = ["heatmap", "latents"] + (["prototypes"] if kind == "vit_som" else [])
    for name in names:
        assert os.path.getsize(figs / f"{stem}_{name}.png") > 1000, name
    out = capsys.readouterr().out
    assert "restored" in out and "topographic_error: " in out and "figures written" in out


def test_eval_checkpoint_with_config_and_override(tmp_path):
    """``--config`` + ``--checkpoint``, ``--no-kmeans`` and an
    ``--override``; without either flag the parser refuses."""
    tr, _, _, ckpt = _setup("desom", tmp_path)
    path, over = KINDS["desom"]
    argv = ["--config", path, "--checkpoint", ckpt, "--cpu", "--synthetic", "--no-kmeans"]
    for k, v in {**SMALL, **over, "train.log_dir": str(tmp_path / "logs")}.items():
        argv += ["--override", f"{k}={v}"]
    results = eval_checkpoint.main(argv)
    assert "kmeans_purity" not in results
    assert results["purity"] == tr.evaluate()["purity"]
    with pytest.raises(SystemExit):
        eval_checkpoint.main(["--cpu"])


def test_eval_checkpoint_classification(tmp_path):
    """A classification checkpoint: the test metrics of the restored state,
    equal to the saving trainer's own test eval, and nothing else."""
    over = {"data.allow_synthetic": True, "data.synthetic_size": 40, "batch_size": 8,
            "som.map_size": [4, 4], "vit.depth": 1, "vit.emb_dim": 16, "vit.heads": 2,
            "vit.dec_emb_dim": 8, "vit.dec_depth": 1,
            "train.checkpoint_dir": str(tmp_path / "states"),
            "train.log_dir": str(tmp_path / "logs")}
    tr = Trainer(load_config("configs/vit_som/vit_som_cifar-10.yaml", over), device="cpu")
    tr.fit(max_steps=2)
    want = tr.evaluate()
    path = tr.save_checkpoint("best")
    got = eval_checkpoint.main(["--checkpoint", path, "--tag", "best", "--cpu",
                                "--figures-dir", str(tmp_path / "figures")])
    assert set(got) == {"accuracy", "precision", "recall", "f1", "inference_time"}
    assert all(got[k] == want[k] for k in ("accuracy", "precision", "recall", "f1"))
    assert not (tmp_path / "figures").exists()  # clustering only


def test_reference_script_drops_batch_stats(tmp_path):
    """The JAX script's distance pass applies DESOM without ``batch_stats``
    (``experiments/tests/eval_checkpoint.py:126``): on a BatchNorm DESOM it
    raises Flax's ScopeCollectionNotFound, where the port evaluates (above).
    A fault of the reference, kept as it is."""
    from flax.errors import ScopeCollectionNotFound

    from vitsom_tpu.train.trainer import Trainer as JTrainer

    _, over = KINDS["desom_batchnorm"]
    cfg = jload_config(DESOM, {**SMALL, **over, "total_epochs": 1,
                               "train.checkpoint_dir": str(tmp_path / "states"),
                               "train.log_dir": str(tmp_path / "logs")})
    t = JTrainer(cfg, dm=jbuild_datamodule(cfg), run_id=0)
    t.save_checkpoint(tag="last")
    sys.path.insert(0, "experiments/tests")
    try:
        import eval_checkpoint as jscript

        with pytest.raises(ScopeCollectionNotFound):
            jscript.main(["--checkpoint", t.checkpoint_dir("last"), "--no-kmeans"])
    finally:
        sys.path.pop(0)
