"""TensorBoard logging and the N-run protocol of the port, on the CPU.

- the port's event writer against the JAX package's: the same file name
  and the same bytes for the same scalars, images and wall time (the port
  encodes PNG with zlib alone, the JAX package with PIL), and crc32c;
- the (tag, step) pairs a tiny DESOM run logs (train metrics, throughput,
  image grids; validation for classification) equal the JAX trainer's;
- ``aggregate_runs`` equals the JAX package's;
- the protocol ``main`` with two runs on the CPU: each run's state
  directory cleared, clustering evaluated after save -> restore of
  ``last``, the harness's keys in ``--json-out``, the "Mean (Std)" lines.
"""

import json
import os
import time

import numpy as np
import pytest
import torch

from vitsom_tpu.config import load_config as jload_config
from vitsom_tpu.data.pipeline import build_datamodule as jbuild_datamodule
from vitsom_tpu.eval import metrics as jmetrics
from vitsom_tpu.train.trainer import Trainer as JTrainer
from vitsom_tpu.utils import tb_writer as jtb
from vitsom_tpu_torch.config import load_config
from vitsom_tpu_torch.eval import metrics as tmetrics
from vitsom_tpu_torch.train import trainer as ttrainer
from vitsom_tpu_torch.utils import tb_writer as ttb
from vitsom_tpu_torch.utils.logging import MetricLogger

DESOM = "configs/desom/desom_mnist.yaml"


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Many small CPU ops: one torch thread per test worker (restored after)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _event_file(log_dir):
    files = [os.path.join(dp, f) for dp, _, fs in os.walk(log_dir) for f in fs
             if f.startswith("events.out.tfevents.")]
    assert len(files) == 1, files
    return files[0]


def test_event_records_match_jax(tmp_path, monkeypatch):
    monkeypatch.setattr(time, "time", lambda: 1700000000.375)
    rng = np.random.default_rng(0)
    images = [rng.uniform(size=(8, 8, 3)), rng.uniform(size=(28, 28, 1)),
              rng.uniform(-0.5, 1.5, size=(5, 7)),
              np.kron(rng.uniform(size=(40, 40, 3)), np.ones((8, 8, 1))),
              (rng.uniform(size=(6, 9, 4)) * 255).astype(np.uint8)]
    for mod in (jtb, ttb):
        w = mod.EventFileWriter(str(tmp_path / mod.__name__))
        for step, (tag, v) in enumerate([("train/recon_loss", 0.5), ("hp/lr", 3.0e-4),
                                         ("val/accuracy", 1.0), ("perf/x", -7.25e9)]):
            w.add_scalar(tag, v, global_step=step * 1000003)
        for i, img in enumerate(images):
            w.add_image(f"images/{i}", img, global_step=i)
        w.close()
    [j_file], [t_file] = (os.listdir(tmp_path / m.__name__) for m in (jtb, ttb))
    assert j_file == t_file
    j_bytes = (tmp_path / jtb.__name__ / j_file).read_bytes()
    assert (tmp_path / ttb.__name__ / t_file).read_bytes() == j_bytes
    assert len(ttb.read_records(str(tmp_path / ttb.__name__ / t_file))) == 1 + 4 + 5


@pytest.mark.parametrize("n", [0, 1, 9, 15, 16, 17, 255, 4099])
def test_crc32c_matches_jax(n):
    data = np.random.default_rng(n).integers(0, 256, size=n, dtype=np.uint8).tobytes()
    assert ttb.crc32c(data) == jtb.crc32c(data)
    assert ttb._masked_crc(data) == jtb._masked_crc(data)
    assert ttb.crc32c(b"123456789") == 0xE3069283


def test_metric_logger_history_and_file(tmp_path):
    logger = MetricLogger(str(tmp_path))
    logger.log_scalars({"train/total_loss": 1.5, "hp/lr": 0.25}, step=7)
    logger.log_image("images/input", np.zeros((4, 4, 1)), step=7)
    logger.close()
    assert logger.history["train/total_loss"] == [(7, 1.5)]
    assert ttb.read_tags(logger.path) == [("train/total_loss", 7), ("hp/lr", 7),
                                          ("images/input", 7)]
    assert MetricLogger().path is None


@pytest.mark.parametrize("classification", [False, True])
def test_logged_tags_match_jax_trainer(classification, tmp_path):
    """Two epochs of a tiny DESOM run with image grids every epoch: the same
    (tag, step) pairs in both packages' event files."""
    over = {"total_epochs": 2, "batch_size": 16, "data.allow_synthetic": True,
            "data.synthetic_size": 64, "ae.encoder_dims": [32, 8], "som.map_size": [4, 4],
            "train.log_images_every_n_epochs": 1,
            "train.checkpoint_dir": str(tmp_path / "states")}
    if classification:
        over["data.num_classes"] = 10
    jcfg = jload_config(DESOM, {**over, "train.log_dir": str(tmp_path / "jax")})
    jt = JTrainer(jcfg, dm=jbuild_datamodule(jcfg))
    jt.fit()
    jt.logger.close()
    tcfg = load_config(DESOM, {**over, "train.log_dir": str(tmp_path / "port")})
    tt = ttrainer.Trainer(tcfg, device="cpu")
    tt.fit()
    tt.logger.close()
    j_tags = set(ttb.read_tags(_event_file(tmp_path / "jax")))
    t_tags = set(ttb.read_tags(_event_file(tmp_path / "port")))
    assert t_tags == j_tags
    spe = tt.dm.steps_per_epoch
    assert ("images/decoded_prototypes", 2 * spe) in t_tags
    assert ("val/accuracy", spe) in t_tags if classification else ("train/som_loss", spe) in t_tags
    assert os.path.dirname(_event_file(tmp_path / "port")) == str(
        tmp_path / "port" / "desom" / "mnist" / "run_0")


def test_aggregate_runs_matches_jax():
    runs = {"purity": [0.5, 0.75, 0.625], "nmi": [0.1], "accuracy": [],
            "run_duration": [12.5, 13.25]}
    assert tmetrics.aggregate_runs(runs) == jmetrics.aggregate_runs(runs)


def test_protocol_main_on_cpu(tmp_path, capsys, monkeypatch):
    calls = []
    for name in ("save_checkpoint", "restore_checkpoint", "evaluate"):
        def spy(self, *args, _orig=getattr(ttrainer.Trainer, name), _name=name, **kw):
            calls.append((_name, args[0] if args else kw.get("tag")))
            return _orig(self, *args, **kw)

        monkeypatch.setattr(ttrainer.Trainer, name, spy)
    out = tmp_path / "runs.json"
    results = ttrainer.main([
        "--config", "configs/vit_som/vit_som_mnist.yaml", "--synthetic", "--runs", "2",
        "--epochs", "1", "--device", "cpu", "--batch-size", "16", "--json-out", str(out),
        "--override", "data.synthetic_size=8", "--override", "som.map_size=[4, 4]",
        "--override", "vit.depth=1", "--override", "vit.dec_depth=1",
        "--override", f"train.checkpoint_dir={tmp_path / 'states'}",
        "--override", f"train.log_dir={tmp_path / 'logs'}",
    ])
    assert calls == [("save_checkpoint", "last"), ("restore_checkpoint", "last"),
                     ("evaluate", None)] * 2
    payload = json.loads(out.read_text())
    # the CPU has no peak memory counter: peak_memory_gb is written on the card only
    assert set(payload) == {"purity", "nmi", "run_duration", "inference_time",
                            "images_per_sec_per_chip"}
    assert all(len(v) == 2 for v in payload.values())
    assert payload["purity"] == [r["purity"] for r in results]
    assert [r["steps"] for r in results] == [4, 4]
    # each run clears the state directory before it starts
    assert os.listdir(tmp_path / "states" / "vit_som") == ["mnist_run1_last"]
    for run in (0, 1):
        tags = ttb.read_tags(_event_file(tmp_path / "logs" / "vit_som" / "mnist" / f"run_{run}"))
        assert ("train/recon_loss", 4) in tags and ("perf/images_per_sec_per_chip", 4) in tags
    text = capsys.readouterr().out
    assert "--- Aggregated Results Across 2 Runs for mnist ---" in text
    assert "Purity Mean (Std):" in text and "Avg Run_duration (Std):" in text
