"""Checkpoints of the port's trainer, on the CPU.

- a save and a restore into a fresh trainer give back every parameter and
  buffer (DESOM's BatchNorm statistics), AdamW's moments, step counts and
  lr tensors, and the device step, bitwise, for ViT-SOM clustering, ViT-SOM
  classification and DESOM with BatchNorm; the restored model evaluates as
  the saved one did;
- the embedded ``vitsom_config.yaml`` is, text for text, what the JAX
  package's ``save_checkpoint_config`` writes for the same config;
- ``check_checkpoint_config`` raises on the structural fields and warns on
  the schedules' fields exactly where the JAX package's does;
- a restore into a trainer that has already stepped (the captured step's
  situation on the card), and into a fresh one, followed by more steps,
  equals the uninterrupted run bitwise, across epoch boundaries;
- the ``best`` checkpoint holds the state of the epoch with the highest
  ``val/accuracy``.
"""

import os
import warnings

import numpy as np
import pytest
import torch

from vitsom_tpu.config import load_config as jload_config
from vitsom_tpu.train import trainer as jtrainer
from vitsom_tpu_torch.config import load_config
from vitsom_tpu_torch.train import trainer as ttrainer

MNIST = "configs/vit_som/vit_som_mnist.yaml"
CIFAR = "configs/vit_som/vit_som_cifar-10.yaml"
DESOM = "configs/desom/desom_mnist.yaml"


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Many small CPU ops: one torch thread per test worker (restored after)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)
NARROW = {"som.map_size": [4, 4], "vit.depth": 1, "vit.emb_dim": 16, "vit.heads": 2,
          "vit.dec_emb_dim": 8, "vit.dec_depth": 1}
KINDS = {
    # (config, overrides): 72 clustering images at B 16 (4 steps an epoch);
    # 32 + 8 classification images at B 8 (4 steps an epoch)
    "vit_som_clustering": (MNIST, {**NARROW, "batch_size": 16, "data.synthetic_size": 8}),
    "vit_som_cls": (CIFAR, {**NARROW, "batch_size": 8, "data.synthetic_size": 40}),
    "desom_batchnorm": (DESOM, {"batch_size": 16, "data.synthetic_size": 8,
                                "ae.encoder_dims": [32, 8], "ae.batch_norm": True}),
}


def make_cfg(kind, tmp_path, **extra):
    path, over = KINDS[kind]
    return load_config(path, {**over, "data.allow_synthetic": True, "total_epochs": 3,
                              "train.checkpoint_dir": str(tmp_path / "states"),
                              "train.log_dir": str(tmp_path / "logs"), **extra})


def snapshot(tr):
    """Every tensor a checkpoint holds, cloned to the CPU."""
    out = {f"model.{k}": v.detach().clone() for k, v in tr.model.state_dict().items()}
    for i, p in enumerate(tr.model.parameters()):
        for k, v in tr.optimizer.state[p].items():
            out[f"opt.{i}.{k}"] = v.detach().clone()
    for i, g in enumerate(tr.optimizer.param_groups):
        out[f"lr.{i}"] = g["lr"].detach().clone()
    for k in ("step", "epoch_start", "metrics"):
        out[f"state.{k}"] = getattr(tr.state, k).detach().clone()
    return out


def addresses(tr):
    """The storage address of every tensor a captured step reads."""
    tensors = list(tr.model.state_dict().values())
    tensors += [v for p in tr.model.parameters() for v in tr.optimizer.state[p].values()]
    tensors += [g["lr"] for g in tr.optimizer.param_groups]
    tensors += [tr.state.step, tr.state.epoch_start, tr.state.metrics]
    return [t.data_ptr() for t in tensors]


def assert_same(a, b):
    assert a.keys() == b.keys()
    for k in a:
        assert torch.equal(a[k], b[k]), k


@pytest.mark.parametrize("kind", list(KINDS))
def test_round_trip(kind, tmp_path):
    cfg = make_cfg(kind, tmp_path)
    tr = ttrainer.Trainer(cfg, device="cpu")
    tr.fit(max_steps=6)
    saved = snapshot(tr)
    before = tr.evaluate()
    path = tr.save_checkpoint("last")
    assert sorted(os.listdir(path)) == ["state.pt", "vitsom_config.yaml"]
    assert path == os.path.abspath(tmp_path / "states" / cfg.model_arch /
                                   f"{cfg.data.dataset}_run0_last")

    fresh = ttrainer.Trainer(cfg, device="cpu")
    assert fresh.step == 0 and not fresh.optimizer.state
    fresh.restore_checkpoint("last")
    assert fresh.step == 6 and fresh.current_temperature() == tr.current_temperature()
    assert_same(snapshot(fresh), saved)
    after = fresh.evaluate()
    for k in before:
        if k != "inference_time":
            assert after[k] == before[k], k
    if kind == "desom_batchnorm":
        assert not torch.equal(saved["model.autoencoder.encoder.bn_0.running_var"],
                               torch.ones(32))


@pytest.mark.parametrize("path", [MNIST, CIFAR, DESOM, "configs/desom/desom_flowers17.yaml"])
def test_config_file_matches_jax(path, tmp_path):
    over = {"batch_size": 32, "som.map_size": [5, 6], "train.seed": 3}
    (tmp_path / "jax").mkdir()
    (tmp_path / "port").mkdir()
    jtrainer.save_checkpoint_config(str(tmp_path / "jax"), jload_config(path, over))
    ttrainer.save_checkpoint_config(str(tmp_path / "port"), load_config(path, over))
    text = (tmp_path / "port" / "vitsom_config.yaml").read_text()
    assert text == (tmp_path / "jax" / "vitsom_config.yaml").read_text()
    assert ttrainer.load_checkpoint_config(str(tmp_path / "port")) == load_config(path, over)


# (override, what the check does): the structural fields raise, the
# schedules' fields warn, the rest pass silently
CHECKS = [
    ({"som.map_size": [3, 3]}, "raise"), ({"vit.emb_dim": 32}, "raise"),
    ({"ae.encoder_dims": [16, 4]}, "raise"), ({"model_arch": "vit"}, "raise"),
    ({"data.num_classes": 10}, "raise"), ({"data.num_channels": 3}, "raise"),
    ({"data.input_size": 32}, "raise"), ({"total_epochs": 7}, "warn"),
    ({"batch_size": 64}, "warn"), ({"gamma": 0.5}, "warn"), ({"optimizer.lr": 0.5}, "warn"),
    ({"train.seed": 9}, "pass"), ({"data.synthetic_size": 9}, "pass"),
]


@pytest.mark.parametrize("override,outcome", CHECKS)
def test_check_checkpoint_config_matches_jax(override, outcome, tmp_path):
    key = list(override)[0]
    field = key if key.startswith("data.") else key.split(".")[0]
    for mod, load in ((jtrainer, jload_config), (ttrainer, load_config)):
        d = tmp_path / mod.__name__
        d.mkdir()
        mod.save_checkpoint_config(str(d), load(MNIST))
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            if outcome == "raise":
                with pytest.raises(ValueError, match=f"mismatched: {field}"):
                    mod.check_checkpoint_config(str(d), load(MNIST, override))
            else:
                mod.check_checkpoint_config(str(d), load(MNIST, override))
        assert any("non-structural" in str(w.message) for w in caught) == (outcome == "warn")


@pytest.mark.parametrize("kind,save_at", [("vit_som_clustering", 3), ("vit_som_cls", 3),
                                          ("vit_som_clustering", 0)])
def test_restore_continues_as_uninterrupted(kind, save_at, tmp_path):
    """Steps up to ``save_at``, save, steps to 10 (crossing two epoch
    boundaries): state S. The same trainer restored to ``save_at`` and
    stepped to 10 reaches S, and so does a fresh trainer restored there. At
    step 0 the checkpoint holds no AdamW state, and the restore zeroes the
    stepped trainer's moments and counts."""
    cfg = make_cfg(kind, tmp_path)
    tr = ttrainer.Trainer(cfg, device="cpu")
    tr.fit(max_steps=save_at)
    tr.save_checkpoint("mid")
    tr.fit(max_steps=10, new_epoch=False)
    uninterrupted = snapshot(tr)
    assert tr.step == 10 and tr.epochs_done == 2

    held = addresses(tr)
    tr.restore_checkpoint("mid")
    assert tr.step == save_at and addresses(tr) == held  # copied in, nothing rebound
    tr.fit(max_steps=10)
    assert_same(snapshot(tr), uninterrupted)

    fresh = ttrainer.Trainer(cfg, device="cpu")
    fresh.restore_checkpoint("mid")
    fresh.fit(max_steps=10)
    assert_same(snapshot(fresh), uninterrupted)
    assert fresh.epochs_done == 2


def test_best_checkpoint_is_best_epoch(tmp_path, monkeypatch):
    """Each epoch's parameters are copied right after its validation; the
    ``best`` checkpoint equals the copy of the first epoch with the highest
    ``val/accuracy``."""
    cfg = make_cfg("vit_som_cls", tmp_path, total_epochs=4)
    tr = ttrainer.Trainer(cfg, device="cpu")
    copies = []
    validate = tr.validate

    def validate_and_copy(epoch):
        out = validate(epoch)
        copies.append({k: v.detach().clone() for k, v in tr.model.state_dict().items()})
        return out

    monkeypatch.setattr(tr, "validate", validate_and_copy)
    tr.fit()
    accs = [v["val/accuracy"] for v in tr.val_history]
    assert len(accs) == len(copies) == 4
    best = int(np.argmax(accs))
    ck = torch.load(os.path.join(tr.checkpoint_dir("best"), "state.pt"), weights_only=True)
    for k, v in copies[best].items():
        assert torch.equal(ck["model"][k], v), k
    assert tr.best_val_accuracy == accs[best]
