"""The port stands apart from the JAX package and never drifts to the CPU.

Importing ``vitsom_tpu_torch`` (every submodule) and ``chip_smoke`` in a
fresh interpreter must load no ``jax``, ``flax``, ``optax`` or
``vitsom_tpu`` module, no ``sklearn`` or ``umap`` (the port has its own
k-means, PCA and UMAP), and no ``PIL``, ``h5py``, ``matplotlib`` or
``torchvision`` (the dataset readers import ``PIL``, ``h5py`` and ``scipy``
inside the functions that need them, the figures ``matplotlib`` inside the
drawing code: the card's machine had no h5py in the runs so far, and may
lack matplotlib; it has PIL, which the host augmentation path ran there);
and an entry point called without a device on a machine without CUDA
raises instead of running on the CPU.
"""

import os
import subprocess
import sys

import pytest
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_PROBE = r"""
import importlib, pkgutil, sys
import vitsom_tpu_torch
names = [m.name for m in pkgutil.walk_packages(vitsom_tpu_torch.__path__, "vitsom_tpu_torch.")]
for n in names:
    importlib.import_module(n)
import chip_smoke
bad = sorted(m for m in sys.modules
             if m.split(".")[0] in ("jax", "jaxlib", "flax", "optax", "vitsom_tpu", "PIL",
                                    "h5py", "torchvision", "sklearn", "matplotlib", "umap"))
print(len(names), all(m in names for m in (
    "vitsom_tpu_torch.ops.attention_fused", "vitsom_tpu_torch.ops.block_fused",
    "vitsom_tpu_torch.data.augment", "vitsom_tpu_torch.data.device_augment",
    "vitsom_tpu_torch.data.pipeline", "vitsom_tpu_torch.models.ae",
    "vitsom_tpu_torch.models.desom", "vitsom_tpu_torch.data.datasets",
    "vitsom_tpu_torch.utils.tb_writer", "vitsom_tpu_torch.utils.logging",
    "vitsom_tpu_torch.models.swin", "vitsom_tpu_torch.models.deit",
    "vitsom_tpu_torch.models.resnet", "vitsom_tpu_torch.models.stochastic",
    "vitsom_tpu_torch.models.mobile_vit", "vitsom_tpu_torch.data.host_augment",
    "vitsom_tpu_torch.eval.umap", "vitsom_tpu_torch.eval.viz", "vitsom_tpu_torch.eval.kmeans",
    "vitsom_tpu_torch.eval.eval_checkpoint", "vitsom_tpu_torch.ops.resize")))
print("BAD", bad)
"""


def test_port_imports_no_jax():
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run(
        [sys.executable, "-c", _PROBE], cwd=ROOT, env=env,
        capture_output=True, text=True, timeout=120,
    )
    assert out.returncode == 0, out.stderr
    counts, bad = out.stdout.strip().splitlines()[-2:]
    n_modules, has_kernel_modules = counts.split()
    assert int(n_modules) >= 47 and has_kernel_modules == "True"
    assert bad == "BAD []", bad


def test_entry_points_refuse_cpu_without_cuda(monkeypatch):
    from vitsom_tpu_torch.config import load_config
    from vitsom_tpu_torch.data.synthetic import build_datamodule
    from vitsom_tpu_torch.models.vit_som import build_model
    from vitsom_tpu_torch.train.trainer import Trainer

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = load_config(
        os.path.join(ROOT, "configs/vit_som/vit_som_mnist.yaml"),
        {"data.allow_synthetic": True, "data.synthetic_size": 64},
    )
    for call in (lambda: Trainer(cfg), lambda: build_model(cfg),
                 lambda: build_datamodule(cfg)):
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            call()


def test_classification_entry_points_refuse_cpu_without_cuda(monkeypatch):
    """The classification slice's entry points default to the card: the
    model builder for ``vit_som`` with a head and for ``vit``, the
    classification data module, and the trainer."""
    import inspect

    from vitsom_tpu_torch.config import load_config
    from vitsom_tpu_torch.data.pipeline import build_classification_datamodule
    from vitsom_tpu_torch.data.synthetic import build_datamodule
    from vitsom_tpu_torch.models.vit_som import build_model
    from vitsom_tpu_torch.train.trainer import Trainer

    for fn in (build_model, build_classification_datamodule, build_datamodule, Trainer):
        assert inspect.signature(fn).parameters["device"].default == "cuda", fn
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for path in ("configs/vit_som/vit_som_cifar-10.yaml", "configs/vit/vit_cifar-10.yaml"):
        cfg = load_config(os.path.join(ROOT, path),
                          {"data.allow_synthetic": True, "data.synthetic_size": 64})
        assert cfg.classification
        for call in (lambda: Trainer(cfg), lambda: build_model(cfg),
                     lambda: build_datamodule(cfg)):
            with pytest.raises(RuntimeError, match="CUDA is not available"):
                call()


def test_desom_entry_points_refuse_cpu_without_cuda(monkeypatch):
    """DESOM's entry points default to the card too: its model, the
    mnist clustering module, the static classification module
    (``desom_flowers17.yaml``) and the trainer."""
    from vitsom_tpu_torch.config import load_config
    from vitsom_tpu_torch.data.synthetic import build_datamodule
    from vitsom_tpu_torch.models.vit_som import build_model
    from vitsom_tpu_torch.train.trainer import Trainer

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for path in ("configs/desom/desom_mnist.yaml", "configs/desom/desom_flowers17.yaml"):
        cfg = load_config(os.path.join(ROOT, path),
                          {"data.allow_synthetic": True, "data.synthetic_size": 8})
        assert cfg.model_arch == "desom"
        for call in (lambda: Trainer(cfg), lambda: build_model(cfg),
                     lambda: build_datamodule(cfg)):
            with pytest.raises(RuntimeError, match="CUDA is not available"):
                call()


def test_baseline_entry_points_refuse_cpu_without_cuda(monkeypatch):
    """Swin's, DeiT's and MobileViT's entry points default to the card
    too: the model, the data module (MobileViT's at 224 streams its epoch;
    the jpg-shaped stand-in takes the host path) and the trainer (whose
    DeiT step builds the teacher on the model's device)."""
    from vitsom_tpu_torch.config import load_config
    from vitsom_tpu_torch.data.synthetic import build_datamodule
    from vitsom_tpu_torch.models.vit_som import build_model
    from vitsom_tpu_torch.train.trainer import Trainer

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for path, extra in (("configs/swin/swin_cifar-10.yaml", {}),
                        ("configs/deit/deit_cifar-10.yaml", {}),
                        ("configs/mobile_vit/mobile_vit_cifar-10.yaml", {}),
                        ("configs/mobile_vit/mobile_vit_flowers-17.yaml",
                         {"data.synthetic_object_array": True})):
        cfg = load_config(os.path.join(ROOT, path),
                          {"data.allow_synthetic": True, "data.synthetic_size": 8, **extra})
        for call in (lambda: Trainer(cfg), lambda: build_model(cfg),
                     lambda: build_datamodule(cfg)):
            with pytest.raises(RuntimeError, match="CUDA is not available"):
                call()


def test_bf16_entry_points_refuse_cpu_without_cuda(monkeypatch):
    """The bf16 paths default to the card: ViT-SOM under bf16 with the
    attention kernels and a bf16 first moment, Swin and DeiT under bf16.
    The kernel wrappers refuse a CPU tensor (bf16 included): on the CPU
    only the plain versions run, reached through ``attention_forward``."""
    from vitsom_tpu_torch.config import load_config
    from vitsom_tpu_torch.data.synthetic import build_datamodule
    from vitsom_tpu_torch.models.vit_som import build_model
    from vitsom_tpu_torch.ops import attention_fused
    from vitsom_tpu_torch.train.trainer import Trainer

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    bf16 = {"train.compute_dtype": "bfloat16"}
    for path, extra in (("configs/vit_som/vit_som_mnist.yaml",
                         {**bf16, "train.attn_impl": "pallas", "train.adam_mu_dtype": "bfloat16"}),
                        ("configs/swin/swin_cifar-10.yaml", {**bf16, "train.attn_impl": "xla_bf16"}),
                        ("configs/deit/deit_cifar-10.yaml", {**bf16, "train.attn_impl": "xla_bf16s"})):
        cfg = load_config(os.path.join(ROOT, path),
                          {"data.allow_synthetic": True, "data.synthetic_size": 8, **extra})
        for call in (lambda: Trainer(cfg), lambda: build_model(cfg),
                     lambda: build_datamodule(cfg)):
            with pytest.raises(RuntimeError, match="CUDA is not available"):
                call()
    x = torch.zeros(1, 9, 16, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="CUDA"):
        attention_fused._kernel_forward(x, x, x, 2)


def test_protocol_main_refuses_cpu_without_device_flag(monkeypatch, tmp_path):
    """The N-run protocol defaults to the card: without ``--device cpu`` on
    a machine without CUDA it raises before it reads data or clears a
    state directory."""
    from vitsom_tpu_torch.train import trainer

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        trainer.main(["--config", "configs/vit_som/vit_som_mnist.yaml", "--synthetic",
                      "--override", f"train.checkpoint_dir={tmp_path / 'states'}"])
    assert not (tmp_path / "states").exists()


def test_eval_checkpoint_refuses_cpu_without_cuda_flag(monkeypatch, tmp_path):
    """Checkpoint evaluation defaults to the card: without ``--cpu`` on a
    machine without CUDA it raises before it reads a config or data."""
    from vitsom_tpu_torch.eval import eval_checkpoint

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        eval_checkpoint.main(["--checkpoint", str(tmp_path / "missing")])


def test_kernel_build_raises_without_nvcc(monkeypatch, tmp_path):
    """No nvcc means no kernel, and the build says so; nothing falls back."""
    import shutil

    from vitsom_tpu_torch.ops import _build

    monkeypatch.setattr(shutil, "which", lambda name: None)
    monkeypatch.delenv("CUDA_HOME", raising=False)
    monkeypatch.delenv("CUDA_PATH", raising=False)
    monkeypatch.setattr(os.path, "isfile", lambda path: False)
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path)
    for name in ("som_fused", "attention", "attention_bf16", "block"):
        with pytest.raises(RuntimeError, match="nvcc not found"):
            _build.load(name)
    assert list(tmp_path.iterdir()) == []


def test_parallel_clustering_and_figure_modules_import_no_jax():
    """The data-parallel modules, the clustering data module's and the
    paper-figure script load no ``jax`` and nothing of ``vitsom_tpu``, and
    no matplotlib until a figure is drawn."""
    probe = (
        "import sys\n"
        "import vitsom_tpu_torch.parallel.distributed, vitsom_tpu_torch.parallel.mesh\n"
        "import vitsom_tpu_torch.eval.plot_paper_figure, vitsom_tpu_torch.data.pipeline\n"
        "from vitsom_tpu_torch.data.pipeline import ClusteringDataModule\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'jaxlib', 'flax', 'optax', 'vitsom_tpu', 'matplotlib'))\n"
        "print('BAD', bad)\n")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run([sys.executable, "-c", probe], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip().splitlines()[-1] == "BAD []"
