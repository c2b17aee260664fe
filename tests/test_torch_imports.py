"""The port stands apart from the JAX package and never drifts to the CPU.

Importing ``vitsom_tpu_torch`` (every submodule) and ``chip_smoke`` in a
fresh interpreter must load no ``jax``, ``flax``, ``optax`` or
``vitsom_tpu`` module; and an entry point called without a device on a
machine without CUDA raises instead of running on the CPU.
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
             if m.split(".")[0] in ("jax", "jaxlib", "flax", "optax", "vitsom_tpu"))
print(len(names), all(f"vitsom_tpu_torch.ops.{m}" in names for m in ("attention_fused", "block_fused")))
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
    assert int(n_modules) >= 22 and has_kernel_modules == "True"
    assert bad == "BAD []", bad


def test_entry_points_refuse_cpu_without_cuda(monkeypatch):
    from vitsom_tpu_torch.config import load_config
    from vitsom_tpu_torch.data.synthetic import build_datamodule
    from vitsom_tpu_torch.models.vit_som import build_vit_som
    from vitsom_tpu_torch.train.trainer import Trainer

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = load_config(
        os.path.join(ROOT, "configs/vit_som/vit_som_mnist.yaml"),
        {"data.allow_synthetic": True, "data.synthetic_size": 64},
    )
    for call in (lambda: Trainer(cfg), lambda: build_vit_som(cfg),
                 lambda: build_datamodule(cfg)):
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            call()


def test_kernel_build_raises_without_nvcc(monkeypatch, tmp_path):
    """No nvcc means no kernel, and the build says so; nothing falls back."""
    import shutil

    from vitsom_tpu_torch.ops import _build

    monkeypatch.setattr(shutil, "which", lambda name: None)
    monkeypatch.delenv("CUDA_HOME", raising=False)
    monkeypatch.delenv("CUDA_PATH", raising=False)
    monkeypatch.setattr(os.path, "isfile", lambda path: False)
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path)
    for name in ("som_fused", "attention", "block"):
        with pytest.raises(RuntimeError, match="nvcc not found"):
            _build.load(name)
    assert list(tmp_path.iterdir()) == []
