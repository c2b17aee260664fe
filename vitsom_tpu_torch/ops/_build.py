"""Build the port's CUDA sources with nvcc and load them with ctypes.

Each ``csrc/<name>.cu`` exposes a plain C interface and is compiled at first
use into ``build/vitsom_tpu_torch/<name>-<hash>.so`` under the repository
root, the hash covering the source, every header it includes with
``#include "..."`` (``csrc/tf32_mma.cuh``) and the flags, so an edited
source or header is rebuilt and an unchanged one is reused. There is no
fallback: a missing nvcc or a failed build raises.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import re
import shutil
import subprocess
import time
from pathlib import Path
from typing import Dict

CSRC_DIR = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "vitsom_tpu_torch"
# --split-compile=0: the front end and ptxas work on a source's kernels in
# parallel, one thread a core (attention_bf16.cu's many instantiations took
# 81-128 s in one thread, 43.5 s so on the H100 machine's 8 cores)
NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
    "-Xptxas", "-v", "--split-compile=0",
]

# dynamic shared memory one CTA may opt into on Hopper (H100, H200); the
# kernel wrappers refuse shapes whose working set needs more
SMEM_LIMIT_BYTES = 232448

_LOADED: Dict[str, ctypes.CDLL] = {}


def _nvcc() -> str:
    candidates = [shutil.which("nvcc")]
    cuda_home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    if cuda_home:
        candidates.append(os.path.join(cuda_home, "bin", "nvcc"))
    candidates.append("/usr/local/cuda/bin/nvcc")
    for c in candidates:
        if c and os.path.isfile(c):
            return c
    raise RuntimeError(
        "nvcc not found (PATH, CUDA_HOME, /usr/local/cuda/bin): the port's "
        "CUDA kernels cannot be built"
    )


_INCLUDE = re.compile(rb'^\s*#\s*include\s+"([^"]+)"', re.MULTILINE)


def sources(name: str) -> list:
    """``csrc/<name>.cu`` and the headers it includes with ``#include
    "..."``, transitively, each once, in the order first met."""
    found, todo = [], [CSRC_DIR / f"{name}.cu"]
    while todo:
        path = todo.pop(0)
        if path in found:
            continue
        found.append(path)
        todo += [path.parent / inc.decode() for inc in _INCLUDE.findall(path.read_bytes())]
    return found


def target_path(name: str) -> Path:
    digest = hashlib.sha256()
    for path in sources(name):
        digest.update(path.name.encode() + b"\0" + path.read_bytes())
    digest.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"{name}-{digest.hexdigest()[:16]}.so"


def build(name: str) -> dict:
    """Compile ``csrc/<name>.cu`` unless it is built already.

    Returns ``{"path", "seconds", "log"}``; ``log`` holds ptxas's
    register/shared-memory report (``-Xptxas -v``) for a fresh build."""
    path = target_path(name)
    if path.exists():
        return {"path": str(path), "seconds": 0.0, "log": "cached"}
    nvcc = _nvcc()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    # nvcc writes a temporary name, renamed when complete, so a killed build
    # never leaves a truncated library behind under the cached name
    tmp = path.with_suffix(f".tmp{os.getpid()}.so")
    t0 = time.perf_counter()
    proc = subprocess.run(
        [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(CSRC_DIR / f"{name}.cu")],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
    )
    if proc.returncode != 0:
        raise RuntimeError(
            f"CUDA build of {name}.cu failed (nvcc exit {proc.returncode}):\n{proc.stdout}"
        )
    os.replace(tmp, path)
    return {"path": str(path), "seconds": time.perf_counter() - t0, "log": proc.stdout}


def load(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, built first if needed."""
    lib = _LOADED.get(name)
    if lib is None:
        lib = ctypes.CDLL(build(name)["path"])
        _LOADED[name] = lib
    return lib
