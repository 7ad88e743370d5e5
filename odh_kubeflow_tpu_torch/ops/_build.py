"""Build the port's CUDA kernels from the sources in this checkout.

Each ``csrc/*.cu`` file compiles with ``nvcc`` for ``sm_90a`` into a shared
library with a plain C interface, which the op modules load with ctypes. A
library is built at first use into ``odh_kubeflow_tpu_torch/_build/`` (listed
in ``.gitignore``) under a name keyed on a hash of its source, the shared
``csrc/*.cuh`` headers and the flags, so later runs reuse it and an edited
source or header rebuilds. ``build_all`` starts one ``nvcc`` per source at
once. A missing ``nvcc`` or a failed build raises
``BuildError`` carrying the compiler's output; nothing falls back.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path
from typing import Dict, Iterable, Optional

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent.parent / "_build"
# kernel name -> source file under csrc/
SOURCES = {"flash_fwd": "flash_fwd.cu", "flash_bwd": "flash_bwd.cu"}
NVCC_CANDIDATES = ("/usr/local/cuda/bin/nvcc",)
NVCC_FLAGS = (
    "-O3", "-std=c++17", "-gencode", "arch=compute_90a,code=sm_90a",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v", "-lineinfo",
)

_lock = threading.Lock()
_libs: Dict[str, ctypes.CDLL] = {}
# name -> {"seconds": build wall time (0.0 when reused), "log": nvcc output}
build_info: Dict[str, dict] = {}


class BuildError(RuntimeError):
    """nvcc is missing or refused a source."""


def find_nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    for cand in NVCC_CANDIDATES:
        if os.path.isfile(cand) and os.access(cand, os.X_OK):
            return cand
    raise BuildError(
        "nvcc not found on PATH or at " + ", ".join(NVCC_CANDIDATES)
        + ": the port's CUDA kernels are built from source with the CUDA "
        "toolkit; on a machine without it, run on the CPU (device='cpu')"
    )


def library_path(name: str) -> Path:
    digest = hashlib.sha256((CSRC / SOURCES[name]).read_bytes())
    for header in sorted(CSRC.glob("*.cuh")):  # shared by every source
        digest.update(header.read_bytes())
    digest.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"{name}-{digest.hexdigest()[:16]}.so"


def build_all(names: Optional[Iterable[str]] = None) -> Dict[str, Path]:
    """Build every named kernel whose library is missing, one nvcc process
    per source, all started together. Returns name -> library path."""
    names = list(SOURCES if names is None else names)
    paths = {name: library_path(name) for name in names}
    todo = [n for n in names if not paths[n].exists()]
    for name in names:
        if name not in todo:
            build_info.setdefault(name, {"seconds": 0.0, "log": "(reused)"})
    if not todo:
        return paths
    nvcc = find_nvcc()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = {}
    t0 = time.perf_counter()
    for name in todo:
        tmp = paths[name].with_suffix(f".tmp{os.getpid()}.so")
        cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(CSRC / SOURCES[name])]
        procs[name] = (tmp, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        ))
    failures = []
    for name, (tmp, proc) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            failures.append(f"--- {name} (nvcc exit {proc.returncode}) ---\n{log}")
            tmp.unlink(missing_ok=True)
            continue
        os.replace(tmp, paths[name])
        build_info[name] = {"seconds": time.perf_counter() - t0, "log": log}
    if failures:
        raise BuildError("kernel build failed:\n" + "\n".join(failures))
    return paths


def load(name: str) -> ctypes.CDLL:
    """The kernel's shared library, built on first use."""
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            lib = ctypes.CDLL(str(build_all([name])[name]))
            _libs[name] = lib
        return lib
