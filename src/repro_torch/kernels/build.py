"""Build the port's CUDA sources and load them with ctypes.

Each ``src/repro_torch/csrc/<name>.cu`` has a plain C interface and is
compiled on first use by ``nvcc`` for ``sm_90a`` into
``build/repro_torch/lib<name>.so`` at the root of the checkout, then loaded
with ``ctypes``. A library is rebuilt when its source is newer. ``build()``
starts one ``nvcc`` per source, all at once, and waits for them; a failed
build raises with the compiler's output. There is no fallback: without
``nvcc`` the kernels cannot run.
"""
from __future__ import annotations

import ctypes
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Dict, Sequence

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "repro_torch"
SOURCES = ("crossbar_matmul", "flash_attention", "rwkv6_wkv",
           "selective_scan", "moe_route")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas=-v")

_LOCK = threading.Lock()
_LOADED: Dict[str, ctypes.CDLL] = {}


def nvcc() -> str:
    path = shutil.which("nvcc")
    if path is None and os.path.exists("/usr/local/cuda/bin/nvcc"):
        path = "/usr/local/cuda/bin/nvcc"
    if path is None:
        raise RuntimeError("nvcc not found: the CUDA kernels of repro_torch "
                           "are built from source at first use")
    return path


def library_path(name: str) -> Path:
    return BUILD_DIR / f"lib{name}.so"


def _stale(name: str) -> bool:
    lib, src = library_path(name), CSRC / f"{name}.cu"
    return not lib.exists() or lib.stat().st_mtime < src.stat().st_mtime


def build(names: Sequence[str] = SOURCES, force: bool = False) -> Dict[str, str]:
    """Compile the given sources in parallel; returns each compiler log
    (``-Xptxas=-v`` register and shared-memory report). Raises on failure."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name in names:
        if not force and not _stale(name):
            continue
        tmp = BUILD_DIR / f"lib{name}.{os.getpid()}.tmp.so"
        cmd = [nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
        procs[name] = (tmp, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    logs, failed = {}, []
    for name, (tmp, proc) in procs.items():
        out, _ = proc.communicate()
        logs[name] = out
        if proc.returncode != 0:
            failed.append(f"--- nvcc {name}.cu (rc {proc.returncode}) ---\n{out}")
            tmp.unlink(missing_ok=True)
        else:
            os.replace(tmp, library_path(name))
    if failed:
        raise RuntimeError("CUDA kernel build failed:\n" + "\n".join(failed))
    return logs


def load(name: str) -> ctypes.CDLL:
    """The loaded library for ``name``, building it first if needed."""
    with _LOCK:
        lib = _LOADED.get(name)
        if lib is None:
            if _stale(name):
                build([name])
            lib = ctypes.CDLL(str(library_path(name)))
            _LOADED[name] = lib
        return lib
