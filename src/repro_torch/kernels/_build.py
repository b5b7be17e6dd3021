"""Builds the CUDA sources under ``csrc/`` at first use and loads them.

Each ``csrc/<name>.cu`` becomes one shared library with a plain C interface,
compiled by ``nvcc`` for Hopper (``sm_90a``) into ``build/repro_torch/`` at
the repository root and loaded with ``ctypes``.  The library's file name
carries a hash of its source and flags, so an edited source is rebuilt and
a stale library is never loaded.  All sources that need a build are
compiled in parallel, one ``nvcc`` each.

No ``--use_fast_math``: it flushes denormals and relaxes inf/NaN handling,
and the min-plus kernel's bitwise claim rests on exact IEEE adds of +inf.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import pathlib
import shutil
import subprocess
import threading
import time
from typing import Dict

CSRC = pathlib.Path(__file__).resolve().parent / "csrc"
BUILD_DIR = pathlib.Path(__file__).resolve().parents[3] / "build" / "repro_torch"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas=-v")

_lock = threading.Lock()
_libs: Dict[str, ctypes.CDLL] = {}


def _nvcc() -> str:
    from torch.utils.cpp_extension import CUDA_HOME
    cand = os.path.join(CUDA_HOME, "bin", "nvcc") if CUDA_HOME else None
    path = cand if cand and os.path.exists(cand) else shutil.which("nvcc")
    if path is None:
        raise RuntimeError("nvcc not found: the CUDA kernels build only on a "
                           "machine with the CUDA toolkit")
    return path


def _target(src: pathlib.Path) -> pathlib.Path:
    h = hashlib.sha256(src.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"lib{src.stem}-{h.hexdigest()[:16]}.so"


def build_all() -> Dict[str, dict]:
    """Compile every source whose library is missing, in parallel.

    Returns ``{name: {"seconds": wall seconds of its nvcc (0.0 when the
    library was already built), "log": nvcc's output (ptxas register and
    shared-memory report)}}``.  Raises if any compile fails.
    """
    with _lock:
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        jobs, out = {}, {}
        t0 = time.perf_counter()
        for src in sorted(CSRC.glob("*.cu")):
            lib = _target(src)
            if lib.exists():
                out[src.stem] = {"seconds": 0.0, "log": ""}
                continue
            tmp = lib.with_suffix(f".{os.getpid()}.tmp")
            cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(src)]
            jobs[src.stem] = (lib, tmp, subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                text=True))
        failed = []
        for name, (lib, tmp, proc) in jobs.items():
            log, _ = proc.communicate()
            if proc.returncode != 0:
                failed.append(f"{name}: nvcc exited {proc.returncode}\n{log}")
                continue
            os.replace(tmp, lib)
            out[name] = {"seconds": time.perf_counter() - t0, "log": log}
        if failed:
            raise RuntimeError("kernel build failed:\n" + "\n".join(failed))
        return out


def library(name: str) -> ctypes.CDLL:
    """The loaded library built from ``csrc/<name>.cu`` (built if needed)."""
    lib = _libs.get(name)
    if lib is None:
        src = CSRC / f"{name}.cu"
        if not src.exists():
            raise FileNotFoundError(f"no CUDA source {src}")
        if not _target(src).exists():
            build_all()
        with _lock:
            lib = _libs.get(name)
            if lib is None:
                lib = _libs[name] = ctypes.CDLL(str(_target(src)))
    return lib
