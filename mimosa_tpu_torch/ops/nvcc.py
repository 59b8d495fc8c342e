"""The port's CUDA C++ sources built with ``nvcc`` into shared libraries.

A source is compiled for ``sm_90a`` at first use into
``build/mimosa_tpu_torch/``, named by the hash of its text and flags (so an
edit builds anew), and loaded with ``ctypes``. Nothing is built at import.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

CSRC = Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "mimosa_tpu_torch"
FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
         "-shared", "-Xcompiler", "-fPIC")


def nvcc():
    from torch.utils.cpp_extension import CUDA_HOME

    path = shutil.which("nvcc")
    if path is None and CUDA_HOME is not None:
        path = os.path.join(CUDA_HOME, "bin", "nvcc")
    if path is None or not os.path.exists(path):
        raise RuntimeError("nvcc not found: the CUDA toolkit is required to "
                           "build the port's CUDA sources")
    return path


def build(source: Path, flags=FLAGS):
    """Compile ``source`` (cached by source and flags) and load it:
    returns (library, seconds, compiler output or "cached")."""
    src = source.read_bytes()
    digest = hashlib.sha256(src + " ".join(flags).encode()).hexdigest()
    so = BUILD_DIR / f"lib{source.stem}-{digest[:16]}.so"
    t0 = time.perf_counter()
    log = "cached"
    if not so.exists():
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = so.with_suffix(f".{os.getpid()}.tmp")
        proc = subprocess.run([nvcc(), *flags, "-o", str(tmp), str(source)],
                              capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed on {source.name} "
                               f"({proc.returncode}):\n{proc.stdout}\n"
                               f"{proc.stderr}")
        os.replace(tmp, so)
        log = (proc.stdout + proc.stderr).strip()
    return ctypes.CDLL(str(so)), time.perf_counter() - t0, log
