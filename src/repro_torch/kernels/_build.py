"""Build-and-load for the port's hand-written CUDA kernels.

Each kernel source under ``kernels/*/csrc/`` is compiled with ``nvcc`` for
Hopper (``sm_90a``) into a shared library with a plain C interface and
loaded with :mod:`ctypes` — no PyTorch headers, so a build takes seconds.
The build happens at first use, from the repository's sources only, into
``kernels/_build/`` (listed in ``.gitignore``); the library's file name
carries a hash of every file in the source's ``csrc/`` directory (the
source and the headers it includes) and of the flags, so an edited source
or header rebuilds and an unchanged one is loaded as it is.

Nothing here runs at import: the CPU tests import every module, and this
host may have no ``nvcc``.  A failed build raises; there is no fallback.
"""
from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import pathlib
import shutil
import subprocess
import tempfile
import time
from typing import Dict, Tuple

import torch

KERNELS_DIR = pathlib.Path(__file__).resolve().parent
BUILD_DIR = KERNELS_DIR / "_build"

NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

# what the last build of each library printed (``-Xptxas -v``: registers,
# shared memory and spills per kernel) and how long it took, by name
BUILD_LOG: Dict[str, Tuple[float, str]] = {}


def nvcc_path() -> str:
    """``nvcc`` from ``CUDA_HOME``/``CUDA_PATH``, then ``PATH``, then the
    toolkit's default install prefix."""
    for env in ("CUDA_HOME", "CUDA_PATH"):
        root = os.environ.get(env)
        if root and (pathlib.Path(root) / "bin" / "nvcc").exists():
            return str(pathlib.Path(root) / "bin" / "nvcc")
    found = shutil.which("nvcc")
    if found:
        return found
    default = pathlib.Path("/usr/local/cuda/bin/nvcc")
    if default.exists():
        return str(default)
    raise RuntimeError("nvcc not found (set CUDA_HOME); the CUDA kernels "
                       "are built from source at first use")


def source_digest(src: pathlib.Path) -> str:
    """Hash of the flags and of every file in ``src``'s directory (names and
    bytes, in name order): what a build of ``src`` can read."""
    digest = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for path in sorted(src.parent.iterdir()):
        if path.is_file():
            digest.update(path.name.encode() + b"\0" + path.read_bytes())
    return digest.hexdigest()[:16]


@functools.lru_cache(maxsize=None)
def load_library(name: str, source: str) -> ctypes.CDLL:
    """Compile ``source`` (a path relative to ``kernels/``) into
    ``_build/lib<name>-<hash>.so`` unless that file exists, and load it.

    The compile writes to a temporary file in the build directory and
    renames it into place, so concurrent first calls never load a
    half-written library."""
    src = KERNELS_DIR / source
    digest = source_digest(src)
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    lib_path = BUILD_DIR / f"lib{name}-{digest}.so"
    if not lib_path.exists():
        fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
        os.close(fd)
        cmd = [nvcc_path(), *NVCC_FLAGS, "-o", tmp, str(src)]
        t0 = time.perf_counter()
        proc = subprocess.run(cmd, capture_output=True, text=True)
        seconds = time.perf_counter() - t0
        if proc.returncode != 0:
            os.unlink(tmp)
            raise RuntimeError(f"nvcc failed building {source} "
                               f"(rc={proc.returncode}):\n{proc.stderr}")
        os.replace(tmp, lib_path)
        BUILD_LOG[name] = (seconds, proc.stderr)
    return ctypes.CDLL(str(lib_path))


def check_launch(rc: int, op: str) -> None:
    """Raise unless a kernel's C entry point returned cudaSuccess (0)."""
    if rc != 0:
        raise RuntimeError(f"{op}: CUDA kernel launch failed with "
                           f"cudaError {rc}")


def stream_handle() -> int:
    """PyTorch's current CUDA stream, as the C entry points take it: the
    raw handle, without building the ``torch.cuda.Stream`` object that
    ``torch.cuda.current_stream()`` returns on every launch."""
    return torch._C._cuda_getCurrentRawStream(torch.cuda.current_device())
