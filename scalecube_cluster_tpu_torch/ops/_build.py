"""Builds the port's CUDA sources and loads them with ``ctypes``.

Each ``csrc/<name>.cu`` exposes a plain C interface and compiles on its own
with ``nvcc`` into ``build/torch_kernels/lib<name>-<hash>.so`` at the root of
the checkout, the hash covering the source and the flags, so an edited
source rebuilds. ptxas reports each kernel's registers, stack and spills
(``-Xptxas -v``); the report is kept beside the library as
``lib<name>-<hash>.log`` (:func:`build_log`). A source builds at its first
use; nothing here runs when the module is imported.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import pathlib
import shutil
import subprocess
import sys

CSRC = pathlib.Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = CSRC.parent.parent / "build" / "torch_kernels"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

_LIBS: dict = {}


def _nvcc() -> str:
    for cand in (shutil.which("nvcc"), "/usr/local/cuda/bin/nvcc"):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError(
        "nvcc not found: the CUDA kernels build only where the CUDA toolkit is installed"
    )


def library_path(name: str) -> pathlib.Path:
    src = CSRC / f"{name}.cu"
    digest = hashlib.sha256(src.read_bytes() + " ".join(NVCC_FLAGS).encode()).hexdigest()[:12]
    return BUILD_DIR / f"lib{name}-{digest}.so"


def build(name: str) -> pathlib.Path:
    """Compile ``csrc/<name>.cu`` unless it is built already; returns the
    library's path. A failed compile raises, its output on stderr."""
    out = library_path(name)
    if not out.exists():
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = out.with_name(f"{out.stem}.{os.getpid()}.tmp.so")
        run = subprocess.run([_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")],
                             capture_output=True, text=True)
        if run.returncode != 0:
            sys.stderr.write(run.stdout + run.stderr)
            raise subprocess.CalledProcessError(run.returncode, run.args, run.stdout, run.stderr)
        out.with_suffix(".log").write_text(run.stdout + run.stderr)
        os.replace(tmp, out)
    return out


def build_log(name: str) -> str:
    """nvcc's output for ``csrc/<name>.cu`` (ptxas's per-kernel registers,
    stack and spills), building it first if needed."""
    return build(name).with_suffix(".log").read_text()


def library(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, built first if needed."""
    lib = _LIBS.get(name)
    if lib is None:
        lib = _LIBS[name] = ctypes.CDLL(str(build(name)))
    return lib
