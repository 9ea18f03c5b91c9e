"""The port's build cache: where its CUDA kernels are compiled to, and an
audit of what that directory holds.

The JAX package's ``compile_cache.py`` points JAX's persistent XLA cache at
a directory. The port compiles nothing through XLA: its one build cache is
the directory ``nvcc`` writes each kernel's library to
(:data:`.ops._build.BUILD_DIR`, ``build/torch_kernels/`` at the root of the
checkout by default; a library's name carries the hash of its source and
flags, so an edited source rebuilds and an unchanged one loads).

* :func:`enable_persistent_compile_cache` — point the kernel builds at
  ``<dir>/torch_kernels/``, the directory resolved as the JAX package
  resolves its own (explicit argument > ``ClusterConfig.sim.
  compile_cache_dir`` > ``SCALECUBE_COMPILE_CACHE_DIR``). One directory can
  so serve both packages without their files mixing.
* :func:`compile_cache_report` — what the build directory holds: the JAX
  report's keys (entry count, bytes, newest entry's age) and one line per
  built library (name, source hash, bytes, whether ptxas's log is kept).

The in-process side (which window functions ran, how often, and what the
first call cost) lives on the driver: ``SimDriver.jit_cache_audit()``.
"""

from __future__ import annotations

import os
import pathlib
import time
from typing import Any, Dict, Optional

from .ops import _build

ENV_VAR = "SCALECUBE_COMPILE_CACHE_DIR"
SUBDIR = "torch_kernels"

_enabled_dir: Optional[str] = None


def resolve_cache_dir(cache_dir: Optional[str] = None, config=None) -> Optional[str]:
    """Resolution order: explicit arg > ``config.sim.compile_cache_dir`` >
    ``SCALECUBE_COMPILE_CACHE_DIR`` env. None means "leave as it is"."""
    if cache_dir:
        return cache_dir
    if config is not None:
        sim = getattr(config, "sim", None)
        if sim is not None and getattr(sim, "compile_cache_dir", None):
            return sim.compile_cache_dir
    return os.environ.get(ENV_VAR) or None


def enable_persistent_compile_cache(cache_dir: Optional[str] = None, config=None) -> Optional[str]:
    """Point the kernel builds at ``<resolved dir>/torch_kernels/`` (created
    here; nothing is built). Returns the resolved directory, or None when no
    directory is configured anywhere — in which case nothing changes. A
    library already loaded in this process stays loaded."""
    global _enabled_dir
    path = resolve_cache_dir(cache_dir, config)
    if not path:
        return None
    if _enabled_dir != path:
        target = pathlib.Path(path) / SUBDIR
        target.mkdir(parents=True, exist_ok=True)
        _build.BUILD_DIR = target
        _enabled_dir = path
    return path


def compile_cache_report() -> Dict[str, Any]:
    """Build-directory audit: the JAX report's keys (``enabled`` — a
    configured directory is in effect; ``dir``; ``entries``; ``total_bytes``;
    ``newest_entry_age_s``) over the kernels' libraries, and ``libraries``,
    one line per built library (``lib<name>-<hash>.so``: the hash covers the
    source and the nvcc flags). One stat per file (this runs on every
    ``/dispatch`` poll)."""
    build_dir = _build.BUILD_DIR
    out: Dict[str, Any] = {
        "enabled": _enabled_dir is not None and build_dir == pathlib.Path(_enabled_dir) / SUBDIR,
        "dir": str(build_dir),
        "entries": 0,
        "total_bytes": 0,
        "newest_entry_age_s": None,
        "libraries": [],
    }
    if not build_dir.is_dir():
        return out
    stats = []
    for lib in sorted(build_dir.glob("lib*.so")):
        try:
            st = lib.stat()
        except OSError:  # replaced by a concurrent build
            continue
        stats.append(st)
        name, _, digest = lib.stem[len("lib"):].rpartition("-")
        out["libraries"].append({"name": name, "source_hash": digest, "bytes": int(st.st_size),
                                 "ptxas_log": lib.with_suffix(".log").is_file()})
    if stats:
        out["entries"] = len(stats)
        out["total_bytes"] = int(sum(s.st_size for s in stats))
        out["newest_entry_age_s"] = round(time.time() - max(s.st_mtime for s in stats), 1)
    return out
