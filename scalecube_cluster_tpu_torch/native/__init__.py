"""Native (C) runtime components with pure-Python fallbacks.

``load_codec()`` returns the compiled ``_sc_codec`` extension (the wire
codec of ``codec.c``, a copy of the JAX package's), building it on first use
with the system compiler into ``build/native/`` at the root of the checkout,
beside the CUDA kernels' ``build/torch_kernels/``. The library's name
carries a hash of the source, the flags and the interpreter's ABI, so an
edited source or another Python rebuilds. If no compiler is available the
caller falls back to the pure-Python implementation of the identical wire
format. Nothing here runs when the module is imported.
"""

from __future__ import annotations

import hashlib
import importlib.util
import logging
import os
import pathlib
import subprocess
import sysconfig

_log = logging.getLogger(__name__)
_DIR = pathlib.Path(__file__).resolve().parent
BUILD_DIR = _DIR.parent.parent / "build" / "native"
CC_FLAGS = ("-O2", "-shared", "-fPIC")


def library_path() -> pathlib.Path:
    """Where the codec of this source, these flags and this interpreter is
    built."""
    tag = " ".join(CC_FLAGS) + (sysconfig.get_config_var("SOABI") or "")
    digest = hashlib.sha256((_DIR / "codec.c").read_bytes() + tag.encode()).hexdigest()[:12]
    return BUILD_DIR / f"_sc_codec-{digest}.so"


def build_codec() -> bool:
    """Compile codec.c into :func:`library_path` unless it is built already.
    Returns success."""
    out = library_path()
    if out.exists():
        return True
    include = sysconfig.get_paths()["include"]
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f"{out.stem}.{os.getpid()}.tmp.so")
    cmd = ["cc", *CC_FLAGS, f"-I{include}", str(_DIR / "codec.c"), "-o", str(tmp)]
    try:
        subprocess.run(cmd, check=True, capture_output=True, timeout=120)
        os.replace(tmp, out)  # a concurrent builder's copy is as good
        return True
    except (OSError, subprocess.SubprocessError) as e:
        _log.info("native codec build failed (%s); using pure-Python fallback", e)
        tmp.unlink(missing_ok=True)
        return False


_BUILD_FAILED = False


def load_codec():
    """Import the native codec module, building it if missing; None if
    unavailable. A failed build is cached for the process lifetime so
    callers don't repeatedly shell out to the compiler."""
    global _BUILD_FAILED
    if _BUILD_FAILED:
        return None
    if not build_codec():
        _BUILD_FAILED = True
        return None
    spec = importlib.util.spec_from_file_location("_sc_codec", library_path())
    if spec is None or spec.loader is None:
        return None
    module = importlib.util.module_from_spec(spec)
    try:
        spec.loader.exec_module(module)
    except Exception as e:  # any load failure -> pure-Python wire
        _log.info("native codec load failed (%s); using pure-Python fallback", e)
        return None
    return module
