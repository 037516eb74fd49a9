"""Build and load the CUDA kernels of this package.

The sources under ``csrc/`` have a plain C interface. At first use they are
compiled with ``nvcc`` for ``sm_90a`` into ``build/kernels/`` at the root of
the checkout (git-ignored), or, for an installed package, into
``$TORCH_EXTENSIONS_DIR/vgan_tpu_torch`` (default
``~/.cache/vgan_tpu_torch/kernels``), under a name keyed by
:func:`source_key` (the source, the ``csrc/*.cuh`` headers it includes and
the flags), and loaded with :mod:`ctypes`. A build failure raises with the
compiler's output.
Nothing here runs at import time.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import re
import shutil
import subprocess
import threading
import time
from pathlib import Path

CSRC = Path(__file__).resolve().parent / "csrc"


def _build_dir() -> Path:
    root = Path(__file__).resolve().parents[3]
    if (root / "pyproject.toml").is_file():
        return root / "build" / "kernels"
    ext = os.environ.get("TORCH_EXTENSIONS_DIR")
    if ext:
        return Path(ext) / "vgan_tpu_torch"
    return Path.home() / ".cache" / "vgan_tpu_torch" / "kernels"


BUILD_DIR = _build_dir()
NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
]

_lock = threading.Lock()  # guards _locks
_locks: dict = {}  # name -> the lock held while that source builds and loads
_libs: dict = {}
# name -> {"seconds": build seconds (0.0 when cached), "log": nvcc output}
build_info: dict = {}


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    default = Path(os.environ.get("CUDA_HOME", "/usr/local/cuda")) / "bin" / "nvcc"
    if default.is_file():
        return str(default)
    raise RuntimeError(
        "nvcc not found (neither on PATH nor under CUDA_HOME): the CUDA "
        "kernels of vgan_tpu_torch are built from source at first use"
    )


def source_key(src: Path) -> str:
    """Hash of ``src``, of every header of its directory that it includes
    (``#include "x.cuh"``, recursively) and of ``NVCC_FLAGS``: an edit to any
    of them builds a new library."""
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    seen, todo = set(), [src]
    while todo:
        path = todo.pop()
        if path in seen:
            continue
        seen.add(path)
        text = path.read_bytes()
        h.update(path.name.encode() + b"\0" + text)
        for inc in re.findall(rb'^\s*#\s*include\s+"([^"]+)"', text, flags=re.M):
            todo.append(path.parent / inc.decode())
    return h.hexdigest()[:16]


def load(name: str) -> ctypes.CDLL:
    """Build (if needed) and load ``csrc/<name>.cu`` as a shared library.
    Different sources may build at the same time from different threads."""
    with _lock:
        name_lock = _locks.setdefault(name, threading.Lock())
    with name_lock:
        lib = _libs.get(name)
        if lib is not None:
            return lib
        src = CSRC / f"{name}.cu"
        out = BUILD_DIR / f"lib{name}_{source_key(src)}.so"
        t0 = time.perf_counter()
        log = ""
        if not out.is_file():
            BUILD_DIR.mkdir(parents=True, exist_ok=True)
            tmp = out.with_suffix(f".{os.getpid()}.tmp")
            cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(src)]
            proc = subprocess.run(cmd, capture_output=True, text=True)
            log = proc.stdout + proc.stderr
            if proc.returncode != 0:
                raise RuntimeError(
                    f"nvcc failed ({proc.returncode}) building {src.name}:\n{log}"
                )
            os.replace(tmp, out)
        build_info[name] = {"seconds": time.perf_counter() - t0, "log": log}
        lib = ctypes.CDLL(str(out))
        _libs[name] = lib
        return lib
