"""The port's one ``ctypes`` boundary: build, load and bind the CUDA kernels
of this package, launch their entries, and count the launches.

The sources under ``csrc/`` have a plain C interface. At first use they are
compiled with ``nvcc`` for ``sm_90a`` into ``build/kernels/`` at the root of
the checkout (git-ignored), or, for an installed package, into
``$TORCH_EXTENSIONS_DIR/vgan_tpu_torch`` (default
``~/.cache/vgan_tpu_torch/kernels``), under a name keyed by
:func:`source_key` (the source, the ``csrc/*.cuh`` headers it includes and
the flags), and loaded with :mod:`ctypes`. A build failure raises with the
compiler's output.

Each kernel module keeps its entries' signatures (``_SIGNATURES``) beside
its wrappers and binds them through :func:`bound`; its wrappers call
:func:`launch` and count through :func:`count`. :func:`built_from` runs a
module's wrappers on a build of the same source from another directory (an
earlier commit's ``csrc/``, or a probe's variant of it).
Nothing here runs at import time.
"""

from __future__ import annotations

import contextlib
import ctypes
import hashlib
import os
import re
import shutil
import subprocess
import threading
import time
from pathlib import Path

import torch

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
_locks: dict = {}  # library path -> the lock held while it builds and loads
_libs: dict = {}  # library path -> its CDLL
# name (a source of another directory: its resolved path) -> {"seconds":
# build seconds (0.0 when cached), "log": nvcc output}
build_info: dict = {}
_bound: dict = {}  # (name, csrc directory) -> its CDLL, bound
_dirs: dict = {}  # name -> the directory its wrappers build from (built_from)
_launches: dict = {}  # count key -> launches


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


def load(name: str, csrc: Path = CSRC) -> ctypes.CDLL:
    """Build (if needed) and load ``<csrc>/<name>.cu`` as a shared library,
    into the one build directory under its :func:`source_key`: a source of
    another directory equal to this package's loads the same library.
    Different sources may build at the same time from different threads."""
    src = Path(csrc).resolve() / f"{name}.cu"
    out = BUILD_DIR / f"lib{name}_{source_key(src)}.so"
    with _lock:
        out_lock = _locks.setdefault(out, threading.Lock())
    with out_lock:
        lib = _libs.get(out)
        if lib is not None:
            return lib
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
                    f"nvcc failed ({proc.returncode}) building {src}:\n{log}"
                )
            os.replace(tmp, out)
        key = name if src.parent == CSRC else str(src)
        build_info[key] = {"seconds": time.perf_counter() - t0, "log": log}
        lib = _libs[out] = ctypes.CDLL(str(out))
        return lib


def bound(name: str, signatures: dict) -> ctypes.CDLL:
    """The library of ``csrc/<name>.cu`` (or of the directory that a
    :func:`built_from` block gives ``name``), loaded once, each entry of
    ``signatures`` (entry -> argtypes) given its argtypes and an int
    restype. An entry the source does not define (an earlier commit's)
    stays unbound."""
    key = (name, _dirs.get(name, CSRC))
    lib = _bound.get(key)
    if lib is None:
        lib = load(name, key[1])
        for entry, argtypes in signatures.items():
            fn = getattr(lib, entry, None)
            if fn is not None:
                fn.argtypes, fn.restype = argtypes, ctypes.c_int
        _bound[key] = lib
    return lib


@contextlib.contextmanager
def built_from(name: str, csrc: Path):
    """Within the block, the wrappers of kernel module ``name`` launch the
    entries of ``<csrc>/<name>.cu`` (the same C interface, built as
    :func:`load` builds; the headers it includes beside it)."""
    saved = _dirs.get(name)
    _dirs[name] = Path(csrc)  # not resolved: a probe enters this on every call
    try:
        yield
    finally:
        if saved is None:
            del _dirs[name]
        else:
            _dirs[name] = saved


def launch(lib: ctypes.CDLL, entry: str, device, *args) -> None:
    """Call ``entry`` of ``lib`` with ``args`` and the current stream of
    ``device``; raise on a nonzero return (a launch error)."""
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        rc = getattr(lib, entry)(*args, stream)
    if rc != 0:
        raise RuntimeError(f"{entry}: CUDA error {rc} at launch")


# ---------------------------------------------------------------------------
# launch counts
# ---------------------------------------------------------------------------


def count(key: str) -> None:
    _launches[key] = _launches.get(key, 0) + 1


def counts(keys) -> dict:
    return {key: _launches.get(key, 0) for key in keys}


def reset(keys) -> None:
    for key in keys:
        _launches[key] = 0


# ---------------------------------------------------------------------------
# operands
# ---------------------------------------------------------------------------


def cdiv(a: int, b: int) -> int:
    return -(-a // b)


def round_up(a: int, b: int) -> int:
    return cdiv(a, b) * b


def check(name: str, t: torch.Tensor, shape, device, dtype=torch.float32) -> None:
    """Raise unless ``t`` is a contiguous ``dtype`` tensor of ``shape`` on
    ``device``: what an entry's pointer arguments assume."""
    if t.dtype != dtype:
        raise TypeError(f"{name}: expected {dtype}, got {t.dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: expected shape {tuple(shape)}, got {tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: expected a contiguous tensor")
    if t.device != device:
        raise ValueError(f"{name}: expected a tensor on {device}, got {t.device}")


def column_major(x: torch.Tensor, rows_multiple: int) -> torch.Tensor:
    """(d, N) float32 copy of the (n, d) rows ``x``, column-major, zero-padded
    to N = n rounded up to ``rows_multiple``: the operand layout of
    ``csrc/dist_tile.cuh``, where a column is one contiguous run of rows."""
    n, d = x.shape
    out = torch.zeros((d, round_up(n, rows_multiple)), dtype=torch.float32, device=x.device)
    out[:, :n] = x.T
    return out
