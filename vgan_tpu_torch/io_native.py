"""ctypes binding of the native tabular ingest engine (counterpart of
``vgan_tpu.io_native``).

``native/tabular_loader.cpp`` (this package's copy of the JAX package's
engine: an mmap'd, row-aligned, multithreaded ``strtod`` CSV parser) is
compiled with ``g++`` at first use into ``build/native/`` at the root of the
checkout (git-ignored), or, for an installed package, into
``~/.cache/vgan_tpu_torch/native``, under a name keyed by the source and the
flags: written to a temporary name and renamed, so that concurrent
processes do not race. The flags leave out ``-march=native``: a cached
library may outlive the host it was built on. This is host code, not a
kernel. Every entry point falls back to numpy when the library cannot be
built or loaded, or cannot parse a file, as in the JAX package.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path
from typing import Optional

import numpy as np

_SOURCE = Path(__file__).resolve().parent / "native" / "tabular_loader.cpp"
_FLAGS = ["-O3", "-std=c++17", "-fPIC", "-Wall", "-Wextra", "-shared", "-pthread"]
_lib = None
_lib_failed = False


def _build_dir() -> Path:
    root = Path(__file__).resolve().parents[1]
    if (root / "pyproject.toml").is_file():
        return root / "build" / "native"
    return Path.home() / ".cache" / "vgan_tpu_torch" / "native"


def _library_path() -> Path:
    key = hashlib.sha256(" ".join(_FLAGS).encode() + b"\0" + _SOURCE.read_bytes())
    return _build_dir() / f"libvgan_io_{key.hexdigest()[:16]}.so"


def _build(out: Path) -> None:
    compiler = os.environ.get("CXX") or shutil.which("g++") or "g++"
    out.parent.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    subprocess.run([compiler, *_FLAGS, "-o", str(tmp), str(_SOURCE)], check=True,
                   capture_output=True, timeout=120)
    os.replace(tmp, out)


def _load_library() -> Optional[ctypes.CDLL]:
    global _lib, _lib_failed
    if _lib is not None or _lib_failed:
        return _lib
    try:
        path = _library_path()
        if not path.exists():
            _build(path)
        lib = ctypes.CDLL(str(path))
        lib.vgan_csv_dims.argtypes = [ctypes.c_char_p, ctypes.POINTER(ctypes.c_long),
                                      ctypes.POINTER(ctypes.c_long),
                                      ctypes.POINTER(ctypes.c_int)]
        lib.vgan_csv_dims.restype = ctypes.c_int
        for name, ptr_t in (("vgan_csv_read_f32", ctypes.POINTER(ctypes.c_float)),
                            ("vgan_csv_read_f64", ctypes.POINTER(ctypes.c_double))):
            fn = getattr(lib, name)
            fn.argtypes = [ctypes.c_char_p, ptr_t, ctypes.c_long, ctypes.c_long,
                           ctypes.c_int, ctypes.c_int]
            fn.restype = ctypes.c_int
        for name, ptr_t in (("vgan_csv_read_range_f32", ctypes.POINTER(ctypes.c_float)),
                            ("vgan_csv_read_range_f64", ctypes.POINTER(ctypes.c_double))):
            fn = getattr(lib, name)
            fn.argtypes = [ctypes.c_char_p, ptr_t, ctypes.c_long, ctypes.c_long,
                           ctypes.c_long, ctypes.c_int, ctypes.c_int]
            fn.restype = ctypes.c_int
        _lib = lib
    except Exception:
        _lib_failed = True
        _lib = None
    return _lib


def native_available() -> bool:
    return _load_library() is not None


def load_csv(path, dtype=np.float64, nthreads: Optional[int] = None, skip_rows: int = 0,
             max_rows: Optional[int] = None) -> np.ndarray:
    """Parse a numeric CSV (an optional header row, blank lines skipped)
    into an (n, d) array.

    Native path: mmap + row-aligned multithreaded strtod. Falls back to
    ``numpy.loadtxt`` when the shared library cannot be built or loaded, or
    cannot parse the file. ``skip_rows`` / ``max_rows`` select a contiguous
    range of data rows (after any header)."""
    path = str(path)
    lib = _load_library()
    dtype = np.dtype(dtype)
    if lib is None or dtype not in (np.float32, np.float64):
        return _numpy_fallback(path, dtype, skip_rows, max_rows)
    rows, cols, header = ctypes.c_long(), ctypes.c_long(), ctypes.c_int()
    rc = lib.vgan_csv_dims(path.encode(), ctypes.byref(rows), ctypes.byref(cols),
                           ctypes.byref(header))
    if rc != 0:
        raise OSError(f"native CSV dims failed for {path} (rc={rc})")
    n_avail = max(rows.value - skip_rows, 0)
    n_read = n_avail if max_rows is None else min(max_rows, n_avail)
    out = np.empty((n_read, cols.value), dtype=dtype)
    if n_read == 0:
        return out
    if nthreads is None:
        nthreads = min(os.cpu_count() or 1, 16)
    f32 = dtype == np.float32
    ptr = out.ctypes.data_as(ctypes.POINTER(ctypes.c_float if f32 else ctypes.c_double))
    if skip_rows or max_rows is not None:
        fn = lib.vgan_csv_read_range_f32 if f32 else lib.vgan_csv_read_range_f64
        rc = fn(path.encode(), ptr, skip_rows, n_read, cols.value, header.value, nthreads)
    else:
        fn = lib.vgan_csv_read_f32 if f32 else lib.vgan_csv_read_f64
        rc = fn(path.encode(), ptr, n_read, cols.value, header.value, nthreads)
    if rc != 0:
        # a file the native parser rejects (ragged rows, other formats) may
        # still load in numpy: degrade, do not fail
        return _numpy_fallback(path, dtype, skip_rows, max_rows)
    return out


def _numpy_fallback(path: str, dtype, skip_rows: int = 0,
                    max_rows: Optional[int] = None) -> np.ndarray:
    """``numpy.loadtxt`` with the native parser's conventions: leading blank
    lines skipped, a first content line that does not parse as numbers is a
    header, ``skip_rows`` counts data rows, and a single column stays (n,
    1)."""
    with open(path) as fh:
        first_idx, first = 0, ""
        for line in fh:
            if line.strip():
                first = line
                break
            first_idx += 1
    try:
        [float(v) for v in first.strip().split(",")]
        skip = first_idx
    except ValueError:
        skip = first_idx + 1
    arr = np.loadtxt(path, delimiter=",", skiprows=skip, dtype=dtype, ndmin=2)
    end = None if max_rows is None else skip_rows + max_rows
    return arr[skip_rows:end]
