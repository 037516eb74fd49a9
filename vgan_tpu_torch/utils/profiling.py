"""Profiling hooks: named spans at the port's layer boundaries and trace
capture (counterpart of ``vgan_tpu.utils.profiling``).

:func:`span` opens a named span while a profiler runs, and is a shared
null context otherwise: ``torch.profiler.profile``, the legacy
``torch.autograd.profiler.profile``, ``emit_nvtx`` and ``emit_itt`` open the
gate, nothing else does, so a run without a profiler pays a flag read and a
null context a span (about 0.4 µs on a CPU core). An open span enters ``torch.profiler.record_function`` (so it lands in
the trace on the clock of the device's operations, and in NVTX under
``emit_nvtx``), measures its host seconds, and, once CUDA is initialised,
records a CUDA event on the current stream at entry and at exit. Each span
adds to a table that :func:`span_table` reads and :func:`reset_spans`
clears, so the table holds every span recorded while a profiler ran.

A span's device time is its event pair's elapsed time: the device's
timeline from the stream reaching the span's first work to finishing its
last, idle inside included. Its self time is its time less its children's.
The program's spans, each with the children its self time leaves out:

- ``vgan::fit``, ``vgan::continue_fit``: an estimator's whole call
  (``vgan::epochs``);
- ``vgan::epochs``: the epochs of one chunk of a fit;
- ``vgan::step``: one training step of a batch;
- ``vgan::forward``: the batch to the loss value (``vgan::mmd.forward``);
- ``vgan::backward``: the step's ``torch.autograd.grad``
  (``vgan::mmd.backward``);
- ``vgan::adadelta``: the optimizer's update;
- ``vgan::mmd.forward``: the biased MMD² of a batch, every implementation;
- ``vgan::mmd.backward``: the MMD kernels' backward (the dense and chunked
  implementations' backward runs in autograd's own nodes, unspanned);
- ``vgan::decision_function``: a subspace ensemble's scoring call
  (``vgan::knn``, ``vgan::knn.generic``);
- ``vgan::knn``: the KNN kernel route's scores over every mask (K6 or K7);
- ``vgan::knn.generic``: a ``knn`` / ``knn_mean`` ensemble's scores of a
  mask shard on the generic route, past the kernels' limits, each counted
  by ``ops.cuda.knn_score.launch_counts()['knn_generic']``.

:func:`annotate` is :func:`span` as a decorator. :func:`trace_context`
captures a whole run into a Chrome / Perfetto trace file (open it at
ui.perfetto.dev or chrome://tracing).
"""

from __future__ import annotations

import contextlib
import functools
import threading
import time
from pathlib import Path

import torch
from torch.autograd import profiler as _autograd_profiler

_NULL = contextlib.nullcontext()


class _SpanTable:
    """Counts, host seconds and device seconds by span name; safe across
    threads (the MMD's backward span runs on autograd's engine thread)."""

    def __init__(self):
        self._lock = threading.Lock()
        self._rows = {}
        self._pending = []

    def add(self, name: str, host_s: float, start, end) -> None:
        with self._lock:
            row = self._rows.setdefault(name, [0, 0.0, None])
            row[0] += 1
            row[1] += host_s
            if start is not None:
                self._pending.append((name, start, end))

    def read(self) -> dict:
        """The table, each pending event pair resolved once its work is
        done (pairs wait for this: the profiler's own record of every
        operation grows faster than they do)."""
        with self._lock:
            if self._pending:
                torch.cuda.synchronize()
            for name, start, end in self._pending:
                row = self._rows[name]
                row[2] = (row[2] or 0.0) + start.elapsed_time(end) * 1e-3
            self._pending.clear()
            return {name: {"count": c, "host_s": h, "device_s": d}
                    for name, (c, h, d) in self._rows.items()}

    def clear(self) -> None:
        with self._lock:
            self._rows.clear()
            self._pending.clear()


_TABLE = _SpanTable()


def _event():
    """A timing event recorded on the current stream, or None before CUDA
    is initialised."""
    if not torch.cuda.is_initialized():
        return None
    ev = torch.cuda.Event(enable_timing=True)
    ev.record()
    return ev


class _Span:
    __slots__ = ("name", "_rf", "_t0", "_start")

    def __init__(self, name: str):
        self.name = name

    def __enter__(self):
        self._rf = torch.profiler.record_function(self.name)
        self._rf.__enter__()
        self._start = _event()
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        host_s = time.perf_counter() - self._t0
        end = _event() if self._start is not None else None
        self._rf.__exit__(*exc)
        _TABLE.add(self.name, host_s, self._start, end)
        return False


def span(name: str):
    """A context manager: the span ``name`` while a profiler runs (and not
    inside a ``torch.compile`` or ``torch.export`` trace), else one shared
    null context that records nothing. Whether it records is decided at
    entry, so its exit records exactly when its entry did."""
    if not _autograd_profiler._is_profiler_enabled or torch.compiler.is_compiling():
        return _NULL
    return _Span(name)


def span_table() -> dict:
    """``{name: {"count", "host_s", "device_s"}}`` over every span recorded
    since :func:`reset_spans`, which is only while a profiler ran: in the
    benchmark's runs (``benchmarks/harness/fit.py``, ``score.py``) the
    traced window alone. Synchronises once to resolve the pending CUDA
    events; ``device_s`` is None where no event was recorded (CUDA not
    initialised)."""
    return _TABLE.read()


def reset_spans() -> None:
    """Clears the table of :func:`span_table`."""
    _TABLE.clear()


def annotate(name: str):
    """Decorator: run the function inside :func:`span` ``name``."""

    def deco(fn):
        @functools.wraps(fn)
        def wrapped(*args, **kwargs):
            with span(name):
                return fn(*args, **kwargs)

        return wrapped

    return deco


@contextlib.contextmanager
def trace_context(log_dir):
    """Capture a host and device trace of the enclosed block into
    ``log_dir/trace_<ns>.json`` (CUDA activity when a card is present)."""
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    log_dir = Path(log_dir)
    log_dir.mkdir(parents=True, exist_ok=True)
    prof = torch.profiler.profile(activities=activities)
    prof.start()
    try:
        yield prof
    finally:
        prof.stop()
        prof.export_chrome_trace(str(log_dir / f"trace_{time.time_ns()}.json"))
