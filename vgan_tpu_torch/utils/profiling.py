"""Profiling hooks: named trace ranges and trace capture (counterpart of
``vgan_tpu.utils.profiling``).

Hot regions can be wrapped in :func:`annotate`, a named
``torch.profiler.record_function`` range (and an NVTX range when a card is
present, for Nsight), and a whole run captured by :func:`trace_context` into
a Chrome / Perfetto trace file (open it at ui.perfetto.dev or
chrome://tracing).
"""

from __future__ import annotations

import contextlib
import functools
import time
from pathlib import Path

import torch


def annotate(name: str):
    """Decorator: run the function inside a named trace range."""

    def deco(fn):
        @functools.wraps(fn)
        def wrapped(*args, **kwargs):
            with contextlib.ExitStack() as stack:
                stack.enter_context(torch.profiler.record_function(name))
                if torch.cuda.is_available():
                    stack.enter_context(torch.cuda.nvtx.range(name))
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
