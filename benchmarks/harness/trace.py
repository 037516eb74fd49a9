"""The traced window: ``torch.profiler`` over whole calls, reduced to the
device's operations (name, start, duration), their union (the busy time),
the longest idle gaps labelled by the host operation under way, and the
harness's own host spans around the calls into the program."""

from __future__ import annotations

import re
import time
from contextlib import contextmanager

import torch

SPAN_PREFIX = "bench::"


def short_name(name: str) -> str:
    """A kernel's name without its return type, arguments and template."""
    name = re.sub(r"^void\s+", "", name.replace("(anonymous namespace)::", ""))
    name = re.sub(r"<.*", "", name.split("(")[0])
    return name.split("::")[-1] or name


@contextmanager
def span(name: str):
    """A host span of the harness's own, around one call into a layer."""
    with torch.profiler.record_function(SPAN_PREFIX + name):
        yield


class Trace:
    """Profiles from :meth:`start` to :meth:`stop` when ``enabled``;
    afterwards ``device_ops`` holds ``(name, start_us, dur_us)`` of every
    operation that ran on the card (kernels, copies, fills; not the
    annotations of host spans) and ``host_ops`` ``(name, start_us, end_us)``
    of the host's operations and spans, on one clock; ``window_s`` is the
    traced window's length on the host clock."""

    def __init__(self, enabled: bool):
        self.enabled = enabled
        self.device_ops, self.host_ops = [], []
        self.window_s = None
        self._prof = None
        self._t0 = None

    @property
    def active(self) -> bool:
        return self._prof is not None

    def start(self):
        if self.enabled:
            from torch.profiler import ProfilerActivity, profile

            torch.cuda.synchronize()
            self._prof = profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])
            self._prof.__enter__()
            self._t0 = time.perf_counter()
        return self

    def elapsed(self) -> float:
        """Seconds since the profiler started."""
        return time.perf_counter() - self._t0

    def stop(self):
        if self._prof is None:
            return
        torch.cuda.synchronize()
        self.window_s = time.perf_counter() - self._t0
        prof, self._prof = self._prof, None
        prof.__exit__(None, None, None)
        self._collect(prof)

    def _collect(self, prof):
        from torch.autograd import DeviceType

        for e in prof.profiler.kineto_results.events():
            name = e.name()
            start, dur = e.start_ns() * 1e-3, e.duration_ns() * 1e-3
            annotation = e.is_user_annotation() or name.startswith(SPAN_PREFIX)
            if e.device_type() == DeviceType.CUDA:
                if not annotation:
                    self.device_ops.append((name, start, dur))
            else:
                self.host_ops.append((name, start, start + dur))
        self.device_ops.sort(key=lambda t: t[1])
        self.host_ops.sort(key=lambda t: t[1])

    # -- reductions ---------------------------------------------------------

    def busy_intervals(self):
        """The union of the device operations' intervals, in µs."""
        out = []
        for _, s, dur in self.device_ops:
            e = s + dur
            if out and s <= out[-1][1]:
                out[-1][1] = max(out[-1][1], e)
            else:
                out.append([s, e])
        return out

    def busy_s(self) -> float:
        return sum(e - s for s, e in self.busy_intervals()) * 1e-6

    def device_time_us(self, names) -> float:
        """Device µs of the operations whose short name is in ``names``."""
        names = set(names)
        return sum(dur for n, _, dur in self.device_ops if short_name(n) in names)

    def device_time_matching_us(self, needle: str) -> float:
        return sum(dur for n, _, dur in self.device_ops if needle in n.lower())

    def top_device_ops(self, count: int = 10):
        by = {}
        for n, _, dur in self.device_ops:
            key = short_name(n)
            by[key] = by.get(key, 0.0) + dur
        top = sorted(by.items(), key=lambda kv: -kv[1])[:count]
        return [[k, v * 1e-6] for k, v in top]

    def idle_gaps(self, count: int = 10):
        """The longest gaps between device operations inside the window,
        each named by the innermost host operation under way at its middle
        (the harness's spans, the program's aten operations, CUDA runtime
        calls)."""
        busy = self.busy_intervals()
        gaps = [(b[0] - a[1], a[1], b[0]) for a, b in zip(busy, busy[1:]) if b[0] > a[1]]
        gaps.sort(key=lambda g: -g[0])
        out = []
        for length, s, e in gaps[:count]:
            mid = 0.5 * (s + e)
            label, start = "host", None
            for name, hs, he in self.host_ops:
                if hs > mid:
                    break
                if he >= mid and (start is None or hs >= start):
                    label, start = name, hs
            out.append([label, length * 1e-6])
        return out
