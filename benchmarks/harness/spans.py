"""The program's own spans (``vgan_tpu_torch.utils.profiling``), as the
per-layer readers read them: counts and device seconds by name, over the
spans recorded while the traced window's profiler ran. A program without
the spans gives nothing to read, and the readers then return None."""

from __future__ import annotations


def table() -> dict:
    """``{name: {"count", "host_s", "device_s"}}``, or ``{}`` where the
    program records no spans."""
    try:
        from vgan_tpu_torch.utils.profiling import span_table
    except ImportError:
        return {}
    return span_table()


def count(spans: dict, name: str) -> int:
    return spans.get(name, {}).get("count", 0)


def device_ms(spans: dict, name: str):
    """The device milliseconds of every ``name`` span: 0.0 where none ran,
    None where they ran with no device time recorded."""
    if name not in spans:
        return 0.0
    s = spans[name]["device_s"]
    return None if s is None else 1e3 * s


def per(spans: dict, plus, minus, over: str):
    """The device ms of the spans ``plus`` less those of ``minus``, over the
    count of ``over``; None unless the first of ``plus`` and ``over`` ran
    with device times."""
    n = count(spans, over)
    if not n or plus[0] not in spans:
        return None
    parts = [device_ms(spans, name) for name in (*plus, *minus)]
    if any(p is None for p in parts):
        return None
    return (sum(parts[:len(plus)]) - sum(parts[len(plus):])) / n
