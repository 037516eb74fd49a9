"""The readers of the program's spans, on a synthetic span table and trace:
each metric's arithmetic, and None from a program that records no spans."""

import pytest

from harness import spans
from harness.spec import Cell
from harness.trace import Trace

TABLE = {
    "vgan::continue_fit": {"count": 2, "host_s": 9.0, "device_s": 9.030},
    "vgan::epochs": {"count": 2, "host_s": 8.9, "device_s": 9.000},
    "vgan::step": {"count": 800, "host_s": 8.8, "device_s": 8.950},
    "vgan::forward": {"count": 800, "host_s": 3.0, "device_s": 4.800},
    "vgan::backward": {"count": 800, "host_s": 2.0, "device_s": 1.600},
    "vgan::adadelta": {"count": 800, "host_s": 1.0, "device_s": 2.400},
    "vgan::mmd.forward": {"count": 800, "host_s": 0.5, "device_s": 0.320},
    "vgan::mmd.backward": {"count": 800, "host_s": 0.2, "device_s": 0.480},
    "vgan::decision_function": {"count": 4, "host_s": 0.6, "device_s": 0.608},
    "vgan::knn": {"count": 4, "host_s": 0.5, "device_s": 0.588},
}
WANT = {
    "model_ms_per_step": (4.8 + 1.6 - 0.32 - 0.48) / 800 * 1e3,
    "mmd_ms_per_step": (0.32 + 0.48) / 800 * 1e3,
    "adadelta_ms_per_step": 2.4 / 800 * 1e3,
    "call_self_ms.fit": (9.03 - 9.0) / 2 * 1e3,
    "call_self_ms.score": (0.608 - 0.588) / 4 * 1e3,
}


def _trace(host_ops, device_ops):
    tr = Trace(False)
    tr.host_ops, tr.device_ops = host_ops, device_ops
    return tr


def _readings(tr):
    return {"trace": tr, "window_s": 1.0, "steps": 4, "calls": 1}


@pytest.mark.parametrize("name", sorted(WANT))
def test_span_reader_arithmetic(name, monkeypatch):
    monkeypatch.setattr(spans, "table", lambda: TABLE)
    cell = Cell("no_kl.score" if name.endswith(".score") else "no_kl.fit")
    assert name in {m["name"] for m in cell.per_layer()}
    got = cell.reader(name)(_readings(_trace([], [])))
    assert got == pytest.approx(WANT[name], rel=1e-12)


def test_loop_idle_reads_the_gaps_inside_the_epochs():
    # µs: two epochs spans (name, start, end), two steps in the first and
    # one in the second (one more outside both); the device's operations
    # (name, start, duration) leave the card idle at 10-15, 40-42 and 90-110
    host = [("vgan::epochs", 0.0, 50.0), ("vgan::step", 1.0, 20.0), ("vgan::step", 20.0, 45.0),
            ("vgan::epochs", 100.0, 130.0), ("vgan::step", 101.0, 129.0),
            ("vgan::step", 200.0, 210.0), ("aten::mm", 2.0, 3.0)]
    device = [("k", 0.0, 10.0), ("k", 15.0, 25.0), ("k", 20.0, 20.0), ("k", 42.0, 48.0),
              ("k", 110.0, 30.0)]
    read = Cell("kl.fit").reader("loop_idle_ms_per_step")
    # idle inside [0, 50]: 10-15, 40-42 = 7 µs; inside [100, 130]: 100-110 = 10 µs
    assert read(_readings(_trace(host, device))) == pytest.approx(17.0 / 3 / 1e3)


@pytest.mark.parametrize("name", sorted(WANT) + ["loop_idle_ms_per_step"])
def test_span_readers_read_nothing_without_spans(name, monkeypatch):
    monkeypatch.setattr(spans, "table", lambda: {})
    cell = Cell("no_kl.score" if name.endswith(".score") else "no_kl.fit")
    tr = _trace([("bench::continue_fit", 0.0, 10.0)], [("k", 0.0, 5.0)])
    assert cell.reader(name)(_readings(tr)) is None


def test_span_readers_read_nothing_without_device_times(monkeypatch):
    monkeypatch.setattr(spans, "table", lambda: {
        k: dict(v, device_s=None) for k, v in TABLE.items()})
    assert Cell("no_kl.fit").reader("model_ms_per_step")(_readings(_trace([], []))) is None
