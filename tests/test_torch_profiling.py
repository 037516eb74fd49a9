"""The port's spans (``vgan_tpu_torch.utils.profiling``): nothing recorded
without a profiler, each layer's span once a step or a call under one, the
MMD's backward span from autograd's engine thread, and the trace file's
names. Tests marked ``card`` check the device times on a CUDA card and skip
without one; on the card:

    python -m pytest --noconftest -o addopts="" -m card tests/test_torch_profiling.py -q
"""

from __future__ import annotations

import json
import os
import sys
import threading

import numpy as np
import pytest
import torch

from vgan_tpu_torch import VGAN, VGAN_no_kl, SubspaceEnsemble
from vgan_tpu_torch.utils import profiling
from vgan_tpu_torch.utils.profiling import reset_spans, span, span_table

N, D, BATCH = 40, 12, 10
NB = N // BATCH
STEP_SPANS = ("vgan::step", "vgan::forward", "vgan::backward", "vgan::adadelta")


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


@pytest.fixture(autouse=True)
def empty_table():
    reset_spans()
    yield
    reset_spans()


def _rows(n=N, d=D, seed=0):
    return np.random.default_rng(seed).normal(size=(n, d)).astype(np.float32)


def _counts():
    return {name: row["count"] for name, row in span_table().items()}


def _estimator(kind: str, device="cpu", **kw):
    cls = VGAN_no_kl if kind == "no_kl" else VGAN
    return cls(epochs=0, batch_size=BATCH, device=device, verbose=False, **kw)


def _trained(kind: str, **kw):
    """An estimator whose epochs all step: kl's generator epochs undetached."""
    if kind == "kl":
        kw.setdefault("replicate_generator_detach", False)
    return _estimator(kind, **kw)


def test_spans_record_nothing_without_a_profiler():
    x = _rows()
    est = _trained("no_kl").fit(x)
    est.continue_fit(x, 2)
    ens = SubspaceEnsemble(np.ones((2, D), bool), np.ones(2) / 2, base="knn", k=3,
                           device="cpu").fit(x)
    ens.decision_function(x[:5])
    assert span_table() == {}
    assert span("a") is span("b")


@pytest.mark.parametrize("kind", ["no_kl", "kl"])
def test_continue_fit_spans_once_a_step(kind):
    x = _rows()
    est = _trained(kind).fit(x)
    with torch.profiler.profile():
        est.continue_fit(x, 2)
    counts = _counts()
    for name in STEP_SPANS + ("vgan::mmd.forward",):
        assert counts[name] == 2 * NB, (name, counts)
    assert counts["vgan::epochs"] == 1 and counts["vgan::continue_fit"] == 1
    assert "vgan::fit" not in counts


@pytest.mark.parametrize("kind", ["no_kl", "kl"])
def test_fit_spans_once_a_step(kind):
    x = _rows()
    est = _trained(kind)
    est.epochs = 2
    with torch.profiler.profile():
        est.fit(x)
    counts = _counts()
    for name in STEP_SPANS:
        assert counts[name] == 2 * NB, (name, counts)
    assert counts["vgan::epochs"] == 1 and counts["vgan::fit"] == 1
    assert "vgan::continue_fit" not in counts


def test_detached_generator_epoch_takes_no_adadelta():
    x = _rows()
    est = _estimator("kl")
    est.epochs = 1  # the schedule's detector epoch; the next is a generator epoch
    est.fit(x)
    with torch.profiler.profile():
        est.continue_fit(x, 1)
    counts = _counts()
    assert counts["vgan::step"] == NB and counts["vgan::forward"] == NB
    assert "vgan::adadelta" not in counts and "vgan::backward" not in counts


@pytest.mark.parametrize("impl, backward", [("cuda", NB), ("torch", 0), ("chunked", 0)])
def test_mmd_backward_span_on_the_kernel_route_only(impl, backward):
    x = _rows()
    est = _estimator("no_kl", mmd_impl=impl).fit(x)
    with torch.profiler.profile():
        est.continue_fit(x, 1)
    counts = _counts()
    assert counts["vgan::mmd.forward"] == NB
    assert counts.get("vgan::mmd.backward", 0) == backward


def test_knn_call_spans_once_a_call():
    x = _rows()
    masks = np.random.default_rng(1).random((5, D)) < 0.5
    ens = SubspaceEnsemble(masks, np.ones(5) / 5, base="knn", k=3, device="cpu").fit(x)
    with torch.profiler.profile():
        ens.decision_function(x[:7])
        ens.decision_function(x[7:12])
    counts = _counts()
    assert counts["vgan::decision_function"] == 2 and counts["vgan::knn"] == 2


def test_trace_context_file_holds_the_spans(tmp_path):
    x = _rows()
    est = _trained("no_kl").fit(x)
    with profiling.trace_context(tmp_path / "trace"):
        est.continue_fit(x, 1)
    (path,) = (tmp_path / "trace").glob("*.json")
    names = {e.get("name") for e in json.loads(path.read_text())["traceEvents"]}
    assert {"vgan::continue_fit", "vgan::epochs", "vgan::mmd.forward", *STEP_SPANS} <= names


def test_exit_records_exactly_when_entry_did():
    off = span("vgan::probe")
    off.__enter__()
    with torch.profiler.profile():
        off.__exit__(None, None, None)
        on = span("vgan::probe")
        on.__enter__()
    on.__exit__(None, None, None)
    table = span_table()
    assert table["vgan::probe"]["count"] == 1
    assert table["vgan::probe"]["host_s"] >= 0.0


def test_span_table_is_safe_across_threads():
    def work():
        for _ in range(200):
            with span("vgan::probe"):
                pass

    n = 2 * (os.cpu_count() or 2)
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        with torch.profiler.profile():
            threads = [threading.Thread(target=work) for _ in range(n)]
            for t in threads:
                t.start()
            for t in threads:
                t.join(timeout=60)
    finally:
        sys.setswitchinterval(interval)
    assert not any(t.is_alive() for t in threads)
    assert span_table()["vgan::probe"]["count"] == 200 * n


def test_no_span_inside_an_export_trace():
    class Twice(torch.nn.Module):
        def forward(self, a):
            with span("vgan::probe"):
                return a * 2

    with torch.profiler.profile():
        program = torch.export.export(Twice(), (torch.ones(3),), strict=False)
    assert "profiler" not in program.graph_module.code
    assert span_table() == {}


@pytest.mark.card
def test_device_times_nest(card, monkeypatch):
    """On the card: device times are recorded, none negative, each child
    within its parent, and the MMD's backward span comes from autograd's
    engine thread."""
    threads = {}
    add = profiling._TABLE.add

    def add_noting_thread(name, *args):
        threads.setdefault(name, set()).add(threading.get_ident())
        add(name, *args)

    monkeypatch.setattr(profiling._TABLE, "add", add_noting_thread)
    x = _rows(n=200, d=600)
    est = VGAN_no_kl(epochs=0, batch_size=50, device=card, verbose=False,
                     mmd_impl="cuda").fit(x)
    ens = SubspaceEnsemble(np.random.default_rng(1).random((8, 600)) < 0.5, np.ones(8) / 8,
                           base="knn", k=5, device=card).fit(x)
    est.continue_fit(x, 1)
    ens.decision_function(x[:64])
    torch.cuda.synchronize()
    with torch.profiler.profile():
        est.continue_fit(x, 2)
        ens.decision_function(x[:64])
    t = span_table()
    s = {name: row["device_s"] for name, row in t.items()}
    assert all(v is not None and v >= 0.0 for v in s.values()), s
    ms = {name: v + 1e-5 for name, v in s.items()}  # room for the events' rounding
    assert t["vgan::step"]["count"] == 8 and t["vgan::mmd.backward"]["count"] == 8
    assert s["vgan::mmd.forward"] <= ms["vgan::forward"]
    assert s["vgan::mmd.backward"] <= ms["vgan::backward"]
    assert s["vgan::forward"] + s["vgan::backward"] + s["vgan::adadelta"] <= ms["vgan::step"]
    assert s["vgan::step"] <= ms["vgan::epochs"] and s["vgan::epochs"] <= ms["vgan::continue_fit"]
    assert s["vgan::knn"] <= ms["vgan::decision_function"]
    main = threading.get_ident()
    assert threads["vgan::step"] == {main}
    assert main not in threads["vgan::mmd.backward"]
