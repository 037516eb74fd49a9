"""The knn ensemble at the RNA-Seq deployment's shape (fewer train rows than
two test batches, a width past the JAX package's gate): on the CPU a tiny
copy against the benchmark's plain reference
(``benchmarks/reference/knn_ensemble.py``) on both routes, the generic one
counted and spanned; on a CUDA card K7 at 801 x 20,531 held to that
reference in float64 under the ``rnaseq.score`` cell's limits. Tests marked
``card`` skip without a card; on the card:

    python -m pytest --noconftest -o addopts="" -m card tests/test_torch_knn_rnaseq.py -q
"""

from __future__ import annotations

import importlib
import json
from pathlib import Path

import numpy as np
import pytest
import torch

from vgan_tpu_torch import SubspaceEnsemble
from vgan_tpu_torch.ensemble import od
from vgan_tpu_torch.ops.cuda import knn_score as KS
from vgan_tpu_torch.utils.profiling import reset_spans, span_table

BENCH = Path(__file__).resolve().parents[1] / "benchmarks"
K, KEEP, SEED = 10, 0.477, 2**31 + 11


@pytest.fixture
def reference(monkeypatch):
    monkeypatch.syspath_prepend(str(BENCH))
    return importlib.import_module("reference.knn_ensemble")


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


def _inputs(n_train, n_test, d, n_masks, device="cpu"):
    """Standard normal rows, the first 5% of the test rows scaled by 3, and
    masks keeping each column with probability 0.477 (the cell's mix)."""
    g = torch.Generator(device=device).manual_seed(SEED)
    x_train = torch.randn((n_train, d), generator=g, device=device)
    x_test = torch.randn((n_test, d), generator=g, device=device)
    x_test[: n_test // 20] *= 3.0
    masks = torch.rand((n_masks, d), generator=g, device=device) < KEEP
    masks[~masks.any(dim=1), 0] = True
    return x_train, x_test, masks


def _counts(resident=0, stream=0, generic=0):
    return {"knn_scores_resident": resident, "knn_scores_stream": stream, "knn_generic": generic}


@pytest.mark.parametrize("route", ["kernel", "generic"])
def test_tiny_rnaseq_ensemble_equals_the_reference(reference, monkeypatch, route):
    """30 train rows against 20-row test batches, 12 masks of about 30 of 64
    columns: the scores within 1e-5 of the largest reference score (the
    z-scored f32 distances against float64), the generic route's shard
    counted once and spanned, the kernel route's spanned as ``vgan::knn``."""
    x_train, x_test, masks = _inputs(30, 20, 64, 12)
    weights = np.full(len(masks), 1.0 / len(masks))
    ens = SubspaceEnsemble(masks.numpy(), weights, base="knn", k=K, device="cpu").fit(
        x_train.numpy())
    if route == "generic":
        monkeypatch.setattr(od, "knn_kernel_supported", lambda *args: False)
    KS.reset_launch_counts()
    reset_spans()
    try:
        with torch.profiler.profile():
            got = ens.decision_function(x_test.numpy())
        spans = {name: row["count"] for name, row in span_table().items()}
    finally:
        reset_spans()
    want, _ = reference.decision_function(x_test[None], x_train, masks,
                                          torch.as_tensor(weights), K, "float64")
    want = want[0].numpy()
    assert np.max(np.abs(got - want)) <= 1e-5 * np.max(np.abs(want))
    generic = route == "generic"
    assert KS.launch_counts() == _counts(generic=int(generic))
    assert spans["vgan::decision_function"] == 1
    assert spans.get("vgan::knn.generic", 0) == int(generic)
    assert spans.get("vgan::knn", 0) == int(not generic)


def test_generic_route_counts_each_shard_of_knn_bases_only(monkeypatch):
    """``knn_generic`` counts a knn / knn_mean call's shard off the kernel
    route (``per_subspace_scores`` too), no other base's, and
    ``reset_launch_counts`` clears it."""
    x_train, x_test, masks = _inputs(30, 20, 64, 6)
    monkeypatch.setattr(od, "knn_kernel_supported", lambda *args: False)
    KS.reset_launch_counts()
    for base in ("knn", "knn_mean", "lof"):
        ens = SubspaceEnsemble(masks.numpy(), np.full(6, 1 / 6), base=base, k=3,
                               device="cpu").fit(x_train.numpy())
        ens.decision_function(x_test.numpy())
        ens.per_subspace_scores(x_test.numpy())
    assert KS.launch_counts() == _counts(generic=4)
    KS.reset_launch_counts()
    assert KS.launch_counts() == _counts()


@pytest.mark.card
def test_k7_at_the_rnaseq_shape(card, reference):
    """K7 at 801 x 20,531 train rows, 500 test rows and 16 masks: one
    launch and no generic shard a call, the per-subspace k-th distances and
    the scores within the ``rnaseq.score`` cell's ``kth`` and ``score``
    limits of the float64 reference."""
    limits = json.loads((BENCH / "limits" / "rnaseq.score.json").read_text())["limits"]
    x_train, x_test, masks = _inputs(801, 500, 20531, 16, card)
    weights = np.full(len(masks), 1.0 / len(masks))
    ens = SubspaceEnsemble(masks.cpu().numpy(), weights, base="knn", k=K, device=card).fit(
        x_train.cpu().numpy())
    raw = []
    scores = od.knn_scores_all_masks

    def kept(*args, **kwargs):
        out = scores(*args, **kwargs)
        raw.append(out.double().cpu())
        return out

    KS.reset_launch_counts()
    od.knn_scores_all_masks = kept
    try:
        got = ens.decision_function(x_test.cpu().numpy())
    finally:
        od.knn_scores_all_masks = scores
    torch.cuda.synchronize()
    assert KS.launch_counts() == _counts(stream=1)
    want, kth = reference.decision_function(x_test[None], x_train, masks,
                                            torch.as_tensor(weights, device=card), K, "float64")
    want, kth = want[0].cpu().numpy(), kth[0].cpu()
    assert len(raw) == 1 and raw[0].shape == kth.shape
    kth_gap = float(torch.max(torch.abs(raw[0] - kth) / kth))
    assert kth_gap <= limits["kth"], kth_gap
    score_gap = float(np.max(np.abs(got - want)) / np.max(np.abs(want)))
    assert score_gap <= limits["score"], score_gap
