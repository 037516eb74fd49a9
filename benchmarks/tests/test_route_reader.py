"""The KNN route's share (``metrics/knn_kernel_route_pct.score.py``) on
synthetic launch counts, and the RNA-Seq cell found by name."""

import pytest

from harness.spec import Cell

ROUTE = "knn_kernel_route_pct.score"


@pytest.mark.parametrize("launches, want", [
    ({"knn_scores_resident": 0, "knn_scores_stream": 24, "knn_generic": 0}, 100.0),
    ({"knn_scores_resident": 24, "knn_scores_stream": 0, "knn_generic": 0}, 100.0),
    ({"knn_scores_resident": 0, "knn_scores_stream": 0, "knn_generic": 24}, 0.0),
    ({"knn_scores_resident": 0, "knn_scores_stream": 3, "knn_generic": 1}, 75.0),
    ({"knn_scores_resident": 0, "knn_scores_stream": 0, "knn_generic": 0}, None),
    ({"knn_scores_resident": 0, "knn_scores_stream": 0}, None),  # a program without the count
    ({"knn_scores_resident": 0, "knn_scores_stream": 5}, 100.0),
])
def test_route_share(launches, want):
    cell = Cell("rnaseq.score")
    assert ROUTE in {m["name"] for m in cell.per_layer()}
    got = cell.reader(ROUTE)({"launches": launches})
    assert got == want


def test_rnaseq_cell_resolves_its_files():
    cell = Cell("rnaseq.score")
    assert cell.chips == 1 and cell.workload["traffic"] == "score.b500"
    assert (cell.config["n"], cell.config["d"]) == (801, 20531)
    assert cell.config["latent_size"] == cell.config["d"] // 16
    widths = cell.config["generator_widths"]
    assert widths == [1283, 2566, 5132, 10264, 20531]
    assert cell.config["generator_parameters"] == sum(
        i * o + o for i, o in zip(widths[:-1], widths[1:]))
    assert cell.traffic["kind"] == "score" and cell.traffic["base"] == "knn"
    assert set(cell.limits["limits"]) == {"score", "kth"}
    assert {m["name"] for m in cell.end_to_end()} == {"score_rows_per_s", "score_p95_ms",
                                                      "setup_s"}
    assert {m["name"] for m in cell.per_layer()} == {
        "K7_roofline", "call_mfu_pct.score", "device_idle_pct.score", "call_self_ms.score",
        ROUTE}
