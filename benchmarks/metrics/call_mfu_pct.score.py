"""call_mfu_pct.score: the operations that every decision_function call of
the traced window needs (``harness/yardstick.py`` ``knn_ops`` over the
run's masks) over the window times the IEEE float32 peak, in percent. It
bounds a claim whatever kernel does the scoring."""

from harness.yardstick import PEAK_F32_FLOPS


def read(r):
    if not r.get("call_ops") or not r["calls"] or not r["window_s"]:
        return None
    return 100.0 * r["call_ops"] * r["calls"] / (r["window_s"] * PEAK_F32_FLOPS * r["chips"])
