"""K7_roofline: K7's (``knn_scores_stream``) least time for one call over
the run's masks (``harness/yardstick.py`` ``knn_bound_ms``), times its
launches in the traced window, over the device time of ``knn_prep_kernel``
and ``knn_kernel`` there, in percent."""

from harness.kernels import KNN_STREAM


def read(r):
    launches = r["launches"].get("knn_scores_stream", 0)
    device_us = r["trace"].device_time_us(KNN_STREAM)
    if not launches or not device_us or not r.get("call_bound_ms"):
        return None
    return 100.0 * launches * r["call_bound_ms"] * 1e3 / device_us
