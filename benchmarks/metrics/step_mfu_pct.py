"""step_mfu_pct: the model FLOPs of the traced window's training steps
(``harness/yardstick.py``: the generator's, for kl also the detector's,
linear layers forward and backward, and the MMD forward and backward, each
counted from shapes) over the window times the IEEE float32 peak of every
card of the cell, in percent."""

from harness.yardstick import PEAK_F32_FLOPS


def read(r):
    if not r.get("model_flops") or not r["window_s"]:
        return None
    return 100.0 * r["model_flops"] / (r["window_s"] * PEAK_F32_FLOPS * r["chips"])
