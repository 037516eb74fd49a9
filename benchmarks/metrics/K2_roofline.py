"""K2_roofline: K2's (``gram_quadrant_sums_stash``) least time at the
cell's MMD shape (m = 2 batch rows of width d; ``harness/yardstick.py``),
times its launches in the traced window, over the device time of the
``csrc/mmd_gram.cu`` kernels there (on rank 0), in percent."""

from harness.kernels import MMD_GRAM
from harness.yardstick import gram_bound_ms


def read(r):
    launches = r["launches"].get("gram_quadrant_sums_stash", 0)
    device_us = r["trace"].device_time_us(MMD_GRAM)
    if not launches or not device_us:
        return None
    m, d = 2 * r["config"]["params"]["batch_size"], r["config"]["d"]
    return 100.0 * launches * gram_bound_ms(m, d, stash=True) * 1e3 / device_us
