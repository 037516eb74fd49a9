"""K1K3_roofline: the least times of K1 (``gram_quadrant_sums``) and K3
(``gram_backward_flash``) at the cell's MMD shape (m = 2 batch encodings of
width L = d // 16; ``harness/yardstick.py``), times their launches in the
traced window, over the device time of the ``csrc/mmd_gram.cu`` kernels
there, in percent. Both run ``dot_slices_kernel``, so the names cannot
split them."""

from harness.kernels import MMD_GRAM
from harness.yardstick import gram_bound_ms, latent_size


def read(r):
    k1 = r["launches"].get("gram_quadrant_sums", 0)
    k3 = r["launches"].get("gram_backward_flash", 0)
    device_us = r["trace"].device_time_us(MMD_GRAM)
    if not (k1 or k3) or not device_us:
        return None
    m, L = 2 * r["config"]["params"]["batch_size"], latent_size(r["config"]["d"])
    bound_us = 1e3 * (k1 * gram_bound_ms(m, L) + k3 * gram_bound_ms(m, L, backward=True))
    return 100.0 * bound_us / device_us
