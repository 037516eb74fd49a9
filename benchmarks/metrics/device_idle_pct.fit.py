"""device_idle_pct.fit: the share of the traced window (whole continue_fit
calls) in which no operation ran on the card (rank 0's under a mesh), in
percent: 100 (1 - busy / window)."""


def read(r):
    if not r["window_s"] or not r["trace"].device_ops:
        return None
    return 100.0 * (1.0 - r["trace"].busy_s() / r["window_s"])
