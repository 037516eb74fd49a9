"""loop_idle_ms_per_step: the time in which no operation ran on the card
(the complement of the trace's busy intervals) inside the host intervals of
the program's ``vgan::epochs`` spans, over the ``vgan::step`` spans that
start inside them, in ms."""


def read(r):
    tr = r["trace"]
    epochs = [(s, e) for name, s, e in tr.host_ops if name == "vgan::epochs"]
    steps = [s for name, s, _ in tr.host_ops if name == "vgan::step"]
    n = sum(any(a <= s <= b for a, b in epochs) for s in steps)
    if not n:
        return None
    busy = tr.busy_intervals()
    idle_us = 0.0
    for a, b in epochs:
        covered = sum(max(0.0, min(e, b) - max(s, a)) for s, e in busy)
        idle_us += (b - a) - covered
    return idle_us / 1e3 / n
