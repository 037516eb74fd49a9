"""adadelta_ms_per_step: the device ms of the program's ``vgan::adadelta``
spans (the optimizer's update with its weight decay), over its count of
``vgan::step`` spans in the traced window (a kl cycle's detached generator
steps take no update and count as steps)."""

from harness import spans


def read(r):
    t = spans.table()
    return spans.per(t, ("vgan::adadelta",), (), "vgan::step")
