"""mmd_ms_per_step: the device ms of the program's ``vgan::mmd.forward``
and ``vgan::mmd.backward`` spans (the MMD kernels forward and backward),
over its count of ``vgan::step`` spans in the traced window."""

from harness import spans


def read(r):
    t = spans.table()
    return spans.per(t, ("vgan::mmd.forward", "vgan::mmd.backward"), (), "vgan::step")
