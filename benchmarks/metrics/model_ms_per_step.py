"""model_ms_per_step: the device ms of the program's ``vgan::forward`` and
``vgan::backward`` spans less its ``vgan::mmd.forward`` and
``vgan::mmd.backward`` spans (the generator, the detector, the coverage
and the batch, without the MMD), over its count of ``vgan::step`` spans in
the traced window."""

from harness import spans


def read(r):
    t = spans.table()
    return spans.per(t, ("vgan::forward", "vgan::backward"),
                     ("vgan::mmd.forward", "vgan::mmd.backward"), "vgan::step")
