"""call_self_ms.fit: the device ms of the program's ``vgan::continue_fit``
spans less its ``vgan::epochs`` spans (the dataset placed on the card, the
history fetched, the state kept), over its count of ``vgan::continue_fit``
spans in the traced window."""

from harness import spans


def read(r):
    t = spans.table()
    return spans.per(t, ("vgan::continue_fit",), ("vgan::epochs",), "vgan::continue_fit")
