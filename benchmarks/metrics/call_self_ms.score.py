"""call_self_ms.score: the device ms of the program's
``vgan::decision_function`` spans less its ``vgan::knn`` spans (the test
batch placed on the card, the z-score, the aggregation and the scores'
fetch), over its count of ``vgan::decision_function`` spans in the traced
window."""

from harness import spans


def read(r):
    t = spans.table()
    return spans.per(t, ("vgan::decision_function",), ("vgan::knn",),
                     "vgan::decision_function")
