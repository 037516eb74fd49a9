"""Utilities: checkpoint / resume, structured metrics, profiling hooks, and
the reader of ``vgan_tpu``'s Flax msgpack files."""

from vgan_tpu_torch.utils.checkpoint import restore_train_state, save_train_state
from vgan_tpu_torch.utils.metrics import MetricsLogger
from vgan_tpu_torch.utils.profiling import annotate, trace_context

__all__ = [
    "save_train_state",
    "restore_train_state",
    "MetricsLogger",
    "annotate",
    "trace_context",
]
