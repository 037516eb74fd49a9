"""Structured JSONL metrics alongside the reference's CSV artifacts.

The reference logs via print + a train-history defaultdict exported to CSV
(vgan.py:334-337, 128-129). The estimators keep those artifacts for
workflow parity; this logger adds machine-readable JSONL (one event per
line) for observability pipelines.
"""

from __future__ import annotations

import json
import time
from pathlib import Path
from typing import Optional


class MetricsLogger:
    def __init__(self, path: Optional[str] = None):
        self.path = Path(path) if path else None
        if self.path:
            self.path.parent.mkdir(parents=True, exist_ok=True)
            self._fh = open(self.path, "a")
        else:
            self._fh = None

    def log(self, event: str, **fields) -> None:
        if self._fh is None:
            return
        rec = {"ts": time.time(), "event": event, **fields}
        self._fh.write(json.dumps(rec) + "\n")
        self._fh.flush()

    def close(self) -> None:
        if self._fh:
            self._fh.close()
            self._fh = None

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
