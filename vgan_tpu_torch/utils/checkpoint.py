"""Full-train-state checkpoints for mid-training resume (counterpart of
``vgan_tpu.utils.checkpoint``), written with ``torch.save``.

The state is a payload of plain tensors and dicts (see
``vgan_tpu_torch.train.steps.train_state_to_payload``): parameters, Adadelta
averages, the frozen bandwidth and its flag, the encoder flag and the
training generator's RNG state, so a resumed fit continues bit for bit on
the same device.

Crash-safe layout, as in the JAX package: each save goes to a fresh
``ckpt_<n>/`` (``state.pt`` and ``meta.json`` written together); only then
is the ``LATEST`` pointer replaced atomically (``os.replace`` of a temp
file), and older ``ckpt_*`` directories are pruned after the flip. A crash at
any point leaves ``LATEST`` naming a complete (state, meta) pair. Without
``LATEST`` the legacy in-place layout (``state.pt`` and ``meta.json``
directly under the path) is read. Orbax directories written by the JAX
package are not read. Under a mesh only rank 0 writes.
"""

from __future__ import annotations

import json
import os
import re
import shutil
import tempfile
from pathlib import Path
from typing import Any, Optional

import torch

_LATEST = "LATEST"
_STATE = "state.pt"


def _latest_dir(path: Path) -> Optional[Path]:
    """The current checkpoint directory: the ``LATEST`` pointer's, or the
    legacy in-place layout."""
    pointer = path / _LATEST
    if pointer.is_file():
        cand = path / pointer.read_text().strip()
        if (cand / _STATE).is_file():
            return cand
    if (path / _STATE).is_file():
        return path
    return None


def save_train_state(path, payload: Any, meta: Optional[dict] = None, mesh=None) -> None:
    """Save ``payload`` (tensors, dicts, lists) and JSON ``meta`` atomically.
    Under a ``mesh`` (the state replicated on every rank) only global rank 0
    writes, and every rank then meets at a barrier."""
    if mesh is not None:
        from vgan_tpu_torch.parallel.mesh import write_on_rank0

        write_on_rank0(mesh, save_train_state, path, payload, meta)
        return
    path = Path(path).absolute()
    path.mkdir(parents=True, exist_ok=True)
    existing = [
        int(m.group(1))
        for m in (re.match(r"ckpt_(\d+)$", p.name) for p in path.iterdir())
        if m
    ]
    new_dir = path / f"ckpt_{max(existing, default=-1) + 1}"
    new_dir.mkdir()
    torch.save(payload, new_dir / _STATE)
    if meta is not None:
        (new_dir / "meta.json").write_text(json.dumps(meta))
    # atomic pointer flip: the checkpoint becomes visible only when complete
    fd, tmp = tempfile.mkstemp(dir=path, prefix=".latest-")
    with os.fdopen(fd, "w") as fh:
        fh.write(new_dir.name)
    os.replace(tmp, path / _LATEST)
    for idx in existing:
        shutil.rmtree(path / f"ckpt_{idx}", ignore_errors=True)


def restore_train_state(path) -> Any:
    """The payload of the current checkpoint under ``path`` (on the CPU)."""
    path = Path(path).absolute()
    d = _latest_dir(path)
    if d is None:
        raise FileNotFoundError(f"no checkpoint under {path}")
    return torch.load(d / _STATE, map_location="cpu", weights_only=True)


def load_meta(path) -> Optional[dict]:
    d = _latest_dir(Path(path).absolute())
    if d is not None and (d / "meta.json").is_file():
        return json.loads((d / "meta.json").read_text())
    return None
