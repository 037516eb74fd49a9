"""One rank of a data-parallel cell on the CPU (gloo), for the tests:

    RANK=r WORLD_SIZE=n MASTER_ADDR=127.0.0.1 MASTER_PORT=p \\
        python3 dp_world.py ROOT WORKLOAD SEED [FAULT]

runs the rest of a run (``harness.cell.run_cell``) without the look for a
card, under the named fault of ``tests/faults.py``; rank 0 prints the
result line."""

from __future__ import annotations

import contextlib
import json
import os
import sys
import time
from pathlib import Path

BENCH_DIR = Path(__file__).resolve().parents[1]
for _p in (str(BENCH_DIR.parent), str(BENCH_DIR)):
    if _p not in sys.path:
        sys.path.insert(0, _p)


def main() -> int:
    import torch

    from harness.cell import run_cell
    from harness.spec import Cell
    from tests import faults

    root, workload, seed = Path(sys.argv[1]), sys.argv[2], int(sys.argv[3])
    fault = faults.DP[sys.argv[4]]() if len(sys.argv) > 4 else contextlib.nullcontext()
    torch.set_num_threads(1)
    rank, world = int(os.environ["RANK"]), int(os.environ["WORLD_SIZE"])
    cell = Cell(workload, root)
    with fault:
        result = run_cell(cell, seed, 0.5, False, torch.device("cpu"), time.time(), rank, world)
    if rank == 0:
        print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
