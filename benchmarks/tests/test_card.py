"""On a CUDA card: one short run of each one-card cell prints a correct
result line whose metrics are the cell's."""

import json
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]


@pytest.mark.card
@pytest.mark.parametrize("workload", ["no_kl.fit", "kl.fit", "no_kl.score"])
def test_cell_runs_on_the_card(card, workload):
    out = subprocess.run(
        [sys.executable, "benchmarks/run.py", "--workload", workload, "--seed", "2147483659",
         "--seconds", "3", "--trace", "0"],
        capture_output=True, text=True, cwd=ROOT, timeout=600)
    assert out.returncode == 0, out.stderr[-4000:]
    result = json.loads(out.stdout.strip().splitlines()[-1])
    assert result["correct"], result["checks"]
    assert result["device"]["platform"] == "gpu" and result["device"]["count"] == 1
