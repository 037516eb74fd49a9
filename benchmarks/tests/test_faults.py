"""Each fault a cell can have, planted under the harness, comes out as
``correct`` false; the sound program comes out true. The rest of a run is
driven on the CPU at a tiny size, without the look for a card."""

import json
import os
import socket
import subprocess
import sys
import time
from pathlib import Path

import pytest
import torch

from harness.cell import run_cell
from harness.spec import Cell
from tests import faults

CASES = [("no_kl.fit", f) for f in faults.FIT] + [("kl.fit", f) for f in faults.FIT] + \
    [("no_kl.score", f) for f in faults.SCORE]


def _run(tiny_root, workload, seed=2**31 + 7):
    return run_cell(Cell(workload, tiny_root), seed, 0.3, False, torch.device("cpu"), time.time())


@pytest.mark.parametrize("workload", ["no_kl.fit", "kl.fit", "no_kl.score"])
def test_sound_run_is_correct(tiny_root, workload):
    result = _run(tiny_root, workload)
    assert result["correct"], result["checks"]
    assert result["failed"] == 0 and result["attempted"] >= 1
    assert list(result)[-1] == "checks"


@pytest.mark.parametrize("workload, fault", CASES)
def test_fault_is_refused(tiny_root, workload, fault):
    table = faults.SCORE if workload.endswith("score") else faults.FIT
    with table[fault]():
        result = _run(tiny_root, workload)
    assert not result["correct"], result["checks"]


def _world(tiny_root, fault=None, world=4):
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    helper = Path(__file__).with_name("dp_world.py")
    args = [str(tiny_root), "no_kl.fit.dp4", str(2**31 + 7)] + ([fault] if fault else [])
    procs = [subprocess.Popen(
        [sys.executable, str(helper), *args], stdout=subprocess.PIPE, text=True,
        env=dict(os.environ, RANK=str(r), WORLD_SIZE=str(world), MASTER_ADDR="127.0.0.1",
                 MASTER_PORT=str(port), CUDA_VISIBLE_DEVICES=""))
        for r in range(world)]
    outs = [p.communicate(timeout=300)[0] for p in procs]
    assert all(p.returncode == 0 for p in procs)
    return json.loads(outs[0].strip().splitlines()[-1])


def test_dp_world_sound_and_faults(tiny_root):
    """The four-rank cell on gloo: sound, then each of its faults."""
    assert _run_ok(_world(tiny_root))
    for fault in faults.DP:
        assert not _world(tiny_root, fault)["correct"], fault


def _run_ok(result):
    assert result["correct"], result["checks"]
    return True
