"""A new configuration, traffic mix, limits and metric are found by name in
a copy of the harness, with no file of it edited."""

import json
import time

import torch

from harness.cell import run_cell
from harness.spec import Cell


def test_new_cell_found_by_name(tiny_root, tmp_path):
    from tests.conftest import make_tiny_root

    root = make_tiny_root(tmp_path)
    bench = root / "benchmarks"
    spec = json.loads((root / "BENCHMARK.json").read_text())
    cfg = json.loads((bench / "configs" / "vgan_no_kl.d10240.json").read_text())
    cfg.update(name="vgan_no_kl.narrow", d=96)
    (bench / "configs" / "vgan_no_kl.narrow.json").write_text(json.dumps(cfg))
    mix = json.loads((bench / "traffic" / "fit.e100.json").read_text())
    mix["epochs_per_call"] = 3
    (bench / "traffic" / "fit.e3.json").write_text(json.dumps(mix))
    (bench / "limits" / "narrow.fit.json").write_text(
        (bench / "limits" / "no_kl.fit.json").read_text())
    (bench / "metrics" / "steps_per_call.py").write_text(
        "def read(r):\n    return r['steps'] / r['calls']\n")
    spec["configs"].append({"name": "vgan_no_kl.narrow", "source": "x",
                            "file": "benchmarks/configs/vgan_no_kl.narrow.json",
                            "reduced": [], "why": "x"})
    spec["workloads"].append({"name": "narrow.fit", "config": "vgan_no_kl.narrow",
                              "traffic": "fit.e3", "chips": 1, "why": "x"})
    spec["end_to_end"][0]["workloads"].append("narrow.fit")
    spec["per_layer"].append({"name": "steps_per_call", "unit": "steps", "better": "higher",
                              "source": "program_counter", "layer": "x",
                              "moves": "train_steps_per_s", "workloads": ["narrow.fit"]})
    (root / "BENCHMARK.json").write_text(json.dumps(spec))

    cell = Cell("narrow.fit", root)
    assert cell.config["d"] == 96 and cell.traffic["epochs_per_call"] == 3
    assert [m["name"] for m in cell.per_layer()] == ["steps_per_call"]
    assert cell.reader("steps_per_call")({"steps": 12, "calls": 3}) == 4
    result = run_cell(cell, 11, 0.2, False, torch.device("cpu"), time.time())
    assert result["correct"], result["checks"]
    assert set(result["metrics"]) == {"train_steps_per_s", "setup_s"}
