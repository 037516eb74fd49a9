#!/usr/bin/env python3
"""The knn ensemble's ``decision_function`` and ``per_subspace_scores`` on
the kernel route (K6) against the same calls of another tree, on one NVIDIA
GPU, in turns.

    python3 examples/torch_knn_route_probe.py --other DIR [--pairs 5]

``DIR`` holds another commit's ``vgan_tpu_torch/`` (e.g. ``git archive
<commit> vgan_tpu_torch | tar -x -C DIR``). Each side runs in its own
process, the two alternating which goes first; a process builds a
bench-shaped knn ensemble (1024 masks of about 30% of the columns, uniform
weights, 1000 x 100 train rows, 500 test rows, k=10) and times each call,
median of 20 calls after a warm-up, host clock (each call ends in the host
fetch of its scores), and prints the sum of its scores, which must be equal
on both sides. Prints the card's name and power limit first; exits non-zero
without a CUDA device.
"""

from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

REPO = Path(__file__).resolve().parent.parent
CALLS = ("decision_function", "per_subspace_scores")


def measure(tree: str) -> None:
    sys.path.insert(0, tree)
    import numpy as np

    import vgan_tpu_torch.ensemble.od as od

    assert Path(od.__file__).resolve().is_relative_to(Path(tree).resolve()), od.__file__
    rng = np.random.default_rng(23)
    xtr = rng.standard_normal((1000, 100), dtype=np.float32)
    xte = rng.standard_normal((500, 100), dtype=np.float32)
    masks = rng.uniform(size=(1024, 100)) < 0.3
    masks[:, 0] = True
    proba = np.full(1024, 1.0 / 1024, np.float32)
    ens = od.SubspaceEnsemble(masks, proba, base="knn", k=10).fit(xtr)
    out = {}
    for name in CALLS:
        fn = getattr(ens, name)
        fn(xte)
        times = []
        for _ in range(20):
            t0 = time.perf_counter()
            s = fn(xte)
            times.append(time.perf_counter() - t0)
        out[name] = statistics.median(times) * 1e3
        out[name + "_sum"] = float(np.asarray(s, np.float64).sum())
    print(json.dumps(out), flush=True)


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--other", type=Path)
    parser.add_argument("--pairs", type=int, default=5)
    parser.add_argument("--measure", default=None, help=argparse.SUPPRESS)
    args = parser.parse_args()
    if args.measure:
        measure(args.measure)
        return 0
    import torch

    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 1
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True).stdout.strip())
    sides = {"this tree": str(REPO), "other": str(args.other.resolve())}
    runs = {name: [] for name in sides}
    for i in range(args.pairs):
        order = list(sides) if i % 2 == 0 else list(sides)[::-1]
        for name in order:
            proc = subprocess.run([sys.executable, __file__, "--measure", sides[name]],
                                  capture_output=True, text=True, check=True)
            runs[name].append(json.loads(proc.stdout.strip().splitlines()[-1]))
            print(name, runs[name][-1], flush=True)
    for key in CALLS:
        sums = {r[key + "_sum"] for name in sides for r in runs[name]}
        assert len(sums) == 1, f"{key}: the two trees' scores differ: {sums}"
        print(f"{key}: " + "; ".join(
            f"{name} {[round(r[key], 3) for r in runs[name]]} ms, median "
            f"{statistics.median(r[key] for r in runs[name]):.3f}" for name in sides)
            + "; scores equal", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
