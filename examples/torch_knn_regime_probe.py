#!/usr/bin/env python3
"""K6 (``knn_scores_resident``) against K7 (``knn_scores_stream``) over a
grid of widths and train-set sizes, on one NVIDIA GPU: the timings that the
crossover of ``vgan_tpu_torch.ops.cuda.knn_score._resident_supported`` is
judged by.

    python3 examples/torch_knn_regime_probe.py [--out knn_regime.json]

Each shape: 500 masks keeping each column with probability 0.477, 500 test
rows, k = 10, standard normal rows drawn on the card. Each kernel (with its
``knn_prep_kernel`` launch) is timed by CUDA events, one call a reading,
after a warm-up, in turns (K6, K7, K7, K6, K6, K7); the medians of three.
The two kernels' scores must be equal to the bit. Prints the card's name and
power limit first and one JSON line a shape; exits non-zero without a CUDA
device.
"""

from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import sys
from pathlib import Path

REPO = Path(__file__).resolve().parent.parent
WIDTHS = (1024, 4096, 10240, 15616, 20531, 30000)
TRAIN_ROWS = (801, 2000, 8192)
N_MASKS, N_TEST, K, KEEP = 500, 500, 10, 0.477
TURNS = ("K6", "K7", "K7", "K6", "K6", "K7")


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--out", type=Path, default=None)
    args = ap.parse_args()
    sys.path.insert(0, str(REPO))
    import torch

    from vgan_tpu_torch.ops.cuda import knn_score as KS

    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 1
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True).stdout.strip()
    print(card, flush=True)
    dev = torch.device("cuda")
    kernels = {"K6": KS.knn_scores_resident, "K7": KS.knn_scores_stream}
    rows = []
    for d in WIDTHS:
        for ntr in TRAIN_ROWS:
            g = torch.Generator(device=dev).manual_seed(d * 10007 + ntr)
            xtr = torch.randn((ntr, d), generator=g, device=dev)
            xte = torch.randn((N_TEST, d), generator=g, device=dev)
            masks = (torch.rand((N_MASKS, d), generator=g, device=dev) < KEEP).float()
            outs = {name: fn(xte, xtr, masks, K) for name, fn in kernels.items()}
            torch.cuda.synchronize()
            equal = bool(torch.equal(outs["K6"], outs["K7"]))
            times = {name: [] for name in kernels}
            for name in TURNS:
                start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
                start.record()
                kernels[name](xte, xtr, masks, K)
                end.record()
                end.synchronize()
                times[name].append(start.elapsed_time(end))
            ms = {name: statistics.median(t) for name, t in times.items()}
            row = {"d": d, "ntr": ntr, "n_selected": int(masks.sum()), "K6_ms": ms["K6"],
                   "K7_ms": ms["K7"], "K6_over_K7": ms["K6"] / ms["K7"], "equal": equal,
                   "times": times, "chosen": "K6" if KS._resident_supported(ntr, d) else "K7"}
            rows.append(row)
            print(json.dumps(row), flush=True)
            del xtr, xte, masks, outs
    if args.out is not None:
        args.out.parent.mkdir(parents=True, exist_ok=True)
        args.out.write_text(json.dumps({"card": card, "rows": rows}, indent=1))
    return 0 if all(r["equal"] for r in rows) else 2


if __name__ == "__main__":
    sys.exit(main())
