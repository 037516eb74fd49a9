"""Readings of the comparison that decides ``correct``, at a cell's own size:
the program's gaps to the reference over many seeds (sound runs: the lower
readings), the control's (the reference in TF32 put in the program's place)
and each planted fault's (the upper readings). No measured window: each
seed runs the set-up's checked steps (fits) or one call a test batch
(scoring). Prints one JSON line a reading, then the largest program reading
and the smallest control and fault readings of each number.

    python3 benchmarks/tests/chip_readings.py --workload no_kl.fit \\
        --seeds 11 12 13 --control-seeds 11 12 13 --faults state_unchanged half_batch

on a machine with the cell's cards (``--device cpu`` and ``--root`` serve
the tests' tiny copies). A cell of several cards runs one process a card.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time
from pathlib import Path

BENCH_DIR = Path(__file__).resolve().parents[1]
for _p in (str(BENCH_DIR.parent), str(BENCH_DIR)):
    if _p not in sys.path:
        sys.path.insert(0, _p)


def _readings_fit(ctx, seed, control, fault_names, mesh, emit, leaves=False):
    from harness import compare, fit
    from harness.device import free
    from tests import faults

    def program(fault=None):
        from harness import data

        x = data.dataset(ctx.config, seed, ctx.device).cpu().numpy()
        if fault is None:
            est = fit.build(ctx, x, mesh)
            prog = fit.checked_steps(est, x, ctx.traffic["check_epochs"])
        else:
            with faults.DP[fault]():
                est = fit.build(ctx, x, mesh)
                prog = fit.checked_steps(est, x, ctx.traffic["check_epochs"])
        del est
        free(ctx.device)
        return prog

    progs = {"program": program()}
    for name in fault_names:
        progs[name] = program(name)
    if ctx.rank != 0:
        return
    ref = fit.reference_readings(ctx)
    if control:
        progs["control"] = fit.reference_readings(ctx, "tf32")
    for kind, prog in progs.items():
        emit(seed, kind, compare.fit_gaps(prog, ref))
        if leaves:
            emit(seed, kind + ".grad_leaves", {
                k: abs(prog["grad_norms"][k] - v) / v for k, v in ref["grad_norms"].items()})


def _readings_score(ctx, seed, control, fault_names, emit):
    from harness import compare, data, score
    from harness.device import free
    from tests import faults

    x_train, x_test, masks = data.score_inputs(ctx.config, ctx.traffic, seed, ctx.device)
    batches = [b.cpu().numpy() for b in x_test]
    xtr, masks_np = x_train.cpu().numpy(), masks.cpu().numpy()
    del x_train, x_test, masks
    order = list(range(len(batches)))
    outs = {}
    ens = score.build(ctx, xtr, masks_np)

    def calls():
        raw = score.checked_calls(ens, batches)
        return score.score_calls(ens, batches, len(batches)), raw

    outs["program"] = calls()
    for name in fault_names:
        with faults.SCORE[name]():
            outs[name] = calls()
    del ens
    free(ctx.device)
    ref, kth = score.reference_scores(ctx)
    for kind, (out, raw) in outs.items():
        emit(seed, kind, {"score": compare.score_gap(out, order, ref),
                          "kth": compare.kth_gap(raw, kth)})
    if control:
        tf32, tf32_kth = score.reference_scores(ctx, "tf32")
        emit(seed, "control", {"score": compare.score_gap(list(tf32), order, ref),
                               "kth": compare.kth_gap(list(tf32_kth), kth)})


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--control-seeds", type=int, nargs="*", default=[])
    ap.add_argument("--faults", nargs="*", default=[])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--root", default=None)
    ap.add_argument("--rank", type=int, default=None)
    ap.add_argument("--leaves", action="store_true", help="also each parameter's gradient gap")
    args = ap.parse_args(argv)
    os.environ["USE_FLAX"] = "0"
    import torch

    from harness.spec import ROOT, Cell, Context

    cell = Cell(args.workload, Path(args.root) if args.root else ROOT)
    if cell.chips > 1 and args.rank is None:
        import socket

        with socket.socket() as s:
            s.bind(("127.0.0.1", 0))
            port = s.getsockname()[1]
        procs = [subprocess.Popen(
            [sys.executable, __file__, *(argv if argv is not None else sys.argv[1:]),
             "--rank", str(r)],
            env=dict(os.environ, RANK=str(r), LOCAL_RANK=str(r), WORLD_SIZE=str(cell.chips),
                     MASTER_ADDR="127.0.0.1", MASTER_PORT=str(port)))
            for r in range(cell.chips)]
        return max(p.wait() for p in procs)
    rank = args.rank or 0
    if args.device == "cuda":
        torch.cuda.set_device(rank)
        device = torch.device("cuda", rank)
    else:
        device = torch.device(args.device)
    torch.backends.cuda.matmul.allow_tf32 = False
    mesh = None
    if cell.traffic.get("layout") == "dp":
        from vgan_tpu_torch.parallel import make_mesh

        mesh = make_mesh(data=cell.chips, device=device.type)
    rows = []

    def emit(seed, kind, gaps):
        row = {"seed": seed, "kind": kind,
               "gaps": {k: (v if v == v and abs(v) != float("inf") else str(v))
                        for k, v in gaps.items()}}
        rows.append(row)
        print(json.dumps(row), flush=True)

    for seed in args.seeds:
        t0 = time.time()
        ctx = Context(cell, seed, 0.0, False, device, t0, rank, cell.chips)
        if cell.traffic["kind"] == "fit":
            _readings_fit(ctx, seed, seed in args.control_seeds, args.faults, mesh, emit,
                          args.leaves)
        else:
            _readings_score(ctx, seed, seed in args.control_seeds, args.faults, emit)
        if rank == 0:
            print(f"seed {seed}: {time.time() - t0:.1f} s", file=sys.stderr, flush=True)
    if rank != 0:
        return 0
    summary = {}
    for row in rows:
        if row["kind"].endswith("_leaves"):
            continue
        for name, v in row["gaps"].items():
            v = float(v)
            key = (row["kind"], name)
            agg = max if row["kind"] == "program" else min
            summary[key] = agg(summary.get(key, v), v)
    for (kind, name), v in sorted(summary.items()):
        print(f"summary {kind} {name} {'max' if kind == 'program' else 'min'} {v!r}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
