#!/usr/bin/env python3
"""Where the bf16 backward's host and device time go (K4 bf16 and K3 bf16),
on one NVIDIA GPU.

    python3 examples/torch_bf16_backward_probe.py [--parent-csrc DIR] [--quick] [--cuts]

The bf16 backward is ``kprime_panel_bf16`` (K4 bf16) and
``gram_backward_flash_bf16`` (K3 bf16) of
``vgan_tpu_torch/ops/cuda/mmd_gram.py``. At the shapes ``chip_smoke.py``
holds and times them at (K4 bf16: the panel fit's square panel, R=C=1000,
d=10240, and one real panel, R=1472, C=45056, d=10240, both at offset 0
with the column operand made once outside the call, as the panel backward
makes it; K3 bf16: the kl cycle's Gram, m=1000, d=640, and m=8192,
d=1024) the probe reads, for one call:

- the CUDA-event time (``chip_smoke.cuda_ms``: median of 20 calls, 3 at
  the large shapes);
- the wrapper's host time: the host clock over calls enqueued back to back,
  a call's share (the card runs behind);
- each pass's device time (``chip_smoke.device_split``), and for K4 bf16
  that of its column operand;

for this tree and, with ``--parent-csrc DIR`` (an earlier commit's
``vgan_tpu_torch/ops/cuda/csrc/``), for the parent's kernels launched as
the parent's wrappers launched them (``chip_smoke.parent_backward_bf16``),
in turns: parent, this tree, this tree, parent. ``--quick`` reads the two
small shapes only. ``--cuts`` also reads the device time of builds of this
tree's ``mmd_gram.cu`` with one part cut out (the outputs are wrong and not
read; a cut whose marker is no longer in the source raises): K4 bf16's
``no_ladder`` (the ladder behind its call two products,
``examples/torch_mmd_ladder_probe.py``'s stub); K3 bf16's
``k3_no_ladder`` (its inline ladder two products), ``k3_no_exchange`` (no
CTA stores its rows of S to the other CTAs) and ``k3_no_sz`` (no S @ z
product). The checks
against the plain versions are ``chip_smoke.py``'s (phase 2). Prints the
card's name and power limit first. Exits non-zero without a CUDA device.
"""

from __future__ import annotations

import argparse
import ctypes
import statistics
import subprocess
import sys
import tempfile
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "examples"))

# (kernel, m, d, R for K4 or None, large)
SHAPES = (("K4 bf16", 1000, 10240, 1000, False), ("K3 bf16", 1000, 640, None, False),
          ("K4 bf16", 45056, 10240, 1472, True), ("K3 bf16", 8192, 1024, None, True))


def host_us(fn, calls: int) -> float:
    """Host microseconds a call of ``fn`` takes to enqueue, back to back."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(calls):
        fn()
    t1 = time.perf_counter()
    torch.cuda.synchronize()
    return (t1 - t0) / calls * 1e6


def _cut(src: str, old: str, new: str) -> str:
    if src.count(old) != 1:
        raise ValueError(f"marker {old!r} occurs {src.count(old)} times")
    return src.replace(old, new)


def _cut_block(src: str, start: str, end: str) -> str:
    """src without the text from the one ``start`` up to and including the
    first ``end`` after it."""
    if src.count(start) != 1:
        raise ValueError(f"marker {start!r} occurs {src.count(start)} times")
    a = src.index(start)
    return src[:a] + src[src.index(end, a) + len(end):]


def cuts(src: str) -> dict:
    """The sources with a part of the bf16 backward cut out (see the top)."""
    from torch_mmd_ladder_probe import variants as ladder_variants

    return {
        "no_ladder": ladder_variants(src)["stub"],
        "k3_no_ladder": _cut(src, "                ladder_body<false, true>(d2, bw, L, k, kpv);\n",
                             "                k = 0.f, kpv = d2 * 1e-6f;\n"),
        "k3_no_exchange": _cut(src, "            for (int pc = 0; pc < c; ++pc)  // to every CTA's "
                                    "Sbuf, this one's first\n",
                               "            for (int pc = 0; pc < 1; ++pc)\n"),
        "k3_no_sz": _cut_block(src, "            const uint8_t* zc = Zbuf + (g / 2) * FC_BOX;\n",
                               "out[i] += frag[i];\n                }\n"),
    }


def build_cuts(G, _build):
    """``name -> library`` of the cut variants, built together."""
    tmp = Path(tempfile.mkdtemp(prefix="bf16_backward_cuts_"))

    def build(item):
        name, text = item
        out = tmp / name
        out.mkdir()
        for h in _build.CSRC.glob("*.cuh"):
            (out / h.name).write_text(h.read_text())
        (out / "mmd_gram.cu").write_text(text)
        lib = out / "libmmd_gram.so"
        subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, "-o", str(lib), str(out / "mmd_gram.cu")],
                       check=True, capture_output=True, text=True, timeout=900)
        cdll = ctypes.CDLL(str(lib))
        for fn, argtypes in G._SIGNATURES.items():
            getattr(cdll, fn).argtypes = argtypes
            getattr(cdll, fn).restype = ctypes.c_int
        return cdll

    sources = cuts((_build.CSRC / "mmd_gram.cu").read_text())
    with ThreadPoolExecutor(len(sources)) as pool:
        return dict(zip(sources, pool.map(build, sources.items())))


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--parent-csrc", type=Path, default=None)
    parser.add_argument("--quick", action="store_true")
    parser.add_argument("--cuts", action="store_true")
    args = parser.parse_args(argv)
    if not torch.cuda.is_available():
        print("torch_bf16_backward_probe: no CUDA device is available", file=sys.stderr)
        return 1
    import chip_smoke as S
    from vgan_tpu_torch.ops import mmd as M
    from vgan_tpu_torch.ops.cuda import _build
    from vgan_tpu_torch.ops.cuda import mmd_gram as G

    print(S.card_identity(), flush=True)
    device = torch.device("cuda")
    mults = M.bandwidth_multipliers()
    G._lib()
    # who -> (K4 bf16, K3 bf16, K4 bf16's column operand of z)
    fns = {"this tree": (G.kprime_panel_bf16, G.gram_backward_flash_bf16,
                         lambda z: G.panel_operand(z, bf16=True))}
    if args.parent_csrc:
        parent_lib = S.build_parent(args.parent_csrc, print)["mmd_gram"]
        fns["parent"] = S.parent_backward_bf16(parent_lib, device)
    turns = ["parent", "this tree", "this tree", "parent"] if args.parent_csrc else ["this tree"]
    cut_libs = build_cuts(G, _build) if args.cuts else {}
    for kernel, m, d, R, large in SHAPES:
        if large and args.quick:
            continue
        z, norms, bw = S.large_gram_inputs(m, d, 61, device)
        calls = {}
        for who, (panel, flash, operand) in fns.items():
            if kernel == "K4 bf16":
                cols_t = operand(z)
                calls[who] = (lambda panel=panel, cols_t=cols_t: panel(
                    z[:R], z, norms[:R], norms, bw, mults, offset=0, cols_t=cols_t))
            else:
                n1 = m // 2
                calls[who] = (lambda flash=flash: flash(z, norms, bw, n1, m - n1, mults))
        iters = 3 if large else 20
        event = {who: [] for who in fns}
        for who in turns:
            event[who].append(S.cuda_ms(calls[who], iters, 1))
        for who, call in calls.items():
            passes = S.device_split(call, calls=3 if large else 20)
            host = statistics.median(host_us(call, 5 if large else 50) for _ in range(3))
            label = f"R={R} C={m}" if kernel == "K4 bf16" else f"m={m}"
            if kernel == "K4 bf16":  # the column operand, made once a backward
                op = S.device_split(lambda: fns[who][2](z), calls=3)
                label += (f" (column operand: device {sum(op.values()):.2f} us: "
                          + "; ".join(f"{k} {v:.2f}" for k, v in op.items()) + ")")
            print(f"  {kernel} {label} d={d} {who}: event "
                  + ", ".join(f"{t:.4f}" for t in event[who]) + f" ms; host {host:.1f} us a call; "
                  f"device {sum(passes.values()):.2f} us a call: "
                  + "; ".join(f"{k} {v:.2f}" for k, v in
                              sorted(passes.items(), key=lambda kv: -kv[1])), flush=True)
        this = calls["this tree"]
        variants = {name: (S.using_lib(G, lib), this) for name, lib in cut_libs.items()
                    if name.startswith("k3_") == (kernel == "K3 bf16")}
        for name, (ctx, call) in variants.items():
            with ctx:
                passes = S.device_split(call, calls=3 if large else 20)
            print(f"    cut {name}: device {sum(passes.values()):.2f} us a call: "
                  + "; ".join(f"{k} {v:.2f}" for k, v in
                              sorted(passes.items(), key=lambda kv: -kv[1])), flush=True)
        del z, norms, calls, this, variants
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
