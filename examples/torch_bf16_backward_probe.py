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
``vgan_tpu_torch/ops/cuda/csrc/`` with this tree's C interface), for this
tree's wrappers on the parent's kernels (``_build.built_from``), in turns:
parent, this tree, this tree, parent. ``--quick`` reads the two
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
import statistics
import sys
import tempfile
import time
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
    # who -> the directory of the mmd_gram.cu its calls run
    dirs = {"this tree": _build.CSRC}
    if args.parent_csrc:
        dirs["parent"] = args.parent_csrc
        with _build.built_from("mmd_gram", args.parent_csrc):
            G._lib()
    turns = ["parent", "this tree", "this tree", "parent"] if args.parent_csrc else ["this tree"]
    cut_dirs = {}
    if args.cuts:
        cut_dirs = S.variant_dirs("mmd_gram", _build.CSRC,
                                  cuts((_build.CSRC / "mmd_gram.cu").read_text()),
                                  Path(tempfile.mkdtemp(prefix="bf16_backward_cuts_")))

    def under(csrc, fn):
        """``fn`` run on the mmd_gram.cu of ``csrc``."""
        def call():
            with _build.built_from("mmd_gram", csrc):
                return fn()
        return call

    for kernel, m, d, R, large in SHAPES:
        if large and args.quick:
            continue
        z, norms, bw = S.large_gram_inputs(m, d, 61, device)
        raw, calls, operands = {}, {}, {}
        for who, csrc in dirs.items():
            if kernel == "K4 bf16":
                operands[who] = under(csrc, lambda: G.panel_operand(z, bf16=True))
                cols_t = operands[who]()
                raw[who] = (lambda cols_t=cols_t: G.kprime_panel_bf16(
                    z[:R], z, norms[:R], norms, bw, mults, offset=0, cols_t=cols_t))
            else:
                n1 = m // 2
                raw[who] = lambda: G.gram_backward_flash_bf16(z, norms, bw, n1, m - n1, mults)
            calls[who] = under(csrc, raw[who])
        iters = 3 if large else 20
        event = {who: [] for who in dirs}
        for who in turns:
            event[who].append(S.cuda_ms(calls[who], iters, 1))
        for who, call in calls.items():
            passes = S.device_split(call, calls=3 if large else 20)
            host = statistics.median(host_us(call, 5 if large else 50) for _ in range(3))
            label = f"R={R} C={m}" if kernel == "K4 bf16" else f"m={m}"
            if kernel == "K4 bf16":  # the column operand, made once a backward
                op = S.device_split(operands[who], calls=3)
                label += (f" (column operand: device {sum(op.values()):.2f} us: "
                          + "; ".join(f"{k} {v:.2f}" for k, v in op.items()) + ")")
            print(f"  {kernel} {label} d={d} {who}: event "
                  + ", ".join(f"{t:.4f}" for t in event[who]) + f" ms; host {host:.1f} us a call; "
                  f"device {sum(passes.values()):.2f} us a call: "
                  + "; ".join(f"{k} {v:.2f}" for k, v in
                              sorted(passes.items(), key=lambda kv: -kv[1])), flush=True)
        for name, csrc in cut_dirs.items():
            if name.startswith("k3_") != (kernel == "K3 bf16"):
                continue
            passes = S.device_split(under(csrc, raw["this tree"]), calls=3 if large else 20)
            print(f"    cut {name}: device {sum(passes.values()):.2f} us a call: "
                  + "; ".join(f"{k} {v:.2f}" for k, v in
                              sorted(passes.items(), key=lambda kv: -kv[1])), flush=True)
        del z, norms, raw, calls, operands
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
