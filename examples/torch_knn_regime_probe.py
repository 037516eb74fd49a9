#!/usr/bin/env python3
"""K6 (``knn_scores_resident``) against K7 (``knn_scores_stream``) over a
grid of widths and train-set sizes, on one NVIDIA GPU: the timings that the
crossover of ``vgan_tpu_torch.ops.cuda.knn_score._resident_supported`` is
judged by; or, with ``--variants``, where K7's time goes at the two score
cells' shapes.

    python3 examples/torch_knn_regime_probe.py [--out knn_regime.json]
    python3 examples/torch_knn_regime_probe.py --variants [--parent-csrc DIR] [--sass DIR]
        [--out FILE]

Each shape: 500 masks keeping each column with probability 0.477, 500 test
rows, k = 10, standard normal rows drawn on the card. Each kernel (with its
``knn_prep_kernel`` launch) is timed by CUDA events, one call a reading,
after a warm-up, in turns (K6, K7, K7, K6, K6, K7); the medians of three.
The two kernels' scores must be equal to the bit. Prints the card's name and
power limit first and one JSON line a shape; exits non-zero without a CUDA
device.

``--variants``: at 500 x 2000, d = 10240 and 500 x 801, d = 20531 (the
``no_kl.score`` and ``rnaseq.score`` shapes), K6, K7 and builds of
``csrc/knn_score.cu`` with one part of K7 changed or cut out by text
substitution (:data:`VARIANTS`; with ``--parent-csrc DIR``, an earlier
commit's ``vgan_tpu_torch/ops/cuda/csrc/`` with this tree's C interface, its
K7 too), each built with ``nvcc`` through the package's loader (the
variants started together; ``ptxas``' registers and spills printed),
launched on the same prepared operands and timed in turns (CUDA events,
median of three launches a turn, two turns in opposite orders). A variant
that still computes the scores must equal K6 to the bit; the cut ones time
a part: the product without selection, without the norms, without the
ring's refills (the chunks copied once), and without the refills and the
chunk barrier (the FFMA and shared-memory issue alone). The card's SM clock
and power are sampled meanwhile. ``--sass DIR`` keeps each build's SASS.
"""

from __future__ import annotations

import argparse
import gzip
import json
import re
import statistics
import subprocess
import sys
import tempfile
import threading
from pathlib import Path

REPO = Path(__file__).resolve().parent.parent
WIDTHS = (1024, 4096, 10240, 15616, 20531, 30000)
TRAIN_ROWS = (801, 2000, 8192)
N_MASKS, N_TEST, K, KEEP = 500, 500, 10, 0.477
TURNS = ("K6", "K7", "K7", "K6", "K6", "K7")
CELL_SHAPES = ((2000, 10240), (801, 20531))  # (ntr, d) of no_kl.score and rnaseq.score

# K7's kernel in csrc/knn_score.cu: the text substitutions below apply after it
_K7 = "\nknn_kernel(const float* __restrict__ xte_t"
_BK = "int stream_bk(int k) { return two_blocks_fit(WIDE_BK, k) ? WIDE_BK : NARROW_BK; }"
_STAGES = "constexpr int STREAM_STAGES = 2;"
_TWO_BLOCKS = 'static_assert(two_blocks_fit(NARROW_BK, MAX_K), "two blocks an SM at every k");'
_NORMS = "            if (tid < BR || t == 0) {\n                const float* S = tid < BR ? Bs + tid"
_SELECT = "        select_tile(d2, An, Bn, Buf, Cnt, L, k, i0, j0, ntr, exclude_self);\n"
_SPILL = """        volatile float spill[TM * TN];  // the products' live range ends here
        float d2[TM][TN];
#pragma unroll
        for (int r = 0; r < TM; ++r)
#pragma unroll
            for (int c = 0; c < TN; ++c) spill[r * TN + c] = acc[r][c];
#pragma unroll
        for (int r = 0; r < TM; ++r)
#pragma unroll
            for (int c = 0; c < TN; ++c) d2[r][c] = spill[r * TN + c];
"""
_CHECKSUM = """#pragma unroll
        for (int r = 0; r < TM; ++r)
#pragma unroll
            for (int c = 0; c < TN; ++c) chk += d2[r][c];
"""
_CURSOR = "    int cs = 0;  // the ring stage of the next step to multiply\n"
_SCORE = ("    if (tid < BT && i0 + tid < nt) write_score(L, k, mean, tid, "
          "out + (size_t)m * nt + i0 + tid);\n")
_OUT_CHECKSUM = "    if (tid < BT && i0 + tid < nt) out[(size_t)m * nt + i0 + tid] = chk;\n"
_REFILL = "            __syncthreads();\n            copy_next();\n"
_PRODUCT = [(_SELECT, _CHECKSUM), (_CURSOR, "    float chk = 0.f;\n" + _CURSOR),
            (_SCORE, _OUT_CHECKSUM)]
_NARROW = [(_BK, _BK.replace("two_blocks_fit(WIDE_BK, k) ? WIDE_BK : NARROW_BK", "NARROW_BK"))]
_RING4 = [(_STAGES, _STAGES.replace("2", "4")), (_TWO_BLOCKS, "")]
_IN_REGISTERS = [(_SPILL, "        float (&d2)[TM][TN] = acc;\n")]
_NOT_INLINED = [("__device__ __forceinline__ void select_tile(",
                 "__device__ __noinline__ void select_tile(")]
_FIRST_TILE = [(_SELECT, "        if (t == 0)\n    " + _SELECT)]
_NO_NORMS = [(_NORMS, "            if (false) {\n"
                      "                const float* S = tid < BR ? Bs + tid")]
_NO_REFILLS = [(_REFILL, "            __syncthreads();\n            dist_tile::cp_async_commit();\n")]
_NO_BARRIER = [(_REFILL, "            dist_tile::cp_async_commit();\n")]
# name: (substitutions after K7's kernel or in the whole file, scores kept)
VARIANTS = {
    "16-column chunks": (_NARROW, True),
    "16-column chunks, ring of 4": (_NARROW + _RING4, True),
    "products kept in registers": (_IN_REGISTERS, True),
    "16-column chunks, products kept in registers": (_NARROW + _IN_REGISTERS, True),
    "selection not inlined": (_NOT_INLINED, True),
    "the first tile selected only": (_FIRST_TILE, False),
    "product": (_PRODUCT, False),
    "product, no norms": (_PRODUCT + _NO_NORMS, False),
    "product, no refills": (_PRODUCT + _NO_REFILLS, False),
    "product, no refills, no barrier": (_PRODUCT + _NO_BARRIER, False),
}


def substitute(src: str, subs) -> str:
    """``src`` with each (old, new): ``old`` must occur once in the file, or
    else once after K7's kernel starts, and is replaced there."""
    start = src.index(_K7)
    for old, new in subs:
        if src.count(old) == 1:
            i = src.index(old)
        elif src[start:].count(old) == 1:
            i = src.index(old, start)
        else:
            raise ValueError(f"{old[:40]!r} is not unique after K7's kernel")
        src = src[:i] + new + src[i + len(old):]
    return src


def ptxas_lines(log: str) -> list:
    """One line for each KNN scoring kernel: ptxas' registers and spills."""
    found, name = {}, None
    for line in log.splitlines():
        m = re.search(r"(?:Compiling entry function|Function properties for) '(\S+)'", line)
        if m:
            name = m.group(1)
        elif name and re.search(r"knn_(resident_)?kernel", name):
            regs = re.search(r"Used (\d+) registers", line)
            spill = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", line)
            entry = found.setdefault(name, {"registers": None, "spills": (0, 0)})
            if regs:
                entry["registers"] = int(regs.group(1))
            if spill:
                entry["spills"] = max(entry["spills"], (int(spill.group(1)), int(spill.group(2))))
    out = []
    for n, e in found.items():
        m = re.search(r"(knn_(?:resident_)?kernel)(?:ILi(\d+)E)?", n)
        kernel = m.group(1) + (f"<{m.group(2)}>" if m.group(2) else "")
        out.append(f"{kernel}: {e['registers']} registers, spill stores / loads "
                   f"{e['spills'][0]} / {e['spills'][1]} B")
    return out


def dump_sass(lib: Path, out: Path) -> None:
    """``cuobjdump -sass`` of ``lib``, gzipped into ``out``."""
    from vgan_tpu_torch.ops.cuda import _build

    dump = subprocess.run([str(Path(_build._nvcc()).parent / "cuobjdump"), "-sass", str(lib)],
                          capture_output=True, text=True, timeout=300)
    with gzip.open(out, "wt") as f:
        f.write(dump.stdout + dump.stderr)


class Clocks:
    """nvidia-smi's SM clock (MHz), power (W) and temperature sampled every
    250 ms while in use."""

    def __enter__(self):
        self.proc = subprocess.Popen(
            ["nvidia-smi", "--query-gpu=clocks.sm,power.draw,temperature.gpu",
             "--format=csv,noheader,nounits", "-lms", "250"],
            stdout=subprocess.PIPE, text=True)
        self.rows = []
        self.reader = threading.Thread(target=self._read, daemon=True)
        self.reader.start()
        return self

    def _read(self):
        for line in self.proc.stdout:
            try:
                self.rows.append([float(v) for v in line.split(",")])
            except ValueError:
                pass

    def __exit__(self, *exc):
        self.proc.terminate()
        self.proc.wait()
        self.reader.join(timeout=5)

    def summary(self) -> dict:
        if not self.rows:
            return {}
        cols = list(zip(*self.rows))
        return {name: (min(c), statistics.median(c), max(c))
                for name, c in zip(("sm_mhz", "power_w", "temp_c"), cols)}


def variants(args, card: str) -> int:
    import torch

    import chip_smoke as S
    from vgan_tpu_torch.ops.cuda import _build
    from vgan_tpu_torch.ops.cuda import knn_score as KS

    src = (_build.CSRC / "knn_score.cu").read_text()
    sources = {name: substitute(src, subs) for name, (subs, _) in VARIANTS.items()}
    keeps = {name: keep for name, (_, keep) in VARIANTS.items()}
    with tempfile.TemporaryDirectory() as tmp:
        if args.sass is not None:
            args.sass.mkdir(parents=True, exist_ok=True)
        dirs = {"this tree": _build.CSRC,
                **S.variant_dirs("knn_score", _build.CSRC, sources, Path(tmp))}
        if args.parent_csrc:
            dirs["parent K7"] = args.parent_csrc
            keeps["parent K7"] = True
        libs = {}
        for name, csrc in dirs.items():
            with _build.built_from("knn_score", csrc):
                libs[name] = KS._lib()
            if args.sass is not None:
                dump_sass(Path(libs[name]._name),
                          args.sass / f"{re.sub(r'[^A-Za-z0-9]+', '_', name)}.sass.gz")
            info = _build.build_info.get("knn_score" if csrc == _build.CSRC
                                         else str(Path(csrc).resolve() / "knn_score.cu"))
            for line in ptxas_lines(info["log"] if info else ""):
                print(f"  {name}: {line}", flush=True)
        tree = libs.pop("this tree")
        runs = {"K6": ("vgan_knn_resident", tree), "K7": ("vgan_knn_stream", tree),
                **{name: ("vgan_knn_stream", lib) for name, lib in libs.items()}}
        dev = torch.device("cuda")
        rows = []
        for ntr, d in CELL_SHAPES:
            g = torch.Generator(device=dev).manual_seed(d * 10007 + ntr)
            xtr = torch.randn((ntr, d), generator=g, device=dev)
            xte = torch.randn((N_TEST, d), generator=g, device=dev)
            masks = (torch.rand((N_MASKS, d), generator=g, device=dev) < KEEP).float()
            xte_t, xtr_t, cols, counts = KS.kernel_operands(xte, xtr, masks)
            n_sel = int(counts.sum())
            bound_ms = S.bound(S.knn_ops(n_sel, N_MASKS, N_TEST, ntr),
                               4 * (N_MASKS * d + N_TEST * d + ntr * d + N_MASKS * N_TEST))[0]
            outs = {name: torch.empty((N_MASKS, N_TEST), device=dev) for name in runs}

            def launch(name):
                fn, lib = runs[name]
                _build.launch(lib, fn, dev, xte_t.data_ptr(), xte_t.shape[1], xtr_t.data_ptr(),
                              xtr_t.shape[1], cols.data_ptr(), counts.data_ptr(), N_MASKS,
                              N_TEST, ntr, d, K, 0, 0, outs[name].data_ptr())

            for name in runs:
                launch(name)
            torch.cuda.synchronize()
            for name in runs:
                if name == "K6" or keeps.get(name, True):
                    S.check(torch.equal(outs[name], outs["K6"]),
                            f"{name} at {ntr} x {d}: scores differ from K6's")
            times = {name: [] for name in runs}
            order = list(runs)
            with Clocks() as clocks:
                for turn in (order, order[::-1]):
                    for name in turn:
                        times[name].append(S.cuda_ms(lambda: launch(name), 3, 1))
            row = {"ntr": ntr, "d": d, "n_selected": n_sel, "bound_ms": bound_ms,
                   "clocks": clocks.summary(), "ms": {}}
            print(f"{N_TEST} x {ntr}, d = {d}: {n_sel} selected columns, bound {bound_ms:.2f} "
                  f"ms; SM MHz, W, C (min, median, max): {row['clocks']}", flush=True)
            for name in runs:
                ms = statistics.mean(times[name])
                row["ms"][name] = times[name]
                print(f"  {name:34s} {ms:9.3f} ms ({', '.join(f'{t:.3f}' for t in times[name])})"
                      f"  {100 * bound_ms / ms:6.2f}% of the bound", flush=True)
            rows.append(row)
            del xtr, xte, masks, xte_t, xtr_t, cols, outs
    if args.out is not None:
        args.out.parent.mkdir(parents=True, exist_ok=True)
        args.out.write_text(json.dumps({"card": card, "rows": rows}, indent=1))
    return 0


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--out", type=Path, default=None)
    ap.add_argument("--variants", action="store_true")
    ap.add_argument("--parent-csrc", type=Path, default=None)
    ap.add_argument("--sass", type=Path, default=None)
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
    if args.variants:
        return variants(args, card)
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
