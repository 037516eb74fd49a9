#!/usr/bin/env python3
"""The JAX package's ROC AUC for each base of ``chip_smoke.py`` phase 3e.

    JAX_PLATFORMS=cpu python3 examples/jax_base_auc.py [base ...]

Runs ``vgan_tpu.ensemble.SubspaceEnsemble`` on the CPU on the data and
masks phase 3e gives each base (``chip_smoke.bench_data`` and
``chip_smoke.base_config``: the bench ensemble's 1000 x 100 train rows, 500
test rows with 25 planted outliers, 1024 masks at k=10; iforest on the
first 256 masks with 100 trees and chunk 32, kpca on the first 128) and
prints the ROC AUC of the planted outliers, the limit phase 3e derives from it
(``chip_smoke.JAX_BENCH_AUC``), and the seconds taken. The neighbour bases
take minutes on the CPU (lof about 6, cof about 5).
"""

from __future__ import annotations

import sys
import time
from pathlib import Path

import jax

jax.config.update("jax_platforms", "cpu")

import numpy as np  # noqa: E402

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

import chip_smoke  # noqa: E402
from vgan_tpu.ensemble import SubspaceEnsemble  # noqa: E402


def main(bases) -> None:
    xtr, xte, is_out, subs = chip_smoke.bench_data()
    for base in bases:
        t0 = time.perf_counter()
        masks, kw = chip_smoke.base_config(base, subs)
        kw = dict(kw) if base == "iforest" else dict(kw, chunk=16)  # bounds the CPU's memory
        ens = SubspaceEnsemble(masks, np.full(len(masks), 1.0 / len(masks)), base=base, **kw)
        scores = np.asarray(ens.fit(xtr).decision_function(xte))
        held = chip_smoke.JAX_BENCH_AUC.get(base)
        print(f"{base}: ROC AUC {chip_smoke.roc_auc(scores, is_out):.4f} (phase 3e holds "
              + (f"{held:.4f}" if held is not None else "none yet") + "), finite "
              f"{bool(np.all(np.isfinite(scores)))}, {time.perf_counter() - t0:.1f} s", flush=True)


if __name__ == "__main__":
    main(sys.argv[1:] or chip_smoke.OTHER_BASES)
