"""Streaming-Gram permutation test at large sample counts, through the K5
kernel (counterpart of ``vgan_tpu.ops.pallas.gof_gram``).

The permutation MMD test needs, for every indicator row ``a_p`` of the
pooled samples, the quadratic forms of the per-alpha Grams
``K_a = exp(-alpha d2)``. :func:`a_times_k` computes ``C_a = A @ K_a`` for
every alpha from one distance pass (``csrc/gof_gram.cu``): pass 1 writes
d2, each unordered pair formed once, into an (m, m) buffer where it fits
``GRAM_BUFFER_BYTES``, else row panel by row panel (:func:`panels`); pass 2
forms K from d2 as it streams, with the diagonal zeroed (the unbiased
statistic excludes self-pairs) and the accumulation over the reduction axis
Kahan-compensated. All statistics then come from C and A in O(P m):

    s_xx(p) = sum_i A[p, i] C[p, i],   s_xy(p) = sum_i (1 - A[p, i]) C[p, i],
    s_yy(p) = 1^T K 1 - s_xx(p) - 2 s_xy(p).

Under a mesh the indicator rows split over its 'data' ranks, each rank
running K5 on its rows against the replicated pooled rows; the statistics
are all-gathered in row order.

The unbiased statistic is a near-cancellation of O(m^2)-entry sums: under
the null it sits near 1e-7 while float32 final sums carry rounding of order
one, so ``precise=True`` fetches the C planes and reduces the quadratic
forms in float64 on the host.

:func:`a_times_k` given CPU tensors returns its plain version
(:func:`a_times_k_reference`); given CUDA tensors it launches the kernel or
raises.
"""

from __future__ import annotations

import ctypes
from typing import Optional, Sequence, Tuple

import torch

from vgan_tpu_torch.ops.cuda import _build
from vgan_tpu_torch.ops.cuda._build import check, column_major, launch, round_up
from vgan_tpu_torch.ops.mmd_test import _indicators, _pooled

# Alphas per launch of pass 2 (the size of the kernel's alpha table); longer
# sweeps launch it once per chunk, on the same d2.
MAX_ALPHAS_PER_PASS = 8
# Indicator rows per call of the kernel: the C planes of one block of rows,
# n_alphas x rows x m float32, stay within this many bytes.
ROW_BLOCK_BYTES = 1 << 30
# The d2 buffer of pass 1 holds at most this many bytes: the whole (m, m)
# where it fits (every pair formed once), else row panels of it (pairs
# across panels formed twice). Read at call time; lower it to force panels.
GRAM_BUFFER_BYTES = 4 << 30
# The kernels' d2 tile (BG in csrc/gof_gram.cu), and their indicator-row
# tile (BP): the operand copies are padded to whole tiles.
KERNEL_TILE = 128


# ---------------------------------------------------------------------------
# plain version
# ---------------------------------------------------------------------------


def a_times_k_reference(z, norms, a, alphas) -> torch.Tensor:
    """``C[k] = a @ K_k`` with ``K_k = exp(-alphas[k] d2)``, the Gram's
    diagonal zeroed; d2 materialized as the kernel forms it,
    ``(-2 z z^T + |z_i|^2) + |z_j|^2`` clamped at 0. (n_alphas, P, m), in
    the inputs' dtype."""
    d2 = torch.clamp_min(-2.0 * (z @ z.T) + norms[:, None] + norms[None, :], 0.0)
    off_diag = ~torch.eye(z.shape[0], dtype=torch.bool, device=z.device)
    return torch.stack([a @ torch.where(off_diag, torch.exp(-float(al) * d2), 0.0)
                        for al in alphas])


# ---------------------------------------------------------------------------
# kernel wrapper
# ---------------------------------------------------------------------------


class _Alphas(ctypes.Structure):
    _fields_ = [("n", ctypes.c_int), ("a", ctypes.c_float * MAX_ALPHAS_PER_PASS)]


_P, _I = ctypes.c_void_p, ctypes.c_int
_SIGNATURES = {
    "vgan_gof_gram_d2": [_P, _P, _I, _I, _I, _I, _I, _P, _P],
    "vgan_gof_a_times_k": [_P, _I, _P, _I, _I, _I, _I, _I, ctypes.POINTER(_Alphas), _I, _P, _P],
}


def panels(m: int) -> list:
    """``[(row0, rows), ...]``: the row panels in which pass 1 forms d2, each
    ``row0`` a multiple of ``KERNEL_TILE``. One panel ``(0, m)`` where the
    whole padded (M, M) buffer fits ``GRAM_BUFFER_BYTES``: the full-Gram
    regime, in which every unordered pair is formed once."""
    M = round_up(m, KERNEL_TILE)
    rows = max(KERNEL_TILE, GRAM_BUFFER_BYTES // (4 * M) // KERNEL_TILE * KERNEL_TILE)
    return [(r0, min(rows, m - r0)) for r0 in range(0, m, rows)]


def regime(m: int) -> str:
    """'full' (one symmetric d2 buffer) or 'panels'."""
    return "full" if len(panels(m)) == 1 else "panels"


def _lib():
    return _build.bound("gof_gram", _SIGNATURES)


def _alpha_table(alphas) -> _Alphas:
    table = _Alphas()
    table.n = len(alphas)
    for i, al in enumerate(alphas):
        table.a[i] = al
    return table


def _launch_passes(z, norms, a, alphas) -> torch.Tensor:
    """Pass 1 per panel of :func:`panels`, then pass 2 per
    ``MAX_ALPHAS_PER_PASS`` alphas on that panel's d2, each panel after the
    first adding into C."""
    m, d = z.shape
    P, dev = a.shape[0], z.device
    z_t = column_major(z, KERNEL_TILE)
    M = z_t.shape[1]
    norms_p = torch.zeros(M, dtype=torch.float32, device=dev)
    norms_p[:m] = norms
    a_t = column_major(a, KERNEL_TILE)  # (m, P padded): A[p, j] at a_t[j, p]
    c = torch.empty((len(alphas), P, m), dtype=torch.float32, device=dev)
    plan = panels(m)
    d2 = torch.empty((round_up(plan[0][1], KERNEL_TILE), M), dtype=torch.float32, device=dev)
    tables = [(i, _alpha_table(alphas[i:i + MAX_ALPHAS_PER_PASS]))
              for i in range(0, len(alphas), MAX_ALPHAS_PER_PASS)]
    for n, (row0, rows) in enumerate(plan):
        launch(_lib(), "vgan_gof_gram_d2", dev, z_t.data_ptr(), norms_p.data_ptr(), M, d,
               int(len(plan) == 1), row0 // KERNEL_TILE, -(-rows // KERNEL_TILE), d2.data_ptr())
        for i, table in tables:
            launch(_lib(), "vgan_gof_a_times_k", dev, a_t.data_ptr(), a_t.shape[1], d2.data_ptr(),
                   M, m, P, row0, rows, ctypes.byref(table), int(n > 0),
                   c[i:i + table.n].data_ptr())
    return c


def a_times_k(z, norms, a, alphas: Sequence[float]) -> torch.Tensor:
    """``C_a = A @ K_a(z)`` for every alpha, (n_alphas, P, m) float32:
    ``z`` (m, d) the unpadded pooled rows, ``norms`` (m,) their squared
    norms, ``a`` (P, m) the indicator rows. One d2 pass serves every
    alpha."""
    alphas = [float(al) for al in alphas]
    if not z.is_cuda:
        return a_times_k_reference(z, norms, a, alphas)
    m, d = z.shape
    check("z", z, (m, d), z.device)
    check("norms", norms, (m,), z.device)
    check("a", a, (a.shape[0], m), z.device)
    if not alphas:
        raise ValueError("a_times_k needs at least one alpha")
    c = _launch_passes(z, norms, a, alphas)
    _build.count("a_times_k")
    return c


def reset_launch_counts() -> None:
    _build.reset(["a_times_k"])


def launch_counts() -> dict:
    return _build.counts(["a_times_k"])


# ---------------------------------------------------------------------------
# statistics and the tiled permutation tests
# ---------------------------------------------------------------------------


def _stats_from_c(c, a, totals, n1: int, n2: int) -> torch.Tensor:
    """(n_alphas, rows) unbiased statistics from C planes (n_alphas, rows,
    m), indicator rows ``a`` and the pooled off-diagonal totals."""
    s_xx = torch.einsum("apm,pm->ap", c, a)
    s_xy = torch.einsum("apm,pm->ap", c, 1.0 - a)
    s_yy = totals[:, None] - s_xx - 2.0 * s_xy
    return (
        s_xx / (n1 * (n1 - 1))
        + s_yy / (n2 * (n2 - 1))
        - 2.0 * s_xy / (n1 * n2)
    )


def _stats_for_rows(a_rows, z, norms, alphas, n1: int, n2: int, precise: bool = False):
    """Unbiased two-sample MMD statistics for a block of indicator rows.

    ``a_rows`` is (n_rows, m); rows are independent (C = A @ K row-wise).
    They go to the kernel in blocks of at most ``ROW_BLOCK_BYTES`` of C
    planes; the first block carries one all-ones row more, whose C row sums
    to the pooled total ``1^T K_offdiag 1``. Returns (n_alphas, n_rows):
    float32 on the rows' device, or with ``precise=True`` float64 on the CPU,
    reduced from the fetched C planes.
    """
    n_rows, m = a_rows.shape
    per_block = max(1, ROW_BLOCK_BYTES // (4 * len(alphas) * m))
    ones = torch.ones((1, m), dtype=a_rows.dtype, device=a_rows.device)
    chunks, totals = [], None
    for start in range(0, n_rows, per_block):
        block = a_rows[start:start + per_block]
        n_blk = block.shape[0]
        rows = torch.cat([block, ones]) if totals is None else block
        c = a_times_k(z, norms, rows.contiguous(), alphas)
        if precise:
            c, block = c.cpu().double(), block.cpu().double()
        if totals is None:
            totals = c[:, n_blk].sum(dim=1)
        chunks.append(_stats_from_c(c[:, :n_blk], block, totals, n1, n2))
    return torch.cat(chunks, dim=1)


def _sharded_stats(a_rows, z, norms, alphas, n1: int, n2: int, precise: bool, mesh):
    """:func:`_stats_for_rows` with the indicator rows split over the mesh's
    'data' ranks (zero rows pad them to a multiple): each rank streams its
    rows against the replicated pooled rows, K5 on its rows only, and the
    statistics are all-gathered in row order. With ``precise`` each rank
    reduces its own C planes in float64 on the host, as the single-device
    route does."""
    from vgan_tpu_torch.parallel.mesh import axis_size
    from vgan_tpu_torch.parallel.ring import gather_rows

    n_rows = a_rows.shape[0]
    p, r = axis_size(mesh, "data"), mesh.get_local_rank("data")
    per = -(-n_rows // p)
    padded = torch.zeros((per * p, a_rows.shape[1]), dtype=a_rows.dtype, device=a_rows.device)
    padded[:n_rows] = a_rows
    local = _stats_for_rows(padded[r * per:(r + 1) * per], z, norms, alphas, n1, n2, precise)
    # rows of the gather are statistics columns; NCCL gathers card tensors
    stats = gather_rows(local.T.contiguous().to(mesh.device_type), mesh.get_group("data"),
                        per * p).T[:, :n_rows]
    return stats.to(local.device)


def _tiled_stats(x, y, alphas, generator, n_permutations, precision, permutations, mesh,
                 device) -> torch.Tensor:
    """(n_alphas, 1 + P) statistics of the observed split, then of each
    permutation: float32 pooled rows and the [observed; permutations]
    indicator rows on one device, through :func:`_stats_for_rows`, or over
    the 'data' ranks of ``mesh`` (:func:`_sharded_stats`)."""
    if precision not in ("float32", "float64"):
        raise ValueError(f"precision must be 'float32' or 'float64', got {precision!r}")
    z, n1, n2 = _pooled(x, y, device)
    z = z.to(torch.float32).contiguous()
    norms = torch.sum(z * z, dim=1)
    base = torch.cat([torch.ones(n1), torch.zeros(n2)]).to(device=z.device, dtype=torch.float32)
    if permutations is None:
        permutations = _indicators(n1, n2, n_permutations, generator, torch.float32, z.device)
    perms = torch.as_tensor(permutations, dtype=torch.float32, device=z.device)
    a_rows = torch.cat([base[None, :], perms])
    alphas = [float(al) for al in torch.as_tensor(alphas, dtype=torch.float64).reshape(-1)]
    if mesh is not None:
        from vgan_tpu_torch.parallel.mesh import check_mesh_device

        check_mesh_device(mesh, z.device)
        return _sharded_stats(a_rows, z, norms, alphas, n1, n2, precision == "float64", mesh)
    return _stats_for_rows(a_rows, z, norms, alphas, n1, n2, precise=precision == "float64")


def mmd_permutation_test_tiled_sweep(
    x,
    y,
    alphas,
    generator: Optional[torch.Generator] = None,
    n_permutations: int = 1000,
    precision: str = "float32",
    permutations=None,
    mesh=None,
    device=None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-alpha large-m permutation tests in one distance-stream pass.

    Returns ``(statistics, p_values)``, each (n_alphas,). Same statistic and
    permutation semantics as ``ops.mmd_test.mmd_permutation_test_sweep``;
    the per-alpha Grams never materialize. ``precision='float64'`` reduces
    the final quadratic forms in float64 on the host (required for valid
    p-values near the null; the results are then CPU float64 tensors).
    ``permutations``: an optional pre-drawn (P, m) 0/1 matrix whose rows sum
    to n1, in place of the ``generator`` draw. ``device`` as in
    ``mmd_permutation_test_sweep``. ``mesh``: a mesh whose 'data' ranks
    split the indicator rows (every rank draws the same permutations from
    its own equally seeded ``generator``); the results are replicated.
    """
    stats = _tiled_stats(x, y, alphas, generator, n_permutations, precision,
                         permutations, mesh, device)
    observed = stats[:, 0]
    pvals = torch.mean((stats[:, 1:] >= observed[:, None]).to(stats.dtype), dim=1)
    return observed, pvals


def mmd_permutation_test_tiled(
    x,
    y,
    alphas,
    generator: Optional[torch.Generator] = None,
    n_permutations: int = 1000,
    precision: str = "float32",
    permutations=None,
    mesh=None,
    device=None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Large-m counterpart of ``mmd_permutation_test``: one test on the
    summed-alpha kernel (C is linear in K, so the per-alpha statistics
    sum). Returns the scalar ``(statistic, p_value)``."""
    stats = _tiled_stats(x, y, alphas, generator, n_permutations, precision,
                         permutations, mesh, device).sum(dim=0)
    observed = stats[0]
    return observed, torch.mean((stats[1:] >= observed).to(stats.dtype))
