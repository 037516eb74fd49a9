"""Fused masked-distance and k-nearest-neighbour scores over many subspace
masks, through the K6 and K7 kernels (counterpart of
``vgan_tpu.ops.pallas.knn_score``).

For each mask m, test row i and train row j the masked squared distance is
the expansion ``max((an + bn) - 2 (xte .* m) @ xtr^T, 0)``; the score of
(m, i) is the k-th smallest distance of the row ('kth', pyod KNN 'largest')
or the mean of the k smallest ('mean'), exact under ties. The (nt, ntr)
distances never reach device memory (``csrc/knn_score.cu``). The kernels
walk only each mask's selected columns: the wrapper hands them the column
lists (:func:`selected_columns`) and column-major copies of the rows.
Both filter each train tile's distances in registers and buffer only the
candidates below each row's k-th value, and keep one double-buffered feed
running across the train tiles; K7 (many selected columns) copies 32
columns a chunk where two blocks an SM fit them (k <= 39) and skips the
empty half of a last train tile of at most 64 rows.

Which shapes the kernels take is the H100's own rule
(:func:`knn_kernel_supported`): the kernels' shared memory does not depend
on d, so every shape whose launch arguments the C entries accept is scored
on the card, at any width; the rest (k above ``MAX_K`` or above the train
rows) take the caller's generic path. K6 runs where the padded train block
is within ``RESIDENT_MAX_NTR_D`` elements (:func:`_resident_supported`), K7
past it.

:func:`knn_scores_all_masks` given CPU tensors returns its plain version
(:func:`knn_scores_all_masks_reference`); given CUDA tensors it launches a
kernel or raises.
"""

from __future__ import annotations

import ctypes

import torch

from vgan_tpu_torch.ops.cuda import _build
from vgan_tpu_torch.ops.cuda._build import cdiv, check, column_major, launch, round_up

MAX_K = 64  # csrc/knn_score.cu MAX_K: the k-lists a test row keeps in shared memory
# The kernels' test and train tiles (BT = BR in csrc/knn_score.cu): the
# column-major copies are padded to whole tiles.
KERNEL_TILE = 128
# The grid's y extent, cdiv(nt, KERNEL_TILE) (csrc/knn_score.cu launch_knn).
MAX_TEST_TILES = 65535
# The C entries take every count and leading dimension as an int.
INT_MAX = 2**31 - 1
_PREP_TILE = 32  # knn_prep_kernel's transpose tile (dist_tile::TT)
_PREP_MASKS = 8  # masks a knn_prep_kernel block lists
# K6 where the padded train block, rows x columns, is within this many
# elements, K7 past it: the JAX package's VMEM rule. Timed on an H100
# (PERF.md, K6 against K7), K7 scores 6-23% faster than K6 at every shape
# from d = 1024 to 30000 and 801 to 8192 train rows, to the same bits, at
# nt = 500, k = 10 and without exclude_self; K7 is not yet timed at the
# bench ensemble's d = 100, at k up to MAX_K, at large nt or with
# exclude_self, so the crossover stays until it is (ROADMAP Queue 4 item 3).
RESIDENT_MAX_NTR_D = 1024 * 1024
# The plain version scores this many masks at a time at most, so that its
# (masks, nt, d) masked rows and (masks, nt, ntr) distances stay within this
# many elements.
REFERENCE_CHUNK_ELEMS = 1 << 27
_BIG = 3.0e38
_MODES = ("kth", "mean")


def _resident_supported(ntr: int, d: int) -> bool:
    """Does K6 (``knn_resident_kernel``) score these shapes rather than K7?
    Where the padded (ntr, d) train block is within
    ``RESIDENT_MAX_NTR_D`` elements."""
    block = round_up(ntr, KERNEL_TILE) * max(KERNEL_TILE, round_up(d, KERNEL_TILE))
    return block <= RESIDENT_MAX_NTR_D


def knn_kernel_supported(nt: int, ntr: int, d: int, k: int, nm: int) -> bool:
    """Can the kernels score ``nm`` masks over these shapes? The limits
    that ``csrc/knn_score.cu``'s entries check, whose shared memory does not
    depend on d (``stream_smem_floats``, ``resident_smem_floats``):

    - ``1 <= k <= MAX_K`` and ``k <= ntr`` (``launch_knn``);
    - ``cdiv(nt, 128) <= 65535``, the grid's y extent (``launch_knn``);
    - every count and leading dimension that an entry takes as an ``int``
      within range: nt and ntr padded to whole tiles, d, nm, and
      ``vgan_knn_prep``'s block count; ``cdiv`` forms ``d + 31`` in an int.
      Column x leading dimension, mask x row length and mask x nt offsets
      are formed in ``size_t`` and bound nothing.
    """
    ld_te, ld_tr = round_up(nt, KERNEL_TILE), round_up(ntr, KERNEL_TILE)
    prep_blocks = ((ld_te + ld_tr) // _PREP_TILE * cdiv(d, _PREP_TILE)
                   + cdiv(nm, _PREP_MASKS))
    return (1 <= k <= MAX_K and k <= ntr and ld_te // KERNEL_TILE <= MAX_TEST_TILES
            and max(ld_te, ld_tr, d + _PREP_TILE - 1, nm, prep_blocks) <= INT_MAX)


# ---------------------------------------------------------------------------
# plain version
# ---------------------------------------------------------------------------


def knn_scores_all_masks_reference(x_test, x_train, masks, k: int, mode: str = "kth",
                                   exclude_self: bool = False) -> torch.Tensor:
    """(n_masks, nt) scores from materialized distances, a chunk of masks at
    a time: d2 by the kernels' expansion, the positional diagonal set to
    +3e38 under ``exclude_self``, then ``torch.topk`` of the k smallest."""
    nt, d = x_test.shape
    ntr = x_train.shape[0]
    nm = masks.shape[0]
    xte2, xtr2 = x_test * x_test, x_train * x_train
    chunk = max(1, REFERENCE_CHUNK_ELEMS // (nt * (ntr + d)))
    out = torch.empty((nm, nt), dtype=x_test.dtype, device=x_test.device)
    diag = torch.arange(min(nt, ntr), device=x_test.device)
    for s in range(0, nm, chunk):
        mk = masks[s:s + chunk]
        an = (xte2 @ mk.T).T
        bn = (xtr2 @ mk.T).T
        cross = (x_test[None] * mk[:, None, :]) @ x_train.T
        d2 = torch.clamp_min(an[:, :, None] + bn[:, None, :] - 2.0 * cross, 0.0)
        if exclude_self:
            d2[:, diag, diag] = _BIG
        vals = torch.topk(d2, k, dim=2, largest=False, sorted=True).values
        out[s:s + chunk] = (torch.sqrt(vals[..., k - 1]) if mode == "kth"
                            else torch.mean(torch.sqrt(vals), dim=2))
    return out


# ---------------------------------------------------------------------------
# kernel wrappers
# ---------------------------------------------------------------------------


def selected_columns(masks: torch.Tensor):
    """``(cols, counts)``: int32 (n_masks, d) with each mask's selected
    columns first, in ascending order (the rest follow and are never read),
    and int32 (n_masks,) their counts. Built on the masks' device."""
    selected = masks != 0
    # a stable sort of the 0 (selected) / 1 keys keeps each group ascending
    order = torch.sort((~selected).to(torch.int32), dim=1, stable=True).indices
    return order.to(torch.int32).contiguous(), selected.sum(dim=1, dtype=torch.int32)


_P, _I = ctypes.c_void_p, ctypes.c_int
_SIGNATURES = {
    name: [_P, _I, _P, _I, _P, _P, _I, _I, _I, _I, _I, _I, _I, _P, _P]
    for name in ("vgan_knn_resident", "vgan_knn_stream")
}
_SIGNATURES["vgan_knn_prep"] = [_P, _I, _I, _P, _I, _I, _P, _I, _I, _P, _P, _P, _P, _P]


def _lib():
    return _build.bound("knn_score", _SIGNATURES)


def kernel_operands(x_test, x_train, masks):
    """``(xte_t, xtr_t, cols, counts)``: the kernels' operands, the rows'
    column-major copies zero-padded to whole tiles and each mask's selected
    columns first, ascending, with their counts. On the card one launch
    (``knn_prep_kernel``), whose ``cols`` holds only the selected columns
    of each row (the rest is never read); on the CPU its plain version
    (:func:`selected_columns`, ``column_major``)."""
    if not x_test.is_cuda:
        return (column_major(x_test, KERNEL_TILE), column_major(x_train, KERNEL_TILE),
                *selected_columns(masks))
    nt, d = x_test.shape
    ntr, nm = x_train.shape[0], masks.shape[0]
    dev = x_test.device
    check("x_test", x_test, (nt, d), dev)
    check("x_train", x_train, (ntr, d), dev)
    check("masks", masks, (nm, d), dev)
    ld_te, ld_tr = round_up(nt, KERNEL_TILE), round_up(ntr, KERNEL_TILE)
    buf = torch.empty(d * (ld_te + ld_tr) + nm * (d + 1), dtype=torch.float32, device=dev)
    xte_t = buf[:d * ld_te].view(d, ld_te)
    xtr_t = buf[d * ld_te:d * (ld_te + ld_tr)].view(d, ld_tr)
    ints = buf[d * (ld_te + ld_tr):].view(torch.int32)
    cols, counts = ints[:nm * d].view(nm, d), ints[nm * d:]
    launch(_lib(), "vgan_knn_prep", dev, x_test.data_ptr(), nt, ld_te, x_train.data_ptr(), ntr,
           ld_tr, masks.data_ptr(), nm, d, xte_t.data_ptr(), xtr_t.data_ptr(), cols.data_ptr(),
           counts.data_ptr())
    return xte_t, xtr_t, cols, counts


def _launch_scores(entry, x_test, x_train, masks, k, mode, exclude_self) -> torch.Tensor:
    """Launch ``entry`` on the operands of :func:`kernel_operands`."""
    nt, d = x_test.shape
    ntr, nm = x_train.shape[0], masks.shape[0]
    dev = x_test.device
    xte_t, xtr_t, cols, counts = kernel_operands(x_test, x_train, masks)
    out = torch.empty((nm, nt), dtype=torch.float32, device=dev)
    launch(_lib(), entry, dev, xte_t.data_ptr(), xte_t.shape[1], xtr_t.data_ptr(),
           xtr_t.shape[1], cols.data_ptr(), counts.data_ptr(), nm, nt, ntr, d, int(k),
           int(mode == "mean"), int(bool(exclude_self)), out.data_ptr())
    return out


def knn_scores_resident(x_test, x_train, masks, k: int, mode: str = "kth",
                        exclude_self: bool = False) -> torch.Tensor:
    """K6: one mask x 128 test rows per block, the selection filtered in
    registers (small train blocks, :func:`_resident_supported`)."""
    out = _launch_scores("vgan_knn_resident", x_test, x_train, masks, k, mode, exclude_self)
    _build.count("knn_scores_resident")
    return out


def knn_scores_stream(x_test, x_train, masks, k: int, mode: str = "kth",
                      exclude_self: bool = False) -> torch.Tensor:
    """K7: one mask x 128 test rows per block, wide chunks across the train
    tiles, the selection in registers (past :func:`_resident_supported`)."""
    out = _launch_scores("vgan_knn_stream", x_test, x_train, masks, k, mode, exclude_self)
    _build.count("knn_scores_stream")
    return out


_COUNTED = ("knn_scores_resident", "knn_scores_stream", "knn_generic")


def count_generic() -> None:
    """Counts one mask shard of a ``knn`` / ``knn_mean`` ensemble scored on
    the generic route (``ensemble/od.py``), where no kernel runs."""
    _build.count("knn_generic")


def reset_launch_counts() -> None:
    _build.reset(_COUNTED)


def launch_counts() -> dict:
    """K6's and K7's launches and the generic route's mask shards
    (``knn_generic``)."""
    return _build.counts(_COUNTED)


def knn_scores_all_masks(x_test: torch.Tensor, x_train: torch.Tensor, masks, k: int,
                         mode: str = "kth", exclude_self: bool = False) -> torch.Tensor:
    """(n_masks, nt) float32 KNN scores for every mask.

    ``mode='kth'``: the k-th nearest-neighbour distance (pyod KNN 'largest');
    ``mode='mean'``: the mean distance to the k nearest (pyod KNN 'mean').
    ``exclude_self`` drops the positional (i, i) pair: use it when the
    leading test rows ARE the train rows (``predict``'s combined batch).
    ``masks`` (n_masks, d) is 0/1, a tensor or an array. Raises
    ``ValueError`` for an unknown mode, for shapes outside
    :func:`knn_kernel_supported` (k above ``MAX_K`` or above n_train), and
    for ``exclude_self`` with k >= n_train.
    """
    if mode not in _MODES:
        raise ValueError(f"unknown mode={mode!r}: expected 'kth' or 'mean'")
    nt, d = x_test.shape
    ntr = x_train.shape[0]
    k = int(k)
    if not knn_kernel_supported(nt, ntr, d, k, len(masks)):
        raise ValueError(
            f"k={k} with {nt} test and {ntr} train rows of width {d}: the kernels take "
            f"1 <= k <= min({MAX_K}, n_train) and shapes within their launch limits"
        )
    if exclude_self and k >= ntr:
        raise ValueError("exclude_self requires k < n_train (self-pairs are dropped)")
    dev = x_test.device
    x_test = x_test.to(torch.float32).contiguous()
    x_train = x_train.to(device=dev, dtype=torch.float32).contiguous()
    masks = torch.as_tensor(masks).to(device=dev, dtype=torch.float32).contiguous()
    if not x_test.is_cuda:
        return knn_scores_all_masks_reference(x_test, x_train, masks, k, mode, exclude_self)
    launch = knn_scores_resident if _resident_supported(ntr, d) else knn_scores_stream
    return launch(x_test, x_train, masks, k, mode, exclude_self)
