"""Fused masked-distance and k-nearest-neighbour scores over many subspace
masks, through the K6 and K7 kernels (counterpart of
``vgan_tpu.ops.pallas.knn_score``).

For each mask m, test row i and train row j the masked squared distance is
the expansion ``max((an + bn) - 2 (xte .* m) @ xtr^T, 0)``; the score of
(m, i) is the k-th smallest distance of the row ('kth', pyod KNN 'largest')
or the mean of the k smallest ('mean'), exact under ties. The (nt, ntr)
distances never reach device memory (``csrc/knn_score.cu``). The kernels
walk only each mask's selected columns: the wrapper hands them the column
lists (:func:`selected_columns`) and column-major copies of the rows. K6
(few selected columns) filters each train tile's distances in registers
and buffers only the candidates below each row's k-th value; K7 (many)
selects from a distance tile in shared memory.

Which kernel runs is the JAX package's regime rule on the same constants:
the resident kernel (K6, :func:`knn_scores_resident`) where
:func:`_resident_supported` holds, the streaming kernel (K7,
:func:`knn_scores_stream`) past it, and neither where
:func:`knn_kernel_supported` fails (the caller then takes the generic
path). The constants are module attributes, read at call time, so a test can
lower ``MAX_NTR_D`` here and in ``vgan_tpu`` alike.

:func:`knn_scores_all_masks` given CPU tensors returns its plain version
(:func:`knn_scores_all_masks_reference`); given CUDA tensors it launches a
kernel or raises.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from vgan_tpu_torch.ops.cuda.mmd_gram import _check, _column_major, _launch, _ptr

# The JAX package's tiling and VMEM constants (vgan_tpu/ops/pallas/
# knn_score.py), kept because they decide the regime; the CUDA kernel uses
# its own 128-row tiles (KERNEL_TILE).
TILE_NT = 256
MASK_G = 8
MAX_K = 64
MAX_NTR_D = 1024 * 1024
MAX_NTR = 8192
_KPAD = 128
# The plain version scores this many masks at a time at most, so that its
# (masks, nt, d) masked rows and (masks, nt, ntr) distances stay within this
# many elements.
REFERENCE_CHUNK_ELEMS = 1 << 27
_BIG = 3.0e38
_MODES = ("kth", "mean")
# The kernel's test and train tiles (BT = BR in csrc/knn_score.cu): the
# column-major copies are padded to whole tiles.
KERNEL_TILE = 128


def _round_up(a: int, b: int) -> int:
    return -(-a // b) * b


def _resident_supported(ntr: int, d: int) -> bool:
    """The JAX resident kernel's rule: the padded (NTR, D) train block
    within ``MAX_NTR`` rows and ``MAX_NTR_D`` elements."""
    NTR = _round_up(ntr, 128)
    D = max(128, _round_up(d, 128))
    return NTR <= MAX_NTR and NTR * D <= MAX_NTR_D


def knn_kernel_supported(nt: int, ntr: int, d: int, k: int) -> bool:
    """Can a kernel score these shapes? k within ``MAX_K`` and the train
    rows, and either regime's layout fits (the JAX package's rule)."""
    return k <= MAX_K and k <= ntr and (_resident_supported(ntr, d) or _stream_fits(d))


def _stream_trb(d: int) -> int:
    """Train rows per streamed block of the JAX streaming kernel."""
    D = max(128, _round_up(d, 128))
    return max(128, min(2048, (MAX_NTR_D // D) // 128 * 128))


def _stream_fits(d: int) -> bool:
    """The JAX streaming kernel's per-step VMEM residents within 48 MB."""
    D = max(128, _round_up(d, 128))
    trb = _stream_trb(D)
    elems = (
        (MASK_G + 2 * TILE_NT + 2 * trb) * D
        + MASK_G * TILE_NT * _KPAD
        + 3 * TILE_NT * (_KPAD + trb)
    )
    return elems * 4 <= 48 * 1024 * 1024


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


@functools.lru_cache(maxsize=None)
def _lib() -> ctypes.CDLL:
    from vgan_tpu_torch.ops.cuda import _build

    lib = _build.load("knn_score")
    for name, argtypes in _SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    return lib


def kernel_operands(x_test, x_train, masks):
    """``(xte_t, xtr_t, cols, counts)``: the kernels' operands, the rows'
    column-major copies zero-padded to whole tiles and each mask's selected
    columns first, ascending, with their counts. On the card one launch
    (``knn_prep_kernel``), whose ``cols`` holds only the selected columns
    of each row (the rest is never read); on the CPU its plain version
    (:func:`selected_columns`, ``_column_major``)."""
    if not x_test.is_cuda:
        return (_column_major(x_test, KERNEL_TILE), _column_major(x_train, KERNEL_TILE),
                *selected_columns(masks))
    nt, d = x_test.shape
    ntr, nm = x_train.shape[0], masks.shape[0]
    dev = x_test.device
    _check("x_test", x_test, (nt, d), dev)
    _check("x_train", x_train, (ntr, d), dev)
    _check("masks", masks, (nm, d), dev)
    ld_te, ld_tr = _round_up(nt, KERNEL_TILE), _round_up(ntr, KERNEL_TILE)
    buf = torch.empty(d * (ld_te + ld_tr) + nm * (d + 1), dtype=torch.float32, device=dev)
    xte_t = buf[:d * ld_te].view(d, ld_te)
    xtr_t = buf[d * ld_te:d * (ld_te + ld_tr)].view(d, ld_tr)
    ints = buf[d * (ld_te + ld_tr):].view(torch.int32)
    cols, counts = ints[:nm * d].view(nm, d), ints[nm * d:]
    _launch("vgan_knn_prep", dev, _ptr(x_test), nt, ld_te, _ptr(x_train), ntr, ld_tr,
            _ptr(masks), nm, d, _ptr(xte_t), _ptr(xtr_t), _ptr(cols), _ptr(counts), lib=_lib())
    return xte_t, xtr_t, cols, counts


def _launch_scores(fn_name, x_test, x_train, masks, k, mode, exclude_self,
                   lib=None) -> torch.Tensor:
    """Launch ``fn_name`` of ``lib`` (default: this module's library) on the
    operands of :func:`kernel_operands`."""
    nt, d = x_test.shape
    ntr, nm = x_train.shape[0], masks.shape[0]
    dev = x_test.device
    xte_t, xtr_t, cols, counts = kernel_operands(x_test, x_train, masks)
    out = torch.empty((nm, nt), dtype=torch.float32, device=dev)
    _launch(fn_name, dev, _ptr(xte_t), xte_t.shape[1], _ptr(xtr_t), xtr_t.shape[1], _ptr(cols),
            _ptr(counts), nm, nt, ntr, d, int(k), int(mode == "mean"), int(bool(exclude_self)),
            _ptr(out), lib=lib if lib is not None else _lib())
    return out


def knn_scores_resident(x_test, x_train, masks, k: int, mode: str = "kth",
                        exclude_self: bool = False) -> torch.Tensor:
    """K6: the JAX resident regime; one mask x 128 test rows per block,
    the selection filtered in registers."""
    out = _launch_scores("vgan_knn_resident", x_test, x_train, masks, k, mode, exclude_self)
    knn_scores_resident.launches += 1
    return out


def knn_scores_stream(x_test, x_train, masks, k: int, mode: str = "kth",
                      exclude_self: bool = False) -> torch.Tensor:
    """K7: the JAX streaming regime; one mask x 128 test rows per block,
    over the mask's selected columns."""
    out = _launch_scores("vgan_knn_stream", x_test, x_train, masks, k, mode, exclude_self)
    knn_scores_stream.launches += 1
    return out


KERNELS = (knn_scores_resident, knn_scores_stream)


def reset_launch_counts() -> None:
    for fn in KERNELS:
        fn.launches = 0


def launch_counts() -> dict:
    return {fn.__name__: fn.launches for fn in KERNELS}


reset_launch_counts()


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
    if k < 1 or not knn_kernel_supported(nt, ntr, d, k):
        raise ValueError(
            f"k={k} with {ntr} train rows of width {d}: the kernels take 1 <= k <= "
            f"min({MAX_K}, n_train) and a width whose streamed layout fits"
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
