"""The plain version of the port's K6 / K7 kernels (``knn_scores_all_masks``
on CPU tensors) against ``vgan_tpu.ops.pallas.knn_score`` run in Pallas
interpret mode on the CPU, in both of the JAX package's regimes, and the
regime rule against the JAX package's.

On the CPU ``knn_scores_all_masks`` returns its plain version; the CUDA
kernels themselves are held to that plain version on the card by
chip_smoke.py.
"""

import numpy as np
import pytest
import torch

import vgan_tpu.ops.pallas.knn_score as JK
from vgan_tpu_torch.ops.cuda import knn_score as TK

# Gaussian data: the distance expansion an + bn - 2 cross cancels to about
# max(an + bn); two summation orders differ by a few ulp of that scale, so
# squared 'kth' scores are held to eps, this fraction of it. A 'mean' score
# averages the sqrt of the k smallest d2, each within eps (order statistics
# move no more than their inputs), and |sqrt(a) - sqrt(b)| <= min(sqrt(eps),
# eps / sqrt(b)) with b at least the nearest neighbour's d2 b1: so 'mean' is
# held to min(sqrt(eps), eps / sqrt(b1)) per score (b1 = 0 for a duplicated
# row).
D2_FRAC = 1e-5
# Integer-valued data: every d2 is exact in f32, so 'kth' is equal to the
# bit; 'mean' sums k square roots in another order.
MEAN_RTOL_EXACT = 1e-6


def _data(nt, ntr, d, nm, seed, integer=False):
    rng = np.random.default_rng(seed)
    if integer:  # small integers: heavy ties, exact distances
        xte = rng.integers(-2, 3, size=(nt, d)).astype(np.float32)
        xtr = rng.integers(-2, 3, size=(ntr, d)).astype(np.float32)
    else:
        xte = rng.normal(size=(nt, d)).astype(np.float32)
        xtr = rng.normal(size=(ntr, d)).astype(np.float32)
    n_dup = min(nt, ntr) // 4
    xte[:n_dup] = xtr[:n_dup]  # duplicated rows: zero distances
    masks = rng.random((nm, d)) < 0.5
    masks[~masks.any(axis=1), 0] = True
    masks[2] = False  # an all-zero mask: d2 == 0 everywhere, score 0
    return xte, xtr, masks


def _jax(xte, xtr, masks, k, mode, exclude_self):
    return np.asarray(JK.knn_scores_all_masks(xte, xtr, masks, k, interpret=True, mode=mode,
                                              exclude_self=exclude_self))


def _port(xte, xtr, masks, k, mode, exclude_self):
    TK.reset_launch_counts()
    got = TK.knn_scores_all_masks(torch.from_numpy(xte), torch.from_numpy(xtr), masks, k,
                                  mode=mode, exclude_self=exclude_self)
    assert TK.launch_counts() == {"knn_scores_resident": 0, "knn_scores_stream": 0}
    assert got.shape == (len(masks), len(xte)) and got.dtype == torch.float32
    return got.numpy()


def _kth_diagnosis(got, want, xte, xtr, masks, k, exclude_self, eps):
    """What a failing 'kth' comparison reports: the masks beyond eps, and a
    second call of the port's plain version on the same inputs (equal to the
    first, or to JAX's), with the host's torch threads and CPU capability. A
    second call that agrees with JAX marks a transient fault of the host."""
    def d2_err(s):
        return np.abs(s.astype(np.float64) ** 2 - want.astype(np.float64) ** 2)

    again = TK.knn_scores_all_masks_reference(
        torch.from_numpy(xte), torch.from_numpy(xtr), torch.from_numpy(masks.astype(np.float32)),
        k, "kth", exclude_self).numpy()
    return dict(err=float(d2_err(got).max()), eps=eps,
                masks_beyond=np.nonzero((d2_err(got) > eps).any(axis=1))[0].tolist(),
                second_call_equals_first=bool(np.array_equal(again, got)),
                second_call_err=float(d2_err(again).max()), threads=torch.get_num_threads(),
                cpu=torch.backends.cpu.get_cpu_capability())


def _assert_close(got, want, xte, xtr, masks, k, mode, exclude_self):
    m = masks.astype(np.float64)
    scale = float(((xte.astype(np.float64) ** 2) @ m.T).max()
                  + ((xtr.astype(np.float64) ** 2) @ m.T).max())
    eps = D2_FRAC * scale
    if mode == "kth":
        err = np.abs(got.astype(np.float64) ** 2 - want.astype(np.float64) ** 2).max()
        assert err <= eps, _kth_diagnosis(got, want, xte, xtr, masks, k, exclude_self, eps)
    else:
        s1 = TK.knn_scores_all_masks_reference(torch.from_numpy(xte), torch.from_numpy(xtr),
                                               torch.from_numpy(masks.astype(np.float32)), 1,
                                               "kth", exclude_self).numpy().astype(np.float64)
        with np.errstate(divide="ignore"):
            lim = np.minimum(np.sqrt(eps), eps / s1)
        assert np.all(np.abs(got.astype(np.float64) - want) <= lim), (eps, scale)
    np.testing.assert_array_equal(got[2], 0.0)


@pytest.mark.parametrize("mode", ["kth", "mean"])
@pytest.mark.parametrize("exclude_self", [False, True])
def test_plain_vs_pallas_resident(mode, exclude_self):
    """Ragged shapes: nt not a multiple of 256, ntr not of 128, n_masks not
    of 8; an all-zero mask."""
    xte, xtr, masks = _data(300, 260, 20, 11, seed=0)
    assert JK._resident_supported(260, 20) and TK._resident_supported(260, 20)
    got = _port(xte, xtr, masks, 5, mode, exclude_self)
    want = _jax(xte, xtr, masks, 5, mode, exclude_self)
    _assert_close(got, want, xte, xtr, masks, 5, mode, exclude_self)


@pytest.mark.parametrize("mode", ["kth", "mean"])
def test_plain_vs_pallas_integer_ties(mode):
    xte, xtr, masks = _data(130, 200, 7, 9, seed=1, integer=True)
    got = _port(xte, xtr, masks, 9, mode, True)
    want = _jax(xte, xtr, masks, 9, mode, True)
    if mode == "kth":
        np.testing.assert_array_equal(got, want)
    else:
        np.testing.assert_allclose(got, want, rtol=MEAN_RTOL_EXACT)


@pytest.fixture
def streaming_regime(monkeypatch):
    """Lower ``MAX_NTR_D`` on both sides so 300 train rows stream in two
    256-row blocks, clear the JAX program cache (``MAX_NTR_D`` is read when
    ``_knn_scores_call`` traces, so a cached resident program would come
    back), and count the JAX streaming kernel's calls."""
    monkeypatch.setattr(JK, "MAX_NTR_D", 128 * 128 * 2)
    monkeypatch.setattr(TK, "MAX_NTR_D", 128 * 128 * 2)
    JK._knn_scores_call.clear_cache()
    calls = []
    stream_call = JK._knn_stream_call

    def counted(*args, **kwargs):
        calls.append(1)
        return stream_call(*args, **kwargs)

    monkeypatch.setattr(JK, "_knn_stream_call", counted)
    yield calls
    JK._knn_scores_call.clear_cache()


def _stream_data(integer, seed):
    xte, xtr, masks = _data(40, 300, 6, 5, seed=seed, integer=integer)
    xtr[256:286] = xtr[226:256]  # duplicates on both sides of the block boundary
    return xte, xtr, masks


@pytest.mark.parametrize("mode", ["kth", "mean"])
@pytest.mark.parametrize("exclude_self", [False, True])
def test_plain_vs_pallas_streaming(streaming_regime, mode, exclude_self):
    xte, xtr, masks = _stream_data(False, seed=2)
    assert not JK._resident_supported(300, 6) and not TK._resident_supported(300, 6)
    assert JK._stream_trb(128) == TK._stream_trb(128) == 256
    got = _port(xte, xtr, masks, 5, mode, exclude_self)
    want = _jax(xte, xtr, masks, 5, mode, exclude_self)
    assert streaming_regime, "the JAX side did not run its streaming kernel"
    _assert_close(got, want, xte, xtr, masks, 5, mode, exclude_self)


@pytest.mark.parametrize("mode", ["kth", "mean"])
def test_plain_vs_pallas_streaming_integer_ties(streaming_regime, mode):
    xte, xtr, masks = _stream_data(True, seed=3)
    got = _port(xte, xtr, masks, 12, mode, False)
    want = _jax(xte, xtr, masks, 12, mode, False)
    assert streaming_regime, "the JAX side did not run its streaming kernel"
    if mode == "kth":
        np.testing.assert_array_equal(got, want)
    else:
        np.testing.assert_allclose(got, want, rtol=MEAN_RTOL_EXACT)


GRID = [
    (500, 2000, 10240, 10),   # the stress ensemble: streaming
    (2500, 2000, 10240, 10),  # its predict batch
    (500, 1000, 100, 10),     # the bench ensemble: resident
    (500, 1000, 100, 64),
    (500, 1000, 100, 65),     # k past MAX_K
    (10, 5, 3, 6),            # k past n_train
    (100, 8192, 128, 10), (100, 8193, 128, 10), (100, 8192, 129, 10),
    (100, 128, 8192, 10), (100, 129, 8192, 10),
    (100, 50000, 300, 10), (100, 3000, 15000, 10), (100, 3000, 16000, 10),
    (100, 3000, 30000, 10),
]


@pytest.mark.parametrize("max_ntr_d", [None, 128 * 128 * 2])
def test_regime_rule_matches_jax(monkeypatch, max_ntr_d):
    if max_ntr_d is not None:
        monkeypatch.setattr(JK, "MAX_NTR_D", max_ntr_d)
        monkeypatch.setattr(TK, "MAX_NTR_D", max_ntr_d)
    for nt, ntr, d, k in GRID:
        assert TK._resident_supported(ntr, d) == JK._resident_supported(ntr, d), (ntr, d)
        assert TK._stream_trb(d) == JK._stream_trb(d), d
        assert TK._stream_fits(d) == JK._stream_fits(d), d
        assert TK.knn_kernel_supported(nt, ntr, d, k) == JK.knn_kernel_supported(nt, ntr, d, k)
    assert TK.knn_kernel_supported(500, 2000, 10240, 10)
    assert not TK._resident_supported(2000, 10240)
    assert TK._resident_supported(1000, 100) == (max_ntr_d is None)
    assert not TK.knn_kernel_supported(500, 1000, 100, 65)


def test_rejects_unsupported_calls():
    x = torch.zeros((6, 3))
    masks = np.ones((2, 3), bool)
    for k, kw in ((65, {}), (7, {}), (6, {"exclude_self": True}), (0, {}),
                  (2, {"mode": "median"})):
        with pytest.raises(ValueError):
            TK.knn_scores_all_masks(x, x, masks, k, **kw)


def _mask_rows(kind: str, d: int) -> np.ndarray:
    rng = np.random.default_rng(7)
    if kind == "all-zero":
        return np.zeros((3, d), bool)
    if kind == "full":
        return np.ones((3, d), bool)
    if kind == "single":
        return np.eye(d, dtype=bool)[[0, 17, d - 1]]
    return rng.random((9, d)) < rng.random((9, 1))  # ragged: counts from 0 to d


@pytest.mark.parametrize("kind", ["all-zero", "full", "single", "ragged"])
def test_selected_columns_match_nonzero(kind):
    """The kernel's column lists: each mask's selected columns first, in
    ascending order, with their count; the rest of the row is the other
    columns (a permutation), which the kernel never reads."""
    d = 37
    masks = _mask_rows(kind, d)
    cols, counts = TK.selected_columns(torch.from_numpy(masks.astype(np.float32)))
    assert cols.dtype == counts.dtype == torch.int32
    assert cols.shape == masks.shape and counts.shape == (len(masks),) and cols.is_contiguous()
    for row, c, n in zip(masks, cols.numpy(), counts.numpy()):
        sel = np.nonzero(row)[0]
        assert n == len(sel)
        np.testing.assert_array_equal(c[:n], sel)
        np.testing.assert_array_equal(np.sort(c), np.arange(d))


def test_kernel_operands_plain_layout():
    """The kernels' operands on the CPU (the plain version of their launch):
    the rows column-major, zero-padded to whole 128-row tiles, and each
    mask's selected columns first with their counts."""
    rng = np.random.default_rng(5)
    xte = torch.from_numpy(rng.normal(size=(130, 9)).astype(np.float32))
    xtr = torch.from_numpy(rng.normal(size=(40, 9)).astype(np.float32))
    masks = torch.from_numpy(_mask_rows("ragged", 9).astype(np.float32))
    xte_t, xtr_t, cols, counts = TK.kernel_operands(xte, xtr, masks)
    assert xte_t.shape == (9, 256) and xtr_t.shape == (9, 128)
    assert torch.equal(xte_t[:, :130], xte.T) and not torch.any(xte_t[:, 130:])
    assert torch.equal(xtr_t[:, :40], xtr.T) and not torch.any(xtr_t[:, 40:])
    want_cols, want_counts = TK.selected_columns(masks)
    assert torch.equal(cols, want_cols) and torch.equal(counts, want_counts)


@pytest.mark.parametrize("mode", ["kth", "mean"])
@pytest.mark.parametrize("exclude_self", [False, True])
def test_plain_scores_on_gathered_columns(mode, exclude_self):
    """The premise of the kernel's compaction: scoring a mask's gathered
    columns with an all-ones mask gives the masked scores (float64), for
    ragged, single-column, full and all-zero masks."""
    rng = np.random.default_rng(9)
    d = 23
    xte = torch.from_numpy(rng.normal(size=(60, d)))
    xtr = torch.from_numpy(rng.normal(size=(50, d)))
    masks = np.concatenate([_mask_rows("ragged", d), _mask_rows("single", d)[:1],
                            _mask_rows("full", d)[:1], _mask_rows("all-zero", d)[:1]])
    mt = torch.from_numpy(masks.astype(np.float64))
    want = TK.knn_scores_all_masks_reference(xte, xtr, mt, 4, mode, exclude_self)
    cols, counts = TK.selected_columns(mt)
    for i in range(len(masks)):
        sel = cols[i, :counts[i]].long()
        got = TK.knn_scores_all_masks_reference(
            xte[:, sel], xtr[:, sel], torch.ones((1, len(sel)), dtype=torch.float64), 4, mode,
            exclude_self)
        np.testing.assert_allclose(got[0].numpy(), want[i].numpy(), rtol=1e-12)
    np.testing.assert_array_equal(want[-1].numpy(), 0.0)


# ---------------------------------------------------------------------------
# K6's selection (csrc/knn_score.cu knn_resident_kernel), modelled on the CPU
# ---------------------------------------------------------------------------

_T = TK.KERNEL_TILE  # test rows of a block, train rows of a tile
_BIG = np.float32(3.0e38)


def _tile_index(q: np.ndarray, lane: np.ndarray) -> np.ndarray:
    """dist_tile's tile_row / tile_col: the q-th row (column) of lane ty (tx)."""
    return (q // 4) * 64 + lane * 4 + q % 4


def _csrc_constant(name: str) -> int:
    import re

    from vgan_tpu_torch.ops.cuda import _build

    src = (_build.CSRC / "knn_score.cu").read_text()
    return int(re.search(rf"constexpr int {name} = (\d+);", src).group(1))


def _model_resident_selection(d2_tiles, k: int, cap: int) -> np.ndarray:
    """The kernel's selection for one block, tile by tile: each thread
    (tx, ty) holds rows tile_row(r, ty) x columns tile_col(c, tx) of a tile's
    distances; candidates below the row's threshold (the k-th entry of both
    of its lists; for k <= 16, while a list of the warp's rows is not full,
    also just above the k-th smallest of the row's 16 lanes' minima on the
    tile) go in rounds of at most ``cap`` per (half, row), in lane and then
    column order, into list h (lanes 8 h .. 8 h + 7) of the row, each while
    it is below that list's k-th entry. Returns the two lists merged."""
    q = np.arange(8)
    lists = np.full((2, _T, k), _BIG, dtype=np.float32)
    cols = _tile_index(q[None, :], np.arange(16)[:, None])  # (tx, c)
    for d2 in d2_tiles:
        lane_vals = d2[:, cols]  # (row, tx, c): the 8 values of each lane
        thr = np.minimum(lists[0, :, k - 1], lists[1, :, k - 1])
        if k <= 16:
            lmin = lane_vals.min(axis=2)
            order = np.lexsort((np.arange(16)[None, :].repeat(_T, 0), lmin), axis=1)
            u = np.nextafter(np.take_along_axis(lmin, order[:, k - 1:k], axis=1)[:, 0],
                             np.float32(np.inf))
            for r in range(8):  # a warp's two rows (ty = 2w, 2w + 1) of its r-th row
                for w in range(8):
                    rows = _tile_index(np.array([r, r]), np.array([2 * w, 2 * w + 1]))
                    if (thr[rows] >= _BIG).any():
                        thr[rows] = np.minimum(thr[rows], u[rows])
        pend = (lane_vals < thr[:, None, None]) & (lane_vals < _BIG)
        while pend.any():
            for h in range(2):
                lanes = slice(8 * h, 8 * h + 8)
                for row in range(_T):
                    idx = np.argwhere(pend[row, lanes])[:cap]  # lane order, then c
                    for lane, c in idx:
                        pend[row, 8 * h + lane, c] = False
                        v = lane_vals[row, 8 * h + lane, c]
                        if v < lists[h, row, k - 1]:
                            lists[h, row] = np.sort(np.append(lists[h, row, :k - 1], v))
            thr = np.minimum(thr, np.minimum(lists[0, :, k - 1], lists[1, :, k - 1]))
            pend &= lane_vals < thr[:, None, None]
    return np.sort(np.concatenate([lists[0], lists[1]], axis=1), axis=1)[:, :k]


@pytest.mark.parametrize("k", [1, 5, 10, 16, 17, 64])
@pytest.mark.parametrize("integer", [False, True])
def test_resident_selection_model_keeps_the_k_smallest(k, integer):
    """The register filter, the lane-minimum threshold, the capped rounds and the two lists keep each row's k smallest distances as
    a multiset, ties included (small-integer rows), with exclude_self's
    positional pair and a ragged last train tile masked to +3e38."""
    rng = np.random.default_rng(k)
    ntr = 300  # three tiles, the last one 44 rows
    if integer:
        d2 = rng.integers(0, 6, size=(_T, ntr)).astype(np.float32)
    else:
        d2 = rng.random((_T, ntr), dtype=np.float32)
    d2[np.arange(_T), np.arange(_T)] = _BIG  # exclude_self
    tiles = []
    for j0 in range(0, ntr, _T):
        tile = np.full((_T, _T), _BIG, dtype=np.float32)
        tile[:, :min(_T, ntr - j0)] = d2[:, j0:j0 + _T]
        tiles.append(tile)
    got = _model_resident_selection(tiles, k, _csrc_constant("CAP"))
    want = np.sort(d2, axis=1)[:, :k]
    np.testing.assert_array_equal(got, want)


def test_resident_kernel_shared_memory_budget():
    """K6's shared memory (the product pipeline, the norms, the candidate
    buffers and counts, two k-lists per row): within a block's 227 KB for
    every k up to MAX_K, two blocks an SM at the bench ensemble's k = 10,
    and below the d2-tile kernel's (K7's) at every k."""
    cap, tile = _csrc_constant("CAP"), TK.KERNEL_TILE
    pipeline = 2 * 16 * (tile + tile)

    def resident(k):
        return 4 * (pipeline + 2 * tile + 2 * cap * tile + 2 * tile + 2 * k * tile)

    def d2_tile(k):
        return 4 * (pipeline + tile * (tile + 1) + 2 * tile + 2 * k * tile)

    for k in range(1, TK.MAX_K + 1):
        assert resident(k) <= 232448 and resident(k) < d2_tile(k), k
    assert 2 * (resident(10) + 1024) <= 233472  # the SM's 228 KB, 1 KB reserved a block
