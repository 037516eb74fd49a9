"""The plain versions of the port's MMD-Gram kernels, and its kernel autograd
Function, against ``vgan_tpu.ops.pallas.mmd_gram`` run in Pallas interpret
mode on the CPU, in float32 (the tolerances of test_pallas_gram.py).

On the CPU each kernel wrapper returns its plain version; the CUDA kernels
themselves are held to those plain versions on the card by chip_smoke.py.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import vgan_tpu.ops.pallas.mmd_gram as JG
from vgan_tpu.ops import mmd as JM
from vgan_tpu_torch.ops import mmd as TM
from vgan_tpu_torch.ops.cuda import mmd_gram as TG

RTOL, GRAD_RTOL = 2e-4, 2e-3
MULTS = JM.bandwidth_multipliers()


def _pair(n1, n2, d, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(n1, d)).astype(np.float32)
    y = (rng.normal(size=(n2, d)) * (rng.random(d) < 0.6) + 0.2).astype(np.float32)
    return x, y


def _both(n1, n2, d, seed=0):
    """JAX padded operands and the port's unpadded ones, from one draw."""
    x, y = _pair(n1, n2, d, seed)
    z_pad, norms_pad, _, _, m, tile_d = JG._pad_z(jnp.asarray(x), jnp.asarray(y))
    bw = float(JM.candidate_bandwidth(jnp.asarray(np.concatenate([x, y]))))
    z = torch.from_numpy(np.concatenate([x, y]))
    return dict(
        z_pad=z_pad, norms_pad=norms_pad, m=m, tile_d=tile_d,
        bw_j=jnp.asarray(bw, jnp.float32), z=z, norms=torch.sum(z * z, dim=1),
        bw_t=torch.tensor(bw, dtype=torch.float32), x=x, y=y,
    )


SHAPES = [(33, 17, 40), (20, 28, 600), (40, 30, 2100)]


@pytest.mark.parametrize("n1,n2,d", SHAPES)
def test_gram_quadrant_sums_plain_vs_pallas(n1, n2, d):
    a = _both(n1, n2, d)
    M = a["z_pad"].shape[0]
    want = JG._gram_quadrant_sums(
        a["z_pad"], a["norms_pad"], a["bw_j"], n1, a["m"], MULTS, a["tile_d"],
        tile_m=JG._fwd_tile(M, a["tile_d"], 4), interpret=True)
    got = TG.gram_quadrant_sums(a["z"], a["norms"], a["bw_t"], n1, MULTS)
    assert got.shape == (1, 4)
    np.testing.assert_allclose(got.numpy()[0, :3], np.asarray(want)[0, :3], rtol=RTOL)


@pytest.mark.parametrize("n1,n2,d", SHAPES)
def test_gram_quadrant_sums_stash_plain_vs_pallas(n1, n2, d):
    a = _both(n1, n2, d)
    M, m = a["z_pad"].shape[0], a["m"]
    sums_j, kp_j = JG._gram_quadrant_sums_stash(
        a["z_pad"], a["norms_pad"], a["bw_j"], n1, m, MULTS, a["tile_d"],
        tile_m=JG._fwd_tile(M, a["tile_d"], 4), interpret=True)
    sums_t, kp_t = TG.gram_quadrant_sums_stash(a["z"], a["norms"], a["bw_t"], n1, MULTS)
    np.testing.assert_allclose(sums_t.numpy()[0, :3], np.asarray(sums_j)[0, :3], rtol=RTOL)
    assert kp_t.shape == (m, m)
    np.testing.assert_allclose(kp_t.numpy(), np.asarray(kp_j)[:m, :m], rtol=RTOL, atol=1e-9)


@pytest.mark.parametrize("n1,n2,d", [(33, 17, 40), (20, 28, 600), (70, 61, 40)])
def test_gram_backward_flash_plain_vs_pallas(n1, n2, d):
    a = _both(n1, n2, d)
    m = a["m"]
    sz_j, rs_j = JG._gram_backward_flash(
        a["z_pad"], a["norms_pad"], a["bw_j"], n1, n2, m, MULTS, interpret=True)
    sz_t, rs_t = TG.gram_backward_flash(a["z"], a["norms"], a["bw_t"], n1, n2, MULTS)
    assert sz_t.shape == (m, d) and rs_t.shape == (m, 1)
    scale = float(np.max(np.abs(np.asarray(sz_j))))
    np.testing.assert_allclose(sz_t.numpy(), np.asarray(sz_j)[:m, :d], rtol=GRAD_RTOL,
                               atol=1e-5 * scale)
    np.testing.assert_allclose(rs_t.numpy(), np.asarray(rs_j)[:m], rtol=GRAD_RTOL,
                               atol=1e-5 * float(np.max(np.abs(np.asarray(rs_j)))))


def test_kprime_panel_plain_vs_pallas():
    """A row panel of the first 256 padded rows against all columns."""
    n1, n2, d = 150, 110, 2100  # M = 512, two row panels of 256
    a = _both(n1, n2, d)
    m = a["m"]
    want = JG._kprime_panel(
        a["z_pad"][:256], a["z_pad"], a["norms_pad"][:256], a["norms_pad"], a["bw_j"],
        MULTS, a["tile_d"], tile_m=256, interpret=True)
    got = TG.kprime_panel(a["z"][:256], a["z"], a["norms"][:256], a["norms"], a["bw_t"], MULTS)
    assert got.shape == (256, m)
    np.testing.assert_allclose(got.numpy(), np.asarray(want)[:, :m], rtol=RTOL, atol=1e-9)


def _core_value_and_grads_jax(x, y, bw):
    def f(a, b):
        return JG.mmd2_biased_pallas(a, b, bandwidth=bw)[0]

    v = f(jnp.asarray(x), jnp.asarray(y))
    gx, gy = jax.grad(f, argnums=(0, 1))(jnp.asarray(x), jnp.asarray(y))
    return float(v), np.asarray(gx), np.asarray(gy)


def _core_value_and_grads_torch(x, y, bw):
    xt = torch.from_numpy(x).requires_grad_()
    yt = torch.from_numpy(y).requires_grad_()
    v, _ = TG.mmd2_biased_cuda(xt, yt, bandwidth=bw)
    gx, gy = torch.autograd.grad(v, (xt, yt))
    return float(v.detach()), gx.numpy(), gy.numpy()


@pytest.mark.parametrize("regime,n1,n2,d", [
    ("flash", 33, 17, 40),
    ("flash", 20, 28, 600),
    ("stash", 40, 30, 2100),
    ("panel", 40, 30, 2100),
])
def test_mmd2_core_vs_pallas(monkeypatch, regime, n1, n2, d):
    if regime == "panel":
        monkeypatch.setattr(JG, "_KP_STASH_BYTES", 0)
        monkeypatch.setattr(TG, "_KP_STASH_BYTES", 0)
    assert TG.regime(n1 + n2, d) == regime
    x, y = _pair(n1, n2, d, seed=1)
    bw = float(d)
    vj, gxj, gyj = _core_value_and_grads_jax(x, y, jnp.asarray(bw, jnp.float32))
    TG.reset_launch_counts()
    vt, gxt, gyt = _core_value_and_grads_torch(x, y, bw)
    assert sum(TG.launch_counts().values()) == 0, "no kernel launches on CPU tensors"
    np.testing.assert_allclose(vt, vj, rtol=RTOL)
    np.testing.assert_allclose(gxt, gxj, rtol=GRAD_RTOL, atol=1e-7)
    np.testing.assert_allclose(gyt, gyj, rtol=GRAD_RTOL, atol=1e-7)


def test_panel_backward_several_panels(monkeypatch):
    """A panel budget small enough that the rank-1 backward streams three
    panels; the gradient still matches the dense torch autograd."""
    n1, n2, d = 100, 80, 2100
    monkeypatch.setattr(TG, "_KP_STASH_BYTES", 0)
    monkeypatch.setattr(TG, "PANEL_BYTES", 180 * 4 * 64)
    assert TG._panel_rows(180) == 64
    x, y = _pair(n1, n2, d, seed=2)
    bw = torch.tensor(float(d))
    yt = torch.from_numpy(y).requires_grad_()
    (g_core,) = torch.autograd.grad(TG.mmd2_cuda_core(torch.from_numpy(x), yt, bw, MULTS), yt)
    yd = torch.from_numpy(y).requires_grad_()
    (g_dense,) = torch.autograd.grad(TM.mmd2_biased(torch.from_numpy(x), yd, bandwidth=bw)[0], yd)
    np.testing.assert_allclose(g_core.numpy(), g_dense.numpy(), rtol=GRAD_RTOL, atol=1e-8)


def test_core_cotangent_dtype_and_no_bandwidth_grad():
    """float64 inputs are computed in float32 and their cotangents cast back."""
    x, y = _pair(12, 9, 30)
    xt = torch.from_numpy(x.astype(np.float64)).requires_grad_()
    bw = torch.tensor(30.0, requires_grad=True)
    v = TG.mmd2_cuda_core(xt, torch.from_numpy(y.astype(np.float64)), bw, MULTS)
    assert v.dtype == torch.float32
    gx, gbw = torch.autograd.grad(v, (xt, bw), allow_unused=True)
    assert gx.dtype == torch.float64 and gbw is None


@pytest.mark.parametrize("stash_bytes", [7 << 30, 0])
def test_regime_agrees_with_jax(monkeypatch, stash_bytes):
    monkeypatch.setattr(JG, "_KP_STASH_BYTES", stash_bytes)
    monkeypatch.setattr(TG, "_KP_STASH_BYTES", stash_bytes)
    for m in (10, 256, 257, 1000, 5000, 41000, 44000):
        for d in (10, 128, 511, 512, 513, 2048, 2049, 2560, 10240):
            M, D, _ = JG._pad_layout(m, d)
            if JG._stash_kprime(M, D):
                want = "stash"
            else:
                want = "flash" if D <= JG.FLASH_D_MAX else "panel"
            assert TG._pad_layout(m, d) == (M, D, JG._pad_layout(m, d)[2])
            assert TG.regime(m, d) == want, (m, d)


def test_cuda_supported_rule():
    big_d = torch.zeros(3, 512)
    assert not TG.cuda_supported(big_d, big_d), "CPU tensors never take the kernels"


def test_ladder_struct():
    lad = TG._ladder(MULTS)
    assert (lad.n, lad.use_pow, lad.base) == (5, 1, 4.0)
    assert list(lad.pw)[:5] == [16, 8, 4, 2, 1]
    odd = TG._ladder((0.3, 1.0, 2.7))
    assert odd.use_pow == 0 and abs(odd.mult[2] - 2.7) < 1e-6
    with pytest.raises(ValueError):
        TG._ladder(tuple(float(i + 1) for i in range(9)))


def _flash_blocks(m, d, sms):
    """A model of K3's blocks (csrc/mmd_gram.cu flash_tile_kernel, mode (a),
    and flash_product_kernel, mode (b)) in launch order: ``(I, s, chunks,
    Js)``, the row tile, the split, the 128-column chunks of ``[z | 1]`` the
    block writes and the column tiles it adds, in its order."""
    T = _cdiv(m, TG.STASH_TILE)
    mode, _, nsplit = TG.flash_schedule(m, d, sms)
    per = _cdiv(T, nsplit)
    chunks = TG.flash_chunks(d)
    blocks = []
    for s in range(nsplit):
        Js = list(range(s * per, min(T, (s + 1) * per)))
        for I in range(T):
            if mode == "a":
                blocks.append((I, s, list(range(chunks)), Js))
            else:
                blocks += [(I, s, [c], Js) for c in range(chunks)]
    return mode, nsplit, blocks


FLASH_SHAPES = [(1000, 640), (1000, 1024), (8192, 1024), (40, 600), (16384, 2048), (3000, 2048),
                (700, 100), (40960, 1024), (131, 40)]


@pytest.mark.parametrize("m,d", FLASH_SHAPES)
def test_flash_schedule_covers_the_square_and_fills_the_card(m, d):
    """K3's schedule: every (row tile, column tile, output chunk) is added
    by exactly one block, each block's column tiles in ascending order and
    its split's partial at a fixed slot (split 0 straight to the output,
    split s to partial s - 1, added in split order); the partials within
    FLASH_SPLIT_BYTES; mode (b)'s dot pass within one wave; and at m = 1000
    more blocks than SMs."""
    sms = 132
    mode, nsplit, blocks = _flash_blocks(m, d, sms)
    T, chunks = _cdiv(m, TG.STASH_TILE), TG.flash_chunks(d)
    seen = np.zeros((T, T, chunks), dtype=np.int32)
    slots = {}
    for I, s, cs, Js in blocks:
        assert Js == sorted(Js) and Js
        for c in cs:
            seen[I, Js, c] += 1
            assert slots.setdefault((I, c, s), s) == s
    assert np.all(seen == 1)
    M, D1 = T * TG.STASH_TILE, chunks * TG.STASH_TILE
    assert (nsplit - 1) * 4 * M * D1 <= TG.FLASH_SPLIT_BYTES
    mode_k1, slice_, count = TG.tile_schedule(TG.tile_pairs(m), d, sms)
    assert TG.flash_schedule(m, d, sms) == (mode, slice_, nsplit) and mode == mode_k1
    if mode == "b":
        assert count > 1 and TG.tile_pairs(m) * count <= TG.STASH_BLOCKS_PER_SM * sms
    if m == 1000:
        assert mode == "b" and sms < len(blocks) <= TG.STASH_BLOCKS_PER_SM * sms
    if (m, d) == (40960, 1024):
        assert (mode, nsplit) == ("a", 2)  # a third split's partial would pass the budget


@pytest.mark.parametrize("n1,n2,d", [(70, 61, 40), (150, 170, 300)])
def test_flash_split_model_reproduces_s_times_z(n1, n2, d):
    """K3's decomposition in float64: S in 128 x 128 tiles, each tile's
    S @ [z | 1] (the ones column giving rowsum(S)), the column tiles of a
    split added in order and the splits' sums added in split order give
    the plain version's S @ z and rowsum(S). S is symmetric (here to
    rounding; in the kernel to the bit), so mode (b) may form each tile
    pair once and read tile (J, I) as tile (I, J) transposed."""
    x, y = _pair(n1, n2, d, seed=4)
    z = torch.from_numpy(np.concatenate([x, y])).double()
    norms = torch.sum(z * z, dim=1)
    bw = torch.tensor(float(d), dtype=torch.float64)
    m, T = n1 + n2, _cdiv(n1 + n2, TG.STASH_TILE)
    want_sz, want_rs = TG.gram_backward_flash_reference(z, norms, bw, n1, n2, MULTS)
    cxx, cyy, cxy = TG._coefficients(n1, n2)
    coeff = torch.full((m, m), cxy, dtype=torch.float64)
    coeff[:n1, :n1], coeff[n1:, n1:] = cxx, cyy
    S = coeff * TG._kernel_deriv(TG._sq_dists(z, z, norms, norms), bw, MULTS)
    np.testing.assert_allclose(S.numpy(), S.T.numpy(), rtol=1e-12, atol=1e-20)
    z_aug = torch.cat([z, torch.ones((m, 1), dtype=torch.float64)], dim=1)
    for nsplit in range(1, T + 1):
        per = _cdiv(T, nsplit)
        if _cdiv(T, per) != nsplit:
            continue
        parts = []
        for s in range(nsplit):
            acc = torch.zeros((m, d + 1), dtype=torch.float64)
            for J in range(s * per, min(T, (s + 1) * per)):
                cols = slice(J * TG.STASH_TILE, (J + 1) * TG.STASH_TILE)
                acc += S[:, cols] @ z_aug[cols]
            parts.append(acc)
        out = parts[0]
        for part in parts[1:]:
            out = out + part
        np.testing.assert_allclose(out[:, :d].numpy(), want_sz.numpy(), rtol=1e-12, atol=1e-18)
        np.testing.assert_allclose(out[:, d:].numpy(), want_rs.numpy(), rtol=1e-12, atol=1e-18)


def test_stash_slices_cover_d_and_fill_the_card():
    """K2's d split: slices of a multiple of the 16-column chunk that cover d
    exactly (the last one ragged), and at the stress shape (m = 1000, 36
    tile pairs) tile pairs x slices fill the 132 SMs in one wave of at most
    two blocks an SM."""
    assert TG.stash_slices(1000, 10240, 132) == (1472, 7)
    for m, d in ((1000, 10240), (850, 2500), (233, 2100), (1000, 640), (40, 40), (5000, 10240)):
        slice_, count = TG.stash_slices(m, d, 132)
        assert slice_ % TG.STASH_BK == 0 and slice_ > 0
        assert (count - 1) * slice_ < d <= count * slice_, (m, d)
        tiles = -(-m // TG.STASH_TILE)
        pairs = tiles * (tiles + 1) // 2
        assert count == 1 or pairs * count <= TG.STASH_BLOCKS_PER_SM * 132, (m, d)
    pairs = 8 * 9 // 2
    _, count = TG.stash_slices(1000, 10240, 132)
    assert 132 <= pairs * count <= 2 * 132
    # ragged: m = 850 (7 tiles, 28 pairs), d = 2500 (157 chunks): 9 slices of 288
    assert TG.stash_slices(850, 2500, 132) == (288, 9)
    # narrow d: no more slices than 16-column chunks
    assert TG.stash_slices(40, 40, 132) == (16, 3)
    scratch = TG.stash_scratch_floats(1000, 10240, 1472)
    assert scratch == 10240 * 1024 + 7 * 36 * 128 * 128 + 12 * 36


def _cluster_slices(d, slices):
    """A model of cluster_gram_kernel's d split (csrc/mmd_gram.cu): CTA q of
    a cluster takes the 64-column chunks [q n / slices, (q + 1) n / slices)
    of the n = cdiv(d, 64), as column ranges clipped to d."""
    n = -(-d // TG.BF16_CHUNK)
    return [(q * n // slices * TG.BF16_CHUNK, min(d, (q + 1) * n // slices * TG.BF16_CHUNK))
            for q in range(slices)]


@pytest.mark.parametrize("m,d", [(1000, 10240), (1000, 640), (1000, 1024), (2113, 700),
                                 (850, 2500), (40, 40), (300, 100), (40960, 1024)])
def test_cluster_schedule_covers_d_within_a_wave(m, d):
    """K1 bf16's and K2 bf16's clusters: slices that start at multiples of
    the 64-column chunk and cover d exactly, none empty; at most
    CLUSTER_MAX a cluster; at most one wave of CTAs (one an SM) unless a
    cluster is a single CTA; as many slices as the wave allows; and the
    clusters of a wave fill it."""
    sms = 132
    pairs = TG.tile_pairs(m)
    slices, clusters = TG.cluster_schedule(pairs, d, sms)
    assert 1 <= slices <= TG.CLUSTER_MAX
    assert slices == 1 or slices * pairs <= sms
    assert slices == min(TG.CLUSTER_MAX, -(-d // TG.BF16_CHUNK)) or (slices + 1) * pairs > sms
    assert clusters == sms // slices and clusters * slices <= sms
    ranges = _cluster_slices(d, slices)
    assert ranges[0][0] == 0 and ranges[-1][1] == d
    for (a0, a1), (b0, _) in zip(ranges, ranges[1:]):
        assert a1 == b0
    assert all(k0 % TG.BF16_CHUNK == 0 and k1 > k0 for k0, k1 in ranges)


def test_cluster_schedule_at_the_fits_grams():
    """m = 1000 (36 tile pairs): three CTAs a pair on 108 of 132 SMs, 44
    clusters a wave; m = 2113 (153 pairs, past a wave): one CTA a pair."""
    assert TG.cluster_schedule(TG.tile_pairs(1000), 10240, 132) == (3, 44)
    assert TG.cluster_schedule(TG.tile_pairs(1000), 640, 132) == (3, 44)
    assert TG.cluster_schedule(TG.tile_pairs(2113), 700, 132) == (1, 132)
    # narrow d: no more slices than chunks
    assert TG.cluster_schedule(1, 100, 132) == (2, 66)
    assert _cluster_slices(10240, 3) == [(0, 3392), (3392, 6784), (6784, 10240)]


@pytest.mark.parametrize("m,d,slices", [(1000, 10240, 3), (1000, 640, 3), (2113, 700, 1),
                                        (333, 2500, 8)])
def test_bf16_forward_scratch_holds_no_partial_tile(m, d, slices):
    """K1 bf16's and K2 bf16's scratch: the row-major bf16 copy of z (d
    padded to a 16-byte row) and three sums a CTA, and nothing else: less
    than one 128 x 128 partial dot tile beyond the copy (the cluster adds
    its slices' tiles in shared memory)."""
    scratch = TG.bf16_forward_scratch_floats(m, d, slices)
    copy = m * (-(-d // 8) * 8) // 2
    assert scratch - copy == 3 * TG.tile_pairs(m) * slices
    assert scratch - copy < TG.STASH_TILE ** 2
    assert 2 * copy >= m * d  # every value of z, two to a float


def _cdiv(a, b):
    return -(-a // b)


def _panel_tiles(R, C, offset=None):
    """A model of K4's tiles of an (R, C) panel in block order, as
    ``Panel::at`` in ``csrc/mmd_gram.cu`` enumerates them: ``(r0, c0, c1,
    mirror)``, the panel rows [r0, r0 + 128) below R and columns [c0, c0 +
    128) below c1. With ``offset`` (the panel's row r is column offset + r):
    first the diagonal block's tile pairs J <= I, whose K' a pair J < I also
    writes mirrored to (c - offset, offset + r), then row tile by row tile
    the ordered tiles left and right of that block. Without, every tile is
    ordered. ``_panel_tiles(m, m, 0)`` is K1 and K2's tile pairs."""
    T = TG.STASH_TILE
    rows = _cdiv(R, T)
    if offset is None:
        return [(J * T, k * T, C, False) for J in range(rows) for k in range(_cdiv(C, T))]
    side = ([(k * T, offset) for k in range(_cdiv(offset, T))]
            + [(offset + R + k * T, C) for k in range(_cdiv(C - offset - R, T))])
    return ([(J * T, offset + I * T, offset + R, I != J) for J in range(rows) for I in range(J, rows)]
            + [(J * T, c0, c1, False) for J in range(rows) for c0, c1 in side])


def _tile_weighted_sums(k, n1):
    """[XX, XY, YY, 0] of the symmetric Gram k as K1 and K2 sum it: over the
    square panel's tiles (``_panel_tiles(m, m, 0)``), a mirrored tile pair
    counts its XX and YY entries twice and its XY entries (row < n1 <= col)
    once, a diagonal tile each entry once by the ordered masks."""
    m = k.shape[0]
    w = torch.zeros((3, m, m), dtype=k.dtype)
    rows = torch.arange(m)[:, None] < n1
    cols = torch.arange(m)[None, :] < n1
    for r0, c0, c1, mirror in _panel_tiles(m, m, 0):
        r, c = slice(r0, min(r0 + TG.STASH_TILE, m)), slice(c0, min(c0 + TG.STASH_TILE, c1))
        rx, cx = rows[r, :], cols[:, c]
        scale = 2.0 if mirror else 1.0
        w[0, r, c] = scale * (rx & cx)
        w[1, r, c] = (rx & ~cx).to(k.dtype)
        w[2, r, c] = scale * (~rx & ~cx)
    sums = torch.einsum("qij,ij->q", w, k)
    return torch.cat([sums, torch.zeros(1, dtype=k.dtype)]).reshape(1, 4)


@pytest.mark.parametrize("n1,n2,d", [(150, 83, 600), (100, 300, 40)])
def test_stash_pair_once_sums_float64_vs_pallas(n1, n2, d):
    """The pair-once quadrant sums, in float64: the stash plain version's
    (the diagonal once, the upper triangle doubled in XX and YY, XY once)
    against ``_fwd_stash_kernel`` in interpret mode at a ragged m (not a
    multiple of 128) with n1 != n2; and the tile-level weights K1 and K2
    apply over their tile pairs, which with it equal the full-Gram sums of
    K1's plain version."""
    a = _both(n1, n2, d)
    M, m = a["z_pad"].shape[0], a["m"]
    assert m % TG.STASH_TILE and n1 != n2
    sums_j, _ = JG._gram_quadrant_sums_stash(
        a["z_pad"], a["norms_pad"], a["bw_j"], n1, m, MULTS, a["tile_d"],
        tile_m=JG._fwd_tile(M, a["tile_d"], 4), interpret=True)
    z64 = a["z"].double()
    n64 = torch.sum(z64 * z64, dim=1)
    bw64 = a["bw_t"].double()
    sums_t, kp_t = TG.gram_quadrant_sums_stash(z64, n64, bw64, n1, MULTS)
    assert sums_t.dtype == torch.float64 and kp_t.shape == (m, m)
    np.testing.assert_allclose(sums_t.numpy()[0, :3], np.asarray(sums_j)[0, :3], rtol=1e-5)
    full = TG.gram_quadrant_sums_reference(z64, n64, bw64, n1, MULTS)
    np.testing.assert_allclose(sums_t.numpy(), full.numpy(), rtol=1e-12)
    k = TM.multi_rbf_gram(TG._sq_dists(z64, z64, n64, n64), bw64, MULTS)
    np.testing.assert_allclose(_tile_weighted_sums(k, n1).numpy(), full.numpy(), rtol=1e-12)


# (m, d): the fits' Grams at m = 1000, ragged shapes, the flash regime at
# m = 40960, the panel regime at m = 45056, and a tiny one
SCHEDULE_SHAPES = [(1000, 640), (1000, 1024), (1000, 10240), (850, 2500), (2113, 700),
                   (40960, 1024), (45056, 10240), (40, 40)]


def _k1_blocks_and_scratch(m, d, slice_):
    """K1's tile pairs, the column-major copy of z in its scratch, and the
    rest of its scratch (partial tiles and sums)."""
    copy = d * TG.round_up(m, TG.STASH_TILE)
    return TG.tile_pairs(m), copy, TG.quadrant_sums_scratch_floats(m, d, slice_) - copy


def _k4_blocks_and_scratch(m, d, slice_):
    """The panel backward's first panel, the column-major copy of z that
    every panel shares (one tile taller than K1's), and its partial tiles."""
    blocks = TG.panel_blocks(TG._panel_rows(m), m, 0)
    copy = d * (TG.round_up(m, TG.STASH_TILE) + TG.STASH_TILE)
    return blocks, copy, TG.panel_scratch_floats(blocks, d, slice_)


@pytest.mark.parametrize("kernel", ["K1", "K4"])
def test_tile_schedule_covers_d_fills_the_card_and_bounds_scratch(kernel):
    """The mode / slice schedule of K1 and K4: slices of a multiple of the
    16-column chunk that cover d exactly; tiles x slices within one wave of
    two blocks an SM and, where d can be split that far, more than one block
    an SM; beyond the column-major copy of z, at most one wave of partial
    tiles (never m^2); and at m = 40960, d = 1024 mode (a) (one slice, no
    partial tiles), the whole scratch at most d x M plus one wave of
    tiles."""
    sms = 132
    wave = TG.STASH_BLOCKS_PER_SM * sms * TG.STASH_TILE ** 2
    blocks_and_scratch = _k1_blocks_and_scratch if kernel == "K1" else _k4_blocks_and_scratch
    for m, d in SCHEDULE_SHAPES:
        blocks, _, _ = blocks_and_scratch(m, d, TG.STASH_BK)
        mode, slice_, count = TG.tile_schedule(blocks, d, sms)
        assert slice_ % TG.STASH_BK == 0 and slice_ > 0
        assert (count - 1) * slice_ < d <= count * slice_, (m, d)
        assert mode == ("a" if count == 1 else "b")
        assert count == 1 or blocks * count <= TG.STASH_BLOCKS_PER_SM * sms, (m, d)
        assert blocks * count > sms or count == -(-d // TG.STASH_BK), (m, d)
        _, _, partial = blocks_and_scratch(m, d, slice_)
        assert partial <= wave + 48 * blocks, (m, d)  # the tiles and the sums' partials
    m, d = 40960, 1024
    blocks, copy, _ = blocks_and_scratch(m, d, TG.STASH_BK)
    mode, slice_, count = TG.tile_schedule(blocks, d, sms)
    assert (mode, slice_, count) == ("a", 1024, 1)
    _, copy, partial = blocks_and_scratch(m, d, slice_)
    assert copy + partial <= d * m + wave
    if kernel == "K1":
        assert partial == 3 * 51360  # the sums of each tile pair, nothing else
        # m = 1000: 36 tile pairs, d split as K2's (7 slices)
        assert TG.tile_schedule(TG.tile_pairs(1000), 10240, sms) == ("b", 1472, 7)
    else:
        assert partial == 0
        # the smoke's square panel at m = 1000 is K2's tile pairs
        assert TG.panel_blocks(1000, 1000, 0) == TG.tile_pairs(1000)


@pytest.mark.parametrize("R,C,offset", [
    (1000, 1000, 0),      # the panel backward at m <= R: the whole square
    (320, 850, 256),      # a middle panel: ordered tiles on both sides, ragged C
    (40, 1000, 960),      # the last, short panel
    (1472, 5000, 2944),   # several row tiles, a ragged diagonal block
    (300, 1000, None),    # no offset: ordered tiles
    (37, 130, None),
])
def test_panel_tiles_write_each_entry_once(R, C, offset):
    """A model of K4's tile enumeration: every (r, c) of the (R, C) panel is
    written by exactly one tile, either directly or as the mirror of the
    entry (c - offset, offset + r) of a tile pair J < I of the diagonal
    block; and the host's block count matches."""
    T = TG.STASH_TILE
    tiles = _panel_tiles(R, C, offset)
    assert len(tiles) == TG.panel_blocks(R, C, offset)
    hits = np.zeros((R, C), dtype=np.int32)
    for r0, c0, c1, mirror in tiles:
        r1, ce = min(r0 + T, R), min(c0 + T, c1)
        assert r0 < R and c0 < c1 <= C and c0 % 4 == 0
        hits[r0:r1, c0:ce] += 1
        if mirror:
            assert offset is not None and c0 - offset > r0  # strictly above the diagonal
            hits[c0 - offset:ce - offset, offset + r0:offset + r1] += 1
    assert np.all(hits == 1)



@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_panel_operand_layout(dtype):
    """K4's column operand. float32: column-major, (d, n rounded up to 128,
    plus one tile), column k the k-th feature of every row, the padding rows
    zero. bfloat16 (K4 bf16, read through TMA): the rows rounded to bf16,
    row-major, d padded to a 16-byte row with zeros, no padding rows."""
    x = torch.from_numpy(np.random.default_rng(3).normal(size=(150, 7)).astype(np.float32))
    if dtype == "float32":
        op = TG.panel_operand(x)
        assert op.shape == (7, 256 + TG.STASH_TILE) and op.dtype == torch.float32
        assert torch.equal(op[:, :150], x.T) and not torch.any(op[:, 150:])
        return
    op = TG.panel_operand(x, bf16=True)
    assert op.shape == (150, 8) and op.dtype == torch.bfloat16
    assert torch.equal(op[:, :7], x.to(torch.bfloat16)) and not torch.any(op[:, 7:])
    assert torch.equal(op[:, :7].float(), TG.rounded(x))


@pytest.mark.parametrize("R,C,offset,d,ctas", [
    (1000, 1000, 0, 10240, 3), (320, 1000, 256, 10240, 5), (1000, 1000, None, 10240, 2),
    (640, 4096, 640, 8300, 1), (520, 4096, None, 8300, 1), (1472, 45056, 0, 10240, 1),
    (640, 4096, 0, 2100, 1), (40, 1000, 960, 100, 2),
])
def test_panel_bf16_schedule_within_a_wave(R, C, offset, d, ctas):
    """K4 bf16's clusters: while the tiles fall short of half a wave, d is
    split over 2..8 CTAs a tile with tiles x CTAs within one wave (one CTA an
    SM), no more CTAs than d has 64-column chunks; past it, one CTA a tile
    (K1 and K2 bf16's ``cluster_schedule``)."""
    sms = 132
    blocks = TG.panel_blocks(R, C, offset)
    got = TG.panel_bf16_schedule(blocks, d, sms)
    assert got == ctas and 1 <= got <= TG.CLUSTER_MAX and got <= -(-d // TG.BF16_CHUNK)
    assert got == 1 or blocks * got <= sms
    assert (got == 1) == (2 * blocks > sms or -(-d // TG.BF16_CHUNK) == 1)
    assert got == TG.cluster_schedule(blocks, d, sms)[0]


FLASH_BF16_SHAPES = [(1000, 640), (1000, 1024), (8192, 1024), (850, 2000), (50, 40),
                     (40960, 1024), (2113, 700), (1000, 2048)]


@pytest.mark.parametrize("m,d", FLASH_BF16_SHAPES)
def test_flash_cluster_schedule_covers_d_and_the_square(m, d):
    """K3 bf16's clusters (a model of ``flash_cluster_kernel``'s ranges): at
    most 8 CTAs a cluster; each output group's chunks split over the CTAs,
    at most two a CTA; the dot products' chunks split over the CTAs and
    covering d; with one group the two ranges the same (the row tile's
    chunks stay in shared memory); the S rows of a tile split over the CTAs;
    every (row tile, column tile) formed once a group over the splits; the
    later splits' partials within FLASH_SPLIT_BYTES; at the kl Gram one
    wave."""
    sms = 132
    c, groups, nsplit = TG.flash_cluster_schedule(m, d, sms)
    n = _cdiv(d, TG.BF16_CHUNK)
    tiles = _cdiv(m, TG.STASH_TILE)
    assert 1 <= c <= TG.CLUSTER_MAX and c <= n
    assert groups == _cdiv(n, TG.FLASH_GROUP_CHUNKS)
    dots = [range(q * n // c, (q + 1) * n // c) for q in range(c)]
    assert sorted(k for r in dots for k in r) == list(range(n))
    assert dots[-1][-1] * TG.BF16_CHUNK < d
    for g in range(groups):
        base, gn = g * TG.FLASH_GROUP_CHUNKS, min(TG.FLASH_GROUP_CHUNKS, n - g * TG.FLASH_GROUP_CHUNKS)
        outs = [range(base + q * gn // c, base + (q + 1) * gn // c) for q in range(c)]
        assert sorted(k for r in outs for k in r) == list(range(base, base + gn))
        assert all(len(r) <= 2 for r in outs)
        if groups == 1:
            assert outs == dots and all(1 <= len(r) <= 2 for r in dots)
    rows = [range(q * TG.STASH_TILE // c, (q + 1) * TG.STASH_TILE // c) for q in range(c)]
    assert sorted(r for rr in rows for r in rr) == list(range(TG.STASH_TILE))
    per = _cdiv(tiles, nsplit)
    assert _cdiv(tiles, per) == nsplit
    seen = np.zeros((tiles, tiles), dtype=np.int32)
    for s in range(nsplit):
        for J in range(s * per, min(tiles, (s + 1) * per)):
            seen[:, J] += 1
    assert np.all(seen == 1)
    assert (nsplit - 1) * 4 * m * (d + 1) <= TG.FLASH_SPLIT_BYTES
    if (m, d) == (1000, 640):
        assert (c, groups, nsplit) == (5, 1, 3) and tiles * nsplit * c <= sms
    if (m, d) == (8192, 1024):
        assert (c, groups, nsplit) == (8, 1, 1)


@pytest.mark.parametrize("m,d", FLASH_BF16_SHAPES)
def test_flash_bf16_scratch_holds_no_m2_term(m, d):
    """K3 bf16's scratch: the row-major bf16 copy of z and the later splits'
    partial outputs (m x (d + 1) each), nothing of size m^2 (no dot tile, no
    S tile); at m = 40960 less than an eighth of an (m, m) f32 buffer."""
    _, _, nsplit = TG.flash_cluster_schedule(m, d, 132)
    scratch = TG.flash_bf16_scratch_floats(m, d, nsplit)
    assert scratch == m * TG.round_up(d, 8) // 2 + (nsplit - 1) * m * (d + 1)
    assert scratch <= m * (TG.round_up(d, 8) // 2 + (nsplit - 1) * (d + 1))
    if m == 40960:
        assert scratch < m * m // 8
