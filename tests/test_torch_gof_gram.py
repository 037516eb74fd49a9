"""The plain version of the port's K5 kernel (``a_times_k``) and the tiled
permutation tests built on it, against ``vgan_tpu.ops.pallas.gof_gram`` run
in Pallas interpret mode on the CPU.

On the CPU ``a_times_k`` returns its plain version; the CUDA kernel itself is
held to that plain version on the card by chip_smoke.py.
"""

from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import vgan_tpu.ops.pallas.gof_gram as JG
from vgan_tpu_torch.ops.cuda import gof_gram as TG

ALPHAS = [0.01, 0.5, 2.0]


def _rows(m, d, P, seed=0):
    rng = np.random.default_rng(seed)
    z = (rng.normal(size=(m, d)) * 0.3).astype(np.float32)
    a = (rng.random((P, m)) < 0.5).astype(np.float32)
    return z, a


def _jax_padded(z, a):
    """The JAX kernel's padded operands for the same rows."""
    m, d = z.shape
    M, D, tile_d = JG._pad_layout(m, d)
    M = JG._round_up(M, JG.TILE_M)
    z_pad = jnp.zeros((M, D), jnp.float32).at[:m, :d].set(z)
    norms = jnp.sum(z_pad * z_pad, axis=1, keepdims=True)
    a_pad = jnp.zeros((JG._round_up(a.shape[0], 8), M), jnp.float32).at[:a.shape[0], :m].set(a)
    return z_pad, norms, a_pad, tile_d


def _torch_rows(z):
    zt = torch.from_numpy(z)
    return zt, torch.sum(zt * zt, dim=1)


def test_a_times_k_plain_vs_pallas():
    m, d, P = 300, 20, 16
    z, a = _rows(m, d, P)
    z_pad, norms, a_pad, tile_d = _jax_padded(z, a)
    want = JG._a_times_k(z_pad, norms, a_pad, jnp.asarray(ALPHAS, jnp.float32), m,
                         n_alphas=len(ALPHAS), tile_d=tile_d, interpret=True)
    want = np.asarray(want)[:, :P, :m]
    zt, nt = _torch_rows(z)
    TG.reset_launch_counts()
    got = TG.a_times_k(zt, nt, torch.from_numpy(a), ALPHAS)
    assert TG.launch_counts() == {"a_times_k": 0}, "no kernel launches on CPU tensors"
    assert got.shape == (len(ALPHAS), P, m) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5)
    np.testing.assert_array_equal(
        got.numpy(), TG.a_times_k_reference(zt, nt, torch.from_numpy(a), ALPHAS).numpy())


def _separated_pair(n1, n2, d, seed):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(n1, d)).astype(np.float32) * 0.4
    y = (rng.normal(size=(n2, d)) * 0.4 + 0.25).astype(np.float32)
    base = np.r_[np.ones(n1), np.zeros(n2)]
    perms = np.stack([rng.permutation(base) for _ in range(30)])
    return x, y, perms


@pytest.mark.parametrize("precise", [False, True])
def test_stats_for_rows_vs_jax(precise):
    n1, n2 = 70, 50
    x, y, perms = _separated_pair(n1, n2, 12, seed=1)
    z = np.concatenate([x, y])
    a = np.concatenate([np.r_[np.ones(n1), np.zeros(n2)][None], perms[:8]]).astype(np.float32)
    z_pad, norms, _, tile_d = _jax_padded(z, a)
    a_rows = jnp.zeros((a.shape[0], z_pad.shape[0]), jnp.float32).at[:, :n1 + n2].set(a)
    want = JG._stats_for_rows(a_rows, z_pad, norms, jnp.asarray(ALPHAS, jnp.float32), n1, n2,
                              n1 + n2, tile_d, interpret=True, precise=precise)
    zt, nt = _torch_rows(z)
    got = TG._stats_for_rows(torch.from_numpy(a), zt, nt, ALPHAS, n1, n2, precise=precise)
    assert got.shape == (len(ALPHAS), a.shape[0])
    assert got.dtype == (torch.float64 if precise else torch.float32)
    # each statistic is a difference of Gram means of order one; near-zero
    # permuted statistics are held to a few float32 ulp of those means
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-4, atol=1e-6)


@pytest.mark.parametrize("precision", ["float32", "float64"])
def test_tiled_sweep_vs_jax(precision):
    x, y, perms = _separated_pair(90, 60, 10, seed=3)
    sj, pj = JG.mmd_permutation_test_tiled_sweep(
        x, y, ALPHAS, jax.random.PRNGKey(0), precision=precision, permutations=perms,
        interpret=True)
    st, pt = TG.mmd_permutation_test_tiled_sweep(
        x, y, ALPHAS, precision=precision, permutations=perms, device="cpu")
    np.testing.assert_allclose(st.numpy(), np.asarray(sj), rtol=1e-4)
    np.testing.assert_array_equal(pt.numpy(), np.asarray(pj))
    # the pooled-alpha test is the sum of the per-alpha statistics
    s1, p1 = TG.mmd_permutation_test_tiled(x, y, ALPHAS, precision=precision,
                                           permutations=perms, device="cpu")
    np.testing.assert_allclose(float(s1), float(st.sum()), rtol=1e-5)
    assert 0.0 <= float(p1) <= 1.0


def test_tiled_sweep_draws_from_the_generator_and_blocks_rows(monkeypatch):
    """Without ``permutations`` the rows come from the seeded generator; row
    blocks smaller than the permutation count give the same statistics."""
    x, y, _ = _separated_pair(40, 30, 6, seed=4)
    g = lambda: torch.Generator().manual_seed(5)
    s1, p1 = TG.mmd_permutation_test_tiled_sweep(x, y, ALPHAS, generator=g(),
                                                 n_permutations=25, device="cpu")
    s2, p2 = TG.mmd_permutation_test_tiled_sweep(x, y, ALPHAS, generator=g(),
                                                 n_permutations=25, device="cpu")
    assert torch.equal(s1, s2) and torch.equal(p1, p2)
    monkeypatch.setattr(TG, "ROW_BLOCK_BYTES", 4 * len(ALPHAS) * 70 * 7)
    s3, p3 = TG.mmd_permutation_test_tiled_sweep(x, y, ALPHAS, generator=g(),
                                                 n_permutations=25, device="cpu")
    np.testing.assert_allclose(s3.numpy(), s1.numpy(), rtol=1e-6)
    np.testing.assert_array_equal(p3.numpy(), p1.numpy())


def test_mesh_message_names_a_roadmap_item():
    """``mesh=`` is ported (ROADMAP.md Queue 1, item 5; held to JAX in
    tests/test_torch_parallel.py): what it refuses is an object that is not
    a mesh, and the message names where a mesh comes from."""
    x, y, _ = _separated_pair(5, 5, 3, seed=6)
    with pytest.raises(TypeError, match="vgan_tpu_torch.parallel.make_mesh"):
        TG.mmd_permutation_test_tiled(x, y, [0.1], mesh=object(), device="cpu")
    roadmap = (Path(__file__).resolve().parent.parent / "ROADMAP.md").read_text()
    queue1 = roadmap.split("### Queue 1")[1].split("### Queue 2")[0]
    assert "5. **Done (PR 14): `parallel/`" in queue1


def test_tiled_rejects_mesh_and_bad_precision():
    x, y, _ = _separated_pair(5, 5, 3, seed=6)
    with pytest.raises(TypeError, match="DeviceMesh"):
        TG.mmd_permutation_test_tiled_sweep(x, y, [0.1], mesh=object(), device="cpu")
    with pytest.raises(ValueError):
        TG.mmd_permutation_test_tiled(x, y, [0.1], precision="float16", device="cpu")


@pytest.mark.parametrize("m, budget_rows", [(850, 256), (300, 128), (129, 1), (1000, 1024),
                                            (1000, 896)])
def test_panels_cover_each_row_once(monkeypatch, m, budget_rows):
    """Pass 1's row panels: whole kernel tiles, each row in exactly one, and
    one panel (the full-Gram regime) exactly where the padded (M, M) buffer
    fits the budget."""
    tile = TG.KERNEL_TILE
    M = -(-m // tile) * tile
    monkeypatch.setattr(TG, "GRAM_BUFFER_BYTES", 4 * M * budget_rows)
    plan = TG.panels(m)
    covered = np.zeros(m, int)
    for row0, rows in plan:
        assert row0 % tile == 0 and rows >= 1
        covered[row0:row0 + rows] += 1
    np.testing.assert_array_equal(covered, 1)
    assert all(rows % tile == 0 for _, rows in plan[:-1])
    full = M * M * 4 <= TG.GRAM_BUFFER_BYTES
    assert (len(plan) == 1) == full and TG.regime(m) == ("full" if full else "panels")


def test_plain_by_panels_equals_reference(monkeypatch):
    """C summed panel by panel (the rows of d2 that a panel holds, the
    diagonal zeroed by global index) equals the plain version, in float64."""
    m, d, P = 300, 9, 11
    monkeypatch.setattr(TG, "GRAM_BUFFER_BYTES", 4 * 384 * 128)
    plan = TG.panels(m)
    assert len(plan) == 3 and TG.regime(m) == "panels"
    z, a = _rows(m, d, P, seed=8)
    z, a = torch.from_numpy(z).double(), torch.from_numpy(a).double()
    norms = torch.sum(z * z, dim=1)
    c = torch.zeros((len(ALPHAS), P, m), dtype=torch.float64)
    for row0, rows in plan:
        r = slice(row0, row0 + rows)
        d2 = torch.clamp_min(-2.0 * (z[r] @ z.T) + norms[r, None] + norms[None, :], 0.0)
        off_diag = torch.arange(row0, row0 + rows)[:, None] != torch.arange(m)[None, :]
        for q, al in enumerate(ALPHAS):
            c[q] += a[:, r] @ torch.where(off_diag, torch.exp(-al * d2), 0.0)
    want = TG.a_times_k_reference(z, norms, a, ALPHAS)
    np.testing.assert_allclose(c.numpy(), want.numpy(), rtol=1e-12)
