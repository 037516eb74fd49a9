"""Hermetic multi-device dry run on CPU ranks (counterpart of
``vgan_tpu._dryrun``).

    python -m vgan_tpu_torch._dryrun [N]     (N ranks, default 8)

Spawns N processes that form a gloo world on the CPU (one rank a process,
as the port runs one process per device) and runs, at tiny shapes, the
port's parallel axes:

- dp with feature sharding: the whole kl fit, 2 epochs (one detector and
  one generator epoch) with ``generator_grad='gumbel_st'``, batch rows over
  'data' and columns over 'model' (a ``data x 2`` mesh for an even N >= 4);
- the ring: one no-kl train step on row-sharded samples through
  :func:`~vgan_tpu_torch.parallel.ring.mmd_loss_ring_rowsharded`, gradients
  summed over 'data';
- the ensemble axis: a mask-sharded knn ``SubspaceEnsemble``;
- the GoF axis: the permutation-sharded streaming two-sample test.

Rank 0 prints one OK line. It touches no card: the ranks see no CUDA device
(``CUDA_VISIBLE_DEVICES`` is emptied before they start) and check at the end
that CUDA was never initialized.
"""

from __future__ import annotations

import os
import socket
import sys


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _rank_main(rank: int, n_ranks: int, port: int) -> None:
    import torch
    import torch.distributed as dist

    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}", rank=rank,
                            world_size=n_ranks)
    try:
        line = _checks(n_ranks)
        if rank == 0:
            print(line, flush=True)
    finally:
        dist.destroy_process_group()


def _checks(n_ranks: int) -> str:
    import numpy as np
    import torch
    import torch.distributed as dist

    from vgan_tpu_torch.ensemble.od import SubspaceEnsemble
    from vgan_tpu_torch.ops.cuda.gof_gram import mmd_permutation_test_tiled
    from vgan_tpu_torch.parallel.dp import kl_fit_program_dp
    from vgan_tpu_torch.parallel.input import shard_dataset
    from vgan_tpu_torch.parallel.mesh import make_mesh
    from vgan_tpu_torch.parallel.ring import mmd_loss_ring_rowsharded
    from vgan_tpu_torch.train.steps import AlternationSchedule, TrainConfig, init_no_kl_state

    model = 2 if n_ranks >= 4 and n_ranks % 2 == 0 else 1
    data = n_ranks // model
    mesh = make_mesh(data=data, model=model, device="cpu")

    # dp (+ feature sharding on 'model'): the whole kl fit, 2 epochs
    rng = np.random.default_rng(0)
    n, d = 8 * data, 32
    x = rng.normal(size=(n, d)).astype(np.float32)
    config = TrainConfig(ndims=d, batch_size=n // data, mmd_impl="torch",
                         generator_grad="gumbel_st")
    phases = AlternationSchedule(1, 5).phase_array(2)
    x_local = shard_dataset(x, mesh, shard_features=model > 1)
    _, det_hist, gen_hist = kl_fit_program_dp(x_local, 0, phases, config, mesh,
                                              shard_features=model > 1)
    assert torch.isfinite(det_hist[0]) and torch.isfinite(gen_hist[-1]), (det_hist, gen_hist)

    # the ring: one no-kl train step on row-sharded samples
    ring_mesh = make_mesh(data=n_ranks, model=1, device="cpu")
    group, idx = ring_mesh.get_group("data"), ring_mesh.get_local_rank("data")
    config_r = TrainConfig(ndims=d, batch_size=n_ranks * 4, mmd_impl="torch")
    state = init_no_kl_state(config_r, 1, "cpu")
    gen = state.generator
    params = dict(gen.named_parameters())
    batch = torch.from_numpy(rng.normal(size=(config_r.batch_size, d)).astype(np.float32))
    batch_loc = batch[idx * 4:(idx + 1) * 4]
    z = torch.randn((4, config_r.latent_size), generator=torch.Generator().manual_seed(2 + idx))
    with torch.enable_grad():
        u = gen(z)
        loss, _ = mmd_loss_ring_rowsharded(
            batch_loc, u * batch_loc, u, config_r.penalty_weight,
            torch.zeros(()), torch.tensor(False), group)
        grads = torch.autograd.grad(loss, list(params.values()))
    for g in grads:
        dist.all_reduce(g, group=group)
    config_r.adadelta(config_r.lr_g).step(params, grads, state.opt_state)
    assert torch.isfinite(loss), loss

    # the ensemble axis: mask-sharded subspace scoring
    masks = (rng.random(size=(n_ranks * 2, d)) < 0.5) | np.eye(d, dtype=bool)[:1]
    ens = SubspaceEnsemble(masks, np.full((masks.shape[0],), 1.0 / masks.shape[0], np.float32),
                           base="knn", k=4, chunk=2, mesh=ring_mesh, device="cpu")
    x_tr = rng.normal(size=(64, d)).astype(np.float32)
    x_te = rng.normal(size=(16, d)).astype(np.float32)
    scores = ens.fit(x_tr).decision_function(x_te)
    assert np.all(np.isfinite(scores)), scores

    # the GoF axis: permutation-sharded streaming two-sample test
    gx = rng.normal(size=(24, 5)).astype(np.float32)
    gy = (rng.normal(size=(24, 5)) + 1.0).astype(np.float32)
    stat, pval = mmd_permutation_test_tiled(
        gx, gy, [0.5], generator=torch.Generator().manual_seed(3),
        n_permutations=2 * n_ranks - 1, mesh=ring_mesh, device="cpu")
    assert torch.isfinite(stat) and 0.0 <= float(pval) <= 1.0, (stat, pval)

    assert not torch.cuda.is_initialized(), "the dry run touched a CUDA device"
    return (f"dryrun_multidevice OK: mesh=({data}x{model}) dp+feature-sharded kl fit, "
            f"{n_ranks}-way ring-MMD step, mask-sharded ensemble, permutation-sharded GoF "
            f"executed on {n_ranks} gloo CPU ranks")


def run(n_ranks: int) -> None:
    """Spawn ``n_ranks`` CPU ranks and run the checks; raises if a rank fails."""
    import torch.multiprocessing as mp

    os.environ["CUDA_VISIBLE_DEVICES"] = ""  # the ranks inherit it: no card is visible
    mp.start_processes(_rank_main, args=(n_ranks, _free_port()), nprocs=n_ranks, join=True,
                       start_method="spawn")


def main() -> None:
    run(int(sys.argv[1]) if len(sys.argv) > 1 else 8)


if __name__ == "__main__":
    main()
