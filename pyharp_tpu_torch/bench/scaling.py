"""Multi-rank scaling of the sharded band flux (PyTorch port of
``pyharp_tpu/bench/scaling.py``).

The problem is the bench problem of ``bench.py`` (g-points x columns x
layers, nstr 8, isotropic thermal), solved through
``parallel.sharded_band_flux`` on a ``('col', 'wave')`` mesh of ranks.
Each function here is called on every rank of the process group (or in
one process without one) and returns its record on rank 0.

    python -m pyharp_tpu_torch.bench.scaling --ncol 1024
    torchrun --nproc-per-node 1 -m pyharp_tpu_torch.bench.scaling
"""

from __future__ import annotations

import argparse
import json
import os

import torch
import torch.distributed as dist

from ..core.device import DEFAULT_DEVICE
from ..parallel.dryrun import default_backend
from ..parallel.mesh import init_distributed, make_radiation_mesh, rank_device
from ..parallel.sharded import sharded_band_flux
from .problems import bench_problem
from .profile import measure


def build_sharded_step(mesh, nwave: int, ncol: int, nlyr: int = 100,
                       nstr: int = 8, dtype: torch.dtype = torch.float32,
                       device: torch.device | str = DEFAULT_DEVICE,
                       kernel: str = "auto"):
    """``(step, args)``: ``step(*args)`` is the sharded band flux of
    ``problems.bench_problem`` with distinct bins on ``mesh``, this rank's
    ``(ncol / n_col, nlyr+1, 2)``."""
    p = bench_problem(nwave, ncol, nlyr, nstr, dtype, device, kernel,
                      distinct_bins=True)

    def step(prop, bc, temf, weights):
        return sharded_band_flux(p.disort, mesh, prop, bc, weights, temf)

    return step, (*p.args, p.weights)


def _world() -> tuple[int, int]:
    if dist.is_initialized():
        return dist.get_world_size(), dist.get_rank()
    return 1, 0


def _slowest(mesh, seconds: float, device: torch.device) -> float:
    """The largest of the mesh ranks' times (a mesh with n_wave = 1, whose
    col group holds every rank)."""
    group = mesh.get_group("col")
    if group is None:
        return seconds
    t = torch.tensor([seconds], dtype=torch.float64, device=device)
    dist.all_reduce(t, op=dist.ReduceOp.MAX, group=group)
    return float(t.item())


def _barrier() -> None:
    if dist.is_initialized():
        dist.barrier()


def scaling_run(cols_per_device: int = 256, nwave: int = 8, nlyr: int = 100,
                nstr: int = 8, device_counts=None,
                device: torch.device | str = DEFAULT_DEVICE) -> list[dict]:
    """Weak scaling: columns/s on the first n ranks, n in ``device_counts``
    up to the world size, ``cols_per_device`` columns per rank; one record
    per n on rank 0 (the others return ``[]``).

    Meaningful only where each rank has a card of its own: on one card
    only n = 1 runs, and ranks sharing a card measure the sharing (use
    :func:`partition_overhead_run` there)."""
    world, me = _world()
    dev = rank_device(device)
    if device_counts is None:
        device_counts = (1, 2, 4, 8, 16, 32)
    results, base = [], None
    for n in (n for n in device_counts if n <= world):
        mesh = make_radiation_mesh(n_col=n, n_wave=1, ranks=range(n))
        if mesh is not None:
            ncol = cols_per_device * n
            step, args = build_sharded_step(mesh, nwave, ncol, nlyr, nstr,
                                            device=dev)
            sec = _slowest(mesh, measure(step, *args, iters=3), dev)
            cols_per_s = ncol / sec
            if base is None:
                base = cols_per_s / n
            results.append({
                "devices": n,
                "columns_per_s": cols_per_s,
                "columns_per_s_per_device": cols_per_s / n,
                "efficiency": cols_per_s / (base * n),
            })
        _barrier()
    return results if me == 0 else []


def partition_overhead_run(ncol_total: int = 1024, nwave: int = 8,
                           nlyr: int = 100, nstr: int = 8,
                           device: torch.device | str = DEFAULT_DEVICE
                           ) -> dict | None:
    """Fixed global work: rank 0 alone against every rank of the world.

    Rank 0 times the whole problem on a one-rank mesh (``t_single_s``) and
    one rank's share of it (``t_one_shard_s``) while the others wait; then
    every rank runs its block of the sharded step on an (n x 1) mesh
    (``t_sharded_s``, the slowest rank's time).  Where the ranks share one
    card, as on JAX's virtual devices sharing a host, the card's time is
    shared too: the no-overhead expectation is then n * t_one_shard_s, so
    ``overhead_vs_serialized_shards`` ~ 1 says that partitioning (the
    slicing, per-rank dispatch, the wave reduction) added no work.  This
    is the honest reading on one card.  Returns the record on rank 0 and
    ``None`` on the others."""
    world, me = _world()
    if ncol_total % world:
        raise ValueError(f"{ncol_total} columns do not split over {world} "
                         "ranks")
    dev = rank_device(device)
    mesh1 = make_radiation_mesh(n_col=1, n_wave=1, ranks=[0])
    if mesh1 is not None:
        step1, args1 = build_sharded_step(mesh1, nwave, ncol_total, nlyr,
                                          nstr, device=dev)
        t1 = measure(step1, *args1, iters=3)
        stepS, argsS = build_sharded_step(mesh1, nwave, ncol_total // world,
                                          nlyr, nstr, device=dev)
        t_shard = measure(stepS, *argsS, iters=3)
        del step1, args1, stepS, argsS
    _barrier()
    meshN = make_radiation_mesh(n_col=world, n_wave=1)
    stepN, argsN = build_sharded_step(meshN, nwave, ncol_total, nlyr, nstr,
                                      device=dev)
    tN = _slowest(meshN, measure(stepN, *argsN, iters=3), dev)
    if me != 0:
        return None
    return {
        "ranks": world,
        "device": str(dev) if dev.type == "cpu"
        else torch.cuda.get_device_name(dev),
        "backend": dist.get_backend() if dist.is_initialized() else None,
        "ncol_total": ncol_total,
        "t_single_s": t1,
        "t_one_shard_s": t_shard,
        "t_sharded_s": tN,
        "overhead_vs_serialized_shards": tN / (world * t_shard),
        "partition_overhead_vs_single": tN / t1,
        # the wave reduction moves (nlyr+1) x 2 float32 per column and
        # wave shard; none here, where the wave axis is local
        "allreduce_bytes_per_column": (nlyr + 1) * 2 * 4,
    }


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--ncol", type=int, default=1024)
    ap.add_argument("--device", default=DEFAULT_DEVICE)
    a = ap.parse_args(argv)
    world = int(os.environ.get("WORLD_SIZE", "1"))
    init_distributed(num_processes=world,
                     process_id=int(os.environ.get("RANK", "0")),
                     backend=default_backend(world, a.device) if world > 1
                     else None, device=a.device)
    try:
        rec = partition_overhead_run(ncol_total=a.ncol, device=a.device)
        if rec is not None:
            print(json.dumps(rec))
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


if __name__ == "__main__":
    main()
