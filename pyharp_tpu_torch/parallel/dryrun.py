"""Run a function on n processes joined in one process group, and the
multi-process dry run (the counterpart of the JAX package's
``__graft_entry__.dryrun_multichip``).

    python -c "from pyharp_tpu_torch.parallel import dryrun_multigpu; \\
               dryrun_multigpu(2, 'cpu')"
"""

from __future__ import annotations

import socket

import numpy as np
import torch
import torch.distributed as dist

from ..core.device import DEFAULT_DEVICE, resolve_device
from .mesh import (init_distributed, local_slice, make_radiation_mesh,
                   rank_device)
from .sharded import sharded_band_flux


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def default_backend(n: int, device: torch.device | str) -> str:
    """NCCL when every rank has a card of its own, else gloo (NCCL refuses
    two ranks on one card; gloo stages CUDA tensors through the host)."""
    dev = resolve_device(device)
    if dev.type == "cuda" and n <= torch.cuda.device_count():
        return "nccl"
    return "gloo"


def _rank_main(rank: int, fn, n: int, port: int, backend: str, device: str,
               args: tuple) -> None:
    init_distributed(f"localhost:{port}", n, rank, backend=backend,
                     device=device)
    try:
        fn(rank, n, *args)
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


def spawn(fn, n: int, *args, backend: str | None = None,
          device: torch.device | str = DEFAULT_DEVICE) -> None:
    """Run ``fn(rank, n, *args)`` in ``n`` new processes, joined in one
    process group on ``localhost`` (``backend`` as :func:`default_backend`
    picks it unless named), and wait for them; raises if a rank fails.
    ``fn`` and ``args`` are pickled: ``fn`` must be importable by name."""
    device = str(device)
    if backend is None:
        backend = default_backend(n, device)
    torch.multiprocessing.spawn(
        _rank_main, args=(fn, n, _free_port(), backend, device, args),
        nprocs=n, join=True)


def dryrun_multigpu(n_devices: int,
                    device: torch.device | str = DEFAULT_DEVICE) -> None:
    """One step of the sharded band flux on ``n_devices`` ranks.

    The mesh is (n/2) x 2 (col x wave) when n is even, else n x 1; each
    rank solves its block of a small thermal problem with a beam and one
    phase moment (8 layers, nstr 8, distinct per-bin edges), then the wave
    reduction and a column mean over ``col``.  Both are held against the
    single-process ``forward`` and weighted sum on the same inputs
    (rtol 5e-6, atol 1e-8, as the JAX dry run).  Rank 0 prints one line.
    """
    device = str(resolve_device(device))
    spawn(_dryrun_rank, n_devices, device, device=device)


def _dryrun_rank(rank: int, n: int, device: str) -> None:
    from ..rt.disort.disort import Disort, DisortOptions

    dev = rank_device(device)
    n_wave = 2 if n % 2 == 0 else 1
    n_col = n // n_wave
    mesh = make_radiation_mesh(n_col, n_wave)
    nwave, ncol, nlyr, nstr = 4 * n_wave, 2 * n_col, 8, 8
    edges = np.linspace(1.0, 1200.0, nwave + 1)
    disort = Disort(DisortOptions(
        flags="lamber,quiet,onlyfl,planck", nwave=nwave, ncol=ncol,
        nlyr=nlyr, nstr=nstr, nmom=nstr, wave_lower=tuple(edges[:-1]),
        wave_upper=tuple(edges[1:])))

    rng = np.random.default_rng(0)
    prop = np.zeros((nwave, ncol, nlyr, 3), np.float32)
    prop[..., 0] = rng.uniform(0.01, 0.5, (nwave, ncol, nlyr))
    prop[..., 1] = rng.uniform(0.1, 0.9, (nwave, ncol, nlyr))
    prop[..., 2] = 0.1
    kw = dict(dtype=torch.float32, device=dev)
    prop = torch.tensor(prop, **kw)
    bc = dict(fbeam=torch.full((nwave, ncol), float(np.pi), **kw),
              umu0=torch.full((nwave, ncol), 0.8, **kw),
              albedo=torch.full((nwave, ncol), 0.3, **kw),
              btemp=torch.full((nwave, ncol), 300.0, **kw))
    temf = torch.full((ncol, nlyr + 1), 280.0, **kw)
    weights = torch.full((nwave,), 1.0 / nwave, **kw)

    bflx = sharded_band_flux(disort, mesh, prop, bc, weights, temf)
    # the column mean: a collective over 'col'
    mean = bflx.sum(dim=0)
    dist.all_reduce(mean, group=mesh.get_group("col"))
    mean = mean / ncol

    ref = torch.einsum("g,g...->...", weights, disort.forward(prop, bc, temf))
    assert bflx.shape == (ncol // n_col, nlyr + 1, 2), bflx.shape
    assert bool(torch.isfinite(mean).all())
    np.testing.assert_allclose(
        bflx.cpu().numpy(),
        local_slice(mesh, ref, ("col", None, None)).cpu().numpy(),
        rtol=5e-6, atol=1e-8)
    np.testing.assert_allclose(mean.cpu().numpy(),
                               ref.mean(dim=0).cpu().numpy(),
                               rtol=5e-6, atol=1e-8)
    if rank == 0:
        print(f"dryrun_multigpu: {n} ranks ({dist.get_backend()}, {dev}), "
              f"mesh {mesh.shape} (col x wave), bflx {tuple(bflx.shape)} per "
              f"rank OK (sharded band flux and column mean agree with the "
              f"single-process forward)", flush=True)
