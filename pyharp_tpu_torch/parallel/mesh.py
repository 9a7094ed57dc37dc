"""A ``('col', 'wave')`` layout of processes for column and spectral
parallelism (PyTorch port of ``pyharp_tpu/parallel/mesh.py``).

Plane-parallel columns are independent, so the layout is pure data
parallelism: ``col`` splits the columns, ``wave`` the spectral bins or
g-points, and each process (rank) solves its own ``(wave, col)`` block
whole.  The one collective of a step is the ck/spectral reduction over
``wave`` (``sharded.sharded_band_flux``).

Ranks are laid out ``rank = c * n_wave + w``, as the JAX package reshapes
its devices to ``(n_col, n_wave)``.  A spec is a tuple with a mesh axis
name or ``None`` per dimension (JAX's ``PartitionSpec``); the block of a
rank is its slice of every split dimension, and a split that does not
divide evenly raises (nothing is padded).

Multi-process runs call :func:`init_distributed` first (every process, its
own rank), then :func:`make_radiation_mesh` (every process, in the same
order, since it creates the process groups).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Sequence

import numpy as np
import torch
import torch.distributed as dist

from ..core.device import DEFAULT_DEVICE, resolve_device

AXES = ("col", "wave")


def init_distributed(coordinator: str | None = None,
                     num_processes: int | None = None,
                     process_id: int | None = None,
                     backend: str | None = None,
                     device: torch.device | str = DEFAULT_DEVICE) -> None:
    """Join the process group of a multi-process run.

    ``coordinator`` is ``host:port`` of rank 0 (``tcp://`` is added), or a
    full init URL; without it the ``env://`` variables that ``torchrun``
    sets are read.  A no-op for one process, unless ``backend`` is named.
    The backend is ``"nccl"`` for a CUDA ``device`` and ``"gloo"`` for the
    CPU unless the caller names one; NCCL without CUDA raises.
    """
    if (num_processes or 1) <= 1 and backend is None:
        return
    if backend is None:
        backend = "nccl" if resolve_device(device).type == "cuda" else "gloo"
    if backend == "nccl" and not torch.cuda.is_available():
        raise RuntimeError("the NCCL backend needs CUDA, which is not "
                           "available; use backend='gloo' on the CPU")
    if coordinator is None:
        init_method = "env://"
    elif "://" in coordinator:
        init_method = coordinator
    else:
        init_method = f"tcp://{coordinator}"
    dist.init_process_group(
        backend, init_method=init_method,
        world_size=-1 if num_processes is None else num_processes,
        rank=-1 if process_id is None else process_id)


def rank_device(device: torch.device | str = DEFAULT_DEVICE) -> torch.device:
    """This rank's device: for CUDA without an index, card ``rank mod
    device count`` (made current), so ranks on one host spread over its
    cards, and share one when there are more ranks than cards."""
    dev = resolve_device(device)
    if dev.type == "cuda" and dev.index is None:
        rank = dist.get_rank() if dist.is_initialized() else 0
        dev = torch.device("cuda", rank % torch.cuda.device_count())
        torch.cuda.set_device(dev)
    return dev


@dataclasses.dataclass(frozen=True)
class RadiationMesh:
    """``n_col x n_wave`` ranks; ``rank`` is this process's place in the
    mesh and ``groups`` its process group on each axis (none without a
    process group: a one-rank mesh then runs no collective)."""

    n_col: int
    n_wave: int
    rank: int = 0
    groups: dict = dataclasses.field(default_factory=dict, compare=False)

    axis_names = AXES

    @property
    def shape(self) -> tuple[int, int]:
        return (self.n_col, self.n_wave)

    def _check(self, axis: str) -> None:
        if axis not in AXES:
            raise ValueError(f"mesh axes are {AXES}, got {axis!r}")

    def size(self, axis: str) -> int:
        self._check(axis)
        return self.n_col if axis == "col" else self.n_wave

    def index(self, axis: str) -> int:
        """This rank's coordinate on ``axis``."""
        self._check(axis)
        return (self.rank // self.n_wave if axis == "col"
                else self.rank % self.n_wave)

    def get_group(self, axis: str):
        """The process group of the ranks that share this rank's other
        coordinate, or ``None`` without a process group."""
        self._check(axis)
        return self.groups.get(axis)


def make_radiation_mesh(n_col: int | None = None, n_wave: int = 1,
                        ranks: Sequence[int] | None = None
                        ) -> RadiationMesh | None:
    """The ``('col', 'wave')`` mesh over ``ranks`` (default: every rank of
    the process group, or this one process without one).

    ``n_col`` defaults to all ranks on the column axis.  Raises when
    ``n_col * n_wave`` is not the number of ranks.  Every process of the
    group calls this, with the same arguments: it creates the ``wave`` and
    ``col`` groups, all in one order on every rank, or the first collective
    would deadlock.  A process outside ``ranks`` gets ``None``.
    """
    on = dist.is_initialized()
    world = dist.get_world_size() if on else 1
    me = dist.get_rank() if on else 0
    ranks = list(range(world) if ranks is None else ranks)
    if n_col is None:
        n_col = len(ranks) // n_wave
    if n_col * n_wave != len(ranks):
        raise ValueError(f"mesh {n_col}x{n_wave} != {len(ranks)} ranks")
    if not on and ranks != [0]:
        raise ValueError(f"ranks {ranks} without a process group; call "
                         "init_distributed first")
    grid = np.asarray(ranks).reshape(n_col, n_wave)
    groups = {}
    if on:
        for axis, lines in (("wave", grid), ("col", grid.T)):
            for line in lines:
                g = dist.new_group([int(r) for r in line])
                if me in line:
                    groups[axis] = g
    if me not in ranks:
        return None
    return RadiationMesh(n_col, n_wave, ranks.index(me), groups)


def band_input_specs() -> dict[str, tuple]:
    """Which mesh axis splits which dimension of the band inputs (JAX
    ``mesh.py:65-82``): conc ``(ncol, nlyr, nspecies)`` on col; dz
    replicated; bc ``(nwave, ncol)`` on both; atm fields ``(ncol, nlyr)``
    on col; prop and flux ``(nwave, ncol, nlyr, ...)`` on (wave, col);
    per-bin vectors on wave."""
    return dict(
        conc=("col", None, None),
        dz=(),
        bc=("wave", "col"),
        atm=("col", None),
        prop=("wave", "col", None, None),
        flux=("wave", "col", None, None),
        wave=("wave",),
    )


def bc_specs(bc: dict) -> dict[str, tuple]:
    """The spec of each ``bc`` entry (JAX ``sharded.py:39-55``): band edges
    on wave; ``radius`` on (wave, col) when 2-D, else replicated;
    ``h_lev`` on col; ``gensrc`` on (wave, col); other 2-D entries on
    (wave, col); scalars and the rest replicated."""
    out = {}
    for k, v in bc.items():
        nd = getattr(v, "ndim", 0)
        if k in ("wvnmlo", "wvnmhi"):
            out[k] = ("wave",)
        elif k == "radius":
            out[k] = ("wave", "col") if nd == 2 else ()
        elif k == "h_lev":
            out[k] = ("col", None)
        elif k == "gensrc":
            out[k] = ("wave", "col", None, None)
        elif nd == 2:
            out[k] = ("wave", "col")
        else:
            out[k] = ()
    return out


def local_slice(mesh: RadiationMesh, x: Any, spec: tuple) -> Any:
    """This rank's block of the global ``x`` (a tensor or array) under
    ``spec``, a contiguous copy; ``x`` itself where nothing splits it."""
    if not any(ax is not None for ax in spec):
        return x
    idx = []
    for d, ax in enumerate(spec):
        if ax is None:
            idx.append(slice(None))
            continue
        n, size = mesh.size(ax), x.shape[d]
        if size % n:
            raise ValueError(f"dimension {d} of size {size} does not split "
                             f"evenly over {n} {ax!r} shards")
        m = size // n
        k = mesh.index(ax)
        idx.append(slice(k * m, (k + 1) * m))
    block = x[tuple(idx)]
    if isinstance(block, torch.Tensor):
        return block.clone(memory_format=torch.contiguous_format)
    return np.ascontiguousarray(block)


def shard_band_inputs(mesh: RadiationMesh, conc, dz, bc: dict,
                      atm: dict | None = None):
    """This rank's blocks of the band inputs: the counterpart of JAX's
    ``device_put`` with a ``NamedSharding``, after which each rank holds
    only its shard.  ``bc`` entries split by :func:`bc_specs`; 1-D
    ``atm`` entries (spectral grids) on wave, the others on col."""
    specs = band_input_specs()
    conc = local_slice(mesh, conc, specs["conc"])
    bspecs = bc_specs(bc)
    bc = {k: local_slice(mesh, v, bspecs[k]) for k, v in bc.items()}
    if atm is None:
        return conc, dz, bc
    atm = {k: local_slice(mesh, v, specs["wave"] if getattr(v, "ndim", 0) == 1
                          else specs["atm"])
           for k, v in atm.items()}
    return conc, dz, bc, atm
