"""The DISORT forward over a ``('col', 'wave')`` mesh (PyTorch port of
``pyharp_tpu/parallel/sharded.py``, the JAX package's production path).

Each rank takes its ``(wave, col)`` block of the global inputs and runs
``disort.forward`` on it, so the solve on a rank is a single-process solve:
on CUDA tensors it launches the kernels through ``kernels.route`` as one
process does.  The only collective is the ``all_reduce`` of the ck/spectral
weighted sum over the ``wave`` group.

Band edges: a rank that holds only some bins must integrate Planck over
those bins' edges.  Edges given in the options are therefore passed as
``bc['wvnmlo'] / bc['wvnmhi']`` ``(nwave,)`` and split over ``wave`` like
the rest (``Disort._band_edges`` prefers them); without that, every rank
would use the first bins' edges and give a wrong answer without an error.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.distributed as dist
from torch import Tensor

from .mesh import RadiationMesh, band_input_specs, bc_specs, local_slice


def _with_band_edges(disort, bc: dict, like: Tensor) -> dict:
    """``bc`` with the options' per-bin band edges added as tensors."""
    if "wvnmlo" in bc or not disort.options.wave_lower:
        return bc
    kw = dict(dtype=like.dtype, device=like.device)
    return dict(bc,
                wvnmlo=torch.as_tensor(np.asarray(disort.options.wave_lower),
                                       **kw),
                wvnmhi=torch.as_tensor(np.asarray(disort.options.wave_upper),
                                       **kw))


def sharded_forward(disort, mesh: RadiationMesh, prop: Tensor, bc: dict,
                    temf: Tensor | None = None) -> Tensor:
    """``disort.forward`` on this rank's block.

    The arguments are those of :meth:`Disort.forward` with their global
    shapes; ``bc`` entries split as ``mesh.bc_specs`` says and ``temf``
    over col.  Returns the local flux ``(nwave/n_wave, ncol/n_col, nlyr+1,
    2)``.
    """
    specs = band_input_specs()
    bc = _with_band_edges(disort, bc, prop)
    bspecs = bc_specs(bc)
    return disort.forward(
        local_slice(mesh, prop, specs["prop"]),
        {k: local_slice(mesh, v, bspecs[k]) for k, v in bc.items()},
        None if temf is None else local_slice(mesh, temf, specs["atm"]))


def sharded_band_flux(disort, mesh: RadiationMesh, prop: Tensor, bc: dict,
                      weights, temf: Tensor | None = None) -> Tensor:
    """:func:`sharded_forward`, the weighted sum over this rank's bins, and
    one ``all_reduce`` over the ``wave`` group: the band flux ``(ncol /
    n_col, nlyr+1, 2)`` of this rank's columns, the same on every rank of
    the group."""
    flux = sharded_forward(disort, mesh, prop, bc, temf)
    w = local_slice(mesh, torch.as_tensor(weights, dtype=flux.dtype,
                                          device=flux.device),
                    band_input_specs()["wave"])
    bflx = torch.einsum("g,g...->...", w, flux)
    group = mesh.get_group("wave")
    if group is not None:
        dist.all_reduce(bflx, op=dist.ReduceOp.SUM, group=group)
    return bflx
