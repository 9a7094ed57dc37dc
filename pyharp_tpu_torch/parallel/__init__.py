"""Column and spectral parallelism over processes with ``torch.distributed``
(port of ``pyharp_tpu/parallel``): a ``('col', 'wave')`` layout of ranks,
each solving its own block; the only collective of a step is the
ck/spectral reduction over ``wave``."""

from .dryrun import dryrun_multigpu, spawn
from .mesh import (RadiationMesh, band_input_specs, bc_specs,
                   init_distributed, local_slice, make_radiation_mesh,
                   rank_device, shard_band_inputs)
from .sharded import sharded_band_flux, sharded_forward

__all__ = [
    "init_distributed", "make_radiation_mesh", "band_input_specs",
    "shard_band_inputs", "sharded_forward", "sharded_band_flux",
    "RadiationMesh", "bc_specs", "local_slice", "rank_device",
    "dryrun_multigpu", "spawn",
]
