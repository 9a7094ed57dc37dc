"""pyharp_tpu_torch: the PyTorch / CUDA port of pyharp-tpu.

The JAX package ``pyharp_tpu`` is the reference; this package mirrors its
layout (``core``, ``interp``, ``tables``, ``opacity``, ``rt``,
``radiation``, ``utils``, ``parallel``, ``bench``) so each module's
counterpart sits at the same path.  It imports torch, numpy and scipy,
never jax.

Ported: the flux solve (``Disort.forward``) with thermal sources, a solar
beam and phase moments, and the radiances (``Disort.intensities``), with
hand-written CUDA kernels for every TPU kernel of the JAX package
(``rt/disort/kernels.py``); the Beer-Lambert solver and the phase-moment
generators; the attenuators; the YAML-driven multi-band ``Radiation``
layer; checkpoints of the tables and sharded array files, both readable by
either package; the column/wave sharding over ``torch.distributed`` ranks
(``parallel``); the profiler, timer and scaling runs (``bench``).  Not
ported, by decision: the JAX pytree helpers (``pytree_dataclass``,
``static_field``, ``replace``), whose place ``torch.nn.Module`` takes.
Entry points put their tensors on the CUDA card unless the caller passes
``device="cpu"``.
"""

from .core import constants, index
from .interp.interpn import interpn, interp1, locate
from .interp.layer2level import (Layer2LevelOptions, k2ndOrder, k4thOrder,
                                 kConstant, kExtrapolate, layer2level)
from .opacity.aerosol import H2SO4Simple, S8Fuller, SimpleAerosol
from .opacity.base import AttenuatorOptions
from .opacity.cia import H2H2CIA, H2HeCIA, XizCIA
from .opacity.clouds import Grey, SimpleCloud
from .opacity.rfm import RFM
from .parallel import init_distributed, make_radiation_mesh
from .radiation import (Radiation, RadiationBand, RadiationBandOptions,
                        RadiationOptions, create_radiation_options,
                        register_attenuator, shared)
from .rt import (BeerLambert, BeerLambertOptions, Disort, DisortOptions,
                 PhaseMomentOptions, scattering_moments)
from .tables.resource import (add_resource_directory, find_resource,
                              get_search_paths, set_search_paths)
from .tables.rfm import load_rfm_table, read_weights_rfm, write_rfm_table
from .utils import (get_direction_grids, parse_radiation_directions,
                    spherical_flux_correction)

__version__ = "0.1.0"

__all__ = [
    "constants", "index",
    "interpn", "interp1", "locate", "Layer2LevelOptions", "layer2level",
    "k2ndOrder", "k4thOrder", "kExtrapolate", "kConstant",
    "find_resource", "add_resource_directory", "set_search_paths",
    "get_search_paths",
    "read_weights_rfm", "load_rfm_table", "write_rfm_table",
    "AttenuatorOptions", "S8Fuller", "H2SO4Simple", "SimpleAerosol", "RFM",
    "XizCIA", "H2H2CIA", "H2HeCIA", "SimpleCloud", "Grey",
    "Disort", "DisortOptions", "BeerLambert", "BeerLambertOptions",
    "PhaseMomentOptions", "scattering_moments",
    "Radiation", "RadiationOptions", "RadiationBand", "RadiationBandOptions",
    "register_attenuator", "create_radiation_options", "shared",
    "make_radiation_mesh", "init_distributed",
    "parse_radiation_directions", "get_direction_grids",
    "spherical_flux_correction",
]
