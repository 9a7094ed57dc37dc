"""Utilities: radiation-direction parsing, the spherical flux correction,
the radiance writers and ``vectorize``.  Checkpointing of the JAX package's
``utils`` is ROADMAP.md section 1 item 10."""

from .directions import get_direction_grids, parse_radiation_directions
from .output import (read_radiance_bin, vectorize, write_radiance_ascii,
                     write_radiance_bin)
from .spherical import spherical_flux_correction

__all__ = [
    "parse_radiation_directions", "get_direction_grids",
    "spherical_flux_correction",
    "write_radiance_ascii", "write_radiance_bin", "read_radiance_bin",
    "vectorize",
]
