"""Utilities: radiation-direction parsing, the spherical flux correction,
the radiance writers, ``vectorize`` and checkpoints (``checkpoint``)."""

from . import checkpoint
from .directions import get_direction_grids, parse_radiation_directions
from .output import (read_radiance_bin, vectorize, write_radiance_ascii,
                     write_radiance_bin)
from .spherical import spherical_flux_correction

__all__ = [
    "checkpoint",
    "parse_radiation_directions", "get_direction_grids",
    "spherical_flux_correction",
    "write_radiance_ascii", "write_radiance_bin", "read_radiance_bin",
    "vectorize",
]
