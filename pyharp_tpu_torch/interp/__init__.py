"""Interpolation: multilinear lookup and layer -> level interpolation."""

from .interpn import interpn, interp1, locate
from .layer2level import (
    Layer2LevelOptions,
    layer2level,
    layer2level_with_mask,
    k2ndOrder,
    k4thOrder,
    kExtrapolate,
    kConstant,
)

__all__ = [
    "interpn", "interp1", "locate",
    "Layer2LevelOptions", "layer2level", "layer2level_with_mask",
    "k2ndOrder", "k4thOrder", "kExtrapolate", "kConstant",
]
