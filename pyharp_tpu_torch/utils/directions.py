"""Radiation direction parsing and direction grids (port of
``pyharp_tpu/utils/directions.py``).

``"(mu_deg, phi_deg)"`` -> ``(mu = cos(theta), phi_rad)``, and the sorted
unique phi/mu grids of a set of rays (1e-3 tolerance).  Host side, numpy.
"""

from __future__ import annotations

import math
import re

import numpy as np


def deg2rad(x: float) -> float:
    return x * math.pi / 180.0


def parse_radiation_direction(s: str) -> np.ndarray:
    """``"(mu_deg, phi_deg)"`` -> array [cos(mu_deg), phi_rad]."""
    m = re.match(r"\s*\(\s*([-\d.eE+]+)\s*,\s*([-\d.eE+]+)\s*\)", s)
    if not m:
        raise ValueError(f"cannot parse radiation direction: {s!r}")
    mu = math.cos(deg2rad(float(m.group(1))))
    phi = deg2rad(float(m.group(2)))
    return np.array([mu, phi], dtype=np.float64)


def parse_radiation_directions(s: str) -> np.ndarray:
    """Whitespace/comma-separated list of direction strings -> (nray, 2)."""
    tokens = re.findall(r"\([^)]*\)", s)
    if not tokens:
        return np.zeros((0, 2))
    return np.stack([parse_radiation_direction(t) for t in tokens])


# directions closer than this (in mu and in phi [rad]) are one grid point
GRID_TOL = 1.0e-3


def get_direction_grids(dirs: np.ndarray, tol: float = GRID_TOL):
    """Unique sorted ``(uphi, umu)`` grids from ``(nray, 2)`` [mu, phi] rows
    (column 0 is mu, as the parser packs it; the JAX package documents the
    reference's disagreement on this)."""
    def uniq(vals):
        out: list[float] = []
        for v in vals:
            if not any(abs(v - u) <= tol for u in out):
                out.append(float(v))
        return sorted(out)

    if dirs.size == 0:
        return [], []
    return uniq(dirs[:, 1]), uniq(dirs[:, 0])
