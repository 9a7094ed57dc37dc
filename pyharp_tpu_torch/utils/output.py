"""Radiance output writers (port of ``pyharp_tpu/utils/output.py``): per-bin
TOA radiance tables with ray headers, ASCII or binary, and the string
tokenizer ``vectorize``.  Host side, numpy."""

from __future__ import annotations

import re
import struct

import numpy as np


def write_radiance_ascii(path: str, radiance, rays, wave=None,
                         header: str = "") -> None:
    """Write a per-bin TOA radiance table: ``radiance`` ``(nwave, nray)``,
    ``rays`` ``(nray, 2)`` (mu, phi) outgoing directions, and optionally a
    ``(nwave,)`` spectral coordinate column ``wave``."""
    radiance = np.asarray(radiance)
    rays = np.asarray(rays)
    with open(path, "w") as f:
        if header:
            f.write(f"# {header}\n")
        f.write("# rays (mu, phi):")
        for mu, phi in rays:
            f.write(f" ({mu:.6f},{phi:.6f})")
        f.write("\n")
        for i in range(radiance.shape[0]):
            if wave is not None:
                f.write(f"{np.asarray(wave)[i]:.8e} ")
            f.write(" ".join(f"{v:.8e}" for v in radiance[i]) + "\n")


def write_radiance_bin(path: str, radiance, rays) -> None:
    """Binary variant: three int32 dimensions, then float64 rays and
    radiances."""
    radiance = np.asarray(radiance, np.float64)
    rays = np.asarray(rays, np.float64)
    with open(path, "wb") as f:
        f.write(struct.pack("<iii", radiance.shape[0], radiance.shape[1],
                            rays.shape[0]))
        f.write(rays.tobytes())
        f.write(radiance.tobytes())


def read_radiance_bin(path: str):
    """``(radiance (nwave, nray), rays (nray, 2))`` of a
    :func:`write_radiance_bin` file."""
    with open(path, "rb") as f:
        nwave, nray, nray2 = struct.unpack("<iii", f.read(12))
        rays = np.frombuffer(f.read(nray2 * 2 * 8), np.float64).reshape(nray2, 2)
        rad = np.frombuffer(f.read(nwave * nray * 8), np.float64).reshape(nwave, nray)
    return rad, rays


def vectorize(s: str, delimiters: str = " ,") -> list[str]:
    """Split ``s`` on any of ``delimiters``, dropping empty tokens."""
    return [t for t in re.split("[" + re.escape(delimiters) + "]+", s) if t]
