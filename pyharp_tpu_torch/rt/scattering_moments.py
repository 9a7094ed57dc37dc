"""Phase-function moment generators (PyTorch port of
``pyharp_tpu/rt/scattering_moments.py``).

pydisort's ``disort::scattering_moments(nstr, options)`` (cdisort's
GETMOM): for a phase-function type, the Legendre moments ``g_1..g_nmom``
(g_0 = 1 is implicit, the solver's ``pmom`` convention).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..core.device import DEFAULT_DEVICE, resolve_device

kIsotropic = "isotropic"
kRayleigh = "rayleigh"
kHenyeyGreenstein = "henyey_greenstein"
kDoubleHenyeyGreenstein = "double_henyey_greenstein"


@dataclasses.dataclass(frozen=True)
class PhaseMomentOptions:
    type: str = kIsotropic
    gg: float = 0.0    # HG asymmetry parameter
    gg1: float = 0.0   # double-HG forward lobe
    gg2: float = 0.0   # double-HG backward lobe
    ff: float = 0.0    # double-HG forward fraction

    def replace(self, **kw) -> "PhaseMomentOptions":
        return dataclasses.replace(self, **kw)


def _moments(nmom: int, options: PhaseMomentOptions) -> np.ndarray:
    ls = np.arange(1, nmom + 1)
    if options.type == kIsotropic:
        return np.zeros(nmom)
    if options.type == kRayleigh:
        out = np.zeros(nmom)
        if nmom >= 2:
            out[1] = 0.1  # g_2 = 1/10 for p = 3/4 (1 + cos^2)
        return out
    if options.type == kHenyeyGreenstein:
        if not -1.0 < options.gg < 1.0:
            raise ValueError(f"HG asymmetry must be in (-1,1), got {options.gg}")
        return options.gg**ls
    if options.type == kDoubleHenyeyGreenstein:
        f = options.ff
        return f * options.gg1**ls + (1.0 - f) * options.gg2**ls
    raise ValueError(f"unknown phase function type: {options.type}")


def scattering_moments(nmom: int,
                       options: PhaseMomentOptions = PhaseMomentOptions(),
                       device: torch.device | str = DEFAULT_DEVICE
                       ) -> torch.Tensor:
    """Moments ``g_1..g_nmom`` of the requested phase function, a float64
    tensor ``(nmom,)`` on ``device``."""
    return torch.as_tensor(np.asarray(_moments(nmom, options), np.float64),
                           device=resolve_device(device))
