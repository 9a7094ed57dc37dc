"""RT solvers, each with ``forward(prop, bc, temf=None)``: ``prop`` is
``(nwave, ncol, nlyr, nprop)`` bottom-up and the result ``(nwave, ncol,
nlyr+1, 2)`` bottom-up level fluxes (IUP/IDN).  Disort (discrete
ordinates) and Beer-Lambert (no scattering)."""

from .beer_lambert import BeerLambert, BeerLambertOptions, toa_radiance
from .disort.disort import Disort, DisortOptions
from .scattering_moments import (PhaseMomentOptions, kDoubleHenyeyGreenstein,
                                 kHenyeyGreenstein, kIsotropic, kRayleigh,
                                 scattering_moments)

__all__ = ["Disort", "DisortOptions", "BeerLambert", "BeerLambertOptions",
           "toa_radiance", "PhaseMomentOptions", "scattering_moments",
           "kIsotropic", "kRayleigh", "kHenyeyGreenstein",
           "kDoubleHenyeyGreenstein"]
