"""RadiationBand: one spectral band = a set of attenuators + one RT solver
(port of ``pyharp_tpu/radiation/band.py``).

* construction builds the attenuators by ``type`` string (the registry
  below, the reference's ``"h2sO4_simple"`` typo included) and the Disort
  solver with the band's sizes, directions and per-bin wave edges;
* ``forward(conc, dz, bc, atm)`` accumulates extinction, extinction-weighted
  SSA and ext*ssa-weighted phase moments over the attenuators, renormalizes
  them with the reference's epsilons, turns extinction into optical
  thickness ``tau = k dz``, exports ``radiation/<name>/optics`` to the
  blackboard and runs the solver (with ``layer2level(temp)`` level
  temperatures when ``atm`` has ``temp``).

The solver is Disort, or Beer-Lambert (``solver_name="beer_lambert"``)
with the band's per-bin edges.  ``band_radiance`` solves the radiances on
the band's direction grids (Disort only) and gathers the TOA value of each
configured ray.  The property layout is ``(nwave, ncol, nlyr, nprop)``
throughout.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable

import numpy as np
import torch
from torch import Tensor

from ..core import index
from ..core.device import DEFAULT_DEVICE, resolve_device
from ..interp.layer2level import Layer2LevelOptions, layer2level
from ..opacity.aerosol import H2SO4Simple, S8Fuller
from ..opacity.base import AttenuatorOptions
from ..opacity.cia import H2H2CIA, H2HeCIA
from ..opacity.clouds import Grey, SimpleCloud
from ..opacity.freedman import FreedmanMean, FreedmanSimple
from ..opacity.radio import RadioCIA, RadioElectron, RadioVVWAbsorber
from ..opacity.rfm import RFM
from ..rt.beer_lambert import BeerLambert, BeerLambertOptions
from ..rt.disort.disort import Disort, DisortOptions
from ..utils.directions import (GRID_TOL, get_direction_grids,
                                parse_radiation_directions)
from .shared import shared

def _with_lines(table: str):
    """A radio line absorber reading ``table`` unless the options name
    their own line file."""
    def build(op, dtype, device):
        if not op.opacity_files:
            op = op.replace(opacity_files=(table,))
        return RadioVVWAbsorber(op, dtype=dtype)
    return build


# type string -> builder(options, dtype, device)
_ATTENUATOR_BUILDERS: dict[str, Callable[..., Any]] = {
    "rfm": lambda op, dtype, device: RFM.from_options(op, dtype=dtype,
                                                      device=device),
    "s8_fuller": lambda op, dtype, device: S8Fuller(op, dtype=dtype,
                                                    device=device),
    "h2so4_simple": lambda op, dtype, device: H2SO4Simple(op, dtype=dtype,
                                                          device=device),
    # the reference's typo, accepted deliberately (radiation_band.cpp:45)
    "h2sO4_simple": lambda op, dtype, device: H2SO4Simple(op, dtype=dtype,
                                                          device=device),
    "h2_h2_cia": lambda op, dtype, device: H2H2CIA(op, dtype=dtype,
                                                   device=device),
    "h2_he_cia": lambda op, dtype, device: H2HeCIA(op, dtype=dtype,
                                                   device=device),
    "simple_cloud": lambda op, dtype, device: SimpleCloud(op, dtype=dtype),
    "grey": lambda op, dtype, device: Grey(op, dtype=dtype),
    "freedman_mean": lambda op, dtype, device: FreedmanMean(op, dtype=dtype),
    "freedman_simple": lambda op, dtype, device: FreedmanSimple(op,
                                                                dtype=dtype),
    "radio_nh3": _with_lines("radio_nh3_lines.txt"),
    "radio_h2o": _with_lines("radio_h2o_lines.txt"),
    "radio_h2s": _with_lines("radio_h2s_lines.txt"),
    "radio_ph3": _with_lines("radio_ph3_lines.txt"),
    "radio_cia": lambda op, dtype, device: RadioCIA(op, dtype=dtype),
    "radio_electron": lambda op, dtype, device: RadioElectron(op,
                                                              dtype=dtype),
}


def register_attenuator(name: str, builder: Callable[..., Any]) -> None:
    """Register ``builder(options, dtype, device)`` under the type string
    ``name`` (the legacy AbsorberFactory's extension hook)."""
    _ATTENUATOR_BUILDERS[name] = builder


@dataclasses.dataclass(frozen=True)
class RadiationBandOptions:
    """Mirror of the JAX package's ``RadiationBandOptions``."""

    name: str = "band"
    outdirs: str = ""
    solver_name: str = "disort"
    nlyr: int = 1
    ncol: int = 1
    wave_lower: tuple[float, ...] = ()
    wave_upper: tuple[float, ...] = ()
    attenuators: tuple[tuple[str, AttenuatorOptions], ...] = ()
    disort: DisortOptions = DisortOptions()
    beer_lambert: BeerLambertOptions = BeerLambertOptions()
    l2l: Layer2LevelOptions = Layer2LevelOptions(check_positivity=False)
    ck_weights: tuple[float, ...] = ()  # correlated-k quadrature weights
    # spectral sample grid [cm^-1] of regular (line-by-line) bands, given to
    # the attenuators as ``wavenumber`` when the caller gives no grid
    wavenumber: tuple[float, ...] = ()

    def replace(self, **kw) -> "RadiationBandOptions":
        return dataclasses.replace(self, **kw)


class RadiationBand:
    """One band; its tables and solver inputs live on ``device``."""

    def __init__(self, options: RadiationBandOptions,
                 dtype: torch.dtype = torch.float32,
                 device: torch.device | str = DEFAULT_DEVICE):
        self.device = resolve_device(device)
        if options.wave_lower and options.wave_upper:
            if len(options.wave_lower) != len(options.wave_upper):
                raise ValueError(
                    "wave_lower and wave_upper must have the same size")
        if options.solver_name not in ("disort", "beer_lambert"):
            raise ValueError(f"Unknown solver: {options.solver_name}")
        self.options = options
        self.dtype = dtype

        self.attenuators: dict[str, Any] = {}
        nmax_prop = 1
        for name, aop in options.attenuators:
            builder = _ATTENUATOR_BUILDERS.get(aop.type)
            if builder is None:
                known = ", ".join(sorted(_ATTENUATOR_BUILDERS))
                raise ValueError(
                    f"Unknown attenuator type: {aop.type!r} (registered: "
                    f"{known}; extend via pyharp_tpu_torch.radiation."
                    f"register_attenuator)")
            a = builder(aop, dtype, self.device)
            nmax_prop = max(nmax_prop, a.nprop)
            self.attenuators[name] = a
        self.nmax_prop = nmax_prop

        ray_out = (parse_radiation_directions(options.outdirs)
                   if options.outdirs else np.zeros((0, 2)))
        self.rayout = np.asarray(ray_out)       # (nray, 2) = (mu, phi)
        if options.solver_name == "beer_lambert":
            self.rtsolver = BeerLambert(dataclasses.replace(
                options.beer_lambert, wave_lower=options.wave_lower,
                wave_upper=options.wave_upper))
        else:
            uphi, umu = get_direction_grids(ray_out)
            dop = options.disort.replace(
                nlyr=options.nlyr, ncol=options.ncol, user_phi=tuple(uphi),
                user_mu=tuple(umu), wave_lower=options.wave_lower,
                wave_upper=options.wave_upper)
            if options.wave_lower:
                dop = dop.replace(nwave=len(options.wave_lower))
            self.rtsolver = Disort(dop)

    # ------------------------------------------------------------------

    def compute_optics(self, conc: Tensor, dz: Tensor, **atm: Tensor) -> Tensor:
        """Accumulate the attenuators' properties into band optics
        ``(nwave, ncol, nlyr, nmax_prop)``: (tau, ssa, pmom...), in the
        reference's order and with its epsilons
        (``radiation_band.cpp:86-116``)."""
        prop = None
        for a in self.attenuators.values():
            kdata = a.forward(conc, **atm)      # (nwave, ncol, nlyr, nprop_a)
            nprop_a = kdata.shape[-1]
            if nprop_a < self.nmax_prop:
                pad = kdata.new_zeros(kdata.shape[:-1]
                                      + (self.nmax_prop - nprop_a,))
                kdata = torch.cat([kdata, pad], dim=-1)
            # attenuators emit (k, ssa*k, pmom*ssa*k), already weighted
            prop = kdata if prop is None else prop + kdata
        if prop is None:
            raise ValueError(f"band {self.options.name}: no attenuators")

        nprop = prop.shape[-1]
        parts = [prop[..., index.IEX:index.ISS]]
        if nprop > 2:
            pm = prop[..., index.IPM:] / (prop[..., index.ISS:index.IPM] + 1e-10)
        if nprop > 1:
            parts.append(prop[..., index.ISS:index.IPM]
                         / (prop[..., index.IEX:index.ISS] + 1e-10))
        if nprop > 2:
            parts.append(pm)
        prop = torch.cat(parts, dim=-1)

        # extinction -> optical thickness; dz (nlyr,) or (ncol, nlyr)
        dz = torch.as_tensor(dz, dtype=prop.dtype, device=prop.device)
        dz_b = dz[None, None, :, None] if dz.ndim == 1 else dz[None, :, :, None]
        tau = prop[..., index.IEX:index.ISS] * dz_b
        return torch.cat([tau, prop[..., index.ISS:]], dim=-1)

    def atm_with_spectral(self, atm: dict | None) -> dict:
        """Copy ``atm`` with this band's sample grid added as the
        attenuators' ``wavenumber`` when the caller gave neither a
        wavenumber nor a wavelength grid."""
        atm = dict(atm or {})
        if (self.options.wavenumber and "wavenumber" not in atm
                and "wavelength" not in atm):
            atm["wavenumber"] = torch.as_tensor(
                np.asarray(self.options.wavenumber), dtype=self.dtype,
                device=self.device)
        return atm

    def forward(self, conc: Tensor, dz: Tensor, bc: dict,
                atm: dict | None = None) -> Tensor:
        """Band flux ``(nwave, ncol, nlyr+1, 2)``, levels bottom-up.
        ``atm`` carries the attenuators' keyword inputs (pres, temp,
        wavelength, wavenumber)."""
        atm = self.atm_with_spectral(atm)
        prop = self.compute_optics(conc, dz, **atm)
        shared[f"radiation/{self.options.name}/optics"] = prop
        temf = (layer2level(atm["temp"], self.options.l2l)
                if "temp" in atm else None)
        return self.rtsolver.forward(prop, bc, temf)

    def band_radiance(self, conc: Tensor, dz: Tensor, bc: dict,
                      atm: dict | None = None) -> Tensor:
        """TOA radiances ``(nwave, ncol, nray)`` at the band's out-directions
        (``band.py:237-275``; the legacy solver's CalBandRadiance): the
        radiances on the deduplicated (mu, phi) grids, then each ray's value.
        A ray farther than the grids' own tolerance (``GRID_TOL``) from
        every grid point raises: the gather is exact or refused, never the
        nearest point."""
        if not isinstance(self.rtsolver, Disort):
            raise ValueError("band_radiance requires the Disort solver")
        if self.rayout.shape[0] == 0:
            raise ValueError(f"band {self.options.name}: no outdirs configured")
        atm = self.atm_with_spectral(atm)
        prop = self.compute_optics(conc, dz, **atm)
        temf = (layer2level(atm["temp"], self.options.l2l)
                if "temp" in atm else None)
        out = self.rtsolver.intensities(prop, bc, temf)
        toa = out["uu"][:, :, 0]             # (nwave, ncol, nphi, numu), TOA
        mus, phis = np.asarray(out["user_mu"]), np.asarray(out["user_phi"])
        cols = []
        for mu, phi in self.rayout:
            im, ip = np.abs(mus - mu).argmin(), np.abs(phis - phi).argmin()
            if abs(mus[im] - mu) > GRID_TOL or abs(phis[ip] - phi) > GRID_TOL:
                raise ValueError(
                    f"band {self.options.name}: ray (mu {mu:.6g}, phi "
                    f"{phi:.6g}) is not on the solver's grids (user_mu "
                    f"{tuple(mus)}, user_phi {tuple(phis)})")
            cols.append(toa[:, :, ip, im])
        return torch.stack(cols, dim=-1)

    def reduce_ck(self, flux: Tensor) -> Tensor:
        """Correlated-k quadrature: band flux = sum_g w_g flux_g."""
        w = torch.as_tensor(np.asarray(self.options.ck_weights),
                            dtype=flux.dtype, device=flux.device)
        return torch.einsum("g,g...->...", w, flux)

    @property
    def bins_are_integrated(self) -> bool:
        """True when per-bin fluxes are band-integrated already [W/m^2]:
        thermal bands with per-bin edges emit each bin's own Planck integral,
        so the band flux is a plain sum over bins.  Beam-only bands follow
        fbeam's units (spectral flux density) and integrate as
        sum(width_i F_i).  Beer-Lambert integrates Planck over each bin
        whenever the band has edges."""
        if not isinstance(self.rtsolver, Disort):
            return bool(self.options.wave_lower)
        return (self.rtsolver.options.has("planck")
                and bool(self.options.wave_lower))

    def spectral_reduce(self, flux: Tensor) -> Tensor:
        """Band flux from per-bin fluxes: g-point quadrature for ck bands,
        a plain sum of bin-integrated thermal bins, the rectangle rule
        sum(width_i F_i) for beam bands with edges, else a plain sum."""
        if self.options.ck_weights:
            return self.reduce_ck(flux)
        if self.bins_are_integrated:
            return flux.sum(dim=0)
        if self.options.wave_lower and self.options.wave_upper:
            hi, lo = (torch.as_tensor(np.asarray(e), dtype=flux.dtype,
                                      device=flux.device)
                      for e in (self.options.wave_upper,
                                self.options.wave_lower))
            return torch.einsum("g,g...->...", hi - lo, flux)
        return flux.sum(dim=0)
