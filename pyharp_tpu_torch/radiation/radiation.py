"""Radiation: the multi-band container (port of
``pyharp_tpu/radiation/radiation.py``).

* ``RadiationOptions.set_flags`` parses ``time_dependent, broad_band,
  stellar_beam, write_bin_radiance`` (unknown flags raise);
* construction builds one ``RadiationBand`` per configured band, passing
  the shared ``outdirs`` on;
* ``forward`` runs every band, reduces each over its spectral axis and sums
  the bands, with the spherical area/volume correction when geometry is
  given or on the blackboard.  ``fuse_bands=True`` solves each group of
  compatible bands as one batched ``Disort.forward`` over the concatenated
  wave axis, with the per-bin Planck edges passed as ``bc['wvnmlo'/
  'wvnmhi']``: one launch of each kernel instead of one per band;
* ``band_radiances`` / ``write_radiances``: TOA radiances at each band's
  out-directions, and their ASCII or binary tables.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch
from torch import Tensor

from ..core.device import DEFAULT_DEVICE, resolve_device
from ..interp.layer2level import layer2level
from ..rt.disort.disort import Disort
from ..tables.ascii import read_stellar_flux
from ..utils.spherical import spherical_flux_correction
from ..utils.output import write_radiance_ascii, write_radiance_bin
from .band import RadiationBand, RadiationBandOptions
from .shared import shared

_KNOWN_FLAGS = {"time_dependent", "broad_band", "stellar_beam",
                "write_bin_radiance"}


@dataclasses.dataclass(frozen=True)
class RadiationOptions:
    """Mirror of the JAX package's ``RadiationOptions``."""

    outdirs: str = ""
    time_dependent: bool = False
    broad_band: bool = False
    stellar_beam: bool = False
    write_bin_radiance: bool = False
    bands: tuple[str, ...] = ()
    band_options: tuple[RadiationBandOptions, ...] = ()

    def set_flags(self, s: str) -> "RadiationOptions":
        out = {}
        for tok in s.replace(",", " ").split():
            if tok not in _KNOWN_FLAGS:
                raise ValueError(
                    f"RadiationOptions::set_flags: flag: '{tok}' unrecognized")
            out[tok] = True
        return dataclasses.replace(self, **out)

    def replace(self, **kw) -> "RadiationOptions":
        return dataclasses.replace(self, **kw)


def _band_bc(bc, name):
    """A band's boundary inputs: ``bc[name]`` when ``bc`` is nested by band
    name, else ``bc`` itself."""
    return bc.get(name, bc) if isinstance(bc, dict) else bc


class Radiation:
    """The bands of one radiation call; tensors live on ``device``."""

    _BC_DEFAULTS = {"fbeam": 0.0, "umu0": 1.0, "albedo": 0.0, "fisot": 0.0,
                    "phi0": 0.0, "btemp": 0.0, "ttemp": 0.0, "temis": 0.0}

    def __init__(self, options: RadiationOptions,
                 dtype: torch.dtype = torch.float32,
                 device: torch.device | str = DEFAULT_DEVICE):
        if len(options.bands) != len(options.band_options):
            raise ValueError("bands and band_options must align")
        self.device = resolve_device(device)
        self.options = options
        self.dtype = dtype
        self.bands: dict[str, RadiationBand] = {}
        for name, bop in zip(options.bands, options.band_options):
            if options.outdirs:
                bop = bop.replace(outdirs=options.outdirs)
            self.bands[name] = RadiationBand(bop.replace(name=name), dtype,
                                             self.device)
        self._fused_solvers: dict = {}
        self._cached = None

    def forward(self, conc: Tensor, dz: Tensor, bc: dict,
                atm: dict | None = None, x1f: Tensor | None = None,
                area: Tensor | None = None, vol: Tensor | None = None,
                return_aux: bool = False, fuse_bands: bool = False,
                use_cache: bool = False):
        """Total band-summed flux ``(ncol, nlyr+1, 2)``, levels bottom-up.

        ``bc`` is shared by all bands or nested by band name.  Each band's
        flux is reduced by :meth:`RadiationBand.spectral_reduce`.  With
        ``return_aux``, also ``{"radiation/<band>/flux": (nwave, ncol,
        nlyr+1, 2)}``.  ``use_cache=True`` (needs the ``time_dependent``
        flag) returns the result of the previous ``forward`` without
        recomputing it.  ``fuse_bands=True`` folds compatible bands into one
        solve (:meth:`_forward_fused`); the result is the sequential one.
        """
        if use_cache:
            if not self.options.time_dependent:
                raise ValueError(
                    "use_cache requires the time_dependent flag "
                    "(RadiationOptions.set_flags('time_dependent'))")
            if self._cached is None:
                raise RuntimeError(
                    "time_dependent cache is empty: call forward() first")
            return self._cached if return_aux else self._cached[0]
        if self.options.broad_band:
            # declared by the reference's flag parser, never implemented by
            # its forward: refused rather than ignored
            raise NotImplementedError(
                "broad_band: the legacy CANOE broadband accumulation "
                "semantics are not implemented; per-band fluxes are "
                "available via forward(..., return_aux=True)")
        total = None
        aux: dict[str, Tensor] = {}
        band_fluxes = (self._forward_fused(conc, dz, bc, atm) if fuse_bands
                       else None)
        for name, band in self.bands.items():
            if band_fluxes is not None:
                flux = band_fluxes[name]
            else:
                flux = band.forward(conc, dz, _band_bc(bc, name), atm)
            aux[f"radiation/{name}/flux"] = flux          # (nwave,ncol,nlvl,2)
            bflx = band.spectral_reduce(flux)
            total = bflx if total is None else total + bflx

        if area is None and "coordinate/area1" in shared:
            area = shared["coordinate/area1"]
        if vol is None and "coordinate/vol" in shared:
            vol = shared["coordinate/vol"]
        if x1f is not None and area is not None and vol is not None:
            up = spherical_flux_correction(total[..., 0], x1f, area, vol)
            dn = spherical_flux_correction(total[..., 1], x1f, area, vol)
            total = torch.stack([up, dn], dim=-1)

        if self.options.time_dependent:
            self._cached = (total, aux)
        return (total, aux) if return_aux else total

    # -- fused multi-band execution -----------------------------------------

    @staticmethod
    def _fuse_key(band: RadiationBand):
        """Bands with equal keys share one Disort configuration up to the
        wave axis (and one level interpolation) and can be solved as one.
        A band with another solver has no key and is solved alone."""
        if not isinstance(band.rtsolver, Disort):
            return None
        o = band.rtsolver.options
        return (o.flags, o.nstr, o.nmom, o.nlyr, o.ncol, o.user_mu,
                o.user_phi, o.user_tau, o.deltam, o.accuracy, o.kernel,
                bool(band.options.wave_lower), band.options.l2l)

    def _fuse_groups(self) -> dict:
        """Fuse key -> the names of the bands that share it."""
        groups: dict = {}
        for name, band in self.bands.items():
            key = self._fuse_key(band)
            groups.setdefault(("solo", name) if key is None else key,
                              []).append(name)
        return groups

    def _forward_fused(self, conc, dz, bc, atm) -> dict[str, Tensor]:
        """One batched Disort solve per group of compatible bands.  Returns
        band name -> per-bin flux, as the sequential path gives it.  The
        band solvers of a fused group are bypassed: their ``fluxes()``
        accessor raises until their next own solve (``radiation.py:303-306``).
        """
        atm = dict(atm or {})
        out: dict[str, Tensor] = {}
        for names in self._fuse_groups().values():
            if len(names) == 1:
                name = names[0]
                out[name] = self.bands[name].forward(
                    conc, dz, _band_bc(bc, name), atm)
        for names, nws, ds, args in self._fused_problems(conc, dz, bc, atm):
            flux = ds.forward(*args)
            ofs = 0
            for name, nw in zip(names, nws):
                out[name] = flux[ofs:ofs + nw]
                ofs += nw
                self.bands[name].rtsolver.mark_bypassed()
        return out

    def _fused_problems(self, conc, dz, bc, atm):
        """Yield the batched solve of each group of two or more bands, one
        group at a time: ``(band names, their nwave, the group's Disort, the
        arguments (prop, bc, temf) of its forward)``, the band inputs
        concatenated along the wave axis."""
        atm = dict(atm or {})
        for key, names in self._fuse_groups().items():
            if len(names) == 1:
                continue
            props, nws, lows, highs, bcs = [], [], [], [], []
            for name in names:
                band = self.bands[name]
                p = band.compute_optics(conc, dz,
                                        **band.atm_with_spectral(atm))
                band_bc = _band_bc(bc, name)
                props.append(p)
                nws.append(p.shape[0])
                # per-bin edges: the caller's bc edges take precedence over
                # the options' tuples, as in Disort._band_edges
                if "wvnmlo" in band_bc:
                    lows.append(band_bc["wvnmlo"])
                    highs.append(band_bc["wvnmhi"])
                elif band.options.wave_lower:
                    lows.append(np.asarray(band.options.wave_lower))
                    highs.append(np.asarray(band.options.wave_upper))
                bcs.append((band, band_bc))

            npmax = max(p.shape[-1] for p in props)
            props = [p if p.shape[-1] == npmax else torch.nn.functional.pad(
                p, (0, npmax - p.shape[-1])) for p in props]
            prop = torch.cat(props, dim=0)
            kw = dict(dtype=prop.dtype, device=prop.device)

            fused_bc: dict[str, Tensor] = {}
            keys = set().union(*(b.keys() for _, b in bcs))
            for k in keys - {"wvnmlo", "wvnmhi"}:
                if k in ("h_lev", "radius"):
                    fused_bc[k] = self._same_geometry(k, [b for _, b in bcs])
                    continue
                default = self._BC_DEFAULTS.get(k, 0.0)
                fused_bc[k] = torch.cat([
                    torch.as_tensor(b.get(k, default), **kw).broadcast_to(
                        (nw, band0.options.ncol))
                    for (band0, b), nw in zip(bcs, nws)], dim=0)
            if lows:
                if len(lows) != len(names):
                    raise ValueError(
                        "fuse_bands: every band in a group must carry band "
                        "edges (bc wvnmlo/wvnmhi or options wave_lower) "
                        "when any does")
                fused_bc["wvnmlo"] = torch.cat(
                    [torch.as_tensor(x, **kw) for x in lows])
                fused_bc["wvnmhi"] = torch.cat(
                    [torch.as_tensor(x, **kw) for x in highs])

            ds = self._fused_solvers.get(key)
            if ds is None:
                first = self.bands[names[0]]
                ds = Disort(first.rtsolver.options.replace(
                    nwave=int(sum(nws)), wave_lower=(), wave_upper=()))
                self._fused_solvers[key] = ds

            temf = (layer2level(atm["temp"], self.bands[names[0]].options.l2l)
                    if "temp" in atm else None)
            yield names, nws, ds, (prop, fused_bc, temf)

    @staticmethod
    def _same_geometry(k: str, bcs: list[dict]):
        """``bc[k]`` of a fused group's bands, which must all give it and
        give the same values: the fused solve sees one copy."""
        vals = [b[k] for b in bcs if k in b]
        if len(vals) != len(bcs):
            raise ValueError(
                f"fuse_bands: bc[{k!r}] supplied for only {len(vals)}/"
                f"{len(bcs)} bands in a fused group; provide it for all or "
                "none (or run with fuse_bands=False)")
        first = vals[0]
        for v in vals[1:]:
            if v is first:
                continue
            a, b = torch.as_tensor(v), torch.as_tensor(first)
            if a.shape != b.shape or not torch.equal(a.to(b), b):
                raise ValueError(
                    f"fuse_bands: bc[{k!r}] differs between bands in a "
                    "fused group; per-band geometry requires "
                    "fuse_bands=False")
        return first

    # -- stellar beam --------------------------------------------------------

    def stellar_beam_bc(self, band: str, mu0, flux_file: str | None = None,
                        wave_file: str | None = None,
                        distance_au: float = 1.0, btemp: float = 5772.0,
                        lum_scale: float = 1.0) -> dict:
        """Beam boundary inputs of a band under the ``stellar_beam`` flag:
        fbeam per spectral bin from a stellar spectrum file, or a blackbody
        at ``btemp`` through the stellar solid angle at ``distance_au``,
        inverse-square scaled.  Returns ``dict(fbeam, umu0)``, float32
        ``(nwave, ncol)`` on the band solver's device, as the JAX package
        returns them."""
        b = self.bands[band]
        nw = len(b.options.wave_lower) or 1
        ncol = b.options.ncol
        if not self.options.stellar_beam:
            raise ValueError("stellar_beam flag is not set on this Radiation")
        grid = np.asarray(b.options.wavenumber
                          or [(lo + hi) / 2 for lo, hi in
                              zip(b.options.wave_lower, b.options.wave_upper)])
        if flux_file is not None:
            flux, wave = read_stellar_flux(flux_file, wave_file)
            order = np.argsort(wave)
            fb = np.interp(grid, wave[order], flux[order]) / distance_au**2
        else:
            rsun_au = 0.00465047
            omega = np.pi * (rsun_au / distance_au) ** 2
            c1 = 1.19144e-8   # 2 h c^2 [W m^-2 (cm^-1)^-3 sr^-1]
            c2 = 1.4388       # h c / k [cm K]
            fb = (lum_scale * omega * c1 * grid**3
                  / np.expm1(c2 * grid / btemp))
        kw = dict(dtype=torch.float32, device=b.device)
        fbeam = torch.as_tensor(np.asarray(fb, np.float32), **kw)
        return dict(fbeam=fbeam[:, None].expand(nw, ncol),
                    umu0=torch.as_tensor(mu0, **kw).broadcast_to((nw, ncol)))

    # -- radiances -----------------------------------------------------------

    def band_radiances(self, conc: Tensor, dz: Tensor, bc: dict,
                       atm: dict | None = None) -> dict[str, Tensor]:
        """TOA radiances of each band with out-directions
        (``radiation.py:370-389``): band name -> ``(nwave, ncol, nray)``
        (:meth:`RadiationBand.band_radiance`).  ``bc`` is shared or nested
        by band name."""
        return {name: band.band_radiance(conc, dz, _band_bc(bc, name), atm)
                for name, band in self.bands.items()
                if band.rayout.shape[0]}

    def write_radiances(self, prefix: str, conc: Tensor, dz: Tensor, bc: dict,
                        atm: dict | None = None, column: int = 0) -> list[str]:
        """Write each band's TOA radiance table of one column
        (``radiation.py:392-423``, the ``write_bin_radiance`` flag): binary
        ``<prefix><band>.out`` when the flag is set, ASCII
        ``<prefix><band>.txt`` otherwise.  Returns the paths written."""
        paths = []
        for name, rad in self.band_radiances(conc, dz, bc, atm).items():
            band = self.bands[name]
            data = rad[:, column, :].double().cpu().numpy()   # (nwave, nray)
            if self.options.write_bin_radiance:
                path = f"{prefix}{name}.out"
                write_radiance_bin(path, data, band.rayout)
            else:
                path = f"{prefix}{name}.txt"
                wave = (np.asarray(band.options.wavenumber)
                        if band.options.wavenumber else None)
                write_radiance_ascii(path, data, band.rayout, wave=wave,
                                     header=f"band {name} TOA radiance")
            paths.append(path)
        return paths
