"""Disort: options, flags, the flux solve and the radiances (PyTorch port
of ``pyharp_tpu/rt/disort/disort.py``).

``Disort.forward(prop, bc, temf)`` returns ``(nwave, ncol, nlyr+1, 2)`` level
fluxes, up and down (direct + diffuse), with **bottom-up** level order
(level 0 = surface).  ``Disort.intensities`` adds the radiances at user
angles, azimuths and depths from every azimuthal mode;
``Disort.albedo_transmissivity`` is the ``ibcnd`` special mode.  Layers are
stored bottom-up and solved top-down; the flip, and the ``(nwave, ncol) ->
B`` flattening (wave-major), happen once each, at this boundary.

The flux solve runs the kernels of ``kernels.py``:

* stage 1, per (layer, column): K1 (isotropic secular eigenstructure and
  thermal particular, plus the beam particular with a beam) when ``prop``
  has no phase moments, else K4 (Cholesky + Jacobi eigenstructure, thermal
  and beam particulars);
* the layer-coupling boundary-value problem: K2 (forward elimination), then
  for N = nstr/2 <= 4 K3 (back-substitution fused with the level-flux sums)
  and above it K5 (back-substitution) followed by the flux epilogue in
  tensor code -- the JAX package's gate (``disort.py:447``).

The radiances solve m = 0 the same way but with K2 then K5 at every N,
since the sweeps need the coefficients (a, b); the modes m >= 1 run K4 once
per mode and one K2 and one K5 for all of them, the modes folded into the
batch axis.  Which functions run, the kernels or their plain versions, is
decided before any launch by ``kernels.route``.

Everything between the kernels is plain tensor code, as it is XLA code in
the JAX package (``intensity.py`` holds the radiance sweeps).  Covered:
thermal sources, a Lambertian surface, a solar beam (plane-parallel or,
with ``spher``, pseudo-spherical), phase moments with delta-M scaling, a
``general_source``, user angles, azimuths and depths, the TMS/IMS intensity
corrections, ``ibcnd`` and the ``print-*`` diagnostics.
"""

from __future__ import annotations

import dataclasses
import math
from types import SimpleNamespace

import numpy as np
import torch
from torch import Tensor

from ...core import index
from . import intensity as _intensity
from . import kernels
from .legendre import lepoly
from .planck import planck_band, planck_total
from .solver import (LayerSolution, StaticAngles, _moment_coeffs, _umv,
                     _uwdot_static, bvp_rhs, full_operators,
                     general_particular, make_static_angles)
from .spherical import chapman_cumulative, effective_mu

_KNOWN_FLAGS = {
    "ibcnd", "usrtau", "usrang", "lamber", "planck", "spher", "onlyfl",
    "quiet", "intensity_correction", "old_intensity_correction",
    "general_source", "output_uum",
    "print-input", "print-fluxes", "print-intensity", "print-transmissivity",
    "print-phase-function",
}

# N = nstr/2 at or below which the back-substitution is fused with the flux
# sums (K3); above it K5 and the flux epilogue run (pyharp_tpu disort.py:447)
FUSED_FLUX_MAX_N = 4


@dataclasses.dataclass(frozen=True)
class DisortOptions:
    """Mirror of the JAX package's DisortOptions.

    ``kernel``: ``"auto"`` launches the CUDA kernels for float32 CUDA
    tensors and runs the plain PyTorch versions otherwise
    (``kernels.route``; float32 CUDA tensors at nstr > 64, which no kernel
    runs, raise); ``"torch"`` runs the plain versions on any
    device and dtype; ``"cuda"`` launches the kernels and raises on
    anything they cannot run.
    """

    header: str = ""
    flags: str = ""
    nwave: int = 1
    ncol: int = 1
    wave_lower: tuple[float, ...] = ()
    wave_upper: tuple[float, ...] = ()
    user_mu: tuple[float, ...] = ()
    user_phi: tuple[float, ...] = ()
    user_tau: tuple[float, ...] = ()
    nlyr: int = 1
    nstr: int = 8
    nmom: int = 8
    nphi: int = 1
    ntau: int = 1
    numu: int = 1
    deltam: bool = True
    accuracy: float = 0.0
    kernel: str = "auto"

    def replace(self, **kw) -> "DisortOptions":
        return dataclasses.replace(self, **kw)

    def flag_set(self) -> frozenset[str]:
        toks = [t for t in self.flags.replace(",", " ").split() if t]
        unknown = [t for t in toks if t not in _KNOWN_FLAGS]
        if unknown:
            raise ValueError(f"unknown disort flags: {unknown}")
        return frozenset(toks)

    def has(self, flag: str) -> bool:
        return flag in self.flag_set()


def _dither_for(dtype: torch.dtype) -> float:
    return 1e-6 if dtype == torch.float32 else 1e-12


def node_intensities(sol: LayerSolution, a: Tensor, b: Tensor,
                     ptop_p: Tensor, ptop_m: Tensor, pb_p: Tensor,
                     pb_m: Tensor):
    """Up and down intensities at the nodes on every level, ``(N, L+1, B)``
    each, top-down (``disort.py:711-722``): the layer tops, then the bottom
    of the last layer."""
    gp, gm, E = sol.gp, sol.gm, sol.expd
    up_t = _umv(gp, a) + _umv(gm, E * b) + ptop_p
    dn_t = _umv(gm, a) + _umv(gp, E * b) + ptop_m
    gpL, gmL, EL, aL, bL = gp[:, :, -1], gm[:, :, -1], E[:, -1], a[:, -1], b[:, -1]
    up_b = _umv(gpL, EL * aL) + _umv(gmL, bL) + pb_p
    dn_b = _umv(gmL, EL * aL) + _umv(gpL, bL) + pb_m
    return (torch.cat([up_t, up_b[:, None]], dim=1),
            torch.cat([dn_t, dn_b[:, None]], dim=1))


def flux_epilogue(sol: LayerSolution, a: Tensor, b: Tensor, ptop_p: Tensor,
                  ptop_m: Tensor, pb_p: Tensor, pb_m: Tensor,
                  ang: StaticAngles):
    """Level-flux sums from the BVP coefficients (``disort.py:711-725``):
    ``(fl, fl_bot)``, the wmu-weighted up/down intensity sums at every layer
    top ``(2, L, B)`` and at the bottom level ``(2, B)``; K3's outputs."""
    wmu = ang.w * ang.mu
    up, dn = node_intensities(sol, a, b, ptop_p, ptop_m, pb_p, pb_m)
    fl = torch.stack([_uwdot_static(wmu, up), _uwdot_static(wmu, dn)])
    return fl[:, :-1], fl[:, -1]


class Disort:
    """Batched plane-parallel discrete-ordinates solver: fluxes, and
    radiances at user angles from every azimuthal mode.

    The instance holds the options and the static angle tables; the
    numbers flow through ``forward`` and ``intensities``.  The accessors
    ``fluxes()`` and ``gather_rad()`` return the last call's results.
    """

    # the last forward ran through Radiation.forward(fuse_bands=True), which
    # bypassed this solver
    _BYPASSED = object()

    def __init__(self, options: DisortOptions):
        fl = options.flag_set()
        if options.nstr < 2 or options.nstr % 2:
            raise ValueError("nstr must be even and >= 2")
        if options.kernel not in kernels.KERNEL_CHOICES:
            raise ValueError(f"kernel must be one of {kernels.KERNEL_CHOICES}"
                             f", got {options.kernel!r}")
        self.options = options
        self._flags = fl
        self.nstr = options.nstr
        self.nmom = max(options.nmom, options.nstr)
        self._ang0: StaticAngles = make_static_angles(self.nstr, self.nmom, 0)
        self._angs: dict[int, StaticAngles] = {0: self._ang0}
        wl, wu = options.wave_lower, options.wave_upper
        self._wave_edges = ((np.asarray(wl, np.float64),
                             np.asarray(wu, np.float64)) if wl and wu else None)
        self._last = None
        self._rad = None

    def _angles(self, m: int) -> StaticAngles:
        """The static angle tables of mode m."""
        if m not in self._angs:
            self._angs[m] = make_static_angles(self.nstr, self.nmom, m)
        return self._angs[m]

    # -- preparation --------------------------------------------------------

    def _band_edges(self, dtype, device, bc: dict):
        """Per-bin band edges ``(nwave,)``: ``bc['wvnmlo'/'wvnmhi']`` take
        precedence over the options' tuples (``disort.py:136-145``); a fused
        multi-band solve passes the concatenated edges of its bands so."""
        if "wvnmlo" in bc or "wvnmhi" in bc:
            if "wvnmlo" not in bc or "wvnmhi" not in bc:
                raise ValueError("bc needs both 'wvnmlo' and 'wvnmhi'")
            return (torch.as_tensor(bc["wvnmlo"], dtype=dtype, device=device),
                    torch.as_tensor(bc["wvnmhi"], dtype=dtype, device=device))
        if self._wave_edges is None:
            return None, None
        return tuple(torch.as_tensor(e, dtype=dtype, device=device)
                     for e in self._wave_edges)

    def _prepare(self, prop: Tensor, bc: dict, temf: Tensor | None) -> dict:
        """Batch-last ``(L, B)`` top-down inputs of the solve: delta-M scaled
        optical properties (and the unscaled ones the radiances read), slant
        beam depths, sources, boundary terms."""
        dtype, device = prop.dtype, prop.device
        nwave, ncol, nlyr, nprop = prop.shape
        B, L = nwave * ncol, nlyr

        P = prop.reshape(B, nlyr, nprop).permute(1, 2, 0).flip(0)  # (L, nprop, B)
        tau = P[:, index.IEX].clamp_min(0.0)
        ssa = (P[:, index.ISS].clamp(0.0, 1.0) if nprop > 1
               else torch.zeros_like(tau))
        pmom = P[:, index.IPM:]                                    # (L, nmom, B)

        def bc_get(name, default):
            v = torch.as_tensor(bc.get(name, default), dtype=dtype, device=device)
            return v.broadcast_to((nwave, ncol)).reshape(B)

        has_beam = "fbeam" in bc
        fbeam = bc_get("fbeam", 0.0)
        umu0 = bc_get("umu0", 1.0)
        albedo = bc_get("albedo", 0.0)
        fisot = bc_get("fisot", 0.0)
        phi0 = bc_get("phi0", 0.0)

        # delta-M scaling (the identity without moments)
        if self.options.deltam and pmom.shape[1] >= self.nstr:
            f = pmom[:, self.nstr - 1]
        else:
            f = torch.zeros_like(tau)
        tau_s = (1.0 - ssa * f) * tau
        ssa_s = ssa * (1.0 - f) / (1.0 - ssa * f)
        if pmom.shape[1] > 0:
            pmom_s = (pmom - f[:, None]) / (1.0 - f[:, None])
        else:
            pmom_s = pmom
        ssa_s = ssa_s.clamp(0.0, 1.0 - _dither_for(dtype))

        zeros1 = torch.zeros((1, B), dtype=dtype, device=device)
        taucum_s = torch.cat([zeros1, torch.cumsum(tau_s, dim=0)], dim=0)
        taucum_u = torch.cat([zeros1, torch.cumsum(tau, dim=0)], dim=0)
        dtau = taucum_s[1:] - taucum_s[:-1]

        # direct-beam slant depths, on the delta-M scaled depth (the solve)
        # and on the unscaled one (the direct beam reported, disort.py:727):
        # tau/mu0, or Chapman paths under spher
        chtau_s = chtau_u = mu_eff = None
        if has_beam and self.options.has("spher"):
            if "h_lev" not in bc or "radius" not in bc:
                raise ValueError(
                    "spher flag requires bc['h_lev'] (ncol, nlyr+1) level "
                    "altitudes and bc['radius'] planetary radius")
            hlev = torch.as_tensor(bc["h_lev"], dtype=dtype, device=device)
            hlev = hlev.flip(-1).T[:, None, :].expand(L + 1, nwave, ncol)
            hlev = hlev.reshape(L + 1, B)
            radius = bc_get("radius", 0.0)
            chtau_s = chapman_cumulative(tau_s, hlev, radius, umu0)
            chtau_u = chapman_cumulative(tau, hlev, radius, umu0)
            mu_eff = effective_mu(tau_s, chtau_s)
        elif has_beam:
            chtau_s = taucum_s / umu0[None]
            chtau_u = taucum_u / umu0[None]

        # general (user) source at the quadrature angles, constant per layer:
        # (nwave, ncol, nlyr, nstr) = [q+ at mu.., q- at mu..], bottom-up
        gensrc = None
        if self.options.has("general_source") != ("gensrc" in bc):
            if self.options.has("general_source"):
                raise ValueError("general_source flag requires bc['gensrc'] "
                                 "(nwave, ncol, nlyr, nstr)")
            raise ValueError("bc['gensrc'] supplied without the general_source "
                             "flag")
        if "gensrc" in bc:
            gs = torch.as_tensor(bc["gensrc"], dtype=dtype, device=device)
            if tuple(gs.shape) != (nwave, ncol, nlyr, self.nstr):
                raise ValueError("gensrc must be (nwave, ncol, nlyr, nstr), "
                                 f"got {tuple(gs.shape)}")
            gs = gs.reshape(B, nlyr, self.nstr).permute(2, 1, 0).flip(1)
            N = self.nstr // 2
            gensrc = (gs[:N], gs[N:])

        if self.options.has("planck"):
            if temf is None:
                raise ValueError("planck flag requires temf level temperatures")
            btemp = bc_get("btemp", 0.0).reshape(nwave, ncol)
            # temf (ncol, nlvl) bottom-up -> (nlvl, ncol) top-down
            tlev = torch.as_tensor(temf, dtype=dtype, device=device).flip(-1).T
            wnlo, wnhi = self._band_edges(dtype, device, bc)
            if wnlo is None:
                planck = planck_total
                blev = planck(tlev)[:, None, :].expand(L + 1, nwave, ncol)
            else:
                def planck(t):
                    return planck_band(t, wnlo[:, None], wnhi[:, None])
                blev = planck(tlev[:, None, :])
            blev = blev.reshape(L + 1, B)
            bsurf = planck(btemp).reshape(B)
            # top emission: temis * B(ttemp), both 0 by default
            if "temis" in bc:
                btop = (bc_get("temis", 0.0)
                        * planck(bc_get("ttemp", 0.0).reshape(nwave, ncol)
                                 ).reshape(B))
            else:
                btop = torch.zeros((B,), dtype=dtype, device=device)
            b_top_lay = blev[:-1]
            slope = torch.where(dtau > 1e-20,
                                (blev[1:] - b_top_lay) / dtau.clamp_min(1e-20),
                                torch.zeros_like(dtau))
        else:
            bsurf = torch.zeros((B,), dtype=dtype, device=device)
            btop = torch.zeros((B,), dtype=dtype, device=device)
            b_top_lay = torch.zeros_like(tau)
            slope = torch.zeros_like(tau)

        return dict(nwave=nwave, ncol=ncol, L=L, B=B, has_beam=has_beam,
                    tau=tau, ssa=ssa, pmom=pmom, f_dm=f,
                    ssa_s=ssa_s.contiguous(), pmom_s=pmom_s.contiguous(),
                    dtau=dtau.contiguous(), taucum_s=taucum_s,
                    taucum_u=taucum_u, b_top_lay=b_top_lay.contiguous(),
                    slope=slope.contiguous(), albedo=albedo.contiguous(),
                    fbeam=fbeam.contiguous(), umu0=umu0, fisot=fisot,
                    phi0=phi0, bsurf=bsurf, btop=btop, chtau_s=chtau_s,
                    chtau_u=chtau_u, mu_eff=mu_eff, gensrc=gensrc)

    # -- the quadrature solve of one mode -------------------------------------

    def _kernels(self, device: torch.device, dtype: torch.dtype
                 ) -> SimpleNamespace:
        """The kernel wrappers, or their plain versions, as ``kernels.route``
        picks them for these tensors; ``.route`` names the choice."""
        names = ("stage1_isotropic", "stage1_isotropic_beam", "stage1_general",
                 "bvp_forward", "bvp_backward_flux", "bvp_backward")
        how = kernels.route(self.options.kernel, device.type, dtype,
                            self.nstr // 2)
        suffix = "_plain" if how == "torch" else ""
        return SimpleNamespace(route=how, **{n: getattr(kernels, n + suffix)
                                             for n in names})

    def _beam_cosine(self, pr: dict) -> Tensor:
        """The beam's decay cosine per layer ``(L, B)``: mu0, or the
        pseudo-spherical effective cosine under ``spher``."""
        mur = (pr["mu_eff"] if pr["mu_eff"] is not None
               else pr["umu0"][None].expand(pr["L"], pr["B"]))
        return mur.contiguous()

    def _solve_mode(self, pr: dict, flux_only: bool = True) -> dict:
        """Eigenstructure, particular solution and BVP of the m = 0 mode.

        With ``flux_only`` (``forward``) the back-substitution gives the
        level-flux sums: K3 for N <= ``FUSED_FLUX_MAX_N``, else K5 and the
        flux epilogue.  Without it (the radiances) K5 gives the
        coefficients (a, b) at every N, as the JAX package's Pallas path
        does (``disort.py:447-456``)."""
        ang = self._ang0
        N = self.nstr // 2
        B, L = pr["B"], pr["L"]
        k = self._kernels(pr["ssa_s"].device, pr["ssa_s"].dtype)
        has_beam = pr["has_beam"]
        dtau = pr["dtau"]
        stage1_in = (pr["ssa_s"], dtau, pr["b_top_lay"], pr["slope"])

        md = dict(route=k.route)
        if has_beam:
            md["mur"] = self._beam_cosine(pr)
        if pr["pmom_s"].shape[1] == 0:
            if has_beam:
                out = k.stage1_isotropic_beam(*stage1_in, pr["fbeam"],
                                              md["mur"], ang)
            else:
                out = k.stage1_isotropic(*stage1_in, ang)
        else:
            beam_kw = {}
            if has_beam:
                md["lam0"] = lepoly(pr["umu0"], 0,
                                    ang.lam_tables.shape[0] - 1).contiguous()
                beam_kw = dict(fbeam=pr["fbeam"], mur=md["mur"],
                               lam0=md["lam0"])
            # without planck the thermal particular is exactly zero
            out = k.stage1_general(pr["ssa_s"], pr["pmom_s"], *stage1_in[1:],
                                   ang, thermal=self.options.has("planck"),
                                   **beam_kw)
        gp, gm, lam, expd, y0p, y0m, y1 = out[:7]
        sol = LayerSolution(lam, gp, gm, expd)

        if pr["gensrc"] is not None:
            V, U = full_operators(pr["ssa_s"], pr["pmom_s"], ang)
            ygp, ygm = general_particular(V, U, *pr["gensrc"])
            y0p = y0p + ygp
            y0m = y0m + ygm

        zp = zm = None
        if has_beam:
            zp, zm = out[7:]
            chtau_s = pr["chtau_s"]
            att_top = torch.exp(-chtau_s[:-1])[None]
            att_bot = torch.exp(-chtau_s[1:])[None]
            ptop_p = zp * att_top + y0p
            ptop_m = zm * att_top + y0m
            pbot_p = zp * att_bot + y0p + y1 * dtau[None]
            pbot_m = zm * att_bot + y0m + y1 * dtau[None]
        else:
            ptop_p, ptop_m = y0p, y0m
            pbot_p = y0p + y1 * dtau[None]
            pbot_m = y0m + y1 * dtau[None]
        pb_p, pb_m = pbot_p[:, -1].contiguous(), pbot_m[:, -1].contiguous()

        wmu = ang.w * ang.mu
        albedo = pr["albedo"]
        ftop = (pr["fisot"] + pr["btop"])[None].expand(N, B)
        emit = (1.0 - albedo) * pr["bsurf"]
        refl = 2.0 * albedo * _uwdot_static(wmu, pb_m)
        if has_beam:
            direct_refl = (albedo / math.pi * pr["umu0"] * pr["fbeam"]
                           * torch.exp(-pr["chtau_s"][-1]))
            bot_rhs = (direct_refl + emit + refl)[None] - pb_p
        else:
            bot_rhs = (emit + refl)[None] - pb_p
        dblk = bvp_rhs(ptop_p, ptop_m, pbot_p, pbot_m, ftop, bot_rhs)

        P, g = k.bvp_forward(gp, gm, expd, dblk, albedo, ang)
        ptop_p, ptop_m = ptop_p.contiguous(), ptop_m.contiguous()
        if flux_only and N <= FUSED_FLUX_MAX_N:
            md["fl"], md["fl_bot"] = k.bvp_backward_flux(
                gp, gm, expd, P, g, ptop_p, ptop_m, pb_p, pb_m, ang)
        else:
            md["a"], md["b"] = k.bvp_backward(gp, gm, expd, P, g, ang)
            if flux_only:
                md["fl"], md["fl_bot"] = flux_epilogue(
                    sol, md["a"], md["b"], ptop_p, ptop_m, pb_p, pb_m, ang)
        md.update(sol=sol, dblk=dblk, P=P, g=g, ptop_p=ptop_p,
                  ptop_m=ptop_m, pb_p=pb_p, pb_m=pb_m, zp=zp, zm=zm,
                  y0p=y0p, y0m=y0m, y1=y1)
        return md

    def _fluxes_from_mode0(self, pr: dict, md: dict):
        """Level fluxes ``(nwave, ncol, nlvl, 2)`` (levels bottom-up) and the
        record the accessors read (``disort.py:686-749``): top-down flup,
        rfldn (diffuse down) and rfldir (the direct beam on the unscaled
        slant depth), and, from (a, b), the node intensities on every
        level."""
        nwave, ncol, L = pr["nwave"], pr["ncol"], pr["L"]
        up_all = dn_all = None
        if "fl" in md:
            fl, fl_bot = md["fl"], md["fl_bot"]
            flup = 2.0 * math.pi * torch.cat([fl[0], fl_bot[0][None]], dim=0)
            fldn = 2.0 * math.pi * torch.cat([fl[1], fl_bot[1][None]], dim=0)
        else:
            up_all, dn_all = node_intensities(
                md["sol"], md["a"], md["b"], md["ptop_p"], md["ptop_m"],
                md["pb_p"], md["pb_m"])
            wmu = self._ang0.w * self._ang0.mu
            flup = 2.0 * math.pi * _uwdot_static(wmu, up_all)
            fldn = 2.0 * math.pi * _uwdot_static(wmu, dn_all)
        if pr["has_beam"]:
            # total down = diffuse + the direct beam on the delta-M scaled
            # slant depth; the direct beam is reported on the unscaled one
            # and the difference is diffuse (disort.py:727-737)
            f0 = (pr["umu0"] * pr["fbeam"])[None]
            rfldir = f0 * torch.exp(-pr["chtau_u"])
            fldn = fldn + f0 * torch.exp(-pr["chtau_s"])
        else:
            rfldir = torch.zeros_like(flup)
        last = dict(a=md.get("a"), b=md.get("b"), sol=md["sol"],
                    taucum_s=pr["taucum_s"], taucum_u=pr["taucum_u"],
                    flup=flup, rfldn=fldn - rfldir, rfldir=rfldir,
                    up_all=up_all, dn_all=dn_all)
        # (L+1, B) pair -> (nwave, ncol, nlvl, 2), levels bottom-up
        flux = torch.stack([flup, fldn], dim=-1).permute(1, 0, 2)
        return flux.reshape(nwave, ncol, L + 1, 2).flip(-2), last

    # -- main entry -------------------------------------------------------------

    def forward(self, prop: Tensor, bc: dict, temf: Tensor | None = None) -> Tensor:
        """Solve every (wave, col) problem; return level fluxes.

        Args:
          prop: ``(nwave, ncol, nlyr, nprop)`` bottom-up optical properties:
            ``[..., 0]`` layer optical thickness, ``[..., 1]``
            single-scattering albedo (optional), ``[..., 2:]`` phase moments
            g_1.. (optional).
          bc: boundary values broadcastable to ``(nwave, ncol)``:
            ``fbeam, umu0, albedo, btemp`` (+ ``ttemp, temis, fisot,
            phi0``); with ``spher``, ``h_lev`` ``(ncol, nlyr+1)`` and
            ``radius``; with ``general_source``, ``gensrc`` ``(nwave, ncol,
            nlyr, nstr)``.
          temf: level temperatures ``(ncol, nlyr+1)`` bottom-up (required
            with the ``planck`` flag).

        Returns:
          ``(nwave, ncol, nlyr+1, 2)`` upward and total (direct + diffuse)
          downward flux, levels bottom-up.
        """
        if "ibcnd" in self._flags:
            raise ValueError(
                "ibcnd (albedo/transmissivity special mode) is not a flux "
                "solve; call albedo_transmissivity(prop, albedo) instead")
        pr = self._prepare(prop, bc, temf)
        md = self._solve_mode(pr)
        flux, self._last = self._fluxes_from_mode0(pr, md)
        self._maybe_print(pr, flux)
        return flux

    # -- the print-* diagnostics --------------------------------------------

    def _maybe_print(self, pr: dict, flux: Tensor) -> None:
        """The tables of the ``print-input``, ``print-phase-function`` and
        ``print-fluxes`` flags, for wave 0, column 0 (``disort.py:636-684``;
        cdisort prints them from c_disort)."""
        if not self._flags & {"print-input", "print-fluxes",
                              "print-phase-function"}:
            return
        opts = self.options
        hdr = opts.header or "DISORT"
        if "print-input" in self._flags:
            print(f"\n{hdr}: input (wave 0, col 0); nlyr={opts.nlyr} "
                  f"nstr={self.nstr} nmom={self.nmom}")
            tau0 = pr["tau"][:, 0].tolist()
            ssa0 = pr["ssa"][:, 0].tolist()
            print(" layer       dtauc       ssalb   (top-down)")
            for l, (t, w) in enumerate(zip(tau0, ssa0)):
                print(f"{l + 1:6d} {t:12.5e} {w:11.5f}")
        if "print-phase-function" in self._flags:
            pm0 = pr["pmom"][:, :, 0].tolist()            # (L, nmom)
            print(f"\n{hdr}: phase moments g_1..g_{pr['pmom'].shape[1]} "
                  "(wave 0, col 0, top-down)")
            for l, row in enumerate(pm0):
                vals = " ".join(f"{v:9.5f}" for v in row[:8])
                print(f"{l + 1:6d} {vals}")
        if "print-fluxes" in self._flags:
            f0 = flux[0, 0].tolist()                      # (nlvl, 2) bottom-up
            rfldir = self._last["rfldir"][:, 0].tolist()
            print(f"\n{hdr}: fluxes (wave 0, col 0)")
            print(" level      direct     diffuse-down    flux-up  "
                  "(level 0 = TOA)")
            nlvl = len(f0)
            for i in range(nlvl):
                b = nlvl - 1 - i                          # bottom-up index
                print(f"{i:6d} {rfldir[i]:12.5e} {f0[b][1] - rfldir[i]:14.5e} "
                      f"{f0[b][0]:12.5e}")

    # -- radiances -----------------------------------------------------------

    def _modes_batched(self, pr: dict) -> dict | None:
        """The quadrature solves of the modes m = 1..nstr-1
        (``disort.py:468-596``).

        These modes have no thermal source, no incident radiation and no
        surface reflection (a Lambertian surface reflects only m = 0), so
        their BVP has zero albedo, zero ``ftop`` and ``bot_rhs = -pbot_p``
        on the m = 0 quadrature: K2's and K5's contract.  Stage 1 runs once
        per mode (K4 with the mode's tables, no thermal source, the beam
        source Lam_l^m(mu0) and prefactor 2/(4 pi)); the BVP runs once for
        all modes, folded into the batch axis as B' = (nstr - 1) B.

        Without a beam, or without phase moments, every source of these
        modes vanishes and so do their radiances: returns None.  Else a
        dict of ``ms``, the mode-leading ``(nm, N[, N], L, B)`` ``gp, gm,
        lam, expd, zp, zm, a, b``, ``lam0`` ``(nm, G, B)`` and ``mur``, and
        the folded BVP inputs ``fold = (gp, gm, expd, dblk, albedo)``."""
        if not pr["has_beam"] or pr["pmom_s"].shape[1] == 0:
            return None
        ang0 = self._ang0
        L, B = pr["L"], pr["B"]
        N = self.nstr // 2
        ms = list(range(1, self.nstr))
        nm = len(ms)
        k = self._kernels(pr["ssa_s"].device, pr["ssa_s"].dtype)
        mur = self._beam_cosine(pr)
        zero = torch.zeros_like(pr["ssa_s"])
        G = ang0.lam_tables.shape[0]
        lam0s = [lepoly(pr["umu0"], m, G - 1).contiguous() for m in ms]
        angs = [self._angles(m) for m in ms]
        if k.route == "torch":
            # the plain version over all modes in one pass (the same bits)
            outs = kernels.stage1_general_modes_plain(
                pr["ssa_s"], pr["pmom_s"], pr["dtau"], angs,
                fbeam=pr["fbeam"], mur=mur, lam0s=lam0s)
        else:
            outs = [k.stage1_general(pr["ssa_s"], pr["pmom_s"], pr["dtau"],
                                     zero, zero, a, thermal=False,
                                     fbeam=pr["fbeam"], mur=mur, lam0=l0)
                    for a, l0 in zip(angs, lam0s)]
        # (..., L, nm, B): the modes next to the batch axis, so that the
        # folded (..., L, nm * B) is a view
        gp, gm, lam, expd, zp, zm = (torch.stack([o[i] for o in outs], dim=-2)
                                     for i in (0, 1, 2, 3, 7, 8))

        def fold(x):
            return x.reshape(x.shape[:-2] + (nm * B,))

        att_top = torch.exp(-pr["chtau_s"][:-1])[:, None]
        att_bot = torch.exp(-pr["chtau_s"][1:])[:, None]
        pbot_p = fold(zp * att_bot)
        dblk = bvp_rhs(fold(zp * att_top), fold(zm * att_top), pbot_p,
                       fold(zm * att_bot), zero.new_zeros((N, nm * B)),
                       -pbot_p[:, -1])
        alb = zero.new_zeros((nm * B,))
        fgp, fgm, fexpd = fold(gp), fold(gm), fold(expd)
        P, g = k.bvp_forward(fgp, fgm, fexpd, dblk, alb, ang0)
        a, b = k.bvp_backward(fgp, fgm, fexpd, P, g, ang0)

        def lead(x):        # (..., L, nm * B) -> (nm, ..., L, B)
            x = x.reshape(x.shape[:-1] + (nm, B))
            return x.movedim(-2, 0)

        return dict(ms=ms, gp=gp.movedim(-2, 0), gm=gm.movedim(-2, 0),
                    lam=lam.movedim(-2, 0), expd=expd.movedim(-2, 0),
                    zp=zp.movedim(-2, 0), zm=zm.movedim(-2, 0), a=lead(a),
                    b=lead(b), lam0=torch.stack(lam0s), mur=mur,
                    fold=(fgp, fgm, fexpd, dblk, alb), N=N)

    def _user_taus(self, pr: dict):
        """The user taus (unscaled cumulative depths) bracketed once: layer
        ``il``, the unscaled and the delta-M scaled depth below its top,
        ``(T, B)`` each, and the depths ``(T,)`` (``disort.py:811-832``); the
        evaluation in each layer is then exact, not a blend of levels."""
        taus = np.asarray(self.options.user_tau, np.float64)
        taucum_u, taucum_s = pr["taucum_u"], pr["taucum_s"]
        L = pr["L"]
        tq = torch.as_tensor(taus, dtype=taucum_u.dtype,
                             device=taucum_u.device)[:, None]      # (T, 1)
        il = ((taucum_u[:-1][None] <= tq[:, None]).sum(dim=1) - 1
              ).clamp(0, L - 1)                                    # (T, B)
        dtu = taucum_u[1:] - taucum_u[:-1]
        dts = taucum_s[1:] - taucum_s[:-1]
        t0 = taucum_u.gather(0, il)
        du = dtu.gather(0, il)
        x_u = torch.minimum((tq - t0).clamp_min(0.0), du)
        # delta-M rescales depth linearly within each layer
        pos = du > 0
        scale = torch.where(pos, dts.gather(0, il)
                            / torch.where(pos, du, torch.ones_like(du)),
                            torch.zeros_like(du))
        return il, x_u, x_u * scale, taus

    def intensities(self, prop: Tensor, bc: dict,
                    temf: Tensor | None = None) -> dict:
        """Fluxes plus radiances at user angles, azimuths and depths
        (``disort.py:753-995``), from every azimuthal mode:

            u(tau, mu, phi) = sum_m u^m(tau, mu) cos(m (phi0 - phi)).

        Angles come from ``options.user_mu`` (signed, > 0 up, DISORT's UMU
        convention) or default to the quadrature angles; azimuths from
        ``options.user_phi`` (default 0); depths from ``options.user_tau``
        (cumulative unscaled optical depth, top-down) or default to every
        level.  Arguments as :meth:`forward`.

        Returns a dict with ``flux`` (as :meth:`forward`), ``uu`` ``(nwave,
        ncol, ntau, nphi, numu)``, ``uum`` ``(nmode, nwave, ncol, ntau,
        numu)`` (cdisort's ``output_uum``), ``user_mu`` and ``user_phi``.
        """
        pr = self._prepare(prop, bc, temf)
        md = self._solve_mode(pr, flux_only=False)
        return self._radiances(pr, md, self._modes_batched(pr))

    def _radiances(self, pr: dict, md: dict, modes: dict | None) -> dict:
        """Everything of :meth:`intensities` after the quadrature solves:
        fluxes, the sweeps of every mode at the user angles and taus, the
        azimuthal sum and the intensity corrections."""
        dtype, device = pr["ssa_s"].dtype, pr["ssa_s"].device
        nwave, ncol, L, B = pr["nwave"], pr["ncol"], pr["L"], pr["B"]
        kw = dict(dtype=dtype, device=device)
        ang = self._ang0
        flux, self._last = self._fluxes_from_mode0(pr, md)

        if pr["has_beam"]:
            beam_top = torch.exp(-pr["chtau_s"][:-1])
            mu_beam = self._beam_cosine(pr)
        else:
            beam_top = torch.zeros((L, B), **kw)
            mu_beam = torch.ones((L, B), **kw)

        user_mu = list(self.options.user_mu)
        if not user_mu:
            user_mu = [-m for m in reversed(ang.mu)] + list(ang.mu)
        user_mu = [float(m) for m in user_mu]
        user_phi = [float(p) for p in self.options.user_phi] or [0.0]
        tau_sel = self._user_taus(pr) if self.options.user_tau else None
        ups = [m for m in user_mu if m > 0]
        downs = [m for m in user_mu if m < 0]

        # boundary intensities of the m = 0 sweeps
        wmu = ang.w * ang.mu
        dn_flux = 2.0 * math.pi * _uwdot_static(wmu, self._last["dn_all"][:, -1])
        dir_flux = (pr["umu0"] * pr["fbeam"] * torch.exp(-pr["chtau_s"][-1])
                    if pr["has_beam"] else torch.zeros((B,), **kw))
        surf_int = (pr["albedo"] / math.pi * (dn_flux + dir_flux)
                    + (1.0 - pr["albedo"]) * pr["bsurf"])
        top_int = pr["fisot"] + pr["btop"]

        g = _moment_coeffs(pr["ssa_s"], pr["pmom_s"], ang)     # (L, G, B)
        G = g.shape[1]
        dt = pr["dtau"]
        sol = md["sol"]
        thermal = None
        if self.options.has("planck") or pr["gensrc"] is not None:
            thermal = (md["y0p"], md["y0m"], md["y1"], pr["b_top_lay"],
                       pr["slope"])
        sets = [dict(angs=[ang], gp=sol.gp[None], gm=sol.gm[None],
                     lam=sol.lam[None], expd=sol.expd[None], a=md["a"][None],
                     b=md["b"][None], thermal=thermal, bounds=(surf_int,
                                                               top_int))]
        if pr["has_beam"]:
            sets[0].update(zp=md["zp"][None], zm=md["zm"][None],
                           lam0=lepoly(pr["umu0"], 0, G - 1)[None])
        if modes is not None:
            sets.append(dict(angs=[self._angles(m) for m in modes["ms"]],
                             thermal=None, bounds=(None, None),
                             **{k: modes[k] for k in ("gp", "gm", "lam",
                                                      "expd", "a", "b", "zp",
                                                      "zm", "lam0")}))

        # per set and hemisphere: (nm, M, L+1 or T, B)
        nmode = self.nstr
        ntau = L + 1 if tau_sel is None else len(tau_sel[3])
        uum = torch.zeros((nmode, len(user_mu), ntau, B), **kw)
        for si, st in enumerate(sets):
            for mus, up, bval in ((ups, True, st["bounds"][0]),
                                  (downs, False, st["bounds"][1])):
                if not mus:
                    continue
                coeffs = _intensity.source_coeffs(
                    mus, st["angs"], st["gp"], st["gm"], g, pr["ssa_s"],
                    zp=st.get("zp"), zm=st.get("zm"), fbeam=pr["fbeam"],
                    lam0=st.get("lam0"), thermal=st["thermal"])
                sweep = (st["a"], st["b"], coeffs, st["lam"], st["expd"], dt,
                         beam_top, mu_beam)
                lv = _intensity.sweep_intensity(mus, up, *sweep, bval)
                if tau_sel is not None:
                    lv = _intensity.partial_sweep_at_tau(
                        mus, up, *sweep, lv, tau_sel[0], tau_sel[2])
                rows = [user_mu.index(mu) for mu in mus]
                m0 = 0 if si == 0 else 1
                uum[m0:m0 + lv.shape[0], rows] = lv

        # azimuthal sum (+ the Nakajima-Tanaka intensity corrections)
        phi = torch.as_tensor(user_phi, **kw)
        mvec = torch.arange(nmode, **kw)
        cosm = torch.cos(mvec[:, None, None]
                         * (pr["phi0"][None, None] - phi[None, :, None]))
        uu = torch.einsum("mpb,mutb->putb", cosm, uum)  # (nphi, numu, ntau, B)
        corrections = (("intensity_correction" in self._flags
                        or "old_intensity_correction" in self._flags)
                       and self.options.deltam and pr["pmom"].shape[1] > 0
                       and pr["has_beam"])
        if corrections:
            uu = uu + self._corrections(pr, user_mu, user_phi, tau_sel,
                                        beam_top, mu_beam)
        uu = uu.permute(3, 2, 0, 1).reshape(nwave, ncol, ntau, len(user_phi),
                                            len(user_mu))
        uum_out = uum.permute(0, 3, 2, 1).reshape(nmode, nwave, ncol, ntau,
                                                  len(user_mu))
        self._rad = uu
        self._maybe_print(pr, flux)
        if "print-intensity" in self._flags:
            hdr = self.options.header or "DISORT"
            u0 = uu[0, 0].tolist()                        # (ntau, nphi, numu)
            print(f"\n{hdr}: intensities (wave 0, col 0); "
                  f"umu={tuple(user_mu)} phi={tuple(user_phi)}")
            for it, row in enumerate(u0):
                for ip, vals in enumerate(row):
                    print(f" tau[{it}] phi[{ip}]: "
                          + " ".join(f"{v:12.5e}" for v in vals))
        return dict(flux=flux, uu=uu, uum=uum_out, user_mu=tuple(user_mu),
                    user_phi=tuple(user_phi))

    def _corrections(self, pr, user_mu, user_phi, tau_sel, beam_top,
                     mu_beam) -> Tensor:
        """TMS for every direction, minus IMS for the downward ones
        (``disort.py:924-970``): ``(nphi, numu, ntau, B)``.  TMS replaces
        the truncated single scattering by the exact-phase one; IMS removes
        the over-counted secondary scattering of the delta-M spike.  IMS
        stays plane-parallel under ``spher``, as in the JAX package."""
        L, B = pr["L"], pr["B"]
        ones = torch.ones((L, 1, B), dtype=pr["ssa"].dtype,
                          device=pr["ssa"].device)
        g_uns = torch.cat([ones, pr["pmom"]], dim=1)
        g_scl = torch.cat([ones, pr["pmom_s"]], dim=1)
        beam = (pr["fbeam"], pr["umu0"], pr["phi0"])
        ntau = L + 1 if tau_sel is None else len(tau_sel[3])
        corr = torch.zeros((len(user_phi), len(user_mu), ntau, B),
                           dtype=g_uns.dtype, device=g_uns.device)
        for up in (True, False):
            rows = [i for i, mu in enumerate(user_mu) if (mu > 0) == up]
            if not rows:
                continue
            mus = [user_mu[i] for i in rows for _ in user_phi]
            phis = [p for _ in rows for p in user_phi]
            c = _intensity.tms_correction(
                mus, phis, g_uns, g_scl, pr["ssa"], pr["ssa_s"], pr["f_dm"],
                self.nstr, pr["taucum_s"], *beam, beam_top=beam_top,
                mu_beam=mu_beam,
                at_taus=None if tau_sel is None else (tau_sel[0], tau_sel[2]))
            if not up:
                c = c - _intensity.ims_correction(
                    mus, phis, g_uns, pr["ssa"], pr["f_dm"], pr["tau"],
                    pr["taucum_u"], self.nstr, *beam,
                    at_taus=None if tau_sel is None
                    else (tau_sel[0], tau_sel[1], tau_sel[3]))
            c = c.reshape(len(rows), len(user_phi), ntau, B).transpose(0, 1)
            corr[:, rows] = c
        return corr

    def albedo_transmissivity(self, prop: Tensor, albedo=0.0) -> dict:
        """Albedo and transmissivity of the whole medium (DISORT's IBCND=1,
        ``disort.py:997-1055``): ``albmed(mu)`` and ``trnmed(mu)`` for a unit
        beam incident at each ``options.user_mu`` (all > 0), each ``(nwave,
        ncol, numu)``.

        One solve with unit isotropic illumination from the top (``fisot =
        1``), then reciprocity: the upward TOA radiance at mu under it is the
        plane albedo for a beam incident at mu, and the downward bottom
        radiance the total transmissivity (the unscattered e^{-tau/mu} is in
        the sweep's boundary term), as cdisort's c_albtrans uses."""
        user_mu = [float(m) for m in self.options.user_mu]
        if not user_mu or any(m <= 0 for m in user_mu):
            raise ValueError("ibcnd mode requires user_mu angles > 0")
        nwave, ncol = prop.shape[0], prop.shape[1]
        kw = dict(dtype=prop.dtype, device=prop.device)
        bc = dict(fisot=torch.ones((nwave, ncol), **kw),
                  albedo=torch.as_tensor(albedo, **kw).broadcast_to(
                      (nwave, ncol)))
        # a second instance, not a mutation of this one's options
        alt = Disort(dataclasses.replace(
            self.options, flags=" ".join(sorted(self._flags - {"ibcnd"})),
            user_mu=tuple(user_mu) + tuple(-m for m in user_mu),
            user_phi=(0.0,), user_tau=()))
        uu = alt.intensities(prop, bc)["uu"]    # (nwave, ncol, L+1, 1, 2 nmu)
        nmu = len(user_mu)
        albmed = uu[:, :, 0, 0, :nmu]
        trnmed = uu[:, :, -1, 0, nmu:]
        if "print-transmissivity" in self._flags:
            hdr = self.options.header or "DISORT"
            print(f"\n{hdr}: albedo/transmissivity (wave 0, col 0)")
            print("     mu      albmed      trnmed")
            for mu, a, t in zip(user_mu, albmed[0, 0].tolist(),
                                trnmed[0, 0].tolist()):
                print(f"{mu:8.4f} {a:11.5e} {t:11.5e}")
        return dict(albmed=albmed, trnmed=trnmed)

    # -- accessors -----------------------------------------------------------

    def gather_rad(self) -> Tensor:
        """Radiances ``uu`` of the last :meth:`intensities` call (pydisort's
        ``get_rad``)."""
        if self._rad is None:
            raise RuntimeError("call intensities() first")
        return self._rad

    def mark_bypassed(self) -> None:
        """Record that the last run solved this instance's problem elsewhere
        (``Radiation.forward(fuse_bands=True)``), so :meth:`fluxes` raises
        instead of returning an earlier run's fluxes."""
        self._last = Disort._BYPASSED

    def fluxes(self):
        """The last solve's flux components (flup, rfldn, rfldir), each
        ``(nlyr+1, B)`` top-down: up, diffuse down and the direct beam."""
        if self._last is Disort._BYPASSED:
            raise RuntimeError(
                "the last run went through Radiation.forward(fuse_bands="
                "True), which bypasses this band's solver; read the fused "
                "fluxes from Radiation.forward's return value")
        if self._last is None:
            raise RuntimeError("call forward() first")
        return self._last["flup"], self._last["rfldn"], self._last["rfldir"]
