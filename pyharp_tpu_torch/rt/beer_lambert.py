"""Beer-Lambert (no-scattering) RT solver (PyTorch port of
``pyharp_tpu/rt/beer_lambert.py``).

The reference's transmission integrator (``rtsolver.hpp:34-64``,
``beer_lambert.cpp_:19-58``): tau/mu accumulated from the top down, the
source integrated by the trapezoid rule,

    I_toa = sum_i 1/2 (S[i+1] e^{-t[i+1]} + S[i] e^{-t[i]}) dtau_i / mu
          + S_surf e^{-t_surf}
          + S_surf alpha Gammaq(alpha, t_surf) t_surf^{-alpha} Gamma(alpha)

with the incomplete-gamma correction for a ``T ~ Ts (tau/taus)^alpha``
lower boundary (``beer_lambert.cpp_:51-54``).

``BeerLambert.forward`` has the RT solver interface: the up and down
fluxes of the single-scattering-albedo-0 discrete-ordinates problem on the
double-Gauss hemisphere (the attenuated direct beam, thermal emission
integrated layer by layer, a Lambertian surface).  It has no TPU kernel in
the JAX package and none here: it is tensor code on the caller's device.
"""

from __future__ import annotations

import dataclasses
import math

import torch
from torch import Tensor

from ..core import index
from .disort.planck import planck_band, planck_total
from .disort.quadrature import gauss_half_range


@dataclasses.dataclass(frozen=True)
class BeerLambertOptions:
    """Mirror of the reference option struct (``rtsolver.hpp:34-39``)."""

    alpha: float = 0.0  # T ~ Ts (tau/taus)^alpha lower-boundary scaling
    nstr: int = 8       # hemisphere quadrature for the flux mode
    wave_lower: tuple[float, ...] = ()
    wave_upper: tuple[float, ...] = ()


def toa_radiance(tau: Tensor, source: Tensor, mu, alpha: float = 0.0
                 ) -> Tensor:
    """Transmission-integrated TOA radiance per outgoing ray.

    Args:
      tau: ``(..., nlyr)`` layer optical thickness, top-down.
      source: ``(..., nlyr+1)`` source function at the levels, top-down.
      mu: ``(nray,)`` outgoing direction cosines (> 0).
      alpha: the lower boundary's temperature exponent.

    Returns ``(..., nray)``.
    """
    mu = torch.as_tensor(mu, dtype=tau.dtype, device=tau.device)
    taut = torch.cat([torch.zeros_like(tau[..., :1]),
                      torch.cumsum(tau, dim=-1)], dim=-1)
    t = taut[..., None, :] / mu[:, None]                # (..., nray, nlvl)
    e = torch.exp(-t)
    s = source[..., None, :]
    trap = 0.5 * (s[..., 1:] * e[..., 1:] + s[..., :-1] * e[..., :-1])
    dtau = tau[..., None, :] / mu[:, None]
    out = torch.sum(trap * dtau, dim=-1) + s[..., -1] * e[..., -1]
    if alpha > 0:
        ts = t[..., -1]
        a = torch.full_like(ts, alpha)
        corr = (s[..., -1] * alpha
                * torch.special.gammaincc(a, ts.clamp_max(1000.0))
                * ts ** (-alpha) * torch.exp(torch.lgamma(a)))
        out = out + torch.where(ts < 1000.0, corr, 0.0)
    return out


def _sweep(trans: Tensor, emis: Tensor, init: Tensor, reverse: bool
           ) -> Tensor:
    """I_{l+1} = I_l trans_l + emis_l along the last axis, from ``init``;
    the values after each layer, ``(..., L)``.  ``reverse`` runs from the
    last layer to the first and returns them in layer order.  A loop, not a
    cumulative product: exp(+t) of the closed form overflows."""
    L = trans.shape[-1]
    out = [None] * L
    carry = init
    for l in (reversed(range(L)) if reverse else range(L)):
        carry = carry * trans[..., l] + emis[..., l]
        out[l] = carry
    return torch.stack(out, dim=-1)


class BeerLambert:
    """No-scattering flux solver with the RT solver ``forward`` interface."""

    def __init__(self, options: BeerLambertOptions = BeerLambertOptions()):
        self.options = options

    def forward(self, prop: Tensor, bc: dict, temf: Tensor | None = None
                ) -> Tensor:
        """Level fluxes ``(nwave, ncol, nlyr+1, 2)``, levels bottom-up.

        ``prop`` ``(nwave, ncol, nlyr, nprop)`` bottom-up (only the optical
        thickness is read); ``bc`` ``fbeam, umu0, albedo, btemp``
        broadcastable to ``(nwave, ncol)``; ``temf`` ``(ncol, nlyr+1)``
        bottom-up level temperatures, for the thermal source.
        """
        dtype, device = prop.dtype, prop.device
        kw = dict(dtype=dtype, device=device)
        nwave, ncol, nlyr, _ = prop.shape
        tau = prop[..., index.IEX].clamp_min(0.0).flip(-1)
        taut = torch.cat([torch.zeros((nwave, ncol, 1), **kw),
                          torch.cumsum(tau, dim=-1)], dim=-1)   # top-down

        mu_q, w_q = (torch.as_tensor(x, **kw)
                     for x in gauss_half_range(self.options.nstr))

        def bc_get(name, default):
            return torch.as_tensor(bc.get(name, default), **kw).broadcast_to(
                (nwave, ncol))

        fbeam = bc_get("fbeam", 0.0)
        umu0 = bc_get("umu0", 1.0)
        albedo = bc_get("albedo", 0.0)

        rfldir = umu0[..., None] * fbeam[..., None] * torch.exp(
            -taut / umu0[..., None])

        if temf is not None:
            btemp = bc_get("btemp", 0.0)
            tlev = torch.as_tensor(temf, **kw).flip(-1)[None]
            wl, wu = self.options.wave_lower, self.options.wave_upper
            if wl and wu:
                lo, hi = torch.as_tensor(wl, **kw), torch.as_tensor(wu, **kw)
                B = planck_band(tlev, lo[:, None, None], hi[:, None, None])
                Bsurf = planck_band(btemp, lo[:, None], hi[:, None])
            else:
                B = planck_total(tlev) * torch.ones((nwave, 1, 1), **kw)
                Bsurf = planck_total(btemp)
        else:
            B = torch.zeros((nwave, ncol, nlyr + 1), **kw)
            Bsurf = torch.zeros((nwave, ncol), **kw)

        # per quadrature angle, the trapezoid in each layer: downward from
        # the top, upward from the surface
        t_ang = taut[..., None, :] / mu_q[:, None]          # (..., nq, nlvl)
        dt = t_ang[..., 1:] - t_ang[..., :-1]
        Bq = B[..., None, :]
        trans = torch.exp(-dt)
        emis_dn = 0.5 * (Bq[..., 1:] + Bq[..., :-1] * trans) * dt
        emis_up = 0.5 * (Bq[..., :-1] + Bq[..., 1:] * trans) * dt

        Idn_in = _sweep(trans, emis_dn, torch.zeros_like(trans[..., 0]),
                        reverse=False)                       # levels 1..L
        Idn = torch.cat([torch.zeros_like(Idn_in[..., :1]), Idn_in], dim=-1)

        # the surface: emission and the Lambertian reflection of the beam
        # and the diffuse down-flux, isotropic over the quadrature angles
        dn_dir_srf = umu0 * fbeam * torch.exp(-taut[..., -1] / umu0)
        dn_dif_srf = 2.0 * math.pi * torch.einsum("j,...j->...", w_q * mu_q,
                                                  Idn[..., -1])
        Isurf_scalar = (albedo / math.pi * (dn_dir_srf + dn_dif_srf)
                        + (1.0 - albedo) * Bsurf)          # (nwave, ncol)
        Isurf = Isurf_scalar[..., None].expand(
            Isurf_scalar.shape + (mu_q.shape[0],))

        Iup_in = _sweep(trans, emis_up, Isurf, reverse=True)  # levels 0..L-1
        Iup = torch.cat([Iup_in, Isurf[..., None]], dim=-1)

        wmu = w_q * mu_q
        flup = 2.0 * math.pi * torch.einsum("j,...jl->...l", wmu, Iup)
        rfldn = 2.0 * math.pi * torch.einsum("j,...jl->...l", wmu, Idn)

        flux = torch.stack([flup, rfldn + rfldir], dim=-1)
        return flux.flip(-2)
