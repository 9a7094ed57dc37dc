"""User-angle radiances: source-function integration per azimuthal mode
(PyTorch port of ``pyharp_tpu/rt/disort/intensity.py``).

Once the quadrature solution of a mode is known, the intensity at a user
direction mu_u comes from integrating the formal solution along the line of
sight, with the source function in closed form: every term of the
eigen/particular expansion is an exponential or linear in optical depth, so
each layer contributes analytic weights and the sweep over layers is a
linear recurrence.

Layout: batch-last as in the solver, with two leading axes, the azimuthal
modes of one solve (``nm``) and the user angles of one hemisphere (``M``):
source coefficients ``(nm, M, N, L, B)`` and ``(nm, M, L, B)``, level
intensities ``(nm, M, L+1, B)``.  The JAX package traces one static-table
pipeline for m = 0 and ``vmap``s a traced-table copy over m >= 1
(``_chi_tables`` / ``_chi_tables_t``, ``_source_coeffs_batch`` /
``_source_coeffs_batch_t``); here one tensor function serves both, the
modes stacked on the leading axis.

Angle convention: user mu > 0 looks up (radiance emerging toward space),
mu < 0 looks down; mu is signed in [-1, 1] like DISORT's UMU.
"""

from __future__ import annotations

import math

import numpy as np
import torch
from torch import Tensor

from .legendre import lepoly, lepoly_static
from .solver import StaticAngles, beam_kappa


def _exp_ratio(E: Tensor, att: Tensor, den: Tensor, t: Tensor) -> Tensor:
    """(E - att) / den for E = exp(-(1 - den) t) and att = exp(-t): the layer
    weight of two decays whose rates meet where den -> 0 (an eigenvalue, or
    the beam's 1/mu0, at 1/|mu_u|).

    The JAX package divides the difference and takes the limit t att below
    |den| < eps (``_safe_div``, ``intensity.py:122``), so between eps and a
    few hundred eps the difference cancels to a few digits (in float32, 1e-3
    relative at |den| ~ 1e-4).  Here, where the rates are close (|den t| <
    0.5), the same value is att t expm1(den t) / (den t), which has no
    cancellation and needs no threshold; elsewhere the quotient itself."""
    y = den * t
    close = y.abs() < 0.5
    zero = y == 0
    ys = torch.where(zero, torch.ones_like(y), y)
    exprel = torch.where(zero, torch.ones_like(y), torch.expm1(ys) / ys)
    direct = (E - att) / torch.where(close, torch.ones_like(den), den)
    return torch.where(close, att * t * exprel, direct)


def _gather_layer(arr: Tensor, il: Tensor) -> Tensor:
    """Per-column layer slices ``arr[..., il[t, b], b]``: ``arr``
    ``(..., L, B)``, ``il`` ``(T, B)`` -> ``(..., T, B)``
    (``intensity.py:270``, with the user taus as an axis)."""
    idx = il.expand(tuple(arr.shape[:-2]) + tuple(il.shape))
    return arr.gather(-2, idx)


# ---------------------------------------------------------------------------
# source coefficients at the user angles
# ---------------------------------------------------------------------------

def _angle_tables(mus, angs: list[StaticAngles], G: int):
    """Static float64 tables of the user angles ``mus`` (M,) for the modes
    of ``angs``: ``T1``/``T2`` ``(nm, M, N, G)``, the weights w_j
    Lam_l^m(mu_j) of the nodes against C_l = (2l+1) Lam_l^m(mu_u), even and
    parity-signed, and ``Tq`` ``(nm, M, G)``, C_l times the parity.  Rows
    below l = m and from l = nstr on are zero: the quadrature solve keeps
    the moments m <= l <= nstr - 1."""
    mus = np.asarray(mus, np.float64)
    ls = np.arange(G)
    T1, T2, Tq = [], [], []
    for ang in angs:
        lam_u = lepoly_static(mus, ang.m, G - 1)              # (G, M)
        keep = (ls >= ang.m) & (ls <= ang.nstr - 1)
        C = ((2 * ls + 1) * keep)[None, :] * lam_u.T          # (M, G)
        WL = (np.asarray(ang.w)[None, :] * ang.lam_tables[:G])  # (G, N)
        par = ang.parity[:G]
        T1.append(C[:, None, :] * WL.T[None])                 # (M, N, G)
        T2.append((C * par)[:, None, :] * WL.T[None])
        Tq.append(C * par)
    return np.stack(T1), np.stack(T2), np.stack(Tq)


def _over_nodes(P: Tensor, X: Tensor) -> Tensor:
    """sum_j P[:, :, j] X[:, j]: ``P`` ``(nm, M, N, L, B)`` with ``X``
    ``(nm, N, K, L, B)`` -> ``(nm, M, K, L, B)``, or with ``X`` ``(nm, N,
    L, B)`` -> ``(nm, M, L, B)``."""
    acc = None
    for j in range(P.shape[2]):
        if X.dim() == 5:
            t = P[:, :, j, None] * X[:, None, j]
        else:
            t = P[:, :, j] * X[:, None, j]
        acc = t if acc is None else acc + t
    return acc


def source_coeffs(mus, angs: list[StaticAngles], gp: Tensor, gm: Tensor,
                  g: Tensor, ssa: Tensor, *, zp: Tensor | None = None,
                  zm: Tensor | None = None, fbeam: Tensor | None = None,
                  lam0: Tensor | None = None, thermal=None):
    """The source function of each mode at the user angles ``mus``, in
    closed form per layer (``_chi_tables`` :29, ``_source_coeffs_batch``
    :127 and their traced-table variants :63, :94).

    The JAX package first forms the angular moments chi_l of the node
    solution against Lam_l(mu_j), then sums them against C_l g_l; here the
    same double sum runs the other way round: the phase weights
    P1/P2[u, j] = sum_l C_l(mu_u) g_l w_j Lam_l(+-mu_j) first (one matmul
    over l), then the nodes.  Then, with half = ssa / 2,

      SA[u, k] = half sum_j (P1[u, j] gp[j, k] + P2[u, j] gm[j, k])
      SB[u, k] = half sum_j (P1[u, j] gm[j, k] + P2[u, j] gp[j, k])
      SZ[u]    = half sum_j (P1 zp + P2 zm)[j]
                 + kappa_m ssa fbeam sum_l C_l parity_l g_l Lam_l^m(mu0)
      S0[u]    = half sum_j (P1 y0p + P2 y0m)[j] + (1 - ssa) b_top
      S1[u]    = half sum_j (P1 + P2)[j] y1[j] + (1 - ssa) slope

    Args:
      mus: the signed user angles, (M,).
      angs: the angle tables of the ``nm`` modes, m = ``angs[i].m``.
      gp, gm: ``(nm, N, N, L, B)``; zp, zm: ``(nm, N, L, B)`` (beam only).
      g: ``(L, G, B)`` the scaled moments g_0 = 1, g_1.. (rows from nstr
        on are not read).
      ssa: ``(L, B)`` scaled single-scattering albedo.
      fbeam ``(B,)``, lam0 ``(nm, G, B)`` Lam_l^m(mu0): beam only.
      thermal: ``(y0p, y0m, y1, b_top, slope)`` of m = 0, or None.

    Returns ``(SA, SB, SZ, S0, S1)``: ``(nm, M, N, L, B)`` twice, then
    ``(nm, M, L, B)`` each, SZ None without a beam, S0 and S1 None without
    ``thermal``.
    """
    L, G, B = g.shape
    nm, N = gp.shape[0], gp.shape[1]
    M = len(mus)
    T1, T2, Tq = (torch.as_tensor(t, dtype=g.dtype, device=g.device)
                  for t in _angle_tables(mus, angs, G))
    gf = g.permute(1, 0, 2).reshape(G, L * B)
    P1 = (T1.reshape(-1, G) @ gf).reshape(nm, M, N, L, B)
    P2 = (T2.reshape(-1, G) @ gf).reshape(nm, M, N, L, B)
    half = 0.5 * ssa
    SA = half * (_over_nodes(P1, gp) + _over_nodes(P2, gm))
    SB = half * (_over_nodes(P1, gm) + _over_nodes(P2, gp))
    SZ = S0 = S1 = None
    if zp is not None:
        kappa = torch.as_tensor([beam_kappa(a.m) for a in angs],
                                dtype=g.dtype, device=g.device)
        # qdir[m, u, l, b] = sum_g Tq[m, u, g] g[l, g, b] lam0[m, g, b]
        qdir = torch.einsum("mug,lgb,mgb->mulb", Tq, g, lam0)
        SZ = (half * (_over_nodes(P1, zp) + _over_nodes(P2, zm))
              + kappa[:, None, None, None] * (ssa * fbeam[None]) * qdir)
    if thermal is not None:
        y0p, y0m, y1, b_top, slope = (x[None] if x.dim() == 3 else x
                                      for x in thermal)
        S0 = (half * (_over_nodes(P1, y0p) + _over_nodes(P2, y0m))
              + (1.0 - ssa) * b_top)
        S1 = half * _over_nodes(P1 + P2, y1) + (1.0 - ssa) * slope
    return SA, SB, SZ, S0, S1


# ---------------------------------------------------------------------------
# formal-solution sweeps
# ---------------------------------------------------------------------------

def _magnitudes(mus, like: Tensor) -> Tensor:
    """|mu| of the user angles as a ``(M, 1, 1)`` tensor."""
    return torch.as_tensor(np.abs(np.asarray(mus, np.float64)),
                           dtype=like.dtype, device=like.device)[:, None, None]


def _recur(att: Tensor, emis: Tensor, up: bool, start: Tensor) -> Tensor:
    """The layer recurrence I_next = I att + emis along L (axis -2), from
    the bottom (``up``) or the top, starting at ``start``; returns the
    levels ``(..., L+1, B)`` top-down."""
    L = emis.shape[-2]
    start = start.expand(emis.shape[:-2] + emis.shape[-1:])
    out = [None] * (L + 1)
    carry = start
    order = range(L - 1, -1, -1) if up else range(L)
    out[L if up else 0] = carry
    for l in order:
        carry = carry * att[..., l, :] + emis[..., l, :]
        out[l if up else l + 1] = carry
    return torch.stack(out, dim=-2)


def sweep_intensity(mus, up: bool, a: Tensor, b: Tensor, coeffs, lam: Tensor,
                    expd: Tensor, dt: Tensor, beam_top: Tensor,
                    mu_beam: Tensor, boundary: Tensor | None) -> Tensor:
    """The formal-solution sweep of every mode and every same-direction
    user angle (``sweep_intensity_batch`` :200).

    Args:
      mus: user angles of one hemisphere (their magnitudes are used).
      a, b, lam, expd: ``(nm, N, L, B)``.
      coeffs: :func:`source_coeffs`'s ``(SA, SB, SZ, S0, S1)``.
      dt: ``(L, B)`` scaled layer depths; beam_top, mu_beam ``(L, B)`` the
        beam's attenuation at each layer top and its decay cosine.
      boundary: ``(B,)`` surface (up) or TOA (down) intensity, or None
        for zero.

    Returns the level intensities ``(nm, M, L+1, B)``, top-down.
    """
    SA, SB, SZ, S0, S1 = coeffs
    m = _magnitudes(mus, dt)                          # (M, 1, 1)
    m4 = m[:, None]                                   # (M, 1, 1, 1)
    att = torch.exp(-dt[None] / m)                    # (M, L, B)
    att4 = att[:, None]
    lam4, E4 = lam[:, None], expd[:, None]            # (nm, 1, N, L, B)
    # the weights of the two eigen-terms: one decays along the line of
    # sight, the other against it (1 +- lam mu)
    toward = (1.0 - E4 * att4) / (1.0 + lam4 * m4)
    along = _exp_ratio(E4, att4, 1.0 - lam4 * m4, dt / m4)
    Ca, Cb = (toward, along) if up else (along, toward)
    emis = (SA * a[:, None] * Ca + SB * b[:, None] * Cb).sum(dim=2)
    if SZ is not None:
        ebm = torch.exp(-dt / mu_beam)
        if up:
            Cz = beam_top * (1.0 - att * ebm) / (1.0 + m / mu_beam)
        else:
            Cz = beam_top * _exp_ratio(ebm, att, 1.0 - m / mu_beam, dt / m)
        emis = emis + SZ * Cz
    if S0 is not None:
        C1 = m * (1.0 - att) - dt * att if up else dt - m * (1.0 - att)
        emis = emis + S0 * (1.0 - att) + S1 * C1
    start = (torch.zeros_like(dt[0]) if boundary is None else boundary)
    return _recur(att, emis, up, start)


def partial_sweep_at_tau(mus, up: bool, a: Tensor, b: Tensor, coeffs,
                         lam: Tensor, expd: Tensor, dt: Tensor,
                         beam_top: Tensor, mu_beam: Tensor, levels: Tensor,
                         il: Tensor, x: Tensor) -> Tensor:
    """Exact in-layer intensity at the user taus (``partial_sweep_at_tau``
    :285): the transport integral from the nearest swept level to the
    scaled local depth ``x`` inside layer ``il``, in closed form.

    Args: as :func:`sweep_intensity`, plus ``levels`` its output and
    ``il`` (long), ``x`` ``(T, B)`` the layer and the depth below its top
    of each user tau.  Returns ``(nm, M, T, B)``.
    """
    SA, SB, SZ, S0, S1 = coeffs
    m = _magnitudes(mus, dt)
    m4 = m[:, None]
    dtl = _gather_layer(dt, il)                       # (T, B)
    x = torch.minimum(x.clamp_min(0.0), dtl)
    lam_l = _gather_layer(lam, il)[:, None]           # (nm, 1, N, T, B)
    ab = (_gather_layer(SA, il) * _gather_layer(a, il)[:, None],
          _gather_layer(SB, il) * _gather_layer(b, il)[:, None])
    bt = _gather_layer(beam_top, il)
    mb = _gather_layer(mu_beam, il)
    if up:
        # from the layer bottom (level il + 1) up to x
        d = dtl - x
        att = torch.exp(-d / m)                       # (M, T, B)
        att4 = att[:, None]
        Er = torch.exp(-lam_l * d)
        Ca = torch.exp(-lam_l * x) * (1.0 - Er * att4) / (1.0 + lam_l * m4)
        Cb = _exp_ratio(Er, att4, 1.0 - lam_l * m4, d / m4)
        u0 = _gather_layer(levels, il + 1)
    else:
        # from the layer top (level il) down to x
        att = torch.exp(-x / m)
        att4 = att[:, None]
        E_l = _gather_layer(expd, il)[:, None]
        Ca = _exp_ratio(torch.exp(-lam_l * x), att4, 1.0 - lam_l * m4, x / m4)
        Cb = (torch.exp(-lam_l * (dtl - x)) - E_l * att4) / (1.0 + lam_l * m4)
        u0 = _gather_layer(levels, il)
    emis = (ab[0] * Ca + ab[1] * Cb).sum(dim=2)
    if SZ is not None:
        if up:
            Cz = (bt * torch.exp(-x / mb) * (1.0 - att * torch.exp(-d / mb))
                  / (1.0 + m / mb))
        else:
            Cz = bt * _exp_ratio(torch.exp(-x / mb), att, 1.0 - m / mb, x / m)
        emis = emis + _gather_layer(SZ, il) * Cz
    if S0 is not None:
        C1 = ((x + m) * (1.0 - att) - d * att if up
              else x - m * (1.0 - att))
        emis = (emis + _gather_layer(S0, il) * (1.0 - att)
                + _gather_layer(S1, il) * C1)
    return u0 * att + emis


# ---------------------------------------------------------------------------
# single scattering and the Nakajima-Tanaka corrections
# ---------------------------------------------------------------------------

def _cos_scatter(mus, phis, mu0: Tensor, phi0: Tensor) -> Tensor:
    """cos of the scattering angle between the beam and each user direction
    (mu_u, phi): ``(D, B)``."""
    mu = torch.as_tensor(np.asarray(mus, np.float64), dtype=mu0.dtype,
                         device=mu0.device)[:, None]
    phi = torch.as_tensor(np.asarray(phis, np.float64), dtype=mu0.dtype,
                          device=mu0.device)[:, None]
    sin_u = torch.sqrt((1.0 - mu * mu).clamp_min(0.0))
    sin0 = torch.sqrt((1.0 - mu0 * mu0).clamp_min(0.0))
    return -mu * mu0 + sin_u * sin0 * torch.cos(phi0 - phi)


def legendre_sum(g: Tensor, cos_t: Tensor, lmax: int) -> Tensor:
    """sum_l (2l+1) g_l P_l(cos_t) (``intensity.py:438``): g ``(L, G, B)``,
    cos_t ``(D, B)`` -> ``(D, L, B)``."""
    P = lepoly(cos_t, 0, lmax)                        # (lmax+1, D, B)
    acc = None
    for l in range(min(lmax + 1, g.shape[1])):
        term = (2 * l + 1) * g[None, :, l] * P[l][:, None]
        acc = term if acc is None else acc + term
    return acc


def _same_sign(mus) -> bool:
    mus = np.asarray(mus, np.float64)
    if not (np.all(mus > 0) or np.all(mus < 0)):
        raise ValueError("the directions of one call must all look up or "
                         "all look down")
    return bool(mus[0] > 0)


def single_scatter_sweep(mus, amp: Tensor, taucum: Tensor, beam_top: Tensor,
                         mu_beam: Tensor) -> Tensor:
    """Beam single-scattering intensity at every level, for directions that
    all look up or all look down (``single_scatter_sweep`` :397).

    ``amp`` ``(D, L, B)`` is each direction's per-layer source amplitude,
    e.g. (F0 / 4 pi) w0 p(Theta); beam_top / mu_beam ``(L, B)`` as in
    :func:`sweep_intensity`.  Zero boundary values: the TMS correction
    excludes surface-reflected light.  Returns ``(D, L+1, B)``.
    """
    up = _same_sign(mus)
    m = _magnitudes(mus, amp)
    dt = taucum[1:] - taucum[:-1]
    att = torch.exp(-dt / m)
    if up:
        w = beam_top * (1.0 - att * torch.exp(-dt / mu_beam)) / (
            1.0 + m / mu_beam)
    else:
        w = beam_top * _exp_ratio(torch.exp(-dt / mu_beam), att,
                                  1.0 - m / mu_beam, dt / m)
    return _recur(att, amp * w, up, torch.zeros_like(dt[0]))


def partial_single_scatter_at_tau(mus, amp: Tensor, taucum: Tensor,
                                  beam_top: Tensor, mu_beam: Tensor,
                                  levels: Tensor, il: Tensor,
                                  x: Tensor) -> Tensor:
    """A :func:`single_scatter_sweep` field inside the layers at the user
    taus (``partial_single_scatter_at_tau`` :367): ``levels`` the sweep's
    ``(D, L+1, B)``; il, x ``(T, B)``.  Returns ``(D, T, B)``."""
    up = _same_sign(mus)
    m = _magnitudes(mus, amp)
    dtl = _gather_layer(taucum[1:] - taucum[:-1], il)
    amp_l = _gather_layer(amp, il)
    bt = _gather_layer(beam_top, il)
    mb = _gather_layer(mu_beam, il)
    x = torch.minimum(x.clamp_min(0.0), dtl)
    if up:
        d = dtl - x
        att = torch.exp(-d / m)
        w = bt * torch.exp(-x / mb) * (1.0 - att * torch.exp(-d / mb)) / (
            1.0 + m / mb)
        return _gather_layer(levels, il + 1) * att + amp_l * w
    att = torch.exp(-x / m)
    w = bt * _exp_ratio(torch.exp(-x / mb), att, 1.0 - m / mb, x / m)
    return _gather_layer(levels, il) * att + amp_l * w


def tms_correction(mus, phis, g_unscaled: Tensor, g_scaled: Tensor,
                   ssa: Tensor, ssa_s: Tensor, f_dm: Tensor, nstr: int,
                   taucum_s: Tensor, fbeam: Tensor, mu0: Tensor, phi0: Tensor,
                   beam_top: Tensor | None = None,
                   mu_beam: Tensor | None = None, at_taus=None) -> Tensor:
    """Nakajima-Tanaka TMS correction for the directions (mus[d], phis[d]),
    all looking up or all down (``tms_correction`` :568):

      corr = I_ss[exact phase, amp = w0 p / (1 - w0 f)]
           - I_ss[truncated phase, amp = w0' p'],

    both along the delta-M scaled depth.  g_unscaled ``(L, G, B)`` and
    g_scaled ``(L, G', B)`` include g_0 = 1.  Returns ``(D, L+1, B)``, or
    with ``at_taus = (il, x_s)`` (each ``(T, B)``) the exact in-layer
    values ``(D, T, B)``.
    """
    cos_t = _cos_scatter(mus, phis, mu0, phi0)
    p_exact = legendre_sum(g_unscaled, cos_t, g_unscaled.shape[1] - 1)
    p_trunc = legendre_sum(g_scaled[:, :nstr], cos_t, nstr - 1)
    if beam_top is None:
        beam_top = torch.exp(-taucum_s[:-1] / mu0[None])
    if mu_beam is None:
        mu_beam = mu0[None].expand_as(ssa)
    k = fbeam[None] / (4.0 * math.pi)
    amp_exact = k * ssa * p_exact / (1.0 - ssa * f_dm)
    amp_trunc = k * ssa_s * p_trunc
    exact = single_scatter_sweep(mus, amp_exact, taucum_s, beam_top, mu_beam)
    trunc = single_scatter_sweep(mus, amp_trunc, taucum_s, beam_top, mu_beam)
    if at_taus is None:
        return exact - trunc
    il, x_s = at_taus
    return (partial_single_scatter_at_tau(mus, amp_exact, taucum_s, beam_top,
                                          mu_beam, exact, il, x_s)
            - partial_single_scatter_at_tau(mus, amp_trunc, taucum_s,
                                            beam_top, mu_beam, trunc, il,
                                            x_s))


def ims_correction(mus, phis, g_unscaled: Tensor, ssa: Tensor, f_dm: Tensor,
                   tau_u: Tensor, taucum_u: Tensor, nstr: int, fbeam: Tensor,
                   mu0: Tensor, phi0: Tensor, at_taus=None) -> Tensor:
    """Nakajima-Tanaka IMS secondary-scattering correction for downward
    directions (mus[d] < 0, phis[d]) (``ims_correction`` :450; N&T 1988
    eq. 17, DISORT's SECSCA): the doubly scattered delta-M spike intensity,

      out = F0 / (4 pi) fw^2 / (1 - fw) pspike chi(tau),
      chi = e^{-tau/u} tau^2 g(a tau) / (u mu0'),  a = 1/mu0' - 1/u,
      g(x) = (1 - e^{-x} (1 + x)) / x^2,  mu0' = mu0 / (1 - fbar wbar),

    pspike = sum_k (2k+1)(2 ghat_k - ghat_k^2) P_k(cos Theta) with ghat_k = 1
    below nstr and the tau*ssa-weighted normalized moment above the level
    otherwise.  g_unscaled ``(L, G, B)`` includes g_0 = 1; tau_u ``(L, B)``
    and taucum_u ``(L+1, B)`` are unscaled depths.  Returns ``(D, L+1, B)``
    to SUBTRACT from the TMS-corrected field, or with ``at_taus = (il, x_u,
    tq)`` (``(T, B)``, ``(T, B)``, ``(T,)`` unscaled depths) ``(D, T, B)``.
    """
    if _same_sign(mus):
        raise ValueError("IMS applies to downward directions only")
    dtype = ssa.dtype
    u = _magnitudes(mus, ssa)                         # (D, 1, 1)
    G = g_unscaled.shape[1]
    cos_t = _cos_scatter(mus, phis, mu0, phi0)
    zero1 = torch.zeros_like(ssa[:1])

    def cum(rate):
        return torch.cat([zero1, torch.cumsum(rate * tau_u, dim=0)], dim=0)

    def at(rate):
        # the prefix sums at each depth: exact, linear in the local depth
        lvl = cum(rate)
        if at_taus is None:
            return lvl
        il, x_u, _ = at_taus
        return _gather_layer(lvl, il) + _gather_layer(rate, il) * x_u

    wsum, fsum = at(ssa), at(ssa * f_dm)
    if at_taus is None:
        ztau = taucum_u
    else:
        ztau = torch.as_tensor(np.asarray(at_taus[2], np.float64),
                               dtype=dtype, device=ssa.device)[:, None]
        ztau = ztau.expand_as(wsum)
    ok = (wsum > 0) & (fsum > 0) & (ztau > 0)
    one = torch.ones_like(wsum)
    wsum_s = torch.where(ok, wsum, one)
    fsum_s = torch.where(ok, fsum, one)
    ztau_s = torch.where(ok, ztau, one)
    fw = ((fsum_s / wsum_s) * (wsum_s / ztau_s)).clamp(0.0, 1.0 - 1e-6)

    P = lepoly(cos_t, 0, G - 1)[:, :, None]           # (G, D, 1, B)
    pspike = None
    for k in range(min(nstr, G)):
        t = (2 * k + 1) * P[k]
        pspike = t if pspike is None else pspike + t
    for k in range(nstr, G):
        ghat = at(ssa * g_unscaled[:, k]) / fsum_s
        pspike = pspike + (2 * k + 1) * (2.0 * ghat - ghat * ghat) * P[k]

    mu0p = mu0[None] / (1.0 - fw)
    a = 1.0 / mu0p - 1.0 / u
    x = a * ztau_s
    small = x.abs() < 0.1
    x_s = torch.where(small, torch.zeros_like(x), x)
    g_direct = ((-torch.expm1(-x_s) - x_s * torch.exp(-x_s))
                / torch.where(small, torch.ones_like(x_s), x_s * x_s))
    g_series = 0.5 - x / 3.0 + x * x / 8.0 - x ** 3 / 30.0
    gx = torch.where(small, g_series, g_direct)
    chi = torch.exp(-ztau_s / u) * ztau_s * ztau_s * gx / (u * mu0p)
    out = ((fbeam[None] / (4.0 * math.pi)) * (fw * fw / (1.0 - fw))
           * pspike * chi)
    return torch.where(ok, out, torch.zeros_like(out))
