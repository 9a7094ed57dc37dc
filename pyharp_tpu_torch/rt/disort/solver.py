"""Discrete-ordinates core of each azimuthal mode (PyTorch port of
``pyharp_tpu/rt/disort/solver.py``): the homogeneous eigenstructure of each
layer, the thermal, beam and general-source particular solutions, and the
layer-coupling boundary-value problem.  The mode m enters through the
angle tables of :func:`make_static_angles`, so one function serves every
mode where the JAX package keeps traced-table copies for m >= 1
(``homogeneous_solution_t`` :315, ``beam_particular_t`` :452).

Memory layout is batch-last, as in the JAX package: matrices
``(N, N, L, B)``, vectors ``(N, L, B)``, per-layer scalars ``(L, B)`` with
``B = nwave * ncol`` flattened wave-major.  On the GPU the last axis is the
one neighbouring threads walk, so kernel loads coalesce.

These functions are the plain versions the stage-1 kernel K4
(``kernels.stage1_general``) repeats operation for operation, and, with
:func:`solve_bvp`, the float64 reference path.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import numpy as np
import torch
from torch import Tensor

from .jacobi import jacobi_eigh
from .legendre import lepoly_static
from .linsolve import cholesky_lower, lu_solve
from .quadrature import gauss_half_range


def _umm(a: Tensor, b: Tensor) -> Tensor:
    """Unrolled tiny matmul: (N, K, ...) x (K, M, ...) -> (N, M, ...).

    Every entry is summed over k in order, ``a[i, 0] b[0, j] + a[i, 1]
    b[1, j] + ...``, each product and each sum rounded; all (i, j) entries
    go together, one tensor operation a product or a sum."""
    K = a.shape[1]
    acc = a[:, 0, None] * b[None, 0]
    for k in range(1, K):
        acc = acc + a[:, k, None] * b[None, k]
    return acc


def _umv(a: Tensor, v: Tensor) -> Tensor:
    """Unrolled tiny matrix-vector: (N, K, ...) x (K, ...) -> (N, ...),
    summed over k in order as :func:`_umm`."""
    K = a.shape[1]
    acc = a[:, 0] * v[0][None]
    for k in range(1, K):
        acc = acc + a[:, k] * v[k][None]
    return acc


def _uwdot_static(w: np.ndarray, x: Tensor) -> Tensor:
    """Static-weight reduction over the leading dim: sum_j w[j] x[j]."""
    acc = float(w[0]) * x[0]
    for j in range(1, x.shape[0]):
        acc = acc + float(w[j]) * x[j]
    return acc


class LayerSolution(NamedTuple):
    """Per-layer homogeneous eigenstructure (batch-last layout)."""

    lam: Tensor   # (N, L, B) positive eigenvalues
    gp: Tensor    # (N, N, L, B) [i, k]: upward components of +lam modes
    gm: Tensor    # (N, N, L, B) [i, k]: downward components of +lam modes
    expd: Tensor  # (N, L, B) exp(-lam * dtau)


class StaticAngles(NamedTuple):
    """Quadrature / Legendre constants for one azimuthal mode."""

    mu: np.ndarray          # (N,)
    w: np.ndarray           # (N,)
    lam_tables: np.ndarray  # (nmom+1, N) normalized assoc. Legendre at nodes
    parity: np.ndarray      # (nmom+1,) (-1)^(l-m)
    m: int
    nstr: int


def make_static_angles(nstr: int, nmom: int, m: int) -> StaticAngles:
    mu, w = gauss_half_range(nstr)
    lmax = max(nmom, nstr - 1)
    lam_tab = lepoly_static(mu, m, lmax)
    ls = np.arange(lmax + 1)
    parity = np.where((ls - m) % 2 == 0, 1.0, -1.0)
    return StaticAngles(mu, w, lam_tab, parity, m, nstr)


def _ucontract_g(coef: Tensor, tab: np.ndarray) -> Tensor:
    """sum_g coef[:, g, :] * tab[g, ...]: (L, G, B) x (G, *dims) ->
    (*dims, L, B), skipping the table's zero entries."""
    G, dims = tab.shape[0], tab.shape[1:]
    flat = []
    for idx in np.ndindex(*dims):
        acc = None
        for gidx in range(G):
            t = float(tab[(gidx,) + idx])
            if t == 0.0:
                continue
            term = coef[:, gidx, :] * t
            acc = term if acc is None else acc + term
        flat.append(torch.zeros_like(coef[:, 0, :]) if acc is None else acc)
    out = torch.stack(flat, dim=0)
    return out.reshape(tuple(dims) + tuple(out.shape[1:]))


def _mm(a: Tensor, b: Tensor) -> Tensor:
    """(N,N,L,B) x (N,N,L,B) matrix product over the leading dims."""
    return _umm(a, b)


def _mv(a: Tensor, v: Tensor) -> Tensor:
    """(N,N,L,B) x (N,L,B) -> (N,L,B)."""
    return _umv(a, v)


def _phase_outer_tables(ang: StaticAngles):
    """Static float64 tables (2l+1) Lam_l(mu_i) Lam_l(mu_j), split by the
    parity of l - m into (even, odd), each ``(G, N, N)``.  Rows l >= nstr
    are zero: the solve truncates the phase expansion at l = nstr - 1."""
    lam = ang.lam_tables
    ls = np.arange(lam.shape[0])
    outer = (2 * ls + 1)[:, None, None] * lam[:, :, None] * lam[:, None, :]
    outer = np.where((ls <= ang.nstr - 1)[:, None, None], outer, 0.0)
    even = ((ls - ang.m) % 2 == 0)[:, None, None]
    return np.where(even, outer, 0.0), np.where(even, 0.0, outer)


def _moment_coeffs(ssa: Tensor, pmom: Tensor, ang: StaticAngles) -> Tensor:
    """g_l for l = 0..lmax, ``(L, G, B)``: g_0 = 1, then pmom's g_1..,
    zero-padded; zero below l = m and above l = nstr - 1 (the quadrature
    solve keeps the first nstr moments, as cdisort does).

    Args: ssa ``(L, B)``; pmom ``(L, nmom, B)`` (may be 0-wide).
    """
    lmax = ang.lam_tables.shape[0] - 1
    L, B = ssa.shape
    ones = torch.ones((L, 1, B), dtype=ssa.dtype, device=ssa.device)
    nmom = pmom.shape[1]
    if nmom >= lmax:
        g = torch.cat([ones, pmom[:, :lmax]], dim=1)
    else:
        pad = torch.zeros((L, lmax - nmom, B), dtype=ssa.dtype,
                          device=ssa.device)
        g = torch.cat([ones, pmom, pad], dim=1)
    ls = np.arange(lmax + 1)
    keep = (ls >= ang.m) & (ls <= ang.nstr - 1)
    if not keep.all():
        mask = torch.as_tensor(keep.astype(np.float64), dtype=ssa.dtype,
                               device=ssa.device)
        g = g * mask[None, :, None]
    return g


def _eye(N: int, like: Tensor) -> Tensor:
    return torch.eye(N, dtype=like.dtype, device=like.device)[:, :, None, None]


def _const(x: np.ndarray, like: Tensor) -> Tensor:
    return torch.as_tensor(np.asarray(x), dtype=like.dtype, device=like.device)


def _parity_operators(ssa: Tensor, pmom: Tensor, ang: StaticAngles):
    """(Se, So): the phase tables contracted with the moments, by parity."""
    even_tab, odd_tab = _phase_outer_tables(ang)
    g = _moment_coeffs(ssa, pmom, ang)
    return _ucontract_g(g, even_tab), _ucontract_g(g, odd_tab)


def full_operators(ssa: Tensor, pmom: Tensor, ang: StaticAngles):
    """The reduced scattering operators V = I - w0 So W and U = I - w0 Se W,
    each ``(N, N, L, B)`` (``solver.py:264``)."""
    Se, So = _parity_operators(ssa, pmom, ang)
    N = ang.mu.shape[0]
    w = _const(ang.w, ssa)
    eye = _eye(N, ssa)
    ssa_b = ssa[None, None]
    return (eye - ssa_b * (So * w[None, :, None, None]),
            eye - ssa_b * (Se * w[None, :, None, None]))


def homogeneous_solution(ssa: Tensor, pmom: Tensor, dtau: Tensor,
                         ang: StaticAngles, sweeps: int | None = None):
    """Eigenstructure of every layer (``solver.py:286``).

    Args:
      ssa: ``(L, B)`` single-scattering albedo (dithered away from 1).
      pmom: ``(L, nmom, B)`` delta-M scaled phase moments g_1..g_nmom.
      dtau: ``(L, B)`` layer optical thickness.
      sweeps: Jacobi sweeps (``jacobi_eigh``'s default if None).

    Returns ``(LayerSolution, Vfull, Ufull)``.
    """
    Se, So = _parity_operators(ssa, pmom, ang)
    return _homogeneous_core(Se, So, ssa, dtau, ang.mu, ang.w, sweeps)


def _homogeneous_core(Se, So, ssa, dtau, mu_np, w_np, sweeps=None):
    """Eigenstructure from the assembled parity operators."""
    mu = _const(mu_np, ssa)
    w = _const(w_np, ssa)
    N = mu.shape[0]
    sqw = torch.sqrt(w)
    sqm = torch.sqrt(mu)
    eye = _eye(N, ssa)
    ssa_b = ssa[None, None]

    # Uhat = M^-1/2 (I - w0 W^1/2 Se W^1/2) M^-1/2 (symmetric, ~SPD), Vhat
    # likewise with So
    def hat(S):
        core = eye - ssa_b * (sqw[:, None, None, None] * S
                              * sqw[None, :, None, None])
        return core / (sqm[:, None, None, None] * sqm[None, :, None, None])

    Uhat = hat(Se)
    Vhat = hat(So)

    # Uhat = Lc Lc^T, so Uhat Vhat is similar to the symmetric Lc^T Vhat Lc
    Lc = cholesky_lower(Uhat, floor=1e-12)
    K = _umm(Lc.transpose(0, 1), _mm(Vhat, Lc))
    lam2, Y = jacobi_eigh(K, sweeps)
    lam = torch.sqrt(lam2.clamp_min(1e-12))

    # d-eigenvectors: D = M^-1/2 W^-1/2 Lc Y
    X = _mm(Lc, Y)
    D = X / (sqm * sqw)[:, None, None, None]

    # s = -(1/lam) M^-1 V d,  V = I - w0 So W
    Vfull = eye - ssa_b * (So * w[None, :, None, None])
    S = -_mm(Vfull, D) / (mu[:, None, None, None] * lam[None])

    gp = 0.5 * (S + D)
    gm = 0.5 * (S - D)

    # each mode (pair) normalized to unit max magnitude
    scale = torch.maximum(gp.abs().amax(dim=0), gm.abs().amax(dim=0))
    scale = scale.clamp_min(1e-30)[None]
    gp = gp / scale
    gm = gm / scale

    expd = torch.exp(-lam * dtau[None])
    Ufull = eye - ssa_b * (Se * w[None, :, None, None])
    return LayerSolution(lam, gp, gm, expd), Vfull, Ufull


def beam_resonance_eps(dtype: torch.dtype) -> float:
    """Relative floor of the beam particular's resonance denominators
    lam^2 - 1/mu^2 (``solver.py:496``): 1e-4 in float32, as the Pallas and
    CUDA stage-1 kernels use, 1e-9 in float64."""
    return 1e-4 if dtype == torch.float32 else 1e-9


def beam_kappa(m: int) -> float:
    """The beam source's mode prefactor (2 - delta_m0) / 4 pi."""
    return (2.0 if m > 0 else 1.0) / (4.0 * math.pi)


def beam_source_moments(ssa: Tensor, pmom: Tensor, lam0: Tensor,
                        ang: StaticAngles):
    """The beam source's q+- at the nodes before the ssa*fbeam amplitude:
    q+-[i] = kappa sum_l (2l+1) g_l Lam_l^m(+-mu_i) Lam_l^m(-mu0), each
    ``(N, L, B)``, kappa = :func:`beam_kappa` of the mode ``ang.m``;
    ``lam0`` is Lam_l^m(mu0), ``(G, B)``."""
    dtype = ssa.dtype
    g = _moment_coeffs(ssa, pmom, ang)
    G = ang.lam_tables.shape[0]
    parity = _const(ang.parity, ssa)
    kappa = beam_kappa(ang.m)
    ls = torch.arange(G, dtype=dtype, device=ssa.device)
    coef = g * ((2 * ls + 1) * parity)[None, :, None] * lam0[None]
    lam_tab, par = ang.lam_tables, ang.parity

    def qsum(signed):
        rows = []
        for i in range(lam_tab.shape[1]):
            acc = None
            for gidx in range(min(G, ang.nstr)):   # truncated at nstr - 1
                t = float(lam_tab[gidx, i])
                if signed:
                    t *= float(par[gidx])
                if t == 0.0:
                    continue
                term = coef[:, gidx, :] * t
                acc = term if acc is None else acc + term
            rows.append(torch.zeros_like(coef[:, 0, :]) if acc is None
                        else acc)
        return torch.stack(rows, dim=0)

    return kappa * qsum(False), kappa * qsum(True)


def _beam_from_q(sol, Vfull, Ufull, qp, qm, ssa, fbeam, mu_r, mu_np):
    """Beam-source particular solution (Z+, Z-), each ``(N, L, B)``, from
    the source moments q+- (``solver.py:387-506``): expanded in the
    homogeneous eigenbasis with the denominators lam^2 - 1/mu_r^2 floored
    at :func:`beam_resonance_eps`.  ``mu_r`` ``(L, B)`` is the decay cosine
    per layer (mu0, or the pseudo-spherical effective cosine)."""
    mu = _const(mu_np, ssa)
    amp = (ssa * fbeam[None])[None]
    qp = qp * amp
    qm = qm * amp
    qs = qp + qm
    qd = qp - qm
    mu_r = mu_r[None]
    mu_c = mu[:, None, None]
    # rhs' = M^-1 V M^-1 qs - M^-1 qd / mu_r
    rhs = _mv(Vfull, qs / mu_c) / mu_c - qd / (mu_c * mu_r)
    # expand in the s-eigenbasis: S c = rhs, scaled by 1/(lam^2 - 1/mu_r^2)
    S = sol.gp + sol.gm
    c = lu_solve(S, rhs)
    inv_mu0_sq = 1.0 / (mu_r * mu_r)
    lam2 = sol.lam * sol.lam
    denom = lam2 - inv_mu0_sq
    floor = beam_resonance_eps(ssa.dtype) * (lam2 + inv_mu0_sq)
    denom = torch.where(denom.abs() < floor,
                        torch.where(denom < 0, -floor, floor), denom)
    zs = _umv(S, c / denom)
    # zd = -mu_r M^-1 (U zs - qs)
    zd = -mu_r * (_mv(Ufull, zs) - qs) / mu_c
    return 0.5 * (zs + zd), 0.5 * (zs - zd)


def thermal_particular(Vfull: Tensor, Ufull: Tensor, ssa: Tensor,
                       b_top: Tensor, b_slope: Tensor, ang: StaticAngles):
    """Linear-in-tau thermal particular solution (``solver.py:509``):
    U h = (1 - w0) 1, V y0d = 2 mu b_slope h; returns (Y0+, Y0-, Y1)."""
    mu = _const(ang.mu, ssa)
    N = mu.shape[0]
    e = torch.ones((N,) + tuple(ssa.shape), dtype=ssa.dtype, device=ssa.device)
    h = lu_solve(Ufull, (1.0 - ssa)[None] * e)
    y1 = b_slope[None] * h
    y0d = lu_solve(Vfull, 2.0 * mu[:, None, None] * y1)
    return b_top[None] * h + 0.5 * y0d, b_top[None] * h - 0.5 * y0d, y1


def general_particular(Vfull: Tensor, Ufull: Tensor, qp: Tensor, qm: Tensor):
    """Particular solution of a source constant within each layer
    (``general_source``, ``solver.py:533``): U (Y+ + Y-) = q+ + q-,
    V (Y+ - Y-) = q+ - q-."""
    ys = lu_solve(Ufull, qp + qm)
    yd = lu_solve(Vfull, qp - qm)
    return 0.5 * (ys + yd), 0.5 * (ys - yd)


def bvp_rhs(ptop_p, ptop_m, pbot_p, pbot_m, ftop, bot_rhs) -> Tensor:
    """The block right-hand sides ``(2N, L, B)`` of the layer-coupling
    system: rows [I- continuity at the layer top ; I+ continuity at its
    bottom], the top row of layer 0 taking the incident ``ftop`` and the
    bottom row of layer L-1 the boundary ``bot_rhs``."""
    L = ptop_p.shape[1]
    d_up = torch.cat([(ptop_m[:, 0] - ftop)[:, None],
                      ptop_m[:, 1:] - pbot_m[:, :L - 1]], dim=1)
    d_lo = torch.cat([ptop_p[:, 1:] - pbot_p[:, :L - 1],
                      bot_rhs[:, None]], dim=1)
    return torch.cat([d_up, d_lo], dim=0)


def solve_bvp(sol: LayerSolution, ptop_p, ptop_m, pbot_p, pbot_m, ftop,
              bot_rhs, albedo, ang: StaticAngles):
    """Factored block-tridiagonal elimination for the coefficients (a, b),
    each ``(N, L, B)`` (``solver.py:554``): the forward scan of kernel K2's
    plain version, then the backward scan of K5's."""
    from .kernels import bvp_backward_plain, bvp_forward_plain

    dblk = bvp_rhs(ptop_p, ptop_m, pbot_p, pbot_m, ftop, bot_rhs)
    P, g = bvp_forward_plain(sol.gp, sol.gm, sol.expd, dblk, albedo, ang)
    return bvp_backward_plain(sol.gp, sol.gm, sol.expd, P, g, ang)
