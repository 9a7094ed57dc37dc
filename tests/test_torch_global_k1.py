"""A float32 numpy model of K1's body at N > 64
(``csrc/stage1_isotropic_global.cu``, ``stage1_isotropic_global_kernel``),
held to the bits of the plain versions ``kernels.stage1_isotropic_plain``
and ``stage1_isotropic_beam_plain``.

The body gives each (layer, column) element a warp; lane t finds the
roots t + 32 j in turn, j over the run-time sets, each as the bodies of
N <= 64 find theirs, every sum over its N terms read from the unpadded
table ``kernels.wide_isotropic_tables`` at the offsets the body computes
(delta's row o at o N, then the origins, half, c, 1/mu^2, 1/mu, mu, w).
Each quotient is checked where it is formed: the fast path where both
operands lie in [2^-60, 2^60] (there the correctly rounded quotient,
exactly 1 on the origin's pole), else ``/`` and the pole's select.  The
model runs the 32 lanes of a set side by side, ``(32, E)`` arrays, and
counts the terms each way takes.

With the beam, S = gp + gm and a copy with the right-hand side
qs / mu_i^2 in column N sit in the element's slab of global scratch;
global.cuh's warp LU (``test_torch_global_bvp.warp_lu_solve_global``: the
records over the run-time row sets, the swaps record by record, each row
below the pivot on lane r mod 32, back substitution dividing by the pivot)
solves the copy.  Lane k forms the clamped denominators of its modes, lane
i zs_i = S scaled for its rows from the unfactored S, and every lane
w . zs in the plain order.
"""

from __future__ import annotations

from collections import Counter

import numpy as np
import pytest
import torch

from pyharp_tpu_torch.rt.disort import kernels as K

from .test_torch_global_bvp import warp_lu_solve_global
from .test_torch_wide_k1_team import (HI, LO, TWO_KAPPA, _inputs, exp32,
                                      same_bits)

F32 = np.float32
LANES = 32


@pytest.fixture(autouse=True)
def one_thread():
    """One intra-op thread: the tensors here are mid-sized, and with
    several test processes on the machine their threads contend."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def offsets(n: int) -> dict[str, int]:
    """The body's offsets into the table (``IsoTab``)."""
    off = {"origin": (n + 1) * n}
    off["half"] = off["origin"] + n + 1
    for a, b in (("c", "half"), ("d", "c"), ("invmu", "d"), ("mu", "invmu"),
                 ("w", "mu")):
        off[a] = off[b] + n
    return off


def in_range(x):
    a = np.abs(x)
    return (a >= LO) & (a <= HI)


def checked_v(s, b, on_pole, stats, key):
    """``v_of``: s / b by the fast path where |s| and |b| lie in its range
    (the correctly rounded quotient), else ``/`` and 1 on the pole."""
    fast = in_range(s) & in_range(b)
    with np.errstate(all="ignore"):
        q = s / b
    stats[key + "_fast"] += int(fast.sum())
    stats[key + "_fallback"] += int((~fast).sum())
    return np.where(fast, q, np.where(on_pole, F32(1.0), q))


def lane_roots(j, n, ssa, tab, off, stats):
    """Set j of every element's warp: lane t finds root k = t + 32 j (the
    lanes with k >= n idle, here clipped and dropped by the caller).
    Returns ``(k, x_k, lam_k, gp[:, k], gm[:, k])``, ``(32, E)`` and
    ``(n, 32, E)``."""
    E = ssa.shape[0]
    k = np.minimum(np.arange(LANES) + LANES * j, n - 1)[:, None]
    kE = np.broadcast_to(k, (LANES, E))
    c = tab[off["c"]:off["c"] + n]

    def dlt(row, i):
        return tab[row * n + i]

    def s_f(tau, s, row, pole, key):
        acc = None
        for i in range(n):
            v = checked_v(s, dlt(row, i) - tau, pole == i, stats, key)
            acc = c[i] * v if acc is None else acc + c[i] * v
        return s - ssa[None] * acc

    h = np.broadcast_to(tab[off["half"] + k], (LANES, E))
    up = s_f(-h, h, kE + 1, n - 1 - kE, "midpoint") > 0.0
    row = np.where(up, kE + 1, kE)
    pole = np.where(up, n - 1 - kE, n - kE)
    flip = ~up & (kE > 0)
    zero = ~up & (kE == 0)
    sgn = np.where(up, F32(-1.0), F32(1.0))
    lo = np.zeros((LANES, E), np.int32)
    hi = np.ascontiguousarray(h).view(np.int32).copy()
    for _ in range(K.WIDE_BISECT):
        m = lo + ((hi - lo) >> 1)
        tau = sgn * m.view(F32)
        s = np.where(zero, F32(1.0), -tau)
        g = s_f(tau, s, row, pole, "bisect")
        pos = np.where(flip, g < 0.0, g > 0.0)
        grow = pos != up
        lo = np.where(grow, m, lo)
        hi = np.where(grow, hi, m)
    alo, ahi = lo.view(F32), hi.view(F32)
    tlo = np.where(up, -ahi, alo)
    thi = np.where(up, -alo, ahi)
    tau = sgn * (lo + ((hi - lo) >> 1)).view(F32)
    with np.errstate(all="ignore"):
        for _ in range(2):
            fs = fps = None
            for i in range(n):
                b = tau - dlt(row, i)
                fast = in_range(b)
                stats["newton_fast"] += int(fast.sum())
                stats["newton_fallback"] += int((~fast).sum())
                u = F32(1.0) / b                     # correctly rounded
                cu = c[i] * u
                fs = cu if fs is None else fs + cu
                fps = cu * u if fps is None else fps + cu * u
            f = F32(1.0) + ssa[None] * fs
            fp = -ssa[None] * fps
            fp_safe = np.where(fp < F32(-1e-30), fp, F32(-1e-30))
            tn = tau - f / fp_safe
            tn = np.where(tn < tlo, tlo, tn)
            tn = np.where(tn > thi, thi, tn)
            tau = np.where(np.isfinite(tn), tn, tau)
        xk = tab[off["origin"] + row] + tau
        s = np.where(zero, F32(1.0), -tau)
        sk = (np.where(flip, F32(-1.0), F32(1.0))
              * np.where(kE & 1, F32(-1.0), F32(1.0)))
        lamk = torch.sqrt(torch.from_numpy(
            np.where(xk < F32(1e-12), F32(1e-12), xk))).numpy()
        invlam = F32(1.0) / lamk
        gps, gms = [], []
        mx = None
        for i in range(n):
            v = checked_v(s, dlt(row, i) - tau, pole == i, stats,
                          "eigenvector")
            invmu = tab[off["invmu"] + i]
            D = invmu * (sk * v)
            si = -D * invmu * invlam
            gps.append(F32(0.5) * (si + D))
            gms.append(F32(0.5) * (si - D))
            m = np.abs(gps[0]) if i == 0 else mx
            m = np.where(np.isnan(m) | (m > np.abs(gps[i])), m,
                         np.abs(gps[i]))
            mx = np.where(np.isnan(m) | (m > np.abs(gms[i])), m,
                          np.abs(gms[i]))
        inv = F32(1.0) / np.where(mx < F32(1e-30), F32(1e-30), mx)
    return (k[:, 0], xk, lamk, np.stack(gps) * inv[None],
            np.stack(gms) * inv[None])


def k1_global(ssa, dtau, btop, slope, ang, fbeam=None, mur=None, stats=None):
    """The body's outputs, ``(gp, gm, lam, expd, y0p, y0m, y1[, zp, zm])``
    in the plain version's shapes."""
    stats = Counter() if stats is None else stats
    n = ang.mu.shape[0]
    L, B = ssa.shape
    E = L * B
    tab = K.wide_isotropic_tables(ang)
    off = offsets(n)
    ssa_e = ssa.reshape(E)
    gp = np.zeros((n, n, E), F32)
    gm = np.zeros((n, n, E), F32)
    lam = np.zeros((n, E), F32)
    xs = np.zeros((n, E), F32)
    for j in range((n + LANES - 1) // LANES):       # the lanes' roots
        k, xk, lamk, gpk, gmk = lane_roots(j, n, ssa_e, tab, off, stats)
        live = np.arange(LANES) + LANES * j < n
        xs[k[live]] = xk[live]
        lam[k[live]] = lamk[live]
        gp[:, k[live]] = gpk[:, live]
        gm[:, k[live]] = gmk[:, live]
    expd = exp32(-lam * dtau.reshape(E))
    mu = tab[off["mu"]:off["mu"] + n]
    sl, bt = slope.reshape(E), btop.reshape(E)
    y1 = np.stack([sl] * n)
    y0p = np.stack([bt + mu[i] * sl for i in range(n)])
    y0m = np.stack([bt - mu[i] * sl for i in range(n)])
    out = [gp, gm, lam, expd, y0p, y0m, y1]
    if fbeam is not None:
        d = tab[off["d"]:off["d"] + n]
        w = tab[off["w"]:off["w"] + n]
        invmu = tab[off["invmu"]:off["invmu"] + n]
        murf = mur.reshape(E)
        qs = TWO_KAPPA * (ssa_e * np.tile(fbeam, L))
        S = gp + gm
        A = np.concatenate([S, np.stack([qs * d[i] for i in range(n)])[:, None]],
                           axis=1)
        for e in range(E):                     # the warp LU, an element each
            sys_ = np.ascontiguousarray(A[..., e])
            warp_lu_solve_global(sys_, n, 1)
            A[..., e] = sys_
        cc = A[:, n]
        inv_mur2 = F32(1.0) / (murf * murf)
        lam2k = np.where(xs < F32(1e-12), F32(1e-12), xs)   # lane k % 32
        den = lam2k - inv_mur2
        fl = F32(1e-4) * (lam2k + inv_mur2)
        den = np.where(np.abs(den) < fl, np.where(den < 0.0, -fl, fl), den)
        scaled = cc / den
        zs = S[:, 0] * scaled[0]                   # lane i % 32, each row
        for k in range(1, n):
            zs = zs + S[:, k] * scaled[k]
        wz = w[0] * zs[0]
        for i in range(1, n):
            wz = wz + w[i] * zs[i]
        uz = zs - ssa_e * wz
        zd = -murf * (uz - qs) * invmu[:, None]
        out += [F32(0.5) * (zs + zd), F32(0.5) * (zs - zd)]
    return tuple(x.reshape(*x.shape[:-1], L, B) for x in out)


@pytest.mark.parametrize("nstr, beam", [(130, False), (130, True),
                                        (258, False), (258, True)])
def test_global_body_is_the_plain_k1(nstr, beam):
    """The model's outputs are the plain version's bits at L 2 x B 5
    (thermal) and 2 x 4 (beam) (N = 65 and 129: 3 and 5 sets of roots, the
    last partial), ssa at 0, 1e-7 and 0.999999, one element on a beam
    resonance.  Both ways through the checked quotients are taken: the roots
    of ssa = 0 and the bisection's first midpoints below 2^-60 fall back
    to ``/``, the rest take the fast path."""
    L, B = (2, 4) if beam else (2, 5)
    ang, ssa, dtau, btop, slope, fbeam, mur = _inputs(nstr, L, B, nstr)
    stats = Counter()
    if beam:
        want = K.stage1_isotropic_beam_plain(ssa, dtau, btop, slope, fbeam,
                                             mur, ang)
        got = k1_global(ssa.numpy(), dtau.numpy(), btop.numpy(),
                        slope.numpy(), ang, fbeam.numpy(), mur.numpy(),
                        stats=stats)
    else:
        want = K.stage1_isotropic_plain(ssa, dtau, btop, slope, ang)
        got = k1_global(ssa.numpy(), dtau.numpy(), btop.numpy(),
                        slope.numpy(), ang, stats=stats)
    assert len(got) == len(want)
    names = ("gp", "gm", "lam", "expd", "y0p", "y0m", "y1", "zp", "zm")
    bad = [nm for nm, g, w in zip(names, got, want) if not same_bits(g, w)]
    assert not bad, f"nstr {nstr}: {bad} differ from the plain version"
    assert all(np.isfinite(g).all() for g in got)
    for key in ("bisect", "eigenvector"):
        assert stats[key + "_fallback"] > 0, (key, stats)
    for key in ("midpoint", "bisect", "newton", "eigenvector"):
        assert stats[key + "_fast"] > 0, (key, stats)


@pytest.mark.parametrize("nstr", [130, 200, 258, 1000])
def test_table_offsets_are_the_bodys(nstr):
    """The body's offsets read the table's pieces where
    ``wide_isotropic_tables`` puts them, at any N: the last entry of each
    is its last, and w ends the table."""
    from pyharp_tpu_torch.rt.disort.solver import make_static_angles

    ang = make_static_angles(nstr, nstr, 0)
    n = ang.mu.shape[0]
    tab = K.wide_isotropic_tables(ang)
    ref = K.wide_secular_tables(ang)
    off = offsets(n)
    assert off["w"] + n == tab.size
    np.testing.assert_array_equal(tab[:off["origin"]].reshape(n + 1, n),
                                  ref["delta"].astype(F32))
    for name, want in (("origin", ref["origin"]), ("half", ref["half"]),
                       ("c", ref["c"]), ("d", 1.0 / ref["mu"] ** 2),
                       ("invmu", 1.0 / ref["mu"]), ("mu", ref["mu"]),
                       ("w", ang.w)):
        got = tab[off[name]:off[name] + len(want)]
        np.testing.assert_array_equal(got, np.asarray(want).astype(F32))
