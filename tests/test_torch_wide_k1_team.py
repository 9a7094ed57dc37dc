"""A float32 numpy model of K1's body at N = 9..16
(``csrc/stage1_isotropic_wide.cu``, ``stage1_isotropic_wide_kernel``),
lane by lane, held to the bits of the plain versions
``kernels.stage1_isotropic_plain`` and ``stage1_isotropic_beam_plain``.

Each sum of a root is formed as the body forms it: over all kNMax = 16
terms, the table padded past N (c = 0, differences 2^30), the pole's term
of s f taken as s / s, each quotient by numpy's ``/`` in place of the
body's ``quotient`` (the same correctly rounded result inside its range),
and the sum taken again over i < N with ``/`` and the pole's select where
s or a divisor leaves [2^-60, 2^60].

The body gives each (layer, column) element a team of G = 4 lanes.  Lane
t finds the roots k = t, t + 4, t + 8, t + 12 (k < N), each by the plain
version's operations in its order (``root``), and stores the columns k of
gp and gm.  With the beam, lane t then holds the columns k = s*G + t of
S = gp + gm (``C[t, s]``) and every lane the right-hand side.  Each
column of the LU: the owner of the pivot column forms the swap bits, the
records of the column (row r swaps where |a_r| beats, strictly, every
|a_k| for col <= k < r), every lane swaps its columns' entries and the
right-hand side as the bubble does, row col with each record row in
turn, and takes the pivot column from its owner for the multipliers
(``team_lu``).  Back substitution reads U's rows from their columns'
owners.  Each lane forms its modes' clamped denominators, every lane
takes every mode's scaled coefficient, lane t sums zs for its rows
s*G + t from the unfactored S, and every lane takes every zs for w . zs.
The kernel's ``sqrtf`` and ``expf`` are modelled by ``torch.sqrt`` and
``torch.exp``: on the card torch's match them bit for bit (``chip_smoke.py``
phase 19), and on the CPU the plain version runs torch's own, which
numpy's need not match.
"""

from __future__ import annotations

from collections import Counter

import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

from pyharp_tpu_torch.bench.problems import stage1_inputs
from pyharp_tpu_torch.rt.disort import kernels as K
from pyharp_tpu_torch.rt.disort.linsolve import lu_solve
from pyharp_tpu_torch.rt.disort.solver import make_static_angles

F32 = np.float32
NMAX = 16
G = 4
SLOTS = NMAX // G
TWO_KAPPA = F32(2.0 * (1.0 / (4.0 * 3.141592653589793)))
LO, HI = F32(2.0 ** -60), F32(2.0 ** 60)    # the range of `quotient`
PAD = F32(2.0 ** 30)                         # dlt past n


def sqrt32(x):
    return torch.sqrt(torch.from_numpy(np.asarray(x, F32))).numpy()


def exp32(x):
    return torch.exp(torch.from_numpy(np.asarray(x, F32))).numpy()


def tables(ang):
    """The float32 table the body stages into shared memory, by name."""
    tab = K.wide_isotropic_tables(ang)
    n = ang.mu.shape[0]
    off = {"delta": 0, "origin": (n + 1) * n}
    off["half"] = off["origin"] + n + 1
    for a, b in (("c", "half"), ("d", "c"), ("invmu", "d"), ("mu", "invmu"),
                 ("w", "mu")):
        off[a] = off[b] + n
    get = {k: tab[v:v + n] for k, v in off.items() if k not in ("delta",
                                                              "origin")}
    get["delta"] = tab[:(n + 1) * n].reshape(n + 1, n)
    get["origin"] = tab[off["origin"]:off["origin"] + n + 1]
    return get


def in_range(x):
    """|x| within [2^-60, 2^60], where the body's quotients are exact."""
    a = np.abs(x)
    return (a >= LO) & (a <= HI)


def pad(dlt, c, n):
    """A root's differences and c over all kNMax terms, as the body holds
    them: dlt = 2^30 and c = 0 past n."""
    d16 = np.full((NMAX,) + dlt.shape[1:], PAD, F32)
    d16[:n] = dlt[:n]
    c16 = np.zeros(NMAX, F32)
    c16[:n] = c[:n]
    return d16, c16


def count(stats, key, ok):
    """Tally the elements of a sum that took the fast path and those that
    fell back to ``/``."""
    if stats is not None:
        stats[key + "_fast"] += int(ok.sum())
        stats[key + "_fallback"] += int((~ok).sum())


def sf_sum_plain(tau, s, dlt, pole, n, c):
    """sum_i c_i v_i over i < n, v_i = s / (dlt_i - tau), 1 on the pole."""
    acc = None
    for i in range(n):
        v = np.where(pole == i, F32(1.0), s / (dlt[i] - tau))
        acc = c[0] * v if i == 0 else acc + c[i] * v
    return acc


def s_f(tau, s, dlt, pole, n, ssa, c, stats=None, key="bisect"):
    """s - ssa sum_i c_i v_i as the body forms it (``sf_sum``): all kNMax
    terms with the padded table and no select on the pole (there s / s =
    1), each quotient exact (numpy's ``/`` for the body's ``quotient``)
    where s and every divisor lie in [2^-60, 2^60]; where one does not,
    the sum again over i < n with ``/`` and the pole's select."""
    d16, c16 = pad(dlt, c, n)
    with np.errstate(all="ignore"):
        acc = None
        lo = np.full(np.shape(tau), HI, F32)
        hi = np.zeros(np.shape(tau), F32)
        for i in range(NMAX):
            b = d16[i] - tau
            lo = np.fmin(lo, np.abs(b))
            hi = np.fmax(hi, np.abs(b))
            v = s / b
            acc = c16[0] * v if i == 0 else acc + c16[i] * v
        ok = in_range(s) & (lo >= LO) & (hi <= HI)
        count(stats, key, ok)
        acc = np.where(ok, acc, sf_sum_plain(tau, s, dlt, pole, n, c))
    return s - ssa * acc


def newton_sums(tau, dlt, n, c, stats=None):
    """fs = sum_i c_i u_i and fps = sum_i c_i u_i^2, u_i = 1 / (tau -
    dlt_i), as the body forms them (``newton_sums``): all kNMax terms,
    the padded ones adding zeros, and again over i < n with ``/`` where a
    divisor leaves [2^-60, 2^60]."""
    d16, c16 = pad(dlt, c, n)

    def sums(m, d, cc):
        fs = fps = None
        lo = np.full(np.shape(tau), HI, F32)
        hi = np.zeros(np.shape(tau), F32)
        for i in range(m):
            b = tau - d[i]
            lo = np.fmin(lo, np.abs(b))
            hi = np.fmax(hi, np.abs(b))
            u = F32(1.0) / b
            cu = cc[i] * u
            fs = cu if i == 0 else fs + cu
            fps = cu * u if i == 0 else fps + cu * u
        return fs, fps, (lo >= LO) & (hi <= HI)

    with np.errstate(all="ignore"):
        fs, fps, ok = sums(NMAX, d16, c16)
        count(stats, "newton", ok)
        pfs, pfps, _ = sums(n, dlt, c)
    return np.where(ok, fs, pfs), np.where(ok, fps, pfps)


def eigenvector(tau, s, sk, invlam, dlt, pole, n, invmu, stats=None):
    """Columns k of gp and gm before their normalisation and their max, as
    the body forms them (``eigenvector``): all kNMax terms, 1/mu = 0 past
    n, the max over i < n; again over i < n with ``/`` where s or a
    divisor off the pole leaves [2^-60, 2^60]."""
    d16, _ = pad(dlt, np.zeros(n, F32), n)
    im16 = np.zeros(NMAX, F32)
    im16[:n] = invmu

    def columns(m, d, fast):
        gpk, gmk = [], []
        mx = None
        ok = in_range(s)
        for i in range(m):
            b = d[i] - tau
            if fast:
                ok = ok & (in_range(b) | (pole == i) | (i >= n))
            v = np.where(pole == i, F32(1.0), s / b)
            D = im16[i] * (sk * v)
            si = -D * im16[i] * invlam
            gpk.append(F32(0.5) * (si + D))
            gmk.append(F32(0.5) * (si - D))
            mm = np.abs(gpk[0]) if i == 0 else mx
            mm = np.fmax(mm, np.abs(gpk[i]))
            mm = np.fmax(mm, np.abs(gmk[i]))
            mx = mm if i < n else mx
        return np.stack(gpk[:n]), np.stack(gmk[:n]), mx, ok

    with np.errstate(all="ignore"):
        gp16, gm16, mx16, ok = columns(NMAX, d16, True)
        count(stats, "eigenvector", ok)
        gpn, gmn, mxn, _ = columns(n, dlt, False)
    return (np.where(ok, gp16, gpn), np.where(ok, gm16, gmn),
            np.where(ok, mx16, mxn))


def root(k, n, ssa, tb, stats=None):
    """Root k of every element as lane k % G finds it: x_k, its lam and
    the normalised columns k of gp and gm, ``(n, E)`` each.  ``stats``
    tallies the sums that took the fast path and the fallback, the
    bisection's first step apart."""
    E = ssa.shape[0]
    c = tb["c"]
    h = np.full(E, tb["half"][k], F32)
    du = np.repeat(tb["delta"][k + 1][:, None], E, axis=1)
    dl = np.repeat(tb["delta"][k][:, None], E, axis=1)
    up = s_f(-h, h, du, np.full(E, n - 1 - k), n, ssa, c, stats,
             "midpoint") > 0.0
    dlt = np.where(up[None], du, dl)
    pole = np.where(up, n - 1 - k, n - k)
    flip = ~up & (k > 0)
    zero = ~up & (k == 0)
    sgn = np.where(up, F32(-1.0), F32(1.0))
    lo = np.zeros(E, np.int32)
    hi = h.view(np.int32).copy()
    for it in range(K.WIDE_BISECT):
        m = lo + ((hi - lo) >> 1)
        tau = sgn * m.view(F32)
        s = np.where(zero, F32(1.0), -tau)
        g = s_f(tau, s, dlt, pole, n, ssa, c, stats,
                "bisect_first" if it == 0 else "bisect")
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
            fs, fps = newton_sums(tau, dlt, n, c, stats)
            f = F32(1.0) + ssa * fs
            fp = -ssa * fps
            fp_safe = np.where(fp < F32(-1e-30), fp, F32(-1e-30))
            tn = tau - f / fp_safe
            tn = np.where(tn < tlo, tlo, tn)
            tn = np.where(tn > thi, thi, tn)
            tau = np.where(np.isfinite(tn), tn, tau)
    xk = np.where(up, tb["origin"][k + 1], tb["origin"][k]) + tau
    s = np.where(zero, F32(1.0), -tau)
    sk = np.where(flip, F32(-1.0), F32(1.0)) * (F32(-1.0) if k & 1 else F32(1.0))
    lamk = sqrt32(np.where(xk < F32(1e-12), F32(1e-12), xk))
    invlam = F32(1.0) / lamk
    gpk, gmk, mx = eigenvector(tau, s, sk, invlam, dlt, pole, n,
                               tb["invmu"], stats)
    inv = F32(1.0) / np.fmax(mx, F32(1e-30))
    return xk, lamk, gpk * inv, gmk * inv


def team_lu(S, rhs):
    """The body's LU of ``S`` ``(n, n, E)`` with one right-hand side ``(n,
    E)``, lane by lane: ``C[t, s, i]`` = S[i, s*G + t] (zero outside n x
    n), the right-hand side ``bv`` in every lane (one copy: every lane
    forms it alike).  Returns the solution every lane holds."""
    n, E = S.shape[0], S.shape[-1]
    C = np.zeros((G, SLOTS, NMAX, E), F32)
    for t in range(G):
        for s in range(SLOTS):
            if s * G + t < n:
                C[t, s, :n] = S[:, s * G + t]
    bv = np.zeros((NMAX, E), F32)
    bv[:n] = rhs
    with np.errstate(all="ignore"):
        for col in range(n):
            oc, sc = col % G, col // G
            # the owner's records, handed to the team
            run = np.abs(C[oc, sc, col])
            bits = np.zeros((NMAX, E), bool)
            for r in range(col + 1, n):
                a = np.abs(C[oc, sc, r])
                bits[r] = a > run
                run = np.where(bits[r], a, run)
            for r in range(col + 1, n):
                sw = bits[r]
                for t in range(G):
                    for s in range(SLOTS):
                        if s * G + G - 1 >= col:
                            a, b = C[t, s, col].copy(), C[t, s, r].copy()
                            C[t, s, col] = np.where(sw, b, a)
                            C[t, s, r] = np.where(sw, a, b)
                a, b = bv[col].copy(), bv[r].copy()
                bv[col], bv[r] = np.where(sw, b, a), np.where(sw, a, b)
            inv = F32(1.0) / C[oc, sc, col]
            for r in range(col + 1, n):
                f = C[oc, sc, r] * inv                 # shuffled from oc
                for t in range(G):
                    for s in range(SLOTS):
                        if s * G + G - 1 > col:
                            C[t, s, r] = C[t, s, r] - f * C[t, s, col]
                bv[r] = bv[r] - f * bv[col]
        for row in range(n - 1, -1, -1):          # bv[row] becomes x_row
            acc = bv[row].copy()
            for cl in range(row + 1, n):
                acc = acc - C[cl % G, cl // G, row] * bv[cl]
            bv[row] = acc / C[row % G, row // G, row]
    return bv[:n]


def k1_team(ssa, dtau, btop, slope, ang, fbeam=None, mur=None, stats=None):
    """The body's outputs, ``(gp, gm, lam, expd, y0p, y0m, y1[, zp, zm])``
    in the plain version's shapes; ``stats`` as :func:`root`'s."""
    n = ang.mu.shape[0]
    L, B = ssa.shape
    E = L * B
    tb = tables(ang)
    ssa_e = ssa.reshape(E)
    gp = np.zeros((n, n, E), F32)
    gm = np.zeros((n, n, E), F32)
    lam = np.zeros((n, E), F32)
    xs = np.zeros((n, E), F32)
    for t in range(G):
        for s in range(SLOTS):
            k = s * G + t
            if k < n:
                xs[k], lam[k], gp[:, k], gm[:, k] = root(k, n, ssa_e, tb,
                                                         stats)
    expd = exp32(-lam * dtau.reshape(E))
    mu = tb["mu"]
    sl, bt = slope.reshape(E), btop.reshape(E)
    y1 = np.stack([sl] * n)
    y0p = np.stack([bt + mu[i] * sl for i in range(n)])
    y0m = np.stack([bt - mu[i] * sl for i in range(n)])
    out = [gp, gm, lam, expd, y0p, y0m, y1]
    if fbeam is not None:
        murf = mur.reshape(E)
        qs = TWO_KAPPA * (ssa_e * np.tile(fbeam, L))
        S = gp + gm
        cc = team_lu(S, np.stack([qs * tb["d"][i] for i in range(n)]))
        inv_mur2 = F32(1.0) / (murf * murf)
        scaled = np.zeros((n, E), F32)
        for t in range(G):                         # each lane its modes
            for s in range(SLOTS):
                k = s * G + t
                if k < n:
                    lam2k = np.where(xs[k] < F32(1e-12), F32(1e-12), xs[k])
                    den = lam2k - inv_mur2
                    fl = F32(1e-4) * (lam2k + inv_mur2)
                    den = np.where(np.abs(den) < fl,
                                   np.where(den < 0.0, -fl, fl), den)
                    scaled[k] = cc[k] / den
        zs = np.zeros((n, E), F32)
        for t in range(G):                         # each lane its rows
            for s in range(SLOTS):
                i = s * G + t
                if i < n:
                    acc = S[i, 0] * scaled[0]
                    for k in range(1, n):
                        acc = acc + S[i, k] * scaled[k]
                    zs[i] = acc
        wz = tb["w"][0] * zs[0]
        for i in range(1, n):
            wz = wz + tb["w"][i] * zs[i]
        zp, zm = [], []
        for i in range(n):
            uz = zs[i] - ssa_e * wz
            zd = -murf * (uz - qs) * tb["invmu"][i]
            zp.append(F32(0.5) * (zs[i] + zd))
            zm.append(F32(0.5) * (zs[i] - zd))
        out += [np.stack(zp), np.stack(zm)]
    return tuple(x.reshape(*x.shape[:-1], L, B) for x in out)


def same_bits(got, want) -> bool:
    want = np.ascontiguousarray(want.numpy())
    got = np.ascontiguousarray(got)
    return got.shape == want.shape and np.array_equal(got.view(np.int32),
                                                      want.view(np.int32))


def _inputs(nstr: int, L: int, B: int, seed: int):
    """Stage-1 inputs with ssa = 0 (every root on its pole), 1e-7 (a root
    within ~1e-7 c_k of it) and 0.999999 in the first three elements; a
    beam, and one element's beam cosine put on the resonance of its root
    k = 2 (1/mur^2 = lam_2^2), where the denominator is clamped."""
    ang = make_static_angles(nstr, nstr, 0)
    ssa, dtau, btop, slope = stage1_inputs(L, B, seed=seed, device="cpu")
    ssa[0, 0], ssa[0, 1], ssa[0, 2] = 0.0, 1e-7, 0.999999
    rng = np.random.default_rng(seed)
    fbeam = torch.tensor(rng.uniform(0.5, 4.0, B), dtype=torch.float32)
    mur = torch.tensor(rng.uniform(0.1, 1.0, (L, B)), dtype=torch.float32)
    xs = K._stage1_isotropic_wide(ssa, dtau, btop, slope, ang)[1]
    mur[1, 3] = float(1.0 / torch.sqrt(xs[2][1, 3].double()))
    return ang, ssa, dtau, btop, slope, fbeam, mur


@pytest.mark.parametrize("beam", [False, True])
@pytest.mark.parametrize("nstr", [18, 22, 26, 32])
def test_team_body_is_the_plain_k1(nstr, beam):
    """The model's outputs are the plain version's bits at L 2 x B 7: an
    element count no block of 32 divides, ssa at 0, 1e-7 and 0.999999,
    one element on a beam resonance."""
    ang, ssa, dtau, btop, slope, fbeam, mur = _inputs(nstr, 2, 7, nstr)
    if beam:
        want = K.stage1_isotropic_beam_plain(ssa, dtau, btop, slope, fbeam,
                                             mur, ang)
        got = k1_team(ssa.numpy(), dtau.numpy(), btop.numpy(), slope.numpy(),
                      ang, fbeam.numpy(), mur.numpy())
        # the resonance clamp acts on the element put there
        inv = 1.0 / float(mur[1, 3]) ** 2
        x2 = float(got[2][2, 1, 3]) ** 2
        assert abs(x2 - inv) < 1e-4 * (x2 + inv)
    else:
        want = K.stage1_isotropic_plain(ssa, dtau, btop, slope, ang)
        got = k1_team(ssa.numpy(), dtau.numpy(), btop.numpy(), slope.numpy(),
                      ang)
    assert len(got) == len(want)
    names = ("gp", "gm", "lam", "expd", "y0p", "y0m", "y1", "zp", "zm")
    bad = [nm for nm, g, w in zip(names, got, want) if not same_bits(g, w)]
    assert not bad, f"nstr {nstr}: {bad} differ from the plain version"


@pytest.mark.parametrize("nstr", [18, 32])
def test_range_fallback_is_taken_and_keeps_the_bits(nstr):
    """Both ways through the body's sums, in one draw: the bisection's
    first midpoint is half the bits of the bracket's half width, below
    2^-60 for most roots, so that step falls back to ``/``; on ssa = 0
    every root's tau goes to 0, so its last steps, its Newton sums (the
    pole's divisor) and its eigenvector (s) fall back too.  The beam
    variant's outputs stay the plain version's bits."""
    ang, ssa, dtau, btop, slope, fbeam, mur = _inputs(nstr, 2, 5, 7 + nstr)
    stats = Counter()
    got = k1_team(ssa.numpy(), dtau.numpy(), btop.numpy(), slope.numpy(),
                  ang, fbeam.numpy(), mur.numpy(), stats=stats)
    want = K.stage1_isotropic_beam_plain(ssa, dtau, btop, slope, fbeam, mur,
                                         ang)
    assert all(same_bits(g, w) for g, w in zip(got, want))
    for key in ("bisect_first", "bisect", "newton", "eigenvector"):
        assert stats[key + "_fallback"] > 0, (key, stats)
    for key in ("midpoint", "bisect", "newton", "eigenvector"):
        assert stats[key + "_fast"] > 0, (key, stats)


def tied_system(n: int, E: int, seed: int):
    """S with ties in its pivot columns: entries of a few magnitudes of
    either sign, so |a| ties are common, and each column's top entries
    copied down with their sign flipped."""
    rng = np.random.default_rng(seed)
    S = rng.choice(np.array([-2.0, -1.0, -0.5, 0.5, 1.0, 2.0], F32),
                   size=(n, n, E)) + np.eye(n, dtype=F32)[:, :, None] * F32(0.25)
    for col in range(n - 1):
        S[col + 1, col] = -S[col, col]
    rhs = rng.normal(size=(n, E)).astype(F32)
    return S.astype(F32), rhs


@pytest.mark.parametrize("n", [9, 16])
def test_team_lu_ties_are_the_plain_lu(n):
    """A pivot column whose entries tie in |a| (a row below the pivot holds
    -a): no swap there, as in the bubble; the team LU gives the plain
    ``lu_solve``'s bits."""
    S, rhs = tied_system(n, 12, n)
    got = team_lu(S.copy(), rhs)
    want = lu_solve(torch.from_numpy(S), torch.from_numpy(rhs))
    assert same_bits(got, want)


@settings(max_examples=20, deadline=None)
@given(n=st.integers(9, 16), seed=st.integers(0, 2**32 - 1))
def test_team_lu_is_the_plain_lu(n, seed):
    """The team LU against the plain ``lu_solve`` on drawn normal systems
    at every N = 9..16."""
    rng = np.random.default_rng(seed)
    S = rng.normal(size=(n, n, 6)).astype(F32)
    rhs = rng.normal(size=(n, 6)).astype(F32)
    got = team_lu(S.copy(), rhs)
    want = lu_solve(torch.from_numpy(S), torch.from_numpy(rhs))
    assert same_bits(got, want)
