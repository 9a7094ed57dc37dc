"""A float32 numpy model of K1's body at N = 17..32
(``csrc/stage1_isotropic_big.cu``, ``stage1_isotropic_big_kernel``),
lane by lane, held to the bits of the plain versions
``kernels.stage1_isotropic_plain`` and ``stage1_isotropic_beam_plain``.

The body gives each (layer, column) element a warp; lane k finds root k
(k < N).  Every sum of a root runs over all kM = 32 terms, the table
padded past N (c, 1/mu^2, 1/mu and w 0, differences 2^30), the pole's
term taken as s / s, each quotient by numpy's ``/`` in place of the
body's ``quotient`` (the same correctly rounded result inside its
range); where s (tau in Newton's sums) leaves [2^-60, 2^60] the sum is
taken again over i < N with ``/`` and the pole's select.  The body checks
no divisor: the table's distances keep every divisor in range wherever s
(or tau) is (``test_table_keeps_the_divisors_in_range``), and the model
asserts so on every sum it takes.

Each element's outputs wait in shared memory until the block of 8
elements stores them.  With the beam, lane i takes row i of S = gp + gm
from there, the system padded to 32 x 32 with the identity.  Each column
of the LU: the swap bits are the records of the pivot column from a
prefix max over the lanes (every row past the pivot where the keys rise
strictly, as S's columns do); the rows stay on their lanes, a row map
permuted by the records telling which lane holds each logical row; the
rows not yet pivots take their multipliers a_r,col * (1 / a_col,col) and
the pivot row (``lu_rows``).  Back substitution sums each row of U in
column order against the solution so far, one quotient a row; each lane
keeps the products R[., c] x_c once x_c is known.  Lane k
forms the clamped denominator of mode k, lane i zs = S scaled for row i
from the unfactored S, and w . zs runs over the lanes in order.  The kernel's
``sqrtf`` and ``expf`` are modelled by ``torch.sqrt`` and ``torch.exp``,
as in ``test_torch_wide_k1_team``.
"""

from __future__ import annotations

from collections import Counter

import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

from pyharp_tpu_torch.rt.disort import kernels as K
from pyharp_tpu_torch.rt.disort.linsolve import lu_solve
from pyharp_tpu_torch.rt.disort.solver import make_static_angles

from .test_torch_wide_k1_team import (HI, LO, TWO_KAPPA, _inputs, count,
                                      exp32, in_range, same_bits,
                                      sf_sum_plain, sqrt32, tied_system)

F32 = np.float32
M = 32                                       # terms of every sum, lanes
PAD = F32(2.0 ** 30)                         # differences past n


@pytest.fixture(autouse=True)
def one_thread():
    """One intra-op thread: the tensors here are small, and with several
    test processes on the machine their threads contend."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def tables(ang):
    """The table as the body stages it, padded to M terms: delta
    ``(M + 1, M)`` (2^30 past n), origin ``(M + 1,)``, then half, c, d,
    invmu, mu, w ``(M,)`` each (0 past n)."""
    tab = K.wide_isotropic_tables(ang)
    n = ang.mu.shape[0]
    delta = np.full((M + 1, M), PAD, F32)
    delta[:n + 1, :n] = tab[:(n + 1) * n].reshape(n + 1, n)
    origin = np.zeros(M + 1, F32)
    origin[:n + 1] = tab[(n + 1) * n:(n + 1) ** 2]
    get = {"delta": delta, "origin": origin}
    for q, name in enumerate(("half", "c", "d", "invmu", "mu", "w")):
        v = np.zeros(M, F32)
        v[:n] = tab[(n + 1) ** 2 + q * n:(n + 1) ** 2 + (q + 1) * n]
        get[name] = v
    return get


def checked(s, divisors):
    """Whether a sum takes the fast path: s within [2^-60, 2^60].  Every
    divisor is then in that range too, which the body relies on."""
    ok = in_range(s)
    a = np.abs(divisors)
    assert not (a > HI).any(), "a divisor past 2^60"
    assert not (ok & (a.min(axis=0) < LO)).any(), "a divisor under 2^-60"
    return ok


def s_f(tau, s, dlt, pole, n, ssa, c, stats=None, key="bisect"):
    """s - ssa sum_i c_i v_i as the body forms it (``s_f``): all M terms,
    no select on the pole (there s / s = 1); again over i < n with ``/``
    and the select where the range does not hold."""
    with np.errstate(all="ignore"):
        b = dlt - tau
        acc = None
        for i in range(M):
            v = s / b[i]
            acc = c[0] * v if i == 0 else acc + c[i] * v
        ok = checked(s, b)
        count(stats, key, ok)
        acc = np.where(ok, acc, sf_sum_plain(tau, s, dlt, pole, n, c))
    return s - ssa * acc


def newton_sums(tau, dlt, n, c, stats=None):
    """fs = sum_i c_i u_i and fps = sum_i c_i u_i^2, u_i = 1 / (tau -
    dlt_i): all M terms, again over i < n where the range does not hold."""
    def sums(m):
        fs = fps = None
        for i in range(m):
            u = F32(1.0) / (tau - dlt[i])
            cu = c[i] * u
            fs = cu if i == 0 else fs + cu
            fps = cu * u if i == 0 else fps + cu * u
        return fs, fps

    with np.errstate(all="ignore"):
        ok = checked(tau, tau - dlt)
        count(stats, "newton", ok)
        fs, fps = sums(M)
        pfs, pfps = sums(n)
    return np.where(ok, fs, pfs), np.where(ok, fps, pfps)


def eigenvector(tau, s, sk, invlam, dlt, pole, n, invmu, stats=None):
    """Columns k of gp and gm before their normalisation and their max
    (``eig_max``): all M terms, v = s / b with no select, 1/mu = 0 past n
    (those entries are zeros in the max); again over i < n with the
    select where the range does not hold."""
    def columns(m, fast):
        gpk, gmk = [], []
        mx = None
        for i in range(m):
            b = dlt[i] - tau
            v = s / b if fast else np.where(pole == i, F32(1.0), s / b)
            D = invmu[i] * (sk * v)
            si = -D * invmu[i] * invlam
            gpk.append(F32(0.5) * (si + D))
            gmk.append(F32(0.5) * (si - D))
            mm = np.abs(gpk[0]) if i == 0 else mx
            mm = np.maximum(mm, np.abs(gpk[i]))
            mx = np.maximum(mm, np.abs(gmk[i]))
        return np.stack(gpk[:n]), np.stack(gmk[:n]), mx

    with np.errstate(all="ignore"):
        ok = checked(s, dlt - tau)
        count(stats, "eigenvector", ok)
        gpf, gmf, mxf = columns(M, True)
        gpn, gmn, mxn = columns(n, False)
    return (np.where(ok, gpf, gpn), np.where(ok, gmf, gmn),
            np.where(ok, mxf, mxn))


def root(k, n, ssa, tb, stats=None):
    """Root k of every element as lane k finds it: x_k, its lam and the
    normalised columns k of gp and gm, ``(n, E)`` each."""
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
    inv = F32(1.0) / np.where(mx < F32(1e-30), F32(1e-30), mx)
    return xk, lamk, gpk * inv, gmk * inv


def record_bits(a, col):
    """The swap bits of column col, ``(M, E)`` booleans, as
    ``record_bits32`` forms them from lane t's entry ``a[t]``: the keys
    (-inf above col; a NaN pivot +inf, a NaN below it -inf), their
    inclusive prefix max over the lanes, and each key against the max of
    the lanes before it."""
    m = np.abs(a)
    t = np.arange(M)[:, None]
    key = np.where(t < col, -np.inf,
                   np.where(np.isnan(m), np.where(t == col, np.inf, -np.inf),
                            m)).astype(F32)
    s = np.maximum.accumulate(key, axis=0)
    e = np.concatenate([np.full_like(s[:1], -np.inf), s[:-1]])
    bits = (t > col) & (key > e)
    # the body's shortcut: keys rising strictly from col on make every
    # position past col a record
    rising = ((t <= col) | (key > np.concatenate([key[:1], key[:-1]]))).all(0)
    assert (bits[:, rising] == (t > col)).all()
    return bits


def record_source(bits, col):
    """The lane whose row moves to lane t, ``(M, E)``, as
    ``record_source32``: col takes the last record's row, each record the
    record's before it (col's for the first), every other lane its own."""
    E = bits.shape[1]
    src = np.repeat(np.arange(M)[:, None], E, axis=1)
    last = np.full(E, col)
    for r in range(col + 1, M):
        src[r] = np.where(bits[r], last, src[r])
        last = np.where(bits[r], r, last)
    src[col] = last
    return src


def lu_rows(S, rhs):
    """The body's LU of ``S`` ``(n, n, E)`` with one right-hand side ``(n,
    E)``, a row a lane, the system padded to M x M with the identity
    (``lu_rows``).  The rows stay on their lanes: ``phys[x]`` is the lane
    of the row at logical position x, and each column's records permute
    it; the lanes of the pivot rows so far are ``done``.  Returns the
    solution ``(n, E)``."""
    n, E = S.shape[0], S.shape[-1]
    R = np.zeros((M, M, E), F32)
    R[:n, :n] = S
    for t in range(n, M):
        R[t, t] = 1.0
    bv = np.zeros((M, E), F32)
    bv[:n] = rhs
    ev = np.arange(E)
    phys = np.repeat(np.arange(M)[:, None], E, axis=1)
    done = np.zeros((M, E), bool)
    with np.errstate(all="ignore"):
        for col in range(M - 1):
            a = np.take_along_axis(R[:, col], phys, axis=0)
            src = record_source(record_bits(a, col), col)
            phys = np.take_along_axis(phys, src, axis=0)
            pl = phys[col]
            done[pl, ev] = True
            live = ~done
            inv = F32(1.0) / R[pl, col, ev]
            f = R[:, col] * inv
            prow = R[pl, :, ev].T                   # (M, E), shuffled
            for j in range(col + 1, M):
                R[:, j] = np.where(live, R[:, j] - f * prow[j], R[:, j])
            bv = np.where(live, bv - f * bv[pl, ev], bv)
        x = np.zeros((M, E), F32)
        for row in range(M - 1, -1, -1):
            pr = phys[row]
            acc = bv[pr, ev]
            for c in range(row + 1, M):
                acc = acc - R[pr, c, ev]        # R[., c] x_c, every lane
            x[row] = acc / R[pr, row, ev]
            R[:, row] = R[:, row] * x[row]
    return x[:n]


def k1_big(ssa, dtau, btop, slope, ang, fbeam=None, mur=None, stats=None):
    """The body's outputs, ``(gp, gm, lam, expd, y0p, y0m, y1[, zp, zm])``
    in the plain version's shapes; ``stats`` tallies the sums that took
    the fast path and the fallback, the bisection's first step apart."""
    n = ang.mu.shape[0]
    L, B = ssa.shape
    E = L * B
    tb = tables(ang)
    ssa_e = ssa.reshape(E)
    gp = np.zeros((n, n, E), F32)
    gm = np.zeros((n, n, E), F32)
    lam = np.zeros((n, E), F32)
    xs = np.zeros((n, E), F32)
    for k in range(n):
        xs[k], lam[k], gp[:, k], gm[:, k] = root(k, n, ssa_e, tb, stats)
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
        cc = lu_rows(S, np.stack([qs * tb["d"][i] for i in range(n)]))
        inv_mur2 = F32(1.0) / (murf * murf)
        scaled = np.zeros((n, E), F32)
        for k in range(n):                         # lane k
            lam2k = np.where(xs[k] < F32(1e-12), F32(1e-12), xs[k])
            den = lam2k - inv_mur2
            fl = F32(1e-4) * (lam2k + inv_mur2)
            den = np.where(np.abs(den) < fl, np.where(den < 0.0, -fl, fl),
                           den)
            scaled[k] = cc[k] / den
        zs = np.zeros((n, E), F32)
        for i in range(n):                         # lane i
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


@pytest.mark.parametrize("nstr", range(34, 65, 2))
def test_table_keeps_the_divisors_in_range(nstr):
    """The body checks s (tau in Newton's sums) and no divisor: for every
    root k and either origin, every divisor dlt_i - tau with i off the
    origin's pole keeps at least 2^-60 from 0 for every tau the search can
    take ([-h_k, 0] below the upper origin, [0, h_k] above the lower),
    the pole's own difference is 0 (its divisor is -tau = s), and none
    passes 2^60."""
    ang = make_static_angles(nstr, nstr, 0)
    tb = tables(ang)
    n = ang.mu.shape[0]
    for k in range(n):
        h = float(tb["half"][k])
        assert LO <= h <= 2.0 ** 30
        for row, pole, lo, hi in ((k + 1, n - 1 - k, -h, 0.0),
                                  (k, n - k, 0.0, h)):
            d = tb["delta"][row].astype(np.float64)
            if pole < n:
                assert d[pole] == 0.0, (nstr, k, row)
            off = np.arange(M) != pole
            gap = np.maximum(np.maximum(lo - d, d - hi), 0.0)[off]
            assert gap.min() >= LO, (nstr, k, row, gap.min())
            assert np.abs(d).max() + h <= HI


@pytest.mark.parametrize("beam", [False, True])
@pytest.mark.parametrize("nstr", [34, 48, 64])
def test_big_body_is_the_plain_k1(nstr, beam):
    """The model's outputs are the plain version's bits at L 2 x B 5, ssa
    at 0, 1e-7 and 0.999999, one element on a beam resonance."""
    ang, ssa, dtau, btop, slope, fbeam, mur = _inputs(nstr, 2, 5, nstr)
    if beam:
        want = K.stage1_isotropic_beam_plain(ssa, dtau, btop, slope, fbeam,
                                             mur, ang)
        got = k1_big(ssa.numpy(), dtau.numpy(), btop.numpy(), slope.numpy(),
                     ang, fbeam.numpy(), mur.numpy())
        # the resonance clamp acts on the element put there
        inv = 1.0 / float(mur[1, 3]) ** 2
        x2 = float(got[2][2, 1, 3]) ** 2
        assert abs(x2 - inv) < 1e-4 * (x2 + inv)
    else:
        want = K.stage1_isotropic_plain(ssa, dtau, btop, slope, ang)
        got = k1_big(ssa.numpy(), dtau.numpy(), btop.numpy(), slope.numpy(),
                     ang)
    assert len(got) == len(want)
    names = ("gp", "gm", "lam", "expd", "y0p", "y0m", "y1", "zp", "zm")
    bad = [nm for nm, g, w in zip(names, got, want) if not same_bits(g, w)]
    assert not bad, f"nstr {nstr}: {bad} differ from the plain version"


@pytest.mark.parametrize("nstr", [34, 64])
def test_range_fallback_is_taken_and_keeps_the_bits(nstr):
    """Both ways through the body's sums, in one draw: the bisection's
    first midpoint lies below 2^-60 for most roots, so that step falls
    back to ``/``; on ssa = 0 every root's tau goes to 0, so its last
    steps, its Newton sums and its eigenvector fall back too.  The beam
    variant's outputs stay the plain version's bits."""
    ang, ssa, dtau, btop, slope, fbeam, mur = _inputs(nstr, 2, 4, 7 + nstr)
    stats = Counter()
    got = k1_big(ssa.numpy(), dtau.numpy(), btop.numpy(), slope.numpy(),
                 ang, fbeam.numpy(), mur.numpy(), stats=stats)
    want = K.stage1_isotropic_beam_plain(ssa, dtau, btop, slope, fbeam, mur,
                                         ang)
    assert all(same_bits(g, w) for g, w in zip(got, want))
    for key in ("bisect_first", "bisect", "newton", "eigenvector"):
        assert stats[key + "_fallback"] > 0, (key, stats)
    for key in ("midpoint", "bisect", "newton", "eigenvector"):
        assert stats[key + "_fast"] > 0, (key, stats)


@pytest.mark.parametrize("n", [17, 24, 32])
def test_register_lu_ties_are_the_plain_lu(n):
    """Pivot columns whose entries tie in |a| (a row below the pivot holds
    -a): no swap there, as in the bubble; the padded row LU gives the
    plain ``lu_solve``'s bits."""
    S, rhs = tied_system(n, 12, n)
    got = lu_rows(S.copy(), rhs)
    want = lu_solve(torch.from_numpy(S), torch.from_numpy(rhs))
    assert same_bits(got, want)


@settings(max_examples=15, deadline=None)
@given(n=st.integers(17, 32), seed=st.integers(0, 2**32 - 1))
def test_register_lu_is_the_plain_lu(n, seed):
    """The row LU against the plain ``lu_solve`` on drawn normal systems
    at N = 17..32, some entries rounded to a few magnitudes so that ties
    and zeros occur."""
    rng = np.random.default_rng(seed)
    S = rng.normal(size=(n, n, 6)).astype(F32)
    few = rng.random(S.shape) < 0.3
    S[few] = np.round(S[few] * 2) / 2
    rhs = rng.normal(size=(n, 6)).astype(F32)
    got = lu_rows(S.copy(), rhs)
    want = lu_solve(torch.from_numpy(S), torch.from_numpy(rhs))
    assert same_bits(got, want)
