"""The plain versions' vectorised pieces against the scalarized forms they
replaced (kept here), bit for bit with ``torch.equal``:

* the Jacobi eigensolve (``pyharp_tpu_torch/rt/disort/jacobi.py``), whose
  rotation updates every row in one tensor operation, against a list of
  lists of batch-shaped tensors and a loop over the rows;
* the phase-table contraction (``solver._ucontract_g``), one tensor
  operation a term for all entries, against a sum per entry;
* K4's plain version over the azimuthal modes in one pass
  (``kernels.stage1_general_modes_plain``) against a call per mode;
* the beam source's moments (``solver.beam_source_moments``), every
  node's sum at once, against a sum per node;
* K1's plain version at N > 8 (``kernels._stage1_isotropic_wide``) with
  every root at once, and K1 beam's with its roots and rows at once,
  against their loops over the roots;
* ``linsolve.lu_solve``'s back substitution with each row's products in
  one operation (its form on the card), and ``linsolve.cholesky_lower``
  with each column's entries below the pivot together, against their
  loops.

Each element goes through the same operations in the same order in both,
so the eigenvalues, the eigenvectors and with them the mode order of the
stage-1 kernels' plain versions are unchanged.
"""

from __future__ import annotations

import math

import numpy as np
import pytest
import torch

from pyharp_tpu_torch.rt.disort import jacobi
from pyharp_tpu_torch.rt.disort import kernels as K
from pyharp_tpu_torch.rt.disort import solver as S
from pyharp_tpu_torch.rt.disort.legendre import lepoly
from pyharp_tpu_torch.rt.disort import linsolve
from pyharp_tpu_torch.rt.disort.linsolve import cholesky_lower



@pytest.fixture(autouse=True)
def one_thread():
    """One intra-op thread: the tensors here are mid-sized, and with
    several test processes on the machine their threads contend."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)

def _rotate_rows_loop(A, V, p: int, q: int, n: int):
    """One rotation zeroing A[p][q] on the scalarized matrix, row by row:
    the form ``jacobi._rotate`` had before it was vectorised."""
    apq = A[p][q]
    app = A[p][p]
    aqq = A[q][q]

    small = apq.abs() <= torch.finfo(apq.dtype).tiny * 1e3
    one = torch.ones_like(apq)
    denom = torch.where(small, one, 2.0 * apq)
    tau = (aqq - app) / denom
    root = torch.sqrt(1.0 + tau * tau)
    t = torch.sign(tau) / (tau.abs() + root)
    t = torch.where(torch.sign(tau) == 0, 1.0 / (tau + root), t)
    t = torch.where(small, torch.zeros_like(t), t)
    c = 1.0 / torch.sqrt(1.0 + t * t)
    s = t * c

    new_pp = c * c * app - 2.0 * s * c * apq + s * s * aqq
    new_qq = s * s * app + 2.0 * s * c * apq + c * c * aqq
    for r in range(n):
        if r == p or r == q:
            continue
        arp = A[r][p]
        arq = A[r][q]
        nrp = c * arp - s * arq
        nrq = s * arp + c * arq
        A[r][p] = nrp
        A[p][r] = nrp
        A[r][q] = nrq
        A[q][r] = nrq
    A[p][p] = new_pp
    A[q][q] = new_qq
    zero = torch.zeros_like(apq)
    A[p][q] = zero
    A[q][p] = zero

    for r in range(n):
        vrp = V[r][p]
        vrq = V[r][q]
        V[r][p] = c * vrp - s * vrq
        V[r][q] = s * vrp + c * vrq


def _jacobi_loop(A, sweeps: int):
    n = A.shape[0]
    Ac = [[0.5 * (A[i, j] + A[j, i]) for j in range(n)] for i in range(n)]
    one = torch.ones_like(A[0, 0])
    zero = torch.zeros_like(A[0, 0])
    Vc = [[one if i == j else zero for j in range(n)] for i in range(n)]
    for _ in range(sweeps):
        for p in range(n - 1):
            for q in range(p + 1, n):
                _rotate_rows_loop(Ac, Vc, p, q, n)
    w = torch.stack([Ac[i][i] for i in range(n)], dim=0)
    V = torch.stack([torch.stack(row, dim=0) for row in Vc], dim=0)
    return w, V


def _matrices(n: int, dtype, seed: int):
    """A batch (3, 5) of K-like matrices: a drawn SPD part, nearly
    degenerate pairs, a zero off-diagonal row (the ``small`` branch) and a
    diagonal one (tau = 0)."""
    rng = np.random.default_rng(seed)
    B = rng.standard_normal((n, n, 3, 5))
    A = np.einsum("ik...,jk...->ij...", B, B) / n + np.eye(n)[..., None, None]
    A[:, :, 0, 1] = np.diag(np.repeat(rng.uniform(1, 2, (n + 1) // 2), 2)[:n])
    A[0, 1:, 1, 2] = A[1:, 0, 1, 2] = 0.0
    A[:, :, 2, 3] = np.eye(n) * 2.0
    return torch.tensor(A, dtype=dtype)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("n", [4, 16, 17, 32])
def test_vectorised_rotation_keeps_the_bits(n, dtype):
    A = _matrices(n, dtype, seed=n)
    # the kernels' sweep count (kernels.kernel_sweeps) but at n = 32, where
    # the row loop takes seconds a sweep: three sweeps there
    sweeps = 4 if n <= 4 else (8 if n <= 17 else 3)
    want = _jacobi_loop(A, sweeps)
    got = jacobi.jacobi_eigh(A, sweeps)
    for g, w in zip(got, want):
        assert g.shape == w.shape
        assert torch.equal(g, w)


def _contract_loop(coef, tab):
    """``solver._ucontract_g`` as a sum per table entry, the form it had
    before it was vectorised."""
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


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("nstr,m", [(8, 0), (8, 3), (34, 1), (64, 0), (64, 63)])
def test_vectorised_contraction_keeps_the_bits(nstr, m, dtype):
    """The parity tables and a table with zero columns (entries that never
    start a sum, and sums that start late), signs of zero included."""
    rng = np.random.default_rng(nstr + m)
    ang = S.make_static_angles(nstr, nstr, m)
    L, B = 3, 5
    ssa = torch.tensor(rng.uniform(0, 1, (L, B)), dtype=dtype)
    pmom = torch.tensor(rng.uniform(-1, 1, (L, nstr, B)), dtype=dtype)
    g = S._moment_coeffs(ssa, pmom, ang)
    even, odd = S._phase_outer_tables(ang)
    ragged = ang.lam_tables[:, :, None] * np.array([1.0, 0.0, -2.0])
    ragged[:m + 2, :, 2] = 0.0
    for tab in (even, odd, ragged):
        want = _contract_loop(g, tab)
        got = S._ucontract_g(g, tab)
        assert got.shape == want.shape
        assert torch.equal(got, want)
        assert torch.equal(torch.signbit(got), torch.signbit(want))


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("nstr", [8, 34])
def test_modes_in_one_pass_keep_the_bits(nstr, dtype):
    """K4's plain version over the modes m = 1..nstr-1 in one pass gives
    the outputs of a call of its own at modes 1, 2, nstr/2 and nstr - 1 (a
    beam, no thermal source)."""
    rng = np.random.default_rng(nstr)
    L, B = 2, 3
    t = lambda x: torch.tensor(x, dtype=dtype)
    ssa = t(rng.uniform(0.0, 0.99, (L, B)))
    pmom = t(0.8 ** np.arange(1, nstr + 1)[None, :, None] * np.ones((L, 1, B)))
    dtau = t(rng.uniform(0.01, 2.0, (L, B)))
    fbeam = t(rng.uniform(0.5, 4.0, B))
    mu0 = t(rng.uniform(0.1, 1.0, B))
    mur = mu0[None].expand(L, B).contiguous()
    zero = torch.zeros_like(ssa)
    angs = [S.make_static_angles(nstr, nstr, m) for m in range(1, nstr)]
    G = angs[0].lam_tables.shape[0]
    lam0s = [lepoly(mu0, a.m, G - 1).contiguous() for a in angs]
    got = K.stage1_general_modes_plain(ssa, pmom, dtau, angs, fbeam=fbeam,
                                       mur=mur, lam0s=lam0s)
    assert len(got) == nstr - 1
    for a, l0, out in zip(angs, lam0s, got):
        if a.m not in (1, 2, nstr // 2, nstr - 1):     # a call per mode
            continue                                    # takes ~1 s
        want = K.stage1_general_plain(ssa, pmom, dtau, zero, zero, a,
                                      thermal=False, fbeam=fbeam, mur=mur,
                                      lam0=l0)
        assert len(out) == len(want)
        for x, w in zip(out, want):
            assert x.shape == w.shape and torch.equal(x, w), a.m


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("nstr", [8, 34])
def test_mode_zero_with_a_thermal_source_in_the_pass(nstr, dtype):
    """With ``btop`` and ``slope``, the one pass over m = 0 and 1 gives m =
    0 the outputs of its own call with a thermal source and a beam, and m =
    1 those of its call with a beam alone."""
    rng = np.random.default_rng(100 + nstr)
    L, B = 2, 3
    t = lambda x: torch.tensor(x, dtype=dtype)
    ssa = t(rng.uniform(0.0, 0.99, (L, B)))
    pmom = t(0.8 ** np.arange(1, nstr + 1)[None, :, None] * np.ones((L, 1, B)))
    dtau = t(rng.uniform(0.01, 2.0, (L, B)))
    btop = t(rng.uniform(0.5, 3.0, (L, B)))
    slope = t(rng.uniform(-1.0, 1.0, (L, B)))
    fbeam = t(rng.uniform(0.5, 4.0, B))
    mu0 = t(rng.uniform(0.1, 1.0, B))
    mur = mu0[None].expand(L, B).contiguous()
    angs = [S.make_static_angles(nstr, nstr, m) for m in (0, 1)]
    G = angs[0].lam_tables.shape[0]
    lam0s = [lepoly(mu0, a.m, G - 1).contiguous() for a in angs]
    got = K.stage1_general_modes_plain(ssa, pmom, dtau, angs, fbeam=fbeam,
                                       mur=mur, lam0s=lam0s, btop=btop,
                                       slope=slope)
    for a, l0, out in zip(angs, lam0s, got):
        want = K.stage1_general_plain(ssa, pmom, dtau, btop, slope, a,
                                      thermal=a.m == 0, fbeam=fbeam, mur=mur,
                                      lam0=l0)
        _same(out, want)


def _beam_moments_loop(ssa, pmom, lam0, ang):
    """``solver.beam_source_moments`` with a sum per node, the form it had
    before the nodes went together."""
    g = S._moment_coeffs(ssa, pmom, ang)
    G = ang.lam_tables.shape[0]
    parity = S._const(ang.parity, ssa)
    ls = torch.arange(G, dtype=ssa.dtype, device=ssa.device)
    coef = g * ((2 * ls + 1) * parity)[None, :, None] * lam0[None]
    lam_tab, par = ang.lam_tables, ang.parity

    def qsum(signed):
        rows = []
        for i in range(lam_tab.shape[1]):
            acc = None
            for gidx in range(min(G, ang.nstr)):
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

    kappa = S.beam_kappa(ang.m)
    return kappa * qsum(False), kappa * qsum(True)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("nstr,m", [(8, 0), (8, 3), (34, 1), (64, 63)])
def test_beam_moments_at_once_keep_the_bits(nstr, m, dtype):
    """The beam source's q+- with every node's sum at once gives the loop's
    bits, m = 63 at nstr 64 among them (tables with zero entries)."""
    rng = np.random.default_rng(nstr + m)
    L, B = 2, 3
    ang = S.make_static_angles(nstr, nstr, m)
    ssa = torch.tensor(rng.uniform(0, 1, (L, B)), dtype=dtype)
    pmom = torch.tensor(rng.uniform(-1, 1, (L, nstr, B)), dtype=dtype)
    mu0 = torch.tensor(rng.uniform(0.1, 1.0, B), dtype=dtype)
    lam0 = lepoly(mu0, m, ang.lam_tables.shape[0] - 1).contiguous()
    _same(S.beam_source_moments(ssa, pmom, lam0, ang),
          _beam_moments_loop(ssa, pmom, lam0, ang))


# ---- the plain K1, K1 beam, LU and Cholesky at large N ---------------------

def _isotropic_roots_loop(ssa, dtau, btop, slope, ang):
    """``kernels._stage1_isotropic_wide`` as a loop over the roots k, the
    form it had before the roots went on a leading axis."""
    tab = K.wide_secular_tables(ang)
    delta, origin, half = tab["delta"], tab["origin"], tab["half"]
    c, mu = tab["c"], tab["mu"]
    N = mu.shape[0]
    itype = torch.int32 if ssa.dtype == torch.float32 else torch.int64

    def offsets(tau, s, dlt, pole):
        """v_i = s / (delta_i - tau), 1 on the origin's pole."""
        return [torch.where(pole == i, torch.ones_like(s),
                            s / (dlt[i] - tau)) for i in range(N)]

    def s_f(tau, s, dlt, pole):
        v = offsets(tau, s, dlt, pole)
        acc = float(c[0]) * v[0]
        for i in range(1, N):
            acc = acc + float(c[i]) * v[i]
        return s - ssa * acc

    xs, lams = [], []
    gp = [[None] * N for _ in range(N)]
    gm = [[None] * N for _ in range(N)]
    for k in range(N):
        du = [torch.full_like(ssa, float(delta[k + 1, i])) for i in range(N)]
        dl = [torch.full_like(ssa, float(delta[k, i])) for i in range(N)]
        h = torch.full_like(ssa, float(half[k]))
        # f at the bracket's midpoint, from the upper pole: root above it?
        up = s_f(-h, h, du, torch.full(ssa.shape, N - 1 - k,
                                       device=ssa.device)) > 0.0
        dlt = [torch.where(up, u, d) for u, d in zip(du, dl)]
        pole = torch.where(up, N - 1 - k, N - k)   # N: origin 0, no pole
        flip = ~up & (k > 0)                       # s = -tau < 0
        sgn = torch.where(up, -1.0, 1.0).to(ssa.dtype)     # tau = sgn a
        lo = torch.zeros_like(ssa, dtype=itype)
        hi = h.view(itype).clone()
        for _ in range(K.WIDE_BISECT):
            m = lo + ((hi - lo) >> 1)
            tau = sgn * m.view(ssa.dtype)
            s = torch.where(up | (k > 0), -tau, torch.ones_like(tau))
            g = s_f(tau, s, dlt, pole)
            pos = torch.where(flip, g < 0.0, g > 0.0)      # f > 0: root above
            grow = pos != up                               # root at larger a
            lo = torch.where(grow, m, lo)
            hi = torch.where(grow, hi, m)
        alo, ahi = lo.view(ssa.dtype), hi.view(ssa.dtype)
        tlo = torch.where(up, -ahi, alo)
        thi = torch.where(up, -alo, ahi)
        tau = sgn * (lo + ((hi - lo) >> 1)).view(ssa.dtype)
        for _ in range(2):
            fs = fps = None
            for i in range(N):
                u = 1.0 / (tau - dlt[i])
                cu = float(c[i]) * u
                fs = cu if fs is None else fs + cu
                fps = cu * u if fps is None else fps + cu * u
            f = 1.0 + ssa * fs
            fp = -ssa * fps
            fp_safe = torch.where(fp < -1e-30, fp, torch.full_like(fp, -1e-30))
            tn = torch.minimum(torch.maximum(tau - f / fp_safe, tlo), thi)
            tau = torch.where(torch.isfinite(tn), tn, tau)
        x = torch.where(up, torch.full_like(ssa, float(origin[k + 1])),
                        torch.full_like(ssa, float(origin[k]))) + tau
        xs.append(x)
        s = torch.where(up | (k > 0), -tau, torch.ones_like(tau))
        v = offsets(tau, s, dlt, pole)
        # (-1)^k sign(s): the sign of prod_j (d_j - x) / s
        sk = torch.where(flip, -1.0, 1.0).to(ssa.dtype) * (-1.0) ** k
        lams.append(torch.sqrt(x.clamp_min(1e-12)))
        invlam = 1.0 / lams[k]
        mx = None
        for i in range(N):
            Di = float(1.0 / mu[i]) * (sk * v[i])
            si = -Di * float(1.0 / mu[i]) * invlam
            gp[i][k] = 0.5 * (si + Di)
            gm[i][k] = 0.5 * (si - Di)
            mx = gp[0][k].abs() if mx is None else mx
            mx = torch.maximum(mx, gp[i][k].abs())
            mx = torch.maximum(mx, gm[i][k].abs())
        inv = 1.0 / mx.clamp_min(1e-30)
        for i in range(N):
            gp[i][k] = gp[i][k] * inv
            gm[i][k] = gm[i][k] * inv

    lam = torch.stack(lams)
    expd = torch.exp(-lam * dtau[None])
    y1 = slope[None].expand(N, *slope.shape).clone()
    muc = torch.as_tensor(mu, dtype=ssa.dtype, device=ssa.device)[:, None, None]
    y0p = btop[None] + muc * slope[None]
    y0m = btop[None] - muc * slope[None]
    return (torch.stack([torch.stack(r) for r in gp]),
            torch.stack([torch.stack(r) for r in gm]),
            lam, expd, y0p, y0m, y1), xs



def _isotropic_beam_loop(ssa, dtau, btop, slope, fbeam, mur, ang):
    """``kernels.stage1_isotropic_beam_plain`` with a loop over the roots
    and the rows, on the roots of :func:`_isotropic_roots_loop` (its form
    before both were vectorised)."""
    out, xs = _isotropic_roots_loop(ssa, dtau, btop, slope, ang)
    gp, gm = out[0], out[1]
    mu = np.asarray(ang.mu, np.float64)
    w = np.asarray(ang.w, np.float64)
    N = mu.shape[0]
    kappa = 1.0 / (4.0 * np.pi)
    amp = ssa * fbeam[None]
    qs = 2.0 * kappa * amp
    rhs = torch.stack([qs * float(1.0 / mu[i] ** 2) for i in range(N)])
    Sm = gp + gm
    cc = _lu_solve_loop(Sm, rhs)
    inv_mur2 = 1.0 / (mur * mur)
    eps = S.beam_resonance_eps(ssa.dtype)
    scaled = []
    for k in range(N):
        lam2k = xs[k].clamp_min(1e-12)
        den = lam2k - inv_mur2
        floor = eps * (lam2k + inv_mur2)
        den = torch.where(den.abs() < floor, torch.where(den < 0, -floor, floor),
                          den)
        scaled.append(cc[k] / den)
    zs = S._umv(Sm, torch.stack(scaled))
    wz = S._uwdot_static(w, zs)
    zp, zm = [], []
    for i in range(N):
        uz = zs[i] - ssa * wz                       # (I - ssa 1 w^T) zs
        zd = -mur * (uz - qs) * float(1.0 / mu[i])
        zp.append(0.5 * (zs[i] + zd))
        zm.append(0.5 * (zs[i] - zd))
    return out + (torch.stack(zp), torch.stack(zm))



def _lu_solve_loop(A, b):
    """``linsolve.lu_solve`` with its back substitution a product and a
    subtraction a term, the form it had before each row's products went
    into one operation."""
    n = A.shape[0]
    vec = b.ndim == A.ndim - 1
    if vec:
        b = b[:, None]
    M = torch.cat([A, b.to(A.dtype)], dim=1)
    for col in range(n - 1):
        a = M[col:, col].abs()
        key = torch.where(a.isnan(), -math.inf, a)
        key[0] = torch.where(a[0].isnan(), math.inf, a[0])
        beat = key[1:] > key.cummax(0).values[:-1]
        rows = torch.arange(col + 1, n, device=M.device)
        rows = rows.view(-1, *(1,) * (a.dim() - 1))
        last = torch.where(beat, rows, col).cummax(0).values
        before = torch.cat([torch.full_like(last[:1], col), last[:-1]])
        idx = torch.cat([last[-1:], torch.where(beat, before, rows)]) - col
        M[col:] = torch.gather(M[col:], 0,
                               idx[:, None].expand(n - col, *M.shape[1:]))
        inv = 1.0 / M[col, col]
        f = M[col + 1:, col] * inv
        M[col + 1:] = M[col + 1:] - f[:, None] * M[col][None]
    x = [None] * n
    for row in range(n - 1, -1, -1):
        acc = M[row, n:]
        for col in range(row + 1, n):
            acc = acc - M[row, col][None] * x[col]
        x[row] = acc / M[row, row][None]
    out = torch.stack(x, dim=0)
    return out[:, 0] if vec else out


def _cholesky_loop(A, floor=1e-30):
    """``linsolve.cholesky_lower`` entry by entry, the form it had before
    each column's entries below the pivot went together."""
    n = A.shape[0]
    Lc = [[None] * n for _ in range(n)]
    for j in range(n):
        d = A[j, j]
        for k in range(j):
            d = d - Lc[j][k] * Lc[j][k]
        d = torch.sqrt(d.clamp_min(floor))
        Lc[j][j] = d
        inv = 1.0 / d
        for i in range(j + 1, n):
            v = A[i, j]
            for k in range(j):
                v = v - Lc[i][k] * Lc[j][k]
            Lc[i][j] = v * inv
    zero = torch.zeros_like(A[0, 0])
    return torch.stack([torch.stack([Lc[i][j] if j <= i else zero
                                     for j in range(n)]) for i in range(n)])


def _isotropic_inputs(nstr, dtype, L=2, B=3):
    """Drawn isotropic inputs: ssa over (0, 1) with 0, 1e-7 and 0.999999
    among them (a root on its pole, a root near the fallback's range), a
    resonance-clamped beam in one element."""
    rng = np.random.default_rng(4000 + nstr)
    t = lambda x: torch.tensor(x, dtype=dtype)
    ssa = rng.uniform(0.0, 0.99, (L, B))
    ssa.flat[:3] = (0.0, 1e-7, 0.999999)
    ang = S.make_static_angles(nstr, nstr, 0)
    mu0 = rng.uniform(0.1, 1.0, B)
    mu0[0] = ang.mu[nstr // 4]          # lam ~ 1/mu0 near a node
    mur = np.broadcast_to(mu0, (L, B)).copy()
    return ang, (t(ssa), t(rng.uniform(0.01, 2.0, (L, B))),
                 t(rng.uniform(0.5, 2.0, (L, B))),
                 t(rng.uniform(-0.5, 0.5, (L, B)))), \
        (t(rng.uniform(0.5, 4.0, B)), t(mur))


def _same(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g.shape == w.shape
        assert torch.equal(g, w)
        assert torch.equal(torch.signbit(g), torch.signbit(w))


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("nstr", [18, 66, 130])
def test_isotropic_roots_at_once_keep_the_bits(nstr, dtype):
    """K1's plain version at N = 9, 33, 65 with every root at once gives
    the outputs and roots of its loop over the roots."""
    ang, s1, _ = _isotropic_inputs(nstr, dtype)
    out, xs = K._stage1_isotropic_wide(*s1, ang)
    want, wxs = _isotropic_roots_loop(*s1, ang)
    _same(out, want)
    _same(list(xs), wxs)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("nstr", [18, 66, 130])
def test_isotropic_beam_at_once_keeps_the_bits(nstr, dtype):
    """K1 beam's plain version at N = 9, 33, 65 (its roots, clamped
    denominators and rows at once) gives the outputs of its loops."""
    ang, s1, (fbeam, mur) = _isotropic_inputs(nstr, dtype)
    got = K.stage1_isotropic_beam_plain(*s1, fbeam, mur, ang)
    want = _isotropic_beam_loop(*s1, fbeam, mur, ang)
    _same(got, want)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("n", [9, 33, 65])
def test_back_substitution_by_rows_keeps_the_bits(n, dtype, monkeypatch):
    """``lu_solve`` with each row's products in one operation (its form on
    the card) gives the loop's bits, on drawn systems with ties and one and
    three right-hand sides."""
    rng = np.random.default_rng(n)
    A = rng.choice(np.array([0.0, 1.0, -1.0, 0.5, 2.0]), (n, n, 2, 3))
    A = A + rng.standard_normal((n, n, 2, 3)) * (rng.uniform(size=(2, 3)) > 0.5)
    A = torch.tensor(A + 3.0 * np.eye(n)[..., None, None], dtype=dtype)
    form = linsolve.back_substitute
    monkeypatch.setattr(linsolve, "back_substitute",
                        lambda M, n, by_rows: form(M, n, True))
    for b in (torch.tensor(rng.standard_normal((n, 2, 3)), dtype=dtype),
              torch.tensor(rng.standard_normal((n, 3, 2, 3)), dtype=dtype)):
        _same([linsolve.lu_solve(A.clone(), b)],
              [_lu_solve_loop(A.clone(), b)])


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("n", [9, 33, 65])
def test_cholesky_by_columns_keeps_the_bits(n, dtype):
    """``cholesky_lower`` with each column's entries below the pivot
    together gives the loop's bits, a singular matrix floored among
    them."""
    rng = np.random.default_rng(100 + n)
    X = rng.standard_normal((n, n, 2, 3))
    A = np.einsum("ik...,jk...->ij...", X, X) / n
    A[:, :, 0, 0] = 0.0
    A = torch.tensor(A, dtype=dtype)
    _same([cholesky_lower(A, floor=1e-12)], [_cholesky_loop(A, floor=1e-12)])
