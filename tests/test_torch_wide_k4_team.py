"""A float32 numpy model of K4's body at N = 9..16
(``csrc/stage1_general_wide.cu``, ``stage1_general_wide_kernel``), held to
the bits of the plain ``kernels.stage1_general_plain``.

The body gives each (layer, column) element a team of G lanes (G = 4 as
built; the model takes any G that divides 16).  Lane t owns rows
s*G + t of every matrix.  The Jacobi matrix A, full and symmetric, sits in
the lanes' registers (Y, the eigenvectors, by rows in shared memory), and
every lane holds A's diagonal; every sweep runs the 120 (p, q) pairs of
N = 16 in the cyclic order, those with q >= N skipped.  In a rotation
the owner of row q broadcasts its copy of a_pq, every lane forms c, s and
the new diagonal and updates columns p and q of its other rows (and of
all its rows of Y), then the owner of row q gathers its new row from
column q, one shuffle per entry; the rows' copies of the diagonal are
not kept, and row p's copy is gathered from column p once after all the
rotations of p, which do not read it.  ``team_rotate`` models that
lane by lane on arrays ``A[t, s, j]``.  The rest of the body runs row by
row over the team from shared memory in the plain version's operation
order: ``k4_team`` models it in the kernel's order, each matrix entry
formed as the lane that owns its row forms it, and the LUs as
``lu_solve_rt`` (the kernel eliminates each column by rows over the
team, its swaps and back substitution on the first lane).  The kernel's ``sqrtf`` and
``expf`` are modelled by ``torch.sqrt`` and ``torch.exp``: on the card
torch's match them bit for bit (``chip_smoke.py`` phase 19), and on the
CPU the plain version runs torch's own, which numpy's need not match
(torch's float32 sqrt on the CPU is not always correctly rounded).
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

from pyharp_tpu_torch.rt.disort import jacobi
from pyharp_tpu_torch.rt.disort import kernels as K
from pyharp_tpu_torch.rt.disort.legendre import lepoly
from pyharp_tpu_torch.rt.disort.solver import make_static_angles

F32 = np.float32
NMAX = 16
TINY = F32(torch.finfo(torch.float32).tiny * 1e3)


def sqrt32(x):
    return torch.sqrt(torch.from_numpy(np.asarray(x, F32))).numpy()


def rotation_scalars(app, apq, aqq):
    """c, s and the new diagonal of ``jacobi._rotate``, as the kernel forms
    them (its 1 / (tau + root) where sign(tau) = 0 is 1 / 1)."""
    small = np.abs(apq) <= TINY
    denom = np.where(small, F32(1.0), F32(2.0) * apq)
    tau = (aqq - app) / denom
    root = sqrt32(F32(1.0) + tau * tau)
    sg = np.sign(tau)
    t = sg / (np.abs(tau) + root)
    t = np.where(sg == 0, F32(1.0), t)
    t = np.where(small, F32(0.0), t)
    c = F32(1.0) / sqrt32(F32(1.0) + t * t)
    s = t * c
    new_pp = c * c * app - F32(2.0) * s * c * apq + s * s * aqq
    new_qq = s * s * app + F32(2.0) * s * c * apq + c * c * aqq
    return c, s, new_pp, new_qq


def team_rotate(A, Y, diag, p: int, q: int, G: int) -> None:
    """One rotation on the team, in place: ``A[t, s]`` and ``Y[t, s]``
    hold row s*G + t of lane t, each ``(16, E)``; ``diag`` ``(16, E)`` the
    diagonal every lane holds."""
    R = NMAX // G
    op, sp, oq, sq = p % G, p // G, q % G, q // G
    apq = A[oq, sq, p].copy()                 # row q's copy, shuffled
    c, s, new_pp, new_qq = rotation_scalars(diag[p], apq, diag[q])
    for t in range(G):
        for k in range(R):
            arp, arq = A[t, k, p].copy(), A[t, k, q].copy()
            if not ((k == sp and t == op) or (k == sq and t == oq)):
                A[t, k, p] = c * arp - s * arq
                A[t, k, q] = s * arp + c * arq
            vrp, vrq = Y[t, k, p].copy(), Y[t, k, q].copy()
            Y[t, k, p] = c * vrp - s * vrq
            Y[t, k, q] = s * vrp + c * vrq
    for r in range(NMAX):                      # row q, a shuffle each
        if r in (p, q):
            continue
        A[oq, sq, r] = A[r % G, r // G, q]
    diag[p] = new_pp
    diag[q] = new_qq
    A[oq, sq, p] = 0.0


def team_row_refresh(A, p: int, G: int) -> None:
    """Row p's copy after the rotations of p, gathered from column p."""
    for r in range(NMAX):
        if r != p:
            A[p % G, p // G, r] = A[r % G, r // G, p]


def team_jacobi(Kfull, n: int, sweeps: int, G: int):
    """The sweeps on the team from the symmetric ``(16, 16, E)`` matrix
    (zero outside n x n); returns the full A (its diagonal from ``diag``)
    and Y, ``(16, 16, E)``."""
    R = NMAX // G
    E = Kfull.shape[-1]
    A = np.zeros((G, R, NMAX, E), F32)
    Y = np.zeros((G, R, NMAX, E), F32)
    for t in range(G):
        for k in range(R):
            A[t, k] = Kfull[k * G + t]
            Y[t, k, k * G + t] = 1.0
    diag = np.stack([Kfull[j, j] for j in range(NMAX)])
    for _ in range(sweeps):
        for p in range(NMAX - 1):
            for q in range(p + 1, NMAX):
                if q < n:
                    team_rotate(A, Y, diag, p, q, G)
            if p + 1 < n:
                team_row_refresh(A, p, G)
    rows = lambda X: np.stack([X[i % G, i // G] for i in range(NMAX)])
    Af = rows(A)
    for j in range(NMAX):
        Af[j, j] = diag[j]
    return Af, rows(Y)


def lu_solve_rt(A, b):
    """wide.cuh's lu_solve_rt, vectorised over elements: ``A`` ``(n, n,
    E)``, ``b`` ``(n, E)``, both overwritten; returns x.  The swaps differ
    per element, so each is a masked exchange."""
    n = b.shape[0]
    for col in range(n):
        for r in range(col + 1, n):
            sw = np.abs(A[r, col]) > np.abs(A[col, col])
            for j in range(col, n):
                hi = np.where(sw, A[r, j], A[col, j])
                lo = np.where(sw, A[col, j], A[r, j])
                A[col, j], A[r, j] = hi, lo
            hi = np.where(sw, b[r], b[col])
            lo = np.where(sw, b[col], b[r])
            b[col], b[r] = hi, lo
        inv = F32(1.0) / A[col, col]
        for r in range(col + 1, n):
            f = A[r, col] * inv
            for j in range(col + 1, n):
                A[r, j] = A[r, j] - f * A[col, j]
            b[r] = b[r] - f * b[col]
    x = np.zeros_like(b)
    for row in range(n - 1, -1, -1):
        acc = b[row].copy()
        for c in range(row + 1, n):
            acc = acc - A[row, c] * x[c]
        x[row] = acc / A[row, row]
    return x


def nan_max(a, b):
    return np.where((a != a) | (a > b), a, b)


def k4_team(ssa, pmom, dtau, btop, slope, ang, *, thermal, fbeam=None,
            mur=None, lam0=None, sweeps=8, G=4):
    """The body on float32 numpy inputs of ``stage1_general_plain``'s
    shapes; returns its outputs in its order (y's only with ``thermal``,
    zp, zm only with ``fbeam``)."""
    L, nmom, B = pmom.shape
    E = L * B
    n = ang.mu.shape[0]
    tab = K.general_tables(ang)
    nn3, nn2 = 2 * n * n * n, 2 * n * n
    even, odd = tab[:nn3], tab[nn3:2 * nn3]
    o = 2 * nn3
    lam_t, lam_s, c2p = tab[o:o + nn2], tab[o + nn2:o + 2 * nn2], tab[o + 2 * nn2:]
    mu, w = c2p[2 * n:3 * n], c2p[3 * n:4 * n]
    # the table's square roots, as the plain version takes them with torch
    sqw, sqm = sqrt32(w), sqrt32(mu)
    sqmsqw = sqm * sqw
    lmax = min(nmom, 2 * n - 1)
    p0, p1 = ang.m, ang.m + 1          # the tables are zero below l = m
    ssa = ssa.reshape(E)
    g = [np.ones(E, F32)] + [pmom[:, l - 1].reshape(E) if l <= lmax
                             else np.zeros(E, F32) for l in range(1, 2 * n)]

    def contract(t, ls, i, j):
        """The kernel's sum, zero entries included (the plain version skips
        them: only the sign of a zero sum can differ, and no use sees it)."""
        acc = np.zeros(E, F32)
        for l in range(ls, min(2 * n, lmax + 1), 2):
            tv = t[(l * n + i) * n + j]
            acc = (np.full(E, tv, F32) if l == 0 else g[l] * tv) if l == ls \
                else acc + g[l] * tv
        return acc

    with np.errstate(all="ignore"):
        # the Cholesky: the owner of row j forms the pivot, every lane
        # then the rows below it; each entry in the plain order
        Lc = np.zeros((n, n, E), F32)
        for j in range(n):
            se = contract(even, p0, j, j)
            d = (F32(1.0) - ssa * ((sqw[j] * se) * sqw[j])) / (sqm[j] * sqm[j])
            for k in range(j):
                d = d - Lc[j, k] * Lc[j, k]
            Lc[j, j] = sqrt32(np.where(d < F32(1e-12), F32(1e-12), d))
            inv = F32(1.0) / Lc[j, j]
            for i in range(j + 1, n):
                se = contract(even, p0, i, j)
                v = (F32(0.0) - ssa * ((sqw[i] * se) * sqw[j])) / (sqm[i] * sqm[j])
                for k in range(j):
                    v = v - Lc[i, k] * Lc[j, k]
                Lc[i, j] = v * inv
        # VL and K by rows; the symmetric part in full rows
        VL = np.zeros((n, n, E), F32)
        for k in range(n):
            vh = [((F32(1.0) if k == m else F32(0.0))
                   - ssa * ((sqw[k] * contract(odd, p1, k, m)) * sqw[m]))
                  / (sqm[k] * sqm[m]) for m in range(n)]
            for j in range(n):
                acc = vh[j] * Lc[j, j]
                for m in range(j + 1, n):
                    acc = acc + vh[m] * Lc[m, j]
                VL[k, j] = acc
        Km = np.zeros((n, n, E), F32)
        for i in range(n):
            for j in range(n):
                acc = Lc[i, i] * VL[i, j]
                for k in range(i + 1, n):
                    acc = acc + Lc[k, i] * VL[k, j]
                Km[i, j] = acc
        Kfull = np.zeros((NMAX, NMAX, E), F32)
        for i in range(n):
            for j in range(n):
                Kfull[i, j] = F32(0.5) * (Km[i, j] + Km[j, i])
        A, Y = team_jacobi(Kfull, n, sweeps, G)
        lam = np.stack([sqrt32(np.where(A[k, k] < F32(1e-12), F32(1e-12),
                                         A[k, k])) for k in range(n)])
        D = np.zeros((n, n, E), F32)
        for i in range(n):
            for k in range(n):
                acc = Lc[i, 0] * Y[0, k]
                for j in range(1, i + 1):
                    acc = acc + Lc[i, j] * Y[j, k]
                D[i, k] = acc / sqmsqw[i]
        Vf = np.stack([np.stack([(F32(1.0) if i == j else F32(0.0))
                                 - ssa * (contract(odd, p1, i, j) * w[j])
                                 for j in range(n)]) for i in range(n)])
        gp = np.zeros((n, n, E), F32)
        gm = np.zeros((n, n, E), F32)
        for k in range(n):
            gpk, gmk, mx = [], [], np.full(E, -1.0, F32)
            for i in range(n):
                acc = Vf[i, 0] * D[0, k]
                for j in range(1, n):
                    acc = acc + Vf[i, j] * D[j, k]
                sv = -acc / (mu[i] * lam[k])
                gpk.append(F32(0.5) * (sv + D[i, k]))
                gmk.append(F32(0.5) * (sv - D[i, k]))
            for t in range(G):                 # each lane's rows, then the team
                m_t = np.full(E, -1.0, F32)
                for i in range(t, n, G):
                    m_t = nan_max(nan_max(m_t, np.abs(gpk[i])), np.abs(gmk[i]))
                mx = nan_max(mx, m_t)
            scale = np.where(mx < F32(1e-30), F32(1e-30), mx)
            for i in range(n):
                gp[i, k] = gpk[i] / scale
                gm[i, k] = gmk[i] / scale
        Sg = gp + gm
        lam_t32 = torch.from_numpy(lam.reshape(n, L, B))
        expd = torch.exp(-lam_t32 * torch.from_numpy(dtau)[None]).numpy()
        Uf = np.stack([np.stack([(F32(1.0) if i == j else F32(0.0))
                                 - ssa * (contract(even, p0, i, j) * w[j])
                                 for j in range(n)]) for i in range(n)])
        shape = lambda x: x.reshape(*x.shape[:-1], L, B)
        out = [shape(gp), shape(gm), shape(lam), expd]
        if thermal:
            h = lu_solve_rt(Uf.copy(), np.stack([(F32(1.0) - ssa) * F32(1.0)] * n))
            y1 = slope.reshape(E) * h
            y0d = lu_solve_rt(Vf.copy(), np.stack([(F32(2.0) * mu[i]) * y1[i]
                                                   for i in range(n)]))
            bt = btop.reshape(E)
            out += [shape(bt * h + F32(0.5) * y0d), shape(bt * h - F32(0.5) * y0d),
                    shape(y1)]
        else:
            out += [np.zeros((n, L, B), F32)] * 3
        if fbeam is None:
            return tuple(out)
        kappa = F32((2.0 if ang.m > 0 else 1.0) / (4.0 * 3.141592653589793))
        bidx = np.tile(np.arange(B), L)
        amp = ssa * fbeam[bidx]
        murf = mur.reshape(E)
        qs, qd = [], []
        for i in range(n):
            accp = accm = None
            for l in range(min(2 * n, lmax + 1)):
                coef = (g[l] * c2p[l]) * lam0[l][bidx]
                tl = lam_t[l * n + i]
                if tl != 0:
                    tp, tm = coef * tl, coef * lam_s[l * n + i]
                    accp = tp if accp is None else accp + tp
                    accm = tm if accm is None else accm + tm
            qp, qm = (kappa * accp) * amp, (kappa * accm) * amp
            qs.append(qp + qm)
            qd.append(qp - qm)
        qsmu = [qs[i] / mu[i] for i in range(n)]
        rhs = []
        for i in range(n):
            acc = Vf[i, 0] * qsmu[0]
            for j in range(1, n):
                acc = acc + Vf[i, j] * qsmu[j]
            rhs.append(acc / mu[i] - qd[i] / (mu[i] * murf))
        cc = lu_solve_rt(Sg.copy(), np.stack(rhs))
        inv = F32(1.0) / (murf * murf)
        scaled = []
        for k in range(n):
            lam2 = lam[k] * lam[k]
            den = lam2 - inv
            fl = F32(1e-4) * (lam2 + inv)
            den = np.where(np.abs(den) < fl, np.where(den < 0, -fl, fl), den)
            scaled.append(cc[k] / den)
        zp, zm = [], []
        zs = []
        for i in range(n):
            acc = Sg[i, 0] * scaled[0]
            for k in range(1, n):
                acc = acc + Sg[i, k] * scaled[k]
            zs.append(acc)
        for i in range(n):
            uz = Uf[i, 0] * zs[0]
            for j in range(1, n):
                uz = uz + Uf[i, j] * zs[j]
            zd = -murf * (uz - qs[i]) / mu[i]
            zp.append(F32(0.5) * (zs[i] + zd))
            zm.append(F32(0.5) * (zs[i] - zd))
        return tuple(out) + (shape(np.stack(zp)), shape(np.stack(zm)))


def _inputs(nstr: int, L: int, B: int, seed: int):
    rng = np.random.default_rng(seed)
    t = lambda x: torch.tensor(x, dtype=torch.float32)
    ssa = rng.uniform(0.0, 0.999, (L, B))
    gg = rng.uniform(0.2, 0.85, (L, 1, B))
    pmom = gg ** np.arange(1, nstr + 1)[None, :, None]
    dtau = rng.uniform(0.01, 2.0, (L, B))
    btop = rng.uniform(0.5, 3.0, (L, B))
    slope = rng.uniform(-1.0, 1.0, (L, B))
    fbeam = rng.uniform(0.5, 4.0, B)
    mu0 = rng.uniform(0.1, 1.0, B)
    mur = np.broadcast_to(mu0, (L, B)).copy()
    return (t(ssa), t(pmom), t(dtau), t(btop), t(slope), t(fbeam), t(mur),
            t(mu0))


@pytest.mark.parametrize("nstr, case", [
    (nstr, case) for nstr in (18, 22, 32)
    for case in ("m0_thermal", "m0_beam", "m1_beam")] + [(32, "m29_beam")])
def test_team_body_is_the_plain_k4(nstr, case):
    """The modelled body gives ``stage1_general_plain``'s float32 bits at
    nstr 18, 22 and 32 (N = 9, 11, 16) on L = 2 x B = 3 elements: m = 0
    with a thermal source and no beam, m = 0 with a beam and no thermal
    source, m = 1 with a beam; and at nstr 32, m = 29 with a beam, where
    some entries of the phase tables at l >= m underflow to zero in
    float32 (the plain version skips them, the body adds them)."""
    m = {"m1_beam": 1, "m29_beam": 29}.get(case, 0)
    ssa, pmom, dtau, btop, slope, fbeam, mur, mu0 = _inputs(nstr, 2, 3, nstr + m)
    ang = make_static_angles(nstr, nstr, m)
    thermal = case == "m0_thermal"
    kw = dict(thermal=thermal)
    if case != "m0_thermal":
        lam0 = lepoly(mu0, m, ang.lam_tables.shape[0] - 1).contiguous()
        kw.update(fbeam=fbeam, mur=mur, lam0=lam0)
    want = K.stage1_general_plain(ssa, pmom, dtau, btop, slope, ang, **kw)
    npk = {k: (v.numpy() if isinstance(v, torch.Tensor) else v)
           for k, v in kw.items()}
    got = k4_team(ssa.numpy(), pmom.numpy(), dtau.numpy(), btop.numpy(),
                  slope.numpy(), ang, **npk)
    assert len(got) == len(want)
    for idx, (x, w) in enumerate(zip(got, want)):
        np.testing.assert_array_equal(x, w.numpy(), err_msg=f"output {idx}")


@pytest.mark.parametrize("G", [4, 8])
@pytest.mark.parametrize("pq", [(0, 1), (1, 5), (2, 10), (3, 15)])
def test_team_rotation_is_jacobi_rotate(G, pq):
    """One modelled rotation, its gathers included, gives ``jacobi._rotate``'s
    bits on a drawn symmetric 16 x 16 matrix and eigenvector block (the
    diagonal from the lanes' copy, the rest from the rows'), for rows p
    and q held by one lane (p = q mod G) and by two, in one slot and in
    two."""
    p, q = pq
    rng = np.random.default_rng(10 * p + q + G)
    E = 5
    M = rng.standard_normal((NMAX, NMAX, E)).astype(F32)
    M = (M + M.transpose(1, 0, 2)) * F32(0.5)
    V = rng.standard_normal((NMAX, NMAX, E)).astype(F32)
    R = NMAX // G
    A = np.stack([np.stack([M[k * G + t] for k in range(R)]) for t in range(G)])
    Yt = np.stack([np.stack([V[k * G + t] for k in range(R)]) for t in range(G)])
    diag = np.stack([M[j, j] for j in range(NMAX)])
    team_rotate(A, Yt, diag, p, q, G)
    team_row_refresh(A, p, G)
    # [A, V] transposed (A symmetric), as jacobi_eigh holds it
    T = torch.from_numpy(np.concatenate([M, V.transpose(1, 0, 2)], axis=1))
    jacobi._rotate(T, NMAX, p, q)
    At, Vt = T[:, :NMAX], T[:, NMAX:].transpose(0, 1)
    for i in range(NMAX):
        np.testing.assert_array_equal(diag[i], At[i, i].numpy())
        for j in range(NMAX):
            if i != j:
                np.testing.assert_array_equal(A[i % G, i // G, j],
                                              At[i, j].numpy())
            np.testing.assert_array_equal(Yt[i % G, i // G, j], Vt[i, j].numpy())
