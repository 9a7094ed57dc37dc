"""A float32 numpy model of K4's body at N = 17..32
(``csrc/stage1_general_big.cu``), held to the bits of ``jacobi._rotate``
and of the plain ``kernels.stage1_general_plain``.

The body gives each (layer, column) element a warp, lane t owning row t,
except in the sweeps, where one warp takes the two elements of a block,
16 lanes each and two rows a lane (one instruction stream forms both
elements' rotations; each element's arithmetic is the same).  The Jacobi
matrix A keeps one copy of each entry, (r, c) at X[max][min] in shared
memory (a rotation writes an entry and its mirror with the same value),
and Y, the eigenvectors, sits by rows beside it.  In the q loop of a fixed
p, the lane holding row r carries a_rp and y_rp in registers and stores
them when the loop ends; a_pq is the register of row q's lane (a
shuffle), a_qq the diagonal as the loop began (row q's lane keeps its new
a_qq and stores it with column p), a_pp the last rotation's new_pp.
``big_sweeps`` models that row by row;
``test_big_sweeps_are_jacobi_rotate`` holds it to ``jacobi.jacobi_eigh``
over whole sweeps.  ``k4_big`` models the whole body in its order: Uhat's
lower triangle (the contractions by columns), the right-looking Cholesky
(each entry's subtractions in k order), VL = Vhat Lc in place by rows,
K[t][j] and K[j][t] on lane t, the sweeps, D and Sg in place a column at
a time, the beam's LU on a copy of Sg (big.cuh's warp LU,
``warp_lu_solve`` of ``test_torch_big_bvp``), Uf formed once, the thermal
LUs.  The kernel's
``sqrtf`` and ``expf`` are modelled by ``torch.sqrt`` and ``torch.exp``
(``test_torch_wide_k4_team``); its quotients and square roots without a
range check are ``/`` and ``sqrtf`` where the range holds, which
``chip_smoke.py`` checks on the card (``kernels.root_check``).
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

from pyharp_tpu_torch.rt.disort import jacobi
from pyharp_tpu_torch.rt.disort import kernels as K
from pyharp_tpu_torch.rt.disort.legendre import lepoly
from pyharp_tpu_torch.rt.disort.solver import make_static_angles

from .test_torch_big_bvp import warp_lu_solve
from .test_torch_wide_k4_team import (_inputs, nan_max, rotation_scalars,
                                      sqrt32)

F32 = np.float32


@pytest.fixture(autouse=True)
def one_thread():
    """One intra-op thread: the tensors here are mid-sized, and with
    several test processes on the machine their threads contend."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def big_sweeps(A0, n: int, sweeps: int):
    """The sweeps of the body on the symmetric ``(n, n, E)`` matrix
    ``A0``: ``(X, Y)``, X holding A's lower triangle (its upper triangle
    untouched, here zero) and Y the eigenvectors by rows."""
    E = A0.shape[-1]
    X = np.zeros((n, n, E), F32)
    for i in range(n):
        for j in range(i + 1):
            X[i, j] = A0[i, j]
    Y = np.zeros((n, n, E), F32)
    for i in range(n):
        Y[i, i] = 1.0

    def slot(r, c):
        return (r, c) if r > c else (c, r)

    lanes = range(n)
    for _ in range(sweeps):
        for p in range(n - 1):
            app = X[p, p].copy()
            arp = [np.zeros(E, F32) if t == p else X[slot(t, p)].copy()
                   for t in lanes]
            yrp = [Y[t, p].copy() for t in lanes]
            dq = [np.zeros(E, F32) for _ in lanes]
            for q in range(p + 1, n):
                apq = arp[q].copy()                    # lane q's, shuffled
                aqq = X[q, q].copy()
                with np.errstate(over="ignore"):   # tau^2 past float32
                    c, s, new_pp, new_qq = rotation_scalars(app, apq, aqq)
                # every lane reads before any lane writes in a rotation
                arq = [X[slot(t, q)].copy() if t not in (p, q) else None
                       for t in lanes]
                vrq = [Y[t, q].copy() for t in lanes]
                for t in lanes:
                    if t not in (p, q):
                        nrp = c * arp[t] - s * arq[t]
                        X[slot(t, q)] = s * arp[t] + c * arq[t]
                        arp[t] = nrp
                    elif t == q:
                        arp[t] = np.zeros(E, F32)
                        dq[t] = new_qq
                    Y[t, q] = s * yrp[t] + c * vrq[t]
                    yrp[t] = c * yrp[t] - s * vrq[t]
                app = new_pp
            for t in lanes:                           # column p, once
                if t == p:
                    X[p, p] = app
                else:
                    X[slot(t, p)] = arp[t]
                if t > p:
                    X[t, t] = dq[t]
                Y[t, p] = yrp[t]
    return X, Y


@pytest.mark.parametrize("n", [17, 24, 32])
def test_big_sweeps_are_jacobi_rotate(n):
    """Eight modelled sweeps, pivots carried by register and shuffle, give
    ``jacobi_eigh``'s bits (its ``_rotate`` in the cyclic order) on drawn
    symmetric float32 matrices with a repeated diagonal entry and a zero
    off-diagonal one: the eigenvalues from X's diagonal, every other entry
    of A from X's lower triangle, the eigenvectors from Y."""
    rng = np.random.default_rng(n)
    E = 3
    M = rng.standard_normal((n, n, E)).astype(F32)
    M = (M + M.transpose(1, 0, 2)) * F32(0.5)
    M[3, 3] = M[5, 5]
    M[2, 7] = M[7, 2] = 0.0
    X, Y = big_sweeps(M, n, 8)
    w, V = jacobi.jacobi_eigh(torch.from_numpy(M), 8)
    np.testing.assert_array_equal(np.stack([X[k, k] for k in range(n)]),
                                  w.numpy())
    np.testing.assert_array_equal(Y, V.numpy())


def k4_big(ssa, pmom, dtau, btop, slope, ang, *, thermal, fbeam=None,
           mur=None, lam0=None, sweeps=8):
    """The body on float32 numpy inputs of ``stage1_general_plain``'s
    shapes, every element at once on the last axis; returns its outputs in
    its order (y's only with ``thermal``, zp, zm only with ``fbeam``)."""
    L, nmom, B = pmom.shape
    E = L * B
    n = ang.mu.shape[0]
    tab = K.general_tables(ang)
    nn3, nn2 = 2 * n * n * n, 2 * n * n
    even, odd = tab[:nn3], tab[nn3:2 * nn3]
    o = 2 * nn3
    lam_t, lam_s, c2p = (tab[o:o + nn2], tab[o + nn2:o + 2 * nn2],
                         tab[o + 2 * nn2:])
    mu, w = c2p[2 * n:3 * n], c2p[3 * n:4 * n]
    # the table's square roots, as the plain version takes them with torch
    sqw, sqm = sqrt32(w), sqrt32(mu)
    sqmsqw = sqm * sqw
    lmax = min(nmom, 2 * n - 1)
    p0, p1 = ang.m, ang.m + 1
    ssa = ssa.reshape(E)
    g = [np.ones(E, F32)] + [pmom[:, l - 1].reshape(E) if l <= lmax
                             else np.zeros(E, F32) for l in range(1, 2 * n)]

    def contract(t, ls, i, j):
        acc = None
        for l in range(ls, min(2 * n, lmax + 1), 2):
            tv = t[(l * n + i) * n + j]
            term = np.full(E, tv, F32) if l == 0 else g[l] * tv
            acc = term if acc is None else acc + g[l] * tv
        return np.zeros(E, F32) if acc is None else acc

    def eye(i, j):
        return F32(1.0) if i == j else F32(0.0)

    def uf(i, j):
        return eye(i, j) - ssa * (contract(even, p0, i, j) * w[j])

    def vf(i, j):
        return eye(i, j) - ssa * (contract(odd, p1, i, j) * w[j])

    with np.errstate(all="ignore"):
        # Uhat's lower triangle; the Cholesky right-looking
        U = np.zeros((n, n, E), F32)
        for t in range(n):
            for j in range(t + 1):
                se = contract(even, p0, t, j)
                U[t, j] = ((eye(t, j) - ssa * ((sqw[t] * se) * sqw[j]))
                           / (sqm[t] * sqm[j]))
        Lc = np.zeros((n, n, E), F32)
        dg = [U[t, t].copy() for t in range(n)]
        for j in range(n):
            Lc[j, j] = sqrt32(np.where(dg[j] < F32(1e-12), F32(1e-12), dg[j]))
            inv = F32(1.0) / Lc[j, j]
            for t in range(j + 1, n):
                Lc[t, j] = U[t, j] * inv
            for t in range(j + 1, n):
                for k in range(j + 1, t):
                    U[t, k] = U[t, k] - Lc[t, j] * Lc[k, j]
                dg[t] = dg[t] - Lc[t, j] * Lc[t, j]
        # Vhat, VL in place by rows, then K's pairs into the Jacobi matrix
        Yv = np.zeros((n, n, E), F32)
        for t in range(n):
            for m in range(n):
                so = contract(odd, p1, t, m)
                Yv[t, m] = ((eye(t, m) - ssa * ((sqw[t] * so) * sqw[m]))
                            / (sqm[t] * sqm[m]))
            for j in range(n):
                acc = Yv[t, j] * Lc[j, j]
                for m in range(j + 1, n):
                    acc = acc + Yv[t, m] * Lc[m, j]
                Yv[t, j] = acc
        A0 = np.zeros((n, n, E), F32)
        for t in range(n):
            for j in range(t + 1):
                ktj = Lc[t, t] * Yv[t, j]
                for k in range(t + 1, n):
                    ktj = ktj + Lc[k, t] * Yv[k, j]
                kjt = Lc[j, j] * Yv[j, t]
                for k in range(j + 1, n):
                    kjt = kjt + Lc[k, j] * Yv[k, t]
                A0[t, j] = A0[j, t] = F32(0.5) * (ktj + kjt)
        X, Y = big_sweeps(A0, n, sweeps)
        lam = np.stack([sqrt32(np.where(X[k, k] < F32(1e-12), F32(1e-12),
                                         X[k, k])) for k in range(n)])
        # D in place over Y a column at a time
        for k in range(n):
            col = []
            for t in range(n):
                acc = Lc[t, 0] * Y[0, k]
                for j in range(1, t + 1):
                    acc = acc + Lc[t, j] * Y[j, k]
                col.append(acc / sqmsqw[t])
            for t in range(n):
                Y[t, k] = col[t]
        Vf = np.stack([np.stack([vf(i, j) for j in range(n)])
                       for i in range(n)])
        gp = np.zeros((n, n, E), F32)
        gm = np.zeros((n, n, E), F32)
        for k in range(n):                     # Sg in place over D
            gpk, gmk, mx = [], [], np.full(E, -1.0, F32)
            for t in range(n):
                acc = Vf[t, 0] * Y[0, k]
                for j in range(1, n):
                    acc = acc + Vf[t, j] * Y[j, k]
                sv = -acc / (mu[t] * lam[k])
                gpk.append(F32(0.5) * (sv + Y[t, k]))
                gmk.append(F32(0.5) * (sv - Y[t, k]))
                mx = nan_max(nan_max(mx, np.abs(gpk[t])), np.abs(gmk[t]))
            scale = np.where(mx < F32(1e-30), F32(1e-30), mx)
            for t in range(n):
                gp[t, k] = gpk[t] / scale
                gm[t, k] = gmk[t] / scale
                Y[t, k] = gp[t, k] + gm[t, k]
        Sg = Y
        lam_t32 = torch.from_numpy(lam.reshape(n, L, B))
        expd = torch.exp(-lam_t32 * torch.from_numpy(dtau)[None]).numpy()
        shape = lambda x: x.reshape(*x.shape[:-1], L, B)
        out = [shape(gp), shape(gm), shape(lam), expd]
        Uf = None
        zs_out = ()
        if fbeam is not None:
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
                if accp is None:              # no term: the kernel's 0
                    accp = accm = np.zeros(E, F32)
                qp, qm = (kappa * accp) * amp, (kappa * accm) * amp
                qs.append(qp + qm)
                qd.append(qp - qm)
            va = [qs[i] / mu[i] for i in range(n)]
            S = np.zeros((n, n + 1, E), F32)
            for t in range(n):
                acc = Vf[t, 0] * va[0]
                for j in range(1, n):
                    acc = acc + Vf[t, j] * va[j]
                S[t, :n] = Sg[t]
                S[t, n] = acc / mu[t] - qd[t] / (mu[t] * murf)
            for e in range(E):                 # the warp LU, an element each
                sys_ = np.ascontiguousarray(S[..., e])
                warp_lu_solve(sys_, n, 1)
                S[..., e] = sys_
            inv = F32(1.0) / (murf * murf)
            vv = []
            for t in range(n):
                lam2 = lam[t] * lam[t]
                den = lam2 - inv
                fl = F32(1e-4) * (lam2 + inv)
                den = np.where(np.abs(den) < fl, np.where(den < 0, -fl, fl),
                               den)
                vv.append(S[t, n] / den)
            zs = []
            for t in range(n):
                acc = Sg[t, 0] * vv[0]
                for k in range(1, n):
                    acc = acc + Sg[t, k] * vv[k]
                zs.append(acc)
            Uf = np.stack([np.stack([uf(i, j) for j in range(n)])
                           for i in range(n)])
            zp, zm = [], []
            for t in range(n):
                uz = Uf[t, 0] * zs[0]
                for j in range(1, n):
                    uz = uz + Uf[t, j] * zs[j]
                zd = -murf * (uz - qs[t]) / mu[t]
                zp.append(F32(0.5) * (zs[t] + zd))
                zm.append(F32(0.5) * (zs[t] - zd))
            zs_out = (shape(np.stack(zp)), shape(np.stack(zm)))
        if thermal:
            if Uf is None:
                Uf = np.stack([np.stack([uf(i, j) for j in range(n)])
                               for i in range(n)])
            h = np.zeros((n, E), F32)
            y0d = np.zeros((n, E), F32)
            y1 = np.zeros((n, E), F32)
            sl = slope.reshape(E)
            for e in range(E):
                sys_ = np.concatenate([Uf[..., e], np.full((n, 1), F32(1.0)
                                                           - ssa[e], F32)],
                                      axis=1)
                warp_lu_solve(sys_, n, 1)
                h[:, e] = sys_[:, n]
                y1[:, e] = sl[e] * h[:, e]
                sys_ = np.concatenate([Vf[..., e], ((F32(2.0) * mu)
                                                    * y1[:, e])[:, None]],
                                      axis=1)
                warp_lu_solve(sys_, n, 1)
                y0d[:, e] = sys_[:, n]
            bt = btop.reshape(E)
            out += [shape(bt * h + F32(0.5) * y0d),
                    shape(bt * h - F32(0.5) * y0d), shape(y1)]
        else:
            out += [np.zeros((n, L, B), F32)] * 3
        return tuple(out) + zs_out


@pytest.mark.parametrize("nstr, case", [
    (nstr, case) for nstr in (34, 48, 64)
    for case in ("m0_thermal", "m0_thermal_beam", "m1_beam")]
    + [(64, "m63_beam")])
def test_big_body_is_the_plain_k4(nstr, case):
    """The modelled body gives ``stage1_general_plain``'s float32 bits at
    nstr 34, 48 and 64 (N = 17, 24, 32) on L = 1 x B = 2 elements: m = 0
    with a thermal source, alone and with a beam, m = 1 with a beam; and at
    nstr 64, m = 63 with a beam, where entries of the phase tables
    underflow to zero in float32."""
    m = {"m1_beam": 1, "m63_beam": 63}.get(case, 0)
    ssa, pmom, dtau, btop, slope, fbeam, mur, mu0 = _inputs(nstr, 1, 2,
                                                            nstr + m)
    ang = make_static_angles(nstr, nstr, m)
    thermal = case.startswith("m0_thermal")
    kw = dict(thermal=thermal)
    if case != "m0_thermal":
        lam0 = lepoly(mu0, m, ang.lam_tables.shape[0] - 1).contiguous()
        kw.update(fbeam=fbeam, mur=mur, lam0=lam0)
    want = K.stage1_general_plain(ssa, pmom, dtau, btop, slope, ang, **kw)
    npk = {k: (v.numpy() if isinstance(v, torch.Tensor) else v)
           for k, v in kw.items()}
    got = k4_big(ssa.numpy(), pmom.numpy(), dtau.numpy(), btop.numpy(),
                 slope.numpy(), ang, **npk)
    assert len(got) == len(want)
    for idx, (x, w) in enumerate(zip(got, want)):
        np.testing.assert_array_equal(x, w.numpy(), err_msg=f"output {idx}")
