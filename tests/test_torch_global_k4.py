"""A float32 numpy model of K4's body at N > 64
(``csrc/stage1_general_global.cu``), held to the bits of ``jacobi._rotate``
and of the plain ``kernels.stage1_general_plain``.

The body is the body of N = 33..64 (``tests/test_torch_huge_k4.py``) with
lane t on the rows t + 32 j for any number of row sets, its matrices and
the values the huge body carries in registers in a slab of global scratch.
Up to 8 row sets (N <= 256) its sweeps are the huge body's
(``sweeps_rows<R>`` of ``csrc/general_huge.cuh``, the rows' carried
values in registers): ``global_sweeps`` runs the huge test's lane model
``rows_sweeps`` at R = ceil(N / 32).
``test_global_sweeps_are_jacobi_rotate`` holds it to ``jacobi.jacobi_eigh``
at N = 65, 100 and 129, and ``test_global_body_is_the_plain_k4`` runs the
whole body (``k4_global``: the lanes' rows of each step at once, each
entry's operations those of ``tests/test_torch_big_k4.py``'s model) with
these sweeps and global.cuh's warp LU
(``test_torch_global_bvp.warp_lu_solve_global``) at nstr 130 and 258.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

from pyharp_tpu_torch.rt.disort import jacobi
from pyharp_tpu_torch.rt.disort import kernels as K
from pyharp_tpu_torch.rt.disort.legendre import lepoly
from pyharp_tpu_torch.rt.disort.solver import make_static_angles

from .test_torch_global_bvp import warp_lu_solve_global
from .test_torch_huge_k4 import rows_sweeps
from .test_torch_wide_k4_team import (_inputs, nan_max, rotation_scalars,
                                      sqrt32)

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


def global_sweeps(A0, n: int, sweeps: int):
    """The body's sweeps on the symmetric ``(n, n, E)`` matrix ``A0`` at
    65 <= n <= 256: ``sweeps_rows<R>`` over R = ceil(n / 32) row sets,
    the carried values in registers (``tests/test_torch_huge_k4.py``'s
    ``rows_sweeps``).  ``(X, Y)``, X holding A's lower triangle and Y the
    eigenvectors by rows."""
    assert 64 < n <= 32 * 8
    return rows_sweeps(A0, n, sweeps, (n + LANES - 1) // LANES)


def k4_global(ssa, pmom, dtau, btop, slope, ang, *, thermal, fbeam=None,
              mur=None, lam0=None, sweeps=8):
    """The body in float32 on ``stage1_general_plain``'s shapes, every
    element at once on the last axis and every step's independent rows
    (the lanes' rows t + 32 j) or columns at once, each entry's operations
    in the order of ``tests/test_torch_big_k4.py``'s ``k4_big`` (the
    body's per entry); the sweeps ``global_sweeps``, the LUs
    ``warp_lu_solve_global``.  Returns the outputs in the plain version's
    order (zeros for y without ``thermal``, zp, zm only with ``fbeam``)."""
    L, nmom, B = pmom.shape
    E = L * B
    n = ang.mu.shape[0]
    tab = K.general_tables(ang)
    nn3, nn2 = 2 * n * n * n, 2 * n * n
    even = tab[:nn3].reshape(2 * n, n, n)
    odd = tab[nn3:2 * nn3].reshape(2 * n, n, n)
    o = 2 * nn3
    lam_t = tab[o:o + nn2].reshape(2 * n, n)
    lam_s = tab[o + nn2:o + 2 * nn2].reshape(2 * n, n)
    c2p = tab[o + 2 * nn2:]
    mu, w = c2p[2 * n:3 * n], c2p[3 * n:4 * n]
    sqw, sqm = sqrt32(w), sqrt32(mu)
    sqmsqw = sqm * sqw
    lmax = min(nmom, 2 * n - 1)
    p0, p1 = ang.m, ang.m + 1
    ssa = ssa.reshape(E)
    g = [np.ones(E, F32)] + [pmom[:, l - 1].reshape(E) if l <= lmax
                             else np.zeros(E, F32) for l in range(1, 2 * n)]
    eye = np.eye(n, dtype=F32)[..., None]
    tri = np.arange(n)

    def contract(t, ls):
        """Every entry's sum over l = ls, ls + 2, ... in order, (n, n, E)."""
        acc = None
        for l in range(ls, min(2 * n, lmax + 1), 2):
            tv = t[l][..., None]
            term = np.broadcast_to(tv, (n, n, E)) if l == 0 else g[l] * tv
            acc = term if acc is None else acc + g[l] * tv
        return np.zeros((n, n, E), F32) if acc is None else acc

    def iw(t, ls):
        return eye - ssa * (contract(t, ls) * w[None, :, None])

    def hat(t, ls):
        return ((eye - ssa * ((sqw[:, None, None] * contract(t, ls))
                              * sqw[None, :, None]))
                / (sqm[:, None, None] * sqm[None, :, None]))

    def lu_each(S):
        for e in range(E):                   # the warp LU, an element each
            sys_ = np.ascontiguousarray(S[..., e])
            warp_lu_solve_global(sys_, n, 1)
            S[..., e] = sys_
        return S[:, n]

    with np.errstate(all="ignore"):
        # Uhat's lower triangle; the Cholesky right-looking, column j's
        # rows below at once, each pending entry less its terms in j order
        U = hat(even, p0)
        Lc = np.zeros((n, n, E), F32)
        dg = np.stack([U[t, t] for t in range(n)])
        below = tri[:, None] > tri[None, :]
        for j in range(n):
            Lc[j, j] = sqrt32(np.where(dg[j] < F32(1e-12), F32(1e-12),
                                           dg[j]))
            inv = F32(1.0) / Lc[j, j]
            Lc[j + 1:, j] = U[j + 1:, j] * inv
            upd = Lc[j + 1:, j][:, None] * Lc[j + 1:, j][None]
            blk = U[j + 1:, j + 1:]
            U[j + 1:, j + 1:] = np.where(below[j + 1:, j + 1:, None],
                                         blk - upd, blk)
            dg[j + 1:] = dg[j + 1:] - Lc[j + 1:, j] * Lc[j + 1:, j]
        # Vhat, VL in place by rows (every row at once, its columns in
        # order), then K's pairs into the Jacobi matrix
        Yv = hat(odd, p1)
        for j in range(n):
            acc = Yv[:, j] * Lc[j, j]
            for m in range(j + 1, n):
                acc = acc + Yv[:, m] * Lc[m, j]
            Yv[:, j] = acc
        Km = np.zeros((n, n, E), F32)
        for a in range(n):                   # K[a][b], every b at once
            acc = Lc[a, a] * Yv[a]
            for k in range(a + 1, n):
                acc = acc + Lc[k, a] * Yv[k]
            Km[a] = acc
        A0 = F32(0.5) * (Km + Km.transpose(1, 0, 2))
        X, Y = global_sweeps(A0, n, sweeps)
        d = np.stack([X[k, k] for k in range(n)])
        lam = sqrt32(np.where(d < F32(1e-12), F32(1e-12), d))
        # D over Y, every column and row at once, each sum in j order
        acc = Lc[:, 0][:, None] * Y[0][None]
        for j in range(1, n):
            acc = np.where((tri >= j)[:, None, None],
                           acc + Lc[:, j][:, None] * Y[j][None], acc)
        Y = acc / sqmsqw[:, None, None]
        Vf = iw(odd, p1)
        acc = Vf[:, 0][:, None] * Y[0][None]
        for j in range(1, n):
            acc = acc + Vf[:, j][:, None] * Y[j][None]
        sv = -acc / (mu[:, None, None] * lam[None])
        gpk = F32(0.5) * (sv + Y)
        gmk = F32(0.5) * (sv - Y)
        mx = np.full((n, E), -1.0, F32)
        for t in range(n):
            mx = nan_max(nan_max(mx, np.abs(gpk[t])), np.abs(gmk[t]))
        scale = np.where(mx < F32(1e-30), F32(1e-30), mx)
        gp, gm = gpk / scale[None], gmk / scale[None]
        Sg = gp + gm
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
            accp = np.zeros((n, E), F32)
            accm = np.zeros((n, E), F32)
            started = np.zeros(n, bool)
            for l in range(min(2 * n, lmax + 1)):     # every row at once
                coef = (g[l] * c2p[l]) * lam0[l][bidx]
                nz = lam_t[l] != 0
                tp = coef[None] * lam_t[l][:, None]
                tm = coef[None] * lam_s[l][:, None]
                first = (nz & ~started)[:, None]
                add = (nz & started)[:, None]
                accp = np.where(first, tp, np.where(add, accp + tp, accp))
                accm = np.where(first, tm, np.where(add, accm + tm, accm))
                started |= nz
            qp, qm = (kappa * accp) * amp, (kappa * accm) * amp
            qs, qd = qp + qm, qp - qm
            va = qs / mu[:, None]
            acc = Vf[:, 0] * va[0]
            for j in range(1, n):
                acc = acc + Vf[:, j] * va[j]
            S = np.concatenate([Sg, (acc / mu[:, None] - qd / (mu[:, None]
                                                              * murf))[:, None]],
                               axis=1)
            cc = lu_each(S)
            inv = F32(1.0) / (murf * murf)
            lam2 = lam * lam
            den = lam2 - inv
            fl = F32(1e-4) * (lam2 + inv)
            den = np.where(np.abs(den) < fl, np.where(den < 0, -fl, fl), den)
            vv = cc / den
            zs = Sg[:, 0] * vv[0]
            for k in range(1, n):
                zs = zs + Sg[:, k] * vv[k]
            Uf = iw(even, p0)
            uz = Uf[:, 0] * zs[0]
            for j in range(1, n):
                uz = uz + Uf[:, j] * zs[j]
            zd = -murf * (uz - qs) / mu[:, None]
            zs_out = (shape(F32(0.5) * (zs + zd)), shape(F32(0.5) * (zs - zd)))
        if thermal:
            if Uf is None:
                Uf = iw(even, p0)
            h = lu_each(np.concatenate(
                [Uf, np.broadcast_to(F32(1.0) - ssa, (n, 1, E))], axis=1))
            y1 = slope.reshape(E) * h
            y0d = lu_each(np.concatenate(
                [Vf, ((F32(2.0) * mu)[:, None] * y1)[:, None]], axis=1))
            bt = btop.reshape(E)
            out += [shape(bt * h + F32(0.5) * y0d),
                    shape(bt * h - F32(0.5) * y0d), shape(y1)]
        else:
            out += [np.zeros((n, L, B), F32)] * 3
        return tuple(out) + zs_out


@pytest.mark.parametrize("n, sweeps", [(65, 2), (100, 1), (129, 1)])
def test_global_sweeps_are_jacobi_rotate(n, sweeps):
    """The modelled sweeps, rows t + 32 j a lane over 3, 4 and 5 sets in
    registers, each rotation's slots loaded ahead of it, give ``jacobi_eigh``'s bits
    (its ``_rotate`` in the cyclic order) on drawn symmetric float32
    matrices with a repeated diagonal entry and zero off-diagonal ones
    across the row sets (one or two sweeps: each rotation is the same
    steps, and eight at N = 129 take 2.3e6 tensor operations of the plain
    Jacobi)."""
    rng = np.random.default_rng(n)
    E = 2
    M = rng.standard_normal((n, n, E)).astype(F32)
    M = (M + M.transpose(1, 0, 2)) * F32(0.5)
    M[3, 3] = M[n - 1, n - 1]
    M[2, 7] = M[7, 2] = 0.0
    M[5, 40] = M[40, 5] = 0.0
    M[1, n - 2] = M[n - 2, 1] = 0.0
    X, Y = global_sweeps(M, n, sweeps)
    w, V = jacobi.jacobi_eigh(torch.from_numpy(M), sweeps)
    np.testing.assert_array_equal(np.stack([X[k, k] for k in range(n)]),
                                  w.numpy())
    np.testing.assert_array_equal(Y, V.numpy())


@pytest.mark.parametrize("nstr, case, sweeps", [
    (130, "m0_thermal_beam", 8), (130, "m1_beam", 8),
    (258, "m0_thermal_beam", 1)])
def test_global_body_is_the_plain_k4(nstr, case, sweeps):
    """The modelled body, rows t + 32 j a lane in the sweeps and the warp
    LU over run-time row sets, gives ``stage1_general_plain``'s float32
    bits at nstr 130 (N = 65: m = 0 with a thermal source and a beam, m = 1
    with a beam, the kernel's 8 sweeps) and 258 (N = 129, m = 0 with both,
    one sweep: the plain Jacobi's 8 at N = 129 take minutes on a CPU) on
    L = 1 x B = 2 elements."""
    m = 1 if case == "m1_beam" else 0
    ssa, pmom, dtau, btop, slope, fbeam, mur, mu0 = _inputs(nstr, 1, 2,
                                                            nstr + m)
    ang = make_static_angles(nstr, nstr, m)
    lam0 = lepoly(mu0, m, ang.lam_tables.shape[0] - 1).contiguous()
    kw = dict(thermal=m == 0, fbeam=fbeam, mur=mur, lam0=lam0, sweeps=sweeps)
    want = K.stage1_general_plain(ssa, pmom, dtau, btop, slope, ang, **kw)
    npk = {k: (v.numpy() if isinstance(v, torch.Tensor) else v)
           for k, v in kw.items()}
    got = k4_global(ssa.numpy(), pmom.numpy(), dtau.numpy(), btop.numpy(),
                    slope.numpy(), ang, **npk)
    assert len(got) == len(want)
    for idx, (x, w) in enumerate(zip(got, want)):
        assert np.isfinite(x).all(), f"output {idx}"
        np.testing.assert_array_equal(x, w.numpy(), err_msg=f"output {idx}")
