"""A float32 numpy model of K2's team kernel at N = 8
(``csrc/bvp_forward.cu``, ``bvp_forward_team_kernel``), held against the
plain version ``kernels.bvp_forward_plain`` and its ``linsolve.lu_solve``.

The kernel gives each column of a layer's 2N x (3N + 1) augmented system
to one lane of a team: lane j holds block column j and, for j <= N, one
right-hand-side column (unit column j, then the rhs).  Per pivot column c,
lane c replays the bubble of ``lu_solve`` (strict |a_r| > |a_c| swaps over
the live suffix) on its own column and broadcasts the swap bits; every
lane applies the swaps in order.  The multipliers are a_r,c * (1 / a_c,c)
from lane c, and back substitution multiplies by the pivot's reciprocal,
where ``lu_solve`` divides by the pivot.  The model follows those steps
lane by lane, in the kernel's operation order.  Run with division instead
of the reciprocal, it must give the plain version's bits; as shipped, it
must stay within the BVP bound of the plain version in float32 and
float64.  The kernel itself contracts multiply-adds, so on the card it is
held to the plain version within the same bound (``chip_smoke.py`` phases
3, 7 and 10).

K6 runs its backward sweep on the same team (``csrc/bvp_fused.cu``,
``team_backward_sweep``): lane r forms x_r = g_r + sum_k P[r][k] dx_k with
dx_k shuffled from lane k, and lanes i < N form the next dx_i from the
shuffled x, in the order of ``bvp_layer_carry`` ((a, b) mode) or
``bvp_layer_flux`` (flux mode; lane 0's sums gather the lanes' terms in
order).  ``team_backward`` models that lane by lane; it must give the bits
of ``thread_backward``, a per-thread model of the ``common.cuh`` steps in
their order, and stay within the BVP bound of the plain backward sweeps.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

from pyharp_tpu_torch.rt.disort import kernels as K
from pyharp_tpu_torch.rt.disort.linsolve import lu_solve
from pyharp_tpu_torch.rt.disort.solver import make_static_angles

F32 = np.float32


def bubble_order(column, col: int) -> list[int]:
    """Row order after ``lu_solve``'s bubble over column ``col``: the
    original row index at each position."""
    order, vals = list(range(len(column))), list(column)
    for r in range(col + 1, len(column)):
        if abs(vals[r]) > abs(vals[col]):
            order[col], order[r] = order[r], order[col]
            vals[col], vals[r] = vals[r], vals[col]
    return order


def swap_flags(column, col: int) -> list:
    """The pivot lane's swap bits over its own (unswapped) column: row r
    is flagged where |a_r| beats the running champion."""
    flags = [False] * len(column)
    champ = column[col]
    for r in range(col + 1, len(column)):
        sw = np.abs(column[r]) > np.abs(champ)
        flags[r] = sw
        champ = np.where(sw, column[r], champ)
    return flags


def team_lu(a: np.ndarray, u: np.ndarray, reciprocal: bool) -> np.ndarray:
    """The team's pivoted LU in float32.  ``a`` ``(M, M, ...)`` holds lane
    j's block column at ``a[j]``, ``u`` ``(k, M, ...)`` the right-hand-side
    columns; both are overwritten, and the solution is returned in ``u``.
    """
    M = a.shape[0]
    with np.errstate(all="ignore"):
        for c in range(M):
            flags = swap_flags(list(a[c]), c)
            for r in range(c + 1, M):
                for x in (a, u):
                    hi = np.where(flags[r], x[:, r], x[:, c])
                    lo = np.where(flags[r], x[:, c], x[:, r])
                    x[:, c], x[:, r] = hi, lo
            inv = F32(1.0) / a[c, c]
            for r in range(c + 1, M):
                f = a[c, r] * inv
                a[:, r] = a[:, r] - f * a[:, c]
                u[:, r] = u[:, r] - f * u[:, c]
        for row in range(M - 1, -1, -1):
            piv = a[row, row]
            acc = u[:, row].copy()
            for c in range(row + 1, M):
                acc = acc - a[c, row] * u[:, c]
            u[:, row] = acc * (F32(1.0) / piv) if reciprocal else acc / piv
    return u


def team_forward(gp, gm, E, dblk, albedo, wmu, reciprocal: bool = True):
    """K2's team kernel in float32: the block columns built lane by lane,
    ``team_lu`` on them, P and g written from the rhs lanes, and the
    condensed carry Q = R P, rg = R g formed per lane.  Arrays as
    ``bvp_forward_plain``'s, numpy float32."""
    N, _, L, B = gp.shape
    M = 2 * N
    q = np.zeros((N, N, B), F32)
    rg = np.zeros((N, B), F32)
    P = np.empty((M, N, L, B), F32)
    g = np.empty((M, L, B), F32)
    for l in range(L):
        gpl, gml, el, dl = gp[:, :, l], gm[:, :, l], E[:, l], dblk[:, l]
        a = np.empty((M, M, B), F32)       # a[j, r]: lane j's block column
        u = np.zeros((N + 1, M, B), F32)   # u[j, r]: lane j's rhs column
        for j in range(M):
            lo, jj = j < N, j % N
            ej = el[jj]
            for i in range(N):
                ttop = gml[i, jj] if lo else gpl[i, jj] * ej
                for k in range(N):
                    dkj = gpl[k, jj] if lo else gml[k, jj] * ej
                    acc = q[i, 0] * dkj if k == 0 else acc + q[i, k] * dkj
                a[j, i] = -ttop + acc
                a[j, N + i] = gpl[i, jj] * ej if lo else gml[i, jj]
            if l == L - 1:   # Lambertian reflection
                alb2 = F32(2.0) * albedo
                for r in range(N):
                    rn = gml[r, jj] * ej if lo else gpl[r, jj]
                    refl = wmu[0] * rn if r == 0 else refl + wmu[r] * rn
                for i in range(N):
                    a[j, N + i] = a[j, N + i] - alb2 * refl
        for j in range(N):
            u[j, N + j] = 1.0
        u[N, :N] = dl[:N] - rg
        u[N, N:] = dl[N:]
        x = team_lu(a, u, reciprocal)
        P[:, :, l] = x[:N].transpose(1, 0, 2)
        g[:, l] = x[N]
        for i in range(N):
            for k in range(M):
                rn = gml[i, k] * el[k] if k < N else gpl[i, k - N]
                acc = rn * x[:, 0] if k == 0 else acc + rn * x[:, k]
            q[i] = acc[:N]
            rg[i] = acc[N]
    return P, g


def _layer_inputs(nstr: int, L: int, B: int, seed: int):
    """gp, gm, E from the plain K4 (moments, no beam), a random dblk and
    albedo: the inputs K2 gets on the aerosol path, as float32 tensors."""
    rng = np.random.default_rng(seed)
    ang = make_static_angles(nstr, nstr, 0)
    t = lambda x: torch.tensor(x, dtype=torch.float32)
    ssa = rng.uniform(0.0, 0.99, (L, B))
    pmom = 0.8 ** np.arange(1, nstr + 1)[None, :, None] * np.ones((L, 1, B))
    dtau = rng.uniform(0.01, 2.0, (L, B))
    zero = np.zeros((L, B))
    gp, gm, _, E, *_ = K.stage1_general_plain(
        t(ssa), t(pmom), t(dtau), t(zero), t(zero), ang, thermal=False)
    N = nstr // 2
    dblk = t(rng.uniform(-1.0, 1.0, (2 * N, L, B)))
    albedo = t(rng.uniform(0.0, 0.6, (B,)))
    return (gp, gm, E, dblk, albedo), ang


def _model(ins, ang, reciprocal):
    wmu = (ang.w * ang.mu).astype(F32)
    return team_forward(*(x.numpy() for x in ins), wmu, reciprocal)


# entries with many equal magnitudes, signs and zeros, so ties are common
TIED = st.sampled_from([0.0, 1.0, -1.0, 0.5, -0.5, 2.0, -2.0, 3.0])
FINITE = st.floats(-1e3, 1e3, allow_nan=False, width=32)


@settings(max_examples=200, deadline=None)
@given(st.lists(st.one_of(TIED, FINITE), min_size=2, max_size=16),
       st.integers(0, 15))
def test_swap_bits_replay_the_bubble(column, col):
    """Lane c's swap bits, applied in order by every lane, give the row
    order of ``lu_solve``'s bubble, on random columns and columns with
    ties."""
    col = col % len(column)
    column = [F32(v) for v in column]
    order = list(range(len(column)))
    for r, sw in enumerate(swap_flags(column, col)):
        if sw:
            order[col], order[r] = order[r], order[col]
    assert order == bubble_order(column, col)


def _assert_team_lu_is_lu_solve(A32: np.ndarray, b32: np.ndarray) -> None:
    want = lu_solve(torch.from_numpy(A32)[..., None],
                    torch.from_numpy(b32)[..., None])[:, 0].numpy()
    got = team_lu(np.ascontiguousarray(A32.T)[..., None].copy(),
                  b32[None, :, None].copy(), reciprocal=False)[0, :, 0]
    np.testing.assert_array_equal(got, want)


@settings(max_examples=100, deadline=None)
@given(st.integers(2, 16).flatmap(lambda n: st.tuples(
    st.lists(st.one_of(TIED, FINITE), min_size=n * n, max_size=n * n),
    st.lists(FINITE, min_size=n, max_size=n))))
def test_team_lu_is_lu_solve_on_drawn_systems(system):
    """Column-owning lanes with broadcast swap bits, divided by the pivot,
    solve drawn float32 systems (ties, zeros, singular ones included) bit
    for bit as ``lu_solve`` does."""
    entries, rhs = system
    n = len(rhs)
    _assert_team_lu_is_lu_solve(np.array(entries, F32).reshape(n, n),
                                np.array(rhs, F32))


@pytest.mark.parametrize("n", [2, 4, 8, 16])
@pytest.mark.parametrize("ties", [False, True])
def test_team_lu_is_lu_solve(n, ties):
    """As above on 20 seeded systems per size; with ties, entries from a
    few magnitudes, so the strict comparison decides most swaps."""
    rng = np.random.default_rng(n + 10 * ties)
    for _ in range(20):
        if ties:
            A = rng.choice([-2.0, -1.0, 0.5, 1.0, 2.0], (n, n))
        else:
            A = rng.standard_normal((n, n))
        _assert_team_lu_is_lu_solve(A.astype(F32),
                                    rng.standard_normal(n).astype(F32))


@pytest.mark.parametrize("nstr", [2, 4, 8, 16])
def test_team_forward_with_division_is_the_plain_forward(nstr):
    """With division in back substitution, the team model gives
    ``bvp_forward_plain``'s float32 bits over a whole forward sweep
    (build, pivots, elimination, carry, the Lambertian fold): the
    reciprocal is the kernel's one departure from the plain version.
    B = 13 is not a multiple of any team block."""
    ins, ang = _layer_inputs(nstr, L=6, B=13, seed=nstr)
    want = K.bvp_forward_plain(*ins, ang)
    got = _model(ins, ang, reciprocal=False)
    for w, x in zip(want, got):
        np.testing.assert_array_equal(x, w.numpy())


@pytest.mark.parametrize("nstr", [2, 4, 8, 16])
def test_team_forward_is_within_the_bvp_bound(nstr):
    """The team model as shipped (times the pivot's reciprocal) against the
    plain version in float32 and in float64: |err| <= 3e-5 max|ref| +
    3e-4 |ref| per output (``tests/test_pallas_kernels.py:70``)."""
    ins, ang = _layer_inputs(nstr, L=6, B=13, seed=100 + nstr)
    got = _model(ins, ang, reciprocal=True)
    for dtype in (torch.float32, torch.float64):
        want = K.bvp_forward_plain(*(x.to(dtype) for x in ins), ang)
        for w, x in zip(want, got):
            w = w.numpy()
            assert np.isfinite(x).all()
            np.testing.assert_allclose(x, w, rtol=3e-4,
                                       atol=3e-5 * np.abs(w).max())


def thread_backward(gp, gm, E, P, g, tp, tm, wmu, flux: bool):
    """One thread per column, float32: ``bvp_layer_coeffs`` then
    ``bvp_layer_carry`` ((a, b)) or ``bvp_layer_flux<N, false>`` (flux),
    bottom-up, in their operation order.  Returns (a, b) ``(N, L, B)``
    each, or (fl ``(2, L, B)``, ab_last ``(2N, B)``)."""
    N, _, L, B = gp.shape
    M = 2 * N
    dx = [np.zeros(B, F32) for _ in range(N)]
    xs = np.empty((M, L, B), F32)
    fl = np.empty((2, L, B), F32)
    for l in range(L - 1, -1, -1):
        x = []
        for i in range(M):
            acc = P[i, 0, l] * dx[0]
            for k in range(1, N):
                acc = acc + P[i, k, l] * dx[k]
            x.append(g[i, l] + acc)
        xs[:, l] = x
        e = E[:, l]
        new = []
        for i in range(N):
            if flux:
                up, dn = gp[i, 0, l] * x[0], gm[i, 0, l] * x[0]
                for k in range(1, N):
                    up = up + gp[i, k, l] * x[k]
                    dn = dn + gm[i, k, l] * x[k]
                for k in range(N):
                    up = up + gm[i, k, l] * e[k] * x[N + k]
                    dn = dn + gp[i, k, l] * e[k] * x[N + k]
                upt = wmu[i] * (up + tp[i, l])
                dnt = wmu[i] * (dn + tm[i, l])
                up_sum = upt if i == 0 else up_sum + upt
                dn_sum = dnt if i == 0 else dn_sum + dnt
                new.append(up)
            else:
                up = gp[i, 0, l] * x[0]
                dn = (gm[i, 0, l] * e[0]) * x[N]
                for k in range(1, N):
                    up = up + gp[i, k, l] * x[k]
                    dn = dn + (gm[i, k, l] * e[k]) * x[N + k]
                new.append(up + dn)
        if flux:
            fl[:, l] = up_sum, dn_sum
        dx = new
    return (fl, xs[:, -1]) if flux else (xs[:N], xs[N:])


def team_backward(gp, gm, E, P, g, tp, tm, wmu, flux: bool):
    """K6's team backward sweep lane by lane, float32: lane j of 2N holds
    x_j, lane i < N holds dx_i; a shuffle is a read of another lane's
    register.  Same contract as ``thread_backward``."""
    N, _, L, B = gp.shape
    M = 2 * N
    dx = [np.zeros(B, F32) for _ in range(M)]     # per lane; j < N live
    xs = np.empty((M, L, B), F32)
    fl = np.empty((2, L, B), F32)
    for l in range(L - 1, -1, -1):
        e = E[:, l]
        # lane j: x_j = g_j + P_j dx, dx_k shuffled from lane k
        x = []
        for j in range(M):
            acc = P[j, 0, l] * dx[0]
            for k in range(1, N):
                acc = acc + P[j, k, l] * dx[k]
            x.append(g[j, l] + acc)
        xs[:, l] = x
        # every lane shuffles all of x; lane j works on row i = j % N
        upt, dnt, new = [], [], []
        for j in range(M):
            i, xj = j % N, list(x)
            if flux:
                up, dn = gp[i, 0, l] * xj[0], gm[i, 0, l] * xj[0]
                for k in range(1, N):
                    up = up + gp[i, k, l] * xj[k]
                    dn = dn + gm[i, k, l] * xj[k]
                for k in range(N):
                    up = up + gm[i, k, l] * e[k] * xj[N + k]
                    dn = dn + gp[i, k, l] * e[k] * xj[N + k]
                upt.append(wmu[i] * (up + tp[i, l]))
                dnt.append(wmu[i] * (dn + tm[i, l]))
                new.append(up)
            else:
                up = gp[i, 0, l] * xj[0]
                dn = (gm[i, 0, l] * e[0]) * xj[N]
                for k in range(1, N):
                    up = up + gp[i, k, l] * xj[k]
                    dn = dn + (gm[i, k, l] * e[k]) * xj[N + k]
                new.append(up + dn)
        if flux:
            # the sums over lanes 0..N-1 in order, shuffled into every lane
            up_sum, dn_sum = upt[0], dnt[0]
            for r in range(1, N):
                up_sum = up_sum + upt[r]
                dn_sum = dn_sum + dnt[r]
            fl[:, l] = up_sum, dn_sum
        dx = new
    return (fl, xs[:, -1]) if flux else (xs[:N], xs[N:])


def _backward_inputs(nstr: int, seed: int):
    """gp, gm, E and P, g of the plain forward on ``_layer_inputs``, and
    random particulars tp, tm: float32 tensors (L = 6, B = 13)."""
    ins, ang = _layer_inputs(nstr, L=6, B=13, seed=seed)
    P, g = K.bvp_forward_plain(*ins, ang)
    rng = np.random.default_rng(seed + 1)
    N = nstr // 2
    tp, tm = (torch.tensor(rng.uniform(0.0, 1.0, (N, 6, 13)),
                           dtype=torch.float32) for _ in range(2))
    return (ins[0], ins[1], ins[2], P, g, tp, tm), ang


@pytest.mark.parametrize("nstr", [2, 4, 8, 16])
@pytest.mark.parametrize("flux", [False, True])
def test_team_backward_is_the_thread_backward(nstr, flux):
    """Lane by lane, the team's backward sweep gives the per-thread steps'
    float32 bits in both modes."""
    xs, ang = _backward_inputs(nstr, seed=200 + nstr)
    wmu = (ang.w * ang.mu).astype(F32)
    arrs = [x.numpy() for x in xs]
    want = thread_backward(*arrs, wmu, flux)
    got = team_backward(*arrs, wmu, flux)
    for w, x in zip(want, got):
        np.testing.assert_array_equal(x, w)


@pytest.mark.parametrize("nstr", [2, 4, 8, 16])
@pytest.mark.parametrize("flux", [False, True])
def test_team_backward_is_within_the_bvp_bound(nstr, flux):
    """The team model against ``bvp_backward_plain`` ((a, b)) or
    ``bvp_backward_flux_plain``'s layer-top sums (flux), float32 and
    float64: |err| <= 3e-5 max|ref| + 3e-4 |ref| per output."""
    xs, ang = _backward_inputs(nstr, seed=300 + nstr)
    wmu = (ang.w * ang.mu).astype(F32)
    got = team_backward(*(x.numpy() for x in xs), wmu, flux)
    for dtype in (torch.float32, torch.float64):
        t = [x.to(dtype) for x in xs]
        if flux:
            zero = torch.zeros(t[0].shape[0], t[0].shape[-1], dtype=dtype)
            want = K.bvp_backward_flux_plain(*t, zero, zero, ang)[:1]
        else:
            want = K.bvp_backward_plain(*t[:5], ang)
        for w, x in zip(want, got):
            w = w.numpy()
            assert np.isfinite(x).all()
            np.testing.assert_allclose(x, w, rtol=3e-4,
                                       atol=3e-5 * np.abs(w).max())
