"""Float32 numpy models of K2's and K5's bodies at N = 17..32
(``csrc/bvp_forward_big.cu``, ``csrc/bvp_backward_big.cu``, the warp LU of
``csrc/big.cuh``), lane by lane, held against the plain versions.

K2 gives a warp to a column.  Its 2N x (3N + 1) system sits in shared
memory, lane t owning rows t and t + 32, so rows pass position 32 and a
pivot search spans both halves: ``record_bits`` takes an inclusive prefix
max of |a| over each half (five ``shfl_up`` steps with ``fmaxf``; a NaN
pivot stands as +inf, a NaN below it as -inf), carries the lower half's
total into the upper one and ballots the rows that beat the prefix before
them.  Those must be the plain bubble's swaps
(``test_record_bits_span_both_halves``).  The swaps go row by row in bit
order over the lanes' columns, each row below the pivot is eliminated on
its lane, and back substitution runs a right-hand side a lane; with the
block built by lanes (t < N builds block columns t and N + t) and the
carry by rows of Q, the model gives ``bvp_forward_plain``'s float32 bits.

K5 gives a block of N warps (N <= 32, so at most 1,024 threads) 32
columns, warp w forming rows w and N + w of x = g + P dx, then the sums up_w
= gp_w a and dn_w = (gm_w E) b through shared memory; with the last tile
partial (lanes past B read column B - 1 and store nothing) the model gives
``bvp_backward_plain``'s float32 bits.  On the card the kernels are held
to the plain versions within 3e-5 max|ref| + 3e-4 |ref| (``chip_smoke.py``
phase 21): the kernels are built with multiply-add contraction.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

from pyharp_tpu_torch.rt.disort import kernels as K
from pyharp_tpu_torch.rt.disort.linsolve import lu_solve

from .test_torch_team_pivot import FINITE, TIED, _layer_inputs, swap_flags

F32 = np.float32
NSTR_BIG = (34, 50, 64)



@pytest.fixture(autouse=True)
def one_thread():
    """One intra-op thread: the tensors here are mid-sized, and with
    several test processes on the machine their threads contend."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)

def _shfl_up(x, off):
    """``__shfl_up_sync`` over the lane axis 0: lanes < off keep their own."""
    return np.concatenate([x[:off], x[:-off]])


def record_bits(A, col: int, nr: int):
    """big.cuh's ``record_bits`` on ``A`` ``(64, ...)``, column ``col`` of
    an ``nr``-row system: a bool array over the 64 row positions, lane t
    holding rows t and t + 32."""
    lane = np.arange(32).reshape((-1,) + (1,) * (A.ndim - 1))
    inf = F32(np.inf)

    def key(half):
        rows = lane + 32 * half
        a = np.abs(A[32 * half:32 * half + 32])
        k = np.where(np.isnan(a), np.where(rows == col, inf, -inf), a)
        return np.where((rows < col) | (rows >= nr), -inf, k).astype(F32)

    k0, k1 = key(0), key(1)
    s0, s1 = k0.copy(), k1.copy()
    off = 1
    while off < 32:
        y0, y1 = _shfl_up(s0, off), _shfl_up(s1, off)
        s0 = np.where(lane >= off, np.fmax(s0, y0), s0)
        s1 = np.where(lane >= off, np.fmax(s1, y1), s1)
        off *= 2
    low_total = s0[31]
    e0 = np.where(lane == 0, -inf, _shfl_up(s0, 1))
    e1 = np.fmax(np.where(lane == 0, -inf, _shfl_up(s1, 1)), low_total)
    return np.concatenate([(lane > col) & (k0 > e0),
                           (lane + 32 > col) & (k1 > e1)])


def warp_lu_solve(A, nr: int, nq: int):
    """big.cuh's ``warp_lu_solve`` in float32 on ``A`` ``(nr, nr + nq,
    ...)`` (in place; the solution over the right-hand-side columns)."""
    w = nr + nq
    pad = np.zeros((64 - nr,) + A.shape[1:], F32)
    with np.errstate(all="ignore"):
        for col in range(nr - 1):
            bits = record_bits(np.concatenate([A[:, col], pad[:, 0]]), col, nr)
            for r in range(col + 1, nr):          # bit order
                if bits[r].any():
                    for j in range(col, w):         # lanes over columns
                        a, b = A[col, j].copy(), A[r, j].copy()
                        A[col, j] = np.where(bits[r], b, a)
                        A[r, j] = np.where(bits[r], a, b)
            inv = F32(1.0) / A[col, col]
            for t in range(32):                     # rows t and t + 32
                for r in (t, t + 32):
                    if col < r < nr:
                        f = A[r, col] * inv
                        A[r, col + 1:w] = A[r, col + 1:w] - f * A[col, col + 1:w]
        for q in range(nq):                         # a right-hand side a lane
            for row in range(nr - 1, -1, -1):
                acc = A[row, nr + q].copy()
                for c in range(row + 1, nr):
                    acc = acc - A[row, c] * A[c, nr + q]
                A[row, nr + q] = acc / A[row, row]


def big_forward(gp, gm, E, dblk, albedo, wmu):
    """bvp_forward_big.cu in float32, all columns at once on the last axis:
    ``(P, g)`` as ``bvp_forward_plain``'s."""
    N, _, L, B = gp.shape
    M = 2 * N
    q = np.zeros((N, N, B), F32)
    rg = np.zeros((N, B), F32)
    P = np.empty((M, N, L, B), F32)
    g = np.empty((M, L, B), F32)
    alb2 = F32(2.0) * albedo
    for l in range(L):
        sgp, sgm, se = gp[:, :, l], gm[:, :, l], E[:, l]
        A = np.zeros((M, 3 * N + 1, B), F32)
        for t in range(N):                       # block columns t and N + t
            ej = se[t]
            if l == L - 1:
                for r in range(N):
                    rlo, rhi = sgm[r, t] * ej, sgp[r, t]
                    refl_lo = wmu[0] * rlo if r == 0 else refl_lo + wmu[r] * rlo
                    refl_hi = wmu[0] * rhi if r == 0 else refl_hi + wmu[r] * rhi
            for i in range(N):
                acc_lo = q[i, 0] * sgp[0, t]
                acc_hi = q[i, 0] * (sgm[0, t] * ej)
                for k in range(1, N):
                    acc_lo = acc_lo + q[i, k] * sgp[k, t]
                    acc_hi = acc_hi + q[i, k] * (sgm[k, t] * ej)
                A[i, t] = -sgm[i, t] + acc_lo
                A[i, N + t] = -(sgp[i, t] * ej) + acc_hi
                blo, bhi = sgp[i, t] * ej, sgm[i, t]
                if l == L - 1:
                    blo, bhi = blo - alb2 * refl_lo, bhi - alb2 * refl_hi
                A[N + i, t], A[N + i, N + t] = blo, bhi
        for r in range(M):                       # unit columns, rhs by rows
            if r >= N:
                A[r, M + r - N] = 1.0
            A[r, M + N] = dblk[r, l] - rg[r] if r < N else dblk[r, l]
        warp_lu_solve(A, M, N + 1)
        P[:, :, l] = A[:, M:M + N]
        g[:, l] = A[:, M + N]
        for t in range(N):                       # the carry, row t on lane t
            for j in range(N + 1):
                acc = (sgm[t, 0] * se[0]) * A[0, M + j]
                for k in range(1, M):
                    rn = sgm[t, k] * se[k] if k < N else sgp[t, k - N]
                    acc = acc + rn * A[k, M + j]
                if j < N:
                    q[t, j] = acc
                else:
                    rg[t] = acc
    return P, g


def big_backward(gp, gm, E, P, g):
    """bvp_backward_big.cu in float32, tile by tile of 32 columns, warp w
    on rows w and N + w: ``(a, b)`` as ``bvp_backward_plain``'s."""
    N, _, L, B = gp.shape
    a = np.full((N, L, B), np.nan, F32)
    b = np.full((N, L, B), np.nan, F32)
    for b0 in range(0, B, 32):
        lanes = np.arange(b0, b0 + 32)
        col = np.minimum(lanes, B - 1)
        inside = lanes < B
        s_up = np.zeros((N, 32), F32)
        s_dn = np.zeros((N, 32), F32)
        for l in range(L - 1, -1, -1):
            s_x = np.empty((2 * N, 32), F32)
            s_e = np.empty((N, 32), F32)
            for w in range(N):
                for r in (w, N + w):
                    pr = P[r, :, l][:, col]
                    acc = pr[0] * (s_up[0] + s_dn[0])
                    for k in range(1, N):
                        acc = acc + pr[k] * (s_up[k] + s_dn[k])
                    s_x[r] = g[r, l, col] + acc
                    (a if r < N else b)[w, l, lanes[inside]] = s_x[r][inside]
                s_e[w] = E[w, l, col]
            if l == 0:
                break
            for w in range(N):
                up = gp[w, 0, l][col] * s_x[0]
                dn = (gm[w, 0, l][col] * s_e[0]) * s_x[N]
                for k in range(1, N):
                    up = up + gp[w, k, l][col] * s_x[k]
                    dn = dn + (gm[w, k, l][col] * s_e[k]) * s_x[N + k]
                s_up[w], s_dn[w] = up, dn
    return a, b


@settings(max_examples=300, deadline=None)
@given(st.lists(st.one_of(TIED, FINITE, st.just(float("nan")),
                          st.just(float("inf")), st.just(-0.0)),
                min_size=2, max_size=64),
       st.integers(0, 63))
def test_record_bits_span_both_halves(column, col):
    """The swap bits from the two halves' prefix max are the bubble's
    (``swap_flags``) on drawn columns of up to 64 rows, ties, signed zeros,
    infinities and NaNs among them, rows at and past position 32."""
    col = col % len(column)
    nr = len(column)
    x = np.zeros(64, F32)
    x[:nr] = np.array(column, F32)
    got = record_bits(x, col, nr)
    want = swap_flags(list(x[:nr]), col)
    for r in range(nr):
        assert bool(got[r]) == bool(want[r]), (r, x[:nr], col)
    assert not got[nr:].any() and not got[:col + 1].any()


@pytest.mark.parametrize("n", [17, 33, 40, 64])
def test_warp_lu_is_lu_solve(n):
    """The warp LU on drawn float32 systems with tied entries (a pivot
    search across both halves at n > 32) and two right-hand sides gives
    the plain ``lu_solve``'s bits."""
    rng = np.random.default_rng(n)
    A = rng.choice(np.array([0.0, 1.0, -1.0, 0.5, 2.0, -3.0], F32),
                   (n, n, 6)) + np.eye(n, dtype=F32)[..., None] * F32(0.25)
    A[:, :, :3] += rng.standard_normal((n, n, 3)).astype(F32)
    rhs = rng.standard_normal((n, 2, 6)).astype(F32)
    sys_ = np.concatenate([A, rhs], axis=1)
    warp_lu_solve(sys_, n, 2)
    want = lu_solve(torch.from_numpy(A), torch.from_numpy(rhs)).numpy()
    np.testing.assert_array_equal(sys_[:, n:], want)


@pytest.mark.parametrize("nstr", (34, 48, 64))
def test_big_forward_is_the_plain_forward(nstr):
    """Lane by lane, K2's layout gives ``bvp_forward_plain``'s float32
    bits, the Lambertian fold on the last layer included."""
    ins, ang = _layer_inputs(nstr, L=3, B=3, seed=700 + nstr)
    wmu = (ang.w * ang.mu).astype(F32)
    got = big_forward(*(x.numpy() for x in ins), wmu)
    want = K.bvp_forward_plain(*ins, ang)
    for x, w in zip(got, want):
        assert np.isfinite(x).all()
        np.testing.assert_array_equal(x, w.numpy())


@pytest.mark.parametrize("nstr", NSTR_BIG)
def test_big_backward_is_the_plain_backward(nstr):
    """Warp by warp through the shared-memory exchange, with the last tile
    partial (B = 45), K5's layout gives ``bvp_backward_plain``'s float32
    bits."""
    ins, ang = _layer_inputs(nstr, L=4, B=45, seed=800 + nstr)
    gp, gm, E = ins[:3]
    P, g = K.bvp_forward_plain(*ins, ang)
    got = big_backward(*(x.numpy() for x in (gp, gm, E, P, g)))
    want = K.bvp_backward_plain(gp, gm, E, P, g, ang)
    for x, w in zip(got, want):
        assert np.isfinite(x).all()
        np.testing.assert_array_equal(x, w.numpy())
