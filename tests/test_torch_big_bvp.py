"""Float32 numpy models of K2's and K5's bodies at N = 17..32
(``csrc/bvp_forward_big.cu``, ``csrc/bvp_backward_big.cu``) and of the
warp LU of ``csrc/big.cuh`` that K1 beam and K4 run there, held against the
plain versions.

K2 gives a block of four warps to a column.  Its 2N x (3N + 1) system is
eliminated in the threads' registers, a tile of 8 rows x 7 columns a
thread (6 x 5 at N <= 24), and no row ever moves: each warp keeps a
logical-to-physical row map, lane t holding logical rows t and t + 32, so
a pivot search spans two halves.  ``record_bits`` takes an inclusive prefix max of
|a| over each half (five ``shfl_up`` steps with ``fmaxf``; a NaN pivot
stands as +inf, a NaN below it as -inf), carries the lower half's total
into the upper one and ballots the rows that beat the prefix before them:
the plain bubble's swaps (``test_record_bits_span_both_halves``).  Those
swaps amount to one permutation, which ``record_source`` applies to the
map in one step (``test_one_step_permutation_is_the_bubble``).  Each
thread updates the live rows and the columns right of the pivot of its
tile, each entry a_rj - f a_pj in column order (``block_lu``, tile by
tile); the rows go back in logical order and back substitution takes every
right-hand side at once, each sum in ascending column order; with the block built entry by entry and the
carry Q = R P, rg = R g, the model gives ``bvp_forward_plain``'s float32
bits.

The warp LU (K1 beam and K4) swaps rows record by record over the lanes'
columns, eliminates each row below the pivot on its lane and runs back
substitution a right-hand side a lane (``test_warp_lu_is_lu_solve``).

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

from .test_torch_team_pivot import (FINITE, TIED, _layer_inputs,
                                    bubble_order, swap_flags)

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


def record_source(bits, col: int, x: int) -> int:
    """big.cuh's ``record_source``: the logical position whose row the
    bubble's swaps over records ``bits`` (a bool array over 64 positions)
    in column ``col`` move to position ``x``."""
    rec = [r for r in range(64) if bits[r]]
    if x == col:
        return rec[-1] if rec else col
    if not bits[x]:
        return x
    below = [r for r in rec if r < x]
    return below[-1] if below else col


def block_lu(A, m: int, nq: int):
    """bvp_forward_big.cu's elimination and back substitution in float32 on
    one column's system ``A`` ``(m, m + nq)``, in place, tile by tile:
    thread (ty, tx) of the block's 8 x 16 holds rows ty + 8i and columns
    tx + 16k.  Rows never move; each step publishes the pivot column, finds
    the records through the row map, publishes the pivot row, and each
    thread updates the live rows and the columns right of the pivot of its
    tile.  The rows then go back in logical order (``A`` ends in that
    order, the solution in its right-hand-side columns) and every
    right-hand side is solved at once."""
    w = m + nq
    perm = list(range(m))                  # logical -> physical
    dead = np.zeros(m, bool)               # the pivot rows so far
    pad = np.zeros(64 - m, F32)
    tiles = [(np.arange(ty, m, 8), np.arange(tx, w, 16))
             for ty in range(8) for tx in range(16)]
    with np.errstate(all="ignore"):
        for col in range(m - 1):
            cv = A[:, col].copy()            # the owners publish column col
            bits = record_bits(np.concatenate([cv[perm], pad]), col, m)
            perm = [perm[record_source(bits, col, x)] for x in range(m)]
            pv = perm[col]
            inv = F32(1.0) / cv[pv]
            dead[pv] = True
            piv = A[pv].copy()               # the owners publish row pv
            for rows, cols in tiles:
                rows = rows[~dead[rows]]
                cols = cols[cols > col]
                if rows.size and cols.size:
                    f = cv[rows] * inv
                    A[np.ix_(rows, cols)] = (A[np.ix_(rows, cols)]
                                             - f[:, None] * piv[cols][None])
        A[:] = A[perm]                       # back in logical order
        for i in range(m - 1, -1, -1):       # every right-hand side at once
            acc = A[i, m:w].copy()
            for c in range(i + 1, m):
                acc = acc - A[i, c] * A[c, m:w]
            A[i, m:w] = acc / A[i, i]


def big_forward(gp, gm, E, dblk, albedo, wmu):
    """bvp_forward_big.cu in float32, column by column (a block each):
    ``(P, g)`` as ``bvp_forward_plain``'s."""
    N, _, L, B = gp.shape
    M = 2 * N
    P = np.empty((M, N, L, B), F32)
    g = np.empty((M, L, B), F32)
    with np.errstate(all="ignore"):
        for b in range(B):
            q = np.zeros((N, N), F32)
            rg = np.zeros(N, F32)
            alb2 = F32(2.0) * albedo[b]
            for l in range(L):
                sgp, sgm, se = gp[:, :, l, b], gm[:, :, l, b], E[:, l, b]
                last = l == L - 1
                # the block columns c of [gp, gm E] and [gm, gp E]
                dn = np.concatenate([sgp, sgm * se[None]], axis=1)
                tt = np.concatenate([sgm, sgp * se[None]], axis=1)
                blow = np.concatenate([sgp * se[None], sgm], axis=1)
                if last:
                    rn = np.concatenate([sgm * se[None], sgp], axis=1)
                    refl = wmu[0] * rn[0]
                    for r in range(1, N):
                        refl = refl + wmu[r] * rn[r]
                    blow = blow - alb2 * refl
                A = np.zeros((M, 3 * N + 1), F32)
                acc = q[:, 0, None] * dn[0][None]
                for j in range(1, N):
                    acc = acc + q[:, j, None] * dn[j][None]
                A[:N, :M] = -tt + acc
                A[N:, :M] = blow
                A[N:, M:M + N] = np.eye(N, dtype=F32)
                A[:, M + N] = np.concatenate([dblk[:N, l, b] - rg,
                                              dblk[N:, l, b]])
                block_lu(A, M, N + 1)
                x = A[:, M:]                     # x_r, r in unknown order
                P[:, :, l, b] = x[:, :N]
                g[:, l, b] = x[:, N]
                # the carry Q = Rn x[:, :N], rg = Rn x[:, N], Rn = [gm E, gp]
                rn = np.concatenate([sgm * se[None], sgp], axis=1)
                acc = rn[:, 0, None] * x[0][None]
                for k in range(1, M):
                    acc = acc + rn[:, k, None] * x[k][None]
                q, rg = acc[:, :N], acc[:, N]
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


@settings(max_examples=300, deadline=None)
@given(st.lists(st.one_of(TIED, FINITE), min_size=2, max_size=64),
       st.integers(0, 63))
def test_one_step_permutation_is_the_bubble(column, col):
    """The records of column ``col`` applied as one permutation of the row
    map (``record_source``: col takes the last record's row, each record
    the row of the record before it, the first record col's row) give the
    row order of ``lu_solve``'s bubble, on drawn columns with ties of up to
    64 rows, records at and past position 32."""
    col = col % len(column)
    nr = len(column)
    x = np.zeros(64, F32)
    x[:nr] = np.array(column, F32)
    bits = record_bits(x, col, nr)
    got = [record_source(bits, col, r) for r in range(nr)]
    assert got == bubble_order(list(x[:nr]), col), (x[:nr], col)


@pytest.mark.parametrize("n", [34, 40, 48, 64])
def test_block_lu_is_lu_solve(n):
    """K2's elimination through the row map, with every right-hand side at
    once, on drawn float32 systems with tied entries and 17 right-hand
    sides gives the plain ``lu_solve``'s bits."""
    rng = np.random.default_rng(40 + n)
    nq = 17
    A = rng.choice(np.array([0.0, 1.0, -1.0, 0.5, 2.0, -3.0], F32),
                   (n, n, 4)) + np.eye(n, dtype=F32)[..., None] * F32(0.25)
    A[:, :, :2] += rng.standard_normal((n, n, 2)).astype(F32)
    rhs = rng.standard_normal((n, nq, 4)).astype(F32)
    want = lu_solve(torch.from_numpy(A), torch.from_numpy(rhs)).numpy()
    for b in range(A.shape[-1]):
        sys_ = np.concatenate([A[..., b], rhs[..., b]], axis=1)
        block_lu(sys_, n, nq)
        np.testing.assert_array_equal(sys_[:, n:], want[..., b])


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
    """Block by block, through the row map, K2's body gives
    ``bvp_forward_plain``'s float32 bits, the Lambertian fold on the last
    layer included."""
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
