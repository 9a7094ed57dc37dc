"""Float32 numpy models of K2's and K5's bodies at N = 33..64
(``csrc/bvp_forward_huge.cu``, ``csrc/bvp_backward_huge.cu``) and of the
pivot search over R sets of 32 rows of ``csrc/huge.cuh``, held against the
plain versions.

K2 gives a block of eight warps to a column and keeps its 2N x (3N + 1)
system in shared memory.  Each elimination step, warp 0 finds the plain
bubble's records of the pivot column over the four sets of 32 rows, lane
t holding rows t, t + 32, t + 64 and t + 96 (``record_bits_sets``: an
inclusive prefix max of |a| over each set, the max of the sets before
carried into each, a NaN pivot +inf and a NaN below it -inf); the threads
over the live columns then move the rows as the bubble's swaps do, row
col's entry to the first record, each record's to the next, the last
record's to row col (``test_rotation_is_the_bubble``); every row below the
pivot takes a_rj - f a_pj right of it, and back substitution takes every
right-hand side at once, each sum in ascending column order.  The block is
built and the carry formed as at N = 17..32 (``test_torch_big_bvp``'s
``big_forward``, run here with this elimination).

K5 gives 32 warps 32 columns; warp w forms the rows w and w + 32 below N,
x_r and x_(N+r), then the sums up_r and dn_r, through shared memory.

In float32 without contracted multiply-adds the models give the plain
versions' bits; on the card, where the two kernels are built with
multiply-add contraction, ``chip_smoke.py`` phase 22 holds them within
3e-5 max|ref| + 3e-4 |ref|.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

from pyharp_tpu_torch.rt.disort import kernels as K
from pyharp_tpu_torch.rt.disort.linsolve import lu_solve

from . import test_torch_big_bvp as big
from .test_torch_big_bvp import _shfl_up
from .test_torch_team_pivot import (FINITE, TIED, _layer_inputs,
                                    bubble_order, swap_flags)

F32 = np.float32
SETS = 4                                     # rows t + 32 h, h < SETS


@pytest.fixture(autouse=True)
def one_thread():
    """One intra-op thread: the tensors here are mid-sized, and with
    several test processes on the machine their threads contend."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def record_bits_sets(x, col: int, nr: int, sets: int = SETS):
    """huge.cuh's ``record_bits_sets`` on the column ``x`` ``(32 sets,)``
    of an ``nr``-row system: a bool array over the row positions."""
    lane = np.arange(32)
    inf = F32(np.inf)
    keys, scans = [], []
    for h in range(sets):
        rows = lane + 32 * h
        a = np.abs(x[32 * h:32 * h + 32])
        k = np.where(np.isnan(a), np.where(rows == col, inf, -inf), a)
        k = np.where((rows < col) | (rows >= nr), -inf, k).astype(F32)
        s, off = k.copy(), 1
        while off < 32:
            s = np.where(lane >= off, np.fmax(s, _shfl_up(s, off)), s)
            off *= 2
        keys.append(k)
        scans.append(s)
    carry = -inf
    bits = []
    for h in range(sets):
        e = np.where(lane == 0, -inf, _shfl_up(scans[h], 1))
        e = np.fmax(e, carry)
        bits.append((lane + 32 * h > col) & (keys[h] > e))
        carry = np.fmax(carry, scans[h][31])
    return np.concatenate(bits)


def rotate_records(A, col: int, bits) -> None:
    """The threads' row moves of step ``col`` on ``A`` (in place), each
    column from col on: row col's entry to the first record, each record's
    to the next, the last record's to row col."""
    recs = np.flatnonzero(bits[:A.shape[0]])
    if recs.size == 0:
        return
    v = A[col, col:].copy()
    for r in recs:
        x = A[r, col:].copy()
        A[r, col:] = v
        v = x
    A[col, col:] = v


def huge_block_lu(A, m: int, nq: int) -> None:
    """bvp_forward_huge.cu's elimination and back substitution in float32
    on one column's system ``A`` ``(m, m + nq)``, in place."""
    w = m + nq
    pad = np.zeros(32 * SETS - m, F32)
    with np.errstate(all="ignore"):
        for col in range(m - 1):
            bits = record_bits_sets(np.concatenate([A[:, col], pad]), col, m)
            rotate_records(A, col, bits)
            inv = F32(1.0) / A[col, col]
            f = A[col + 1:m, col] * inv
            A[col + 1:m, col + 1:w] = (A[col + 1:m, col + 1:w]
                                       - f[:, None] * A[col, col + 1:w][None])
        for i in range(m - 1, -1, -1):       # every right-hand side at once
            acc = A[i, m:w].copy()
            for c in range(i + 1, m):
                acc = acc - A[i, c] * A[c, m:w]
            A[i, m:w] = acc / A[i, i]


def huge_backward(gp, gm, E, P, g):
    """bvp_backward_huge.cu in float32, tile by tile of 32 columns, warp w
    on the rows w and w + 32 below N: ``(a, b)`` as ``bvp_backward_plain``'s."""
    N, _, L, B = gp.shape
    a = np.full((N, L, B), np.nan, F32)
    b = np.full((N, L, B), np.nan, F32)
    mine = [[i for i in (w, w + 32) if i < N] for w in range(32)]
    for b0 in range(0, B, 32):
        lanes = np.arange(b0, b0 + 32)
        col = np.minimum(lanes, B - 1)
        inside = lanes < B
        s_up = np.zeros((N, 32), F32)
        s_dn = np.zeros((N, 32), F32)
        for l in range(L - 1, -1, -1):
            s_x = np.empty((2 * N, 32), F32)
            s_e = np.empty((N, 32), F32)
            for w in range(32):
                for i in mine[w]:
                    for r in (i, N + i):
                        pr = P[r, :, l][:, col]
                        acc = pr[0] * (s_up[0] + s_dn[0])
                        for k in range(1, N):
                            acc = acc + pr[k] * (s_up[k] + s_dn[k])
                        s_x[r] = g[r, l, col] + acc
                        (a if r < N else b)[i, l, lanes[inside]] = \
                            s_x[r][inside]
                    s_e[i] = E[i, l, col]
            if l == 0:
                break
            for w in range(32):
                for i in mine[w]:
                    up = gp[i, 0, l][col] * s_x[0]
                    dn = (gm[i, 0, l][col] * s_e[0]) * s_x[N]
                    for k in range(1, N):
                        up = up + gp[i, k, l][col] * s_x[k]
                        dn = dn + (gm[i, k, l][col] * s_e[k]) * s_x[N + k]
                    s_up[i], s_dn[i] = up, dn
    return a, b


@settings(max_examples=300, deadline=None)
@given(st.lists(st.one_of(TIED, FINITE, st.just(float("nan")),
                          st.just(float("inf")), st.just(-0.0)),
                min_size=2, max_size=128),
       st.integers(0, 127))
def test_record_bits_span_four_sets(column, col):
    """The swap bits from the four sets' prefix max are the bubble's
    (``swap_flags``) on drawn columns of up to 128 rows, ties, signed
    zeros, infinities and NaNs among them, records in every set."""
    col = col % len(column)
    nr = len(column)
    x = np.zeros(32 * SETS, F32)
    x[:nr] = np.array(column, F32)
    got = record_bits_sets(x, col, nr)
    want = swap_flags(list(x[:nr]), col)
    for r in range(nr):
        assert bool(got[r]) == bool(want[r]), (r, x[:nr], col)
    assert not got[nr:].any() and not got[:col + 1].any()


@pytest.mark.parametrize("sets", [1, 2])
def test_record_bits_sets_are_the_big_bits(sets):
    """With one or two sets the bits are those of ``record_bits32`` and
    big.cuh's ``record_bits`` (two halves), on tied columns."""
    rng = np.random.default_rng(sets)
    for col in range(0, 32 * sets - 1, 5):
        x = rng.choice(np.array([0.0, 1.0, -1.0, 2.0, np.nan], F32),
                       32 * sets)
        got = record_bits_sets(x, col, 32 * sets, sets)
        pad = np.concatenate([x, np.zeros(64 - 32 * sets, F32)])
        want = big.record_bits(pad, col, 32 * sets)[:32 * sets]
        np.testing.assert_array_equal(got, want)


@settings(max_examples=300, deadline=None)
@given(st.lists(st.one_of(TIED, FINITE), min_size=2, max_size=128),
       st.integers(0, 127))
def test_rotation_is_the_bubble(column, col):
    """The records of column ``col`` applied as one rotation of the rows
    (row col's entry to the first record, each record's to the next, the
    last record's to row col) give the row order of ``lu_solve``'s bubble,
    on drawn columns with ties of up to 128 rows."""
    col = col % len(column)
    nr = len(column)
    x = np.zeros(32 * SETS, F32)
    x[:nr] = np.array(column, F32)
    bits = record_bits_sets(x, col, nr)
    rows = np.arange(nr, dtype=F32)[:, None].repeat(col + 1, axis=1)
    rotate_records(rows, col, bits)
    assert list(rows[:, col].astype(int)) == bubble_order(list(x[:nr]), col)


@pytest.mark.parametrize("n", [66, 96, 128])
def test_huge_block_lu_is_lu_solve(n):
    """K2's elimination with the rows moved record by record, every
    right-hand side at once, on drawn float32 systems of n = 2N rows with
    tied entries and 17 right-hand sides gives the plain ``lu_solve``'s
    bits."""
    rng = np.random.default_rng(60 + n)
    nq = 17
    A = rng.choice(np.array([0.0, 1.0, -1.0, 0.5, 2.0, -3.0], F32),
                   (n, n, 2)) + np.eye(n, dtype=F32)[..., None] * F32(0.25)
    A[:, :, :1] += rng.standard_normal((n, n, 1)).astype(F32)
    rhs = rng.standard_normal((n, nq, 2)).astype(F32)
    want = lu_solve(torch.from_numpy(A), torch.from_numpy(rhs)).numpy()
    for b in range(A.shape[-1]):
        sys_ = np.concatenate([A[..., b], rhs[..., b]], axis=1)
        huge_block_lu(sys_, n, nq)
        np.testing.assert_array_equal(sys_[:, n:], want[..., b])


@pytest.mark.parametrize("nstr", (66, 96, 128))
def test_huge_forward_is_the_plain_forward(nstr, monkeypatch):
    """Column by column, K2's body gives ``bvp_forward_plain``'s float32
    values (here its bits), the Lambertian fold on the last layer
    included."""
    monkeypatch.setattr(big, "block_lu", huge_block_lu)
    ins, ang = _layer_inputs(nstr, L=2, B=2, seed=1700 + nstr)
    wmu = (ang.w * ang.mu).astype(F32)
    got = big.big_forward(*(x.numpy() for x in ins), wmu)
    want = K.bvp_forward_plain(*ins, ang)
    for x, w in zip(got, want):
        assert np.isfinite(x).all()
        np.testing.assert_array_equal(x, w.numpy())


@pytest.mark.parametrize("nstr", (66, 96, 128))
def test_huge_backward_is_the_plain_backward(nstr):
    """Warp by warp through the shared-memory exchange, with the last tile
    partial (B = 37), K5's layout gives ``bvp_backward_plain``'s float32
    values (here its bits)."""
    ins, ang = _layer_inputs(nstr, L=3, B=37, seed=1800 + nstr)
    gp, gm, E = ins[:3]
    P, g = K.bvp_forward_plain(*ins, ang)
    got = huge_backward(*(x.numpy() for x in (gp, gm, E, P, g)))
    want = K.bvp_backward_plain(gp, gm, E, P, g, ang)
    for x, w in zip(got, want):
        assert np.isfinite(x).all()
        np.testing.assert_array_equal(x, w.numpy())
