"""Float32 numpy models of K2's and K5's bodies at N = 33..64
(``csrc/bvp_forward_huge.cu``, ``csrc/bvp_backward_huge.cu``) and of the
pivot search over R sets of 32 rows of ``csrc/huge.cuh``, held against the
plain versions.

K2 gives a block of sixteen warps to a column and eliminates its 2N x
(3N + 1) system in the threads' registers, thread (ty, tx) holding rows
ty + 32i and columns tx + 16k.  Rows never move: each warp keeps a
logical-to-physical row map, lane t holding logical rows t, t + 32,
t + 64 and t + 96.  Each step every warp finds the plain bubble's records
of the published pivot column through its map over the four sets
(``record_bits_sets``: an inclusive prefix max of |a| over each set, the
max of the sets before carried into each, a NaN pivot +inf and a NaN
below it -inf) and applies them to the map as one permutation
(``apply_records_sets``, ``test_one_step_permutation_over_four_sets``);
every live row takes a_rj - f a_pj right of the pivot from the published
pivot row.  The rows go back in logical order and back substitution gives
each right-hand side four lanes, lane s summing the columns c = s (mod 4)
in ascending order, the four sums added as (s0 + s1) + (s2 + s3): not the
plain order, so that part is held to the BVP bound
(``test_huge_back_substitution_within_the_bound``), the elimination to
``lu_solve``'s bits.  The block is built and the carry formed as at N =
17..32 (``test_torch_big_bvp``'s ``big_forward``, run here with this
elimination).  The rotation of rows record by record
(``rotate_records``) is the bubble's too (``test_rotation_is_the_bubble``):
the bodies above N = 64 move their rows so.

K5 gives 32 warps 32 columns; warp w forms the rows w and w + 32 below N,
x_r and x_(N+r), then the sums up_r and dn_r, through shared memory.

In float32 without contracted multiply-adds the models give the plain
versions' bits (K2's with the plain order of back substitution); on the
card, where the two kernels are built with multiply-add contraction,
``chip_smoke.py`` phase 22 holds them within 3e-5 max|ref| + 3e-4 |ref|.
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


def bvp_bound_check(got, ref, what: str) -> None:
    """|got - ref| <= 3e-5 max|ref| + 3e-4 |ref| (the BVP bound of
    ``chip_smoke.py``), entry by entry."""
    ref = np.asarray(ref, np.float64)
    err = np.abs(np.asarray(got, np.float64) - ref)
    bound = 3e-5 * np.abs(ref).max() + 3e-4 * np.abs(ref)
    assert (err <= bound).all(), (what, float((err - bound).max()))


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


def record_source_sets(bits, col: int, x: int) -> int:
    """huge.cuh's ``apply_records_sets`` at logical position ``x``: the
    position whose row the bubble's swaps over the records ``bits`` (a bool
    array over 32 SETS positions) in column ``col`` move to ``x``, found
    as the kernel finds it (``highest_record_below``)."""
    def below(lim: int) -> int:
        recs = np.flatnonzero(bits[:lim])
        return int(recs[-1]) if recs.size else -1

    if x == col or bits[x]:
        r = below(32 * SETS if x == col else x)
        return r if r >= 0 else col
    return x


def tile_lu(A, m: int, nq: int, order: str = "kernel") -> None:
    """bvp_forward_huge.cu's elimination in float32 on one column's system
    ``A`` ``(m, m + nq)``, in place: rows never move; each step publishes
    the pivot column (by physical row), finds the records through the
    warps' row map over four sets, updates the map in one step, publishes
    the pivot row, and every live row takes a_rj - f a_pj right of the
    pivot (an entry's update does not depend on which thread's tile holds
    it).  The rows then go back in logical order and the right-hand sides
    are solved: ``order`` "kernel", the groups of four lanes
    (``group_back_substitute``), or "plain", ``lu_solve``'s order."""
    w = m + nq
    perm = list(range(32 * SETS))          # logical -> physical
    dead = np.zeros(m, bool)               # the pivot rows so far
    pad = np.zeros(32 * SETS - m, F32)
    with np.errstate(all="ignore"):
        for col in range(m - 1):
            cv = np.concatenate([A[:, col], pad])  # column col, published
            bits = record_bits_sets(cv[perm], col, m)
            perm = [perm[record_source_sets(bits, col, x)]
                    for x in range(32 * SETS)]
            pv = perm[col]
            inv = F32(1.0) / cv[pv]
            dead[pv] = True
            piv = A[pv].copy()               # the pivot row, published
            rows = np.flatnonzero(~dead)
            f = cv[rows] * inv
            A[rows, col + 1:w] = (A[rows, col + 1:w]
                                  - f[:, None] * piv[col + 1:w][None])
        A[:] = A[perm[:m]]                   # back in logical order
        if order == "plain":
            for i in range(m - 1, -1, -1):
                acc = A[i, m:w].copy()
                for c in range(i + 1, m):
                    acc = acc - A[i, c] * A[c, m:w]
                A[i, m:w] = acc / A[i, i]
        else:
            group_back_substitute(A, m, nq)


def group_back_substitute(A, m: int, nq: int) -> None:
    """bvp_forward_huge.cu's back substitution in float32 on the eliminated
    ``A`` ``(m, m + nq)`` in logical order, in place: each right-hand side
    on four lanes, lane s summing u_ic x_c over c = s (mod 4), c > i, in
    ascending order from zero, the sums added as (s0 + s1) + (s2 + s3) (the
    two shuffles), x_i = (b_i - sum) / u_ii."""
    w = m + nq
    with np.errstate(all="ignore"):
        for i in range(m - 1, -1, -1):
            part = []
            for s in range(4):
                acc = np.zeros(nq, F32)
                for c in range(i + 1, m):
                    if c % 4 == s:
                        acc = acc + A[i, c] * A[c, m:w]
                part.append(acc)
            tot = (part[0] + part[1]) + (part[2] + part[3])
            A[i, m:w] = (A[i, m:w] - tot) / A[i, i]


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


@settings(max_examples=300, deadline=None)
@given(st.lists(st.one_of(TIED, FINITE), min_size=2, max_size=128),
       st.integers(0, 127))
def test_one_step_permutation_over_four_sets(column, col):
    """The records of column ``col`` applied as one permutation of the row
    map (``record_source_sets``: col takes the last record's row, each
    record the row of the record before it, the first record col's row)
    give the row order of ``lu_solve``'s bubble, on drawn columns with
    ties of up to 128 rows, records in every set."""
    col = col % len(column)
    nr = len(column)
    x = np.zeros(32 * SETS, F32)
    x[:nr] = np.array(column, F32)
    bits = record_bits_sets(x, col, nr)
    got = [record_source_sets(bits, col, r) for r in range(nr)]
    assert got == bubble_order(list(x[:nr]), col), (x[:nr], col)


def _drawn_systems(n: int, nq: int, seed: int):
    """Float32 systems of n rows with tied entries (and one drawn in full)
    and nq right-hand sides: ``(A (n, n, 2), rhs (n, nq, 2))``."""
    rng = np.random.default_rng(seed)
    A = rng.choice(np.array([0.0, 1.0, -1.0, 0.5, 2.0, -3.0], F32),
                   (n, n, 2)) + np.eye(n, dtype=F32)[..., None] * F32(0.25)
    A[:, :, :1] += rng.standard_normal((n, n, 1)).astype(F32)
    rhs = rng.standard_normal((n, nq, 2)).astype(F32)
    return A, rhs


@pytest.mark.parametrize("n", [66, 96, 128])
def test_huge_block_lu_is_lu_solve(n):
    """K2's register-tile elimination, the rows behind the warps' maps over
    four sets, on drawn float32 systems of n = 2N rows with tied entries
    and 17 right-hand sides, then back substitution in the plain order,
    gives the plain ``lu_solve``'s bits."""
    nq = 17
    A, rhs = _drawn_systems(n, nq, 60 + n)
    want = lu_solve(torch.from_numpy(A), torch.from_numpy(rhs)).numpy()
    for b in range(A.shape[-1]):
        sys_ = np.concatenate([A[..., b], rhs[..., b]], axis=1)
        tile_lu(sys_, n, nq, order="plain")
        np.testing.assert_array_equal(sys_[:, n:], want[..., b])


@pytest.mark.parametrize("nstr", (66, 96, 128))
def test_huge_back_substitution_within_the_bound(nstr):
    """The kernel's back substitution (four lanes a right-hand side) after
    its elimination, on the systems K2 solves (the first layer of drawn
    aerosol columns, N unit columns and the right-hand side), is within
    the BVP bound of the plain ``lu_solve``."""
    ins, ang = _layer_inputs(nstr, L=1, B=2, seed=1750 + nstr)
    gp, gm, E, dblk, _ = (x.numpy() for x in ins)
    N = nstr // 2
    for b in range(2):
        gpE = gp[:, :, 0, b] * E[None, :, 0, b]
        M = np.block([[-np.concatenate([gm[:, :, 0, b], gpE], axis=1)],
                      [np.concatenate([gpE, gm[:, :, 0, b]], axis=1)]])
        rhs = np.concatenate([np.concatenate([np.zeros((N, N), F32),
                                              np.eye(N, dtype=F32)]),
                              dblk[:, 0, b, None]], axis=1).astype(F32)
        M = M.astype(F32)
        want = lu_solve(torch.from_numpy(M), torch.from_numpy(rhs)).numpy()
        sys_ = np.concatenate([M, rhs], axis=1)
        tile_lu(sys_, 2 * N, N + 1)
        assert np.isfinite(sys_[:, 2 * N:]).all()
        bvp_bound_check(sys_[:, 2 * N:], want, f"nstr {nstr} column {b}")


@pytest.mark.parametrize("nstr", (66, 96, 128))
def test_huge_forward_is_the_plain_forward(nstr, monkeypatch):
    """Column by column, K2's body gives ``bvp_forward_plain``'s float32
    values, the Lambertian fold on the last layer included: its bits with
    the plain order of back substitution, and within the BVP bound with
    the kernel's."""
    ins, ang = _layer_inputs(nstr, L=2, B=2, seed=1700 + nstr)
    wmu = (ang.w * ang.mu).astype(F32)
    want = K.bvp_forward_plain(*ins, ang)
    for order in ("plain", "kernel"):
        monkeypatch.setattr(big, "block_lu",
                            lambda A, m, nq: tile_lu(A, m, nq, order))
        got = big.big_forward(*(x.numpy() for x in ins), wmu)
        for x, w in zip(got, want):
            assert np.isfinite(x).all()
            if order == "plain":
                np.testing.assert_array_equal(x, w.numpy())
            else:
                bvp_bound_check(x, w.numpy(), f"nstr {nstr}")


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
