"""Float32 numpy models of K2's and K5's bodies at N > 64
(``csrc/bvp_forward_global.cu``, ``csrc/bvp_backward_global.cu``) and of
the pieces of ``csrc/global.cuh`` they share with K1 beam and K4, held
against the bubble and the plain versions.

``record_bits_global`` finds the plain bubble's records of a pivot column
over R = ceil(rows / 32) sets of 32 rows, R a run-time count: the sets in
order from the pivot's on, an inclusive prefix max of |a| over each (a NaN
pivot +inf, a NaN below it -inf), the max of the sets before carried in,
one ballot a set.  ``warp_lu_solve_global`` is the plain ``lu_solve`` by a
warp on a system of any size: the records' swaps in row order, each row
below the pivot on lane r mod 32, back substitution a right-hand side a
lane.

K2's slab body (past the cluster body's reach, N > 170;
``tests/test_torch_cluster_bvp.py`` models the cluster body) keeps its 2N
x (3N + 1) system in a slab of global scratch and moves the rows record
by record (``rotate_records``) with the records over R sets; K5 gives 32
warps a tile of 32 columns, warp w forming the
rows w + 32 j below N, the carry up + dn stored once added and E read
where the sum uses it.

In float32 without contracted multiply-adds the models give the plain
versions' bits; on the card K2 is built so and ``chip_smoke.py`` phase 23
asserts its bits, and K5, built with multiply-add contraction, is held
within 3e-5 max|ref| + 3e-4 |ref|.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

from pyharp_tpu_torch.bench.problems import stage1_inputs
from pyharp_tpu_torch.rt.disort import kernels as K
from pyharp_tpu_torch.rt.disort.linsolve import lu_solve
from pyharp_tpu_torch.rt.disort.solver import make_static_angles

from . import test_torch_big_bvp as big
from .test_torch_big_bvp import _shfl_up
from .test_torch_huge_bvp import rotate_records
from .test_torch_team_pivot import FINITE, TIED, bubble_order, swap_flags

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


def row_sets(rows: int) -> int:
    return (rows + LANES - 1) // LANES


def record_bits_global(x, col: int, nr: int):
    """global.cuh's ``record_bits_global`` on the column ``x`` (``nr``
    entries) of an ``nr``-row system: a bool array over the row positions,
    the sets above col's left False (the body writes no word for them)."""
    sets = row_sets(nr)
    lane = np.arange(LANES)
    inf = F32(np.inf)
    bits = np.zeros(LANES * sets, bool)
    carry = -inf
    for h in range(col // LANES, sets):
        rows = lane + LANES * h
        a = np.abs(np.concatenate([x, np.zeros(LANES * sets - nr, F32)])
                   [LANES * h:LANES * h + LANES])
        k = np.where(np.isnan(a), np.where(rows == col, inf, -inf), a)
        k = np.where((rows < col) | (rows >= nr), -inf, k).astype(F32)
        s, off = k.copy(), 1
        while off < LANES:
            s = np.where(lane >= off, np.fmax(s, _shfl_up(s, off)), s)
            off *= 2
        e = np.where(lane == 0, -inf, _shfl_up(s, 1))
        e = np.fmax(e, carry)
        bits[LANES * h:LANES * h + LANES] = (rows > col) & (k > e)
        carry = np.fmax(carry, s[LANES - 1])
    return bits


def warp_lu_solve_global(A, nr: int, nq: int):
    """global.cuh's ``warp_lu_solve_global`` in float32 on ``A`` ``(nr,
    nr + nq)`` (in place; the solution over the right-hand-side columns)."""
    w = nr + nq
    with np.errstate(all="ignore"):
        for col in range(nr - 1):
            bits = record_bits_global(A[:, col].copy(), col, nr)
            for r in np.flatnonzero(bits[:nr]):        # row order
                a = A[col, col:w].copy()
                A[col, col:w] = A[r, col:w]
                A[r, col:w] = a
            inv = F32(1.0) / A[col, col]
            for t in range(LANES):                     # rows t + 32 j
                for r in range(t, nr, LANES):
                    if r > col:
                        f = A[r, col] * inv
                        A[r, col + 1:w] = A[r, col + 1:w] - f * A[col, col + 1:w]
        for q in range(nq):                            # a right-hand side a lane
            for row in range(nr - 1, -1, -1):
                acc = A[row, nr + q]
                for c in range(row + 1, nr):
                    acc = acc - A[row, c] * A[c, nr + q]
                A[row, nr + q] = acc / A[row, row]


def global_block_lu(A, m: int, nq: int) -> None:
    """bvp_forward_global.cu's elimination and back substitution in float32
    on one column's system ``A`` ``(m, m + nq)``, in place: the huge
    body's steps with the records over ``row_sets(m)`` sets."""
    w = m + nq
    with np.errstate(all="ignore"):
        for col in range(m - 1):
            bits = record_bits_global(A[:, col].copy(), col, m)
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


def global_backward(gp, gm, E, P, g):
    """bvp_backward_global.cu in float32, tile by tile of 32 columns, warp
    w on the rows w + 32 j below N, the carry up + dn stored once added:
    ``(a, b)`` as ``bvp_backward_plain``'s."""
    N, _, L, B = gp.shape
    a = np.full((N, L, B), np.nan, F32)
    b = np.full((N, L, B), np.nan, F32)
    mine = [list(range(w, N, LANES)) for w in range(LANES)]
    for b0 in range(0, B, LANES):
        lanes = np.arange(b0, b0 + LANES)
        col = np.minimum(lanes, B - 1)
        inside = lanes < B
        s_dx = np.zeros((N, LANES), F32)
        for l in range(L - 1, -1, -1):
            s_x = np.empty((2 * N, LANES), F32)
            for w in range(LANES):
                for i in mine[w]:
                    for r in (i, N + i):
                        pr = P[r, :, l][:, col]
                        acc = pr[0] * s_dx[0]
                        for k in range(1, N):
                            acc = acc + pr[k] * s_dx[k]
                        s_x[r] = g[r, l, col] + acc
                        (a if r < N else b)[i, l, lanes[inside]] = \
                            s_x[r][inside]
            if l == 0:
                break
            for w in range(LANES):
                for i in mine[w]:
                    up = gp[i, 0, l][col] * s_x[0]
                    dn = (gm[i, 0, l][col] * E[0, l, col]) * s_x[N]
                    for k in range(1, N):
                        up = up + gp[i, k, l][col] * s_x[k]
                        dn = dn + (gm[i, k, l][col] * E[k, l, col]) * s_x[N + k]
                    s_dx[i] = up + dn
    return a, b


def _iso_layer_inputs(nstr: int, L: int, B: int, seed: int):
    """gp, gm, E from the plain K1 (an isotropic solve), a drawn dblk and
    albedo: the inputs K2 gets on the isotropic paths, float32 tensors."""
    rng = np.random.default_rng(seed)
    ang = make_static_angles(nstr, nstr, 0)
    ssa, dtau, btop, slope = stage1_inputs(L, B, seed=seed, device="cpu")
    gp, gm, _, E, *_ = K.stage1_isotropic_plain(ssa, dtau, btop, slope, ang)
    N = nstr // 2
    t = lambda x: torch.tensor(x, dtype=torch.float32)
    dblk = t(rng.uniform(-1.0, 1.0, (2 * N, L, B)))
    albedo = t(rng.uniform(0.0, 0.6, (B,)))
    return (gp, gm, E, dblk, albedo), ang


@settings(max_examples=150, deadline=None)
@given(st.sampled_from([130, 200, 258]),
       st.lists(st.one_of(TIED, FINITE, st.just(float("nan")),
                          st.just(float("inf")), st.just(-0.0)),
                min_size=258, max_size=258),
       st.integers(0, 257))
def test_record_bits_over_run_time_sets(nr, column, col):
    """The swap bits from the run-time sets' prefix max are the bubble's
    (``swap_flags``) on drawn columns of 130, 200 and 258 rows (5, 7 and
    9 sets, the last partial), ties, signed zeros, infinities and NaNs
    among them, the pivot in any set."""
    col = col % nr
    x = np.array(column[:nr], F32)
    got = record_bits_global(x, col, nr)
    want = swap_flags(list(x), col)
    for r in range(nr):
        assert bool(got[r]) == bool(want[r]), (r, col)
    assert not got[nr:].any() and not got[:col + 1].any()


@pytest.mark.parametrize("nr", [130, 200, 258])
def test_record_bits_rotate_as_the_bubble(nr):
    """The records of every column of a tied column set, applied as one
    rotation of the rows, give the row order of ``lu_solve``'s bubble."""
    rng = np.random.default_rng(nr)
    for col in range(0, nr - 1, 7):
        x = rng.choice(np.array([0.0, 1.0, -1.0, 2.0, -2.0, np.nan], F32), nr)
        bits = record_bits_global(x, col, nr)
        rows = np.arange(nr, dtype=F32)[:, None].repeat(col + 1, axis=1)
        rotate_records(rows, col, bits)
        assert list(rows[:, col].astype(int)) == bubble_order(list(x), col)


@pytest.mark.parametrize("n", [65, 100, 129])
def test_warp_lu_global_is_lu_solve(n):
    """The warp LU over run-time row sets on drawn float32 systems of n =
    65, 100, 129 rows with tied entries and one right-hand side gives the
    plain ``lu_solve``'s bits."""
    rng = np.random.default_rng(n)
    A = rng.choice(np.array([0.0, 1.0, -1.0, 0.5, 2.0, -3.0], F32),
                   (n, n)) + np.eye(n, dtype=F32) * F32(0.25)
    A[:, : n // 2] += rng.standard_normal((n, n // 2)).astype(F32)
    rhs = rng.standard_normal(n).astype(F32)
    want = lu_solve(torch.from_numpy(A)[..., None],
                    torch.from_numpy(rhs)[..., None]).numpy()[:, 0]
    sys_ = np.concatenate([A, rhs[:, None]], axis=1)
    warp_lu_solve_global(sys_, n, 1)
    np.testing.assert_array_equal(sys_[:, n], want)


@pytest.mark.parametrize("nstr", (130, 258))
def test_global_forward_is_the_plain_forward(nstr, monkeypatch):
    """Column by column, K2's body gives ``bvp_forward_plain``'s float32
    values (here its bits) at N = 65 and 129 (2N = 130 and 258 rows over
    5 and 9 sets), the Lambertian fold on the last layer included."""
    monkeypatch.setattr(big, "block_lu", global_block_lu)
    ins, ang = _iso_layer_inputs(nstr, L=2, B=1, seed=1900 + nstr)
    wmu = (ang.w * ang.mu).astype(F32)
    got = big.big_forward(*(x.numpy() for x in ins), wmu)
    want = K.bvp_forward_plain(*ins, ang)
    for x, w in zip(got, want):
        assert np.isfinite(x).all()
        np.testing.assert_array_equal(x, w.numpy())


@pytest.mark.parametrize("nstr", (130, 258))
def test_global_backward_is_the_plain_backward(nstr):
    """Warp by warp through the tile, with the last tile partial (B = 37),
    K5's layout at N = 65 and 129 gives ``bvp_backward_plain``'s float32
    values (here its bits)."""
    ins, ang = _iso_layer_inputs(nstr, L=2, B=37, seed=2000 + nstr)
    gp, gm, E = ins[:3]
    P, g = K.bvp_forward_plain(*ins, ang)
    got = global_backward(*(x.numpy() for x in (gp, gm, E, P, g)))
    want = K.bvp_backward_plain(gp, gm, E, P, g, ang)
    for x, w in zip(got, want):
        assert np.isfinite(x).all()
        np.testing.assert_array_equal(x, w.numpy())
