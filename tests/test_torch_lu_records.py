"""The plain ``linsolve.lu_solve`` pivots by records of the pivot column and
one gather of the rows; the bubble it replaced swapped the row at ``col``
with every later row whose |a| beats it, strictly.  Held here bit for bit
(``torch.equal``) to that bubble, kept as the oracle, on drawn systems
with ties, NaNs, signed zeros and infinities, and through the plain
versions of K1's beam variant and K2 at N = 16 with the oracle swapped
in."""

from __future__ import annotations

import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

from pyharp_tpu_torch.rt.disort import kernels as K
from pyharp_tpu_torch.rt.disort.linsolve import lu_solve
from pyharp_tpu_torch.rt.disort.solver import make_static_angles
from pyharp_tpu_torch.bench.problems import extra_problem, stage1_inputs


def bubble_lu_solve(A, b):
    """The bubble: a list of ``(ncols, *batch)`` rows, each column's rows
    swapped in turn with ``where`` under ``|a_r| > |a_col|``."""
    n = A.shape[0]
    vec = b.ndim == A.ndim - 1
    if vec:
        b = b[:, None]
    rows = [torch.cat([A[i], b[i].to(A.dtype)], dim=0) for i in range(n)]
    for col in range(n):
        for r in range(col + 1, n):
            swap = rows[r][col].abs() > rows[col][col].abs()
            hi = torch.where(swap, rows[r], rows[col])
            lo = torch.where(swap, rows[col], rows[r])
            rows[col] = hi
            rows[r] = lo
        inv = 1.0 / rows[col][col]
        for r in range(col + 1, n):
            f = rows[r][col] * inv
            rows[r] = rows[r] - f[None] * rows[col]
    x = [None] * n
    for row in range(n - 1, -1, -1):
        acc = rows[row][n:]
        for col in range(row + 1, n):
            acc = acc - rows[row][col][None] * x[col]
        x[row] = acc / rows[row][row][None]
    out = torch.stack(x, dim=0)
    return out[:, 0] if vec else out


def same_bits(x, y) -> bool:
    """``torch.equal`` of the bits (NaN payloads and -0 included)."""
    it = torch.int32 if x.dtype == torch.float32 else torch.int64
    return x.shape == y.shape and torch.equal(x.view(it), y.view(it))


SPECIAL = np.array([0.0, -0.0, np.inf, -np.inf, np.nan])


def drawn_system(n, batch, k, seed, special, ties, dtype):
    """``(A, b)``: entries of a few values where ``ties`` (so pivot columns
    hold equal |a| of either sign), else normals; a ``special`` share of
    them replaced by 0, -0, +-inf or NaN."""
    rng = np.random.default_rng(seed)
    shape = (n, n + k, batch)
    if ties:
        M = rng.choice([-2.0, -1.0, 1.0, 2.0, 0.5], size=shape)
    else:
        M = rng.normal(size=shape)
    hit = rng.random(shape) < special
    M[hit] = rng.choice(SPECIAL, size=int(hit.sum()))
    M = torch.tensor(M, dtype=dtype)
    return M[:, :n].contiguous(), M[:, n:].contiguous()


@pytest.mark.parametrize("n", [2, 5, 16, 32])
@settings(max_examples=25, deadline=None)
@given(seed=st.integers(0, 2**32 - 1),
       special=st.sampled_from([0.0, 0.02, 0.2]),
       ties=st.booleans())
def test_records_are_the_bubble(n, seed, special, ties):
    """One right-hand side, float32, 6 systems a draw."""
    A, b = drawn_system(n, 6, 1, seed, special, ties, torch.float32)
    got = lu_solve(A, b[:, 0])
    want = bubble_lu_solve(A, b[:, 0])
    assert same_bits(got, want)


@pytest.mark.parametrize("n", [5, 16])
@settings(max_examples=15, deadline=None)
@given(seed=st.integers(0, 2**32 - 1),
       special=st.sampled_from([0.0, 0.05]), ties=st.booleans())
def test_records_are_the_bubble_many_rhs(n, seed, special, ties):
    """Several right-hand sides at once (``b`` ``(n, k, *batch)``), float64,
    two batch axes."""
    A, b = drawn_system(n, 8, 3, seed, special, ties, torch.float64)
    A, b = A.reshape(n, n, 2, 4), b.reshape(n, 3, 2, 4)
    got = lu_solve(A, b)
    want = bubble_lu_solve(A, b)
    assert same_bits(got, want)


def test_first_record_order():
    """A column -1, 2, -2, 3, 3, NaN below a pivot of 1: records at rows
    1 and 3 (2 beats 1, 3 beats 2; the tie -2 and the second 3 do not, nor
    NaN), so row 3 ends at the top, row 1 at row 3's place and row 0 at
    row 1's, as the bubble leaves them."""
    col0 = torch.tensor([1.0, 2.0, -2.0, 3.0, 3.0, float("nan")])
    A = torch.eye(6) * 7.0
    A[:, 0] = col0
    A = A[:, :, None]
    b = torch.arange(6, dtype=torch.float32)[:, None]
    assert same_bits(lu_solve(A, b), bubble_lu_solve(A, b))


@pytest.mark.parametrize("which", ["k1_beam", "k2"])
def test_plain_kernels_keep_their_bits(which, monkeypatch):
    """The plain K1 beam variant and the plain K2 at N = 16 (nstr 32) give
    the same bits with the records as with the bubble."""
    if which == "k1_beam":
        L, B = 2, 6
        ang = make_static_angles(32, 32, 0)
        ssa, dtau, btop, slope = stage1_inputs(L, B, seed=11, device="cpu")
        rng = np.random.default_rng(12)
        fbeam = torch.tensor(rng.uniform(0.5, 4.0, B), dtype=torch.float32)
        mur = torch.tensor(rng.uniform(0.1, 1.0, (L, B)), dtype=torch.float32)

        def run():
            return K.stage1_isotropic_beam_plain(ssa, dtau, btop, slope,
                                                 fbeam, mur, ang)
    else:
        p = extra_problem(1, 4, 3, 32, g=0.8, device="cpu", kernel="torch",
                          seed=5)
        pr = p.disort._prepare(p.prop, p.bc, None)
        md = p.disort._solve_mode(pr)
        sol = md["sol"]

        def run():
            return K.bvp_forward_plain(sol.gp, sol.gm, sol.expd, md["dblk"],
                                       pr["albedo"], p.disort._ang0)
    got = run()
    monkeypatch.setattr(K, "lu_solve", bubble_lu_solve)
    want = run()
    assert all(same_bits(g, w) for g, w in zip(got, want))
