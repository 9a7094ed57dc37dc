"""A float32 numpy model of K2's half-warp team at N = 5, 6, 7
(``csrc/bvp_forward.cu``, ``bvp_forward_half_kernel``, a template over
N <= 8 that the library builds at N = 7, where the solves take it), lane
by lane and position by position, held against the unpadded team model of
``tests/test_torch_team_pivot.py``, the warp-per-column model of
``tests/test_torch_wide_team.py`` and the plain
``kernels.bvp_forward_plain``; and the port's plain K2 + K5 at nstr 10,
12 and 14 against the JAX package's XLA solver, and at nstr 10 and 12
against its Pallas kernels (interpret mode, answers pinned by
``tests/make_bvp_mid_golden.py``).

The team gives 16 lanes to one column, two columns to a warp.  The rows
and block columns of the 2N x 2N system sit at fixed positions, the
upper block's at 0..N-1 and the lower block's at 8..8+N-1; lane p owns
the block column at position p, lanes p < N also unit column p, lane 8
the right-hand side.  Loops run over the 16 positions and skip the empty
ones.  The swap bits of pivot c are the records of the pivot column over
the 16 lanes (``record_bits``: a prefix max with ``fmaxf``, four steps,
then a ballot), the bits of the plain bubble.  If the positions keep the
system's order, the model gives the bits of the unpadded team model, and
with division in back substitution those of the plain version.  On the
card the kernel contracts multiply-adds and is held to the plain version
within the BVP bound (``chip_smoke.py`` phases 3, 13 and 20).
"""

from __future__ import annotations

from types import SimpleNamespace

import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

from pyharp_tpu.rt.disort import solver as JS
from pyharp_tpu_torch.rt.disort import kernels as K

from .make_bvp_mid_golden import NSTR as PINNED_NSTR
from .make_bvp_mid_golden import OUT as GOLDEN
from .make_bvp_mid_golden import RHS
from .test_torch_scattering_kernels import _bvp, _torch_k5
from .test_torch_team_pivot import (FINITE, TIED, _layer_inputs, _model,
                                    swap_flags)
from .test_torch_wide_team import _wide_model, record_bits

F32 = np.float32
LANES = 16
LOW = 8          # position of the lower block's first row
HALF_N = (5, 6, 7)


def live(p: int, n: int) -> bool:
    return (p & 7) < n


def row_at(p: int, n: int) -> int:
    return p if p < LOW else n + p - LOW


def half_forward(gp, gm, E, dblk, albedo, wmu, reciprocal: bool = True):
    """The half-warp team in float32, in the kernel's order: ``a[p, s]`` is
    lane p's entry at position s, ``u[p, s]`` its right-hand-side
    column.  Arrays as ``bvp_forward_plain``'s, numpy float32."""
    N, _, L, B = gp.shape
    pos = [s for s in range(LANES) if live(s, N)]
    live_pos = [live(s, N) for s in range(LANES)]
    q = np.zeros((N, N, B), F32)
    rg = np.zeros((N, B), F32)          # the rhs lane's
    P = np.empty((2 * N, N, L, B), F32)
    g = np.empty((2 * N, L, B), F32)
    with np.errstate(all="ignore"):
        for l in range(L):
            gpl, gml, el, dl = gp[:, :, l], gm[:, :, l], E[:, l], dblk[:, l]
            a = np.zeros((LANES, LANES, B), F32)
            u = np.zeros((LANES, LANES, B), F32)
            for p in range(LANES):
                lo = p < LOW
                jj = (p & 7) if live(p, N) else 0
                ej = el[jj]
                for i in range(N):
                    ttop = gml[i, jj] if lo else gpl[i, jj] * ej
                    for k in range(N):
                        dkj = gpl[k, jj] if lo else gml[k, jj] * ej
                        acc = q[i, 0] * dkj if k == 0 else acc + q[i, k] * dkj
                    a[p, i] = -ttop + acc
                    a[p, LOW + i] = gpl[i, jj] * ej if lo else gml[i, jj]
                if l == L - 1:
                    alb2 = F32(2.0) * albedo
                    for r in range(N):
                        rn = gml[r, jj] * ej if lo else gpl[r, jj]
                        refl = wmu[r] * rn if r == 0 else refl + wmu[r] * rn
                    for i in range(N):
                        a[p, LOW + i] = a[p, LOW + i] - alb2 * refl
                rhs = p == LOW
                for i in range(N):
                    u[p, i] = dl[i] - rg[i] if rhs else 0.0
                    u[p, LOW + i] = dl[N + i] if rhs else F32(p == i)
            for c in pos:
                # lane c's column in shared memory, an entry a lane
                bits = record_bits(a[c], c, live_pos)
                for r in pos:
                    if r > c:
                        for x in (a, u):
                            hi = np.where(bits[r], x[:, r], x[:, c])
                            lw = np.where(bits[r], x[:, c], x[:, r])
                            x[:, c], x[:, r] = hi, lw
                inv = F32(1.0) / a[c, c]
                for r in pos:
                    if r > c:
                        f = a[c, r] * inv
                        a[:, r] = a[:, r] - f * a[:, c]
                        u[:, r] = u[:, r] - f * u[:, c]
            for row in pos[::-1]:
                acc = u[:, row].copy()
                for c in pos:
                    if c > row:
                        acc = acc - a[c, row] * u[:, c]
                piv = a[row, row]
                u[:, row] = acc * (F32(1.0) / piv) if reciprocal else acc / piv
            for s in pos:
                r = row_at(s, N)
                P[r, :, l] = u[:N, s]
                g[r, l] = u[LOW, s]
            for i in range(N):
                for s in pos:
                    rn = (gml[i, s] * el[s] if s < LOW
                          else gpl[i, s - LOW])
                    acc = rn * u[:, s] if s == 0 else acc + rn * u[:, s]
                q[i] = acc[:N]
                rg[i] = acc[LOW]
    return P, g


def _half_model(ins, ang, reciprocal):
    wmu = (ang.w * ang.mu).astype(F32)
    return half_forward(*(x.numpy() for x in ins), wmu, reciprocal)


# B = 13 columns: two columns a warp and 16 a block leave the last partial
L_HALF, B_HALF = 4, 13


@pytest.mark.parametrize("N", HALF_N)
def test_half_forward_with_division_is_the_plain_forward(N):
    """With division in back substitution the half-warp model gives
    ``bvp_forward_plain``'s float32 bits over a whole forward sweep
    (build, record pivots, elimination, carry, the Lambertian fold)."""
    ins, ang = _layer_inputs(2 * N, L=L_HALF, B=B_HALF, seed=600 + N)
    want = K.bvp_forward_plain(*ins, ang)
    for w, x in zip(want, _half_model(ins, ang, reciprocal=False)):
        np.testing.assert_array_equal(x, w.numpy())


@pytest.mark.parametrize("N", HALF_N)
def test_half_forward_is_within_the_bvp_bound(N):
    """The half-warp model as shipped (times the pivot's reciprocal)
    against the plain version in float32 and float64: |err| <= 3e-5
    max|ref| + 3e-4 |ref| per output (``tests/test_pallas_kernels.py:70``)."""
    ins, ang = _layer_inputs(2 * N, L=L_HALF, B=B_HALF, seed=700 + N)
    got = _half_model(ins, ang, reciprocal=True)
    for dtype in (torch.float32, torch.float64):
        want = K.bvp_forward_plain(*(x.to(dtype) for x in ins), ang)
        for w, x in zip(want, got):
            w = w.numpy()
            assert np.isfinite(x).all()
            np.testing.assert_allclose(x, w, rtol=3e-4,
                                       atol=3e-5 * np.abs(w).max())


@pytest.mark.parametrize("N", HALF_N)
def test_half_forward_is_the_team_and_the_warp_forward(N):
    """The positions keep the system's order: the half-warp model gives
    the bits of the unpadded team model (the pivot lane's bubble bits)
    and of the warp-per-column model of N = 9..16 run at these N
    (positions 0..N-1 and 16..16+N-1), with the reciprocal and with
    division."""
    ins, ang = _layer_inputs(2 * N, L=3, B=5, seed=800 + N)
    for reciprocal in (True, False):
        got = _half_model(ins, ang, reciprocal)
        for want in (_model(ins, ang, reciprocal),
                     _wide_model(ins, ang, reciprocal)):
            for w, x in zip(want, got):
                np.testing.assert_array_equal(x, w)


@settings(max_examples=300, deadline=None)
@given(st.integers(5, 7),
       st.lists(st.one_of(TIED, FINITE, st.just(float("nan")),
                          st.just(float("inf")), st.just(-0.0)),
                min_size=16, max_size=16),
       st.integers(0, 15))
def test_half_record_bits_are_the_bubble_swaps(N, column, col):
    """Over the 16 lanes of a half warp, with the empty positions of
    N = 5..7 between the blocks, the record bits equal the pivot lane's
    bubble swap bits on drawn columns (ties, signed zeros, infinities,
    NaNs)."""
    live_pos = [live(s, N) for s in range(LANES)]
    rows = [s for s in range(LANES) if live_pos[s]]
    col = rows[col % len(rows)]
    x = np.array(column, F32)
    got = record_bits(x, col, live_pos)
    want = swap_flags([x[r] for r in rows], rows.index(col))
    for k, r in enumerate(rows):
        assert bool(got[r]) == bool(want[k]), (r, x[rows], col)
    assert not got[[s for s in range(LANES) if not live_pos[s]]].any()


@pytest.mark.parametrize("nstr", PINNED_NSTR)
def test_plain_k2_k5_match_pallas_f32(nstr):
    """The port's plain K2 + K5 at nstr 10 and 12 against
    ``solve_bvp_pallas`` in interpret mode, float32, on the same inputs:
    atol 3e-5 max|ref|, rtol 3e-4 (``tests/test_pallas_kernels.py:70``).
    Inputs and Pallas answers are pinned in ``tests/golden/
    bvp_mid_pallas.npz`` (``tests/make_bvp_mid_golden.py``): the
    interpret-mode compile takes minutes at these N, and at nstr 14 more
    memory than a CPU test may take."""
    pins = np.load(GOLDEN)
    x = lambda k: pins[f"nstr{nstr}_{k}"]
    sol = SimpleNamespace(gp=x("gp"), gm=x("gm"), expd=x("expd"))
    args = (sol, *(x(k) for k in RHS), SimpleNamespace(nstr=nstr))
    got = _torch_k5(args)
    for g, w in zip(got, (x("a"), x("b"))):
        assert g.shape == w.shape and g.dtype == np.float32
        np.testing.assert_allclose(g, w, atol=3e-5 * np.abs(w).max(),
                                   rtol=3e-4)
    assert K.launch_counts()["bvp_forward"] == 0


@pytest.mark.parametrize("nstr", [2 * n for n in HALF_N])
def test_plain_k2_k5_match_xla_solve_bvp_f64(nstr):
    """The same in float64 against the XLA ``solver.solve_bvp``: 1e-12 of
    max|ref|, the same recurrence."""
    args = _bvp(nstr, 11, 16, seed=nstr + 1, dtype=np.float64)
    want = JS.solve_bvp(*args)
    for g, w in zip(_torch_k5(args), want):
        w = np.asarray(w)
        assert np.abs(g - w).max() <= 1e-12 * np.abs(w).max()
