"""A float32 numpy model of K2's body at N = 9..16
(``csrc/bvp_forward_wide.cu``, ``bvp_forward_wide_kernel``), lane by lane
and position by position, held against the team model of
``tests/test_torch_team_pivot.py`` and the plain ``kernels.bvp_forward_plain``.

The wide body gives a whole warp to one column at every N = 9..16.  The
rows and block columns of the 2N x 2N system sit at fixed positions, the
upper block's at 0..N-1 and the lower block's at 16..16+N-1; lane p owns
the block column at position p, lanes p < N also unit column p, lane 16
the right-hand side.  Loops run over all 32 positions and skip the empty
ones.  The swap bits of pivot c are the records of the pivot column: lane
r takes |a_r| from lane c's column, and row r swaps where |a_r| beats,
strictly, the prefix max of |a_k| over c <= k < r (``record_bits``, a
five-step scan over the lanes with ``fmaxf``, which skips NaNs; a NaN
pivot stands as +inf).  These are the bits of the plain bubble
(``test_record_bits_are_the_bubble_swaps``).  If the positions keep the
system's order, the model gives the bits of the unpadded team model, and
with division in back substitution those of the plain version.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

from pyharp_tpu_torch.rt.disort import kernels as K

from .test_torch_team_pivot import (FINITE, TIED, _layer_inputs, _model,
                                    swap_flags)

F32 = np.float32
HALF = 16


def live(p: int, n: int) -> bool:
    return (p & 15) < n


def row_at(p: int, n: int) -> int:
    return p if p < HALF else n + p - HALF


def record_bits(x, c: int, live_pos):
    """The swap bits of pivot c as the kernel forms them: ``x`` ``(32,
    ...)`` holds lane c's column (every lane reads its row's entry),
    ``live_pos`` the positions that hold a row.  Returns a bool array of
    x's shape: row r swaps where |a_r| > max |a_k| over c <= k < r."""
    ax = np.abs(x)
    lanes = np.arange(x.shape[0]).reshape((-1,) + (1,) * (x.ndim - 1))
    live_pos = np.asarray(live_pos).reshape(lanes.shape)
    cand = (lanes > c) & live_pos
    pivot = np.where(np.isnan(ax), F32(np.inf), ax)
    run = np.where(lanes == c, pivot, np.where(cand, ax, F32(-1.0)))
    d = 1
    while d < x.shape[0]:                       # shfl_up and fmaxf
        y = np.concatenate([run[:d], run[:-d]])
        run = np.where(lanes >= d, np.fmax(run, y), run)
        d *= 2
    before = np.concatenate([run[:1], run[:-1]])
    with np.errstate(invalid="ignore"):
        return cand & (ax > before)


def wide_forward(gp, gm, E, dblk, albedo, wmu, reciprocal: bool = True):
    """The wide body in float32, in the kernel's order: ``a[p, s]`` is lane
    p's entry at position s, ``u[p, s]`` its right-hand-side column."""
    N, _, L, B = gp.shape
    pos = [s for s in range(32) if live(s, N)]
    q = np.zeros((N, N, B), F32)
    rg = np.zeros((N, B), F32)          # the rhs lane's
    P = np.empty((2 * N, N, L, B), F32)
    g = np.empty((2 * N, L, B), F32)
    with np.errstate(all="ignore"):
        for l in range(L):
            gpl, gml, el, dl = gp[:, :, l], gm[:, :, l], E[:, l], dblk[:, l]
            a = np.zeros((32, 32, B), F32)
            u = np.zeros((32, 32, B), F32)
            for p in range(32):
                lo = p < HALF
                jj = (p & 15) if live(p, N) else 0
                ej = el[jj]
                for i in range(N):
                    ttop = gml[i, jj] if lo else gpl[i, jj] * ej
                    for k in range(N):
                        dkj = gpl[k, jj] if lo else gml[k, jj] * ej
                        acc = q[i, 0] * dkj if k == 0 else acc + q[i, k] * dkj
                    a[p, i] = -ttop + acc
                    a[p, HALF + i] = gpl[i, jj] * ej if lo else gml[i, jj]
                if l == L - 1:
                    alb2 = F32(2.0) * albedo
                    for r in range(N):
                        rn = gml[r, jj] * ej if lo else gpl[r, jj]
                        refl = wmu[r] * rn if r == 0 else refl + wmu[r] * rn
                    for i in range(N):
                        a[p, HALF + i] = a[p, HALF + i] - alb2 * refl
                rhs = p == HALF
                for i in range(N):
                    u[p, i] = dl[i] - rg[i] if rhs else 0.0
                    u[p, HALF + i] = dl[N + i] if rhs else F32(p == i)
            live_pos = [live(s, N) for s in range(32)]
            for c in pos:
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
                g[r, l] = u[HALF, s]
            for i in range(N):
                for s in pos:
                    rn = (gml[i, s] * el[s] if s < HALF
                          else gpl[i, s - HALF])
                    acc = rn * u[:, s] if s == 0 else acc + rn * u[:, s]
                q[i] = acc[:N]
                rg[i] = acc[HALF]
    return P, g


def _wide_model(ins, ang, reciprocal):
    wmu = (ang.w * ang.mu).astype(F32)
    return wide_forward(*(x.numpy() for x in ins), wmu, reciprocal)


@pytest.mark.parametrize("nstr", [18, 22, 32])
def test_wide_forward_is_the_team_forward(nstr):
    """The positions keep the system's order: the wide body gives the
    unpadded team model's bits (N = 9, 11 and 16; 2N divides 32 only at
    16).  B = 5 columns, L = 3 layers."""
    ins, ang = _layer_inputs(nstr, L=3, B=5, seed=nstr)
    for reciprocal in (True, False):
        want = _model(ins, ang, reciprocal)
        got = _wide_model(ins, ang, reciprocal)
        for w, x in zip(want, got):
            np.testing.assert_array_equal(x, w)


@pytest.mark.parametrize("nstr", [18, 32])
def test_wide_forward_with_division_is_the_plain_forward(nstr):
    """With division in back substitution the wide model gives
    ``bvp_forward_plain``'s float32 bits; as shipped (the pivot's
    reciprocal) it is within the BVP bound of the plain version in float32
    and float64."""
    ins, ang = _layer_inputs(nstr, L=3, B=5, seed=100 + nstr)
    want = K.bvp_forward_plain(*ins, ang)
    for w, x in zip(want, _wide_model(ins, ang, reciprocal=False)):
        np.testing.assert_array_equal(x, w.numpy())
    got = _wide_model(ins, ang, reciprocal=True)
    for dtype in (torch.float32, torch.float64):
        want = K.bvp_forward_plain(*(x.to(dtype) for x in ins), ang)
        for w, x in zip(want, got):
            w = w.numpy()
            assert np.isfinite(x).all()
            np.testing.assert_allclose(x, w, rtol=3e-4,
                                       atol=3e-5 * np.abs(w).max())


@settings(max_examples=300, deadline=None)
@given(st.lists(st.one_of(TIED, FINITE, st.just(float("nan")),
                          st.just(float("inf")), st.just(-0.0)),
                min_size=2, max_size=32),
       st.integers(0, 31), st.integers(0, 2**32 - 1))
def test_record_bits_are_the_bubble_swaps(column, col, dead):
    """The prefix-max record bits equal the pivot lane's bubble swap bits
    (``swap_flags``, strict |a_r| > |champion|) on drawn columns: ties,
    zeros of either sign, infinities and NaNs (a NaN never beats the
    champion, and a NaN pivot is never beaten), with positions left empty
    as the wide body leaves them between the two blocks."""
    col = col % len(column)
    x = np.zeros(32, F32)
    x[:len(column)] = np.array(column, F32)
    live_pos = [(r < len(column)) and (r == col or not (dead >> r) & 1)
                for r in range(32)]
    got = record_bits(x, col, live_pos)
    rows = [r for r in range(32) if live_pos[r]]
    want = swap_flags([x[r] for r in rows], rows.index(col))
    for k, r in enumerate(rows):
        assert bool(got[r]) == bool(want[k]), (r, x[rows], col)
    assert not got[[r for r in range(32) if not live_pos[r]]].any()
