"""A float32 numpy model of K5's rows kernel at N = 9..16
(``csrc/bvp_backward.cu``, ``bvp_backward_rows_kernel``), warp by warp
and lane by lane, held against the per-thread steps and the plain
``kernels.bvp_backward_plain``.

The kernel gives a block 32 consecutive columns (lane c owns column
b0 + c; lanes past B read column B - 1 and store nothing) and 2N warps.
Per layer, bottom-up: warp w forms x_w = g_w + sum_k P[w, k] dx_k, with
dx_k = up_k + dn_k read from shared memory, and stores it; warps w >= N
also put E[w - N] in shared memory.  After a barrier, warp i < N forms
up_i = sum_k gp[i, k] x_k and warp N + i forms dn_i = sum_k (gm[i, k]
E_k) x_(N+k), each sum in the per-thread body's order, into shared
memory; after a second barrier the next layer reads them.  The model
runs those phases in that order on arrays shaped like the shared
memory; it must give the bits of ``thread_backward``
(``tests/test_torch_team_pivot.py``), the per-thread steps of
``common.cuh`` in their order, and stay within the BVP bound of the
plain version.  On the card the kernel is held to the plain version
within that bound (``chip_smoke.py`` phases 19 and 20).
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

from pyharp_tpu_torch.rt.disort import kernels as K

from .test_torch_team_pivot import _layer_inputs, thread_backward

F32 = np.float32
TILE = 32


def rows_backward(gp, gm, E, P, g):
    """The rows kernel in float32, tile by tile: ``(a, b)``, ``(N, L, B)``
    each.  Arrays as ``bvp_backward_plain``'s, numpy float32."""
    N, _, L, B = gp.shape
    a = np.full((N, L, B), np.nan, F32)
    b = np.full((N, L, B), np.nan, F32)
    for b0 in range(0, B, TILE):
        lanes = np.arange(b0, b0 + TILE)
        col = np.minimum(lanes, B - 1)          # lanes past B read B - 1
        inside = lanes < B
        s_up = np.zeros((N, TILE), F32)
        s_dn = np.zeros((N, TILE), F32)
        for l in range(L - 1, -1, -1):
            s_x = np.empty((2 * N, TILE), F32)
            s_e = np.empty((N, TILE), F32)
            for w in range(2 * N):              # phase 1: warp w
                i = w % N
                pr = P[w, :, l][:, col]
                acc = pr[0] * (s_up[0] + s_dn[0])
                for k in range(1, N):
                    acc = acc + pr[k] * (s_up[k] + s_dn[k])
                x = g[w, l, col] + acc
                s_x[w] = x
                if w >= N:
                    s_e[i] = E[i, l, col]
                (a if w < N else b)[i, l, lanes[inside]] = x[inside]
            if l == 0:
                break
            for w in range(2 * N):              # phase 2: warp w
                i = w % N
                if w < N:
                    cr = gp[i, :, l][:, col]
                    acc = cr[0] * s_x[0]
                    for k in range(1, N):
                        acc = acc + cr[k] * s_x[k]
                    s_up[i] = acc
                else:
                    cr = gm[i, :, l][:, col]
                    acc = (cr[0] * s_e[0]) * s_x[N]
                    for k in range(1, N):
                        acc = acc + (cr[k] * s_e[k]) * s_x[N + k]
                    s_dn[i] = acc
    return a, b


# B = 45: one whole tile, then a partial one (13 of 32 lanes inside)
L_ROWS, B_ROWS = 5, 45


def _rows_inputs(nstr: int, seed: int):
    """gp, gm, E and the plain forward's P, g on ``_layer_inputs``: float32
    tensors, (L, B) = (5, 45)."""
    ins, ang = _layer_inputs(nstr, L=L_ROWS, B=B_ROWS, seed=seed)
    P, g = K.bvp_forward_plain(*ins, ang)
    return (ins[0], ins[1], ins[2], P, g), ang


NSTR_WIDE = tuple(range(18, 33, 2))


@pytest.mark.parametrize("nstr", NSTR_WIDE)
def test_rows_backward_is_the_thread_backward(nstr):
    """Warp by warp, through the shared-memory exchange, with the last
    tile partial and N odd or even, the rows model gives the per-thread
    steps' float32 bits."""
    xs, ang = _rows_inputs(nstr, seed=400 + nstr)
    arrs = [x.numpy() for x in xs]
    got = rows_backward(*arrs)
    N, L, B = arrs[0].shape[0], L_ROWS, B_ROWS
    zero = np.zeros((N, L, B), F32)
    want = thread_backward(*arrs, zero, zero, None, flux=False)
    for w, x in zip(want, got):
        np.testing.assert_array_equal(x, w)


@pytest.mark.parametrize("nstr", NSTR_WIDE)
def test_rows_backward_is_within_the_bvp_bound(nstr):
    """The rows model against ``bvp_backward_plain`` in float32 and
    float64: |err| <= 3e-5 max|ref| + 3e-4 |ref| per output
    (``tests/test_pallas_kernels.py:103``)."""
    xs, ang = _rows_inputs(nstr, seed=500 + nstr)
    got = rows_backward(*(x.numpy() for x in xs))
    for dtype in (torch.float32, torch.float64):
        want = K.bvp_backward_plain(*(x.to(dtype) for x in xs), ang)
        for w, x in zip(want, got):
            w = w.numpy()
            assert np.isfinite(x).all()
            np.testing.assert_allclose(x, w, rtol=3e-4,
                                       atol=3e-5 * np.abs(w).max())
