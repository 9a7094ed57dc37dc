"""Batched symmetric eigendecomposition by cyclic Jacobi rotations (PyTorch
port of ``pyharp_tpu/rt/disort/jacobi.py``).

The matrix and its eigenvectors are one ``(n, 2n, *batch)`` tensor, held
transposed; a rotation updates their columns p and q, and the matrix's
rows p and q, for all rows in one tensor operation each.  The rotation
formulas and the cyclic (p, q) order are the JAX package's, so the same
number of sweeps gives the same eigenvalue (mode) order.  On the card the
sweeps replay a CUDA graph of one sweep above ``GRAPH_MIN_N``: the same
kernels, without the host's cost of issuing them.
"""

from __future__ import annotations

import torch
from torch import Tensor


def _rotate(T: Tensor, n: int, p: int, q: int) -> None:
    """One batched Jacobi rotation zeroing A[p, q], in place on ``T`` =
    ``[A, V]`` transposed, ``(n, 2n, *batch)``: ``T[c]`` holds column c of A
    (entries 0..n-1) and of V (n..2n-1), so the columns p and q a rotation
    changes are two contiguous rows of ``T`` for every row of A and V at
    once.

    A is symmetric and stays so.  Every element goes through the operations
    of the rotation one row at a time in its order, so the bits are those
    of a loop over the rows."""
    apq = T[q, p]
    app = T[p, p]
    aqq = T[q, q]

    small = apq.abs() <= torch.finfo(apq.dtype).tiny * 1e3
    denom = torch.where(small, 1.0, 2.0 * apq)
    tau = (aqq - app) / denom
    root = torch.sqrt(1.0 + tau * tau)
    sg = torch.sign(tau)
    t = sg / (tau.abs() + root)
    # where sign(tau) is 0, tau is +-0, root is 1 and the JAX package's
    # 1 / (tau + root) is 1
    t = torch.where(sg == 0, 1.0, t)
    t = torch.where(small, 0.0, t)
    c = torch.reciprocal(torch.sqrt(1.0 + t * t))
    s = t * c

    # A <- J^T A J restricted to rows/cols p, q: columns p and q of A and of
    # V for every row, A's entries p and q of them then set to the new
    # diagonal and zeros, and written over A's rows p and q too
    cc, ss, sc2 = c * c, s * s, 2.0 * s * c
    new_pp = cc * app - sc2 * apq + ss * aqq
    new_qq = ss * app + sc2 * apq + cc * aqq
    yp = c * T[p] - s * T[q]
    yq = s * T[p] + c * T[q]
    yp[p] = new_pp
    yp[q] = 0.0
    yq[p] = 0.0
    yq[q] = new_qq
    T[p] = yp
    T[q] = yq
    T[:n, p] = yp[:n]
    T[:n, q] = yq[:n]


def _sweep(T: Tensor, n: int) -> None:
    """One cyclic sweep: the rotations (p, q), p < q, in row order."""
    for p in range(n - 1):
        for q in range(p + 1, n):
            _rotate(T, n, p, q)


# n above which the sweeps of CUDA tensors replay a CUDA graph of one sweep
GRAPH_MIN_N = 16


def _sweeps_graphed(T: Tensor, n: int, sweeps: int) -> None:
    """``sweeps`` sweeps on the CUDA tensor ``T`` by replaying a CUDA graph
    of one sweep captured on ``T`` in place (a rotation on a copy first
    loads every kernel a rotation launches, outside the capture).  A replay
    launches the same kernels on the same memory as the sweep it recorded,
    so the bits are those of sweeping ``sweeps`` times; it saves the host's
    cost of issuing n (n - 1) / 2 rotations of some 45 launches each, which
    bounds the plain version on the card (at n = 128 a sweep is 8,128
    rotations)."""
    with torch.cuda.device(T.device):
        _rotate(T.clone(), n, 0, 1)
        g = torch.cuda.CUDAGraph()
        with torch.cuda.graph(g, capture_error_mode="thread_local"):
            _sweep(T, n)
        for _ in range(sweeps):
            g.replay()
        del g


def default_sweeps(n: int) -> int:
    """``jacobi_eigh``'s default: enough sweeps for n <= 8 in float64."""
    return 6 if n <= 2 else (10 if n <= 4 else 14)


def jacobi_eigh(A: Tensor, sweeps: int | None = None):
    """Eigendecomposition of a batch of symmetric matrices.

    Args:
      A: ``(n, n, *batch)``, symmetric in the leading two dims (only the
        symmetric part is used).
      sweeps: full cyclic sweeps; default :func:`default_sweeps`.

    Returns:
      ``(w, V)``: ``w`` ``(n, *batch)`` and ``V`` ``(n, n, *batch)`` (index
      1 enumerates eigenvectors), ``A ~= sum_k w_k V[:,k] V[:,k]^T``.
      Eigenvalues are unsorted.
    """
    n = A.shape[0]
    if sweeps is None:
        sweeps = default_sweeps(n)
    eye = torch.eye(n, dtype=A.dtype, device=A.device)
    eye = eye.reshape(n, n, *(1,) * (A.dim() - 2)).expand(A.shape)
    # [A, V] transposed; both start symmetric, so as they are
    T = torch.cat([0.5 * (A + A.transpose(0, 1)), eye], dim=1)
    if T.is_cuda and n > GRAPH_MIN_N and sweeps > 1:
        _sweeps_graphed(T, n, sweeps)
    else:
        for _ in range(sweeps):
            _sweep(T, n)
    w = torch.diagonal(T[:, :n], dim1=0, dim2=1).movedim(-1, 0).contiguous()
    return w, T[:, n:].transpose(0, 1).contiguous()
