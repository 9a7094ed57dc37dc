"""Batched dense solve of tiny fixed-size systems (PyTorch port of
``pyharp_tpu/rt/disort/linsolve.py::lu_solve``).

The augmented system is one ``(n, ncols, *batch)`` tensor, so a column's
elimination is one tensor op over its rows.  Partial pivoting cannot
branch per batch element.  The JAX package bubbles the max-|pivot| row up
with elementwise ``where`` swaps, row r against the row at ``col``, under
the strict ``abs(r) > abs(col)`` rule.  Here each column's pivot entries
are walked once, as a running maximum (``cummax``) of the champion's |a|,
and the rows move with one gather: the row at ``col`` ends as the last
record (a row whose |a| beats, strictly, every |a| above it from ``col``
on), each record's position takes the record before it (``col``'s row for
the first), as the bubble leaves them.  The same strict ``>`` on the same
values decides each swap, so NaNs, signed zeros and ties move as in the
bubble and every output is bit for bit the bubble's, in some 20 tensor
operations a column where the bubble takes five a row.
"""

from __future__ import annotations

import math

import torch
from torch import Tensor


def lu_solve(A: Tensor, b: Tensor) -> Tensor:
    """Solve ``A x = b`` for batches of small square systems.

    Args:
      A: ``(n, n, *batch)``.
      b: ``(n, *batch)`` or ``(n, k, *batch)``.

    Returns:
      ``x`` with the shape of ``b``.
    """
    n = A.shape[0]
    vec = b.ndim == A.ndim - 1
    if vec:
        b = b[:, None]

    M = torch.cat([A, b.to(A.dtype)], dim=1)

    for col in range(n - 1):
        a = M[col:, col].abs()
        # the champion's |a| down the column: a NaN pivot is never beaten
        # (+inf), a NaN below it never beats (-inf)
        key = torch.where(a.isnan(), -math.inf, a)
        key[0] = torch.where(a[0].isnan(), math.inf, a[0])
        beat = key[1:] > key.cummax(0).values[:-1]          # the records
        rows = torch.arange(col + 1, n, device=M.device)
        rows = rows.view(-1, *(1,) * (a.dim() - 1))
        last = torch.where(beat, rows, col).cummax(0).values
        before = torch.cat([torch.full_like(last[:1], col), last[:-1]])
        idx = torch.cat([last[-1:], torch.where(beat, before, rows)]) - col
        M[col:] = torch.gather(M[col:], 0,
                               idx[:, None].expand(n - col, *M.shape[1:]))
        inv = 1.0 / M[col, col]
        f = M[col + 1:, col] * inv
        M[col + 1:] = M[col + 1:] - f[:, None] * M[col][None]

    x = [None] * n
    for row in range(n - 1, -1, -1):
        acc = M[row, n:]
        for col in range(row + 1, n):
            acc = acc - M[row, col][None] * x[col]
        x[row] = acc / M[row, row][None]

    out = torch.stack(x, dim=0)
    if vec:
        out = out[:, 0]
    return out


def cholesky_lower(A: Tensor, floor: float = 1e-30) -> Tensor:
    """Batched Cholesky of tiny SPD matrices, scalarized
    (``pyharp_tpu/rt/disort/linsolve.py:73``).

    Args:
      A: ``(n, n, *batch)`` symmetric positive definite; each pivot is
        floored at ``floor`` before its square root.

    Returns:
      ``L`` of shape ``(n, n, *batch)``, lower-triangular, ``A ~= L L^T``.
    """
    n = A.shape[0]
    Lc = [[None] * n for _ in range(n)]
    for j in range(n):
        d = A[j, j]
        for k in range(j):
            d = d - Lc[j][k] * Lc[j][k]
        d = torch.sqrt(d.clamp_min(floor))
        Lc[j][j] = d
        inv = 1.0 / d
        for i in range(j + 1, n):
            v = A[i, j]
            for k in range(j):
                v = v - Lc[i][k] * Lc[j][k]
            Lc[i][j] = v * inv
    zero = torch.zeros_like(A[0, 0])
    return torch.stack([torch.stack([Lc[i][j] if j <= i else zero
                                     for j in range(n)]) for i in range(n)])
