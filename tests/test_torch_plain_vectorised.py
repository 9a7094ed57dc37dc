"""The plain versions' vectorised pieces against the scalarized forms they
replaced (kept here), bit for bit with ``torch.equal``:

* the Jacobi eigensolve (``pyharp_tpu_torch/rt/disort/jacobi.py``), whose
  rotation updates every row in one tensor operation, against a list of
  lists of batch-shaped tensors and a loop over the rows;
* the phase-table contraction (``solver._ucontract_g``), one tensor
  operation a term for all entries, against a sum per entry;
* K4's plain version over the azimuthal modes in one pass
  (``kernels.stage1_general_modes_plain``) against a call per mode.

Each element goes through the same operations in the same order in both,
so the eigenvalues, the eigenvectors and with them the mode order of the
stage-1 kernels' plain versions are unchanged.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

from pyharp_tpu_torch.rt.disort import jacobi
from pyharp_tpu_torch.rt.disort import kernels as K
from pyharp_tpu_torch.rt.disort import solver as S
from pyharp_tpu_torch.rt.disort.legendre import lepoly



@pytest.fixture(autouse=True)
def one_thread():
    """One intra-op thread: the tensors here are mid-sized, and with
    several test processes on the machine their threads contend."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)

def _rotate_rows_loop(A, V, p: int, q: int, n: int):
    """One rotation zeroing A[p][q] on the scalarized matrix, row by row:
    the form ``jacobi._rotate`` had before it was vectorised."""
    apq = A[p][q]
    app = A[p][p]
    aqq = A[q][q]

    small = apq.abs() <= torch.finfo(apq.dtype).tiny * 1e3
    one = torch.ones_like(apq)
    denom = torch.where(small, one, 2.0 * apq)
    tau = (aqq - app) / denom
    root = torch.sqrt(1.0 + tau * tau)
    t = torch.sign(tau) / (tau.abs() + root)
    t = torch.where(torch.sign(tau) == 0, 1.0 / (tau + root), t)
    t = torch.where(small, torch.zeros_like(t), t)
    c = 1.0 / torch.sqrt(1.0 + t * t)
    s = t * c

    new_pp = c * c * app - 2.0 * s * c * apq + s * s * aqq
    new_qq = s * s * app + 2.0 * s * c * apq + c * c * aqq
    for r in range(n):
        if r == p or r == q:
            continue
        arp = A[r][p]
        arq = A[r][q]
        nrp = c * arp - s * arq
        nrq = s * arp + c * arq
        A[r][p] = nrp
        A[p][r] = nrp
        A[r][q] = nrq
        A[q][r] = nrq
    A[p][p] = new_pp
    A[q][q] = new_qq
    zero = torch.zeros_like(apq)
    A[p][q] = zero
    A[q][p] = zero

    for r in range(n):
        vrp = V[r][p]
        vrq = V[r][q]
        V[r][p] = c * vrp - s * vrq
        V[r][q] = s * vrp + c * vrq


def _jacobi_loop(A, sweeps: int):
    n = A.shape[0]
    Ac = [[0.5 * (A[i, j] + A[j, i]) for j in range(n)] for i in range(n)]
    one = torch.ones_like(A[0, 0])
    zero = torch.zeros_like(A[0, 0])
    Vc = [[one if i == j else zero for j in range(n)] for i in range(n)]
    for _ in range(sweeps):
        for p in range(n - 1):
            for q in range(p + 1, n):
                _rotate_rows_loop(Ac, Vc, p, q, n)
    w = torch.stack([Ac[i][i] for i in range(n)], dim=0)
    V = torch.stack([torch.stack(row, dim=0) for row in Vc], dim=0)
    return w, V


def _matrices(n: int, dtype, seed: int):
    """A batch (3, 5) of K-like matrices: a drawn SPD part, nearly
    degenerate pairs, a zero off-diagonal row (the ``small`` branch) and a
    diagonal one (tau = 0)."""
    rng = np.random.default_rng(seed)
    B = rng.standard_normal((n, n, 3, 5))
    A = np.einsum("ik...,jk...->ij...", B, B) / n + np.eye(n)[..., None, None]
    A[:, :, 0, 1] = np.diag(np.repeat(rng.uniform(1, 2, (n + 1) // 2), 2)[:n])
    A[0, 1:, 1, 2] = A[1:, 0, 1, 2] = 0.0
    A[:, :, 2, 3] = np.eye(n) * 2.0
    return torch.tensor(A, dtype=dtype)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("n", [4, 16, 17, 32])
def test_vectorised_rotation_keeps_the_bits(n, dtype):
    A = _matrices(n, dtype, seed=n)
    # the kernels' sweep count (kernels.kernel_sweeps) but at n = 32, where
    # the row loop takes seconds a sweep: three sweeps there
    sweeps = 4 if n <= 4 else (8 if n <= 17 else 3)
    want = _jacobi_loop(A, sweeps)
    got = jacobi.jacobi_eigh(A, sweeps)
    for g, w in zip(got, want):
        assert g.shape == w.shape
        assert torch.equal(g, w)


def _contract_loop(coef, tab):
    """``solver._ucontract_g`` as a sum per table entry, the form it had
    before it was vectorised."""
    G, dims = tab.shape[0], tab.shape[1:]
    flat = []
    for idx in np.ndindex(*dims):
        acc = None
        for gidx in range(G):
            t = float(tab[(gidx,) + idx])
            if t == 0.0:
                continue
            term = coef[:, gidx, :] * t
            acc = term if acc is None else acc + term
        flat.append(torch.zeros_like(coef[:, 0, :]) if acc is None else acc)
    out = torch.stack(flat, dim=0)
    return out.reshape(tuple(dims) + tuple(out.shape[1:]))


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("nstr,m", [(8, 0), (8, 3), (34, 1), (64, 0), (64, 63)])
def test_vectorised_contraction_keeps_the_bits(nstr, m, dtype):
    """The parity tables and a table with zero columns (entries that never
    start a sum, and sums that start late), signs of zero included."""
    rng = np.random.default_rng(nstr + m)
    ang = S.make_static_angles(nstr, nstr, m)
    L, B = 3, 5
    ssa = torch.tensor(rng.uniform(0, 1, (L, B)), dtype=dtype)
    pmom = torch.tensor(rng.uniform(-1, 1, (L, nstr, B)), dtype=dtype)
    g = S._moment_coeffs(ssa, pmom, ang)
    even, odd = S._phase_outer_tables(ang)
    ragged = ang.lam_tables[:, :, None] * np.array([1.0, 0.0, -2.0])
    ragged[:m + 2, :, 2] = 0.0
    for tab in (even, odd, ragged):
        want = _contract_loop(g, tab)
        got = S._ucontract_g(g, tab)
        assert got.shape == want.shape
        assert torch.equal(got, want)
        assert torch.equal(torch.signbit(got), torch.signbit(want))


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("nstr", [8, 34])
def test_modes_in_one_pass_keep_the_bits(nstr, dtype):
    """K4's plain version over the modes m = 1..nstr-1 in one pass gives
    the outputs of a call of its own at modes 1, 2, nstr/2 and nstr - 1 (a
    beam, no thermal source)."""
    rng = np.random.default_rng(nstr)
    L, B = 2, 3
    t = lambda x: torch.tensor(x, dtype=dtype)
    ssa = t(rng.uniform(0.0, 0.99, (L, B)))
    pmom = t(0.8 ** np.arange(1, nstr + 1)[None, :, None] * np.ones((L, 1, B)))
    dtau = t(rng.uniform(0.01, 2.0, (L, B)))
    fbeam = t(rng.uniform(0.5, 4.0, B))
    mu0 = t(rng.uniform(0.1, 1.0, B))
    mur = mu0[None].expand(L, B).contiguous()
    zero = torch.zeros_like(ssa)
    angs = [S.make_static_angles(nstr, nstr, m) for m in range(1, nstr)]
    G = angs[0].lam_tables.shape[0]
    lam0s = [lepoly(mu0, a.m, G - 1).contiguous() for a in angs]
    got = K.stage1_general_modes_plain(ssa, pmom, dtau, angs, fbeam=fbeam,
                                       mur=mur, lam0s=lam0s)
    assert len(got) == nstr - 1
    for a, l0, out in zip(angs, lam0s, got):
        if a.m not in (1, 2, nstr // 2, nstr - 1):     # a call per mode
            continue                                    # takes ~1 s
        want = K.stage1_general_plain(ssa, pmom, dtau, zero, zero, a,
                                      thermal=False, fbeam=fbeam, mur=mur,
                                      lam0=l0)
        assert len(out) == len(want)
        for x, w in zip(out, want):
            assert x.shape == w.shape and torch.equal(x, w), a.m
