"""A float32 numpy model of K4's body at N = 33..64
(``csrc/stage1_general_huge.cu``), held to the bits of ``jacobi._rotate``
and of the plain ``kernels.stage1_general_plain``.

The body is the body of N = 17..32 (``tests/test_torch_big_k4.py``) with
two rows a lane: lane t owns rows t and t + 32 (columns t and t + 32 where
a step goes by columns), and every step runs over the lane's rows in
turn, each entry's operations as before; the Cholesky keeps each row's
pending pivot in the pivot vector.  In the sweeps the lane carries a_rp
and y_rp of both its rows through the q loop; a_pq is row q's register on
lane q mod 32, shuffled; a rotation's row updates touch one slot (r, q) a
row, so the two rows of a lane never meet.  ``huge_sweeps`` models that
lane by lane, the 32 lanes and two registers as arrays;
``test_huge_sweeps_are_jacobi_rotate`` holds it to ``jacobi.jacobi_eigh``
over whole sweeps, and ``test_huge_body_is_the_plain_k4`` runs the big
body's model with these sweeps at nstr 66, 96 and 128.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

from pyharp_tpu_torch.rt.disort import jacobi
from pyharp_tpu_torch.rt.disort import kernels as K
from pyharp_tpu_torch.rt.disort.legendre import lepoly
from pyharp_tpu_torch.rt.disort.solver import make_static_angles

from . import test_torch_big_k4 as big
from .test_torch_wide_k4_team import _inputs, rotation_scalars

F32 = np.float32
LANES = 32
ROWS = 2                                     # rows t and t + 32 a lane


@pytest.fixture(autouse=True)
def one_thread():
    """One intra-op thread: the tensors here are mid-sized, and with
    several test processes on the machine their threads contend."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def huge_sweeps(A0, n: int, sweeps: int):
    """The body's sweeps on the symmetric ``(n, n, E)`` matrix ``A0``:
    ``(X, Y)``, X holding A's lower triangle (its upper triangle untouched,
    here zero) and Y the eigenvectors by rows.  ``arp[h]``, ``yrp[h]`` and
    ``dq[h]`` are the registers of row t + 32 h on lane t, ``(32, E)``."""
    E = A0.shape[-1]
    X = np.zeros((n, n, E), F32)
    for i in range(n):
        X[i, :i + 1] = A0[i, :i + 1]
    Y = np.zeros((n, n, E), F32)
    for i in range(n):
        Y[i, i] = 1.0
    t = np.arange(LANES)
    rows = [t + LANES * h for h in range(ROWS)]
    valid = [r < n for r in rows]
    rc = [np.minimum(r, n - 1) for r in rows]           # clipped indices
    zero = np.zeros((LANES, E), F32)
    for _ in range(sweeps):
        for p in range(n - 1):
            app = X[p, p].copy()
            arp, yrp, dq = [], [], []
            for h in range(ROWS):
                r = rc[h]
                a = np.where((r > p)[:, None], X[r, p],
                             X[p, np.minimum(r, p)])
                arp.append(np.where((valid[h] & (rows[h] != p))[:, None], a,
                                    zero))
                yrp.append(np.where(valid[h][:, None], Y[r, p], zero))
                dq.append(zero.copy())
            for q in range(p + 1, n):
                apq = arp[q // LANES][q % LANES].copy()    # shuffled
                aqq = X[q, q].copy()
                with np.errstate(over="ignore"):   # tau^2 past float32
                    c, s, new_pp, new_qq = rotation_scalars(app, apq, aqq)
                for h in range(ROWS):
                    r, ok = rc[h], valid[h]
                    gen = ok & (rows[h] != p) & (rows[h] != q)
                    hi, lo = np.maximum(r, q), np.minimum(r, q)
                    arq = X[hi, lo]
                    nrp = c * arp[h] - s * arq
                    nrq = s * arp[h] + c * arq
                    X[hi[gen], lo[gen]] = nrq[gen]
                    isq = ok & (rows[h] == q)
                    arp[h] = np.where(gen[:, None], nrp,
                                      np.where(isq[:, None], zero, arp[h]))
                    dq[h] = np.where(isq[:, None], new_qq, dq[h])
                    vrq = Y[r, q]
                    Y[r[ok], q] = (s * yrp[h] + c * vrq)[ok]
                    yrp[h] = np.where(ok[:, None], c * yrp[h] - s * vrq,
                                      yrp[h])
                app = new_pp
            for h in range(ROWS):                     # column p, once
                for lane in range(LANES):
                    r = rows[h][lane]
                    if r >= n:
                        continue
                    if r == p:
                        X[p, p] = app
                    else:
                        X[max(r, p), min(r, p)] = arp[h][lane]
                    if r > p:
                        X[r, r] = dq[h][lane]
                    Y[r, p] = yrp[h][lane]
    return X, Y


@pytest.mark.parametrize("n", [33, 48, 64])
def test_huge_sweeps_are_jacobi_rotate(n):
    """Eight modelled sweeps, two rows a lane, pivots carried by register
    and shuffle, give ``jacobi_eigh``'s bits (its ``_rotate`` in the cyclic
    order) on drawn symmetric float32 matrices with a repeated diagonal
    entry and zero off-diagonal ones across the two row sets."""
    rng = np.random.default_rng(n)
    E = 2
    M = rng.standard_normal((n, n, E)).astype(F32)
    M = (M + M.transpose(1, 0, 2)) * F32(0.5)
    M[3, 3] = M[n - 1, n - 1]
    M[2, 7] = M[7, 2] = 0.0
    M[5, 40 % n] = M[40 % n, 5] = 0.0
    X, Y = huge_sweeps(M, n, 8)
    w, V = jacobi.jacobi_eigh(torch.from_numpy(M), 8)
    np.testing.assert_array_equal(np.stack([X[k, k] for k in range(n)]),
                                  w.numpy())
    np.testing.assert_array_equal(Y, V.numpy())


@pytest.mark.parametrize("nstr, case", [
    (66, "m0_thermal_beam"), (96, "m1_beam"), (128, "m0_thermal"),
    (128, "m63_beam")])
def test_huge_body_is_the_plain_k4(nstr, case, monkeypatch):
    """The modelled body, two rows a lane in the sweeps, gives
    ``stage1_general_plain``'s float32 bits at nstr 66, 96 and 128
    (N = 33, 48, 64) on L = 1 x B = 2 elements: m = 0 with a thermal
    source, with and without a beam, m = 1 with a beam, and at nstr 128
    m = 63 with a beam, where entries of the phase tables underflow to
    zero in float32."""
    monkeypatch.setattr(big, "big_sweeps", huge_sweeps)
    m = {"m1_beam": 1, "m63_beam": 63}.get(case, 0)
    ssa, pmom, dtau, btop, slope, fbeam, mur, mu0 = _inputs(nstr, 1, 2,
                                                            nstr + m)
    ang = make_static_angles(nstr, nstr, m)
    thermal = case.startswith("m0_thermal")
    kw = dict(thermal=thermal)
    if case != "m0_thermal":
        lam0 = lepoly(mu0, m, ang.lam_tables.shape[0] - 1).contiguous()
        kw.update(fbeam=fbeam, mur=mur, lam0=lam0)
    want = K.stage1_general_plain(ssa, pmom, dtau, btop, slope, ang, **kw)
    npk = {k: (v.numpy() if isinstance(v, torch.Tensor) else v)
           for k, v in kw.items()}
    got = big.k4_big(ssa.numpy(), pmom.numpy(), dtau.numpy(), btop.numpy(),
                     slope.numpy(), ang, **npk)
    assert len(got) == len(want)
    for idx, (x, w) in enumerate(zip(got, want)):
        assert np.isfinite(x).all(), f"output {idx}"
        np.testing.assert_array_equal(x, w.numpy(), err_msg=f"output {idx}")
