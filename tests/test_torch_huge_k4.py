"""A float32 numpy model of K4's body at N = 33..64
(``csrc/stage1_general_huge.cu``), held to the bits of ``jacobi._rotate``
and of the plain ``kernels.stage1_general_plain``.

The body is the body of N = 17..32 (``tests/test_torch_big_k4.py``) with
two rows a lane: lane t owns rows t and t + 32 (columns t and t + 32 where
a step goes by columns), and every step runs over the lane's rows in
turn, each entry's operations as before; the Cholesky keeps each row's
pending pivot in the pivot vector.  The sweeps are ``sweeps_rows<2>`` of
``csrc/general_huge.cuh``: at a fixed p the lane carries a_rp, y_rp and
the diagonal of both its rows; a rotation loads its slots (r, q) and y_rq
right after the previous rotation's barrier, takes a_qq and a_pq by
shuffles (a_pq from row q + 1's new a_rp, formed first in the rotation
before), updates y_r,q-1 of the rotation before beside its own (the first
rotation of a p loop after the identity), and forms every row's new a_rp
and a_rq by selects (the huge body's rows that update no slot store into
X's column n, which the sweeps never read and the model leaves out).
``rows_sweeps`` models that schedule lane by lane,
the 32 lanes and R registers as arrays, each load taken when the kernel
issues it; ``test_huge_sweeps_are_jacobi_rotate`` holds it to
``jacobi.jacobi_eigh`` over whole sweeps, and
``test_huge_body_is_the_plain_k4`` runs the big body's model with these
sweeps at nstr 66, 96 and 128.  ``tests/test_torch_global_k4.py`` runs
``rows_sweeps`` at R = 3..5, as the body of N > 64 runs ``sweeps_rows``.
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


def rows_sweeps(A0, n: int, sweeps: int, R: int = ROWS):
    """``sweeps_rows<R>``'s sweeps on the symmetric ``(n, n, E)`` matrix
    ``A0`` (n <= 32 R): ``(X, Y)``, X holding A's lower triangle (its upper
    triangle untouched, here zero) and Y the eigenvectors by rows.
    ``arp[h]``, ``yrp[h]``, ``dq[h]``, ``dg[h]`` and ``vp[h]`` are the
    registers of row t + 32 h on lane t, ``(32, E)``; a shuffle from lane
    l of register h is ``pick(x, h)[l]``."""
    E = A0.shape[-1]
    X = np.zeros((n, n, E), F32)
    for i in range(n):
        X[i, :i + 1] = A0[i, :i + 1]
    Y = np.zeros((n, n, E), F32)
    for i in range(n):
        Y[i, i] = 1.0
    t = np.arange(LANES)
    rows = [t + LANES * h for h in range(R)]
    live = [r < n for r in rows]
    rc = [np.minimum(r, n - 1) for r in rows]           # clipped indices
    zero = np.zeros((LANES, E), F32)

    def slot(r, c):
        return np.maximum(r, c), np.minimum(r, c)

    def pick(x, h):
        return x[h] if h < R else x[0]

    for _ in range(sweeps):
        for p in range(n - 1):
            arp, yrp, dq, dg, vp = [], [], [], [], []
            for h in range(R):
                r, ok = rc[h], live[h][:, None]
                arp.append(np.where(ok & (rows[h] != p)[:, None],
                                    X[slot(r, p)], zero))
                yrp.append(np.where(ok, Y[r, p], zero))
                dg.append(np.where(ok, X[r, r], zero))
                dq.append(zero.copy())
                vp.append(zero.copy())
            app = X[p, p].copy()
            apq = pick(arp, (p + 1) // LANES)[(p + 1) % LANES].copy()
            cp, sp = np.ones(E, F32), np.zeros(E, F32)    # the identity
            for q in range(p + 1, n):
                # the loads after the barrier, then a_qq's shuffle
                arq = [np.where(live[h][:, None], X[slot(rc[h], q)], zero)
                       for h in range(R)]
                vrq = [np.where(live[h][:, None], Y[rc[h], q], zero)
                       for h in range(R)]
                aqq = pick(dg, q // LANES)[q % LANES].copy()
                for h in range(R):           # the previous rotation's y_rq
                    r, ok = rc[h], live[h]
                    y = yrp[h]
                    Y[r[ok], q - 1] = (sp * y + cp * vp[h])[ok]
                    yrp[h] = cp * y - sp * vp[h]
                with np.errstate(over="ignore"):   # tau^2 past float32
                    c, s, new_pp, new_qq = rotation_scalars(app, apq, aqq)
                nrp = [c * arp[h] - s * arq[h] for h in range(R)]
                nrq = [s * arp[h] + c * arq[h] for h in range(R)]
                apq_next = pick(nrp, (q + 1) // LANES)[(q + 1) % LANES].copy()
                for h in range(R):
                    gen = live[h] & (rows[h] != p) & (rows[h] != q)
                    hi, lo = slot(rc[h], q)
                    X[hi[gen], lo[gen]] = nrq[h][gen]
                    isq = (rows[h] == q)[:, None]
                    arp[h] = np.where(gen[:, None], nrp[h],
                                      np.where(isq, zero, arp[h]))
                    dq[h] = np.where(isq, new_qq, dq[h])
                    vp[h] = vrq[h]
                cp, sp, app, apq = c, s, new_pp, apq_next
            for h in range(R):                # the last y_rq, column p
                y = yrp[h]
                ylast = sp * y + cp * vp[h]
                yrp[h] = cp * y - sp * vp[h]
                for lane in range(LANES):
                    r = rows[h][lane]
                    if r >= n:
                        continue
                    Y[r, n - 1] = ylast[lane]
                    if r == p:
                        X[p, p] = app
                    else:
                        X[max(r, p), min(r, p)] = arp[h][lane]
                    if r > p:
                        X[r, r] = dq[h][lane]
                    Y[r, p] = yrp[h][lane]
    return X, Y


def huge_sweeps(A0, n: int, sweeps: int):
    """The huge body's sweeps: :func:`rows_sweeps` with two rows a lane."""
    return rows_sweeps(A0, n, sweeps, ROWS)


@pytest.mark.parametrize("n", [33, 48, 64])
def test_huge_sweeps_are_jacobi_rotate(n):
    """Eight modelled sweeps, two rows a lane, each rotation's slots loaded
    ahead of it, a_pq and a_qq by shuffles, the y updates a rotation late,
    give ``jacobi_eigh``'s bits (its ``_rotate`` in the cyclic order) on
    drawn symmetric float32 matrices with a repeated diagonal entry and
    zero off-diagonal ones across the two row sets."""
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
