"""A float32 numpy model of K1's body at N = 33..64
(``csrc/stage1_isotropic_huge.cu``, ``stage1_isotropic_huge_kernel``),
held to the bits of the plain versions ``kernels.stage1_isotropic_plain``
and ``stage1_isotropic_beam_plain``.

The body gives each (layer, column) element a warp; lane k finds roots k
and k + 32 in turn, each as the body of N = 17..32 finds its one root
(``tests/test_torch_big_k1.py``'s ``root``), every sum over kM = 64 terms,
the table padded past N (c, 1/mu^2, 1/mu and w 0, differences 2^30),
the pole's term s / s, each quotient correctly rounded where s (tau in
Newton's sums) lies in [2^-60, 2^60] and the sum taken again over i < N
with ``/`` and the pole's select where it does not.  The model is that
module's, its term count set to 64 for each test here.

With the beam, S = gp + gm and a copy with the right-hand side
qs / mu_i^2 in column N sit in the element's shared memory; big.cuh's warp
LU (``tests/test_torch_big_bvp.py``'s ``warp_lu_solve``: the bubble's
swaps record by record, each row below the pivot on its lane, back
substitution dividing by the pivot) solves the copy.  Lane k forms the
clamped denominators of modes k and k + 32, lane i zs_i = S scaled for
rows i and i + 32 from the unfactored S, and every lane w . zs in the
plain order.
"""

from __future__ import annotations

from collections import Counter

import numpy as np
import pytest
import torch

from pyharp_tpu_torch.rt.disort import kernels as K
from pyharp_tpu_torch.rt.disort.solver import make_static_angles

from . import test_torch_big_k1 as big
from .test_torch_big_bvp import warp_lu_solve
from .test_torch_wide_k1_team import (HI, LO, TWO_KAPPA, _inputs, exp32,
                                      same_bits)

F32 = np.float32
M = 64                                       # terms of every sum


@pytest.fixture(autouse=True)
def huge_terms(monkeypatch):
    """The big body's model with 64 terms a sum, on one intra-op thread."""
    monkeypatch.setattr(big, "M", M)
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def k1_huge(ssa, dtau, btop, slope, ang, fbeam=None, mur=None, stats=None):
    """The body's outputs, ``(gp, gm, lam, expd, y0p, y0m, y1[, zp, zm])``
    in the plain version's shapes; ``stats`` tallies the sums that took
    the fast path and the fallback."""
    n = ang.mu.shape[0]
    L, B = ssa.shape
    E = L * B
    tb = big.tables(ang)
    ssa_e = ssa.reshape(E)
    gp = np.zeros((n, n, E), F32)
    gm = np.zeros((n, n, E), F32)
    lam = np.zeros((n, E), F32)
    xs = np.zeros((n, E), F32)
    for t in range(32):                        # lane t: roots t, t + 32
        for k in (t, t + 32):
            if k < n:
                xs[k], lam[k], gp[:, k], gm[:, k] = big.root(k, n, ssa_e, tb,
                                                             stats)
    expd = exp32(-lam * dtau.reshape(E))
    mu = tb["mu"]
    sl, bt = slope.reshape(E), btop.reshape(E)
    y1 = np.stack([sl] * n)
    y0p = np.stack([bt + mu[i] * sl for i in range(n)])
    y0m = np.stack([bt - mu[i] * sl for i in range(n)])
    out = [gp, gm, lam, expd, y0p, y0m, y1]
    if fbeam is not None:
        murf = mur.reshape(E)
        qs = TWO_KAPPA * (ssa_e * np.tile(fbeam, L))
        S = gp + gm
        A = np.concatenate([S, np.stack([qs * tb["d"][i]
                                         for i in range(n)])[:, None]], axis=1)
        for e in range(E):                     # the warp LU, an element each
            sys_ = np.ascontiguousarray(A[..., e])
            warp_lu_solve(sys_, n, 1)
            A[..., e] = sys_
        cc = A[:, n]
        inv_mur2 = F32(1.0) / (murf * murf)
        scaled = np.zeros((n, E), F32)
        for k in range(n):                     # lane k % 32
            lam2k = np.where(xs[k] < F32(1e-12), F32(1e-12), xs[k])
            den = lam2k - inv_mur2
            fl = F32(1e-4) * (lam2k + inv_mur2)
            den = np.where(np.abs(den) < fl, np.where(den < 0.0, -fl, fl),
                           den)
            scaled[k] = cc[k] / den
        zs = np.zeros((n, E), F32)
        for i in range(n):                     # lane i % 32
            acc = S[i, 0] * scaled[0]
            for k in range(1, n):
                acc = acc + S[i, k] * scaled[k]
            zs[i] = acc
        wz = tb["w"][0] * zs[0]
        for i in range(1, n):
            wz = wz + tb["w"][i] * zs[i]
        zp, zm = [], []
        for i in range(n):
            uz = zs[i] - ssa_e * wz
            zd = -murf * (uz - qs) * tb["invmu"][i]
            zp.append(F32(0.5) * (zs[i] + zd))
            zm.append(F32(0.5) * (zs[i] - zd))
        out += [np.stack(zp), np.stack(zm)]
    return tuple(x.reshape(*x.shape[:-1], L, B) for x in out)


@pytest.mark.parametrize("nstr", range(66, 129, 2))
def test_table_keeps_the_divisors_in_range(nstr):
    """The body checks s (tau in Newton's sums) and no divisor: for every
    root k and either origin, every divisor dlt_i - tau with i off the
    origin's pole keeps at least 2^-60 from 0 for every tau the search can
    take ([-h_k, 0] below the upper origin, [0, h_k] above the lower), the
    pole's own difference is 0 (its divisor is -tau = s), and none passes
    2^60: at N = 64 the poles reach 8.3e6 and lie 0.30% apart."""
    ang = make_static_angles(nstr, nstr, 0)
    tb = big.tables(ang)
    n = ang.mu.shape[0]
    assert tb["delta"].shape == (M + 1, M)
    for k in range(n):
        h = float(tb["half"][k])
        assert LO <= h <= 2.0 ** 30
        for row, pole, lo, hi in ((k + 1, n - 1 - k, -h, 0.0),
                                  (k, n - k, 0.0, h)):
            d = tb["delta"][row].astype(np.float64)
            if pole < n:
                assert d[pole] == 0.0, (nstr, k, row)
            off = np.arange(M) != pole
            gap = np.maximum(np.maximum(lo - d, d - hi), 0.0)[off]
            assert gap.min() >= LO, (nstr, k, row, gap.min())
            assert np.abs(d).max() + h <= HI


@pytest.mark.parametrize("nstr, beam", [(66, False), (66, True), (96, False),
                                        (128, True)])
def test_huge_body_is_the_plain_k1(nstr, beam):
    """The model's outputs are the plain version's bits at L 2 x B 4, ssa
    at 0, 1e-7 and 0.999999, one element on a beam resonance.  Both ways
    through the body's sums are taken: the bisection's first midpoints
    below 2^-60 and the roots of ssa = 0 fall back to ``/``, the others
    take the fast path."""
    ang, ssa, dtau, btop, slope, fbeam, mur = _inputs(nstr, 2, 4, nstr)
    stats = Counter()
    if beam:
        want = K.stage1_isotropic_beam_plain(ssa, dtau, btop, slope, fbeam,
                                             mur, ang)
        got = k1_huge(ssa.numpy(), dtau.numpy(), btop.numpy(), slope.numpy(),
                      ang, fbeam.numpy(), mur.numpy(), stats=stats)
    else:
        want = K.stage1_isotropic_plain(ssa, dtau, btop, slope, ang)
        got = k1_huge(ssa.numpy(), dtau.numpy(), btop.numpy(), slope.numpy(),
                      ang, stats=stats)
    assert len(got) == len(want)
    names = ("gp", "gm", "lam", "expd", "y0p", "y0m", "y1", "zp", "zm")
    bad = [nm for nm, g, w in zip(names, got, want) if not same_bits(g, w)]
    assert not bad, f"nstr {nstr}: {bad} differ from the plain version"
    assert all(np.isfinite(g).all() for g in got)
    for key in ("bisect_first", "bisect", "newton", "eigenvector"):
        assert stats[key + "_fallback"] > 0, (key, stats)
    for key in ("midpoint", "bisect", "newton", "eigenvector"):
        assert stats[key + "_fast"] > 0, (key, stats)
