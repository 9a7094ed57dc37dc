"""K1 at N = 9..16 (nstr 18..32): the plain version of
``csrc/stage1_isotropic_wide.cu``, whose secular roots are taken relative to
their nearer pole, against float64 and against the JAX package's Pallas K1.

The JAX package's K1 (``pallas_kernels.py:242-300``), and with it the port's
K1 at N <= 8, finds the roots by a fixed schedule in x = lam^2; in float32
that is NaN from nstr 22 on (the top root sits under float32's spacing
from its pole, ``tests/wide_secular_report.py`` prints it).  The port's K1
at N > 8 is held here:

* against its own float64 plain version, at every N = 9..16 and at N =
  17, 24, 32, 33, 48, 64, on
  ``test_torch_kernels._stage1_inputs(6, 64, seed 0)`` (ssa = 0 and
  0.999999 entries included): finite, gp and gm within 2e-4 of their max,
  lam within 2e-6 relative (N 2^-24 above N = 32, 3.8e-6 at N = 64)
  everywhere but the ssa = 0.999999 element,
  where float32's rounding of ssa alone moves the smallest root by ~1%
  (the bounds the fixed schedule meets at nstr 16 on the same inputs);
  the beam variant's particular against float64 run with float32's
  resonance floor, 1e-4 of max|ref| on the columns with no layer within
  1e-3 of a beam resonance and 1e-3 on the others (``chip_smoke.py``'s
  rule; above N = 32 scaled as lam's bound, 1.9e-3 at N = 64);
* against the JAX Pallas K1 in interpret mode at nstr 18 and 20, where the
  fixed schedule is still finite, as ``tests/test_torch_kernels.py`` holds
  nstr 4 and 8: 3e-5 of max|ref| away from ssa = 0.999999, and at that
  edge both float32 results within 3e-4 of JAX's float64 answer; on the
  elements where JAX's schedule leaves a root short of the eigenvalue
  (numpy's, which the port's float64 K1 meets to 1e-12), both against the
  exact answer.
"""

from __future__ import annotations

from unittest import mock

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pyharp_tpu_torch.rt.disort import kernels as K
from pyharp_tpu_torch.rt.disort import solver as S
from pyharp_tpu_torch.rt.disort.solver import make_static_angles

from .test_torch_kernels import NEAR_CONSERVATIVE, _jax_stage1, _stage1_inputs

NSTR_WIDE = tuple(range(18, 33, 2))
NAMES = ("gp", "gm", "lam", "expd", "y0p", "y0m", "y1", "zp", "zm")


def _beam_inputs(B: int, L: int):
    rng = np.random.default_rng(1)
    fbeam = rng.uniform(0.5, 4.0, B)
    mur = np.broadcast_to(rng.uniform(0.1, 1.0, B), (L, B)).copy()
    return fbeam, mur


def _plain_beam(ins, fbeam, mur, nstr, dtype):
    t = lambda x: torch.tensor(x, dtype=dtype)
    return K.stage1_isotropic_beam(*(t(x) for x in ins), t(fbeam), t(mur),
                                   make_static_angles(nstr, nstr, 0))


# and the bodies of N = 17..32 (csrc/stage1_isotropic_big.cu) and of
# N = 33..64 (csrc/stage1_isotropic_huge.cu), whose plain version is the
# same
NSTR_BIG = (34, 48, 64)
NSTR_HUGE = (66, 96, 128)


@pytest.mark.parametrize("nstr", NSTR_WIDE + NSTR_BIG + NSTR_HUGE)
def test_wide_k1_float32_is_near_float64(nstr):
    ins = _stage1_inputs(6, 64, seed=0)
    fbeam, mur = _beam_inputs(64, 6)
    got = _plain_beam(ins, fbeam, mur, nstr, torch.float32)
    want = _plain_beam(ins, fbeam, mur, nstr, torch.float64)
    eps = S.beam_resonance_eps(torch.float32)
    with mock.patch.object(S, "beam_resonance_eps", lambda dtype: eps):
        want_floor = _plain_beam(ins, fbeam, mur, nstr, torch.float64)
    edge = ins[0] == NEAR_CONSERVATIVE
    assert edge.any() and (ins[0] == 0.0).any()
    for name, g in zip(NAMES, got):
        assert bool(torch.isfinite(g).all()), name
    thermal = K.stage1_isotropic(*(torch.tensor(x, dtype=torch.float32)
                                   for x in ins),
                                 make_static_angles(nstr, nstr, 0))
    for name, g, t in zip(NAMES, got, thermal):
        assert torch.equal(g, t), name     # one eigenstructure, two variants
    for i in (0, 1):
        err = (got[i].double() - want[i]).abs().max() / want[i].abs().max()
        assert err <= 2e-4, (NAMES[i], float(err))
    rel = ((got[2].double() - want[2]).abs() / want[2]).numpy()
    # 2e-6 up to N = 32; above, N float32 half-ulps (the secular sums' N
    # terms, each rounded): at nstr 128 the smallest root of ssa 0.93-0.95
    # reads 2.5-2.7e-6 from float64 with float32-rounded inputs too
    tol = max(2e-6, nstr // 2 * 2.0 ** -24)
    assert rel[:, ~edge].max() <= tol, rel[:, ~edge].max()
    lam2 = want[2] ** 2
    inv = 1.0 / torch.tensor(mur) ** 2
    near = (((lam2 - inv).abs() / (lam2 + inv)) < 1e-3).any(dim=0)
    for i in (7, 8):
        w = want_floor[i]
        err = (got[i].double() - w).abs() / w.abs().max()
        assert err[..., ~near].max() <= 1e-4, (NAMES[i], float(err.max()))
        # near a resonance the clamped denominator magnifies the roots'
        # error, so that bound grows with the roots' (zp 1.26e-3 at nstr
        # 128)
        assert err.max() <= 1e-3 * tol / 2e-6, (NAMES[i], float(err.max()))


def _exact_lam(ssa, ang):
    """lam from numpy's eigenvalues of diag(d) - ssa 1 c^T, whose
    eigenvalues x solve 1 - ssa sum_i c_i / (d_i - x) = 0: ``(N, L, B)``."""
    mu, w = np.asarray(ang.mu), np.asarray(ang.w)
    d, c = 1.0 / mu**2, w / mu**2
    L, B = ssa.shape
    out = np.empty((mu.size, L, B))
    for l in range(L):
        for b in range(B):
            M = np.diag(d) - ssa[l, b] * np.outer(np.ones_like(d), c)
            out[:, l, b] = np.sqrt(np.maximum(np.sort(np.linalg.eigvals(M).real),
                                              0.0))
    return out


@pytest.fixture(scope="module", params=[18, 20])
def jax_k1(request):
    nstr = request.param
    ins = _stage1_inputs(6, 16, seed=nstr)
    ang = make_static_angles(nstr, nstr, 0)
    exact = K.stage1_isotropic(*(torch.tensor(x) for x in ins), ang)
    return (nstr, ins, ang, [x.numpy() for x in exact],
            _jax_stage1(*ins, nstr, jnp.float32),
            _jax_stage1(*ins, nstr, jnp.float64))


def test_wide_k1_float64_is_exact(jax_k1):
    """The port's float64 K1 at nstr 18 and 20 gives numpy's eigenvalues to
    1e-12 of the largest: the reference the float32 results are held to."""
    nstr, ins, ang, exact, _, _ = jax_k1
    want = _exact_lam(ins[0], ang)
    got = np.sort(exact[2], axis=0)
    assert np.abs(got - want).max() <= 1e-12 * want.max()


def test_wide_k1_matches_pallas(jax_k1):
    """The port's float32 K1 against JAX's Pallas K1, as
    ``tests/test_torch_kernels.py`` holds nstr 4 and 8 (3e-5 of max|ref|
    away from ssa = 0.999999; at that edge both within 3e-4 of float64),
    on the elements where JAX's fixed schedule has converged: there its
    float64 roots are within 1e-9 of the exact ones.  At nstr 18 it has
    not on some (12 bisections and two Newton steps leave the top root
    ~3e-6 of the largest lam from the eigenvalue, in float64 as in float32:
    a condition of the reference algorithm, ROADMAP section 3); there JAX's
    float32 is held to 1e-4 of max|ref| from the exact answer and the
    port's to 3e-5."""
    nstr, ins, ang, exact, want32, want64 = jax_k1
    got = [x.numpy() for x in K.stage1_isotropic(
        *(torch.tensor(x, dtype=torch.float32) for x in ins), ang)]
    edge = ins[0] == NEAR_CONSERVATIVE
    lam_off = np.abs(want64[2] - exact[2]).max(axis=0) / exact[2].max()
    late = lam_off > 1e-9                  # JAX's schedule left a root short
    assert not late[edge].any()
    for name, g, w32, w64, x in zip(NAMES, got, want32, want64, exact):
        assert g.shape == w32.shape, name
        assert np.isfinite(g).all(), name
        scale = np.abs(w32).max()
        err = np.abs(g - w32)[..., ~edge & ~late]
        assert err.max() <= 3e-5 * scale, (name, err.max() / scale)
        for f32, tol in ((g, 3e-5), (w32, 1e-4)):
            if late.any():
                e = np.abs(f32 - x)[..., late].max()
                assert e <= tol * scale, (name, e / scale)
            assert np.abs(f32 - w64)[..., edge].max() <= 3e-4 * scale, name
    if nstr == 18:
        assert late.any()   # the condition the port repairs shows here
