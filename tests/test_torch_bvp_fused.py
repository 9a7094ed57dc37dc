"""K6's plain version, ``kernels.bvp_fused_plain``, against the JAX
package's single-pass BVP kernel (``solve_bvp_fused``, interpret mode) and
its XLA solver, on the inputs ``tests/test_pallas_kernels.py:110-116``
builds (nstr 4, L = 11, B = 8).

The CUDA kernel runs only on a GPU; ``chip_smoke.py`` phase 10 holds it to
this plain version and to K2 + K3/K5 on the card.  Here the wrapper takes
CPU tensors and so runs the plain version (and launches nothing).

Tolerances:

* against ``solve_bvp_fused`` in float32, both output modes: 3e-5 of
  max|ref| per output, the bound ``tests/test_pallas_kernels.py:70`` holds
  the Pallas BVP to (the same recurrence, summed in another order);
* against ``solver.solve_bvp`` plus the wmu-weighted layer-top sums in
  float64: 1e-12 of max|ref|, the same recurrence;
* the bottom snapshot ``ab_last`` contracted to bottom-level sums against
  K3's plain ``fl_bot``, float64: 1e-12 of max|ref|.

The CUDA kernel at N <= 4 runs a segmented schedule (``csrc/bvp_fused.cu``):
the forward sweep keeps only the carry at every S-th layer boundary, and
the backward sweep recomputes each segment's P and g from its checkpoint
before back-substituting them.  ``segmented_fused`` models that schedule in
PyTorch with the plain version's layer step; it must give
``bvp_fused_plain``'s bits (``torch.equal``) for every S, the last segment
partial included.
"""

import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pyharp_tpu.rt.disort import pallas_kernels as PK
from pyharp_tpu.rt.disort import solver as JS

from pyharp_tpu_torch.rt.disort import kernels as K
from pyharp_tpu_torch.rt.disort import solver as TS

ALBEDO = 0.3


def _jax_problem(nstr, L, B, seed, dtype):
    """``tests/test_pallas_kernels.py``'s BVP problem: the stage-1
    solution and the BVP arguments of ``solve_bvp``/``solve_bvp_fused``."""
    ang = JS.make_static_angles(nstr, nstr, 0)
    rng = np.random.default_rng(seed)
    ssa = jnp.asarray(rng.uniform(0.0, 0.95, (L, B)), dtype)
    pmom = jnp.asarray(rng.uniform(-0.2, 0.8, (L, nstr, B)), dtype)
    dtau = jnp.asarray(rng.uniform(0.001, 2.0, (L, B)), dtype)
    btop = jnp.asarray(rng.uniform(0.0, 1.0, (L, B)), dtype)
    slope = jnp.asarray(rng.uniform(-0.2, 0.2, (L, B)), dtype)
    sol, V, U = JS.homogeneous_solution(ssa, pmom, dtau, ang)
    y0p, y0m, y1 = JS.thermal_particular(V, U, ssa, btop, slope, ang)
    N = nstr // 2
    args = (sol, y0p, y0m, y0p + y1 * dtau[None], y0m + y1 * dtau[None],
            jnp.zeros((N, B), dtype), jnp.ones((N, B), dtype),
            jnp.full((B,), ALBEDO, dtype), ang)
    return args


def _port_inputs(args, dtype):
    """The port's K6 inputs from the JAX problem, as CPU tensors."""
    sol, ptop_p, ptop_m, pbot_p, pbot_m, ftop, bot_rhs, albedo, ang = args
    t = lambda x: torch.tensor(np.asarray(x), dtype=dtype)  # noqa: E731
    dblk = TS.bvp_rhs(t(ptop_p), t(ptop_m), t(pbot_p), t(pbot_m), t(ftop),
                      t(bot_rhs))
    return ((t(sol.gp), t(sol.gm), t(sol.expd), dblk, t(albedo), t(ptop_p),
             t(ptop_m)), np.asarray(ang.w * ang.mu))


def _rel(got, want):
    got = got.numpy() if isinstance(got, torch.Tensor) else got
    want = np.asarray(want)
    assert got.shape == want.shape
    assert np.isfinite(got).all()
    return np.abs(got - want).max() / max(np.abs(want).max(), 1e-30)


@pytest.mark.parametrize("flux_only", [False, True])
def test_plain_matches_pallas_single_pass_f32(flux_only):
    args = _jax_problem(4, 11, 8, seed=3, dtype=jnp.float32)
    want = PK.solve_bvp_fused(*args, flux_only=flux_only, block_b=8,
                              interpret=True)
    ins, wmu = _port_inputs(args, torch.float32)
    got = K.bvp_fused_plain(*ins, wmu=wmu, flux_only=flux_only)
    for g, w in zip(got, want):
        assert _rel(g, w) <= 3e-5


def _xla_reference(args, N):
    """JAX ``solve_bvp`` in float64, and from its (a, b) the layer-top
    wmu-sums and the bottom snapshot."""
    sol, ptop_p, ptop_m = args[0], np.asarray(args[1]), np.asarray(args[2])
    ang = args[-1]
    a, b = (np.asarray(x) for x in JS.solve_bvp(*args))
    gp, gm, E = (np.asarray(x) for x in (sol.gp, sol.gm, sol.expd))
    wmu = np.asarray(ang.w * ang.mu)
    up = (np.einsum("iklb,klb->ilb", gp, a)
          + np.einsum("iklb,klb->ilb", gm * E[None], b) + ptop_p)
    dn = (np.einsum("iklb,klb->ilb", gm, a)
          + np.einsum("iklb,klb->ilb", gp * E[None], b) + ptop_m)
    fl = np.stack([np.einsum("i,ilb->lb", wmu, up),
                   np.einsum("i,ilb->lb", wmu, dn)])
    return (a, b), (fl, np.concatenate([a[:, -1], b[:, -1]]))


@pytest.mark.parametrize("nstr", [4, 8])
@pytest.mark.parametrize("flux_only", [False, True])
def test_plain_matches_xla_f64(nstr, flux_only):
    args = _jax_problem(nstr, 11, 8, seed=3, dtype=jnp.float64)
    ab, flux = _xla_reference(args, nstr // 2)
    ins, wmu = _port_inputs(args, torch.float64)
    got = K.bvp_fused_plain(*ins, wmu=wmu, flux_only=flux_only)
    for g, w in zip(got, flux if flux_only else ab):
        assert _rel(g, w) <= 1e-12


def test_ab_last_contracts_to_k3_bottom_level_sums():
    """K6's flux mode keeps the raw bottom (a, b); contracted to the
    bottom-level sums it gives K3's ``fl_bot``, and its layer-top sums are
    K3's ``fl`` (K2 + K3 plain, float64)."""
    args = _jax_problem(4, 11, 8, seed=3, dtype=jnp.float64)
    (gp, gm, E, dblk, alb, tp, tm), wmu = _port_inputs(args, torch.float64)
    ang = TS.make_static_angles(4, 4, 0)
    pbp = torch.tensor(np.asarray(args[3])[:, -1])
    pbm = torch.tensor(np.asarray(args[4])[:, -1])
    P, g = K.bvp_forward_plain(gp, gm, E, dblk, alb, ang)
    fl3, flb3 = K.bvp_backward_flux_plain(gp, gm, E, P, g, tp, tm, pbp, pbm,
                                          ang)
    fl6, ab = K.bvp_fused_plain(gp, gm, E, dblk, alb, tp, tm, wmu=wmu,
                                flux_only=True)
    N = 2
    aL, bL = ab[:N], ab[N:]
    gpL, gmL, EL = gp[:, :, -1], gm[:, :, -1], E[:, -1]
    up = TS._umv(gpL * EL[None], aL) + TS._umv(gmL, bL) + pbp
    dn = TS._umv(gmL * EL[None], aL) + TS._umv(gpL, bL) + pbm
    bot = torch.stack([TS._uwdot_static(wmu, up), TS._uwdot_static(wmu, dn)])
    assert _rel(bot, flb3.numpy()) <= 1e-12
    assert _rel(fl6, fl3.numpy()) <= 1e-12


def test_wrapper_on_cpu_runs_plain_and_launches_nothing():
    args = _jax_problem(4, 5, 4, seed=1, dtype=jnp.float32)
    ins, wmu = _port_inputs(args, torch.float32)
    K.reset_launches()
    for flux_only in (False, True):
        got = K.bvp_fused(*ins, wmu=wmu, flux_only=flux_only)
        want = K.bvp_fused_plain(*ins, wmu=wmu, flux_only=flux_only)
        for g, w in zip(got, want):
            torch.testing.assert_close(g, w, rtol=0, atol=0)
    assert K.launch_counts()["bvp_fused"] == 0
    with pytest.raises(ValueError, match="CPU or all on CUDA"):
        K.bvp_fused(*ins[:-1], ins[-1].to("meta"), wmu=wmu, flux_only=True)


def segmented_fused(gp, gm, expd, dblk, alb, tp, tm, *, wmu, flux_only, S):
    """K6's segmented schedule with the plain layer step: sweep 1 keeps the
    plain carry (R, P, g) entering every S-th layer up to the last
    segment; sweep 2 walks the segments bottom-up, recomputes each one's
    P_l, g_l from its checkpoint and back-substitutes them (K5's carry, or
    K3's layer-top sums and the bottom (a, b))."""
    N, _, L, B = gp.shape
    wmu = np.asarray(wmu, np.float64)
    step = lambda l, c: K._bvp_forward_step(  # noqa: E731
        gp, gm, expd, dblk, alb, wmu, l, c)
    nseg = -(-L // S)
    carry, ckpt = K._bvp_forward_carry0(gp), {}
    for l in range((nseg - 1) * S):
        if l % S == 0:
            ckpt[l // S] = carry
        carry = step(l, carry)
    dx = gp.new_zeros((N, B))
    xs, fl = [None] * L, [None] * L
    for seg in range(nseg - 1, -1, -1):
        if seg < nseg - 1:
            carry = ckpt[seg]
        layers = range(seg * S, min(L, seg * S + S))
        Pg = []
        for l in layers:
            carry = step(l, carry)
            Pg.append(carry[1:])
        for l, (P, g) in reversed(list(zip(layers, Pg))):
            x = g + TS._umv(P, dx)
            a, b = x[:N], x[N:]
            gpl, gml, El = gp[:, :, l], gm[:, :, l], expd[:, l]
            up = TS._umv(gpl, a) + TS._umv(gml * El[None], b)
            dn = TS._umv(gml, a) + TS._umv(gpl * El[None], b)
            fl[l] = torch.stack([TS._uwdot_static(wmu, up + tp[:, l]),
                                 TS._uwdot_static(wmu, dn + tm[:, l])])
            xs[l], dx = x, up
    x = torch.stack(xs, dim=1)
    if flux_only:
        return torch.stack(fl, dim=1), x[:, -1]
    return x[:N], x[N:]


@functools.lru_cache(maxsize=None)
def _plain_fused(nstr: int, flux_only: bool):
    """K6's float32 inputs at L = 11, B = 8 and ``bvp_fused_plain`` on them."""
    args = _jax_problem(nstr, 11, 8, seed=5, dtype=jnp.float32)
    ins, wmu = _port_inputs(args, torch.float32)
    return ins, wmu, K.bvp_fused_plain(*ins, wmu=wmu, flux_only=flux_only)


@pytest.mark.parametrize("nstr", [2, 4, 8])
@pytest.mark.parametrize("S", [1, 3, 4, 11])
@pytest.mark.parametrize("flux_only", [False, True])
def test_segmented_schedule_is_the_plain_version_bit_for_bit(nstr, S,
                                                             flux_only):
    """L = 11: S = 3 and 4 leave the last segment partial, S = 11 is one
    segment (no checkpoint), S = 1 a checkpoint at every layer."""
    ins, wmu, want = _plain_fused(nstr, flux_only)
    got = segmented_fused(*ins, wmu=wmu, flux_only=flux_only, S=S)
    for g, w in zip(got, want):
        assert g.shape == w.shape
        assert torch.equal(g, w)
