"""Stage-level timings of the solver (PyTorch port of
``pyharp_tpu/bench/stages.py``).

    python -m pyharp_tpu_torch.bench.stages [--ncol 8192] [--device cuda]

Part (a), the JAX tool's own problem (L = 100, B = 8 x 8192, nstr 8, 8
phase moments, :func:`problems.stage_inputs`): stage 1 (K4, the
eigensolve and the thermal particular in one kernel), then stage 1 with
the BVP added (the boundary blocks, K2 and K5), and the solver-only
columns/s.

Part (b), ``Disort.forward`` on the bench problem split into its layers:
preparation (``Disort._prepare``, the Planck series included), stage 1
(K1), the glue (the particulars, the boundary terms and ``dblk``:
``Disort._solve_mode`` with its kernels' outputs replayed), the BVP (K2,
K3), the flux assembly (``Disort._fluxes_from_mode0``) and the whole
``forward``.  Each stage runs on the previous stage's outputs, so the
chain gives ``forward``'s flux bit for bit (:func:`split_forward`).

Every time is :func:`profile.measure`'s: CUDA events over 10 calls on the
card, the host clock over 2 on the CPU.
"""

from __future__ import annotations

import argparse
import copy
import json
import statistics
from types import SimpleNamespace

import torch

from ..core.device import DEFAULT_DEVICE, resolve_device
from ..rt.disort import kernels as K
from ..rt.disort.disort import FUSED_FLUX_MAX_N
from ..rt.disort.solver import bvp_rhs, make_static_angles
from .problems import bench_problem, stage_inputs
from .roofline_run import kernel_fn
from .profile import card_line, measure, timed_calls


def solver_stages(ncol: int = 8192, nwave: int = 8, nlyr: int = 100,
                  nstr: int = 8, device: torch.device | str = DEFAULT_DEVICE,
                  iters: int = 10, check=None) -> dict:
    """Part (a): seconds of stage 1 (K4) and of stage 1 + the BVP (K2 +
    K5), and the solver-only columns/s (``ncol`` over the latter).
    ``check(name, got, want)``, where given, is called for each stage with
    its outputs and those of the kernels' plain versions chained the same
    way on the same inputs."""
    dev = resolve_device(device)
    L, B = nlyr, nwave * ncol
    ang = make_static_angles(nstr, nstr, 0)
    x = stage_inputs(L, B, nstr, device=dev)
    s1 = (x["ssa"], x["pmom"], x["dtau"], x["btop"], x["slope"])
    bc = (x["albedo"], x["ftop"], x["bot_rhs"])

    def stage1(ssa, pmom, dtau, btop, slope, plain=False):
        k4 = kernel_fn("stage1_general", plain)
        return k4(ssa, pmom, dtau, btop, slope, ang)

    def full(ssa, pmom, dtau, btop, slope, albedo, ftop, bot_rhs,
             plain=False):
        gp, gm, _, expd, y0p, y0m, y1 = stage1(ssa, pmom, dtau, btop, slope,
                                               plain)
        dblk = bvp_rhs(y0p, y0m, y0p + y1 * dtau[None], y0m + y1 * dtau[None],
                       ftop, bot_rhs).contiguous()
        P, g = kernel_fn("bvp_forward", plain)(gp, gm, expd, dblk, albedo, ang)
        return kernel_fn("bvp_backward", plain)(gp, gm, expd, P, g, ang)

    t1 = measure(stage1, *s1, iters=iters)
    t_full = measure(full, *s1, *bc, iters=iters)
    if check is not None:
        check("stage 1 (K4)", stage1(*s1), stage1(*s1, plain=True))
        check("stage 1 + BVP (K2 + K5)", full(*s1, *bc),
              full(*s1, *bc, plain=True))
    return dict(stage1_s=t1, with_bvp_s=t_full, columns_per_s=ncol / t_full)


def _replaying(ds, route: str, out1):
    """A shallow copy of ``ds`` whose ``_solve_mode`` runs the glue alone:
    its kernel namespace (in place of ``Disort._kernels``) returns ``out1``
    from stage 1, and its BVP kernels launch nothing: they record their
    arguments in ``calls`` and return ``None``s, which ``_solve_mode`` only
    stores.  Returns ``(copy, calls)``."""
    calls = {}

    def record(name):
        def fn(*args):
            calls[name] = args
            return None, None
        return fn

    ns = SimpleNamespace(
        route=route, stage1_isotropic=lambda *a: out1,
        bvp_forward=record("bvp_forward"),
        bvp_backward_flux=record("bvp_backward_flux"))
    glue = copy.copy(ds)
    glue._kernels = lambda device, dtype: ns
    return glue, calls


def _bvp(fwd_args, bwd_args):
    """K2 then K3 on the arguments the glue handed them."""
    P, g = K.bvp_forward(*fwd_args)
    gp, gm, expd, _, _, *rest = bwd_args
    fl, fl_bot = K.bvp_backward_flux(gp, gm, expd, P, g, *rest)
    return P, g, fl, fl_bot


def split_forward(ds, prop, bc, temf, iters: int = 10, rounds: int = 5):
    """Part (b): ``ds.forward(prop, bc, temf)`` stage by stage, each stage
    on the previous one's outputs.  Returns ``(rows, flux)``: the seconds
    of each stage and of the whole ``forward``, and the chained stages'
    flux.

    The steps are host-bound (preparation launches many small kernels), so
    a time moves with the host's load: every row is measured once per
    round, the rows in turns, and each row's median over the ``rounds``
    is reported."""
    N = ds.nstr // 2
    if N > FUSED_FLUX_MAX_N:
        raise ValueError(f"the split follows K3's path, N <= "
                         f"{FUSED_FLUX_MAX_N}; got N = {N}")
    pr = ds._prepare(prop, bc, temf)
    if pr["pmom_s"].shape[1] or pr["has_beam"] or pr["gensrc"] is not None:
        raise ValueError("the split follows the isotropic thermal path (K1)")
    ang = ds._ang0
    k = ds._kernels(prop.device, prop.dtype)
    s1 = (pr["ssa_s"], pr["dtau"], pr["b_top_lay"], pr["slope"], ang)
    out1 = k.stage1_isotropic(*s1)
    glue, calls = _replaying(ds, k.route, out1)
    md = glue._solve_mode(pr)
    fwd_args, bwd_args = calls["bvp_forward"], calls["bvp_backward_flux"]
    P, g, fl, fl_bot = _bvp(fwd_args, bwd_args)
    md.update(P=P, g=g, fl=fl, fl_bot=fl_bot)
    flux = ds._fluxes_from_mode0(pr, md)[0]
    calls = {
        "preparation": (ds._prepare, prop, bc, temf),
        "stage 1 (K1)": (k.stage1_isotropic, *s1),
        "glue": (glue._solve_mode, pr),
        "BVP (K2, K3)": (_bvp, fwd_args, bwd_args),
        "flux assembly": (ds._fluxes_from_mode0, pr, md),
        "forward": (ds.forward, prop, bc, temf),
    }
    times = {name: [] for name in calls}
    for _ in range(rounds):
        for name, (fn, *args) in calls.items():
            times[name].append(measure(fn, *args, iters=iters))
    return {name: statistics.median(t) for name, t in times.items()}, flux


def check_split(rows: dict, tol: float = 0.1) -> float:
    """The stages' sum over the whole ``forward``; raises unless within
    ``tol`` of 1, naming the gap."""
    parts = {k: v for k, v in rows.items() if k != "forward"}
    ratio = sum(parts.values()) / rows["forward"]
    if abs(ratio - 1.0) > tol:
        gap = (rows["forward"] - sum(parts.values())) * 1e3
        raise AssertionError(
            f"the stages sum to {ratio:.3f} of forward: "
            + (f"{gap:.3f} ms of forward is in no row (a stage or a launch "
               "is missing from the split)" if gap > 0 else
               f"{-gap:.3f} ms more than forward (a stage's inputs were "
               "made inside its timed call)")
            + "; rows " + ", ".join(f"{k} {v * 1e3:.3f} ms"
                                    for k, v in rows.items()))
    return ratio


def main(argv=None, check=None) -> dict:
    """The command line; ``check`` as :func:`solver_stages`'s."""
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--ncol", type=int, default=8192)
    ap.add_argument("--nwave", type=int, default=8)
    ap.add_argument("--nlyr", type=int, default=100)
    ap.add_argument("--nstr", type=int, default=8)
    ap.add_argument("--device", default=DEFAULT_DEVICE)
    a = ap.parse_args(argv)
    dev = resolve_device(a.device)
    iters = timed_calls(dev)
    rounds = 5 if dev.type == "cuda" else 1
    card = card_line(dev)
    shape = f"{a.nwave}x{a.ncol}x{a.nlyr} nstr {a.nstr}"

    sa = solver_stages(a.ncol, a.nwave, a.nlyr, a.nstr, dev, iters, check)
    print(f"(a) stages.py's problem {shape}, 8 moments [{card}]")
    print(f"stage 1 (K4)        : {sa['stage1_s'] * 1e3:8.3f} ms")
    print(f"  + BVP (K2 + K5)   : {sa['with_bvp_s'] * 1e3:8.3f} ms "
          f"(delta {(sa['with_bvp_s'] - sa['stage1_s']) * 1e3:+.3f})")
    print(f"solver-only rate    : {sa['columns_per_s']:,.0f} columns/s")

    p = bench_problem(a.nwave, a.ncol, a.nlyr, a.nstr, device=dev)
    rows, flux = split_forward(p.disort, *p.args, iters, rounds)
    equal = torch.equal(flux, p.disort.forward(*p.args))
    if dev.type == "cuda":
        ratio = check_split(rows)
    else:       # host times of the plain versions: reported, not held
        ratio = sum(v for k, v in rows.items() if k != "forward") / rows[
            "forward"]
    print(f"(b) Disort.forward on the bench problem {shape} [{card}]")
    for name, sec in rows.items():
        share = sec / rows["forward"]
        print(f"{name:<20}: {sec * 1e3:8.3f} ms ({share:6.1%})")
    print(f"stages sum to {ratio:.3f} of forward; chained stages bit-equal "
          f"to forward: {'yes' if equal else 'no'}")
    if not equal:
        raise AssertionError("the chained stages differ from forward")
    rec = dict(card=card, shape=shape, solver=sa,
               split_ms={k: v * 1e3 for k, v in rows.items()},
               sum_over_forward=ratio, bit_equal=equal)
    print(json.dumps(rec))
    return rec


if __name__ == "__main__":
    main()
