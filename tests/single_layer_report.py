#!/usr/bin/env python3
"""The float32 BVP of one layer spanning 100 K, against float64: the JAX
package's float32 path beside the PyTorch port's plain version, on the
CPU.

    python3 tests/single_layer_report.py

Builds the inputs of ``chip_smoke.py`` phase 10's L = 1 case on the CPU
(``pyharp_tpu_torch.bench.problems.bench_problem``: 2 x 509 columns, one
layer from 200 to 300 K, dtau 0.001-0.8, its seed) at nstr 4, 8 and 16,
in float32, and
solves the BVP three ways on those same float32 inputs:

* the port's ``bvp_fused_plain`` in float64 (the inputs widened): the
  reference;
* the port's ``bvp_fused_plain`` in float32;
* the JAX package's ``solve_bvp`` (its XLA path) in float32, and from its
  (a, b) the layer-top sums as the JAX ``Disort`` forms them in float32
  (``disort.py:713-725``: gp a + gm (E b) + ptop, wmu-weighted).

For each float32 solve it prints, for (a, b) and for the layer-top sums
(K6's flux mode), max|err|/max|ref| against the reference and the excess
of ``chip_smoke.BVP_TOL`` (max of |err| - 3e-4 |ref|, over max|ref|; the
check passes at <= 3e-5), the larger over the outputs.  (a, b) stay near
float32's rounding; the layer-top sums add the particular solution at the
layer top to the homogeneous part that cancels it, and lose digits there.
The last line is one JSON object with the same numbers.  Not a test: it
imports the JAX package and the port, as the tests do, and takes about a
minute.  (The Pallas K6 in interpret mode is left out: at nstr 16 its
compile on the CPU outlasts 15 minutes.)
"""

from __future__ import annotations

import json
import os
import sys
from pathlib import Path

REPO = Path(__file__).resolve().parents[1]
NCOL, L = 509, 1


def main() -> None:
    os.environ["JAX_PLATFORMS"] = "cpu"
    sys.path[:0] = [str(REPO)]
    import jax

    jax.config.update("jax_enable_x64", True)
    import jax.numpy as jnp
    import numpy as np
    import torch

    import chip_smoke as cs
    from pyharp_tpu_torch.bench.problems import bench_problem
    from pyharp_tpu.rt.disort import solver as JS
    from pyharp_tpu_torch.rt.disort import kernels as K

    def measures(got, ref):
        rel = exc = 0.0
        for g, r in zip(got, ref):
            g, r = np.asarray(g, np.float64), np.asarray(r, np.float64)
            top = np.abs(r).max()
            rel = max(rel, float(np.abs(g - r).max() / top))
            exc = max(exc, float((np.abs(g - r) - 3e-4 * np.abs(r)).max()
                                 / top))
        return dict(max_rel_err=rel, bvp_tol_excess=exc)

    out = {}
    for nstr in (4, 8, 16):
        N = nstr // 2
        p = bench_problem(2, NCOL, L, nstr, torch.float32, "cpu", "torch",
                          seed=3 * nstr + L)
        ds, prop, bc, temf = p.disort, p.prop, p.bc, p.temf
        pr = ds._prepare(prop, bc, temf)
        md = ds._solve_mode(pr)
        ins = cs.bvp_inputs(pr, md)
        wmu = ds._ang0.w * ds._ang0.mu
        ins64 = [x.double() for x in ins]
        ab64 = K.bvp_fused_plain(*ins64, wmu=wmu, flux_only=False)
        fl64 = K.bvp_fused_plain(*ins64, wmu=wmu, flux_only=True)[0]
        ab32 = K.bvp_fused_plain(*ins, wmu=wmu, flux_only=False)
        fl32 = K.bvp_fused_plain(*ins, wmu=wmu, flux_only=True)[0]
        # the JAX solver on the same float32 inputs: at L = 1 the block
        # rhs is [ptop_m - ftop ; bot_rhs], so ptop_m = its top half and
        # ftop = 0 give the port's dblk exactly
        gp, gm, E, dblk, alb, tp, tm = (jnp.asarray(x.numpy()) for x in ins)
        sol = JS.LayerSolution(jnp.asarray(md["sol"].lam.numpy()), gp, gm, E)
        top = dblk[:N]
        zero = jnp.zeros_like(top)
        a, b = JS.solve_bvp(sol, zero, top, zero, zero,
                            jnp.zeros((N, top.shape[-1]), top.dtype),
                            dblk[N:, 0], alb, JS.make_static_angles(nstr, nstr, 0))
        up = JS._umv(gp, a) + JS._umv(gm, E * b) + tp
        dn = JS._umv(gm, a) + JS._umv(gp, E * b) + tm
        fl_jax = jnp.stack([JS._uwdot_static(wmu, up),
                            JS._uwdot_static(wmu, dn)])
        row = {"(a, b), port plain f32": measures(ab32, ab64),
               "(a, b), JAX solve_bvp f32": measures((a, b), ab64),
               "layer-top sums, port plain f32": measures([fl32], [fl64]),
               "layer-top sums, JAX f32": measures([fl_jax], [fl64])}
        out[f"nstr {nstr}"] = row
        for name, m in row.items():
            print(f"nstr {nstr}, L {L}, {2 * NCOL} columns, {name} vs port "
                  f"plain f64: max|err|/max|ref| {m['max_rel_err']:.3e}, "
                  f"BVP_TOL excess {m['bvp_tol_excess']:.3e}", flush=True)
    print(json.dumps(out))


if __name__ == "__main__":
    main()
