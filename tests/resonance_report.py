#!/usr/bin/env python3
"""The float32 flux solve near a beam resonance, against float64: the JAX
package's own float32 path beside the PyTorch port's, on the CPU.

    python3 tests/resonance_report.py [--aerosol-waves 10] [--lbl-waves 4]

Takes the first waves of ``chip_smoke.py``'s two shortwave problems (the
same draws): ``aerosol_16str_beam`` (128 columns x 40 layers, nstr 16,
Henyey-Greenstein g = 0.8) and ``sw_lbl_4str_beam`` (512 x 40, nstr 4,
isotropic), both with mu0 = 0.7 and albedo 0.3.  Their columns are split as
``chip_smoke.py`` splits them: "near" when a layer has lam_k^2 within
1e-3 (relative) of 1/mu0^2, "away" otherwise; of the near columns, those
within float32's resonance floor (1e-4) also on their own.  For each group
it prints the largest per-column max|err| / max|flux| of:

* the port's float64 plain path against JAX ``kernel="xla"`` float64 (the
  reference; resonance floor 1e-9 in both);
* JAX ``kernel="xla"`` float32 and the port's float32 plain path (floor
  1e-4 in both; the port's CUDA kernels compute the port's plain float32
  versions) against that reference, and against the float64 plain path
  run with float32's floor;
* for the aerosol problem, the port's float32 path with its eigenvalue
  problem (``homogeneous_solution``) solved in float64 and rounded to
  float32, against the float64 plain path with float32's floor: what is
  left when float32 Jacobi rotations no longer set lam^2.

The last line is one JSON object with the same numbers.  Not a test: it
imports the JAX package and the port, as the tests do, and takes a few
minutes on the CPU, most of it compiling JAX's nstr 16 graphs.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
from pathlib import Path
from unittest import mock

REPO = Path(__file__).resolve().parents[1]


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--aerosol-waves", type=int, default=10)
    ap.add_argument("--lbl-waves", type=int, default=4)
    args = ap.parse_args()

    os.environ["JAX_PLATFORMS"] = "cpu"
    sys.path.insert(0, str(REPO))
    import jax

    jax.config.update("jax_enable_x64", True)
    import jax.numpy as jnp
    import numpy as np
    import torch

    from chip_smoke import (RESONANCE_MARGIN,
                            float32_resonance_floor, resonance_margin)
    from pyharp_tpu.rt.disort.disort import Disort as JDisort
    from pyharp_tpu.rt.disort.disort import DisortOptions as JDisortOptions
    from pyharp_tpu_torch.bench.problems import extra_problem
    from pyharp_tpu_torch.rt.disort import kernels as K
    from pyharp_tpu_torch.rt.disort import solver as S

    def port(cfg, dtype):
        nwave, ncol, nlyr, nstr, g = cfg
        p = extra_problem(nwave, ncol, nlyr, nstr, g=g, dtype=dtype,
                          device="cpu", kernel="torch", first=cfg_first[cfg])
        ds, prop, bc = p.disort, p.prop, p.bc
        pr = ds._prepare(prop, bc, None)
        md = ds._solve_mode(pr)
        return ds._fluxes_from_mode0(pr, md)[0].double().numpy(), md, ds, prop, bc

    def jax_xla(ds, prop, bc, dtype):
        opts = {f: getattr(ds.options, f) for f in
                ("flags", "nwave", "ncol", "nlyr", "nstr", "nmom")}
        return np.asarray(JDisort(JDisortOptions(kernel="xla", **opts)).forward(
            jnp.asarray(prop.numpy(), dtype),
            {k: jnp.asarray(v.numpy(), dtype) for k, v in bc.items()}),
            np.float64)

    def eigen_f64(ssa, pmom, dtau, ang, sweeps=None):
        sol, V, U = S.homogeneous_solution(ssa.double(), pmom.double(),
                                           dtau.double(), ang, sweeps)
        return (S.LayerSolution(*(x.float() for x in sol)), V.float(),
                U.float())

    aerosol = (500, 128, 40, 16, 0.8)
    lbl = (500, 512, 40, 4, 0.0)
    cfg_first = {aerosol: args.aerosol_waves, lbl: args.lbl_waves}
    report = {}
    for name, cfg in (("aerosol_16str_beam", aerosol),
                      ("sw_lbl_4str_beam", lbl)):
        ref, md, ds, prop64, bc64 = port(cfg, torch.float64)
        margin = resonance_margin(md).reshape(ref.shape[:2]).numpy()
        near = margin < RESONANCE_MARGIN
        floor32 = S.beam_resonance_eps(torch.float32)
        groups = {"away": ~near, "near": near,
                  f"near, margin < {floor32}": margin < floor32}
        with float32_resonance_floor():
            ref_f = port(cfg, torch.float64)[0]
        f32 = port(cfg, torch.float32)[0]
        j64 = jax_xla(ds, prop64, bc64, jnp.float64)
        j32 = jax_xla(ds, prop64, bc64, jnp.float32)
        rows = {
            "port f64 vs JAX xla f64": (ref, j64),
            "JAX xla f32 vs JAX xla f64": (j32, j64),
            "port f32 vs JAX xla f64": (f32, j64),
            "JAX xla f32 vs f64 with f32 floor": (j32, ref_f),
            "port f32 vs f64 with f32 floor": (f32, ref_f),
        }
        if cfg[3] > 4:
            with mock.patch.object(K, "homogeneous_solution", eigen_f64):
                f32e = port(cfg, torch.float32)[0]
            rows["port f32, f64 eigen-solve, vs f64 with f32 floor"] = (
                f32e, ref_f)
        scale = np.abs(j64).max()
        out = {"columns": int(near.size),
               "counts": {g: int(m.sum()) for g, m in groups.items()}}
        print(f"{name}: first {cfg_first[cfg]} waves, {near.size} columns; "
              + ", ".join(f"{g}: {n}" for g, n in out["counts"].items()))
        for label, (a, b) in rows.items():
            col = np.abs(a - b).max(axis=(2, 3)) / scale
            out[label] = {g: float(col[m].max()) if m.any() else 0.0
                          for g, m in groups.items()}
            print(f"  {label:50s} " + "  ".join(
                f"{g} {e:.3e}" for g, e in out[label].items()))
        report[name] = out
    print(json.dumps(report))


if __name__ == "__main__":
    main()
