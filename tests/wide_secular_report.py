#!/usr/bin/env python3
"""K1's secular roots in float32 at nstr 16 to 32: the JAX package's Pallas
K1 beside the port's K1, both against the port's float64 K1, on the CPU.

    python3 tests/wide_secular_report.py [--nstr 16 22 32]

On ``tests/test_torch_kernels._stage1_inputs(6, 64, seed 0)`` (ssa with 0
and 0.999999 entries) it runs, at each nstr:

* the JAX package's ``fused_homogeneous_thermal`` (nmom = 0, interpret
  mode, float32): the fixed secular schedule in x = lam^2 of
  ``pallas_kernels.py:242-300``;
* the port's ``kernels.stage1_isotropic_plain`` in float32, which the CUDA
  K1 computes bit for bit: the same schedule up to nstr 16, the roots
  taken relative to their nearer pole above;

and prints for each the largest relative error of lam away from the ssa =
0.999999 element, the error of gp over max|gp|, and how many elements of
gp are NaN, against the port's K1 in float64.  From nstr 22 on the fixed
schedule cannot tell the top root from its pole in float32 and returns
NaN: a float32 condition of the reference algorithm, which the port
repairs and the JAX package keeps.  The last line is one JSON object with
the same numbers.  Not a test: the interpret-mode Pallas body takes ~40 s
at nstr 32.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
from pathlib import Path

import numpy as np

REPO = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(REPO)]


def errors(got, ref, edge):
    """(lam rel. err. away from the edge, gp err. / max|gp|, NaN count)."""
    gp, lam = np.asarray(got[0], np.float64), np.asarray(got[2], np.float64)
    with np.errstate(invalid="ignore"):
        rel = np.abs(lam - ref[2]) / ref[2]
        gerr = np.abs(gp - ref[0]).max() / np.abs(ref[0]).max()
    return (float(np.nanmax(rel[:, ~edge]) if np.isfinite(rel[:, ~edge]).any()
                  else np.nan),
            float(gerr), int(np.isnan(gp).sum()))


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--nstr", type=int, nargs="+", default=[16, 22, 32])
    args = ap.parse_args(argv)
    os.environ.setdefault("JAX_PLATFORMS", "cpu")
    import jax

    jax.config.update("jax_enable_x64", True)
    import jax.numpy as jnp
    import torch

    from pyharp_tpu_torch.rt.disort import kernels as K
    from pyharp_tpu_torch.rt.disort.solver import make_static_angles
    from tests.test_torch_kernels import (NEAR_CONSERVATIVE, _jax_stage1,
                                          _stage1_inputs)

    ins = _stage1_inputs(6, 64, seed=0)
    edge = ins[0] == NEAR_CONSERVATIVE
    rows = {}
    print("nstr | who | max rel. err. of lam (no ssa = 0.999999) | "
          "gp err. / max|gp| | NaN entries of gp")
    for nstr in args.nstr:
        ang = make_static_angles(nstr, nstr, 0)
        ref = [x.numpy() for x in K.stage1_isotropic_plain(
            *(torch.tensor(x) for x in ins), ang)]
        port = [x.numpy() for x in K.stage1_isotropic_plain(
            *(torch.tensor(x, dtype=torch.float32) for x in ins), ang)]
        jax32 = _jax_stage1(*ins, nstr, jnp.float32)
        for who, got in (("JAX Pallas K1 float32", jax32),
                         ("port K1 float32", port)):
            lam_err, gp_err, nans = errors(got, ref, edge)
            rows[f"{nstr} {who}"] = dict(lam_rel_err=lam_err, gp_err=gp_err,
                                         gp_nan=nans, gp_size=got[0].size)
            print(f"{nstr} | {who} | {lam_err:.2e} | {gp_err:.2e} | "
                  f"{nans} of {got[0].size}", flush=True)
    print(json.dumps(rows))


if __name__ == "__main__":
    main()
