#!/usr/bin/env python3
"""Float32 against float64 on the radiance path, for the port and the JAX
package, column by column (not a test; CPU, ~2 min).

    python3 tests/radiance_f32_report.py [--first 1024] [--cols 579,2584]

It draws ``chip_smoke.py`` phase 12's problem
(``pyharp_tpu_torch.bench.problems.radiance_problem``:
radiances_8str_4mu_2phi_3tau, 32 x 512 x 40, nstr 8, drawn with numpy as
``bench_extra.py`` draws it) and solves only the chosen columns (flattened wave x
column indices: the first ``--first`` ones and ``--cols``): the port's
float64 plain path as the reference, the port's float32 plain path, and
the JAX package's float32 ``kernel="xla"`` path (x64 off, in a
subprocess).  Per column it prints max|err| of ``uu`` over the column's
max|uu|, next to the two distances that condition float32 there: the beam
margin (the least |lam_k^2 - 1/mu0^2| / (lam_k^2 + 1/mu0^2) over every
mode and layer, ``chip_smoke.RESONANCE_MARGIN`` = 1e-3 makes a column
"near") and the user margin (the least |1 - lam_k |mu_u||), then the
largest error in bins of each.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import tempfile
from pathlib import Path

import numpy as np

REPO = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(REPO), str(REPO / "examples")]

JAX_CODE = r"""
import sys, numpy as np, jax
jax.config.update("jax_platforms", "cpu")
import jax.numpy as jnp
from pyharp_tpu.rt.disort.disort import Disort, DisortOptions
p = np.load(sys.argv[1]).astype(np.float32)
n = p.shape[1]
kw = {k: tuple(v) if isinstance(v, list) else v
      for k, v in json.loads(sys.argv[3]).items()}
ds = Disort(DisortOptions(kernel="xla", nwave=1, ncol=n, **kw))
bc = dict(albedo=jnp.full((1, n), 0.2, jnp.float32),
          fbeam=jnp.full((1, n), float(np.pi), jnp.float32),
          umu0=jnp.full((1, n), 0.7, jnp.float32))
uu = ds.intensities(jnp.asarray(p), bc)["uu"]
np.save(sys.argv[2], np.asarray(uu).astype(np.float64))
"""


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--first", type=int, default=1024)
    ap.add_argument("--cols", default="")
    args = ap.parse_args()

    import torch

    import chip_smoke as cs
    from pyharp_tpu_torch import Disort, DisortOptions
    from pyharp_tpu_torch.bench import problems as P

    cols = list(range(args.first)) + [int(c) for c in args.cols.split(",")
                                      if c]
    prop = P.radiance_problem(torch.float32, "cpu", "torch").prop
    nlyr, nstr = prop.shape[2], P.RAD_SHAPE[3]
    sel = prop.reshape(-1, *prop.shape[2:])[cols][None]   # (1, n, L, nprop)
    n = len(cols)
    opts = dict(flags=P.RAD_FLAGS, nlyr=nlyr, nstr=nstr, nmom=nstr,
                user_mu=P.RAD_MU, user_phi=P.RAD_PHI, user_tau=P.RAD_TAU)

    def port(dtype):
        ds = Disort(DisortOptions(kernel="torch", nwave=1, ncol=n, **opts))
        bc = dict(albedo=torch.full((1, n), 0.2, dtype=dtype),
                  fbeam=torch.full((1, n), float(np.pi), dtype=dtype),
                  umu0=torch.full((1, n), 0.7, dtype=dtype))
        return ds, sel.to(dtype), bc

    ds64, p64, bc64 = port(torch.float64)
    pr = ds64._prepare(p64, bc64, None)
    md = ds64._solve_mode(pr, flux_only=False)
    modes = ds64._modes_batched(pr)
    u64 = ds64._radiances(pr, md, modes)["uu"].numpy()
    beam = torch.minimum(cs.resonance_margin(md),
                         cs.modes_margin(modes).amin(dim=0)).numpy()
    lam = torch.cat([md["sol"].lam[None], modes["lam"]])   # (nm, N, L, B)
    mus = torch.tensor([abs(m) for m in P.RAD_MU], dtype=torch.float64)
    user = (1.0 - lam[None] * mus[:, None, None, None, None]).abs()
    user = user.amin(dim=(0, 1, 2, 3)).numpy()

    u32 = port(torch.float32)
    u32 = u32[0].intensities(u32[1], u32[2])["uu"].double().numpy()
    with tempfile.TemporaryDirectory() as tmp:
        pin, pout = os.path.join(tmp, "p.npy"), os.path.join(tmp, "u.npy")
        np.save(pin, sel.numpy())
        env = dict(os.environ, JAX_PLATFORMS="cpu",
                   PYTHONPATH=str(REPO))
        jopts = {k: (list(v) if isinstance(v, tuple) else v)
                 for k, v in opts.items()}
        subprocess.run([sys.executable, "-c", "import json\n" + JAX_CODE,
                        pin, pout, json.dumps(jopts)], check=True, env=env)
        uj = np.load(pout)

    def rel(u):
        return (np.abs(u - u64).max(axis=(2, 3, 4))
                / np.abs(u64).max(axis=(2, 3, 4)))[0]

    e32, ej = rel(u32), rel(uj)
    print(f"{n} columns of radiances_8str_4mu_2phi_3tau, uu max|err| over "
          "the column's max|uu|, against the port's float64 plain path")
    for name, m, edges in (("beam margin", beam, (0, 1e-4, 1e-3, 1.0)),
                           ("user margin", user, (0, 1e-5, 1e-4, 1e-3, 1.0))):
        for lo, hi in zip(edges, edges[1:]):
            s = (m >= lo) & (m < hi)
            if s.any():
                print(f"  {name} [{lo:g}, {hi:g}): {int(s.sum())} columns, "
                      f"port float32 {e32[s].max():.2e}, JAX float32 "
                      f"{ej[s].max():.2e}")
    away = beam >= cs.RESONANCE_MARGIN
    for name, s in (("away from a beam resonance", away),
                    ("near one", ~away)):
        if s.any():
            print(f"  {name}: {int(s.sum())} columns, port float32 "
                  f"{e32[s].max():.2e}, JAX float32 {ej[s].max():.2e}")
    for i, c in enumerate(cols[args.first:]):
        j = args.first + i
        print(f"  column {c}: beam margin {beam[j]:.2e}, user margin "
              f"{user[j]:.2e}, port float32 {e32[j]:.2e}, JAX float32 "
              f"{ej[j]:.2e}")


if __name__ == "__main__":
    main()
