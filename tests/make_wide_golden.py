#!/usr/bin/env python3
"""Pin the JAX package's answers at 18 to 32 streams, where JAX is too slow
on a CPU to run inside the tests.

    JAX_PLATFORMS=cpu python3 tests/make_wide_golden.py [--parts ...] [--out F]

From seeded numpy inputs it runs, and stores beside the inputs:

* K4's Pallas body (``fused_homogeneous_thermal``, interpret mode, float32)
  at nstr 18 with phase moments: m = 0 with a thermal source and a beam,
  and the odd mode m = 1 (the eigenstructure; the body's beam prefactor is
  m = 0's).  At nstr 32 the interpret-mode body held 43 GB after 28
  minutes on a CPU without finishing; the port's K4 runs one body for
  every N = 9..16, which the card holds to its plain version at each;
* JAX's XLA ``solver.solve_bvp`` (the same two scans as K2 + K5), run
  eagerly, in float32 and float64 at nstr 32 and 18 on a
  beam-and-moments solve's BVP inputs.  ``solve_bvp_pallas`` in interpret
  mode held 19 GB after an hour at nstr 32 and 31 GB after half an hour
  at nstr 18 (37 GB jitted) on a CPU without finishing, so it is not
  pinned;
* ``Disort.forward`` (``kernel="xla"``, float64) at nstr 32 with a beam,
  Henyey-Greenstein moments and Planck emission, and
  ``Disort.intensities`` at nstr 32 (user angles and depths, the intensity
  correction), a few waves, columns and layers each.

It writes ``tests/golden/wide_streams_jax.npz`` (or ``--out``), keeping
the entries of the parts it does not run, which
``tests/test_torch_wide_golden.py`` holds the port to.  Not a test: on a
CPU the parts take minutes each; ``--parts`` runs a subset (in parallel
processes with separate ``--out`` files, merged with ``--merge``).
"""

from __future__ import annotations

import argparse
import sys
import time
from pathlib import Path

import numpy as np

REPO = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(REPO)]
OUT = REPO / "tests" / "golden" / "wide_streams_jax.npz"
K4_NSTR = 18


def k4_inputs(nstr: int, m: int):
    """Stage-1 inputs as in ``test_torch_scattering_kernels._inputs`` (L = 3,
    B = 8): ssa with a 0 entry, HG moments g = 0.2/0.8 by column, a beam."""
    from tests.test_torch_scattering_kernels import _inputs

    return _inputs(3, 8, nstr, seed=nstr + m, near_conservative=False)


def bvp_inputs(nstr: int):
    """A beam-and-moments solve's BVP inputs (L = 5, B = 8), float32, from
    the port's plain K4 (the values only need to be those of a solve):
    ``(gp, gm, lam, expd, ptop_p, ptop_m, pbot_p, pbot_m, ftop, bot_rhs,
    albedo)`` as numpy."""
    import torch

    from pyharp_tpu_torch.rt.disort import kernels as K
    from pyharp_tpu_torch.rt.disort.legendre import lepoly
    from pyharp_tpu_torch.rt.disort.solver import make_static_angles
    from tests.test_torch_scattering_kernels import _inputs

    x = _inputs(5, 8, nstr, seed=nstr, near_conservative=False)
    t = {k: torch.tensor(v, dtype=torch.float32) for k, v in x.items()}
    ang = make_static_angles(nstr, nstr, 0)
    gp, gm, lam, expd, _, _, _, zp, zm = K.stage1_general_plain(
        t["ssa"], t["pmom"], t["dtau"], t["btop"], t["slope"], ang,
        thermal=False, fbeam=t["fbeam"], mur=t["mur"],
        lam0=lepoly(t["mu0"], 0, ang.lam_tables.shape[0] - 1))
    att = torch.exp(-torch.cumsum(t["dtau"], dim=0) / t["mu0"][None])
    N = nstr // 2
    rng = np.random.default_rng(nstr)
    f32 = lambda a: np.asarray(a, np.float32)
    return dict(gp=gp.numpy(), gm=gm.numpy(), lam=lam.numpy(),
                expd=expd.numpy(), ptop_p=zp.numpy(), ptop_m=zm.numpy(),
                pbot_p=(zp * att).numpy(), pbot_m=(zm * att).numpy(),
                ftop=f32(rng.uniform(0.0, 0.5, (N, 8))),
                bot_rhs=f32(rng.uniform(0.5, 1.5, (N, 8))),
                albedo=f32(rng.uniform(0.0, 0.6, 8)))


def forward_case():
    """``Disort.forward`` at nstr 32: 2 waves x 3 columns x 4 layers, beam,
    HG g = 0.8 moments, Planck between 200 and 300 K."""
    nwave, ncol, nlyr, nstr = 2, 3, 4, 32
    rng = np.random.default_rng(32)
    prop = np.zeros((nwave, ncol, nlyr, 2 + nstr))
    prop[..., 0] = rng.uniform(0.01, 0.8, (nwave, ncol, nlyr))
    prop[..., 1] = rng.uniform(0.1, 0.95, (nwave, ncol, nlyr))
    prop[..., 2:] = 0.8 ** np.arange(1, nstr + 1)
    opts = dict(flags="lamber,quiet,onlyfl,planck", nwave=nwave, ncol=ncol,
                nlyr=nlyr, nstr=nstr, nmom=nstr,
                wave_lower=(100.0, 400.0), wave_upper=(400.0, 900.0))
    bc = dict(albedo=np.full((nwave, ncol), 0.3),
              fbeam=np.full((nwave, ncol), np.pi),
              umu0=rng.uniform(0.3, 0.9, (nwave, ncol)),
              btemp=np.full((nwave, ncol), 300.0))
    temf = np.broadcast_to(np.linspace(200.0, 300.0, nlyr + 1),
                           (ncol, nlyr + 1)).copy()
    return opts, prop, bc, temf


# bench_extra.py's radiance directions
RAD_MU = (-0.8, -0.4, 0.4, 0.8)
RAD_PHI = (0.0, float(np.pi / 2))
RAD_TAU = (0.05, 0.3)


def intensity_case():
    """``Disort.intensities`` at nstr 32: 1 wave x 2 columns x 3 layers,
    ``bench_extra.py``'s radiance flags and HG g = 0.7 moments, user depths
    inside the column."""
    nwave, ncol, nlyr, nstr = 1, 2, 3, 32
    rng = np.random.default_rng(33)
    prop = np.zeros((nwave, ncol, nlyr, 2 + nstr))
    prop[..., 0] = rng.uniform(0.01, 0.5, (nwave, ncol, nlyr))
    prop[..., 1] = rng.uniform(0.1, 0.9, (nwave, ncol, nlyr))
    prop[..., 2:] = 0.7 ** np.arange(1, nstr + 1)
    opts = dict(flags="lamber,quiet,usrang,usrtau,intensity_correction",
                nwave=nwave, ncol=ncol, nlyr=nlyr, nstr=nstr, nmom=nstr,
                user_mu=RAD_MU, user_phi=RAD_PHI, user_tau=RAD_TAU)
    bc = dict(albedo=np.full((nwave, ncol), 0.2),
              fbeam=np.full((nwave, ncol), np.pi),
              umu0=np.full((nwave, ncol), 0.7))
    return opts, prop, bc


PARTS = ("k4_m0", "k4_m1", "bvp", "forward", "intensities")


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--parts", nargs="*", choices=PARTS, default=PARTS)
    ap.add_argument("--out", type=Path, default=OUT)
    ap.add_argument("--merge", type=Path, nargs="*", default=(),
                    help="npz files whose entries to take over first")
    args = ap.parse_args(argv)
    import jax

    jax.config.update("jax_enable_x64", True)
    import jax.numpy as jnp

    from pyharp_tpu.rt.disort import legendre as JL
    from pyharp_tpu.rt.disort import pallas_kernels as PK
    from pyharp_tpu.rt.disort import solver as JS
    from pyharp_tpu.rt.disort.disort import Disort, DisortOptions

    out = dict(np.load(args.out)) if args.out.exists() else {}
    for f in args.merge:
        out.update(np.load(f))

    def put(prefix, d):
        for k, v in d.items():
            out[f"{prefix}__{k}"] = np.asarray(v)

    t0 = time.perf_counter()
    for m in (0, 1):
        if f"k4_m{m}" not in args.parts:
            continue
        nstr = K4_NSTR
        x = k4_inputs(nstr, m)
        jang = JS.make_static_angles(nstr, nstr, m)
        j = {k: jnp.asarray(v, jnp.float32) for k, v in x.items()}
        kw = {}
        if m == 0:
            kw = dict(fbeam=j["fbeam"], mur=j["mur"],
                      lam0=JL.lepoly(j["mu0"], 0, jang.lam_tables.shape[0] - 1))
        res = PK.fused_homogeneous_thermal(
            j["ssa"], j["pmom"], j["dtau"], j["btop"], j["slope"], jang,
            thermal=m == 0, block=(8, 8), interpret=True, **kw)
        put(f"k4_m{m}", x)
        put(f"k4_m{m}", {f"out{i}": r for i, r in enumerate(res)})
        print(f"K4 nstr {nstr} m {m}: {time.perf_counter() - t0:.0f} s",
              flush=True)

    # a solve's BVP inputs through JAX's XLA solver.solve_bvp (eagerly),
    # in float32 and float64
    for nstr in (32, 18) if "bvp" in args.parts else ():
        b = bvp_inputs(nstr)
        for dt in (jnp.float32, jnp.float64):
            j = {k: jnp.asarray(v, dt) for k, v in b.items()}
            sol = JS.LayerSolution(j["lam"], j["gp"], j["gm"], j["expd"])
            with jax.disable_jit():
                a, bb = JS.solve_bvp(sol, j["ptop_p"], j["ptop_m"], j["pbot_p"],
                                     j["pbot_m"], j["ftop"], j["bot_rhs"],
                                     j["albedo"],
                                     JS.make_static_angles(nstr, nstr, 0))
            tag = "f32" if dt == jnp.float32 else "f64"
            put(f"bvp_xla{nstr}_{tag}", dict(b, a=a, b=bb))
        print(f"solve_bvp (XLA) nstr {nstr}: "
              f"{time.perf_counter() - t0:.0f} s", flush=True)

    if "forward" in args.parts:
        opts, prop, bc, temf = forward_case()
        ds = Disort(DisortOptions(kernel="xla", **opts))
        with jax.disable_jit():
            flux = ds.forward(jnp.asarray(prop),
                              {k: jnp.asarray(v) for k, v in bc.items()},
                              jnp.asarray(temf))
        put("forward", dict(prop=prop, temf=temf, flux=flux,
                            **{f"bc_{k}": v for k, v in bc.items()}))
        print(f"forward nstr 32: {time.perf_counter() - t0:.0f} s",
              flush=True)

    if "intensities" in args.parts:
        opts, prop, bc = intensity_case()
        ds = Disort(DisortOptions(kernel="xla", **opts))
        with jax.disable_jit():
            res = ds.intensities(jnp.asarray(prop),
                                 {k: jnp.asarray(v) for k, v in bc.items()})
        put("intensities", dict(prop=prop, uu=res["uu"], flux=res["flux"],
                                **{f"bc_{k}": v for k, v in bc.items()}))
        print(f"intensities nstr 32: {time.perf_counter() - t0:.0f} s",
              flush=True)

    args.out.parent.mkdir(parents=True, exist_ok=True)
    np.savez_compressed(args.out, **out)
    print(f"wrote {args.out} ({args.out.stat().st_size} bytes)")


if __name__ == "__main__":
    main()
