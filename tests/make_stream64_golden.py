#!/usr/bin/env python3
"""Pin the JAX package's answers at 34 to 64 streams, where JAX is too slow
on a CPU to run inside the tests.

    JAX_PLATFORMS=cpu python3 tests/make_stream64_golden.py [--parts ...] [--out F]

From seeded numpy inputs it runs JAX's ``kernel="xla"`` path in float64,
eagerly (``jax.disable_jit``: jitted, one Jacobi sweep at N = 32 is a
graph of ~170,000 operations), and stores the answers beside the inputs:

* ``Disort.forward`` at nstr 34 and 64 with a beam, Henyey-Greenstein
  moments and Planck emission (``forward_case``);
* ``Disort.intensities`` at nstr 34 and 64 (user angles and depths, the
  intensity correction; ``intensity_case``).

It writes ``tests/golden/stream64_jax.npz`` (or ``--out``), keeping the
entries of the parts it does not run, which ``tests/test_torch_stream64.py``
holds the port to.  Not a test: each part takes minutes on a CPU;
``--parts`` runs a subset (in parallel processes with separate ``--out``
files, merged with ``--merge``).
"""

from __future__ import annotations

import argparse
import sys
import time
from pathlib import Path

import numpy as np

REPO = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(REPO)]
OUT = REPO / "tests" / "golden" / "stream64_jax.npz"
NSTR = (34, 64)


def forward_case(nstr: int):
    """``Disort.forward``: 2 waves x 2 columns x 3 layers, beam, HG g = 0.8
    moments, Planck between 200 and 300 K."""
    nwave, ncol, nlyr = 2, 2, 3
    rng = np.random.default_rng(nstr)
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


def intensity_case(nstr: int):
    """``Disort.intensities``: 1 wave x 1 column x 2 layers,
    ``bench_extra.py``'s radiance flags and HG g = 0.7 moments, user depths
    inside the column."""
    nwave, ncol, nlyr = 1, 1, 2
    rng = np.random.default_rng(nstr + 1)
    prop = np.zeros((nwave, ncol, nlyr, 2 + nstr))
    prop[..., 0] = rng.uniform(0.05, 0.5, (nwave, ncol, nlyr))
    prop[..., 1] = rng.uniform(0.1, 0.9, (nwave, ncol, nlyr))
    prop[..., 2:] = 0.7 ** np.arange(1, nstr + 1)
    opts = dict(flags="lamber,quiet,usrang,usrtau,intensity_correction",
                nwave=nwave, ncol=ncol, nlyr=nlyr, nstr=nstr, nmom=nstr,
                user_mu=RAD_MU, user_phi=RAD_PHI, user_tau=RAD_TAU)
    bc = dict(albedo=np.full((nwave, ncol), 0.2),
              fbeam=np.full((nwave, ncol), np.pi),
              umu0=np.full((nwave, ncol), 0.7))
    return opts, prop, bc


PARTS = tuple(f"{kind}{n}" for kind in ("forward", "intensities")
              for n in NSTR)


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

    from pyharp_tpu.rt.disort.disort import Disort, DisortOptions

    out = dict(np.load(args.out)) if args.out.exists() else {}
    for f in args.merge:
        out.update(np.load(f))

    def put(prefix, d):
        for k, v in d.items():
            out[f"{prefix}__{k}"] = np.asarray(v)

    t0 = time.perf_counter()
    for nstr in NSTR:
        if f"forward{nstr}" in args.parts:
            opts, prop, bc, temf = forward_case(nstr)
            ds = Disort(DisortOptions(kernel="xla", **opts))
            with jax.disable_jit():
                flux = ds.forward(jnp.asarray(prop),
                                  {k: jnp.asarray(v) for k, v in bc.items()},
                                  jnp.asarray(temf))
            put(f"forward{nstr}", dict(prop=prop, temf=temf, flux=flux,
                                       **{f"bc_{k}": v for k, v in bc.items()}))
            print(f"forward nstr {nstr}: {time.perf_counter() - t0:.0f} s",
                  flush=True)
        if f"intensities{nstr}" in args.parts:
            opts, prop, bc = intensity_case(nstr)
            ds = Disort(DisortOptions(kernel="xla", **opts))
            with jax.disable_jit():
                res = ds.intensities(jnp.asarray(prop),
                                     {k: jnp.asarray(v) for k, v in bc.items()})
            put(f"intensities{nstr}", dict(
                prop=prop, uu=res["uu"], flux=res["flux"],
                **{f"bc_{k}": v for k, v in bc.items()}))
            print(f"intensities nstr {nstr}: {time.perf_counter() - t0:.0f} s",
                  flush=True)

    args.out.parent.mkdir(parents=True, exist_ok=True)
    np.savez_compressed(args.out, **out)
    print(f"wrote {args.out} ({args.out.stat().st_size} bytes)")


if __name__ == "__main__":
    main()
