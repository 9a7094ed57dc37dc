#!/usr/bin/env python3
"""Pin the JAX package's answers at 66 to 128 streams, where JAX is too slow
on a CPU to run inside the tests.

    JAX_PLATFORMS=cpu python3 tests/make_stream128_golden.py [--parts ...] [--out F]

The cases are ``tests/make_stream64_golden.py``'s (``forward_case``,
``intensity_case``), run the same way: JAX's ``kernel="xla"`` path in
float64, eagerly, the answers stored beside the inputs:

* ``Disort.forward`` at nstr 66 and 128;
* ``Disort.intensities`` at nstr 66.

It writes ``tests/golden/stream128_jax.npz`` (or ``--out``), keeping the
entries of the parts it does not run, which ``tests/test_torch_stream128.py``
holds the port to.  Not a test: each part takes tens of minutes on a CPU;
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

from tests.make_stream64_golden import forward_case, intensity_case  # noqa: E402

OUT = REPO / "tests" / "golden" / "stream128_jax.npz"
FORWARD_NSTR = (66, 128)
INTENSITY_NSTR = (66,)
PARTS = (tuple(f"forward{n}" for n in FORWARD_NSTR)
         + tuple(f"intensities{n}" for n in INTENSITY_NSTR))


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
    for nstr in FORWARD_NSTR:
        if f"forward{nstr}" not in args.parts:
            continue
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
    for nstr in INTENSITY_NSTR:
        if f"intensities{nstr}" not in args.parts:
            continue
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
