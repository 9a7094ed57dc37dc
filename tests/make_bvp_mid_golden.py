#!/usr/bin/env python3
"""Pin the JAX package's Pallas BVP (K2 + K5, ``solve_bvp_pallas`` in
interpret mode, float32) at nstr 10 and 12, where its interpret-mode
compile takes minutes on a CPU.

    JAX_PLATFORMS=cpu python3 tests/make_bvp_mid_golden.py [--nstr 10 12] [--out F]

For each nstr it builds a beam-and-moments solve's BVP inputs with JAX's
XLA solver (``tests/test_torch_scattering_kernels._bvp``: L = 11, B = 16,
float32) and stores them beside ``solve_bvp_pallas``'s (a, b) in
``tests/golden/bvp_mid_pallas.npz`` (or ``--out``), which
``tests/test_torch_k2_halfwarp.py`` holds the port's plain K2 + K5 to;
the entries of the nstr it does not run are kept, and the file is written
after each nstr.  Not a test: the interpret-mode solve took 185-208 s and
~7 GB on a CPU at nstr 10 and 2,126 s and ~17 GB at nstr 12; at nstr 14
it held 37 GB after 25 minutes without finishing, so nstr 14 is not
pinned (the port's plain K2 + K5 meet JAX's XLA solver there in the
test).  ``--nstr`` runs a subset, one compile a process.
"""

from __future__ import annotations

import argparse
import sys
import time
from pathlib import Path

import numpy as np

REPO = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(REPO)]
OUT = REPO / "tests" / "golden" / "bvp_mid_pallas.npz"
NSTR = (10, 12)
# _bvp's arguments after ``sol``, in order
RHS = ("ptop_p", "ptop_m", "pbot_p", "pbot_m", "ftop", "bot_rhs", "albedo")


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", type=Path, default=OUT)
    ap.add_argument("--nstr", type=int, nargs="+", default=list(NSTR))
    args = ap.parse_args()
    assert set(args.nstr) <= set(NSTR), args.nstr

    from pyharp_tpu.rt.disort import pallas_kernels as PK
    from tests.test_torch_scattering_kernels import _bvp

    pins = dict(np.load(args.out)) if args.out.exists() else {}
    for nstr in args.nstr:
        t0 = time.perf_counter()
        bvp = _bvp(nstr, 11, 16, seed=nstr, dtype=np.float32)
        a, b = PK.solve_bvp_pallas(*bvp, block_b=16, interpret=True)
        sol = bvp[0]
        for k in ("gp", "gm", "expd"):
            pins[f"nstr{nstr}_{k}"] = np.asarray(getattr(sol, k))
        for k, v in zip(RHS, bvp[1:8]):
            pins[f"nstr{nstr}_{k}"] = np.asarray(v)
        pins[f"nstr{nstr}_a"] = np.asarray(a)
        pins[f"nstr{nstr}_b"] = np.asarray(b)
        args.out.parent.mkdir(parents=True, exist_ok=True)
        np.savez_compressed(args.out, **pins)
        print(f"nstr {nstr}: {time.perf_counter() - t0:.1f} s, wrote "
              f"{args.out}", flush=True)


if __name__ == "__main__":
    main()
