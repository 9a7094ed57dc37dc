#!/usr/bin/env python3
"""Pin the JAX package's float64 answers on the radiance-path test cases.

    JAX_PLATFORMS=cpu python3 tests/make_intensity_golden.py

For each case of ``tests/intensity_cases.py`` it runs the JAX package's
``Disort.intensities`` (or ``albedo_transmissivity``) with ``kernel="xla"``
in float64 on the CPU and stores ``uu``, ``uum`` and ``flux`` (``albmed``,
``trnmed``); for two cases also ``forward`` and its ``fluxes()``
accessor; the m >= 1 stage 1 of ``k4_modes_inputs`` at nstr 4 and 8
(``solver.homogeneous_solution_t`` and ``beam_particular_t``, as
``Disort._modes_batched`` calls them); and ``Radiation.band_radiances`` on
``band_case``.  It writes ``tests/golden/intensity_jax_f64.npz``, which
``tests/test_torch_intensity.py`` holds the port to.  Not a test: JAX's
eager radiance path compiles every operation of every case, some minutes.
"""

from __future__ import annotations

import sys
from pathlib import Path

import numpy as np

REPO = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(REPO), str(REPO / "tests")]
OUT = REPO / "tests" / "golden" / "intensity_jax_f64.npz"


def main() -> None:
    import jax

    jax.config.update("jax_enable_x64", True)
    import jax.numpy as jnp

    import intensity_cases as C
    from pyharp_tpu.radiation import Radiation, RadiationOptions
    from pyharp_tpu.rt.disort import solver as S
    from pyharp_tpu.rt.disort.disort import Disort, DisortOptions
    from tests.test_band import aerosol_band_options

    out = {}
    for name in C.CASES:
        c = C.case(name)
        ds = Disort(DisortOptions(kernel="xla", **c["opts"]))
        prop = jnp.asarray(c["prop"])
        if c["call"] == "albedo_transmissivity":
            res = ds.albedo_transmissivity(prop, c["bc"]["albedo"])
            keys = ("albmed", "trnmed")
        else:
            bc = {k: jnp.asarray(v) for k, v in c["bc"].items()}
            temf = None if c["temf"] is None else jnp.asarray(c["temf"])
            res = ds.intensities(prop, bc, temf)
            keys = ("uu", "uum", "flux")
            if name in ("spher_beam", "isotropic_beam"):
                res = dict(res, forward=ds.forward(prop, bc, temf))
                res.update(zip(("flup", "rfldn", "rfldir"), ds.fluxes()))
                keys += ("forward", "flup", "rfldn", "rfldir")
        for k in keys:
            out[f"{name}__{k}"] = np.asarray(res[k])
        print(name, flush=True)

    for nstr in (4, 8):
        x = C.k4_modes_inputs(nstr)
        ssa, pmom, dtau = (jnp.asarray(x[k]) for k in ("ssa", "pmom", "dtau"))
        fbeam, mu0 = jnp.asarray(x["fbeam"]), jnp.asarray(x["mu0"])
        ang0 = S.make_static_angles(nstr, nstr, 0)
        G = ang0.lam_tables.shape[0]
        ls = np.arange(G)
        for m in range(1, nstr):
            angm = S.make_static_angles(nstr, nstr, m)
            even, odd = S._phase_outer_tables(angm, np.float64)
            keep = jnp.asarray(((ls >= m) & (ls <= nstr - 1)).astype(float))
            sol, V, U = S.homogeneous_solution_t(
                ssa, pmom, dtau, ang0.mu, ang0.w, jnp.asarray(even),
                jnp.asarray(odd), keep)
            zp, zm = S.beam_particular_t(
                sol, V, U, ssa, pmom, fbeam, mu0, ang0.mu,
                jnp.asarray(angm.lam_tables), jnp.asarray(angm.parity), keep,
                S.lepoly(mu0, m, G - 1), 1.0 / (2.0 * np.pi))
            for k, v in zip(("lam", "gp", "gm", "zp", "zm"),
                            (sol.lam, sol.gp, sol.gm, zp, zm)):
                out[f"k4_nstr{nstr}_m{m}__{k}"] = np.asarray(v)
    print("k4 modes", flush=True)

    b = C.band_case()
    bop = aerosol_band_options(nwave=b["nwave"], ncol=b["ncol"],
                               nlyr=b["nlyr"])
    bop = bop.replace(outdirs=b["outdirs"], wavenumber=b["wavenumber"],
                      disort=bop.disort.replace(flags=b["flags"], nstr=4,
                                                nmom=4, kernel="xla"))
    rad = Radiation(RadiationOptions(bands=("sw",), band_options=(bop,)),
                    dtype=jnp.float64)
    rads = rad.band_radiances(jnp.asarray(b["conc"]), jnp.asarray(b["dz"]),
                              {k: jnp.asarray(v) for k, v in b["bc"].items()})
    out["band__sw"] = np.asarray(rads["sw"])
    print("band radiances", flush=True)

    OUT.parent.mkdir(exist_ok=True)
    np.savez_compressed(OUT, **out)
    print(f"wrote {OUT.relative_to(REPO)}: {len(out)} arrays")


if __name__ == "__main__":
    main()
