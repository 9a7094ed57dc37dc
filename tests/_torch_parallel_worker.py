"""One rank of ``tests/test_torch_parallel.py``'s two-rank gloo run: the
sharded forward and band flux of :func:`problem` on the (2, 1) and (1, 2)
meshes, written with ``checkpoint.save_array_sharded`` for the test to
assemble, and the refusals each rank sees, in ``<out>/refusals.json``."""

from __future__ import annotations

import json

import numpy as np
import torch

NWAVE, NCOL, NLYR, NSTR = 4, 4, 6, 4
MESHES = ((2, 1), (1, 2))
# distinct per-bin edges: a rank integrating Planck over other bins' edges
# gives another answer
WAVE_EDGES = (10.0, 250.0, 600.0, 1100.0, 2000.0)


def problem() -> dict:
    """The global inputs as float64 numpy, and the Disort options' fields:
    thermal (per-bin edges), a beam and one phase moment."""
    rng = np.random.default_rng(17)
    prop = np.zeros((NWAVE, NCOL, NLYR, 3))
    prop[..., 0] = rng.uniform(0.01, 1.0, (NWAVE, NCOL, NLYR))
    prop[..., 1] = rng.uniform(0.1, 0.9, (NWAVE, NCOL, NLYR))
    prop[..., 2] = rng.uniform(0.0, 0.5, (NWAVE, NCOL, NLYR))
    bc = dict(fbeam=rng.uniform(1.0, 3.0, (NWAVE, NCOL)), umu0=0.6,
              albedo=rng.uniform(0.0, 0.5, (NWAVE, NCOL)),
              btemp=rng.uniform(260.0, 320.0, (NWAVE, NCOL)))
    temf = rng.uniform(180.0, 320.0, (NCOL, NLYR + 1))
    weights = rng.uniform(0.1, 1.0, NWAVE)
    options = dict(flags="lamber,quiet,onlyfl,planck", nwave=NWAVE,
                   ncol=NCOL, nlyr=NLYR, nstr=NSTR, nmom=NSTR,
                   wave_lower=WAVE_EDGES[:-1], wave_upper=WAVE_EDGES[1:])
    return dict(prop=prop, bc=bc, temf=temf, weights=weights,
                options=options)


def _refusal(fn) -> str:
    try:
        fn()
    except ValueError as e:
        return str(e)
    return ""


def run(rank: int, n: int, out: str) -> None:
    from pyharp_tpu_torch.parallel import (make_radiation_mesh,
                                           shard_band_inputs,
                                           sharded_band_flux, sharded_forward)
    from pyharp_tpu_torch.rt import Disort, DisortOptions
    from pyharp_tpu_torch.utils import checkpoint

    p = problem()
    t = torch.tensor
    prop, temf, weights = t(p["prop"]), t(p["temf"]), t(p["weights"])
    bc = {k: t(v) if isinstance(v, np.ndarray) else v
          for k, v in p["bc"].items()}
    disort = Disort(DisortOptions(**p["options"], kernel="torch"))
    flux_spec = ("wave", "col", None, None)
    for n_col, n_wave in MESHES:
        mesh = make_radiation_mesh(n_col, n_wave)
        tag = f"{n_col}x{n_wave}"
        flux = sharded_forward(disort, mesh, prop, bc, temf)
        checkpoint.save_array_sharded(f"{out}/forward_{tag}", flux, mesh,
                                      flux_spec)
        bflx = sharded_band_flux(disort, mesh, prop, bc, weights, temf)
        checkpoint.save_array_sharded(f"{out}/band_{tag}", bflx, mesh,
                                      ("col", None, None))
        # every wave shard handed the first shard's edges
        nwl = NWAVE // n_wave
        lo, hi = np.asarray(WAVE_EDGES[:-1]), np.asarray(WAVE_EDGES[1:])
        wrong = dict(bc, wvnmlo=t(np.tile(lo[:nwl], n_wave)),
                     wvnmhi=t(np.tile(hi[:nwl], n_wave)))
        checkpoint.save_array_sharded(
            f"{out}/wrong_edges_{tag}",
            sharded_forward(disort, mesh, prop, wrong, temf), mesh, flux_spec)
        conc = t(np.arange(NCOL * NLYR * 2, dtype=np.float64).reshape(
            NCOL, NLYR, 2))
        atm = dict(temp=temf[:, :-1], wavenumber=t(np.asarray(lo)))
        conc_l, _, bc_l, atm_l = shard_band_inputs(mesh, conc, 1.0, bc, atm)
        for name, x, spec in (("conc", conc_l, ("col", None, None)),
                              ("albedo", bc_l["albedo"], ("wave", "col")),
                              ("temp", atm_l["temp"], ("col", None)),
                              ("wavenumber", atm_l["wavenumber"], ("wave",))):
            checkpoint.save_array_sharded(f"{out}/{name}_{tag}", x, mesh,
                                          spec)
        assert bc_l["umu0"] == bc["umu0"]
    refusals = dict(
        mesh_size=_refusal(lambda: make_radiation_mesh(2, 2)),
        uneven=_refusal(lambda: sharded_forward(
            disort, make_radiation_mesh(2, 1), prop[:, :3], bc, temf)))
    if rank == 0:
        with open(f"{out}/refusals.json", "w") as f:
            json.dump(refusals, f)
