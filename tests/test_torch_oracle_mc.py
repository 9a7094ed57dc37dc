"""The port's fluxes against the independent oracles: the counterpart of
``tests/test_oracle_mc.py``, through ``pyharp_tpu_torch``'s ``Disort`` in
float64 on the CPU (``bench.rmse_run._solver_fluxes`` and ``_solve``).

The same four cases with the same photon counts and bounds: the compiled C
Monte Carlo transport (``tests/oracle/mc.py``) at 4e6 photons, max|err|
within 5e-3 of the scale (MC's statistical error is ~1e-3 relative), for
a beam with Henyey-Greenstein scattering, thermal emission and isotropic
illumination at nstr 8; and the semi-infinite plane albedo of 32 layers of
tau 2 at nstr 16 against Chandrasekhar's H-function within 2e-3, the three
(w0, mu0) as three columns of one solve.  These hold the port to oracles
that share no code with either package.
"""

import numpy as np
import torch

from pyharp_tpu_torch.bench.rmse_run import _oracles, _solve, _solver_fluxes

# tests/oracle, with the Monte Carlo library built into place atomically
# (other test files load it at the same time)
mc, hfunction = _oracles()
mc_beam_flux, mc_isotropic_flux = mc.mc_beam_flux, mc.mc_isotropic_flux
mc_thermal_flux, plane_albedo = mc.mc_thermal_flux, hfunction.plane_albedo


def test_beam_fluxes_match_mc_hg():
    dtau = np.full(4, 0.5)
    ssa, g, albedo, mu0 = 0.9, 0.7, 0.2, 0.6
    up, dn = _solver_fluxes(dtau, ssa, g, albedo, 8, "beam", mu0=mu0)
    mup, mdn = mc_beam_flux(dtau, ssa, g, albedo, mu0, fbeam=1.0,
                            n_photons=4_000_000)
    scale = max(mdn.max(), mup.max())
    assert np.abs(up - mup).max() / scale < 5e-3
    assert np.abs(dn - mdn).max() / scale < 5e-3


def test_thermal_fluxes_match_mc():
    dtau = np.array([0.2, 0.6, 1.2, 2.0])
    ssa = 0.35
    blev = np.array([1.0, 1.4, 1.9, 2.3, 2.8])    # top-down Planck
    bsurf = 3.0
    albedo = 0.15
    up, dn = _solver_fluxes(dtau, ssa, 0.0, albedo, 8, "thermal", blev=blev,
                            bsurf=bsurf)
    mup, mdn = mc_thermal_flux(dtau, ssa, 0.0, albedo, blev, bsurf,
                               n_photons=4_000_000)
    scale = max(mup.max(), mdn.max())
    assert np.abs(up - mup).max() / scale < 5e-3
    assert np.abs(dn - mdn).max() / scale < 5e-3


def test_fisot_fluxes_match_mc():
    dtau = np.full(3, 0.8)
    ssa, albedo = 0.8, 0.3
    up, dn = _solver_fluxes(dtau, ssa, 0.0, albedo, 8, "fisot")
    mup, mdn = mc_isotropic_flux(dtau, ssa, 0.0, albedo, fisot=1.0,
                                 n_photons=4_000_000)
    scale = mdn.max()
    assert np.abs(up - mup).max() / scale < 5e-3
    assert np.abs(dn - mdn).max() / scale < 5e-3


def test_semi_infinite_plane_albedo_matches_chandrasekhar():
    cases = [(0.3, 0.5), (0.9, 0.8), (0.99, 0.2)]
    w0 = np.array([w for w, _ in cases])
    mu0 = np.array([m for _, m in cases])
    up, _ = _solve(np.full(32, 2.0), w0, 0.0, 0.0, 16,
                   dict(fbeam=1.0, umu0=mu0), dtype=torch.float64)
    for i, (w, m) in enumerate(cases):
        got = up[i, 0] / m                         # TOA up / incident
        want = plane_albedo(w, m)
        assert abs(got - want) / want < 2e-3, (w, m, got, want)
