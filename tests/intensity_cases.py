"""Inputs of the radiance-path parity tests (``tests/test_torch_intensity.py``)
and of the script that pins the JAX package's answers on them
(``tests/make_intensity_golden.py``).

Each case is a small problem (nstr 4, one at nstr 8; L <= 6; 2 waves x 2
columns) drawn from a numpy seed around a case of the JAX package's own
tests: ``tests/test_intensity.py`` (node angles, higher modes, a user tau
inside a thick layer, the azimuth of thin-layer single scattering, the
isotropic phase), ``tests/test_ims.py`` (TMS + IMS),
``tests/test_disort_features.py`` (``ibcnd``), plus ``spher`` with a beam,
thermal sources with a ``general_source``, and a thermal problem without a
beam.  Numpy only: the test imports it without JAX.
"""

from __future__ import annotations

import numpy as np

NWAVE, NCOL = 2, 2


def _prop(rng, dtau, ssa, moments):
    """(nwave, ncol, nlyr, 2 + nmom) bottom-up from top-down per-layer
    values, each column's depths and albedos jittered by up to 10%."""
    dtau = np.asarray(dtau, np.float64)
    ssa = np.asarray(ssa, np.float64) * np.ones_like(dtau)
    nlyr = dtau.shape[0]
    moments = np.zeros((nlyr, 0)) if moments is None else np.atleast_2d(moments)
    nmom = moments.shape[1]
    prop = np.zeros((NWAVE, NCOL, nlyr, 2 + nmom))
    tau = dtau * rng.uniform(0.9, 1.1, (NWAVE, NCOL, nlyr))
    w = np.minimum(ssa * rng.uniform(0.9, 1.1, (NWAVE, NCOL, nlyr)), 1.0)
    prop[..., 0] = tau[..., ::-1]
    prop[..., 1] = w[..., ::-1]
    prop[..., 2:] = moments[::-1]
    return prop


def _beam(rng, f0, mu0, albedo):
    return dict(fbeam=np.full((NWAVE, NCOL), f0),
                umu0=rng.uniform(mu0 - 0.05, mu0 + 0.05, (NWAVE, NCOL)),
                albedo=np.full((NWAVE, NCOL), albedo),
                phi0=rng.uniform(0.0, 0.5, (NWAVE, NCOL)))


def _hg(g, n):
    return g ** np.arange(1, n + 1)


def case(name: str) -> dict:
    """``dict(opts, prop, bc, temf, call)``: the DisortOptions fields, the
    inputs as numpy float64, and ``"intensities"`` or
    ``"albedo_transmissivity"``."""
    rng = np.random.default_rng(sum(map(ord, name)))
    temf = None
    call = "intensities"
    base = dict(nwave=NWAVE, ncol=NCOL)
    if name == "node_angle":
        nstr, L = 4, 3
        prop = _prop(rng, [0.2, 0.5, 1.0], 0.7, np.full((L, 1), 0.3))
        bc = _beam(rng, np.pi, 0.6, 0.3)
        opts = dict(flags="lamber,quiet,usrang", nstr=nstr, nmom=nstr)
    elif name == "higher_modes":
        nstr, L = 8, 2
        prop = _prop(rng, [0.3, 0.8], [0.85, 0.5],
                     np.tile(_hg(0.6, 7), (L, 1)))
        bc = _beam(rng, 2.0, 0.55, 0.0)
        opts = dict(flags="lamber,quiet,usrang", nstr=nstr, nmom=nstr)
    elif name == "user_tau_thick":
        nstr, L = 4, 2
        prop = _prop(rng, [5.0, 1.0], [0.8, 0.6],
                     np.tile(_hg(0.5, 3), (L, 1)))
        bc = _beam(rng, np.pi, 0.6, 0.3)
        opts = dict(flags="lamber,quiet,usrang,usrtau", nstr=nstr, nmom=3,
                    user_mu=(-0.9, -0.3, 0.2, 0.7),
                    user_tau=(0.0, 1.7, 2.5, 4.9, 5.0, 5.5, 6.0))
    elif name == "azimuth":
        nstr, L = 4, 2
        prop = _prop(rng, [2e-4, 3e-4], 0.9, np.tile(_hg(0.5, 3), (L, 1)))
        bc = _beam(rng, np.pi, 0.7, 0.0)
        opts = dict(flags="lamber,quiet,usrang", nstr=nstr, nmom=3,
                    user_mu=(0.35, 0.8), user_phi=(0.0, np.pi / 3, np.pi))
    elif name == "isotropic_beam":
        nstr, L = 4, 3
        prop = _prop(rng, [0.5, 0.2, 0.9], 0.8, None)
        bc = _beam(rng, np.pi, 0.6, 0.2)
        opts = dict(flags="lamber,quiet,usrang", nstr=nstr, nmom=nstr,
                    user_mu=(-0.5, 0.5), user_phi=(0.0, 1.0, 2.5))
    elif name == "thermal_no_beam":
        nstr, L = 4, 4
        prop = _prop(rng, [0.1, 0.4, 0.8, 0.3], 0.5,
                     np.tile(_hg(0.6, 4), (L, 1)))
        bc = dict(albedo=np.full((NWAVE, NCOL), 0.2),
                  btemp=np.full((NWAVE, NCOL), 290.0))
        temf = np.broadcast_to(np.linspace(200.0, 290.0, L + 1),
                               (NCOL, L + 1)).copy()
        opts = dict(flags="lamber,quiet,usrang,usrtau,planck", nstr=nstr,
                    nmom=nstr, user_mu=(-0.7, 0.3, 0.9), user_phi=(0.0, 2.0),
                    user_tau=(0.05, 0.9, 1.6), wave_lower=(100.0, 300.0),
                    wave_upper=(300.0, 700.0))
    elif name in ("tms_ims", "tms_ims_usrtau"):
        nstr, L, nmom = 4, 4, 16
        prop = _prop(rng, np.full(L, 0.25), 0.9,
                     np.tile(_hg(0.7, nmom), (L, 1)))
        bc = _beam(rng, np.pi, 0.8, 0.1)
        if name == "tms_ims":
            opts = dict(flags="lamber,quiet,usrang,intensity_correction",
                        nstr=nstr, nmom=nmom, user_mu=(-0.8, -0.6, 0.5),
                        user_phi=(0.0, 1.0))
        else:
            opts = dict(flags="lamber,quiet,usrang,usrtau,"
                        "old_intensity_correction", nstr=nstr, nmom=nmom,
                        user_mu=(-0.8, -0.6, 0.5, 0.9), user_phi=(0.3, 2.0),
                        user_tau=(0.1, 0.6, 1.0))
    elif name == "spher_beam":
        nstr, L = 4, 5
        prop = _prop(rng, [0.05, 0.1, 0.3, 0.5, 0.8], 0.85,
                     np.tile(_hg(0.75, 8), (L, 1)))
        bc = _beam(rng, np.pi, 0.35, 0.2)
        bc["h_lev"] = np.broadcast_to(np.linspace(0.0, 80e3, L + 1),
                                      (NCOL, L + 1)).copy()
        bc["radius"] = np.full((NWAVE, NCOL), 3.4e6)
        opts = dict(flags="lamber,quiet,usrang,usrtau,spher,"
                    "intensity_correction", nstr=nstr, nmom=8,
                    user_mu=(-0.6, 0.4, 0.8), user_phi=(0.0, 1.2),
                    user_tau=(0.02, 0.7, 1.5))
    elif name == "thermal_gensrc":
        nstr, L = 4, 3
        prop = _prop(rng, [0.3, 0.6, 0.2], 0.6, np.tile(_hg(0.4, 4), (L, 1)))
        bc = _beam(rng, 2.0, 0.5, 0.3)
        bc["btemp"] = np.full((NWAVE, NCOL), 280.0)
        bc["gensrc"] = rng.uniform(0.0, 1.0, (NWAVE, NCOL, L, nstr))
        temf = np.broadcast_to(np.linspace(210.0, 280.0, L + 1),
                               (NCOL, L + 1)).copy()
        opts = dict(flags="lamber,quiet,usrang,usrtau,planck,general_source",
                    nstr=nstr, nmom=nstr, user_mu=(-0.5, 0.6),
                    user_tau=(0.2, 0.95))
    elif name == "ibcnd":
        nstr, L = 4, 4
        prop = _prop(rng, np.full(L, 0.5), 0.95, np.tile(_hg(0.3, 4), (L, 1)))
        bc = dict(albedo=0.1)
        opts = dict(flags="lamber,quiet,ibcnd", nstr=nstr, nmom=nstr,
                    user_mu=(0.2, 0.5, 0.9))
        call = "albedo_transmissivity"
    else:
        raise KeyError(name)
    opts = dict(base, nlyr=prop.shape[2], **opts)
    return dict(opts=opts, prop=prop, bc=bc, temf=temf, call=call)


CASES = ("node_angle", "higher_modes", "user_tau_thick", "azimuth",
         "isotropic_beam", "thermal_no_beam", "tms_ims", "tms_ims_usrtau",
         "spher_beam", "thermal_gensrc", "ibcnd")
# cases whose modes m >= 1 carry no source: no beam, or no phase moment
SOURCELESS_MODES = ("isotropic_beam", "thermal_no_beam")


def k4_modes_inputs(nstr: int, L: int = 3, B: int = 4, seed: int = 5):
    """Stage-1 inputs of the modes m >= 1 (``(L, B)`` / ``(L, nmom, B)``,
    top-down, delta-M scaled Henyey-Greenstein moments with g = 0.8, a
    beam), as numpy: ssa, pmom, dtau, fbeam ``(B,)``, mu0 ``(B,)``."""
    rng = np.random.default_rng(seed + nstr)
    gl = 0.8 ** np.arange(1, nstr + 1)
    pm = (gl - gl[-1]) / (1.0 - gl[-1])
    return dict(ssa=rng.uniform(0.05, 0.99, (L, B)),
                pmom=np.broadcast_to(pm[None, :, None], (L, nstr, B)).copy(),
                dtau=rng.uniform(0.01, 2.0, (L, B)),
                fbeam=rng.uniform(0.5, 4.0, B), mu0=rng.uniform(0.2, 1.0, B))


def band_case():
    """The band-radiance problem of ``tests/test_band.py:358-390``: the
    aerosol shortwave band (S8 + H2SO4), 4 waves, 1 column, 5 layers, two
    out-directions, nstr 4, as numpy inputs."""
    nwave, ncol, nlyr = 4, 1, 5
    return dict(nwave=nwave, ncol=ncol, nlyr=nlyr,
                outdirs="(0., 0.) (60., 30.)",
                wavenumber=tuple(np.linspace(2000.0, 50000.0, nwave)),
                flags="lamber,quiet,usrang,intensity_correction",
                conc=np.full((ncol, nlyr, 2), 1e-4),
                dz=np.full((nlyr,), 2000.0),
                bc=dict(fbeam=np.full((nwave, ncol), np.pi),
                        umu0=np.full((nwave, ncol), 0.8),
                        albedo=np.full((nwave, ncol), 0.3)))
