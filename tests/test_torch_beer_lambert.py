"""The port's Beer-Lambert solver and a ``Radiation`` with a Beer-Lambert
band against the JAX package, on the same numpy inputs drawn from a seed.

Tolerances, in float64: ``toa_radiance`` 1e-12 of max|I| (the same
trapezoid sums; ``gammaincc`` and ``lgamma`` of two libraries may differ
in the last bits); ``BeerLambert.forward`` and ``Radiation.forward``
1e-10 of max|flux|, as the Disort paths are held (the layer recurrence is
a scan in JAX and a loop here, in the same order).
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pyharp_tpu.opacity.base import AttenuatorOptions as JAttOptions
from pyharp_tpu.radiation import band as JB
from pyharp_tpu.radiation import factory as JFac
from pyharp_tpu.radiation import radiation as JRad
from pyharp_tpu.rt import beer_lambert as jbl
from pyharp_tpu.rt.disort.disort import DisortOptions as JDisortOptions
from pyharp_tpu.tables.rfm import write_rfm_table

from pyharp_tpu_torch import convert
from pyharp_tpu_torch.radiation import (Radiation, RadiationBand,
                                        create_radiation_options)
from pyharp_tpu_torch.radiation.band import BeerLambertOptions as BandBLO
from pyharp_tpu_torch.rt import beer_lambert as tbl

F64 = torch.float64


def _close(got, want, rel):
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    want = np.asarray(want)
    assert got.shape == want.shape
    assert np.isfinite(got).all()
    err = np.abs(got - want).max()
    assert err <= rel * np.abs(want).max(), (err, np.abs(want).max())


@pytest.mark.parametrize("alpha", [0.0, 0.5])
def test_toa_radiance_f64(alpha):
    rng = np.random.default_rng(7)
    tau = rng.uniform(0.0, 0.4, (3, 4, 10))          # top-down
    tau[0, 0] *= 1e4                                  # t_surf above 1000
    source = rng.uniform(1.0, 5.0, (3, 4, 11))
    mu = np.array([0.2, 0.55, 1.0])
    got = tbl.toa_radiance(torch.tensor(tau), torch.tensor(source),
                           torch.tensor(mu), alpha=alpha)
    want = jbl.toa_radiance(jnp.asarray(tau), jnp.asarray(source),
                            jnp.asarray(mu), alpha=alpha)
    assert got.shape == (3, 4, 3)
    _close(got, want, 1e-12)


CASES = {
    "no_source": dict(temf=False, edges=False, beam=False),
    "thermal_edges_beam": dict(temf=True, edges=True, beam=True),
    "thermal_total": dict(temf=True, edges=False, beam=False),
    "beam_only": dict(temf=False, edges=False, beam=True),
}


@pytest.mark.parametrize("case", list(CASES))
def test_forward_f64(case):
    """Level fluxes ``(nwave, ncol, nlyr+1, 2)`` of 3 bins x 4 columns x 10
    layers, nstr 4: the attenuated beam, thermal emission (band-integrated
    per bin with edges, sigma T^4 / pi without) and a Lambertian surface."""
    c = CASES[case]
    nwave, ncol, nlyr = 3, 4, 10
    rng = np.random.default_rng(11)
    prop = np.zeros((nwave, ncol, nlyr, 2))
    prop[..., 0] = rng.uniform(0.001, 1.5, (nwave, ncol, nlyr))
    prop[..., 1] = rng.uniform(0.0, 0.9, (nwave, ncol, nlyr))   # ignored
    bc = dict(albedo=rng.uniform(0.0, 0.6, (nwave, ncol)),
              btemp=rng.uniform(250.0, 320.0, (nwave, ncol)))
    if c["beam"]:
        bc.update(fbeam=rng.uniform(1.0, 3.0, (nwave, ncol)),
                  umu0=rng.uniform(0.3, 1.0, (nwave, ncol)))
    temf = rng.uniform(180.0, 320.0, (ncol, nlyr + 1)) if c["temf"] else None
    edges = (dict(wave_lower=(10.0, 300.0, 700.0),
                  wave_upper=(300.0, 700.0, 1500.0)) if c["edges"] else {})
    want = jbl.BeerLambert(jbl.BeerLambertOptions(nstr=4, **edges)).forward(
        jnp.asarray(prop), {k: jnp.asarray(v) for k, v in bc.items()},
        None if temf is None else jnp.asarray(temf))
    got = tbl.BeerLambert(tbl.BeerLambertOptions(nstr=4, **edges)).forward(
        torch.tensor(prop), {k: torch.tensor(v) for k, v in bc.items()},
        None if temf is None else torch.tensor(temf))
    assert got.dtype == F64 and got.shape == (nwave, ncol, nlyr + 1, 2)
    if case == "no_source":
        assert not got.any()
    else:
        _close(got, want, 1e-10)


def _radiation_options(tmp_path):
    """``tests/test_band.py:540-588``'s four bands for both packages: two
    fusable beam Disort bands of different nprop, a planck Disort band and
    a Beer-Lambert band, over one 3-bin line-by-line table."""
    nw = 3
    path = str(tmp_path / "grp-lbl-B1.nc")
    write_rfm_table(path, np.array([2500.0, 3500.0, 4500.0]),
                    np.logspace(5, 2, 6), np.linspace(-50, 50, 5),
                    np.linspace(300, 150, 6),
                    {"CO2": np.full((nw, 6, 5), -2.0)})
    common = dict(species_names=("CO2", "S8"),
                  species_weights=(44.0e-3, 256.0e-3))
    op_aer = JAttOptions(species_ids=(1,), type="s8_fuller",
                         opacity_files=("s8_k_fuller.txt",), **common)
    op_gas = JAttOptions(species_ids=(0,), type="rfm", opacity_files=(path,),
                         **common)

    def mk(name, **kw):
        return JB.RadiationBandOptions(
            name=name, nlyr=4, ncol=2,
            wave_lower=tuple(2000.0 + 1000.0 * i for i in range(nw)),
            wave_upper=tuple(3000.0 + 1000.0 * i for i in range(nw)),
            wavenumber=tuple(2500.0 + 1000.0 * i for i in range(nw)), **kw)

    beam = JDisortOptions(flags="lamber,quiet,onlyfl", nstr=4, nmom=4)
    bands = (
        mk("b1", attenuators=(("gas", op_gas),), disort=beam),
        mk("b2", attenuators=(("gas", op_gas), ("aer", op_aer)), disort=beam),
        mk("b3", attenuators=(("gas", op_gas),), disort=beam.replace(
            flags="lamber,quiet,onlyfl,planck")),
        mk("b4", attenuators=(("gas", op_gas),), solver_name="beer_lambert",
           beer_lambert=jbl.BeerLambertOptions(nstr=4)),
    )
    ro = JRad.RadiationOptions(bands=("b1", "b2", "b3", "b4"),
                               band_options=bands)
    return ro, convert.radiation_options_from_state(dataclasses.asdict(ro))


@pytest.mark.parametrize("fuse", [False, True])
def test_radiation_with_a_beer_lambert_band(tmp_path, fuse):
    """The total and every band's flux against JAX (float64, 1e-10); fused,
    only b1 + b2 share a solve and the Beer-Lambert band is solved alone."""
    jro, tro = _radiation_options(tmp_path)
    assert isinstance(tro.band_options[3].beer_lambert, BandBLO)
    jrad = JRad.Radiation(jro, dtype=jnp.float64)
    trad = Radiation(tro, dtype=F64, device="cpu")
    assert isinstance(trad.bands["b4"].rtsolver, tbl.BeerLambert)
    assert trad.bands["b4"].rtsolver.options.wave_lower == \
        jro.band_options[3].wave_lower
    assert trad.bands["b4"].bins_are_integrated
    rng = np.random.default_rng(4)
    conc = rng.uniform(0.5e-3, 1.5e-3, (2, 4, 2))
    dz = np.full((4,), 500.0)
    atm = dict(pres=rng.uniform(2e4, 1e5, (2, 4)),
               temp=rng.uniform(220.0, 300.0, (2, 4)))
    bc = dict(fbeam=2.0, umu0=0.7, albedo=0.2, btemp=270.0)
    want, jaux = jrad.forward(jnp.asarray(conc), jnp.asarray(dz), bc,
                              {k: jnp.asarray(v) for k, v in atm.items()},
                              return_aux=True)
    got, taux = trad.forward(torch.tensor(conc), torch.tensor(dz), bc,
                             {k: torch.tensor(v) for k, v in atm.items()},
                             return_aux=True, fuse_bands=fuse)
    _close(got, want, 1e-10)
    assert set(taux) == set(jaux)
    for k in jaux:
        _close(taux[k], jaux[k], 1e-10)
    if fuse:
        (key, ds), = trad._fused_solvers.items()
        assert ds.options.nwave == 6
    with pytest.raises(ValueError, match="requires the Disort solver"):
        trad.bands["b4"].band_radiance(None, None, {})


def test_factory_beer_lambert_reaches_the_band(tmp_path):
    """``rt-solver: BeerLambert`` in a YAML band builds a Beer-Lambert band,
    with the same options as the JAX factory's."""
    node = {
        "opacity-sources": [{"name": "grey", "class": "Grey",
                             "data": "none"}],
        "bands": ["lw"],
        "lw": {"wavenumber-range": [10.0, 2000.0], "grid-type": "regular",
               "resolution": 500.0, "opacity": ["grey"],
               "rt-solver": "BeerLambert", "flags": ["thermal_emission"]},
    }
    species = {"grey": (0, 44.0e-3)}
    want = JFac.create_radiation_options(node, species, nlyr=4, ncol=2)
    got = create_radiation_options(node, species, nlyr=4, ncol=2)
    assert got.band_options[0].solver_name == "beer_lambert"
    assert convert.radiation_options_from_state(
        dataclasses.asdict(want)) == got
    band = RadiationBand(got.band_options[0].replace(name="lw"), dtype=F64,
                         device="cpu")
    assert isinstance(band.rtsolver, tbl.BeerLambert)
