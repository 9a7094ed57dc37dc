"""The port's YAML-driven ``Radiation`` layer against the JAX package's.

Both packages read the same synthetic NetCDF3 tables, written by
``examples/amars_yaml_torch.py``'s helpers into a temporary directory.

Tolerances, in float64:

* options from both factories, carried over by ``convert``: equal field by
  field;
* ``RadiationBand.compute_optics``: 1e-12 relative (the same accumulation
  order and epsilons);
* ``Radiation.forward`` with ``kernel="torch"`` against JAX
  ``kernel="xla"``: 1e-10 of max|flux|, per band and in total.
"""

import dataclasses
import sys
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pyharp_tpu.opacity.base import AttenuatorOptions as JAttOptions
from pyharp_tpu.radiation import band as JB
from pyharp_tpu.radiation import factory as JFac
from pyharp_tpu.radiation import radiation as JRad
from pyharp_tpu.radiation.shared import shared as jshared
from pyharp_tpu.rt.disort.disort import Disort as JDisort
from pyharp_tpu.rt.disort.disort import DisortOptions as JDisortOptions
from pyharp_tpu.utils import directions as JDir
from pyharp_tpu.utils.spherical import spherical_flux_correction as jsfc

from pyharp_tpu_torch import Disort, DisortOptions, convert
from pyharp_tpu_torch.opacity.base import AttenuatorOptions
from pyharp_tpu_torch.radiation import (Radiation, RadiationBand,
                                        RadiationBandOptions, RadiationOptions,
                                        create_radiation_options, shared)
from pyharp_tpu_torch.utils import directions as TDir
from pyharp_tpu_torch.utils.spherical import spherical_flux_correction

REPO = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO / "examples"))

import amars_yaml_torch as ay  # noqa: E402

F64 = torch.float64
NCOL, NLYR = 2, 6


@pytest.fixture(scope="module")
def nodes(tmp_path_factory):
    """The ck and lbl (resolution 10) configurations with their tables."""
    tmp = str(tmp_path_factory.mktemp("tables"))
    return {"ck": ay.ensure_tables(ay.load_node("ck"), tmp),
            "lbl": ay.ensure_tables(ay.load_node("lbl", 10.0), tmp)}


def _xla(ro):
    return ro.replace(band_options=tuple(
        b.replace(disort=b.disort.replace(kernel="xla"))
        for b in ro.band_options))


def _torch(ro):
    return ro.replace(band_options=tuple(
        b.replace(disort=b.disort.replace(kernel="torch"))
        for b in ro.band_options))


def _atmosphere(ncol=NCOL, nlyr=NLYR, seed=0):
    """conc, dz, atm as numpy: columns and layers that differ."""
    rng = np.random.default_rng(seed)
    return (rng.uniform(0.5, 1.5, (ncol, nlyr, 2)), np.full(nlyr, 1.0),
            dict(pres=rng.uniform(2e5, 1e6, (ncol, nlyr)),
                 temp=rng.uniform(200.0, 320.0, (ncol, nlyr))))


def _jax_in(conc, dz, atm):
    return (jnp.asarray(conc), jnp.asarray(dz),
            {k: jnp.asarray(v) for k, v in atm.items()})


def _torch_in(conc, dz, atm):
    return (torch.tensor(conc), torch.tensor(dz),
            {k: torch.tensor(v) for k, v in atm.items()})


def _forward(rad, inputs, bc, **kw):
    """``rad.forward(conc, dz, bc, atm, **kw)`` from ``(conc, dz, atm)``."""
    conc, dz, atm = inputs
    return rad.forward(conc, dz, bc, atm, **kw)


def _close(got, want, rel):
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    want = np.asarray(want)
    assert got.shape == want.shape
    assert np.isfinite(got).all()
    assert np.abs(got - want).max() <= rel * np.abs(want).max()


def _close_aux(got, want, rel):
    assert set(got) == set(want)
    for k in want:
        _close(got[k], want[k], rel)


# ---- factory and options ---------------------------------------------------

@pytest.mark.parametrize("config", ["ck", "lbl"])
def test_factory_options_match_jax(nodes, config):
    """The shipped configurations (lbl at its own 0.1 cm^-1) through both
    factories; the JAX options carried over by ``convert``."""
    node = nodes["ck"] if config == "ck" else ay.load_node("lbl")
    want = JFac.create_radiation_options(node, ay.SPECIES, nlyr=40, ncol=3)
    got = create_radiation_options(node, ay.SPECIES, nlyr=40, ncol=3)
    assert convert.radiation_options_from_state(
        dataclasses.asdict(want)) == got
    assert len(got.band_options[2].wave_lower) == (9501 if config == "lbl"
                                                   else 8)
    # the same YAML from a path as from the parsed dict
    if config == "lbl":
        assert create_radiation_options(ay.config_path("lbl"), ay.SPECIES,
                                        nlyr=40, ncol=3) == got


@pytest.mark.parametrize("which", ["aerosols", "gas_and_aerosol"])
def test_compute_optics_matches_jax(nodes, which):
    """Extinction, SSA and optical depth accumulated over attenuators of
    different nprop (padding), the reference's typo ``h2sO4_simple``
    included."""
    fields = dict(species_names=("CO2", "S8", "H2SO4"),
                  species_weights=(44e-3, 256e-3, 98e-3))
    atts = [("s8", dict(fields, type="s8_fuller", species_ids=(1,),
                        opacity_files=("s8_k_fuller.txt",))),
            ("h2so4", dict(fields, type="h2sO4_simple", species_ids=(2,),
                           opacity_files=("h2so4.txt",)))]
    wave = tuple(np.linspace(2000.0, 40000.0, 5))
    if which == "gas_and_aerosol":
        table = nodes["lbl"]["opacity-sources"][0]["data"]   # B1, 16 bins
        atts.insert(0, ("gas", dict(fields, type="rfm", species_ids=(0,),
                                    opacity_files=(table,))))
        wave = tuple(np.linspace(1.0, 150.0, 16))
    kw = dict(name="b", nlyr=NLYR, ncol=NCOL, wavenumber=wave,
              wave_lower=tuple(w - 1 for w in wave),
              wave_upper=tuple(w + 1 for w in wave))
    jband = JB.RadiationBand(JB.RadiationBandOptions(
        attenuators=tuple((n, JAttOptions(**f)) for n, f in atts), **kw),
        dtype=jnp.float64)
    tband = RadiationBand(RadiationBandOptions(
        attenuators=tuple((n, AttenuatorOptions(**f)) for n, f in atts),
        **kw), dtype=F64, device="cpu")
    assert tband.nmax_prop == jband.nmax_prop == 2
    _, _, atm = _atmosphere(seed=1)
    conc = np.random.default_rng(2).uniform(0.5, 1.5, (NCOL, NLYR, 3))
    dz = np.linspace(100.0, 600.0, NLYR)
    jc, jdz, jatm = _jax_in(conc * 1e-3, dz, atm)
    tc, tdz, tatm = _torch_in(conc * 1e-3, dz, atm)
    want = jband.compute_optics(jc, jdz, **jband.atm_with_spectral(jatm))
    got = tband.compute_optics(tc, tdz, **tband.atm_with_spectral(tatm))
    _close(got, want, 1e-12)


# ---- Radiation.forward -----------------------------------------------------

@pytest.mark.parametrize("config,fuse", [("ck", False), ("ck", True),
                                         ("lbl", True)])
def test_forward_matches_jax(nodes, config, fuse):
    """amarsw-ck and amarsw-lbl (resolution 10), 2 columns x 6 layers, with
    the band fluxes and their total.  The lbl bands have five different
    wave counts, which the JAX package compiles apart, so lbl runs fused
    against JAX and sequential against the port's fused run (1e-12)."""
    node = nodes[config]
    ro = JFac.create_radiation_options(node, ay.SPECIES, nlyr=NLYR, ncol=NCOL)
    jrad = JRad.Radiation(_xla(ro), dtype=jnp.float64)
    trad = Radiation(_torch(create_radiation_options(
        node, ay.SPECIES, nlyr=NLYR, ncol=NCOL)), dtype=F64, device="cpu")
    inputs = _atmosphere()
    bc = dict(albedo=0.3, btemp=290.0)
    want, jaux = _forward(jrad, _jax_in(*inputs), bc, return_aux=True,
                              fuse_bands=fuse)
    got, taux = _forward(trad, _torch_in(*inputs), bc, return_aux=True,
                             fuse_bands=fuse)
    _close(got, want, 1e-10)
    _close_aux(taux, jaux, 1e-10)
    if fuse:
        assert len(trad._fused_solvers) == 1
    if config == "lbl":
        seq, saux = _forward(trad, _torch_in(*inputs), bc, return_aux=True)
        _close(seq, got.numpy(), 1e-12)
        _close_aux(saux, {k: v.numpy() for k, v in taux.items()}, 1e-12)


def test_seeded_example_atmosphere(tmp_path):
    """``amars_yaml_torch.build(seed=...)`` draws columns and layers that
    differ; the solve ``Radiation._fused_problems`` hands out is the fused
    forward's, bit for bit; the forward matches JAX float64 (1e-10)."""
    rad, (conc, dz, bc, atm) = ay.build(
        "ck", str(tmp_path), nlyr=NLYR, ncol=NCOL, dtype=F64, device="cpu",
        kernel="torch", seed=4)
    for x in (conc, atm["pres"], atm["temp"]):
        assert float(x.std(dim=0).min()) > 0 and float(x.std(dim=1).min()) > 0
    assert float(dz.std()) > 0
    total, aux = rad.forward(conc, dz, bc, atm, return_aux=True,
                             fuse_bands=True)
    ((names, nws, ds, args),) = rad._fused_problems(conc, dz, bc, atm)
    assert names == list(rad.bands)
    flux = ds.forward(*args)
    assert flux.shape[0] == sum(nws)
    assert torch.equal(flux, torch.cat([aux[f"radiation/{n}/flux"]
                                        for n in names]))
    node = ay.ensure_tables(ay.load_node("ck"), str(tmp_path))
    jrad = JRad.Radiation(_xla(JFac.create_radiation_options(
        node, ay.SPECIES, nlyr=NLYR, ncol=NCOL)), dtype=jnp.float64)
    want = _forward(jrad, _jax_in(conc.numpy(), dz.numpy(),
                                  {k: v.numpy() for k, v in atm.items()}), bc)
    _close(total, want, 1e-10)


def test_per_call_band_edges_match_jax(nodes):
    """``bc['wvnmlo'/'wvnmhi']`` take precedence over the options' edges, in
    ``Disort`` and per band through ``Radiation`` (sequential and fused)."""
    nwave, nlyr = 3, 4
    opts = dict(flags="lamber,quiet,onlyfl,planck", nwave=nwave, ncol=NCOL,
                nlyr=nlyr, nstr=4, nmom=4, wave_lower=(1.0,) * nwave,
                wave_upper=(500.0,) * nwave)
    rng = np.random.default_rng(2)
    prop = rng.uniform(0.01, 1.0, (nwave, NCOL, nlyr, 1))
    temf = rng.uniform(200.0, 300.0, (NCOL, nlyr + 1))
    bc = dict(albedo=0.2, btemp=280.0, wvnmlo=np.array([10.0, 300.0, 700.0]),
              wvnmhi=np.array([300.0, 700.0, 1500.0]))
    want = JDisort(JDisortOptions(kernel="xla", **opts)).forward(
        jnp.asarray(prop), {k: jnp.asarray(v) for k, v in bc.items()},
        jnp.asarray(temf))
    ds = Disort(DisortOptions(kernel="torch", **opts))
    got = ds.forward(torch.tensor(prop),
                     {k: torch.tensor(v, dtype=F64) for k, v in bc.items()},
                     torch.tensor(temf))
    _close(got, want, 1e-10)
    plain = ds.forward(torch.tensor(prop), dict(albedo=0.2, btemp=280.0),
                       torch.tensor(temf))
    assert np.abs(plain.numpy() - np.asarray(want)).max() > 1e-3 * np.abs(
        np.asarray(want)).max()

    node = nodes["ck"]
    ro = JFac.create_radiation_options(node, ay.SPECIES, nlyr=NLYR, ncol=NCOL)
    jrad = JRad.Radiation(_xla(ro), dtype=jnp.float64)
    trad = Radiation(_torch(create_radiation_options(
        node, ay.SPECIES, nlyr=NLYR, ncol=NCOL)), dtype=F64, device="cpu")
    nested = {name: dict(albedo=0.1, btemp=300.0,
                         wvnmlo=np.full(8, 1.0 + 100.0 * i),
                         wvnmhi=np.full(8, 90.0 + 100.0 * i))
              for i, name in enumerate(ro.bands)}
    inputs = _atmosphere(seed=3)
    for fuse in (False, True):
        want = _forward(jrad, _jax_in(*inputs), nested, fuse_bands=fuse)
        got = _forward(trad, _torch_in(*inputs), nested, fuse_bands=fuse)
        _close(got, want, 1e-10)


def test_time_dependent_cache(nodes):
    node = nodes["ck"]
    ro = create_radiation_options(node, ay.SPECIES, nlyr=NLYR, ncol=NCOL)
    inputs = _torch_in(*_atmosphere())
    bc = dict(albedo=0.3, btemp=290.0)
    plain = Radiation(_torch(ro), dtype=F64, device="cpu")
    with pytest.raises(ValueError, match="time_dependent"):
        _forward(plain, inputs, bc, use_cache=True)
    rad = Radiation(_torch(ro).set_flags("time_dependent"), dtype=F64,
                    device="cpu")
    with pytest.raises(RuntimeError, match="empty"):
        _forward(rad, inputs, bc, use_cache=True)
    total, aux = _forward(rad, inputs, bc, return_aux=True)
    assert rad.forward(None, None, None, use_cache=True) is total
    cached, cached_aux = rad.forward(None, None, None, use_cache=True,
                                     return_aux=True)
    assert cached is total and cached_aux is aux
    jro = JFac.create_radiation_options(node, ay.SPECIES, nlyr=NLYR,
                                        ncol=NCOL).set_flags("time_dependent")
    jrad = JRad.Radiation(_xla(jro), dtype=jnp.float64)
    _forward(jrad, _jax_in(*_atmosphere()), bc)
    _close(cached, jrad.forward(None, None, None, use_cache=True), 1e-10)


def _sw_config(res):
    return {
        "opacity-sources": [
            {"name": "S8", "class": "S8Fuller", "data": "s8_k_fuller.txt"},
            {"name": "H2SO4", "class": "H2SO4Simple", "data": "h2so4.txt"}],
        "bands": ["SW"],
        "SW": {"units": "cm-1", "grid-type": "regular",
               "wavenumber-range": [2000.0, 50000.0], "resolution": res,
               "opacity": ["S8", "H2SO4"], "rt-solver": "Disort"},
        "Disort-flags": {"lamber": True, "onlyfl": True, "quiet": True},
    }


def test_stellar_beam_bc_matches_jax(tmp_path):
    """fbeam from a blackbody and from a spectrum file, then the SW band's
    beam fluxes (width-weighted bins) with that bc."""
    species = {"S8": (0, 256.0e-3), "H2SO4": (1, 98.0e-3)}
    nwave, nlyr = 8, 4
    res = (50000.0 - 2000.0) / (nwave - 1)
    cfg = _sw_config(res)
    jrad = JRad.Radiation(_xla(JFac.create_radiation_options(
        cfg, species, nlyr=nlyr, ncol=NCOL).set_flags("stellar_beam")),
        dtype=jnp.float64)
    trad = Radiation(_torch(create_radiation_options(
        cfg, species, nlyr=nlyr, ncol=NCOL).set_flags("stellar_beam")),
        dtype=F64, device="cpu")
    wavef, fluxf = tmp_path / "wave.txt", tmp_path / "flux.txt"
    np.savetxt(wavef, np.linspace(1900.0, 50100.0, 50))
    np.savetxt(fluxf, np.linspace(1.0, 2.0, 50))
    conc = np.full((NCOL, nlyr, 2), 1e-4)
    dz = np.full(nlyr, 2000.0)
    for kw in (dict(distance_au=1.5),
               dict(flux_file=str(fluxf), wave_file=str(wavef))):
        jbc = jrad.stellar_beam_bc("SW", mu0=0.6, **kw)
        tbc = trad.stellar_beam_bc("SW", mu0=0.6, **kw)
        for k in ("fbeam", "umu0"):
            assert tbc[k].dtype == torch.float32 and tbc[k].shape == (nwave,
                                                                      NCOL)
            np.testing.assert_array_equal(tbc[k].numpy(), np.asarray(jbc[k]))
        want = jrad.forward(jnp.asarray(conc), jnp.asarray(dz),
                            dict(jbc, albedo=0.2))
        got = trad.forward(torch.tensor(conc), torch.tensor(dz),
                           dict(tbc, albedo=0.2))
        _close(got, want, 1e-10)
    off = Radiation(create_radiation_options(cfg, species, nlyr=nlyr),
                    device="cpu")
    with pytest.raises(ValueError, match="stellar_beam"):
        off.stellar_beam_bc("SW", mu0=0.5)


def test_spherical_correction_through_shared_matches_jax(nodes):
    """Area and volume read from the blackboard (``coordinate/area1``,
    ``coordinate/vol``) correct the total flux as in JAX; the band optics
    are exported there too."""
    node = nodes["ck"]
    rng = np.random.default_rng(4)
    x1f = np.sort(rng.uniform(0.0, 100.0, NLYR + 1))
    area = rng.uniform(1.0, 2.0, (NCOL, NLYR + 1))
    vol = rng.uniform(0.1, 1.0, (NCOL, NLYR + 1))
    jrad = JRad.Radiation(_xla(JFac.create_radiation_options(
        node, ay.SPECIES, nlyr=NLYR, ncol=NCOL)), dtype=jnp.float64)
    trad = Radiation(_torch(create_radiation_options(
        node, ay.SPECIES, nlyr=NLYR, ncol=NCOL)), dtype=F64, device="cpu")
    inputs = _atmosphere(seed=5)
    bc = dict(albedo=0.3, btemp=290.0)
    keys = ("coordinate/area1", "coordinate/vol")
    try:
        jshared.update(zip(keys, (jnp.asarray(area), jnp.asarray(vol))))
        shared.update(zip(keys, (torch.tensor(area), torch.tensor(vol))))
        want = _forward(jrad, _jax_in(*inputs), bc, x1f=jnp.asarray(x1f))
        got = _forward(trad, _torch_in(*inputs), bc, x1f=torch.tensor(x1f))
        assert "radiation/B3/optics" in shared
    finally:
        for k in keys:
            jshared.pop(k, None)
            shared.pop(k, None)
    _close(got, want, 1e-10)
    flat = _forward(trad, _torch_in(*inputs), bc, x1f=torch.tensor(x1f))
    assert np.abs(flat.numpy() - got.numpy()).max() > 1e-6


def test_spherical_flux_correction_and_directions_match_jax():
    rng = np.random.default_rng(1)
    nx1 = 7
    flx, area = rng.uniform(1, 2, (3, nx1)), rng.uniform(1, 2, (3, nx1))
    vol, x1f = rng.uniform(0.1, 1, (3, nx1)), np.sort(rng.uniform(0, 10, nx1))
    _close(spherical_flux_correction(*map(torch.tensor, (flx, x1f, area, vol))),
           jsfc(*map(jnp.asarray, (flx, x1f, area, vol))), 1e-13)
    s = "(0., 0.) (60., 30.) (60., 30.0001), (45, -10)"
    np.testing.assert_array_equal(TDir.parse_radiation_directions(s),
                                  JDir.parse_radiation_directions(s))
    rays = TDir.parse_radiation_directions(s)
    assert TDir.get_direction_grids(rays) == JDir.get_direction_grids(rays)
    with pytest.raises(ValueError, match="parse"):
        TDir.parse_radiation_direction("60, 30")


# ---- refusals and devices --------------------------------------------------

def _band(**kw):
    op = AttenuatorOptions(type="s8_fuller", species_ids=(0,),
                           species_names=("S8",), species_weights=(0.256,),
                           opacity_files=("s8_k_fuller.txt",))
    return RadiationBandOptions(name="b", attenuators=(("s8", op),), **kw)


@pytest.mark.parametrize("what", ["band_radiance", "band_radiances",
                                  "broad_band", "unknown_attenuator"])
def test_refusals(what):
    if what == "unknown_attenuator":
        bad = _band().replace(attenuators=(("x", AttenuatorOptions(
            type="nope", species_ids=(0,))),))
        with pytest.raises(ValueError, match="Unknown attenuator"):
            RadiationBand(bad, device="cpu")
    elif what == "band_radiance":
        # ported; a band without out-directions has no radiances to give
        band = RadiationBand(_band(), device="cpu")
        with pytest.raises(ValueError, match="no outdirs"):
            band.band_radiance(None, None, {})
    elif what == "broad_band":
        opts = RadiationOptions(bands=("b",), band_options=(_band(),))
        rad = Radiation(opts.set_flags("broad_band"), device="cpu")
        with pytest.raises(NotImplementedError, match="broad_band"):
            rad.forward(torch.ones((1, 1, 1)), torch.ones(1), {})
    else:
        # ported; a ray that is not on the solver's direction grids is
        # refused, where the JAX package takes the nearest grid point
        opts = RadiationOptions(bands=("b",),
                                band_options=(_band(outdirs="(0., 0.)"),))
        rad = Radiation(opts, dtype=torch.float64, device="cpu")
        solver = rad.bands["b"].rtsolver
        rad.bands["b"].rtsolver = Disort(solver.options.replace(
            user_mu=(0.5,), kernel="torch"))
        args = (torch.ones((1, 1, 1), dtype=torch.float64),
                torch.ones(1, dtype=torch.float64), {},
                dict(wavenumber=torch.tensor([5000.0], dtype=torch.float64)))
        with pytest.raises(ValueError, match="not on the solver's grids"):
            rad.band_radiances(*args)
        with pytest.raises(ValueError, match="not on the solver's grids"):
            rad.write_radiances("x", *args)


def test_entry_points_need_cuda_unless_cpu(nodes, monkeypatch, tmp_path):
    """Without CUDA the default device raises; ``device="cpu"`` runs."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    ro = create_radiation_options(nodes["ck"], ay.SPECIES, nlyr=NLYR)
    for build in (lambda **kw: Radiation(ro, **kw),
                  lambda **kw: RadiationBand(ro.band_options[0], **kw),
                  lambda **kw: ay.build("ck", str(tmp_path), nlyr=NLYR, **kw)):
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            build()
        build(device="cpu")


@pytest.mark.parametrize("band", ["B2", "B4"])
def test_pick_source_reads_the_file_name_not_its_directory(band):
    """A band is matched against the data file's own name: a temporary
    directory whose random name holds another band's (``.../tmpxb4y/``)
    must not make the pick ambiguous."""
    from pyharp_tpu_torch.radiation.factory import _pick_source

    cands = [{"data": f"/data/tmpxb4y/amarsw-ck-{b}.nc"} for b in ("B2", "B4")]
    assert _pick_source(cands, band)["data"].endswith(f"-{band}.nc")
