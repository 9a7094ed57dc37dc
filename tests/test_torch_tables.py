"""Static tables, Planck, interpolation and RFM opacity: the PyTorch port
against the JAX package on the same numpy inputs.

Tolerances: the quadrature, Legendre, angle, constant and index tables are
the same numpy code, so they must be exactly equal.  Planck and
interpolation run in float64 in both frameworks with the same operation
order; rtol 1e-12 leaves room for the last-bit differences of ``pow``/``exp``
between XLA and PyTorch.  Table ingestion moves float64 values through files
and must be bit-exact.
"""

import dataclasses
import importlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pyharp_tpu.core import constants as jconst, index as jindex
from pyharp_tpu.opacity.base import AttenuatorOptions as JAttOpts
from pyharp_tpu.opacity.rfm import RFM as JRFM
from pyharp_tpu.rt.disort import legendre as jleg, planck as jplanck
from pyharp_tpu.rt.disort import quadrature as jquad, solver as jsolver
from pyharp_tpu.rt.disort.disort import DisortOptions as JDisortOptions
from pyharp_tpu.tables import rfm as jrfm

from pyharp_tpu_torch import convert
from pyharp_tpu_torch.core import constants as tconst, index as tindex
from pyharp_tpu_torch.opacity.rfm import RFM as TRFM
from pyharp_tpu_torch.rt.disort import legendre as tleg, planck as tplanck
from pyharp_tpu_torch.rt.disort import quadrature as tquad, solver as tsolver
from pyharp_tpu_torch.tables import rfm as trfm

# the interp packages re-export functions under their modules' names
jinterp = importlib.import_module("pyharp_tpu.interp.interpn")
jl2l = importlib.import_module("pyharp_tpu.interp.layer2level")
tinterp = importlib.import_module("pyharp_tpu_torch.interp.interpn")
tl2l = importlib.import_module("pyharp_tpu_torch.interp.layer2level")

F64 = torch.float64


def _t(x):
    return torch.tensor(np.asarray(x), dtype=F64)


@pytest.mark.parametrize("nstr", [2, 4, 8, 16])
def test_quadrature_and_angles_exact(nstr):
    for a, b in zip(jquad.gauss_half_range(nstr), tquad.gauss_half_range(nstr)):
        np.testing.assert_array_equal(a, b)
    for m in range(3):
        ja = jsolver.make_static_angles(nstr, nstr + 2, m)
        ta = tsolver.make_static_angles(nstr, nstr + 2, m)
        for f in ja._fields:
            np.testing.assert_array_equal(getattr(ja, f), getattr(ta, f))
        np.testing.assert_array_equal(
            jleg.lepoly_static(ja.mu, m, 9), tleg.lepoly_static(ta.mu, m, 9))


def test_constants_and_index_exact():
    for jm, tm in ((jconst, tconst), (jindex, tindex)):
        names = [n for n in dir(jm) if not n.startswith("_")]
        assert names == [n for n in dir(tm) if not n.startswith("_")]
        for n in names:
            assert getattr(jm, n) == getattr(tm, n), n


def test_planck_f64():
    rng = np.random.default_rng(0)
    # temperatures from near 0 K up, band edges straddling the series switch
    temp = np.concatenate([[0.0, 1e-3, 50.0], rng.uniform(100.0, 400.0, 29)])
    wnlo = np.concatenate([[0.0, 1.0], rng.uniform(1.0, 800.0, 30)])
    wnhi = np.concatenate([[np.inf, 150.0], wnlo[2:] + rng.uniform(1, 500, 30)])
    got = tplanck.planck_band(_t(temp), _t(wnlo), _t(wnhi)).numpy()
    want = np.asarray(jplanck.planck_band(jnp.asarray(temp), jnp.asarray(wnlo),
                                          jnp.asarray(wnhi)))
    np.testing.assert_allclose(got, want, rtol=1e-12, atol=0)
    np.testing.assert_allclose(tplanck.planck_total(_t(temp)).numpy(),
                               np.asarray(jplanck.planck_total(jnp.asarray(temp))),
                               rtol=1e-12, atol=0)


def test_locate_interp_f64_with_clamped_edges():
    rng = np.random.default_rng(1)
    ax0 = np.sort(rng.uniform(0.0, 10.0, 7))
    ax1 = np.sort(rng.uniform(-5.0, 5.0, 5))
    # below, at, between and above the samples, including exact hits
    x0 = np.concatenate([[ax0[0] - 1, ax0[0], ax0[-1], ax0[-1] + 2, ax0[3]],
                         rng.uniform(-1.0, 11.0, 20)])
    x1 = np.concatenate([[ax1[-1] + 1, ax1[0], ax1[2], ax1[0] - 3, ax1[-1]],
                         rng.uniform(-6.0, 6.0, 20)])
    np.testing.assert_array_equal(
        tinterp.locate(_t(ax0), _t(x0)).numpy(),
        np.asarray(jinterp.locate(jnp.asarray(ax0), jnp.asarray(x0))))

    data1 = rng.standard_normal(7)
    np.testing.assert_allclose(
        tinterp.interp1(_t(x0), _t(data1), _t(ax0)).numpy(),
        np.asarray(jinterp.interp1(jnp.asarray(x0), jnp.asarray(data1),
                                   jnp.asarray(ax0))), rtol=1e-12, atol=1e-14)

    data2 = rng.standard_normal((7, 5, 3))   # trailing value axis
    got = tinterp.interpn([_t(x0), _t(x1)], _t(data2), [_t(ax0), _t(ax1)])
    want = jinterp.interpn([jnp.asarray(x0), jnp.asarray(x1)],
                           jnp.asarray(data2),
                           [jnp.asarray(ax0), jnp.asarray(ax1)])
    np.testing.assert_allclose(got.numpy(), np.asarray(want),
                               rtol=1e-12, atol=1e-14)


@pytest.mark.parametrize("nlyr", [1, 2, 3, 9])
@pytest.mark.parametrize("opts", [
    dict(), dict(order=2), dict(logy=True),
    dict(blower=1, bupper=0, check_positivity=False)])
def test_layer2level_f64(nlyr, opts):
    rng = np.random.default_rng(nlyr)
    var = rng.uniform(100.0, 300.0, (3, nlyr))
    got = tl2l.layer2level(_t(var), tl2l.Layer2LevelOptions(**opts))
    want = jl2l.layer2level(jnp.asarray(var), jl2l.Layer2LevelOptions(**opts))
    np.testing.assert_allclose(got.numpy(), np.asarray(want),
                               rtol=1e-12, atol=0)


def _table_arrays():
    rng = np.random.default_rng(3)
    wave = np.linspace(1.0, 150.0, 5)
    pres = np.logspace(6.0, 2.0, 6)          # descending: flipped on load
    tgrid = np.linspace(-40.0, 40.0, 4)
    reftemp = np.linspace(300.0, 160.0, 6)
    species = {"CO2": rng.normal(-2.0, 1.0, (5, 6, 4)),
               "H2O": rng.normal(-3.0, 1.0, (5, 6, 4))}
    return wave, pres, tgrid, reftemp, species, np.full(5, 0.2)


def test_rfm_table_hdf5_and_netcdf3_load_identically(tmp_path):
    args = _table_arrays()
    h5 = str(tmp_path / "table_h5.nc")
    nc3 = str(tmp_path / "table_nc3.nc")
    jrfm.write_rfm_table(h5, *args[:5], weights=args[5])
    trfm.write_rfm_table(nc3, *args[:5], weights=args[5])
    with open(nc3, "rb") as f:
        assert f.read(3) == b"CDF"
    for species in ("CO2", "H2O"):
        ref = jrfm.load_rfm_table(h5, species)
        for path in (h5, nc3):
            for loaded in (trfm.load_rfm_table(path, species),
                           jrfm.load_rfm_table(path, species)):
                for f in dataclasses.fields(ref):
                    np.testing.assert_array_equal(getattr(loaded, f.name),
                                                  getattr(ref, f.name))
    np.testing.assert_array_equal(trfm.read_weights_rfm(nc3), args[5])
    np.testing.assert_array_equal(trfm.read_weights_rfm(h5), args[5])


def test_rfm_forward_f64_through_convert(tmp_path):
    path = str(tmp_path / "table.nc")
    jrfm.write_rfm_table(path, *_table_arrays()[:5], weights=_table_arrays()[5])
    opts = JAttOpts(species_names=("CO2", "H2O"), species_ids=(1,),
                    opacity_files=(path,))
    jr = JRFM.from_options(opts, dtype=jnp.float64)
    leaves = {k: (None if getattr(jr, k) is None else np.asarray(getattr(jr, k)))
              for k in convert.RFM_LEAVES}
    tr = convert.rfm_from_state(leaves, dataclasses.asdict(opts), dtype=F64,
                                device="cpu")
    assert isinstance(tr, TRFM) and tr.options.species_ids == (1,)
    direct = TRFM.from_options(convert.attenuator_options_from_state(
        dataclasses.asdict(opts)), dtype=F64, device="cpu")
    for k in convert.RFM_LEAVES:
        torch.testing.assert_close(getattr(tr, k), getattr(direct, k),
                                   rtol=0, atol=0)

    rng = np.random.default_rng(4)
    ncol, nlyr = 3, 6
    conc = rng.uniform(0.5, 2.0, (ncol, nlyr, 2))
    # pressures and temperatures running past both ends of the table
    pres = np.exp(rng.uniform(np.log(50.0), np.log(5e6), (ncol, nlyr)))
    temp = rng.uniform(120.0, 380.0, (ncol, nlyr))
    want = np.asarray(jr.forward(jnp.asarray(conc), pres=jnp.asarray(pres),
                                 temp=jnp.asarray(temp)))
    got = tr(_t(conc), pres=_t(pres), temp=_t(temp)).numpy()
    assert got.shape == want.shape == (5, ncol, nlyr, 1)
    np.testing.assert_allclose(got, want, rtol=1e-12, atol=0)


@pytest.mark.parametrize("jkernel,tkernel",
                         [("xla", "torch"), ("pallas", "cuda"), ("auto", "auto")])
def test_disort_options_carry_over(jkernel, tkernel):
    jo = JDisortOptions(flags="lamber,onlyfl,planck", nwave=3, ncol=2, nlyr=7,
                        nstr=8, wave_lower=(1.0,) * 3, wave_upper=(5.0,) * 3,
                        kernel=jkernel)
    to = convert.disort_options_from_state(dataclasses.asdict(jo))
    assert to.kernel == tkernel
    fields = dataclasses.asdict(to)
    for k, v in dataclasses.asdict(jo).items():
        if k != "kernel":
            assert fields[k] == v, k


# ---- the parity leftovers and the phase-moment generators -----------------

@pytest.mark.parametrize("opts", [
    dict(type="isotropic"), dict(type="rayleigh"),
    dict(type="henyey_greenstein", gg=0.73),
    dict(type="double_henyey_greenstein", gg1=0.8, gg2=-0.4, ff=0.65)])
@pytest.mark.parametrize("nmom", [1, 8])
def test_scattering_moments_f64(opts, nmom):
    from pyharp_tpu.rt import scattering_moments as jsm
    from pyharp_tpu.rt import PhaseMomentOptions as JPMO
    from pyharp_tpu_torch.rt import scattering_moments as tsm
    from pyharp_tpu_torch.rt import PhaseMomentOptions as TPMO

    got = tsm(nmom, TPMO(**opts), device="cpu")
    assert got.dtype == F64 and got.device.type == "cpu"
    np.testing.assert_array_equal(got.numpy(), jsm(nmom, JPMO(**opts)))


@pytest.mark.parametrize("opts", [dict(type="henyey_greenstein", gg=1.0),
                                  dict(type="henyey_greenstein", gg=-1.0),
                                  dict(type="mie")])
def test_scattering_moments_refusals_match(opts):
    from pyharp_tpu.rt import scattering_moments as jsm
    from pyharp_tpu.rt import PhaseMomentOptions as JPMO
    from pyharp_tpu_torch.rt import scattering_moments as tsm
    from pyharp_tpu_torch.rt import PhaseMomentOptions as TPMO

    with pytest.raises(ValueError) as jerr:
        jsm(4, JPMO(**opts))
    with pytest.raises(ValueError) as terr:
        tsm(4, TPMO(**opts), device="cpu")
    assert str(terr.value) == str(jerr.value)


def test_search_paths_and_find_resource(tmp_path):
    """The same edits to both packages' search paths give the same lists
    and the same resolved files; the defaults are restored after."""
    from pyharp_tpu.tables import resource as jres
    from pyharp_tpu_torch.tables import resource as tres

    saved = jres.get_search_paths(), tres.get_search_paths()
    assert saved[0][0] == saved[1][0] == "."
    first, second = tmp_path / "a", tmp_path / "b"
    first.mkdir()
    second.mkdir()
    (second / "only_here.txt").write_text("1 2\n")
    (first / "both.txt").write_text("1\n")
    (second / "both.txt").write_text("2\n")
    try:
        for res in (jres, tres):
            res.set_search_paths(f"{first}:{second}")
        assert tres.get_search_paths() == [str(first), str(second)] + \
            saved[1][-1:]
        for name in ("only_here.txt", "both.txt", "s8_k_fuller.txt"):
            assert tres.find_resource(name) == jres.find_resource(name)
        assert tres.find_resource("both.txt") == str(first / "both.txt")
        for res in (jres, tres):
            res.add_resource_directory(str(second))
            res.add_resource_directory(str(tmp_path), prepend=False)
        assert tres.get_search_paths() == jres.get_search_paths()[:-1] + \
            tres.get_search_paths()[-1:]
        assert tres.find_resource("both.txt") == str(second / "both.txt")
        with pytest.raises(FileNotFoundError, match="add_resource_directory"):
            tres.find_resource("no_such_table.txt")
    finally:
        for res, paths in zip((jres, tres), saved):
            res.set_search_paths(paths[:-1])
    assert (jres.get_search_paths(), tres.get_search_paths()) == saved


@pytest.mark.parametrize("header", ["# wave kext ssa\n", "# two names\n",
                                    ""])
def test_ascii_counts_and_vectors(tmp_path, header):
    from pyharp_tpu.tables import ascii as jascii
    from pyharp_tpu_torch.tables import ascii as tascii

    rng = np.random.default_rng(len(header))
    path = tmp_path / "table.txt"
    rows = rng.uniform(-5.0, 5.0, (7, 3))
    path.write_text(header + "\n".join(" ".join(f"{v:.17g}" for v in r)
                                       + "  # note" for r in rows) + "\n")
    name = str(path)
    assert tascii.get_num_rows(name) == jascii.get_num_rows(name) == 7
    assert tascii.get_num_cols(name) == jascii.get_num_cols(name) == 3
    got, want = tascii.read_data_vector(name), jascii.read_data_vector(name)
    assert list(got) == list(want)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k])


def test_layer2level_with_mask_and_top_level_names():
    import pyharp_tpu
    import pyharp_tpu_torch

    rng = np.random.default_rng(5)
    var = rng.uniform(-1.0, 3.0, (4, 9))       # some levels come out < 0
    for opts in (dict(), dict(order=2, blower=1, bupper=0)):
        got, gmask = tl2l.layer2level_with_mask(
            _t(var), tl2l.Layer2LevelOptions(**opts))
        want, wmask = jl2l.layer2level_with_mask(
            jnp.asarray(var), jl2l.Layer2LevelOptions(**opts))
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   rtol=1e-12, atol=1e-15)
        np.testing.assert_array_equal(gmask.numpy(), np.asarray(wmask))
        assert gmask.any()
    for name in ("k2ndOrder", "k4thOrder", "kExtrapolate", "kConstant"):
        assert getattr(pyharp_tpu_torch, name) == getattr(pyharp_tpu, name)
