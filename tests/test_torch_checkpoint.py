"""Checkpoints of table-backed state and sharded array files: the port's
``utils.checkpoint`` on its own (the counterparts of
``tests/test_checkpoint.py``) and across packages, a file written by one
package read by the other.

Tolerances: state moves through ``.npz`` / ``.npy`` files unchanged, so
buffers and arrays are bit-equal; fluxes from restored state are bit-equal
to those of the state saved in the same package, and within 1e-10 of
max|flux| of the other package's (float64, as the Radiation tests).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from pyharp_tpu.opacity.base import AttenuatorOptions as JAttOptions
from pyharp_tpu.radiation import band as JB
from pyharp_tpu.radiation import radiation as JRad
from pyharp_tpu.rt.disort.disort import DisortOptions as JDisortOptions
from pyharp_tpu.tables.rfm import write_rfm_table
from pyharp_tpu.utils import checkpoint as jck

from pyharp_tpu_torch import AttenuatorOptions, S8Fuller, convert
from pyharp_tpu_torch.parallel import RadiationMesh
from pyharp_tpu_torch.radiation import (Radiation, RadiationBand,
                                        RadiationBandOptions)
from pyharp_tpu_torch.rt.disort.disort import DisortOptions
from pyharp_tpu_torch.utils import checkpoint

F64 = torch.float64
SPECIES = dict(species_ids=(0,), species_names=("S8",),
               species_weights=(0.256,))


def make_s8(dtype=torch.float32):
    return S8Fuller(AttenuatorOptions(type="s8_fuller",
                                      opacity_files=("s8_k_fuller.txt",),
                                      **SPECIES), dtype=dtype, device="cpu")


def _zero_buffers(module):
    for _, buf in module.named_buffers():
        buf.zero_()


def test_roundtrip_attenuator(tmp_path):
    a = make_s8()
    p = str(tmp_path / "s8.npz")
    checkpoint.save(p, a)
    b = make_s8()
    _zero_buffers(b)
    assert b.kdata.abs().max() == 0
    b = checkpoint.load(p, b)
    assert torch.equal(b.kwave, a.kwave) and torch.equal(b.kdata, a.kdata)
    conc = torch.ones((2, 3, 1))
    wav = torch.linspace(0.3, 1.0, 4)
    assert torch.equal(a.forward(conc, wavelength=wav),
                       b.forward(conc, wavelength=wav))


def test_dtype_follows_module(tmp_path):
    p = str(tmp_path / "s8_64.npz")
    checkpoint.save(p, make_s8(dtype=F64))
    b32 = checkpoint.load(p, make_s8(dtype=torch.float32))
    assert b32.kdata.dtype == torch.float32
    assert torch.equal(b32.kdata, make_s8(dtype=torch.float32).kdata)


@pytest.mark.parametrize("fault", ["shape", "missing"])
def test_shape_mismatch_and_missing_key_raise(tmp_path, fault):
    a = make_s8()
    p = str(tmp_path / "s8.npz")
    checkpoint.save(p, a)
    state = dict(np.load(p))
    key = [k for k in state if k.endswith("kwave")][0]
    if fault == "shape":
        state[key] = state[key][:-1]
        with pytest.raises(ValueError, match="shape mismatch"):
            checkpoint.load_state(a, state)
    else:
        del state[key]
        with pytest.raises(KeyError, match="kwave"):
            checkpoint.load_state(a, state)


def test_band_roundtrip(tmp_path):
    bop = RadiationBandOptions(
        name="sw", nlyr=4, ncol=1, wave_lower=(2000.0,), wave_upper=(9999.0,),
        attenuators=(("s8", AttenuatorOptions(
            type="s8_fuller", opacity_files=("s8_k_fuller.txt",), **SPECIES)),),
        disort=DisortOptions(flags="lamber,quiet,onlyfl", nstr=4, nmom=4,
                             nwave=1, ncol=1, nlyr=4))
    band = RadiationBand(bop, device="cpu")
    p = str(tmp_path / "band.npz")
    checkpoint.save(p, band)
    sd = checkpoint.state_dict(band)
    assert set(sd) == {"s8/kwave", "s8/kdata"}
    band2 = RadiationBand(bop, device="cpu")
    _zero_buffers(band2.attenuators["s8"])
    band2 = checkpoint.load(p, band2)
    assert torch.equal(band2.attenuators["s8"].kdata,
                       band.attenuators["s8"].kdata)


# ---- across packages -------------------------------------------------------

def _radiations(tmp_path):
    """A JAX and a port ``Radiation`` of two bands: an RFM line-by-line
    table without ck weights (a ``None`` leaf) beside an S8 aerosol, and an
    aerosol-only band."""
    path = str(tmp_path / "ck-lbl-B1.nc")
    rng = np.random.default_rng(6)
    write_rfm_table(path, np.array([2500.0, 3500.0, 4500.0]),
                    np.logspace(5, 2, 6), np.linspace(-50, 50, 5),
                    np.linspace(300, 150, 6),
                    {"CO2": rng.normal(-2.0, 0.5, (3, 6, 5))})
    common = dict(species_names=("CO2", "S8"),
                  species_weights=(44.0e-3, 256.0e-3))
    gas = JAttOptions(species_ids=(0,), type="rfm", opacity_files=(path,),
                      **common)
    aer = JAttOptions(species_ids=(1,), type="s8_fuller",
                      opacity_files=("s8_k_fuller.txt",), **common)
    band = dict(nlyr=4, ncol=2, wave_lower=(2000.0, 3000.0, 4000.0),
                wave_upper=(3000.0, 4000.0, 5000.0),
                wavenumber=(2500.0, 3500.0, 4500.0),
                disort=JDisortOptions(flags="lamber,quiet,onlyfl", nstr=4,
                                      nmom=4, kernel="xla"))
    ro = JRad.RadiationOptions(bands=("b1", "b2"), band_options=(
        JB.RadiationBandOptions(name="b1", attenuators=(("gas", gas),
                                                        ("s8", aer)), **band),
        JB.RadiationBandOptions(name="b2", attenuators=(("s8", aer),),
                                **band)))
    tro = convert.radiation_options_from_state(dataclasses.asdict(ro))
    return (JRad.Radiation(ro, dtype=jnp.float64),
            Radiation(tro, dtype=F64, device="cpu"))


def _flux(rad, xp):
    rng = np.random.default_rng(8)
    conc = rng.uniform(0.5e-3, 1.5e-3, (2, 4, 2))
    atm = dict(pres=rng.uniform(2e4, 1e5, (2, 4)),
               temp=rng.uniform(220.0, 300.0, (2, 4)))
    bc = dict(fbeam=2.0, umu0=0.7, albedo=0.2)
    out = rad.forward(xp(conc), xp(np.full((4,), 500.0)), bc,
                      {k: xp(v) for k, v in atm.items()})
    return np.asarray(out.numpy() if isinstance(out, torch.Tensor) else out)


def _jax_in(x):
    return jnp.asarray(x)


def _torch_in(x):
    return torch.tensor(x)


def _close(got, want):
    assert np.abs(got - want).max() <= 1e-10 * np.abs(want).max()


@pytest.mark.parametrize("direction", ["jax_to_port", "port_to_jax"])
def test_checkpoints_cross_packages(tmp_path, direction):
    """The JAX leaf paths are the port's keys: a file saved by one package
    restores the other's zeroed tables bit for bit, and the fluxes with
    them; the RFM's ``None`` weights are skipped on both sides."""
    jrad, trad = _radiations(tmp_path)
    want_j, want_t = _flux(jrad, _jax_in), _flux(trad, _torch_in)
    _close(want_t, want_j)
    sd_j, sd_t = jck.state_dict(jrad), checkpoint.state_dict(trad)
    assert sorted(sd_j) == sorted(sd_t)
    assert "b1/gas/kdata" in sd_t and not any(k.endswith("weights")
                                              for k in sd_t)
    p = str(tmp_path / "rad.npz")
    if direction == "jax_to_port":
        jck.save(p, jrad)
        for band in trad.bands.values():
            for a in band.attenuators.values():
                _zero_buffers(a)
        checkpoint.load(p, trad)
        for k, v in checkpoint.state_dict(trad).items():
            np.testing.assert_array_equal(v, np.asarray(sd_j[k]))
            assert v.dtype == np.float64
        np.testing.assert_array_equal(_flux(trad, _torch_in), want_t)
    else:
        checkpoint.save(p, trad)
        for band in jrad.bands.values():
            for n, a in band.attenuators.items():
                band.attenuators[n] = jax.tree_util.tree_map(
                    lambda x: x * 0, a)
        jck.load(p, jrad)
        for k, v in jck.state_dict(jrad).items():
            np.testing.assert_array_equal(np.asarray(v), sd_t[k])
        np.testing.assert_array_equal(_flux(jrad, _jax_in), want_j)


GLOBAL = np.arange(8 * 6 * 3, dtype=np.float32).reshape(8, 6, 3) / 7.0


def test_sharded_arrays_jax_to_port(tmp_path):
    """A (wave, col)-sharded JAX array over 8 devices, and a plain one."""
    mesh = Mesh(np.asarray(jax.devices()[:8]).reshape(4, 2), ("wave", "col"))
    arr = jax.device_put(jnp.asarray(GLOBAL),
                         NamedSharding(mesh, P("wave", "col", None)))
    prefix = str(tmp_path / "flux")
    written = jck.save_array_sharded(prefix, arr)
    assert len(written) == 9
    got = checkpoint.load_array_sharded(prefix)
    assert got.dtype == GLOBAL.dtype
    np.testing.assert_array_equal(got, GLOBAL)
    jck.save_array_sharded(str(tmp_path / "plain"), GLOBAL)
    np.testing.assert_array_equal(
        checkpoint.load_array_sharded(str(tmp_path / "plain")), GLOBAL)


@pytest.mark.parametrize("spec", [("wave", "col", None), ("col", None, None)])
def test_sharded_arrays_port_to_jax(tmp_path, spec):
    """Each rank of a 2 x 2 (col x wave) mesh writes its block of the
    global array; a block that ``wave`` replicates is written once."""
    from pyharp_tpu_torch.parallel import local_slice

    prefix = str(tmp_path / "flux")
    x = torch.tensor(GLOBAL)
    written = []
    for rank in range(4):
        mesh = RadiationMesh(2, 2, rank)
        written += checkpoint.save_array_sharded(
            prefix, local_slice(mesh, x, spec), mesh, spec)
    assert len(written) == (8 if spec[0] == "wave" else 4)
    for load in (jck.load_array_sharded, checkpoint.load_array_sharded):
        got = load(prefix)
        assert got.dtype == GLOBAL.dtype
        np.testing.assert_array_equal(got, GLOBAL)
    checkpoint.save_array_sharded(str(tmp_path / "plain"), x)
    np.testing.assert_array_equal(
        jck.load_array_sharded(str(tmp_path / "plain")), GLOBAL)
