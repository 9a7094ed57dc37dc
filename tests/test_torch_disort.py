"""``Disort.forward`` of the PyTorch port against the JAX package, on a
bench-shaped problem (``bench.py:41-78`` cut to 2 waves x 4 columns x 11
layers): isotropic, ``lamber,onlyfl,planck``, no beam.

Tolerances, in float64:

* against JAX ``kernel="xla"`` at nstr 8: max|err| <= 1e-6 max|flux|.  The
  XLA path finds the eigenvalues by Jacobi rotations and the port by the
  secular root schedule (10 bisections + 2 Newton steps) of the Pallas
  kernel; at this shape JAX's own two paths differ by 1.3e-7 relative.
* against JAX ``kernel="pallas"`` (interpret mode) at nstr 4: the same
  algorithms, max|err| <= 1e-10 max|flux|.
"""

import subprocess
import sys
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pyharp_tpu.rt.disort.disort import Disort as JDisort
from pyharp_tpu.rt.disort.disort import DisortOptions as JDisortOptions

from pyharp_tpu_torch import Disort, DisortOptions

REPO = Path(__file__).resolve().parents[1]
FLAGS = "lamber,quiet,onlyfl,planck"


def _bench_problem(nwave=2, ncol=4, nlyr=11, seed=0):
    """``bench.build_problem``'s inputs at a small size, as numpy."""
    rng = np.random.default_rng(seed)
    prop = np.zeros((nwave, ncol, nlyr, 2))
    prop[..., 0] = rng.uniform(0.001, 0.8, (nwave, ncol, nlyr))
    prop[..., 1] = rng.uniform(0.0, 0.6, (nwave, ncol, nlyr))
    bc = dict(umu0=np.full((nwave, ncol), 0.5),
              albedo=np.full((nwave, ncol), 0.1),
              btemp=np.full((nwave, ncol), 300.0))
    temf = np.broadcast_to(np.linspace(200.0, 300.0, nlyr + 1),
                           (ncol, nlyr + 1)).copy()
    return prop, bc, temf


def _options(nstr, nwave=2, ncol=4, nlyr=11, **kw):
    return dict(dict(flags=FLAGS, nwave=nwave, ncol=ncol, nlyr=nlyr,
                     nstr=nstr, nmom=nstr, wave_lower=(1.0,) * nwave,
                     wave_upper=(500.0,) * nwave), **kw)


def _jax_forward(nstr, kernel):
    prop, bc, temf = _bench_problem()
    ds = JDisort(JDisortOptions(kernel=kernel, **_options(nstr)))
    return np.asarray(ds.forward(
        jnp.asarray(prop, jnp.float64),
        {k: jnp.asarray(v, jnp.float64) for k, v in bc.items()},
        jnp.asarray(temf, jnp.float64)))


def _torch_forward(nstr, kernel, dtype=torch.float64):
    prop, bc, temf = _bench_problem()
    ds = Disort(DisortOptions(kernel=kernel, **_options(nstr)))
    return ds.forward(torch.tensor(prop, dtype=dtype),
                      {k: torch.tensor(v, dtype=dtype) for k, v in bc.items()},
                      torch.tensor(temf, dtype=dtype)).numpy()


@pytest.mark.parametrize("nstr,jkernel,rel", [(8, "xla", 1e-6),
                                              (4, "pallas", 1e-10)])
def test_forward_matches_jax_f64(nstr, jkernel, rel):
    want = _jax_forward(nstr, jkernel)
    got = _torch_forward(nstr, "torch")
    assert got.shape == want.shape == (2, 4, 12, 2)
    assert np.abs(got - want).max() <= rel * np.abs(want).max()
    # CPU tensors: the wrappers run the same plain versions
    np.testing.assert_array_equal(_torch_forward(nstr, "auto"), got)


def test_forward_total_planck_and_top_emission_match_jax_f64():
    """No band edges (sigma T^4 / pi sources) and an emitting top boundary
    (``ttemp``, ``temis``, ``fisot``), against JAX ``kernel="xla"``."""
    prop, bc, temf = _bench_problem()
    bc = dict(bc, ttemp=np.full((2, 4), 180.0), temis=np.full((2, 4), 0.7),
              fisot=np.full((2, 4), 0.5))
    opts = _options(4, wave_lower=(), wave_upper=())
    want = np.asarray(JDisort(JDisortOptions(kernel="xla", **opts)).forward(
        jnp.asarray(prop, jnp.float64),
        {k: jnp.asarray(v, jnp.float64) for k, v in bc.items()},
        jnp.asarray(temf, jnp.float64)))
    got = Disort(DisortOptions(kernel="torch", **opts)).forward(
        torch.tensor(prop), {k: torch.tensor(v) for k, v in bc.items()},
        torch.tensor(temf)).numpy()
    assert np.abs(got - want).max() <= 1e-6 * np.abs(want).max()


def test_forward_f32_close_to_f64():
    """The float32 solve (the kernels' working type) against float64: f32
    rounding through 11 layers."""
    f64 = _torch_forward(8, "torch")
    f32 = _torch_forward(8, "torch", torch.float32)
    assert f32.dtype == np.float32
    assert np.abs(f32 - f64).max() <= 1e-5 * np.abs(f64).max()


def _tiny(nprop=2, flags=FLAGS):
    ds = Disort(DisortOptions(flags=flags, nlyr=3, nstr=4, wave_lower=(1.0,),
                              wave_upper=(500.0,)))
    prop = torch.full((1, 1, 3, nprop), 0.1, dtype=torch.float64)
    temf = torch.full((1, 4), 250.0, dtype=torch.float64)
    return ds, prop, temf


def test_unported_inputs_raise():
    ds, prop, temf = _tiny()
    # per-call band edges are ported; half a pair is refused
    with pytest.raises(ValueError, match="wvnmhi"):
        ds.forward(prop, dict(albedo=0.1, btemp=250.0, wvnmlo=1.0), temf)
    # the radiance flags are ported; ibcnd is a special mode, not a flux
    # solve, and forward refuses it as the JAX package does
    for flag in ("usrtau", "usrang", "output_uum", "print-fluxes"):
        _tiny(flags=FLAGS + "," + flag)
    ds_ibcnd, prop_i, temf_i = _tiny(flags=FLAGS + ",ibcnd")
    with pytest.raises(ValueError, match="albedo_transmissivity"):
        ds_ibcnd.forward(prop_i, dict(albedo=0.1, btemp=250.0), temf_i)
    with pytest.raises(ValueError, match="unknown"):
        _tiny(flags=FLAGS + ",bogus")
    with pytest.raises(ValueError, match="kernel"):
        Disort(DisortOptions(kernel="pallas"))


def test_import_leaves_jax_out():
    code = ("import sys, pyharp_tpu_torch, pyharp_tpu_torch.convert\n"
            "import pyharp_tpu_torch.rt.disort.kernels\n"
            "import pyharp_tpu_torch.radiation, pyharp_tpu_torch.utils\n"
            "import pyharp_tpu_torch.opacity\n"
            "bad = [m for m in sys.modules\n"
            "       if m.split('.')[0] in ('jax', 'jaxlib', 'pyharp_tpu')]\n"
            "print(bad)\n")
    res = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr
    assert res.stdout.strip() == "[]"
