"""``bench.extra``'s configurations with a beam against ``bench_extra.py``'s
steps, in float64 on the CPU, at 2 waves x 4 columns x 10 layers, each at
its own nstr, within 1e-10 of max|output|:

* ``sw_lbl_4str_beam`` (nstr 4, isotropic): the JAX script with
  ``kernel="pallas"`` (interpret mode), the port's algorithm (a secular
  root schedule; JAX's XLA path takes Jacobi rotations, ~1e-9 apart);
* ``aerosol_16str_beam`` (nstr 16, g = 0.8) with ``kernel="xla"``: with
  moments both take Jacobi rotations;
* ``radiances_8str_4mu_2phi_3tau`` (nstr 8): ``Disort.intensities``'s
  ``uu`` against the script's jitted ``ds.intensities(p, b)["uu"]``
  (``bench_extra.py:134-168``) with ``kernel="xla"``, on the port's draw.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import bench_extra
from pyharp_tpu.rt.disort.disort import Disort as JDisort
from pyharp_tpu.rt.disort.disort import DisortOptions as JDisortOptions

from pyharp_tpu_torch.bench import problems

from .test_torch_bench_steps import close, f64, jax_script


@pytest.mark.parametrize("nstr,kw,kernel", [
    (4, dict(beam=True, planck=False), "pallas"),
    (16, dict(beam=True, planck=False, g=0.8), "xla")],
    ids=["sw_lbl_4str_beam", "aerosol_16str_beam"])
def test_extra_step_matches_bench_extra_f64(nstr, kw, kernel):
    step, args = jax_script(bench_extra.build, 2, 4, 10, nstr, kernel=kernel,
                            **kw)
    want = np.asarray(step(*f64(args)))
    p = problems.extra_problem(2, 4, 10, nstr, dtype=torch.float64,
                               device="cpu", **kw)
    close(p.run().numpy(), want)


def test_radiance_step_matches_bench_extra_f64():
    shape = (2, 4, 10, 8)
    p = problems.radiance_problem(torch.float64, "cpu", shape=shape)
    o = p.disort.options
    ds = JDisort(JDisortOptions(
        flags=o.flags, nwave=o.nwave, ncol=o.ncol, nlyr=o.nlyr, nstr=o.nstr,
        nmom=o.nmom, user_mu=o.user_mu, user_phi=o.user_phi,
        user_tau=o.user_tau, kernel="xla"))
    rad_step = jax.jit(lambda q, b: ds.intensities(q, b)["uu"])
    want = np.asarray(rad_step(jnp.asarray(p.prop.numpy()),
                               {k: jnp.asarray(v.numpy())
                                for k, v in p.bc.items()}))
    got = p.run().numpy()
    assert got.shape == (2, 4, 3, 2, 4)
    close(got, want)
