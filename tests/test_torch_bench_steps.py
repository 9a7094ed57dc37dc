"""The steps of the port's drivers against the JAX scripts' steps, in
float64 on the CPU, at 2 waves x 4 columns x 10 layers:

* ``bench.columns`` (``problems.bench_problem``'s step) against
  ``bench.build_problem``'s jitted step, nstr 8;
* ``bench.extra``'s ``thermal_lw_8str_100lyr_bigbatch`` against
  ``bench_extra.build(..., beam=False, planck=True)``'s step, nstr 8.

Both are isotropic, where the JAX package's float64 XLA path finds the
eigenvalues by Jacobi rotations and the port (as the Pallas kernel) by a
secular root schedule, ~1e-7 apart (``tests/test_torch_disort.py``); so
the JAX scripts are run with ``kernel="pallas"`` (interpret mode on the
CPU), the same algorithms, and held to 1e-10 of max|flux|.  The inputs are
the scripts' float32 draws, in float64.  The other configurations of
``bench_extra.py`` are in ``tests/test_torch_bench_extra.py``.

Compiling a step in interpret mode takes most of a minute, so ``bench.py``'s
step is compiled once for the module and serves both: the big batch's
``Disort`` is ``bench.py``'s (the same flags, band edges and moments), and
its mean over waves is ``bench.py``'s sum with weights 1/nwave.
"""

import functools
from unittest import mock

import jax.numpy as jnp
import numpy as np
import pytest

import bench
import bench_extra
from pyharp_tpu.rt.disort.disort import DisortOptions as JDisortOptions

from pyharp_tpu_torch.bench import problems

REL = 1e-10


def jax_script(build, *args, kernel, **kw):
    """``build(*args, **kw)`` of a JAX script with its ``Disort`` made with
    ``kernel``."""
    with mock.patch("pyharp_tpu.rt.DisortOptions",
                    functools.partial(JDisortOptions, kernel=kernel)):
        return build(*args, **kw)


def f64(args):
    prop, bc, temf = args
    return (jnp.asarray(prop, jnp.float64),
            {k: jnp.asarray(v, jnp.float64) for k, v in bc.items()},
            None if temf is None else jnp.asarray(temf, jnp.float64))


def close(got, want):
    assert got.shape == want.shape
    assert np.isfinite(got).all()
    err = np.abs(got - want).max() / np.abs(want).max()
    assert err <= REL, err


@pytest.fixture(scope="module")
def bench_step():
    """``bench.build_problem``'s jitted step and inputs at 2 waves x 4
    columns x 10 layers, nstr 8, in float64 through the Pallas kernels."""
    return jax_script(bench.build_problem, 4, nwave=2, nlyr=10, nstr=8,
                      dtype=jnp.float64, kernel="pallas")


def test_columns_step_matches_bench_py_f64(bench_step):
    import torch

    step, args = bench_step
    want = np.asarray(step(*args))
    p = problems.bench_problem(2, 4, 10, 8, torch.float64, "cpu")
    close(p.run().numpy(), want)


def test_bigbatch_step_matches_bench_extra_f64(bench_step):
    """``bench_extra.build(..., beam=False, planck=True)``'s step on its own
    draw, computed by ``bench.py``'s compiled step: its ``bc`` gains
    ``bench.py``'s umu0, which a solve without a beam never reads."""
    import torch

    step, (_, bench_bc, _) = bench_step
    _, args = bench_extra.build(2, 4, 10, 8, beam=False, planck=True)
    prop, bc, temf = f64(args)
    assert set(bench_bc) == set(bc) | {"umu0"}
    want = np.asarray(step(prop, dict(bc, umu0=bench_bc["umu0"]), temf))
    p = problems.extra_problem(2, 4, 10, 8, beam=False, planck=True,
                               dtype=torch.float64, device="cpu")
    assert "umu0" not in p.bc
    close(p.run().numpy(), want)
