"""The port at 66 to 128 streams against the JAX package's answers pinned
in ``tests/golden/stream128_jax.npz`` (``tests/make_stream128_golden.py``:
on a CPU JAX takes tens of minutes for each of them).

``Disort.forward`` (a beam, HG moments, Planck emission) at nstr 66, 128
and 130 (N = 65, past the bodies of N <= 64), and ``Disort.intensities``
(user angles and depths, the intensity correction) at nstr 66, through
the port's plain path in float64 against
JAX ``kernel="xla"`` in float64: 1e-12 of max|flux| and of max|uu|, the
bound ``tests/test_torch_stream64.py`` holds nstr 34 and 64 to.  The cases
are ``tests/make_stream64_golden.py``'s.  The float32 kernels that run
these stream counts on the card are held to the plain versions by
``chip_smoke.py`` phases 22 and 23.
"""

from __future__ import annotations

from pathlib import Path

import numpy as np
import pytest
import torch

from pyharp_tpu_torch import Disort, DisortOptions

from .make_stream64_golden import forward_case, intensity_case
from .make_stream128_golden import FORWARD_NSTR, INTENSITY_NSTR

GOLDEN = Path(__file__).resolve().parent / "golden" / "stream128_jax.npz"


@pytest.fixture(scope="module")
def gold():
    with np.load(GOLDEN) as f:
        return dict(f)


@pytest.fixture(autouse=True)
def one_thread():
    """One intra-op thread: the plain path's tensors are mid-sized, and
    with several test processes on the machine their threads contend."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _part(gold, prefix):
    n = len(prefix) + 2
    return {k[n:]: v for k, v in gold.items() if k.startswith(prefix + "__")}


def _bc(g):
    return {k[3:]: torch.tensor(v) for k, v in g.items() if k.startswith("bc_")}


@pytest.mark.parametrize("nstr", FORWARD_NSTR)
def test_forward_float64_matches_pinned_xla(gold, nstr):
    g = _part(gold, f"forward{nstr}")
    opts = forward_case(nstr)[0]
    got = Disort(DisortOptions(kernel="torch", **opts)).forward(
        torch.tensor(g["prop"]), _bc(g), torch.tensor(g["temf"])).numpy()
    want = g["flux"]
    assert got.shape == want.shape and np.isfinite(want).all()
    assert np.abs(got - want).max() <= 1e-12 * np.abs(want).max()


@pytest.mark.parametrize("nstr", INTENSITY_NSTR)
def test_intensities_float64_matches_pinned_xla(gold, nstr):
    g = _part(gold, f"intensities{nstr}")
    opts = intensity_case(nstr)[0]
    res = Disort(DisortOptions(kernel="torch", **opts)).intensities(
        torch.tensor(g["prop"]), _bc(g))
    for key in ("uu", "flux"):
        got, want = res[key].numpy(), g[key]
        assert got.shape == want.shape and np.isfinite(want).all(), key
        assert np.abs(got - want).max() <= 1e-12 * np.abs(want).max(), key
