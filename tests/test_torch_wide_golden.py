"""The port at 18 to 32 streams against the JAX package's answers pinned in
``tests/golden/wide_streams_jax.npz`` (``tests/make_wide_golden.py``: on a
CPU JAX takes minutes for each of them).

Tolerances, as the kernel tests hold the same kernels at N <= 8:

* K4's plain version in float32 against the Pallas body in float32 at
  nstr 18, m = 0 (phase moments, a thermal source, a beam) and m = 1 (the
  eigenstructure): max|err| <= 3e-5 max|ref| per output
  (``tests/test_torch_scattering_kernels.py``);
* K2 + K5's plain versions against the XLA ``solve_bvp`` at nstr 32 and
  18: in float32 atol 3e-5 max|ref|, rtol 3e-4 (the Pallas bound,
  ``tests/test_pallas_kernels.py:70``), in float64 1e-12 of max|ref| (the
  same recurrence);
* ``Disort.forward`` (beam, HG moments, Planck) and ``Disort.intensities``
  (user angles and depths, the intensity correction) at nstr 32 through
  the plain path in float64 against JAX ``kernel="xla"`` in float64:
  1e-12 of max|flux| and of max|uu| (``tests/test_torch_beam_disort.py``'s
  bound at nstr 16 with moments).
"""

from __future__ import annotations

from pathlib import Path

import numpy as np
import pytest
import torch

from pyharp_tpu_torch import Disort, DisortOptions
from pyharp_tpu_torch.rt.disort import kernels as K
from pyharp_tpu_torch.rt.disort import solver as TS
from pyharp_tpu_torch.rt.disort.legendre import lepoly

from .make_wide_golden import forward_case, intensity_case

GOLDEN = Path(__file__).resolve().parent / "golden" / "wide_streams_jax.npz"


@pytest.fixture(scope="module")
def gold():
    with np.load(GOLDEN) as f:
        return dict(f)


def _part(gold, prefix):
    n = len(prefix) + 2
    return {k[n:]: v for k, v in gold.items() if k.startswith(prefix + "__")}


@pytest.mark.parametrize("m", [0, 1])
def test_k4_plain_matches_pinned_pallas(gold, m):
    g = _part(gold, f"k4_m{m}")
    nstr = g["pmom"].shape[1]
    ang = TS.make_static_angles(nstr, nstr, m)
    t = {k: torch.tensor(g[k], dtype=torch.float32)
         for k in ("ssa", "pmom", "dtau", "btop", "slope", "fbeam", "mu0",
                   "mur")}
    kw = dict(thermal=m == 0)
    if m == 0:
        kw.update(fbeam=t["fbeam"], mur=t["mur"],
                  lam0=lepoly(t["mu0"], 0, ang.lam_tables.shape[0] - 1))
    got = K.stage1_general(t["ssa"], t["pmom"], t["dtau"], t["btop"],
                           t["slope"], ang, **kw)
    want = [g[f"out{i}"] for i in range(len(got))]
    assert len(got) == (9 if m == 0 else 7)
    for i, (x, w) in enumerate(zip(got, want)):
        x = x.numpy()
        assert x.shape == w.shape and np.isfinite(x).all(), i
        assert np.abs(x - w).max() <= 3e-5 * np.abs(w).max(), (
            i, np.abs(x - w).max() / np.abs(w).max())
    assert K.launch_counts()["stage1_general"] == 0    # CPU: no kernel


def _port_bvp(g, nstr, dtype):
    """K2 + K5 through the wrappers on CPU tensors (the plain versions)."""
    g = {k: torch.tensor(v).to(dtype) for k, v in g.items()}
    ang = TS.make_static_angles(nstr, nstr, 0)
    dblk = TS.bvp_rhs(g["ptop_p"], g["ptop_m"], g["pbot_p"], g["pbot_m"],
                      g["ftop"], g["bot_rhs"])
    P, gg = K.bvp_forward(g["gp"], g["gm"], g["expd"], dblk, g["albedo"], ang)
    return K.bvp_backward(g["gp"], g["gm"], g["expd"], P, gg, ang)


@pytest.mark.parametrize("nstr", [32, 18])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_bvp_plain_matches_pinned_xla(gold, nstr, dtype):
    """A solve's BVP through JAX's XLA ``solve_bvp``, run eagerly (its
    interpret-mode Pallas version does not finish on a CPU at these N)."""
    g = _part(gold, f"bvp_xla{nstr}_{'f32' if dtype == torch.float32 else 'f64'}")
    got = _port_bvp(g, nstr, dtype)
    for x, w in zip(got, (g["a"], g["b"])):
        x = x.numpy()
        assert x.dtype == w.dtype and np.isfinite(x).all()
        if dtype == torch.float32:
            np.testing.assert_allclose(x, w, atol=3e-5 * np.abs(w).max(),
                                       rtol=3e-4)
        else:
            assert np.abs(x - w).max() <= 1e-12 * np.abs(w).max()


def test_forward_float64_matches_pinned_xla(gold):
    g = _part(gold, "forward")
    opts = forward_case()[0]
    bc = {k[3:]: torch.tensor(v) for k, v in g.items() if k.startswith("bc_")}
    got = Disort(DisortOptions(kernel="torch", **opts)).forward(
        torch.tensor(g["prop"]), bc, torch.tensor(g["temf"])).numpy()
    want = g["flux"]
    assert got.shape == want.shape and np.isfinite(want).all()
    assert np.abs(got - want).max() <= 1e-12 * np.abs(want).max()


def test_intensities_float64_matches_pinned_xla(gold):
    g = _part(gold, "intensities")
    opts = intensity_case()[0]
    bc = {k[3:]: torch.tensor(v) for k, v in g.items() if k.startswith("bc_")}
    res = Disort(DisortOptions(kernel="torch", **opts)).intensities(
        torch.tensor(g["prop"]), bc)
    for key in ("uu", "flux"):
        got, want = res[key].numpy(), g[key]
        assert got.shape == want.shape and np.isfinite(want).all(), key
        assert np.abs(got - want).max() <= 1e-12 * np.abs(want).max(), key
