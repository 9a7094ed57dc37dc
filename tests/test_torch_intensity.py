"""The radiance path of the PyTorch port (``Disort.intensities``, every
azimuthal mode, user angles and depths, the TMS/IMS corrections,
``albedo_transmissivity``, the band radiances) against the JAX package's
``kernel="xla"`` path, float64 on the CPU.

The inputs are ``tests/intensity_cases.py``'s, drawn from numpy seeds; the
JAX answers on them are pinned in ``tests/golden/intensity_jax_f64.npz`` by
``tests/make_intensity_golden.py`` (JAX's eager radiance path compiles
every operation of every case, minutes in all).  Each output is held to
max|err| <= 1e-9 max|ref|.  The port's plain versions run K4's Jacobi
sweep count (3/4/8 at N <= 2/4/8) where JAX's XLA path runs 6/10/14; both
have converged to ~1e-15, so the modes come out in another order but every
radiance agrees.

Also here: the static kernel route (``kernels.route``) as a table, and K4's
plain version at m >= 1 (the mode's tables and its beam prefactor 2/(4 pi))
against JAX's ``homogeneous_solution_t`` and ``beam_particular_t``.
"""

import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from pyharp_tpu_torch import Disort, DisortOptions
from pyharp_tpu_torch.opacity.base import AttenuatorOptions
from pyharp_tpu_torch.radiation import (Radiation, RadiationBand,
                                        RadiationBandOptions,
                                        RadiationOptions)
from pyharp_tpu_torch.rt.disort import kernels as K
from pyharp_tpu_torch.rt.disort.legendre import lepoly
from pyharp_tpu_torch.rt.disort.solver import make_static_angles
from pyharp_tpu_torch.utils import read_radiance_bin

sys.path.insert(0, str(Path(__file__).resolve().parent))
import intensity_cases as C  # noqa: E402

GOLDEN = np.load(Path(__file__).resolve().parent / "golden"
                 / "intensity_jax_f64.npz")
REL = 1e-9


def _close(got, want, what, rel=REL):
    got = np.asarray(got)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    scale = max(np.abs(want).max(), 1e-300)
    err = np.abs(got - want).max() / scale
    assert err <= rel, f"{what}: max|err|/max|ref| {err:.2e} > {rel}"


def _torch_inputs(c):
    bc = {k: torch.as_tensor(v, dtype=torch.float64)
          for k, v in c["bc"].items()}
    temf = None if c["temf"] is None else torch.tensor(c["temf"])
    return torch.tensor(c["prop"]), bc, temf


def _run(name, kernel="torch"):
    c = C.case(name)
    ds = Disort(DisortOptions(kernel=kernel, **c["opts"]))
    prop, bc, temf = _torch_inputs(c)
    if c["call"] == "albedo_transmissivity":
        return ds, ds.albedo_transmissivity(prop, c["bc"]["albedo"])
    return ds, ds.intensities(prop, bc, temf)


@pytest.mark.parametrize("name", C.CASES)
def test_intensities_match_jax_f64(name):
    ds, out = _run(name)
    keys = (("albmed", "trnmed") if name == "ibcnd"
            else ("uu", "uum", "flux"))
    for k in keys:
        _close(out[k].numpy(), GOLDEN[f"{name}__{k}"], f"{name} {k}")
    if name != "ibcnd":
        np.testing.assert_array_equal(ds.gather_rad().numpy(),
                                      out["uu"].numpy())
        # CPU float64 tensors: kernel="auto" routes to the same plain path
        _, auto = _run(name, kernel="auto")
        np.testing.assert_array_equal(auto["uu"].numpy(), out["uu"].numpy())


@pytest.mark.parametrize("name", C.SOURCELESS_MODES)
def test_modes_without_a_source_are_zero(name):
    """Without a beam, or without a phase moment, every source of the modes
    m >= 1 vanishes: JAX's ``uum[1:]`` is exactly 0, and the port skips
    those solves and returns 0."""
    assert not np.any(GOLDEN[f"{name}__uum"][1:])
    ds, out = _run(name)
    assert not torch.any(out["uum"][1:])
    assert ds._modes_batched(ds._prepare(*_torch_inputs(C.case(name)))) is None


def test_node_angles_reproduce_the_node_solution():
    """At the quadrature angles the m = 0 sweep equals the node expansion
    of the BVP solution (``tests/test_intensity.py:46``)."""
    ds, out = _run("node_angle")
    up, dn = ds._last["up_all"], ds._last["dn_all"]        # (N, L+1, B)
    node_mu = list(np.round(ds._ang0.mu, 12))
    uum = out["uum"][0].reshape(-1, *out["uum"].shape[3:])  # (B, ntau, numu)
    for i, mu in enumerate(out["user_mu"]):
        j = node_mu.index(round(abs(mu), 12))
        want = (up if mu > 0 else dn)[j].T                   # (B, L+1)
        np.testing.assert_allclose(uum[:, :, i], want, rtol=0, atol=1e-12)


@pytest.mark.parametrize("name", ["tms_ims", "spher_beam", "thermal_gensrc"])
def test_intensities_flux_is_forward_flux(name):
    """``intensities`` (K2 + K5 at every N, the flux from the node
    intensities) returns ``forward``'s fluxes (K3 at N <= 4)."""
    c = C.case(name)
    ds = Disort(DisortOptions(kernel="torch", **c["opts"]))
    args = _torch_inputs(c)
    np.testing.assert_allclose(ds.intensities(*args)["flux"].numpy(),
                               ds.forward(*args).numpy(), rtol=1e-12,
                               atol=1e-14)


@pytest.mark.parametrize("name", ["spher_beam", "isotropic_beam"])
def test_forward_and_fluxes_accessor_match_jax_f64(name):
    """``forward`` and ``fluxes()`` (up, diffuse down, and the direct beam
    on the unscaled slant depth) against the JAX package's."""
    c = C.case(name)
    ds = Disort(DisortOptions(kernel="torch", **c["opts"]))
    with pytest.raises(RuntimeError, match="forward"):
        ds.fluxes()
    _close(ds.forward(*_torch_inputs(c)).numpy(), GOLDEN[f"{name}__forward"],
           f"{name} forward")
    for k, v in zip(("flup", "rfldn", "rfldir"), ds.fluxes()):
        _close(v.numpy(), GOLDEN[f"{name}__{k}"], f"{name} {k}")


def test_user_taus_at_the_levels_are_the_level_radiances():
    """User taus placed on the levels give the level radiances
    (``tests/test_intensity.py:170``)."""
    c = C.case("node_angle")
    prop, bc, _ = _torch_inputs(c)
    lvl = Disort(DisortOptions(kernel="torch", **c["opts"])).intensities(
        prop[:, :1], {k: v[:, :1] for k, v in bc.items()})
    taus = np.concatenate([[0.0], np.cumsum(c["prop"][0, 0, ::-1, 0])])
    opts = dict(c["opts"], ncol=1, flags=c["opts"]["flags"] + ",usrtau",
                user_tau=tuple(taus))
    at = Disort(DisortOptions(kernel="torch", **opts)).intensities(
        prop[:, :1], {k: v[:, :1] for k, v in bc.items()})
    np.testing.assert_allclose(at["uu"][0].numpy(), lvl["uu"][0].numpy(),
                               rtol=1e-10, atol=1e-14)


# ---- K4's plain version at m >= 1 ------------------------------------------

def _by_eigenvalue(lam, gp, gm):
    """Modes sorted by eigenvalue per element, each eigenvector's sign
    fixed by its largest entry: the order-free form of a stage-1 output."""
    order = np.argsort(lam, axis=0)                     # (N, L, B)
    lam = np.take_along_axis(lam, order, axis=0)
    gp = np.take_along_axis(gp, order[None], axis=1)
    gm = np.take_along_axis(gm, order[None], axis=1)
    both = np.concatenate([gp, gm], axis=0)             # (2N, N, L, B)
    big = np.take_along_axis(both, np.abs(both).argmax(0)[None], axis=0)
    sign = np.sign(big)
    return lam, gp * sign, gm * sign


@pytest.mark.parametrize("nstr", [4, 8])
def test_k4_plain_at_every_mode_matches_jax_f64(nstr):
    """``kernels.stage1_general_plain`` with the tables of mode m = 1..nstr-1,
    no thermal source and the beam's Lam_l^m(mu0), against JAX's
    ``homogeneous_solution_t`` + ``beam_particular_t`` with kappa = 2/(4 pi)
    (``disort.py:545-552``); the CPU wrapper gives the same bits."""
    x = C.k4_modes_inputs(nstr)
    ssa, pmom, dtau = (torch.tensor(x[k]) for k in ("ssa", "pmom", "dtau"))
    fbeam, mu0 = torch.tensor(x["fbeam"]), torch.tensor(x["mu0"])
    zero = torch.zeros_like(ssa)
    mur = mu0[None].expand_as(ssa).contiguous()
    for m in range(1, nstr):
        ang = make_static_angles(nstr, nstr, m)
        lam0 = lepoly(mu0, m, ang.lam_tables.shape[0] - 1)
        args = (ssa, pmom, dtau, zero, zero, ang)
        kw = dict(thermal=False, fbeam=fbeam, mur=mur, lam0=lam0)
        out = K.stage1_general_plain(*args, **kw)
        for o, w in zip(out, K.stage1_general(*args, **kw)):
            assert torch.equal(o, w)
        assert not any(torch.any(y) for y in out[4:7])
        key = f"k4_nstr{nstr}_m{m}__"
        got = _by_eigenvalue(*(t.numpy() for t in (out[2], out[0], out[1])))
        want = _by_eigenvalue(*(GOLDEN[key + k] for k in ("lam", "gp", "gm")))
        for g, w, k in zip(got, want, ("lam", "gp", "gm")):
            _close(g, w, f"m {m} {k}")
        for i, k in ((7, "zp"), (8, "zm")):
            _close(out[i].numpy(), GOLDEN[key + k], f"m {m} {k}")


# ---- the static kernel route -----------------------------------------------

@pytest.mark.parametrize("kernel,device,dtype,N,want", [
    ("auto", "cuda", torch.float32, 4, "cuda"),
    ("auto", "cuda", torch.float32, 8, "cuda"),
    ("auto", "cuda", torch.float32, 3, "cuda"),      # nstr 6
    ("auto", "cuda", torch.float32, 6, "cuda"),      # nstr 12
    ("auto", "cuda", torch.float32, 1, "cuda"),      # nstr 2
    ("auto", "cuda", torch.float64, 4, "torch"),
    ("auto", "cuda", torch.float64, 3, "torch"),
    ("auto", "cpu", torch.float32, 4, "torch"),
    ("auto", "cpu", torch.float64, 8, "torch"),
    ("torch", "cuda", torch.float32, 4, "torch"),
    ("cuda", "cuda", torch.float64, 3, "cuda"),      # the wrappers raise
    *(("auto", "cuda", torch.float32, n, "cuda") for n in range(9, 17)),
    ("cuda", "cuda", torch.float32, 16, "cuda"),     # nstr 32
    ("auto", "cuda", torch.float64, 16, "torch"),
    ("auto", "cpu", torch.float32, 16, "torch"),
    *(("auto", "cuda", torch.float32, n, "cuda") for n in range(17, 33)),
    ("cuda", "cuda", torch.float32, 32, "cuda"),     # nstr 64
    ("auto", "cuda", torch.float64, 32, "torch"),
    ("auto", "cpu", torch.float32, 32, "torch"),
    *(("auto", "cuda", torch.float32, n, "cuda") for n in range(33, 65)),
    ("cuda", "cuda", torch.float32, 64, "cuda"),     # nstr 128
    ("auto", "cuda", torch.float64, 64, "torch"),
    ("auto", "cpu", torch.float32, 64, "torch"),
])
def test_route_is_a_function_of_device_dtype_and_n(kernel, device, dtype, N,
                                                   want):
    """``kernels.route``: the kernels for float32 CUDA tensors under
    "auto" (every nstr up to 128 has a kernel), the plain versions
    otherwise, as the JAX package's ``_use_pallas``
    (``disort.py:311-319``); decided before any launch, from these three
    facts alone."""
    assert K.route(kernel, device, dtype, N) == want


def test_route_refuses_what_it_cannot_run():
    with pytest.raises(ValueError, match="CUDA tensors"):
        K.route("cuda", "cpu", torch.float32, 4)
    with pytest.raises(ValueError, match="kernel must be"):
        K.route("pallas", "cuda", torch.float32, 4)
    # every nstr 66..128 has a kernel (the bodies of csrc/*_huge.cu)
    assert all(K.route("auto", "cuda", torch.float32, n) == "cuda"
               for n in range(33, 65))
    # no kernel at nstr > 128: float32 on the card raises, it is not
    # handed to the plain versions
    for kernel in ("auto", "cuda"):
        with pytest.raises(ValueError, match="no CUDA kernel for N = 65"):
            K.route(kernel, "cuda", torch.float32, 65)
    assert K.route("auto", "cuda", torch.float64, 65) == "torch"
    assert K.route("auto", "cpu", torch.float32, 65) == "torch"
    ds = Disort(DisortOptions(kernel="cuda", nstr=4))
    with pytest.raises(ValueError, match="CUDA tensors"):
        ds._kernels(torch.device("cpu"), torch.float32)
    k = Disort(DisortOptions(nstr=6))._kernels(torch.device("cpu"),
                                               torch.float32)
    assert k.route == "torch" and k.bvp_forward is K.bvp_forward_plain


# ---- print-* diagnostics -------------------------------------------------------

def test_print_flags(capsys):
    c = C.case("node_angle")
    flags = (c["opts"]["flags"] + ",print-input,print-fluxes,"
             "print-intensity,print-phase-function")
    ds = Disort(DisortOptions(kernel="torch", **dict(c["opts"], flags=flags,
                                                      header="T")))
    out = ds.intensities(*_torch_inputs(c))
    text = capsys.readouterr().out
    for head in ("T: input (wave 0, col 0)", "T: phase moments",
                 "T: fluxes (wave 0, col 0)", "T: intensities (wave 0, col 0)"):
        assert head in text
    assert f"{out['uu'][0, 0, 0, 0, 0].item():12.5e}" in text
    d = C.case("ibcnd")
    ds = Disort(DisortOptions(kernel="torch", **dict(
        d["opts"], flags=d["opts"]["flags"] + ",print-transmissivity")))
    res = ds.albedo_transmissivity(torch.tensor(d["prop"]), 0.1)
    text = capsys.readouterr().out
    assert "albedo/transmissivity" in text
    assert f"{res['trnmed'][0, 0, 0].item():11.5e}" in text
    with pytest.raises(ValueError, match="ibcnd"):
        ds.forward(torch.tensor(d["prop"]), {})


# ---- band radiances ------------------------------------------------------------

def _sw_band(b):
    op = AttenuatorOptions(species_names=("S8", "H2SO4"),
                           species_weights=(256.0e-3, 98.0e-3))
    return RadiationBandOptions(
        name="sw", nlyr=b["nlyr"], ncol=b["ncol"],
        wave_lower=(2000.0,) * b["nwave"], wave_upper=(50000.0,) * b["nwave"],
        outdirs=b["outdirs"], wavenumber=b["wavenumber"],
        attenuators=(
            ("s8", op.replace(species_ids=(0,), type="s8_fuller",
                              opacity_files=("s8_k_fuller.txt",))),
            ("h2so4", op.replace(species_ids=(1,), type="h2sO4_simple",
                                 opacity_files=("h2so4.txt",)))),
        disort=DisortOptions(flags=b["flags"], nstr=4, nmom=4,
                             kernel="torch"))


def _band_inputs(b):
    return (torch.tensor(b["conc"]), torch.tensor(b["dz"]),
            {k: torch.tensor(v) for k, v in b["bc"].items()})


def test_band_radiances_match_jax_and_round_trip(tmp_path):
    """``Radiation.band_radiances`` on ``tests/test_band.py:358-390``'s band
    against the JAX package's, then ``write_radiances`` as ASCII and as
    binary, read back."""
    b = C.band_case()
    bop = _sw_band(b)
    rad = Radiation(RadiationOptions(bands=("sw",), band_options=(bop,)),
                    dtype=torch.float64, device="cpu")
    inputs = _band_inputs(b)
    rads = rad.band_radiances(*inputs)
    assert set(rads) == {"sw"}
    _close(rads["sw"].numpy(), GOLDEN["band__sw"], "band radiances")
    assert torch.all(rads["sw"] > 0)

    paths = rad.write_radiances(str(tmp_path / "rad_"), *inputs)
    assert paths == [str(tmp_path / "rad_sw.txt")]
    txt = Path(paths[0]).read_text()
    assert "rays (mu, phi)" in txt and len(txt.splitlines()) == 2 + b["nwave"]
    rad_bin = Radiation(RadiationOptions(bands=("sw",), band_options=(bop,),
                                         write_bin_radiance=True),
                        dtype=torch.float64, device="cpu")
    paths = rad_bin.write_radiances(str(tmp_path / "radb_"), *inputs)
    data, rays = read_radiance_bin(paths[0])
    np.testing.assert_array_equal(data, rads["sw"][:, 0].numpy())
    np.testing.assert_array_equal(rays, rad.bands["sw"].rayout)


def test_band_radiance_refuses_a_ray_off_the_grid():
    """The JAX gather takes the nearest grid point unchecked
    (``band.py:271-274``); the port raises for a ray that is not on the
    solver's direction grids."""
    b = C.band_case()
    band = RadiationBand(_sw_band(b), dtype=torch.float64, device="cpu")
    opts = band.rtsolver.options
    band.rtsolver = Disort(opts.replace(
        user_mu=tuple(m + 0.01 for m in opts.user_mu)))
    with pytest.raises(ValueError, match="not on the solver's grids"):
        band.band_radiance(*_band_inputs(b))


def test_fused_bands_bypass_their_solvers_fluxes_accessor():
    """``Radiation.forward(fuse_bands=True)`` solves compatible bands in one
    Disort and marks each band's own solver bypassed: its ``fluxes()``
    raises until the band solves again (``radiation.py:303-306``)."""
    b = C.band_case()
    bop = _sw_band(b).replace(disort=DisortOptions(flags="lamber,quiet",
                                                   nstr=4, nmom=4))
    rad = Radiation(RadiationOptions(bands=("x", "y"),
                                     band_options=(bop, bop)),
                    dtype=torch.float64, device="cpu")
    inputs = _band_inputs(b)
    fused = rad.forward(*inputs, fuse_bands=True)
    for band in rad.bands.values():
        with pytest.raises(RuntimeError, match="fuse_bands"):
            band.rtsolver.fluxes()
    seq = rad.forward(*inputs)
    np.testing.assert_allclose(fused.numpy(), seq.numpy(), rtol=1e-12)
    for band in rad.bands.values():
        assert band.rtsolver.fluxes()[0].shape == (b["nlyr"] + 1,
                                                   b["nwave"] * b["ncol"])
