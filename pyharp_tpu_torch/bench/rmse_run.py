"""The flux-accuracy matrix against the independent oracles (PyTorch port of
``pyharp_tpu/bench/rmse_run.py``): a compiled C Monte Carlo photon
transport (``tests/oracle/mc.py``, ``csrc/mc_oracle.c``, built with ``gcc``
into ``csrc/build/``) and the exact Chandrasekhar H-function
(``tests/oracle/hfunction.py``).

    python -m pyharp_tpu_torch.bench.rmse_run [--photons 1e8] [--out FILE]
        [--device cuda] [--dtype float64]

The matrix is the JAX script's:

  sources:      beam (mu0 = 0.6), beam + HG (g = 0.7), thermal (B linear
                in tau), fisot
  atmospheres:  thin (tau_tot = 0.4), thick (tau_tot = 8)
  streams:      nstr = 4, 8, 16

reported as the relative RMSE over all levels of (flup, fldn_total), the
scale the largest MC flux; then the semi-infinite anchor (32 layers of tau
2, nstr 16, three (w0, mu0) as three columns of one solve) against
1 - sqrt(1 - w0) H(mu0).  ``MC_CASES`` are ``tests/test_oracle_mc.py``'s
three Monte Carlo cases with their photon count and bound.

float64 (the default, the reference's validation dtype) takes the plain
versions on any device, as the JAX package takes XLA there; its g = 0
cases carry nstr zero moments, as the JAX script builds them.  float32 on
the card takes the kernels: its g = 0 cases carry no moment columns, so
the beam, thermal and fisot cases run K1 (beam and thermal variants), the
HG case K4, then K2 and K3 (nstr 4, 8) or K5 (nstr 16), on 1-3 columns.

Prints the tables; writes them only to ``--out``.
"""

from __future__ import annotations

import argparse
import os
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

from ..core.constants import stefanBoltzmann
from ..core.device import DEFAULT_DEVICE, resolve_device
from ..rt.disort.disort import Disort, DisortOptions
from .profile import card_line

REPO = Path(__file__).resolve().parents[2]
DTYPES = {"float64": torch.float64, "float32": torch.float32}


def _oracles():
    """The repo's test oracles (``tests/oracle``), imported from the
    checkout this package sits in.  The Monte Carlo library is built here
    first when it is missing or stale, into a temporary file renamed into
    place, so processes that start at once never load a half-written one."""
    if str(REPO) not in sys.path:
        sys.path.insert(0, str(REPO))
    from tests.oracle import hfunction, mc
    so, src = Path(mc._SO), Path(mc._SRC)
    if not so.exists() or src.stat().st_mtime > so.stat().st_mtime:
        so.parent.mkdir(parents=True, exist_ok=True)
        tmp = so.with_suffix(f".{os.getpid()}.so")
        subprocess.run(["gcc", "-O3", "-fPIC", "-std=c11", "-shared", "-o",
                        str(tmp), str(src), "-lm"], check=True,
                       capture_output=True, timeout=120)
        os.replace(tmp, so)
    return mc, hfunction


def _solve(dtau, ssa, g, albedo, nstr, bc, *, blev=None, bsurf=None,
           isotropic=False, dtype=torch.float64,
           device: torch.device | str = "cpu"):
    """Top-down (flup, fldn_total) per column ``(ncol, nlyr+1)`` of
    ``ncol`` columns of one layered atmosphere; ``ssa`` and the ``bc``
    values may differ by column (``(ncol,)``)."""
    dev = resolve_device(device)
    kw = dict(dtype=dtype, device=dev)
    dtau = np.asarray(dtau, np.float64)
    nlyr = len(dtau)
    ncol = max([np.size(ssa)] + [np.size(v) for v in bc.values()])
    nmom = 0 if isotropic and not g else nstr
    prop = np.zeros((1, ncol, nlyr, 2 + nmom))
    prop[..., 0] = dtau[::-1]                          # the solver: bottom-up
    prop[..., 1] = np.asarray(ssa, np.float64).reshape(-1, 1)
    if g:
        prop[..., 2:] = g ** np.arange(1, nmom + 1)
    flags = "lamber,quiet,onlyfl"
    temf = None
    bc = {k: torch.tensor(np.broadcast_to(np.asarray(v, np.float64),
                                          (1, ncol)).copy(), **kw)
          for k, v in dict(bc, albedo=albedo).items()}
    if blev is not None:
        # B(T) = sigma T^4 / pi: the level temperatures whose Planck
        # function is ``blev``
        flags += ",planck"
        tlev = (np.pi * np.asarray(blev) / stefanBoltzmann) ** 0.25
        temf = torch.tensor(np.broadcast_to(tlev[::-1], (ncol, nlyr + 1))
                            .copy(), **kw)
        bc["btemp"] = torch.full(
            (1, ncol), (np.pi * bsurf / stefanBoltzmann) ** 0.25, **kw)
    ds = Disort(DisortOptions(flags=flags, nwave=1, ncol=ncol, nlyr=nlyr,
                              nstr=nstr, nmom=max(nmom, nstr)))
    flux = ds.forward(torch.tensor(prop, **kw), bc, temf)[0]
    flux = flux.double().cpu().numpy()[:, ::-1]        # levels top-down
    return flux[..., 0], flux[..., 1]


def _solver_fluxes(dtau, ssa, g, albedo, nstr, source, blev=None,
                   bsurf=None, mu0=0.6, *, isotropic=False,
                   dtype=torch.float64, device: torch.device | str = "cpu"):
    """Top-down (flup, fldn_total) of one column under ``source`` (``beam``
    of 1 at ``mu0``, ``fisot`` of 1, or ``thermal`` with level Planck
    values ``blev`` and surface ``bsurf``), as the JAX
    ``rmse_run._solver_fluxes``; with ``isotropic`` a g = 0 problem carries
    no moment columns."""
    bc = dict(beam=dict(fbeam=1.0, umu0=mu0), fisot=dict(fisot=1.0),
              thermal={})[source]
    up, dn = _solve(dtau, ssa, g, albedo, nstr, bc,
                    blev=blev if source == "thermal" else None, bsurf=bsurf,
                    isotropic=isotropic, dtype=dtype, device=device)
    return up[0], dn[0]


def _mc(source, dtau, ssa, g, albedo, n_photons, blev=None, bsurf=None,
        mu0=0.6):
    mc, _ = _oracles()
    if source == "beam":
        return mc.mc_beam_flux(dtau, ssa, g, albedo, mu0, 1.0,
                               n_photons=n_photons)
    if source == "fisot":
        return mc.mc_isotropic_flux(dtau, ssa, g, albedo, 1.0,
                                    n_photons=n_photons)
    return mc.mc_thermal_flux(dtau, ssa, g, albedo, blev, bsurf,
                              n_photons=n_photons)


ATMOSPHERES = {"thin": np.full(4, 0.1), "thick": np.full(8, 1.0)}


def _cases(nlyr: int):
    blev = np.linspace(1.0, 3.0, nlyr + 1)
    return [
        ("beam iso w0=0.9", dict(ssa=0.9, g=0.0, albedo=0.2, source="beam")),
        ("beam HG g=0.7 w0=0.9", dict(ssa=0.9, g=0.7, albedo=0.2,
                                      source="beam")),
        ("thermal w0=0.35", dict(ssa=0.35, g=0.0, albedo=0.15,
                                 source="thermal", blev=blev, bsurf=3.5)),
        ("fisot w0=0.8", dict(ssa=0.8, g=0.0, albedo=0.3, source="fisot")),
    ]


def matrix(n_photons: int, dtype=torch.float64,
           device: torch.device | str = DEFAULT_DEVICE,
           nstrs=(4, 8, 16)) -> list[tuple]:
    """Rows ``(atmosphere, case, nstr, relative RMSE, MC seconds)``."""
    rows = []
    iso = dtype == torch.float32
    for aname, dtau in ATMOSPHERES.items():
        for cname, kw in _cases(len(dtau)):
            t0 = time.perf_counter()
            mup, mdn = _mc(kw["source"], dtau, kw["ssa"], kw["g"],
                           kw["albedo"], n_photons, kw.get("blev"),
                           kw.get("bsurf"))
            t_mc = time.perf_counter() - t0
            scale = max(mup.max(), mdn.max())
            for nstr in nstrs:
                up, dn = _solver_fluxes(dtau, nstr=nstr, isotropic=iso,
                                        dtype=dtype, device=device, **kw)
                r = np.sqrt(np.mean(np.concatenate(
                    [up - mup, dn - mdn]) ** 2)) / scale
                rows.append((aname, cname, nstr, float(r), t_mc))
    return rows


ANCHOR = ((0.3, 0.5), (0.9, 0.8), (0.99, 0.2))    # (w0, mu0)
ANCHOR_TOL = 2e-3            # tests/test_oracle_mc.py:123


def anchor(dtype=torch.float64, device: torch.device | str = DEFAULT_DEVICE
           ) -> list[tuple]:
    """Rows ``(w0, mu0, solver, exact, relative error)`` of the plane
    albedo of 32 layers of tau 2 (isotropic, nstr 16), the three cases as
    three columns of one solve."""
    _, hf = _oracles()
    w0 = np.array([w for w, _ in ANCHOR])
    mu0 = np.array([m for _, m in ANCHOR])
    up, _ = _solve(np.full(32, 2.0), w0, 0.0, 0.0, 16,
                   dict(fbeam=1.0, umu0=mu0),
                   isotropic=dtype == torch.float32, dtype=dtype,
                   device=device)
    rows = []
    for i, (w, m) in enumerate(ANCHOR):
        got, want = up[i, 0] / m, hf.plane_albedo(w, m)
        rows.append((w, m, float(got), want, float(abs(got - want) / want)))
    return rows


# tests/test_oracle_mc.py's Monte Carlo cases (:58-97): nstr 8, 4e6 photons,
# max|err| within 5e-3 of the scale (the largest MC flux; for fisot the
# largest down-flux)
MC_PHOTONS = 4_000_000
MC_TOL = 5e-3
MC_CASES = {
    "beam HG g=0.7": dict(dtau=np.full(4, 0.5), ssa=0.9, g=0.7, albedo=0.2,
                          source="beam"),
    "thermal": dict(dtau=np.array([0.2, 0.6, 1.2, 2.0]), ssa=0.35, g=0.0,
                    albedo=0.15, source="thermal",
                    blev=np.array([1.0, 1.4, 1.9, 2.3, 2.8]), bsurf=3.0),
    "fisot": dict(dtau=np.full(3, 0.8), ssa=0.8, g=0.0, albedo=0.3,
                  source="fisot"),
}


def mc_case_errors(n_photons: int = MC_PHOTONS, dtype=torch.float64,
                   device: torch.device | str = DEFAULT_DEVICE) -> dict:
    """Case -> (max|err| up, max|err| down) over the scale, nstr 8."""
    out = {}
    for name, kw in MC_CASES.items():
        kw = dict(kw)
        dtau = kw.pop("dtau")
        mup, mdn = _mc(kw["source"], dtau, kw["ssa"], kw["g"], kw["albedo"],
                       n_photons, kw.get("blev"), kw.get("bsurf"))
        up, dn = _solver_fluxes(dtau, nstr=8, isotropic=dtype == torch.float32,
                                dtype=dtype, device=device, **kw)
        scale = mdn.max() if kw["source"] == "fisot" else max(mup.max(),
                                                               mdn.max())
        out[name] = (float(np.abs(up - mup).max() / scale),
                     float(np.abs(dn - mdn).max() / scale))
    return out


def report(rows, anchors, n_photons: int, dtype, device) -> str:
    noise = 3.0 / np.sqrt(n_photons)    # ~3x a single tally's sigma
    lines = [
        "# RMSE: flux accuracy of the port against independent oracles",
        "",
        "References: the compiled C Monte Carlo transport "
        "(`csrc/mc_oracle.c`) and the exact Chandrasekhar H-function "
        "(`tests/oracle/hfunction.py`).",
        "",
        f"Solver: pyharp_tpu_torch, {str(dtype)[6:]} on {card_line(device)}; "
        f"MC photons per case {n_photons:.0e} (~{noise:.1e} relative "
        "1-sigma noise floor).",
        "",
        "| atmosphere | case | nstr | rel flux RMSE | MC wall |",
        "|---|---|---|---|---|"]
    lines += [f"| {a} | {c} | {n} | {r:.2e} | {t:.1f} s |"
              for a, c, n, r, t in rows]
    lines += ["", "## Exact semi-infinite anchor", "",
              "Plane albedo of a tau = 64 isotropic atmosphere against "
              "`1 - sqrt(1 - w0) H(mu0)` (nstr 16):", "",
              "| w0 | mu0 | solver | exact | rel err |",
              "|---|---|---|---|---|"]
    lines += [f"| {w} | {m} | {g:.6f} | {e:.6f} | {r:.2e} |"
              for w, m, g, e, r in anchors]
    return "\n".join(lines) + "\n"


def main(argv=None) -> tuple:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--photons", type=float, default=1e8)
    ap.add_argument("--out", default=None, help="write the tables here")
    ap.add_argument("--device", default=DEFAULT_DEVICE)
    ap.add_argument("--dtype", default="float64", choices=tuple(DTYPES))
    a = ap.parse_args(argv)
    dev, dtype = resolve_device(a.device), DTYPES[a.dtype]
    n_ph = int(a.photons)
    rows = matrix(n_ph, dtype, dev)
    anchors = anchor(dtype, dev)
    text = report(rows, anchors, n_ph, dtype, dev)
    print(text, end="")
    if a.out:
        Path(a.out).write_text(text)
        print(f"wrote {a.out} ({len(rows)} rows)")
    return rows, anchors


if __name__ == "__main__":
    main()
