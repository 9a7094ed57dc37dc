"""The problems of the measurement drivers, drawn as the JAX package's
scripts draw them.

* :func:`bench_problem`: ``bench.py:41-78`` (8 g-points, ``lamber,quiet,
  onlyfl,planck``, band edges (1, 500), the weighted g-point sum);
* :func:`extra_problem`: ``bench_extra.py:46-83`` (``build``: a beam, a
  Planck source, Henyey-Greenstein moments, the mean over waves);
* :func:`radiance_problem`: ``bench_extra.py:134-168`` (the radiances at 4
  user cosines x 2 azimuths x 3 user depths);
* :func:`stage_inputs`: the batch-last stage inputs of
  ``pyharp_tpu/bench/stages.py:52-62`` and ``roofline_run.py:137-145``;
* :func:`stage1_inputs`: stage-1 inputs with ssa set to 0 and 0.999999 in
  some entries, the edges of K1's secular solve.

Each draw is made with numpy from a seed, in float32 as the scripts make
it, and then put on the requested device in the requested dtype, so every
dtype and device sees the same values.
"""

from __future__ import annotations

from typing import Callable, NamedTuple

import numpy as np
import torch
from torch import Tensor

from ..core.device import DEFAULT_DEVICE, resolve_device
from ..rt.disort.disort import Disort, DisortOptions


class Problem(NamedTuple):
    """A solver, its inputs and the step of the script it mirrors:
    ``step(prop, bc, temf)`` returns that script's reduced output."""
    disort: Disort
    prop: Tensor
    bc: dict
    temf: Tensor | None
    weights: Tensor | None
    step: Callable

    @property
    def args(self) -> tuple:
        return self.prop, self.bc, self.temf

    def run(self):
        return self.step(*self.args)


def _full(shape, value: float, **kw) -> Tensor:
    """``torch.full`` of ``value`` rounded to float32, as the scripts make
    their boundary values, in any dtype."""
    return torch.full(shape, float(np.float32(value)), **kw)


def _levels(ncol: int, nlyr: int, **kw) -> Tensor:
    """Level temperatures 200-300 K, bottom-up, every column alike."""
    temf = np.linspace(200.0, 300.0, nlyr + 1, dtype=np.float32)
    return torch.tensor(np.broadcast_to(temf, (ncol, nlyr + 1)).copy(), **kw)


def bench_problem(nwave: int = 8, ncol: int = 8192, nlyr: int = 100,
                  nstr: int = 8, dtype: torch.dtype = torch.float32,
                  device: torch.device | str = DEFAULT_DEVICE,
                  kernel: str = "auto", seed: int = 0,
                  distinct_bins: bool = False) -> Problem:
    """``bench.build_problem``: isotropic thermal emission, tau in [0.001,
    0.8], ssa in [0, 0.6], albedo 0.1, a 300 K surface, levels 200-300 K,
    every bin (1, 500) cm^-1, the g-points summed with equal weights.

    With ``distinct_bins`` the bins tile 1-500 cm^-1 instead, as the
    sharded runs need (a rank must integrate Planck over its own bins).
    ``bc`` holds no ``fbeam``, as in ``bench.py`` (a ``bc`` with ``fbeam``
    runs K1's beam variant)."""
    kw = dict(dtype=dtype, device=resolve_device(device))
    if distinct_bins:
        edges = np.linspace(1.0, 500.0, nwave + 1)
        lower, upper = tuple(edges[:-1]), tuple(edges[1:])
    else:
        lower, upper = (1.0,) * nwave, (500.0,) * nwave
    disort = Disort(DisortOptions(
        flags="lamber,quiet,onlyfl,planck", nwave=nwave, ncol=ncol,
        nlyr=nlyr, nstr=nstr, nmom=nstr, wave_lower=lower, wave_upper=upper,
        kernel=kernel))
    rng = np.random.default_rng(seed)
    prop = np.zeros((nwave, ncol, nlyr, 2), np.float32)
    prop[..., 0] = rng.uniform(0.001, 0.8, (nwave, ncol, nlyr))
    prop[..., 1] = rng.uniform(0.0, 0.6, (nwave, ncol, nlyr))
    bc = dict(umu0=_full((nwave, ncol), 0.5, **kw),
              albedo=_full((nwave, ncol), 0.1, **kw),
              btemp=_full((nwave, ncol), 300.0, **kw))
    weights = _full((nwave,), 1.0 / nwave, **kw)

    def step(prop, bc, temf):
        return torch.einsum("g,g...->...", weights,
                            disort.forward(prop, bc, temf))

    return Problem(disort, torch.tensor(prop, **kw), bc,
                   _levels(ncol, nlyr, **kw), weights, step)


def extra_problem(nwave: int, ncol: int, nlyr: int, nstr: int, *,
                  beam: bool = True, planck: bool = False, g: float = 0.0,
                  dtype: torch.dtype = torch.float32,
                  device: torch.device | str = DEFAULT_DEVICE,
                  kernel: str = "auto", seed: int = 0,
                  first: int | None = None) -> Problem:
    """``bench_extra.build``: tau in [0.001, 0.8], ssa in [0.1, 0.95],
    moments g^l when ``g`` is set, albedo 0.3; with ``beam`` a beam of pi
    at mu0 = 0.7, with ``planck`` a 300 K surface, levels 200-300 K and
    band edges (1, 500); the fluxes averaged over waves.  With ``first``,
    only the first waves of the same draw."""
    kw = dict(dtype=dtype, device=resolve_device(device))
    nmom = nstr if g else 0
    rng = np.random.default_rng(seed)
    prop = np.zeros((nwave, ncol, nlyr, 2 + nmom), np.float32)
    prop[..., 0] = rng.uniform(0.001, 0.8, (nwave, ncol, nlyr))
    prop[..., 1] = rng.uniform(0.1, 0.95, (nwave, ncol, nlyr))
    if nmom:
        prop[..., 2:] = g ** np.arange(1, nmom + 1)
    if first is not None:
        nwave, prop = first, prop[:first]
    disort = Disort(DisortOptions(
        flags="lamber,quiet,onlyfl" + (",planck" if planck else ""),
        nwave=nwave, ncol=ncol, nlyr=nlyr, nstr=nstr, nmom=max(nmom, nstr),
        wave_lower=(1.0,) * nwave if planck else (),
        wave_upper=(500.0,) * nwave if planck else (), kernel=kernel))
    bc = dict(albedo=_full((nwave, ncol), 0.3, **kw))
    temf = None
    if beam:
        bc["fbeam"] = _full((nwave, ncol), float(np.pi), **kw)
        bc["umu0"] = _full((nwave, ncol), 0.7, **kw)
    if planck:
        bc["btemp"] = _full((nwave, ncol), 300.0, **kw)
        temf = _levels(ncol, nlyr, **kw)

    def step(prop, bc, temf):
        return disort.forward(prop, bc, temf).mean(dim=0)

    return Problem(disort, torch.tensor(prop, **kw), bc, temf, None, step)


# bench_extra.py:134-168, radiances_8str_4mu_2phi_3tau: (nwave, ncol, nlyr,
# nstr), the user cosines, azimuths and depths, the flags
RAD_SHAPE = (32, 512, 40, 8)
RAD_MU = (-0.8, -0.4, 0.4, 0.8)
RAD_PHI = (0.0, float(np.pi / 2))
RAD_TAU = (0.5, 2.0, 5.0)
RAD_FLAGS = "lamber,quiet,usrang,usrtau,intensity_correction"


def radiance_problem(dtype: torch.dtype = torch.float32,
                     device: torch.device | str = DEFAULT_DEVICE,
                     kernel: str = "auto", shape=RAD_SHAPE,
                     seed: int = 0) -> Problem:
    """``bench_extra.py:134-168``'s radiance configuration: tau in [0.01,
    0.5], ssa in [0.1, 0.9], HG moments g_l = 0.7^l, a beam of pi at mu0 =
    0.7, albedo 0.2; the step returns the radiances ``uu``."""
    kw = dict(dtype=dtype, device=resolve_device(device))
    nwave, ncol, nlyr, nstr = shape
    disort = Disort(DisortOptions(
        flags=RAD_FLAGS, nwave=nwave, ncol=ncol, nlyr=nlyr, nstr=nstr,
        nmom=nstr, user_mu=RAD_MU, user_phi=RAD_PHI, user_tau=RAD_TAU,
        kernel=kernel))
    rng = np.random.default_rng(seed)
    prop = np.zeros((nwave, ncol, nlyr, 2 + nstr), np.float32)
    prop[..., 0] = rng.uniform(0.01, 0.5, (nwave, ncol, nlyr))
    prop[..., 1] = rng.uniform(0.1, 0.9, (nwave, ncol, nlyr))
    prop[..., 2:] = 0.7 ** np.arange(1, nstr + 1)
    bc = dict(albedo=_full((nwave, ncol), 0.2, **kw),
              fbeam=_full((nwave, ncol), float(np.pi), **kw),
              umu0=_full((nwave, ncol), 0.7, **kw))

    def step(prop, bc, temf=None):
        return disort.intensities(prop, bc)["uu"]

    return Problem(disort, torch.tensor(prop, **kw), bc, None, None, step)


def stage_inputs(L: int = 100, B: int = 8 * 8192, nstr: int = 8,
                 dtype: torch.dtype = torch.float32,
                 device: torch.device | str = DEFAULT_DEVICE,
                 seed: int = 0) -> dict[str, Tensor]:
    """Batch-last stage inputs of ``pyharp_tpu/bench/stages.py:52-62``
    (and, but for ``bot_rhs``, ``roofline_run.py:137-145``): ssa, pmom
    ``(L, nstr, B)``, dtau, btop, slope, albedo 0.1, ftop 0 and bot_rhs
    ``(N, B)``, drawn in that order."""
    kw = dict(dtype=dtype, device=resolve_device(device))
    N = nstr // 2
    rng = np.random.default_rng(seed)
    draws = dict(ssa=rng.uniform(0.0, 0.6, (L, B)),
                 pmom=rng.uniform(0.0, 0.3, (L, nstr, B)),
                 dtau=rng.uniform(0.001, 0.8, (L, B)),
                 btop=rng.uniform(0.0, 1.0, (L, B)),
                 slope=rng.uniform(-0.1, 0.1, (L, B)))
    out = {k: torch.tensor(v.astype(np.float32), **kw)
           for k, v in draws.items()}
    out["bot_rhs"] = torch.tensor(
        rng.uniform(0.0, 1.0, (N, B)).astype(np.float32), **kw)
    out["albedo"] = _full((B,), 0.1, **kw)
    out["ftop"] = torch.zeros((N, B), **kw)
    return out


def stage1_inputs(L: int, B: int, seed: int,
                  device: torch.device | str = DEFAULT_DEVICE) -> list[Tensor]:
    """float32 ``(ssa, dtau, btop, slope)`` ``(L, B)`` of stage 1, ssa in
    [0, 0.95] with 0.1% of the entries set to 0 and as many to 0.999999
    (the conservative edge of K1's secular solve), dtau in [0.001, 2]."""
    rng = np.random.default_rng(seed)
    ssa = rng.uniform(0.0, 0.95, (L, B))
    ssa.flat[rng.choice(L * B, max(1, L * B // 1000), replace=False)] = 0.0
    ssa.flat[rng.choice(L * B, max(1, L * B // 1000), replace=False)] = 0.999999
    arrs = (ssa, rng.uniform(0.001, 2.0, (L, B)), rng.uniform(0.0, 1.0, (L, B)),
            rng.uniform(-0.2, 0.2, (L, B)))
    dev = resolve_device(device)
    return [torch.tensor(a, dtype=torch.float32, device=dev) for a in arrs]
