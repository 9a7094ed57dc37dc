"""The further configurations of ``bench_extra.py``, at its full widths:
the port's counterpart of that script.

    python -m pyharp_tpu_torch.bench.extra [--out FILE] [--device cuda]

* ``sw_lbl_4str_beam``: 500 waves x 512 columns x 40 layers, nstr 4, a
  beam, isotropic scattering (K1's beam variant, K2, K3);
* ``aerosol_16str_beam``: 500 x 128 x 40, nstr 16, a beam,
  Henyey-Greenstein moments g = 0.8 (K4, K2, K5);
* ``thermal_lw_8str_100lyr_bigbatch``: 8 x 16384 x 100, nstr 8, thermal
  (K1, K2, K3), with the seconds 1e6 columns would take on one card;
* ``radiances_8str_4mu_2phi_3tau``: 32 x 512 x 40, nstr 8, 4 user cosines x
  2 azimuths x 3 user depths (K4 once per mode, K2 and K5 twice), with
  radiances/s and the first call's seconds.

Each is timed over 10 steps after 2 warm-up steps with CUDA events; on
the CPU, as the JAX script there, over 2 steps on the host clock with the
columns divided by 16.  Each record carries the JAX script's
keys, the launches of one step, the peak device memory it took and the
card's name and power limit.  Prints the JSON on one line; writes it only
to ``--out``.
"""

from __future__ import annotations

import argparse
import json
import time

import torch

from ..core.device import DEFAULT_DEVICE, resolve_device
from ..rt.disort import kernels as K
from .problems import (RAD_MU, RAD_PHI, RAD_SHAPE, RAD_TAU, extra_problem,
                       radiance_problem)
from .profile import card_line, measure, timed_calls

CONFIGS = {
    # name: (nwave, ncol, nlyr, nstr, extra_problem's keywords)
    "sw_lbl_4str_beam": (500, 512, 40, 4, dict(beam=True, planck=False)),
    "aerosol_16str_beam": (500, 128, 40, 16,
                           dict(beam=True, planck=False, g=0.8)),
    "thermal_lw_8str_100lyr_bigbatch": (8, 16384, 100, 8,
                                        dict(beam=False, planck=True)),
    "radiances_8str_4mu_2phi_3tau": RAD_SHAPE + (None,),
}


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def run_config(name: str, device: torch.device | str = DEFAULT_DEVICE,
               shrink: int | None = None, iters: int | None = None) -> dict:
    """One configuration's record; ``shrink`` divides its columns (1 on the
    card, 16 on the CPU unless given)."""
    dev = resolve_device(device)
    if shrink is None:
        shrink = 1 if dev.type == "cuda" else 16
    nwave, ncol, nlyr, nstr, kw = CONFIGS[name]
    ncol = max(1, ncol // shrink)
    if dev.type == "cuda":
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats(dev)
        before = torch.cuda.memory_allocated(dev)
    if kw is None:
        p = radiance_problem(device=dev, shape=(nwave, ncol, nlyr, nstr))
    else:
        p = extra_problem(nwave, ncol, nlyr, nstr, device=dev, **kw)
    K.reset_launches()
    _sync(dev)
    t0 = time.perf_counter()
    out = p.run()
    _sync(dev)
    first = time.perf_counter() - t0
    launches = K.launch_counts()
    if not bool(torch.isfinite(out).all()):
        raise AssertionError(f"{name}: non-finite output")
    sec = measure(p.step, *p.args, iters=iters or timed_calls(dev))
    rec = {"config": name,
           "shape": {"nwave": nwave, "ncol": ncol, "nlyr": nlyr,
                     "nstr": nstr},
           "seconds": sec, "columns_per_s": ncol / sec}
    if kw is None:
        nrad = nwave * ncol * len(RAD_MU) * len(RAD_PHI) * len(RAD_TAU)
        rec["shape"].update(numu=len(RAD_MU), nphi=len(RAD_PHI),
                            ntau=len(RAD_TAU))
        rec.update(radiances_per_s=nrad / sec, first_call_s=first)
    elif name.endswith("bigbatch"):
        rec["seconds_for_1e6_columns_one_chip"] = 1e6 * sec / ncol
    else:
        rec["wavecol_solves_per_s"] = nwave * ncol / sec
    rec["launches"] = {k: v for k, v in launches.items() if v}
    # the peak of device memory while the configuration ran, less what was
    # allocated before it started
    rec["max_memory_allocated_bytes"] = (
        torch.cuda.max_memory_allocated(dev) - before
        if dev.type == "cuda" else None)
    rec["timer"] = "cuda events" if dev.type == "cuda" else "host clock"
    return rec


def run(device: torch.device | str = DEFAULT_DEVICE) -> dict:
    dev = resolve_device(device)
    return {"card": card_line(dev),
            "results": [run_config(n, dev) for n in CONFIGS]}


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default=DEFAULT_DEVICE)
    ap.add_argument("--out", default=None, help="write the JSON here too")
    a = ap.parse_args(argv)
    out = run(a.device)
    print(json.dumps(out))
    if a.out:
        with open(a.out, "w") as f:
            json.dump(out, f, indent=1)
    return out


if __name__ == "__main__":
    main()
