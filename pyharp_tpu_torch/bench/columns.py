"""Columns per second of the 8-stream x 100-layer solve: the port's
counterpart of ``bench.py``.

    python -m pyharp_tpu_torch.bench.columns [--device cuda]

The problem is ``bench.py``'s (:func:`problems.bench_problem`: 8 g-points x
8192 columns x 100 layers, ``lamber,quiet,onlyfl,planck``, the weighted
g-point sum), on the card through K1, K2 and K3; 2 warm-up steps, then 10
timed with CUDA events.  On the CPU, as ``bench.py`` there, 128 columns
and 2 steps on the host clock.  Prints one JSON line:
``metric``, ``value``, ``unit``, and the card's name and power limit.

``bench.py``'s ``vs_baseline`` is not carried: its denominator (1001
columns/s, ``bench.py:38``) is an XLA:CPU figure taken on another machine,
no baseline of this card.
"""

from __future__ import annotations

import argparse
import json

import torch

from ..core.device import DEFAULT_DEVICE, resolve_device
from .problems import bench_problem
from .profile import card_line, measure, timed_calls

METRIC = "columns_per_s_per_chip_8str_100lyr"


def run(ncol: int | None = None,
        device: torch.device | str = DEFAULT_DEVICE,
        iters: int | None = None) -> dict:
    """The JSON record of one measurement; ``ncol`` 8192 on the card and
    128 on the CPU unless given."""
    dev = resolve_device(device)
    if ncol is None:
        ncol = 8192 if dev.type == "cuda" else 128
    p = bench_problem(8, ncol, 100, 8, device=dev)
    out = p.run()
    if not bool(torch.isfinite(out).all()):
        raise AssertionError("bench problem: non-finite fluxes")
    sec = measure(p.step, *p.args, iters=iters or timed_calls(dev))
    return {"metric": METRIC, "value": ncol / sec, "unit": "columns/s/chip",
            "seconds_per_step": sec, "ncol": ncol, "card": card_line(dev),
            "timer": "cuda events" if dev.type == "cuda" else "host clock"}


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default=DEFAULT_DEVICE)
    a = ap.parse_args(argv)
    rec = run(device=a.device)
    print(json.dumps(rec))
    return rec


if __name__ == "__main__":
    main()
