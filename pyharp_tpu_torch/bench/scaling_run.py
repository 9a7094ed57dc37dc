"""The partition-overhead sweep and a projection of the wave-sharded
efficiency across cards: the port's counterpart of ``scaling_run.py``.

    python -m pyharp_tpu_torch.bench.scaling_run [--columns-per-s X]
        [--device cuda] [--out FILE]

1. The sweep: ``bench.scaling.partition_overhead_run`` on 2 and 4 gloo
   ranks on the CPU (``parallel.spawn``), the counterpart of the JAX
   tool's virtual CPU devices, at 256 columns per rank.
   ``overhead_vs_serialized_shards`` ~ 1 says that splitting the problem
   over the ranks added no work; the ranks share the host's cores, so no
   speed-up is seen (``oversubscribed`` where they outnumber the cores).
2. The projection: columns are independent, so sharding them needs no
   collective; sharding the waves needs one all-reduce of the band flux,
   ``allreduce_bytes_per_column`` per column and step.  Against the
   card's rate (``bench.columns`` on ``--device``, or ``--columns-per-s``)
   and the H100 SXM's NVLink bandwidth, the unoverlapped efficiency of a
   ring all-reduce (2x the payload per card) is t_comp / (t_comp +
   t_comm).

Prints the JSON; writes it only to ``--out``.
"""

from __future__ import annotations

import argparse
import json
import os
import tempfile
from pathlib import Path

import torch

from ..core.device import DEFAULT_DEVICE, resolve_device
from ..parallel.dryrun import spawn

# NVIDIA H100 SXM data sheet: NVLink 900 GB/s per card (18 fourth-generation
# links of 50 GB/s, both directions together); one link one way, 25 GB/s,
# is the conservative floor
NVLINK_BYTES_PER_S = 900e9
NVLINK_ONE_LINK_ONE_WAY = 25e9


def _rank(rank: int, n: int, ncol_total: int, nlyr: int, out: str) -> None:
    from .scaling import partition_overhead_run

    rec = partition_overhead_run(ncol_total=ncol_total, nlyr=nlyr,
                                 device="cpu")
    if rec is not None:
        Path(out).write_text(json.dumps(rec))


def sweep(ranks=(2, 4), cols_per_rank: int = 256, nlyr: int = 100
          ) -> list[dict]:
    """``partition_overhead_run`` on each number of gloo CPU ranks,
    ``cols_per_rank`` columns per rank."""
    ncores = os.cpu_count() or 1
    records = []
    with tempfile.TemporaryDirectory() as tmp:
        for n in ranks:
            out = str(Path(tmp, f"ranks{n}.json"))
            spawn(_rank, n, cols_per_rank * n, nlyr, out, backend="gloo",
                  device="cpu")
            rec = json.loads(Path(out).read_text())
            rec.update(cols_per_rank=cols_per_rank, oversubscribed=n > ncores)
            records.append(rec)
    return records


def projection(columns_per_s: float, allreduce_bytes_per_column: float
               ) -> dict:
    t_comp = 1.0 / columns_per_s
    proj = {}
    for name, bw in (("nvlink_aggregate", NVLINK_BYTES_PER_S),
                     ("one_link_one_way", NVLINK_ONE_LINK_ONE_WAY)):
        t_comm = 2.0 * allreduce_bytes_per_column / bw
        proj[name] = {"bytes_per_s": bw,
                      "t_comm_over_t_comp": t_comm / t_comp,
                      "projected_efficiency_unoverlapped":
                          t_comp / (t_comp + t_comm)}
    return proj


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--columns-per-s", type=float, default=None,
                    help="the card's rate; measured with bench.columns on "
                         "--device when not given")
    ap.add_argument("--device", default=DEFAULT_DEVICE)
    ap.add_argument("--out", default=None, help="write the JSON here too")
    a = ap.parse_args(argv)
    dev = resolve_device(a.device)
    records = sweep()
    if a.columns_per_s is None:
        from .columns import run as columns_run

        rate = columns_run(device=dev)
    else:
        rate = {"value": a.columns_per_s, "card": "given"}
    out = {
        "mesh": "('col', 'wave') = (n, 1), gloo ranks on the CPU",
        "records": records,
        "columns_per_s": rate["value"], "columns_card": rate["card"],
        "projection": projection(
            rate["value"], records[0]["allreduce_bytes_per_column"]),
    }
    print(json.dumps(out, indent=1))
    if a.out:
        Path(a.out).write_text(json.dumps(out, indent=1))
    return out


if __name__ == "__main__":
    main()
