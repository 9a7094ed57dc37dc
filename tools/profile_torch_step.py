#!/usr/bin/env python3
"""Profile a step of the PyTorch port on one CUDA GPU.

    python tools/profile_torch_step.py [--ncol 8192] [--nstr 8] [--trace PATH]
    python tools/profile_torch_step.py --yaml lbl [--ncol 16] [--fuse]
    python tools/profile_torch_step.py --radiances [--ncol 512]

By default the step is ``Disort.forward`` and the g-point sum on the
``bench.py`` problem (8 g-points x ncol columns x 100 layers,
``lamber,onlyfl,planck``; ``pyharp_tpu_torch.bench.problems.bench_problem``);
with ``--yaml ck|lbl`` it is ``Radiation.forward`` of
``examples/amars_yaml_torch.py`` (amarsw-lbl at 0.1 cm^-1: 19,995 bins x
ncol columns x 40 layers), sequential or with ``--fuse``; with
``--radiances`` it is ``Disort.intensities`` on
``pyharp_tpu_torch.bench.problems.radiance_problem`` (``bench_extra.py``'s
radiance configuration: 32 waves x ncol columns x 40 layers, nstr 8).
Runs 3 steps under ``torch.profiler`` and prints device time by kernel
plus the device's busy share of the steps' wall time.
``--trace`` writes a Chrome trace.
"""

from __future__ import annotations

import argparse
import shutil
import sys
import tempfile
from pathlib import Path

REPO = Path(__file__).resolve().parents[1]


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--ncol", type=int, default=None,
                    help="columns (default 8192, or 16 with --yaml)")
    ap.add_argument("--yaml", choices=("ck", "lbl"), default=None)
    ap.add_argument("--fuse", action="store_true")
    ap.add_argument("--radiances", action="store_true")
    ap.add_argument("--nstr", type=int, default=8)
    ap.add_argument("--steps", type=int, default=3)
    ap.add_argument("--trace", default=None)
    args = ap.parse_args()

    import torch
    from torch.profiler import ProfilerActivity, profile

    if not torch.cuda.is_available():
        raise SystemExit("profile_torch_step: needs a CUDA GPU")
    sys.path[:0] = [str(REPO), str(REPO / "examples")]
    dev = torch.device("cuda", 0)
    if args.yaml:
        import amars_yaml_torch as ay

        tmp = tempfile.mkdtemp()
        rad, inputs = ay.build(args.yaml, tmp, ncol=args.ncol or 16,
                               nstr=args.nstr, device=dev, kernel="cuda")

        def step():
            return rad.forward(*inputs, fuse_bands=args.fuse)
    elif args.radiances:
        from pyharp_tpu_torch.bench.problems import RAD_SHAPE, radiance_problem

        shape = (RAD_SHAPE[0], args.ncol or RAD_SHAPE[1]) + RAD_SHAPE[2:]
        step = radiance_problem(torch.float32, dev, "cuda", shape=shape).run
    else:
        from pyharp_tpu_torch.bench.problems import bench_problem

        step = bench_problem(8, args.ncol or 8192, 100, args.nstr,
                             torch.float32, dev, "cuda").run

    step()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        start.record()
        for _ in range(args.steps):
            step()
        stop.record()
        torch.cuda.synchronize()
    wall_ms = start.elapsed_time(stop)
    events = prof.key_averages()
    # kernel rows only: an aten op's row repeats its kernels' device time
    busy_us = sum(e.self_device_time_total for e in events
                  if e.device_type == torch.autograd.DeviceType.CUDA)
    print(events.table(sort_by="self_device_time_total", row_limit=20,
                       max_name_column_width=60))
    print(f"steps {args.steps}: wall {wall_ms / args.steps:.3f} ms/step, "
          f"device busy {busy_us / 1e3 / args.steps:.3f} ms/step "
          f"({100.0 * busy_us / 1e3 / wall_ms:.1f}% of wall)")
    if args.trace:
        Path(args.trace).parent.mkdir(parents=True, exist_ok=True)
        prof.export_chrome_trace(args.trace)
    if args.yaml:
        shutil.rmtree(tmp)


if __name__ == "__main__":
    main()
