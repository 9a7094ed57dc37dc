"""Profiling and roofline accounting (PyTorch port of
``pyharp_tpu/bench/profile.py``).

* :func:`trace` wraps ``torch.profiler`` around any step and writes a
  Chrome trace (Perfetto);
* :func:`measure` is the steady-state timer: warm-up calls first, then
  CUDA events around the timed calls on the card, or the host clock ended
  by a synchronize on the CPU;
* :func:`roofline` places a measured function against the card's
  published peaks.  Only the H100's are carried: a device without a
  published peak here raises.
"""

from __future__ import annotations

import contextlib
import os
import subprocess
import tempfile
import time
from dataclasses import dataclass

import torch

# NVIDIA's data sheet, H100 SXM, at its 700 W limit: HBM bytes/s and
# float32 (outside the tensor cores) FLOP/s, as chip_smoke.py uses them
PEAKS = {
    "h100": {"flops": 67e12, "bytes": 3.35e12},
}


def _peaks() -> dict:
    if not torch.cuda.is_available():
        raise RuntimeError("roofline needs a CUDA device: a CPU time is not "
                           "a device measurement")
    kind = torch.cuda.get_device_name(0).lower()
    for name, p in PEAKS.items():
        if name in kind:
            return p
    raise ValueError(f"no published peak for {kind!r}; known: {list(PEAKS)}")


def card_line(device: torch.device | str = "cuda") -> str:
    """The card's name and power limit as ``nvidia-smi --query-gpu=name,
    power.limit --format=csv,noheader`` prints them (its first card), to
    stand beside every time; ``"cpu"`` for a CPU device."""
    if torch.device(device).type != "cuda":
        return "cpu"
    try:
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            check=True, timeout=60).stdout.splitlines()[0].strip()
    except (OSError, subprocess.SubprocessError, IndexError):
        return f"{torch.cuda.get_device_name(0)}, power limit not read"


@contextlib.contextmanager
def trace(logdir: str | None = None):
    """``with trace(dir) as prof: step(...)``: a ``torch.profiler`` trace of
    the block (CPU, and CUDA when available), written to
    ``<dir>/trace.json``; ``prof.key_averages()`` gives the sums by
    kernel."""
    logdir = logdir or os.path.join(tempfile.gettempdir(), "pyharp_trace")
    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    with torch.profiler.profile(activities=acts) as prof:
        yield prof
    os.makedirs(logdir, exist_ok=True)
    prof.export_chrome_trace(os.path.join(logdir, "trace.json"))


def timed_calls(device: torch.device | str) -> int:
    """Timed calls per measurement of the drivers: 10 on the card, 2 on the
    CPU, as ``bench.py`` and ``bench_extra.py`` take them."""
    return 10 if torch.device(device).type == "cuda" else 2


def _cuda_out(out) -> bool:
    if isinstance(out, torch.Tensor):
        return out.is_cuda
    if isinstance(out, (tuple, list)):
        return any(_cuda_out(o) for o in out)
    if isinstance(out, dict):
        return any(_cuda_out(o) for o in out.values())
    return False


def measure(fn, *args, iters: int = 10, warmup: int = 2) -> float:
    """Steady-state seconds per call of ``fn(*args)``: ``warmup`` calls,
    then ``iters`` calls timed with CUDA events when ``fn`` returns CUDA
    tensors, else on the host clock ended by a synchronize."""
    out = None
    for _ in range(warmup):
        out = fn(*args)
    if _cuda_out(out):
        torch.cuda.synchronize()
        start = torch.cuda.Event(enable_timing=True)
        stop = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(iters):
            fn(*args)
        stop.record()
        torch.cuda.synchronize()
        return start.elapsed_time(stop) / 1e3 / iters
    t0 = time.perf_counter()
    for _ in range(iters):
        fn(*args)
    return (time.perf_counter() - t0) / iters


@dataclass(frozen=True)
class Roofline:
    seconds: float
    achieved_flops: float        # FLOP/s
    achieved_bw: float           # bytes/s
    flops_frac: float            # fraction of the card's peak
    bw_frac: float
    bound: str                   # "compute" | "bandwidth"

    def __str__(self):
        return (f"{self.seconds*1e3:.3f} ms | "
                f"{self.achieved_flops/1e12:.2f} TFLOP/s "
                f"({100*self.flops_frac:.1f}% peak) | "
                f"{self.achieved_bw/1e9:.1f} GB/s "
                f"({100*self.bw_frac:.1f}% peak) | {self.bound}-bound")


def roofline(fn, *args, flops: float, bytes_moved: float,
             iters: int = 10) -> Roofline:
    """Measure ``fn`` on the card and place it on the card's roofline;
    ``flops`` and ``bytes_moved`` are the caller's counts per call."""
    p = _peaks()
    sec = measure(fn, *args, iters=iters)
    af = flops / sec
    ab = bytes_moved / sec
    ff, fb = af / p["flops"], ab / p["bytes"]
    return Roofline(seconds=sec, achieved_flops=af, achieved_bw=ab,
                    flops_frac=ff, bw_frac=fb,
                    bound="compute" if ff >= fb else "bandwidth")


def disort_flop_estimate(nwave: int, ncol: int, nlyr: int, nstr: int,
                         nmode: int = 1) -> float:
    """The JAX package's analytic FLOP count of one batched DISORT solve:
    per (wave, col, layer) the eigensolve O(s^3), the particular solutions
    O(s^2) and the block-tridiagonal factor and solve O((2s)^3 / 3), with
    s = nstr/2."""
    s = nstr // 2
    per_layer = 30 * s ** 3 + 40 * s ** 2 + (8 * s ** 3) / 3 + 16 * s ** 2
    return float(nmode * nwave * ncol * nlyr * per_layer)
