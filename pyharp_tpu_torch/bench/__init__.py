"""Profiling and scaling harnesses (port of ``pyharp_tpu/bench``: the
profiler, the steady-state timer, the H100 roofline and the multi-rank
scaling runs)."""

from .profile import Roofline, disort_flop_estimate, measure, roofline, trace
from .scaling import (bench_problem, build_sharded_step,
                      partition_overhead_run, scaling_run)

__all__ = [
    "trace", "measure", "roofline", "Roofline", "disort_flop_estimate",
    "bench_problem", "build_sharded_step", "scaling_run",
    "partition_overhead_run",
]
