"""Measurement of the port (port of ``pyharp_tpu/bench`` and of the root
scripts ``bench.py``, ``bench_extra.py`` and ``scaling_run.py``): the
problems, the profiler and steady-state timer, the roofline, the stage
split, the columns/s and further configurations, the accuracy matrix
against the oracles and the multi-rank scaling runs.  The drivers run as
``python -m pyharp_tpu_torch.bench.<module>`` (``columns``, ``extra``,
``stages``, ``roofline_run``, ``rmse_run``, ``scaling``, ``scaling_run``);
each puts its tensors on the card unless given ``--device cpu``.
``scaling_run`` names the driver module; the weak-scaling function of that
name is ``scaling.scaling_run``."""

from .problems import (Problem, bench_problem, extra_problem,
                       radiance_problem, stage1_inputs, stage_inputs)
from .profile import (PEAKS, Roofline, card_line, disort_flop_estimate,
                      measure, roofline, trace)
from .roofline_run import (bound, bvp_min_bytes, kernel_bytes, kernel_flops,
                           tensor_bytes)
from .scaling import build_sharded_step, partition_overhead_run
from .stages import solver_stages, split_forward

__all__ = [
    "Problem", "bench_problem", "extra_problem", "radiance_problem",
    "stage_inputs", "stage1_inputs",
    "trace", "measure", "roofline", "Roofline", "PEAKS", "card_line",
    "disort_flop_estimate",
    "kernel_flops", "kernel_bytes", "bvp_min_bytes", "tensor_bytes", "bound",
    "solver_stages", "split_forward",
    "build_sharded_step", "partition_overhead_run",
]
