#!/usr/bin/env python3
"""Drive the PyTorch port's main paths once on one NVIDIA GPU.

    python3 chip_smoke.py

The paths run through the hand-written CUDA kernels of
``pyharp_tpu_torch/rt/disort/kernels.py``.  The m = 0 flux solves of
``Disort.forward``: the isotropic thermal problem of ``bench.py`` (8
g-points x 8192 columns x 100 layers, 8 streams) and amars_lw (kernels K1,
K2, K3); the 16-stream aerosol problem with a beam of ``bench_extra.py``
(500 x 128 x 40, K4, K2, K5), and the same at 32, 48, 64, 128 and 256 streams; its 4-stream line-by-line beam problem (500 x
512 x 40, K1's beam variant, K2, K3); amars_sw (K1 beam, K2, K3); the YAML
``Radiation`` layer.  The radiances of ``Disort.intensities``: every
azimuthal mode of ``bench_extra.py``'s radiance problem (32 x 512 x 40,
K4 once per mode, K2 and K5 twice: m = 0, then the modes m >= 1 folded into
the batch axis; above 64 streams K4 twice too, the modes m >= 1 in one
launch), and ``Radiation.band_radiances``.  Phases, one line each
or more:

0. device: needs CUDA (raises otherwise); prints the card, its power limit,
   the CUDA, nvcc and PyYAML versions;
1. builds the kernels from the checkout's sources, prints the build time
   and each kernel's registers, stack and spills (K1-K5 at N = 1..8, every
   nstr up to 16; K1, K4 and K2 at N = 9..16 as one body each,
   ``<kernel>_wide<9..16>``: K4 a team of 4 lanes per element, K2 a warp
   per column, each on a line of its own; K5 at each N = 9..16 as
   ``bvp_backward_rows``; K1, K4 and K5 at N = 17..32 as one body
   each, ``<kernel>_big<17..32>``, K2 there as its two tiles,
   ``bvp_forward_big<17..24>`` and ``<25..32>``), K2 as
   its bodies (one thread per column for
   N <= 6, ``bvp_forward_half`` for N = 7, ``bvp_forward_team`` for
   N = 8) and K6 as
   its instantiations per mode (``bvp_fused_ab`` / ``_flux``, one thread
   per column for N <= 4; ``bvp_fused_team`` for N = 8);
2. K1 against its plain PyTorch version, float32 on the card, nstr
   4/6/8/10/12/14/16 and the bench shape, with ssa forced to 0 and 0.999999
   in some entries: max|err| <= 3e-5 max|ref| per output;
3. K2 and K3 against their plain versions, float32 on the card, nstr
   4/8/16 at L = 100 on 1024 columns, and nstr 4/6/8/10/12/14/16 at L = 37
   on 1018, which leaves every launch's last block of columns partial:
   |err| <= 3e-5 max|ref| + 3e-4 |ref| per output;
4. ``Disort.forward`` at the bench shape: each kernel launched once per
   call; fluxes against the plain path in float64 on every column
   (max|err| <= 1e-4 max|flux|); 10 timed steps of the kernel path and of
   the plain float32 path; then each kernel against its plain version on
   the path's own inputs, every column, to phase 2's and 3's bounds, and
   each timed;
5. amars_lw through the port: band fluxes against the float64 golden file
   (max|err| <= 1e-4 max|flux|), TOA down-flux ~ 0, up-flux > 0;
6. K1's beam variant, K4 and K5 against their plain versions, float32 on
   the card, nstr 4/6/8/10/12/14/16: K1 beam and K4 (thermal on and off,
   beam on and off, delta-M scaled Henyey-Greenstein moments with g = 0.2
   and 0.8, ssa with 0 and 0.999999 entries, the beam cosine set onto a
   resonance 1/lam_k in some entries) to phase 2's bound, K4 also
   bit-equal (asserted); K4 at the modes m = 1..nstr-1 (nstr 4/8/16; the
   others at m = 1, 2, nstr - 1: the mode's tables, no thermal source, the
   beam's Lam_l^m(mu0) and prefactor 2/(4 pi), HG g = 0.8) to phase 2's
   bound and bit-equal (asserted); K5 at L = 100 (nstr 4/8/16) and 37 on a
   beam-and-moments solve to phase 3's;
7. ``aerosol_16str_beam`` (``bench_extra.py:109-119``) at full width: K4,
   K2 and K5 each launched once per call, K1 and K3 not; fluxes against
   the float64 plain path on every column: 1e-4 max|flux| where no layer
   is within 1e-3 (relative) of a beam resonance lam_k = 1/mu0; on the
   columns that have one, 1e-3 of the float64 plain path run with
   float32's resonance floor, their distance from the float64 answer
   printed (see ``RESONANCE_MARGIN``); 10 timed steps; each kernel
   against its plain version on the path's own inputs, every column, and
   timed, with K4's and K2's registers and spills and K4's issue-rate
   floor without multiply-add contraction (twice its operation bound);
   then K3 against K5 + the flux epilogue on the same inputs at N = 8
   (timed and compared, not used);
8. ``sw_lbl_4str_beam`` (``bench_extra.py:97-107``) at full width: K1 beam,
   K2 and K3 each launched once, the same checks and timings as phase 7;
9. amars_sw through the port (float32): TOA down-flux within 0.5 of
   408.17 W/m^2 and every flux within 1e-4 max|flux| of the float64 golden
   file written from the JAX example;
10. K6 (``bvp_fused``, no caller on ``Disort.forward``, as in the JAX
    package) against its plain version (phase 3's bound; on the columns
    of the aerosol path near a beam resonance, where the two sweeps
    together amplify float32 rounding, 1e-3 of max|ref|) and against K2 +
    K3 (flux mode; its raw bottom (a, b) against K2 + K5's bottom layer)
    or K2 + K5 ((a, b) mode) within 3e-6 of max|ref| per output
    (``tests/test_pallas_kernels.py:121-142``; K6's sweeps form every
    entry as K2's and K5's do, so the (a, b) mode is bit-equal to K2 + K5
    at every N): both modes at
    nstr 4/8/16 on phase 3's shapes and on 1018 columns at L = 1 and
    L = 25, one past a multiple of the segment size S of K6's schedule at
    N <= 4 (3 at N <= 2, 2 at N = 4), so the last segment and the last
    block of columns are partial; at L = 1 the flux mode's layer-top sums
    are held to ``SINGLE_LAYER_TOL`` of the float64 plain version instead,
    the float32 plain version's reading beside; then on the BVP inputs of
    the bench (flux),
    aerosol ((a, b)) and sw_lbl (flux) paths, each timed against the
    two-kernel pair, with K6's share of its bound; on the near columns
    K2 + K5 against the plain K2 then K5 is printed beside K6's reading;
11. the YAML ``Radiation`` path of ``examples/amars_yaml_torch.py``: the
    amarsw-ck (40 g-points) and amarsw-lbl (19,995 bins at 0.1 cm^-1)
    configurations, 1 column x 40 layers, 8 streams, sequential and
    ``fuse_bands=True``, band fluxes and total within 1e-4 max|flux| of the
    JAX float64 golden files (``tests/make_amars_yaml_golden.py``), fused
    within 1e-6 of sequential, K1/K2/K3 launched once per band sequentially
    and once in all fused; amarsw-lbl at 16 columns of an atmosphere drawn
    per layer and column, timed (10 steps after a warm-up, both ways),
    fused within 1e-6 of sequential and checked against the float64 plain
    path on columns 0 and 15; then K1, K2 and K3 against their plain
    versions on the fused solve's own inputs (phase 2's and 3's bounds,
    every column, timed), and K6 on them as in phase 10;
12. ``radiances_8str_4mu_2phi_3tau`` (``bench_extra.py:134-168``) at full
    width, 32 x 512 x 40, nstr 8, 4 user cosines x 2 azimuths x 3 user
    depths, the TMS/IMS corrections, tau and ssa drawn with numpy as
    ``bench_extra.py:149-153`` draws them: ``Disort.intensities`` launches
    K4 nstr times, K2 and K5 twice each, K1, K3 and K6 never; ``flux`` and
    ``uu`` against the float64 plain path on every column
    (``radiance_errors``: 1e-4 of max|flux|, and of each column's own
    max|uu| at every (tau, phi, mu),
    where no layer of any mode is within ``RESONANCE_MARGIN`` of a beam
    resonance; the near columns against the float64 plain path run with
    float32's resonance floor, flux to ``NEAR_RESONANCE_TOL`` of max|flux|
    as phase 7 holds it, uu to ``NEAR_RESONANCE_TOL`` of each column's own
    max|uu|, their count and distance from float64 printed); ``flux``
    against ``forward``'s (2e-4 rtol,
    ``tests_tpu/test_tpu_radiances.py:52-53``); uu > 0 looking up; the step
    (10 after a warm-up) and radiances/s, and how it divides between m =
    0's kernels, the modes' kernels, the sweeps and corrections, and the
    rest; K4 over the modes m >= 1 (bit-equal, asserted) and K2 and K5 on
    the folded modes against their plain versions, timed;
    K6 in (a, b) mode on m = 0's and the folded modes' BVP inputs beside
    K2 + K5 (K6 has no caller: the route is a later decision);
13. the static route (``kernels.route``): ``Disort.forward`` and
    ``.intensities`` on CUDA tensors under ``kernel="auto"``, at nstr 6 and
    12 in float32 through the kernels (forward: K4, K2, and K3 or K5 as N
    gives, once each; intensities: K4 nstr times, K2 and K5 twice), at
    nstr 8 in float64 through the plain versions (no launch), each against
    the float64 plain path as phase 12 holds it; at nstr 6 and 12 the
    kernels of forward's solve against their plain versions on its
    inputs, timed (N = 3 and 6, instantiations no other phase times);
14. ``Radiation.band_radiances`` on ``tests/test_band.py:358-390``'s band
    (S8 + H2SO4, three out-directions) at 64 bins x 16 columns x 40 layers,
    nstr 8: one launch each of K1 beam, K2 and K5; within 1e-4 of max|ref|
    of the float64 plain path;
15. ``BeerLambert.forward`` (no kernel: tensor code) at 8 x 8192 x 100,
    nstr 8, thermal with the bins' edges and a beam, float32 on the card
    against float64 on the card (1e-4 of max|flux|), and ``toa_radiance``
    with alpha = 0.5 likewise; both timed;
16. the sharded bench problem (``bench.scaling.build_sharded_step``: 8
    g-points x 8192 columns x 100 layers, nstr 8, eight distinct bins
    tiling 1-500 cm^-1) through ``parallel.sharded_band_flux`` at world
    size 1 over NCCL: K1, K2 and K3 launched once; bit-equal to the
    unsharded ``forward`` + weighted sum; against the float64 plain path
    (1e-4 of max|flux|); the sharded and unsharded steps timed in turns,
    the NCCL ``all_reduce`` alone; K1-K3 on the path's inputs;
17. the same problem on two ranks sharing the card over gloo with CUDA
    tensors, on the (col x wave) meshes (2, 1) and (1, 2): each rank
    launches K1, K2 and K3 once per step, its band flux within rtol 5e-6,
    atol 1e-8 of phase 16's unsharded result, each rank's step timed;
    then ``bench.scaling.partition_overhead_run`` at 8192 columns;
18. the measurement drivers of ``pyharp_tpu_torch.bench`` on the card,
    their output relayed: ``roofline_run`` (K4, K1, K2 + K5, K2 + K3 and K6
    in both modes at the bench shape against their bounds and the BVP's
    min-bytes floor), ``stages`` (the JAX tool's stage timings, and
    ``Disort.forward`` on the bench problem split into preparation, stage
    1, glue, BVP and flux assembly: the rows within 10% of the whole, the
    chained stages bit-equal to it), ``columns`` (the
    ``columns_per_s_per_chip_8str_100lyr`` line), ``extra`` (the four
    ``bench_extra.py`` configurations at full width, each one's launches
    asserted as phases 7, 8 and 12 assert them) and ``rmse_run`` in
    float32 through K1 (thermal and beam), K4, K2, K3 and K5:
    ``tests/test_oracle_mc.py``'s three Monte Carlo cases at 4e6 photons
    within 5e-3, the H-function anchor within 2e-3, and the whole matrix
    at 1e6 photons;
19. 18 to 32 streams: at every nstr 18..32, K1 and its beam variant (L 37 x B 4096, ssa 0
    and 0.999999 entries) and K4 (thermal x beam at m = 0, and m = 1)
    bit-equal to their plain versions (asserted; K4 also on 37 x 509
    elements at nstr 18 and 32, its last block partial), K4's float32 distance
    from float64 printed with the modes matched by eigenvalue, and beside it
    with each mode matched as a span (its sign free; a near-degenerate set
    of modes, eigenvalues within 1e-6, as one span) and the largest
    principal-angle sine, K2 and K5
    on 1018 columns x 8 layers to phase 3's bound; then through the wide
    bodies, each path's fluxes against float64 as phase 7 holds them and
    each kernel against its plain version on the path's inputs, every
    column, timed (the plain versions once: at N = 16 they take seconds a
    call): the isotropic thermal solve at nstr 32 (8 x 2048 x 20; K1, K2,
    K5; beside it the fixed secular schedule of N <= 8 in float32, NaN
    there), the isotropic beam (500 x 64 x 20; K1 beam), the aerosol
    configuration at nstr 22 (32 x 128 x 20, HG g = 0.8; N = 11, where 2N
    does not divide a warp) and at nstr 32 in full width (500 x 128 x 40:
    K4, K2 and K5 once each; float64 on every 10th wave; K4 without its
    Jacobi sweeps timed beside, and ``torch.linalg.eigh`` once on as
    many symmetric 16 x 16 matrices as a yardstick of the sweeps alone),
    and ``Disort.intensities`` at nstr 32
    (32 x 64 x 40: K4 32 times, held bit-equal at every mode m = 0..31
    to the plain version, which takes the modes m >= 1 in one pass, K2
    and K5 twice, held on the folded modes; float64 with float32's
    resonance floor on every 4th wave);
20. ``aerosol_16str_beam``'s configuration (500 x 128 x 40, HG g = 0.8, a
    beam) at nstr 10, 12 and 14 through ``Disort.forward`` under
    ``kernel="auto"``: K4, K2 and K5 once each; the fluxes against the
    float64 plain path as phase 7 holds them; K4, K2 and K5 against their
    plain versions on the path's inputs, every column, timed;
21. 34 to 64 streams: ``kernels.route`` sends float32 CUDA tensors at
    every nstr 2..64 to the kernels;
    K4's square root without a range check against ``sqrtf`` on every
    float32 in [1, 2^60] (``kernels.root_check``); at nstr 34, 40, 48, 50, 64 (N = 17, 20, 24, 25, 32), K1 and its beam
    variant and K4 (thermal x beam at m = 0, m = 1, at nstr 64 also m =
    31 and 63) bit-equal to their plain versions on L 7 x B 1017 elements
    (asserted), K2 and K5 on 1017 columns x 8 layers to phase 3's bound;
    then through ``kernel="auto"``, each path's fluxes against float64 as
    phase 7 holds them, its peak device memory and step, and each kernel
    against its plain version on the path's inputs, every column, timed
    (the plain versions once): aerosol_16str_beam's configuration at
    nstr 64 and 48 (HG g 0.8, a beam, 128 columns, 40 layers; its 500
    waves cut to the first 100 and 200, ``AEROSOL_BIG``; float64 on every
    10th wave; K4, K2, K5), the isotropic thermal solve at nstr 64 (8 x
    2048 x 20; K1, K2, K5), the isotropic beam (500 x 64 x 20; K1 beam,
    K2, K5; float64 on every 10th wave) and ``Disort.intensities`` at
    nstr 64 (8 x 64 x 20: K4 64 times, held bit-equal at every mode, K2
    and K5 twice, held on the folded modes; radiances against float64
    with float32's resonance floor on every 10th wave, 1e-4 of each
    column's max|uu| away from a resonance);
22. 66 to 128 streams: the bodies of N = 33..64 (``csrc/*_huge.cu``), their
    ptxas lines and elements (columns) an SM, K2's shared memory a block
    (its system in register tiles over 16 warps); ``kernels.route`` sends
    float32 CUDA tensors at every nstr 2..128 to the kernels; at nstr 66,
    82, 96, 128 (N = 33, 41, 48,
    64), K1 and its beam variant and K4 (m = 0 with a thermal source and a
    beam, m = 1 with a beam, at nstr 128 also m = 63) bit-equal to their
    plain versions on L 3 x B 99 elements (asserted), K2 and K5 on 99
    columns x 8 layers to phase 3's bound; the off-diagonal K4's 8 Jacobi
    sweeps leave at N = 64; then through ``kernel="auto"`` as phase 21:
    aerosol_16str_beam's configuration at nstr 128 (its first 10 waves x
    128 x 40, ``AEROSOL_HUGE``; float64 on every 5th wave; K4, K2, K5), the
    isotropic thermal solve (8 x 256 x 20; K1, K2, K5), the isotropic
    beam (the first 25 of 500 waves x 64 x 20; K1 beam, K2, K5; float64 on
    every 5th wave) and ``Disort.intensities`` (1 x 16 x 8: K4 twice, m =
    0 and the 127 modes m >= 1 in one launch, held bit-equal at m = 0 and
    ``RADIANCE_HUGE_MODES``, every mode timed; K2 and K5 twice);
23. beyond 128 streams: the bodies of N > 64 (``csrc/*_global.cu``, any N,
    their matrices in global scratch, K2's in a thread-block cluster's
    shared memory up to its reach), their ptxas lines, elements (columns)
    an SM and the scratch a resident block keeps at N = 128, K2's cluster
    size, shared memory a block and clusters resident, its slab body's
    line at the first N past the reach; the cluster sizing of
    ``kernels.cluster_blocks`` against the library's at every N up to one
    past the reach (170); ``kernels.route`` sends float32 CUDA tensors at
    nstr 130, 256 and 1000
    to the kernels, decided before any launch; at nstr 130, 200, 256, 258
    (N = 65, 100, 128, 129: 3, 4, 4 and 5 sets of 32 rows), K1 and its
    beam variant, K4 (m = 0 with a thermal source and a beam, m = 1 with
    a beam; the plain version of both modes in one pass) and K2 bit-equal
    to their plain versions on L 3 x B 37 elements (asserted; K2 built
    without multiply-add contraction there), K2 and K5 on 37 columns x 3
    layers to phase 3's bound; K2 bit-equal to its plain version at nstr
    340 (the reach, a cluster of 8 blocks) and at 342 (the slab body) on
    7 columns x 2 layers; the off-diagonal K4's 8 Jacobi sweeps leave
    at N = 128; then through ``kernel="auto"`` at nstr 256 as phase 22:
    aerosol_16str_beam's configuration (its first wave x 128 columns x
    its first 10 layers, ``AEROSOL_GLOBAL``; K4, K2, K5), the isotropic
    thermal solve (1 x 63 x 11; K1, K2, K5), the isotropic beam (the first
    3 of 500 waves x 21 x 11; K1 beam, K2, K5) and ``Disort.intensities``
    (1 x 4 x 4: K4 twice, m = 0 and the 255 modes m >= 1 in one launch,
    held bit-equal at m = 0 and ``RADIANCE_GLOBAL_MODES``, every mode
    timed; K2 and K5 twice); the float64 references
    run on the card while ``nvcc`` builds, as phases 21 and 22's.

The problems, the roofline counts and the card's peaks come from
``pyharp_tpu_torch.bench`` (``problems``, ``roofline_run``, ``profile``).
Any failure raises.  The last three lines are the ``nvidia-smi``
card line, a JSON object of per-kernel results and
``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import contextlib
import io
import json
import re
import subprocess
import sys
import tempfile
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path
from unittest import mock

import numpy as np

REPO = Path(__file__).resolve().parent
DATA = REPO / "pyharp_tpu_torch" / "data"
CSRC = "pyharp_tpu_torch/rt/disort/csrc/"
TPU = "pyharp_tpu/rt/disort/pallas_kernels.py:"
KERNEL_TABLE = {
    # wrapper: (source, the TPU kernel it replaces)
    "stage1_isotropic": (CSRC + "stage1_isotropic.cu", TPU + "223"),
    "stage1_isotropic_beam": (CSRC + "stage1_isotropic.cu", TPU + "395"),
    "stage1_general": (CSRC + "stage1_general.cu", TPU + "427"),
    "bvp_forward": (CSRC + "bvp_forward.cu", TPU + "754"),
    "bvp_backward_flux": (CSRC + "bvp_backward_flux.cu", TPU + "885"),
    "bvp_backward": (CSRC + "bvp_backward.cu", TPU + "846"),
    "bvp_fused": (CSRC + "bvp_fused.cu", TPU + "964"),
}
# the sources of the bodies at N = 9..16 (kernels.NARROW_MAX_N < N)
WIDE_SOURCES = {
    "stage1_isotropic": CSRC + "stage1_isotropic_wide.cu",
    "stage1_isotropic_beam": CSRC + "stage1_isotropic_wide.cu",
    "stage1_general": CSRC + "stage1_general_wide.cu",
    "bvp_forward": CSRC + "bvp_forward_wide.cu",
}
# the sources of the bodies at N = 17..32 (kernels.WIDE_MAX_N < N)
BIG_SOURCES = {
    "stage1_isotropic": CSRC + "stage1_isotropic_big.cu",
    "stage1_isotropic_beam": CSRC + "stage1_isotropic_big.cu",
    "stage1_general": CSRC + "stage1_general_big.cu",
    "bvp_forward": CSRC + "bvp_forward_big.cu",
    "bvp_backward": CSRC + "bvp_backward_big.cu",
}
# the sources of the bodies at N = 33..64 (kernels.BIG_MAX_N < N), and the
# name of each body in ptxas_summary
HUGE_SOURCES = {k: v.replace("_big.cu", "_huge.cu")
                for k, v in BIG_SOURCES.items()}
HUGE_PTXAS = {
    "stage1_isotropic": "stage1_isotropic_huge<33..64>",
    "stage1_isotropic_beam": "stage1_isotropic_huge_beam<33..64>",
    "stage1_general": "stage1_general_huge<33..64>",
    "bvp_forward": "bvp_forward_huge<33..64>",
    "bvp_backward": "bvp_backward_huge<33..64>",
}
# the sources of the bodies at N > 64 (kernels.HUGE_MAX_N < N), and the
# name of each body in ptxas_summary
GLOBAL_SOURCES = {k: v.replace("_big.cu", "_global.cu")
                  for k, v in BIG_SOURCES.items()}
GLOBAL_PTXAS = {
    "stage1_isotropic": "stage1_isotropic_global<65..>",
    "stage1_isotropic_beam": "stage1_isotropic_global_beam<65..>",
    "stage1_general": "stage1_general_global<65..>",
    "bvp_forward": "bvp_forward_global<65..>",
    "bvp_backward": "bvp_backward_global<65..>",
}
# K2's cluster body at N = 65..170 in ptxas_summary (its slab body above)
CLUSTER_PTXAS = "bvp_forward_cluster<65..170>"
AMARS_SW_TOA = 408.17


def say(phase: str, msg: str) -> None:
    print(f"[phase {phase}] {msg}", flush=True)


def run(cmd: list[str]) -> str:
    return subprocess.run(cmd, capture_output=True, text=True, check=True,
                          timeout=60).stdout.strip()


def cuda_ms(fn, reps: int) -> float:
    """Mean device time of ``fn()`` over ``reps`` calls, after one warm-up."""
    import torch

    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / reps


def rel_err(got, ref) -> float:
    return float((got - ref).abs().max() / ref.abs().max().clamp_min(1e-30))


STAGE1_TOL = "max|err| <= 3e-5 max|ref| per output"
# The stream counts of the repo's configurations, and with them every other
# nstr up to 16, each a kernel instantiation N = nstr/2 <= 8 (phase 19 runs
# the bodies of N = 9..16)
NSTR_MAIN = (4, 8, 16)
NSTR_ALL = (4, 6, 8, 10, 12, 14, 16)
BVP_TOL = "|err| <= 3e-5 max|ref| + 3e-4 |ref|"
# (L, ncol) of phases 3 and 10, two waves each: 1024 columns, then 1018,
# which no launch's block of columns divides, so the last block is partial.
PHASE3_SHAPES = ((100, 512), (37, 509))
# Phase 10 adds K6's edges on 1018 columns: one layer, and 25 = 24 + 1
# layers, one past a multiple of the segment size of K6's schedule at every
# N <= 4 (3 and 2), so the last segment holds one layer.
K6_EDGE_SHAPES = ((1, 509), (25, 509))
# One layer spanning 100 K (dtau 0.001-0.8): the layer-top sums of K6's
# flux mode add the particular solution at the layer top to the homogeneous
# part that cancels it, and every float32 solver loses digits there
# (ROADMAP section 3).  Against the float64 plain version at nstr 16, the
# float32 plain version and the JAX package's float32 path read 8.0e-5 and
# 7.7e-5 of max|ref| on the CPU, while (a, b) stay within 2.3e-7
# (tests/single_layer_report.py); phase 10 prints K6's and the float32
# plain version's readings on the card.  There K6's sums are held to the
# float64 plain version.
SINGLE_LAYER_TOL = 2e-4


def stage1_check(got, ref, what: str) -> float:
    """A stage-1 kernel's outputs (K1, K1 beam, K4) against its plain
    version: all finite and within ``STAGE1_TOL``
    (``tests/test_pallas_kernels.py:45``).  Returns the largest
    max|err|/max|ref| over the outputs."""
    import torch

    assert len(got) == len(ref), what
    errs = [rel_err(g, r) for g, r in zip(got, ref)]
    bad = {i: e for i, (e, g) in enumerate(zip(errs, got))
           if not e <= 3e-5 or not bool(torch.isfinite(g).all())}
    assert not bad, f"{what}: output index -> max|err|/max|ref| {bad}"
    return max(errs)


def bvp_check(got, ref, what: str) -> float:
    """A BVP kernel's outputs (K2, K3, K5) against the plain version: all
    finite and within ``BVP_TOL``, max|ref| taken per output
    (``tests/test_pallas_kernels.py:70, :103``).  Returns the largest
    max|err|/max|ref| over the outputs."""
    import torch

    for name, g, r in zip(("first", "second"), got, ref):
        assert bool(torch.isfinite(g).all()), f"{what}, {name} output"
        excess = ((g - r).abs() - 3e-4 * r.abs()).max().item()
        excess /= max(float(r.abs().max()), 1e-30)
        assert excess <= 3e-5, (f"{what}, {name} output: {excess:.2e} of "
                                "max|ref| over 3e-4 rtol, of 3e-5")
    return max(rel_err(g, r) for g, r in zip(got, ref))


def ptxas_summary(log: str) -> dict[str, str]:
    """'kernel<N>' -> 'R regs, F B stack, S B spill st, L B spill ld' from
    ptxas -v; the bodies of K1, K4 and K2 at N = 9..16 as
    'kernel_wide<9..16>', those of K1, K4 and K5 at N = 17..32 as
    'kernel_big<17..32>', K2's there as 'bvp_forward_big<17..24>' and
    'bvp_forward_big<25..32>' (its two tiles)."""
    out, cur, regs, spills = {}, None, {}, {}
    for line in log.splitlines():
        m = re.search(r"(?:entry function '|Function properties for )(\S+?)'?$",
                      line.strip())
        if m:
            k = re.search(r"(stage1_isotropic|stage1_general|"
                          r"bvp_forward_team|bvp_forward_half|bvp_forward|"
                          r"bvp_backward_flux|bvp_backward_rows|"
                          r"bvp_backward|bvp_fused_team|"
                          r"bvp_fused)_kernelILi(\d+)E(L[bi]([01])E)?",
                          m.group(1))
            w = re.search(r"(stage1_isotropic|stage1_general|bvp_forward)"
                          r"_wide_kernel(ILb([01])E)?", m.group(1))
            big = re.search(r"(stage1_isotropic|stage1_general|bvp_forward|"
                            r"bvp_backward)_big_kernel(ILb([01])E|"
                            r"ILi(\d+)ELi\d+ELi\d+E)?", m.group(1))
            huge = re.search(r"(stage1_isotropic|stage1_general|bvp_forward|"
                             r"bvp_backward)_huge_kernel(ILb([01])E)?",
                             m.group(1))
            glob = re.search(r"(stage1_isotropic|stage1_general|bvp_forward|"
                             r"bvp_backward)_global_kernel(ILb([01])E)?",
                             m.group(1))
            cluster = re.search(r"bvp_forward_cluster_kernel", m.group(1))
            cur = None
            if k:
                # the second template argument: K1's beam flag, K6's mode,
                # K4's parity of the azimuthal mode
                flag = {"stage1_isotropic": ("", "_beam"),
                        "stage1_general": ("", "_odd_m"),
                        "bvp_fused": ("_ab", "_flux"),
                        "bvp_fused_team": ("_ab", "_flux")}.get(k.group(1))
                name = k.group(1) + (flag[int(k.group(4))] if flag else "")
                cur = f"{name}<{k.group(2)}>"
            elif w:
                beam = "_beam" if w.group(3) == "1" else ""
                cur = f"{w.group(1)}_wide{beam}<9..16>"
            elif big:
                beam = "_beam" if big.group(3) == "1" else ""
                # K2's tile of 6 rows a thread serves N <= 24, of 8 N >= 25
                span = {"6": "17..24", "8": "25..32"}.get(big.group(4),
                                                          "17..32")
                cur = f"{big.group(1)}_big{beam}<{span}>"
            elif huge:
                beam = "_beam" if huge.group(3) == "1" else ""
                cur = f"{huge.group(1)}_huge{beam}<33..64>"
            elif glob:
                # K1's beam flag; K5's: its tile in shared memory (1) or
                # in global scratch (0, past N = 591 on the H100)
                flag = glob.group(3)
                suffix = ("" if flag is None else
                          {"0": "_scratch", "1": ""}[flag]
                          if glob.group(1) == "bvp_backward" else
                          {"0": "", "1": "_beam"}[flag])
                cur = f"{glob.group(1)}_global{suffix}<65..>"
            elif cluster:
                cur = CLUSTER_PTXAS
            continue
        if cur is None:
            continue
        m = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill stores, "
                      r"(\d+) bytes spill loads", line)
        if m:
            spills[cur] = m.groups()
        m = re.search(r"Used (\d+) registers", line)
        if m:
            regs[cur] = m.group(1)
    for k in sorted(regs):
        fr, st, ld = spills.get(k, ("?", "?", "?"))
        out[k] = f"{regs[k]} regs, {fr} B stack, {st} B spill st, {ld} B spill ld"
    return out


def near_err(got, ref, near) -> float:
    """max|err| / max|ref| on the ``near`` columns (the last axis), the
    largest over the outputs; max|ref| is taken over all columns."""
    return max(float((g[..., near] - r[..., near]).abs().max()
                     / r.abs().max().clamp_min(1e-30))
               for g, r in zip(got, ref))


def kernel_record(name, path, launches, fn, plain, args, kw, check, tol,
                  flops, near=None, reads=None, once=False):
    """One kernel against its plain version on ``args``, timed, with its
    bound; the entry of the ``kernels`` JSON line.  ``reads``, the tensors
    the function reads, where not all of ``args`` and ``kw``.  ``near``, a
    mask of the columns (the outputs' last axis) with a layer within
    ``RESONANCE_MARGIN`` of a beam resonance: ``check`` holds the other
    columns, the near ones are held to ``NEAR_RESONANCE_TOL`` of max|ref|
    and their count and reading go into the entry.  The bound is
    ``bench.roofline_run``'s from the bytes of ``reads`` and the outputs.
    N, read from the first ``(N, N, L, B)`` tensor of the inputs or else
    the outputs, picks the source of the body that N runs.  The kernel is
    timed over 20 calls and the plain version over 3; with ``once`` (the
    plain versions at N > 8 take seconds a call) the kernel over 3 calls
    and the plain version by the one call that gives the reference."""
    import torch

    from pyharp_tpu_torch.bench import roofline_run as R
    from pyharp_tpu_torch.rt.disort import kernels as K

    got = fn(*args, **kw)
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    want = plain(*args, **kw)
    stop.record()
    torch.cuda.synchronize()
    plain_ms = (start.elapsed_time(stop) if once else
                cuda_ms(lambda: plain(*args, **kw), 3))
    what = f"{name} on the {path} inputs"
    extra = {}
    if near is not None and bool(near.any()):
        away = ~near
        rel = check([g[..., away] for g in got], [w[..., away] for w in want],
                    f"{what}, columns away from a beam resonance")
        err = near_err(got, want, near)
        assert err <= NEAR_RESONANCE_TOL, (
            f"{what}, {int(near.sum())} columns near a resonance: {err:.2e}")
        extra = dict(near_columns=int(near.sum()), max_rel_err_near=err)
        tol += (f" on the columns away from a beam resonance, max|err| <= "
                f"{NEAR_RESONANCE_TOL} max|ref| on the near ones")
    else:
        rel = check(got, want, what)
    if reads is None:
        reads = list(args) + list(kw.values())
    nbytes = R.tensor_bytes(reads, got)
    bound_ms, bound_by = R.bound(nbytes, flops)
    src, tpu = KERNEL_TABLE[name]
    N = next(t for t in (*args, *got) if isinstance(t, torch.Tensor)
             and t.dim() == 4).shape[1]
    if N > K.HUGE_MAX_N:
        src = GLOBAL_SOURCES[name]
    elif N > K.BIG_MAX_N:
        src = HUGE_SOURCES[name]
    elif N > K.WIDE_MAX_N:
        src = BIG_SOURCES[name]
    elif N > K.NARROW_MAX_N:
        src = WIDE_SOURCES.get(name, src)
    rec = dict(
        name=name, route="cuda", source=src, replaces=tpu, launches=launches,
        max_abs_err=max(float((g - r).abs().max()) for g, r in zip(got, want)),
        ms=cuda_ms(lambda: fn(*args, **kw), 3 if once else 20),
        plain_ms=plain_ms,
        bound_ms=bound_ms, bound_by=bound_by, library_ms=None, path=path, max_rel_err=rel, tolerance=tol,
        bytes=nbytes, flops=flops, **extra)
    del got, want
    return rec


def records_line(recs) -> str:
    return "; ".join(
        f"{r['name']} {r['ms']:.3f} ms (plain {r['plain_ms']:.3f} ms, bound "
        f"{r['bound_ms']:.3f} ms by {r['bound_by']}"
        + (f", ptxas {r['ptxas']}" if "ptxas" in r else "")
        + f", max|err|/max|ref| {r['max_rel_err']:.2e}, {r['tolerance']})"
        for r in recs)


# ---- the sharded band flux on two ranks sharing the card (phase 17) --------

SHARDED_SHAPE = (8, 8192, 100, 8)
PHASE17_MESHES = ((2, 1), (1, 2))


def phase17_rank(rank: int, n: int, out: str) -> None:
    """One rank of phase 17 (run by ``parallel.spawn``): the sharded bench
    step on each mesh, its launches and time, its band flux saved to
    ``<out>``, then ``partition_overhead_run``; a JSON record per rank."""
    import torch

    from pyharp_tpu_torch.bench.scaling import (build_sharded_step,
                                                partition_overhead_run)
    from pyharp_tpu_torch.parallel import make_radiation_mesh, rank_device
    from pyharp_tpu_torch.rt.disort import kernels as K

    torch.backends.cuda.matmul.allow_tf32 = False
    dev = rank_device("cuda")
    nwave, ncol, nlyr, nstr = SHARDED_SHAPE
    rec = {}
    for n_col, n_wave in PHASE17_MESHES:
        mesh = make_radiation_mesh(n_col, n_wave)
        step, args = build_sharded_step(mesh, nwave, ncol, nlyr, nstr,
                                        device=dev, kernel="cuda")
        K.reset_launches()
        got = step(*args)
        torch.cuda.synchronize()
        launches = K.launch_counts()
        expect_launches(launches, stage1_isotropic=1, bvp_forward=1,
                        bvp_backward_flux=1)
        tag = f"{n_col}x{n_wave}"
        np.save(f"{out}/rank{rank}_{tag}.npy", got.cpu().numpy())
        rec[tag] = dict(launches=launches, ms=cuda_ms(lambda: step(*args), 5),
                        col_index=mesh.index("col"))
        del step, args, got
    rec["partition"] = partition_overhead_run(ncol_total=ncol, nwave=nwave,
                                              nlyr=nlyr, nstr=nstr,
                                              device=dev)
    rec["device"] = torch.cuda.get_device_name(dev)
    with open(f"{out}/rank{rank}.json", "w") as f:
        json.dump(rec, f)


# ---- problems -------------------------------------------------------------

def hg_moments(g: float, nstr: int) -> np.ndarray:
    """Delta-M scaled Henyey-Greenstein moments g_1..g_nstr."""
    gl = g ** np.arange(1, nstr + 1)
    return (gl - gl[-1]) / (1.0 - gl[-1])


def expect_launches(launches, **want):
    full = {k: want.get(k, 0) for k in KERNEL_TABLE}
    assert launches == full, (launches, full)


# A column is near a beam resonance lam_k = 1/mu0 when one of its layers has
# |lam_k^2 - 1/mur^2| < RESONANCE_MARGIN (lam_k^2 + 1/mur^2).  The beam
# particular's denominator is floored at 1e-4 (relative) in float32, by the
# Pallas kernels, the JAX package's float32 XLA path and the port alike,
# and at 1e-9 in float64, so there the float32 and float64 answers differ
# by the floor's regularization; the JAX package's own float32 path departs
# from its float64 one alike (tests/resonance_report.py).  Near columns
# are held to NEAR_RESONANCE_TOL of the float64 plain path run with
# float32's floor: the beam particular grows there up to 1/floor times its
# usual size before the BVP cancels it, and float32 rounding with it.
# Their distance from the float64 answer itself is reported.
RESONANCE_MARGIN = 1e-3
NEAR_RESONANCE_TOL = 1e-3


def resonance_margin(md) -> "torch.Tensor":
    """Per column ``(B,)``: the least relative distance of any layer's
    lam_k^2 from 1/mur^2 in a solve's ``_solve_mode`` output."""
    lam2 = md["sol"].lam ** 2
    inv = 1.0 / md["mur"][None] ** 2
    return ((lam2 - inv).abs() / (lam2 + inv)).amin(dim=(0, 1))


@contextlib.contextmanager
def float32_resonance_floor():
    """Plain solves in any dtype with float32's beam resonance floor, the
    regularization the float32 kernels compute."""
    import torch

    from pyharp_tpu_torch.rt.disort import solver as S

    eps = S.beam_resonance_eps(torch.float32)
    with mock.patch.object(S, "beam_resonance_eps", lambda dtype: eps):
        yield


def flux_reference(ds64, args64):
    """The float64 plain path's fluxes on ``args64``; each column's least
    distance from a beam resonance (None without a beam); where a column
    lies within ``RESONANCE_MARGIN`` of one, the fluxes of the float64
    plain path run with float32's resonance floor (else None)."""
    def fluxes():
        pr64 = ds64._prepare(*args64)
        md64 = ds64._solve_mode(pr64)
        return ds64._fluxes_from_mode0(pr64, md64)[0], md64

    ref, md64 = fluxes()
    if "mur" not in md64:              # no beam: no resonance
        return ref, None, None
    margin = resonance_margin(md64)
    ref_f = None
    if bool((margin < RESONANCE_MARGIN).any()):
        with float32_resonance_floor():
            ref_f = fluxes()[0]
    return ref, margin, ref_f


def solve_and_check(ds, ds64, args, args64, want_launches, label, sel=None,
                    steps=10, reference=None):
    """One counted forward of a path, its float64 checks on every column (on
    the waves ``sel`` where given: ``args64`` holds those alone) and
    ``steps`` timed steps.  Columns with no layer within ``RESONANCE_MARGIN``
    of a beam resonance are held to 1e-4 max|flux| of the float64 plain
    path, the others to ``NEAR_RESONANCE_TOL`` of it run with float32's
    resonance floor.  ``reference``: :func:`flux_reference` of ``ds64`` on
    ``args64``, computed earlier (else here).  Returns (launches, err away,
    err near against float32's floor, err near against the float64 answer,
    number of near columns, ms)."""
    import torch

    from pyharp_tpu_torch.rt.disort import kernels as K

    K.reset_launches()
    flux = ds.forward(*args)
    torch.cuda.synchronize()
    launches = K.launch_counts()
    expect_launches(launches, **want_launches)
    assert bool(torch.isfinite(flux).all()), label
    got = flux if sel is None else flux.index_select(0, sel)
    if reference is None:
        reference = flux_reference(ds64, args64)
    ref, margin, ref_f = reference

    def err(r):
        return (got.double() - r).abs().amax(dim=(2, 3)) / r.abs().max()

    col = err(ref)
    margin = (torch.full_like(col, float("inf")) if margin is None
              else margin.reshape(col.shape))
    near = margin < RESONANCE_MARGIN
    col_f = col if ref_f is None else err(ref_f)
    err_away = float(col[~near].max()) if bool((~near).any()) else 0.0
    err_near = float(col[near].max()) if bool(near.any()) else 0.0
    err_near_f = float(col_f[near].max()) if bool(near.any()) else 0.0
    assert err_away <= 1e-4, f"{label} vs float64 plain: {err_away:.2e}"
    assert err_near_f <= NEAR_RESONANCE_TOL, (
        f"{label} vs float64 plain with float32's resonance floor near a "
        f"resonance: {err_near_f:.2e}")
    del flux, got, col, col_f
    ms = cuda_ms(lambda: ds.forward(*args).mean(dim=0), steps)
    return launches, err_away, err_near_f, err_near, int(near.sum()), ms


# ---- the radiance path -------------------------------------------------------

def step_pieces(ds, prop, bc, reps: int) -> dict[str, float]:
    """Mean wall ms of each piece of ``ds.intensities(prop, bc)`` over the
    same ``reps`` steps after a warm-up, each piece ending in a
    synchronize: ``prepare``, ``m0`` (the m = 0 solve), ``modes`` (the
    modes m >= 1), ``radiances`` (sweeps, corrections, assembly); then,
    not part of the step, ``radiances`` without the modes m >= 1."""
    import torch

    tot = dict(prepare=0.0, m0=0.0, modes=0.0, radiances=0.0,
               radiances_without_modes=0.0)
    for rep in range(reps + 1):
        torch.cuda.synchronize()
        t = [time.perf_counter()]
        pr = ds._prepare(prop, bc, None)
        torch.cuda.synchronize()
        t.append(time.perf_counter())
        md = ds._solve_mode(pr, flux_only=False)
        torch.cuda.synchronize()
        t.append(time.perf_counter())
        modes = ds._modes_batched(pr)
        torch.cuda.synchronize()
        t.append(time.perf_counter())
        ds._radiances(pr, md, modes)
        torch.cuda.synchronize()
        t.append(time.perf_counter())
        ds._radiances(pr, md, None)
        torch.cuda.synchronize()
        t.append(time.perf_counter())
        if rep:
            for k, a, b in zip(tot, t, t[1:]):
                tot[k] += (b - a) * 1e3 / reps
    return tot


def modes_margin(modes) -> "torch.Tensor":
    """Per mode and column ``(nm, B)``: the least relative distance of any
    layer's lam_k^2 from 1/mur^2 in the modes m >= 1 of a radiance solve
    (``Disort._modes_batched``'s output)."""
    lam2 = modes["lam"] ** 2
    inv = 1.0 / modes["mur"] ** 2
    return ((lam2 - inv).abs() / (lam2 + inv)).amin(dim=(1, 2))


def radiance_reference(ds64, args64):
    """The float64 plain path's radiances on ``args64``, and each column's
    least distance from a beam resonance over every mode ``(B,)``, and per
    mode m >= 1 ``(nm, B)``."""
    import torch

    pr = ds64._prepare(*args64, None)
    md = ds64._solve_mode(pr, flux_only=False)
    modes = ds64._modes_batched(pr)
    out = ds64._radiances(pr, md, modes)
    per_mode = modes_margin(modes)
    margin = torch.minimum(resonance_margin(md), per_mode.amin(dim=0))
    return out, margin, per_mode


def radiance_errors(out, ref, ref_f, near, keys=("flux", "uu")):
    """``flux`` and ``uu`` against the float64 plain path ``ref``, column by
    column (``near`` ``(nwave, ncol)``).  Away from a beam resonance: max|err|
    <= 1e-4 of max|flux| (all columns), and of the column's own max|uu|.
    Near one, against ``ref_f``, the float64 plain path run with float32's
    resonance floor: flux as phase 7 holds it, max|err| <=
    ``NEAR_RESONANCE_TOL`` of max|flux| over all columns; uu column by
    column, max|err| <= ``NEAR_RESONANCE_TOL`` of the column's own max|uu|,
    so a column of small radiances is held to its own scale.  Returns per
    output (away, near vs ``ref_f``, near vs ``ref``, near per column vs
    ``ref``), each over its own scale."""
    res = {}
    for key in keys:
        got, want, want_f = out[key].double(), ref[key], ref_f[key]
        assert bool(got.isfinite().all()), key
        dims = tuple(range(2, got.dim()))
        err = (got - want).abs().amax(dim=dims)
        err_f = (got - want_f).abs().amax(dim=dims)
        if key == "flux":
            own, own_f = want.abs().max(), want_f.abs().max()
        else:
            own, own_f = want.abs().amax(dim=dims), want_f.abs().amax(dim=dims)
        away = float((err / own)[~near].max()) if bool((~near).any()) else 0.0
        if bool(near.any()):
            near_f = float((err_f / own_f)[near].max())
            near_64 = float(err[near].max() / want.abs().max())
            near_col = float((err / own)[near].max())
        else:
            near_f = near_64 = near_col = 0.0
        assert away <= 1e-4, f"{key} vs float64 plain: {away:.2e}"
        assert near_f <= NEAR_RESONANCE_TOL, (
            f"{key} near a resonance vs float64 plain with float32's floor: "
            f"{near_f:.2e}")
        res[key] = (away, near_f, near_64, near_col)
    return res


def errors_text(res, n_near, n) -> str:
    def scale(k):
        return "the column's max|uu|" if k == "uu" else f"max|{k}|"

    return "; ".join(
        f"{k}: {a:.2e} on the {n - n_near} columns away from a resonance "
        f"(<= 1e-4{' of the column' if k == 'uu' else ''}), on the {n_near} "
        f"near ones {f:.2e} vs float32's floor (<= {NEAR_RESONANCE_TOL} of "
        f"{scale(k)}) and {d:.2e} vs float64 ({c:.2e} of the column's max)"
        for k, (a, f, d, c) in res.items())


# ---- K6: the single-pass BVP against its plain version and K2 + K3/K5 ------

K6_PAIR_TOL = 3e-6   # of max|ref| per output, tests/test_pallas_kernels.py:121


def bvp_inputs(pr, md):
    """K6's inputs from a solve's ``_prepare`` and ``_solve_mode`` outputs:
    (gp, gm, expd, dblk, albedo, ptop_p, ptop_m)."""
    sol = md["sol"]
    return (sol.gp, sol.gm, sol.expd, md["dblk"], pr["albedo"],
            md["ptop_p"], md["ptop_m"])


def bvp_pair(ins, md, ang, flux_only: bool, plain: bool = False):
    """K2 then K3 (flux mode) or K5 ((a, b) mode) on K6's inputs; with
    ``plain``, their plain versions chained the same way."""
    from pyharp_tpu_torch.rt.disort import kernels as K

    fwd, bwd_flux, bwd = ((K.bvp_forward_plain, K.bvp_backward_flux_plain,
                           K.bvp_backward_plain) if plain else
                          (K.bvp_forward, K.bvp_backward_flux, K.bvp_backward))
    gp, gm, E, dblk, alb, tp, tm = ins
    P, g = fwd(gp, gm, E, dblk, alb, ang)
    if flux_only:
        return bwd_flux(gp, gm, E, P, g, tp, tm, md["pb_p"], md["pb_m"], ang)
    return bwd(gp, gm, E, P, g, ang)


def k6_pair_reference(ins, md, ang, flux_only: bool):
    """What K6 must give from the two-kernel pair: K2 + K5's (a, b); in
    flux mode K3's layer-top sums and K2 + K5's bottom-layer (a, b).  The
    bottom layer's x = g + P dx has dx = 0 in every sweep, so K6's raw
    ab_last is exact there; contracted to K3's bottom-level sums it would
    meet K3's in-kernel sums only to float32 rounding of a cancelling sum
    (2.27e-5 of max|ref| in one layer spanning 100 K, dtau down to 1e-3)."""
    import torch

    a, b = bvp_pair(ins, md, ang, False)
    if not flux_only:
        return a, b
    return (bvp_pair(ins, md, ang, True)[0],
            torch.cat([a[:, -1], b[:, -1]]))


def k6_against_pair(ins, md, ang, flux_only: bool, what: str):
    """K6 against ``k6_pair_reference`` on the same inputs, within
    ``K6_PAIR_TOL`` of max|ref| per output; timed against K2 + K3 (flux
    mode) or K2 + K5.  Returns (errors, K6 ms, pair ms)."""
    from pyharp_tpu_torch.rt.disort import kernels as K

    def k6():
        return K.bvp_fused(*ins, wmu=ang.w * ang.mu, flux_only=flux_only)

    def pair():
        return bvp_pair(ins, md, ang, flux_only)

    got, want = k6(), k6_pair_reference(ins, md, ang, flux_only)
    errs = [rel_err(g, w) for g, w in zip(got, want)]
    assert max(errs) <= K6_PAIR_TOL, f"{what}: K6 vs K2 + K3/K5 {errs}"
    return errs, cuda_ms(k6, 20), cuda_ms(pair, 20)


def single_layer_check(got, want, ins, kw, what: str) -> str:
    """K6's layer-top sums ``got`` at L = 1 against the float64 plain
    version within ``SINGLE_LAYER_TOL`` of max|ref|; the float32 plain
    version's ``want`` read beside.  Returns the note for phase 10's line."""
    from pyharp_tpu_torch.rt.disort import kernels as K

    assert bool(got.isfinite().all()), what
    ref = K.bvp_fused_plain(*(x.double() for x in ins), **kw)[0]
    err6, err32 = rel_err(got.double(), ref), rel_err(want.double(), ref)
    assert err6 <= SINGLE_LAYER_TOL, (
        f"{what}: layer-top sums vs float64 plain {err6:.2e} (float32 plain "
        f"{err32:.2e})")
    return (f" (flux sums vs float64 plain {err6:.2e}, the float32 plain "
            f"version {err32:.2e})")


def k6_record(path, pr, md, ang, flux_only: bool, ins=None, near=None):
    """K6 on a path's BVP inputs (``bvp_inputs(pr, md)`` unless ``ins`` is
    given, with ``near`` the columns near a resonance): against its plain
    version (phase 3's bound; with a beam, ``NEAR_RESONANCE_TOL`` on the
    columns near a resonance) and K2 + K3/K5, timed; the ``kernels`` entry
    (launches 0: K6 has no caller on the paths) and a line of text.

    Near a resonance the BVP cancels a beam particular up to 1/floor times
    its usual size, so float32 rounding, which differs between the kernels
    (contracted multiply-adds) and the plain versions, is amplified through
    the forward and the backward sweep together; each sweep alone meets
    ``BVP_TOL`` on the path's inputs (phase 7).  On those columns K2 + K3/K5
    is held against the plain K2 then K3/K5 as well, and the reading
    printed beside K6's."""
    from pyharp_tpu_torch.bench.roofline_run import kernel_flops
    from pyharp_tpu_torch.rt.disort import kernels as K

    if ins is None:
        ins = bvp_inputs(pr, md)
        near = resonance_margin(md) < RESONANCE_MARGIN if "mur" in md else None
    N, _, L, B = ins[0].shape
    # the (a, b) mode reads no tp, tm
    rec = kernel_record("bvp_fused", path, 0, K.bvp_fused, K.bvp_fused_plain,
                        ins, dict(wmu=ang.w * ang.mu, flux_only=flux_only),
                        bvp_check, BVP_TOL,
                        kernel_flops("bvp_fused", N, L, B,
                                     flux_only=flux_only), near=near,
                        reads=list(ins if flux_only else ins[:5]))
    pair = "K2 + K3" if flux_only else "K2 + K5"
    near_note = ""
    if "near_columns" in rec:
        chained = near_err(bvp_pair(ins, md, ang, flux_only),
                           bvp_pair(ins, md, ang, flux_only, plain=True),
                           near)
        assert chained <= NEAR_RESONANCE_TOL, (path, chained)
        n = rec["near_columns"]
        rec.update(pair_vs_plain_max_rel_err_near=chained)
        near_note = (f" on the {B - n} columns away from a resonance, "
                     f"{rec['max_rel_err_near']:.2e} of max|ref| on the {n} "
                     f"near ones ({pair} vs the plain pair chained there: "
                     f"{chained:.2e})")
    errs, ms6, ms2 = k6_against_pair(ins, md, ang, flux_only, path)
    rec.update(mode="flux" if flux_only else "(a, b)",
               pair_ms=ms2, pair=pair, pair_max_rel_err=max(errs),
               share_of_bound=rec["bound_ms"] / rec["ms"])
    return rec, (f"{path}, {rec['mode']} mode: K6 {ms6:.3f} ms vs {pair} "
                 f"{ms2:.3f} ms, K6 at {rec['share_of_bound']:.1%} of its "
                 f"bound; max|err|/max|ref| vs {pair} "
                 f"{max(errs):.2e} (<= {K6_PAIR_TOL}), vs plain "
                 f"{rec['max_rel_err']:.2e}{near_note} ({rec['tolerance']}); "
                 f"plain {rec['plain_ms']:.3f} ms; bound "
                 f"{rec['bound_ms']:.3f} ms by {rec['bound_by']}")


def plain_check(errs: dict):
    """A ``check(name, got, want)`` for ``roofline_run`` and ``stages``:
    a stage-1 row's outputs held to ``STAGE1_TOL`` of the plain version's,
    a BVP row's (the kernels chained as the plain versions are) to
    ``BVP_TOL``, and K6's rows besides to ``K6_PAIR_TOL`` of what the K2 +
    K5 and K2 + K3 rows gave (``k6_pair_reference``'s contraction, K6's
    rows coming after theirs).  max|err|/max|ref| of each goes into
    ``errs``."""
    import torch

    pair = {}

    def check(name, got, want):
        if "BVP" not in name:
            errs[name] = stage1_check(got, want, name)
            return
        errs[name] = bvp_check(got, want, name)
        for two in ("K2 + K5", "K2 + K3"):
            if name.endswith(f"({two})"):
                pair[two] = got
        if name.endswith("(K6)"):
            ref = pair["K2 + K5"]
            if "flux" in name:
                ref = (pair["K2 + K3"][0],
                       torch.cat([ref[0][:, -1], ref[1][:, -1]]))
            e = max(rel_err(g, r) for g, r in zip(got, ref))
            assert e <= K6_PAIR_TOL, f"{name}: K6 vs K2 + K3/K5 {e:.2e}"
            errs[name + " vs the pair"] = e
    return check


def thermal_records(path, launches, pr, md, ang, once=False):
    """K1, K2 and K3 against their plain versions on a thermal path's own
    inputs, every column, to phase 2's and 3's bounds, each timed
    (``once`` as in ``kernel_record``); the entries of the ``kernels``
    line."""
    from pyharp_tpu_torch.bench.roofline_run import kernel_flops
    from pyharp_tpu_torch.rt.disort import kernels as K

    from pyharp_tpu_torch.rt.disort.disort import FUSED_FLUX_MAX_N

    sol = md["sol"]
    N, L, B = sol.gp.shape[0], pr["L"], pr["B"]
    bwd = (sol.gp, sol.gm, sol.expd, md["P"], md["g"])
    if N <= FUSED_FLUX_MAX_N:
        last = kernel_record(
            "bvp_backward_flux", path, launches["bvp_backward_flux"],
            K.bvp_backward_flux, K.bvp_backward_flux_plain,
            (*bwd, md["ptop_p"], md["ptop_m"], md["pb_p"], md["pb_m"], ang),
            {}, bvp_check, BVP_TOL, kernel_flops("bvp_backward_flux", N, L, B),
            once=once)
    else:
        last = kernel_record(
            "bvp_backward", path, launches["bvp_backward"], K.bvp_backward,
            K.bvp_backward_plain, (*bwd, ang), {}, bvp_check, BVP_TOL,
            kernel_flops("bvp_backward", N, L, B), once=once)
    return [
        kernel_record("stage1_isotropic", path, launches["stage1_isotropic"],
                      K.stage1_isotropic, K.stage1_isotropic_plain,
                      (pr["ssa_s"], pr["dtau"], pr["b_top_lay"], pr["slope"],
                       ang), {}, stage1_check, STAGE1_TOL,
                      kernel_flops("stage1_isotropic", N, L, B),
                      once=once),
        kernel_record("bvp_forward", path, launches["bvp_forward"],
                      K.bvp_forward, K.bvp_forward_plain,
                      (sol.gp, sol.gm, sol.expd, md["dblk"], pr["albedo"],
                       ang), {}, bvp_check, BVP_TOL,
                      kernel_flops("bvp_forward", N, L, B),
                      once=once),
        last,
    ]


def sums_check(ins, ang, info: dict, away):
    """A check for K3 (``kernel_record``'s ``check``) where its layer-top
    and bottom-level sums cancel in float32: the sums add the particular
    solution, many times the result with a beam and forward-peaked
    moments, to the homogeneous part that cancels it, so the rounding of
    the float32 inputs alone moves them by more than ``BVP_TOL`` allows
    (phase 13 prints the float32 plain version's distance from float64
    beside the kernel's).  As phase 10 holds K6's layer-top sums at L = 1,
    each output is held to ``SINGLE_LAYER_TOL`` of max|ref| of the float64
    plain version on the same inputs, on the columns ``away`` from a beam
    resonance (``kernel_record`` holds the others); the float32 plain
    version's reading and the kernel's against it (``BVP_TOL``'s measure,
    reported) go into ``info``."""
    from pyharp_tpu_torch.rt.disort import kernels as K

    ref = [r[..., away] for r in
           K.bvp_backward_flux_plain(*(x.double() for x in ins), ang)]

    def check(got, want, what):
        errs, errs32, excess = [], [], []
        for g, w, r in zip(got, want, ref):
            assert bool(g.isfinite().all()), what
            errs.append(rel_err(g.double(), r))
            errs32.append(rel_err(w.double(), r))
            excess.append(float(((g - w).abs() - 3e-4 * w.abs()).max()
                                / w.abs().max().clamp_min(1e-30)))
        assert max(errs) <= SINGLE_LAYER_TOL, (
            f"{what}: sums vs float64 plain {errs} (float32 plain {errs32})")
        info.update(max_rel_err_vs_float64=max(errs),
                    plain_max_rel_err_vs_float64=max(errs32),
                    vs_plain_excess_over_rtol=max(excess))
        return max(errs)
    return check


def beam_records(path, launches, pr, md, ang, near=None,
                 sums_vs_float64=False, once=False):
    """The kernels of a beam solve's ``_solve_mode`` (``forward``) against
    their plain versions on that solve's own inputs, every column, each
    timed: K4 (phase moments; no thermal source) or K1's beam variant, K2,
    then K3 (N <= ``FUSED_FLUX_MAX_N``) or K5.  ``near``, as in
    ``kernel_record``, for K2 and K5; with ``sums_vs_float64``, K3 is held
    by ``sums_check``; ``once`` as in ``kernel_record``.  The entries
    of the ``kernels`` line, in that order."""
    import torch

    from pyharp_tpu_torch.bench.roofline_run import kernel_flops
    from pyharp_tpu_torch.rt.disort import kernels as K
    from pyharp_tpu_torch.rt.disort.disort import FUSED_FLUX_MAX_N

    sol = md["sol"]
    N, L, B = sol.gp.shape[0], pr["L"], pr["B"]
    s1 = (pr["ssa_s"], pr["dtau"], pr["b_top_lay"], pr["slope"])
    nmom = pr["pmom_s"].shape[1]
    if nmom:
        recs = [kernel_record(
            "stage1_general", path, launches["stage1_general"],
            K.stage1_general, K.stage1_general_plain,
            (pr["ssa_s"], pr["pmom_s"], *s1[1:], ang),
            dict(thermal=False, fbeam=pr["fbeam"], mur=md["mur"],
                 lam0=md["lam0"]), stage1_check, STAGE1_TOL,
            kernel_flops("stage1_general", N, L, B, nmom=nmom,
                         sweeps=K.kernel_sweeps(N), thermal=False, beam=True),
            reads=[pr["ssa_s"], pr["pmom_s"], pr["dtau"], pr["fbeam"],
                   md["mur"], md["lam0"]], once=once)]
    else:
        recs = [kernel_record(
            "stage1_isotropic_beam", path, launches["stage1_isotropic_beam"],
            K.stage1_isotropic_beam, K.stage1_isotropic_beam_plain,
            (*s1, pr["fbeam"], md["mur"], ang), {}, stage1_check, STAGE1_TOL,
            kernel_flops("stage1_isotropic_beam", N, L, B), once=once)]
    recs.append(kernel_record(
        "bvp_forward", path, launches["bvp_forward"], K.bvp_forward,
        K.bvp_forward_plain,
        (sol.gp, sol.gm, sol.expd, md["dblk"], pr["albedo"], ang), {},
        bvp_check, BVP_TOL, kernel_flops("bvp_forward", N, L, B), near=near,
        once=once))
    bwd = (sol.gp, sol.gm, sol.expd, md["P"], md["g"])
    if N <= FUSED_FLUX_MAX_N:
        tops = (md["ptop_p"], md["ptop_m"], md["pb_p"], md["pb_m"])
        info = {}
        check, tol = bvp_check, BVP_TOL
        if sums_vs_float64:
            away = torch.ones(B, dtype=torch.bool, device=sol.gp.device)
            if near is not None and bool(near.any()):
                away = ~near
            check = sums_check((*bwd, *tops), ang, info, away)
            tol = (f"max|err| <= {SINGLE_LAYER_TOL} max|ref| of the float64 "
                   "plain version (float32 cancellation in the sums)")
        recs.append(kernel_record(
            "bvp_backward_flux", path, launches["bvp_backward_flux"],
            K.bvp_backward_flux, K.bvp_backward_flux_plain,
            (*bwd, *tops, ang), {}, check, tol,
            kernel_flops("bvp_backward_flux", N, L, B), near=near,
            once=once))
        recs[-1].update(info)
    else:
        recs.append(kernel_record(
            "bvp_backward", path, launches["bvp_backward"], K.bvp_backward,
            K.bvp_backward_plain, (*bwd, ang), {}, bvp_check, BVP_TOL,
            kernel_flops("bvp_backward", N, L, B), near=near, once=once))
    return recs

def radiance_k4(ds, pr, modes, check=None):
    """K4 at every mode of a radiance solve (no thermal source) as the path
    launches it, m = 0, then the modes m >= 1 through
    ``kernels.stage1_general_modes`` (one launch at N > 32, one a mode
    below), and its plain version: every mode in one pass
    (``kernels.stage1_general_modes_plain``, the bits of a call per mode).
    Returns ``(kernel, plain, lam00)``, the first two taking no arguments
    and giving every mode's outputs ``(gp, gm, lam, expd, y0p, y0m, y1, zp,
    zm)`` in one tuple; with ``check``, a set of modes m >= 1, only m = 0's
    and theirs (the kernel still launched at every mode, the plain version
    run at those alone)."""
    import torch

    from pyharp_tpu_torch.rt.disort import kernels as K
    from pyharp_tpu_torch.rt.disort.legendre import lepoly

    ang0 = ds._ang0
    lam00 = lepoly(pr["umu0"], 0, ang0.lam_tables.shape[0] - 1).contiguous()
    angs = [ds._angles(m) for m in modes["ms"]]
    s4 = (pr["ssa_s"], pr["pmom_s"], pr["dtau"])
    b4 = dict(fbeam=pr["fbeam"], mur=modes["mur"])
    keep = [i for i, m in enumerate(modes["ms"]) if check is None or m in check]

    def kernel():
        outs = K.stage1_general(*s4, pr["b_top_lay"], pr["slope"], ang0,
                                thermal=False, lam0=lam00, **b4)
        folded = K.stage1_general_modes(*s4, angs, lam0s=modes["lam0"], **b4)
        for i in keep:
            gp, gm, lam, expd, zp, zm = (x[..., i, :] for x in folded)
            outs += (gp, gm, lam, expd, *[K.zero_particular(lam)] * 3, zp, zm)
        return outs

    def plain():
        outs = ()
        for o in K.stage1_general_modes_plain(
                *s4, [ang0] + [angs[i] for i in keep],
                lam0s=[lam00] + [modes["lam0"][i] for i in keep], **b4):
            outs += o
        return outs

    return kernel, plain, lam00


# ---- 18 to 32 streams (phase 19) --------------------------------------------

# every nstr with a body of N = 9..16 (csrc/*_wide.cu, K5 instantiated)
NSTR_WIDE = tuple(range(18, 33, 2))
# matrices a torch.linalg.eigh call of phase 19's yardstick
EIGH_BATCH = 1 << 14


def wave_subset(p, stride: int, dtype, kernel: str):
    """Problem ``p`` on every ``stride``-th wave, in ``dtype`` (the same
    values: the draws are float32), as ``(disort, args, sel)``, ``sel`` the
    wave indices: the float64 reference where the whole width does not
    fit."""
    import torch

    from pyharp_tpu_torch.rt.disort.disort import Disort

    o = p.disort.options
    idx = list(range(0, o.nwave, stride))
    pick = lambda t: tuple(t[i] for i in idx) if t else t
    ds = Disort(o.replace(nwave=len(idx), wave_lower=pick(o.wave_lower),
                          wave_upper=pick(o.wave_upper), kernel=kernel))
    sel = torch.tensor(idx, device=p.prop.device)
    args = (p.prop.index_select(0, sel).to(dtype),
            {k: v.index_select(0, sel).to(dtype) for k, v in p.bc.items()},
            None if p.temf is None else p.temf.to(dtype))
    return ds, args, sel


def modes_distance(got, ref):
    """Stage 1's (gp, gm, lam, expd) against a reference with the modes of
    each element matched by eigenvalue: the Jacobi sweeps leave the modes
    in an order that rounding can change where two rotations nearly tie,
    and the solve does not depend on it.  Returns (the largest
    max|err|/max|ref| of the four, the number of elements whose mode order
    differs)."""
    import torch

    def sort(out):
        idx = out[2].argsort(dim=0)
        cols = idx[None].expand_as(out[0])
        return (out[0].gather(1, cols), out[1].gather(1, cols),
                out[2].gather(0, idx), out[3].gather(0, idx)), idx

    (g, gi), (r, ri) = sort(got[:4]), sort(ref[:4])
    swapped = int((gi != ri).any(dim=0).sum())
    return max(rel_err(a.double(), b) for a, b in zip(g, r)), swapped


# modes whose reference eigenvalues lie within this of each other (relative)
# form a near-degenerate set: rounding may turn their eigenvectors within
# their span, so only the span is compared
DEGENERATE_REL = 1e-6


def modes_subspace_distance(got, ref):
    """As ``modes_distance``, with the modes matched as subspaces: each
    near-degenerate set (reference eigenvalues within ``DEGENERATE_REL`` of
    their neighbour's, relative) as one span, every other mode as its own
    line.  Each set's columns of [gp; gm] in ``got`` are compared with
    their projection onto the span of ``ref``'s (least squares), so an
    eigenvector's sign, which the Jacobi sweeps leave free, and a turn
    within a degenerate span do not count.  Returns (the largest
    max|err|/max|ref| of gp, gm, lam, expd so matched, the largest sine of
    a principal angle between two matched spans, the number of
    near-degenerate sets)."""
    import torch

    def sort(out):
        idx = out[2].argsort(dim=0)
        cols = idx[None].expand_as(out[0])
        return [out[0].gather(1, cols).double(),
                out[1].gather(1, cols).double(),
                out[2].gather(0, idx).double(), out[3].gather(0, idx).double()]

    g, r = sort(got[:4]), sort(ref[:4])
    N = r[2].shape[0]
    vg = torch.cat(g[:2]).reshape(2 * N, N, -1)      # [gp; gm] by mode
    vr = torch.cat(r[:2]).reshape(2 * N, N, -1)
    # every mode on its own line: got's column less its projection on ref's
    dot = (vr * vg).sum(dim=0)
    nr = (vr * vr).sum(dim=0)
    fit = vr * (dot / nr)[None]
    lam = r[2].reshape(N, -1)
    tie = ((lam[1:] - lam[:-1]).abs()
           <= DEGENERATE_REL * torch.maximum(lam[1:].abs(), lam[:-1].abs()))
    alone = torch.ones_like(lam, dtype=torch.bool)
    alone[1:] &= ~tie
    alone[:-1] &= ~tie
    cos2 = (dot * dot / (nr * (vg * vg).sum(dim=0))).clamp(max=1.0)
    sine = float((1.0 - cos2[alone]).sqrt().max()) if bool(alone.any()) else 0.0
    sets = 0
    for e in torch.nonzero(tie.any(dim=0)).flatten().tolist():
        k = 0
        while k < N:
            j = k
            while j + 1 < N and bool(tie[j, e]):
                j += 1
            if j > k:
                sets += 1
                a, b = vg[:, k:j + 1, e], vr[:, k:j + 1, e]
                fit[:, k:j + 1, e] = b @ torch.linalg.lstsq(b, a).solution
                cos = torch.linalg.svdvals(torch.linalg.qr(b).Q.T
                                           @ torch.linalg.qr(a).Q).min()
                sine = max(sine, float((1.0 - cos.clamp(max=1.0) ** 2).sqrt()))
            k = j + 1
    # the matched columns: ref's plus what got holds outside ref's span
    m = (vr + vg - fit).reshape(2 * N, *g[0].shape[1:])
    g[0], g[1] = m[:N], m[N:]
    return max(rel_err(a, b) for a, b in zip(g, r)), sine, sets


def flux_line(label, res, card) -> str:
    launches, err, err_near_f, err_near, n_near, ms = res
    return (f"{label}: launches {launches}; max|err|/max|flux| vs float64 "
            f"plain: {err:.2e} on the columns with every layer over "
            f"{RESONANCE_MARGIN} from a beam resonance (<= 1e-4); on the "
            f"other {n_near}, {err_near_f:.2e} vs float64 plain with "
            f"float32's resonance floor (<= {NEAR_RESONANCE_TOL}) and "
            f"{err_near:.2e} vs float64 plain; kernel path {ms:.3f} ms/step "
            f"[{card}]")


def stage1_exact(got, ref, what: str) -> float:
    """``stage1_check``, and the outputs bit-equal to the plain version's
    (asserted): K1 and K4 are built without multiply-add contraction to
    compute operation for operation what their plain versions compute."""
    import torch

    assert all(bool(torch.equal(g, r)) for g, r in zip(got, ref)), (
        f"{what}: not bit-equal to the plain version")
    return stage1_check(got, ref, what)


# instructions of one correctly rounded float32 division (~10) and of the
# subtraction and sum term around it (~3), for K1's issue floor
K1_DIVISION_INSTRUCTIONS = 13


def k1_division_floor_ms(N: int, L: int, B: int, clock_mhz: float) -> float:
    """The issue floor of K1's exact divisions at N > 8, an estimate from
    the algorithm (not read from the SASS, and not measured; printed beside
    K1's times, kept out of the ``kernels`` line): each of the N roots takes the
    midpoint's and ``WIDE_BISECT`` sums of N divisions, two Newton steps
    of N reciprocals and one division, and the eigenvector's N; each
    division ``K1_DIVISION_INSTRUCTIONS`` instructions, issued 128 lanes
    a cycle on every SM at ``clock_mhz``."""
    import torch

    from pyharp_tpu_torch.rt.disort import kernels as K

    divisions = N * ((1 + K.WIDE_BISECT) * N + 2 * (N + 1) + N)
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    instructions = divisions * K1_DIVISION_INSTRUCTIONS * L * B
    return instructions / (sms * 128 * clock_mhz * 1e6) * 1e3


def k1_ptxas(rec: dict, regs: dict) -> None:
    """K1's entry at N > 8 gets its body's ptxas line from phase 1."""
    beam = rec["name"] == "stage1_isotropic_beam"
    rec["ptxas"] = regs.get(f"stage1_isotropic_wide{'_beam' if beam else ''}"
                            "<9..16>")


def k1_floor_text(N: int, L: int, B: int, clock_mhz: float) -> str:
    return (f"K1's division issue floor, estimated from the algorithm at "
            f"{clock_mhz:.0f} MHz (not measured): "
            f"{k1_division_floor_ms(N, L, B, clock_mhz):.3f} ms")


def phase19(dev, card: str, regs: dict) -> list:
    """Phase 19, 18 to 32 streams: every N = 9..16 against the plain
    versions, then the paths through the bodies of N = 9..16; returns the
    entries of the ``kernels`` line."""
    import torch

    from pyharp_tpu_torch.bench.problems import (bench_problem, extra_problem,
                                                 radiance_problem,
                                                 stage1_inputs)
    from pyharp_tpu_torch.bench import roofline_run as R
    from pyharp_tpu_torch.bench.roofline_run import kernel_flops
    from pyharp_tpu_torch.rt.disort import kernels as K
    from pyharp_tpu_torch.rt.disort.legendre import lepoly
    from pyharp_tpu_torch.rt.disort.solver import make_static_angles

    t19 = time.perf_counter()
    kernels_json = []
    clock_mhz = float(run(["nvidia-smi", "--query-gpu=clocks.max.sm",
                           "--format=csv,noheader,nounits"]).splitlines()[0])
    # each new N: K1 (thermal, beam) and K4 (thermal x beam, m = 0; m = 1
    # with a beam; every mode at nstr 32 on the radiance path below)
    # bit-equal to their plain versions, K4's distance from float64 (8
    # Jacobi sweeps at every N > 4), K2 and K5 against their plain versions
    # on 1018 columns (the last block partial) x 8 layers
    msgs = []
    for nstr in NSTR_WIDE:
        L, B = 37, 4096
        ang = make_static_angles(nstr, nstr, 0)
        rng = np.random.default_rng(300 + nstr)
        ssa, dtau, btop, slope = stage1_inputs(L, B, seed=400 + nstr,
                                               device=dev)
        fbeam = torch.tensor(rng.uniform(0.5, 4.0, B), dtype=torch.float32,
                             device=dev)
        mu0 = rng.uniform(0.1, 1.0, B)
        mur = torch.tensor(np.broadcast_to(mu0, (L, B)).copy(),
                           dtype=torch.float32, device=dev)
        stage1_exact(K.stage1_isotropic(ssa, dtau, btop, slope, ang),
                     K.stage1_isotropic_plain(ssa, dtau, btop, slope, ang),
                     f"K1 nstr {nstr}")
        stage1_exact(
            K.stage1_isotropic_beam(ssa, dtau, btop, slope, fbeam, mur, ang),
            K.stage1_isotropic_beam_plain(ssa, dtau, btop, slope, fbeam, mur,
                                          ang), f"K1 beam nstr {nstr}")
        pm = torch.tensor(
            np.stack([hg_moments(0.2 if b % 2 else 0.8, nstr)
                      for b in range(B)], axis=-1)[None].repeat(L, axis=0),
            dtype=torch.float32, device=dev)
        mu0_t = torch.tensor(mu0, dtype=torch.float32, device=dev)
        d64 = 0.0
        for m in (0, 1):
            angm = make_static_angles(nstr, nstr, m)
            lam0 = lepoly(mu0_t, m, angm.lam_tables.shape[0] - 1).contiguous()
            for thermal in ((True, False) if m == 0 else (False,)):
                kw = dict(thermal=thermal, fbeam=fbeam, mur=mur, lam0=lam0)
                a4 = (ssa, pm, dtau, btop, slope, angm)
                got = K.stage1_general(*a4, **kw)
                stage1_exact(got, K.stage1_general_plain(*a4, **kw),
                             f"K4 nstr {nstr} m {m} thermal {thermal}")
                if m == 0 and thermal:
                    ref64 = K.stage1_general_plain(
                        *(x.double() for x in a4[:5]), angm, thermal=True,
                        fbeam=fbeam.double(), mur=mur.double(),
                        lam0=lam0.double())
                    d64, swapped = modes_distance(got, ref64)
                    d64s, sine, nsets = modes_subspace_distance(got, ref64)
                    del ref64
        p = extra_problem(2, 509, 8, nstr, g=0.8, device=dev, kernel="torch",
                          seed=nstr)
        ds = p.disort
        pr = ds._prepare(p.prop, p.bc, None)
        md = ds._solve_mode(pr)
        s5, a0 = md["sol"], ds._ang0
        e2 = bvp_check(K.bvp_forward(s5.gp, s5.gm, s5.expd, md["dblk"],
                                     pr["albedo"], a0), (md["P"], md["g"]),
                       f"K2 nstr {nstr}")
        bwd = (s5.gp, s5.gm, s5.expd, md["P"], md["g"], a0)
        e5 = bvp_check(K.bvp_backward(*bwd), K.bvp_backward_plain(*bwd),
                       f"K5 nstr {nstr}")
        msgs.append(f"nstr {nstr}: K1, K1 beam bit-equal; K4 (m 0 thermal "
                    f"on/off, m 1) bit-equal, its float32 vs float64 plain "
                    f"(gp, gm, lam, expd; modes matched by eigenvalue, "
                    f"{swapped} elements of {L * B} hold them in another "
                    f"order) {d64:.2e}, with each mode matched as a span "
                    f"(its sign free; {nsets} near-degenerate sets within "
                    f"{DEGENERATE_REL} as one span) {d64s:.2e}, the largest "
                    f"principal-angle sine {sine:.2e}; K2 {e2:.2e}, "
                    f"K5 {e5:.2e}")
        del p, ds, pr, md, s5, bwd, pm, got
    say("19", "at L 37 x B 4096 (stage 1) and 1018 columns x 8 layers "
              "(BVP): " + "; ".join(msgs) + f" ({STAGE1_TOL}; {BVP_TOL}) "
              f"[{card}]")
    # K1's and K4's last block partial: L 37 x B 509 elements is no
    # multiple of the 32 a block of their bodies at N = 9..16 takes
    for nstr in (18, 32):
        L, B = 37, 509
        ang = make_static_angles(nstr, nstr, 0)
        rng = np.random.default_rng(500 + nstr)
        ssa, dtau, btop, slope = stage1_inputs(L, B, seed=600 + nstr,
                                               device=dev)
        fbeam = torch.tensor(rng.uniform(0.5, 4.0, B), dtype=torch.float32,
                             device=dev)
        mu0 = torch.tensor(rng.uniform(0.1, 1.0, B), dtype=torch.float32,
                           device=dev)
        mur = mu0[None].expand(L, B).contiguous()
        pm = torch.tensor(hg_moments(0.8, nstr)[None, :, None]
                          .repeat(L, axis=0).repeat(B, axis=2),
                          dtype=torch.float32, device=dev)
        lam0 = lepoly(mu0, 0, ang.lam_tables.shape[0] - 1).contiguous()
        a4 = (ssa, pm, dtau, btop, slope, ang)
        kw = dict(thermal=True, fbeam=fbeam, mur=mur, lam0=lam0)
        stage1_exact(K.stage1_general(*a4, **kw),
                     K.stage1_general_plain(*a4, **kw),
                     f"K4 nstr {nstr} on {L} x {B} elements")
        stage1_exact(K.stage1_isotropic(ssa, dtau, btop, slope, ang),
                     K.stage1_isotropic_plain(ssa, dtau, btop, slope, ang),
                     f"K1 nstr {nstr} on {L} x {B} elements")
        s1b = (ssa, dtau, btop, slope, fbeam, mur, ang)
        stage1_exact(K.stage1_isotropic_beam(*s1b),
                     K.stage1_isotropic_beam_plain(*s1b),
                     f"K1 beam nstr {nstr} on {L} x {B} elements")
    say("19", f"K1, K1 beam and K4 bit-equal at nstr 18 and 32 on 37 x 509 "
              f"elements (the last block partial) [{card}]")
    say("19", f"{time.perf_counter() - t19:.1f} s into phase 19")

    # the isotropic thermal solve at nstr 32 through K1, K2, K5; the fixed
    # secular schedule of N <= 8 beside it, in float32, NaN there.  This
    # and the isotropic beam run the widths of bench.py and bench_extra.py
    # at 20 layers: the plain K2 at N = 16, which holds K2 on each path's
    # inputs and runs in the float64 reference, takes ~0.5 s a layer
    p = bench_problem(8, 2048, 20, 32, torch.float32, dev, "cuda")
    ds64, args64, _ = wave_subset(p, 1, torch.float64, "torch")
    res = solve_and_check(p.disort, ds64, p.args, args64,
                          dict(stage1_isotropic=1, bvp_forward=1,
                               bvp_backward=1),
                          "isotropic thermal nstr 32", steps=3)
    del ds64, args64
    path = "bench 8x2048x20 nstr 32"
    pr = p.disort._prepare(*p.args)
    md = p.disort._solve_mode(pr)
    fixed = K._stage1_isotropic_plain(pr["ssa_s"], pr["dtau"],
                                      pr["b_top_lay"], pr["slope"],
                                      p.disort._ang0)[0][0]
    n_nan = int(torch.isnan(fixed).sum())
    recs = thermal_records(path, res[0], pr, md, p.disort._ang0, once=True)
    k1_ptxas(recs[0], regs)
    recs[2]["ptxas"] = regs.get("bvp_backward_rows<16>")
    say("19", flux_line(f"isotropic thermal {path}", res, card)
              + f"; N <= 8's fixed secular schedule on the same inputs in "
              f"float32: {n_nan} of {fixed.numel()} entries of gp NaN; per "
              "kernel: " + records_line(recs) + "; "
              + k1_floor_text(16, pr["L"], pr["B"], clock_mhz)
              + f"; {time.perf_counter() - t19:.1f} s into phase 19")
    kernels_json += recs
    del p, pr, md, fixed, recs
    torch.cuda.empty_cache()

    # the isotropic beam at nstr 32 through K1's beam variant, K2, K5; the
    # aerosol configuration at nstr 22 (N = 11: 2N does not divide 32)
    for label, p, want in (
            ("isotropic beam 500x64x20 nstr 32",
             extra_problem(500, 64, 20, 32, beam=True, device=dev,
                           kernel="cuda"),
             dict(stage1_isotropic_beam=1, bvp_forward=1, bvp_backward=1)),
            ("aerosol 32x128x20 nstr 22, HG g 0.8",
             extra_problem(32, 128, 20, 22, g=0.8, device=dev, kernel="cuda"),
             dict(stage1_general=1, bvp_forward=1, bvp_backward=1))):
        ds64, args64, _ = wave_subset(p, 1, torch.float64, "torch")
        res = solve_and_check(p.disort, ds64, (p.prop, p.bc), args64, want,
                              label, steps=3)
        del ds64, args64
        pr = p.disort._prepare(*p.args)
        md = p.disort._solve_mode(pr)
        near = resonance_margin(md) < RESONANCE_MARGIN
        recs = beam_records(label, res[0], pr, md, p.disort._ang0, near=near,
                            once=True)
        floor = ""
        if recs[0]["name"] == "stage1_isotropic_beam":
            k1_ptxas(recs[0], regs)
            floor = "; " + k1_floor_text(16, pr["L"], pr["B"], clock_mhz)
        N = md["sol"].gp.shape[0]
        recs[2]["ptxas"] = regs.get(f"bvp_backward_rows<{N}>")
        say("19", flux_line(label, res, card) + "; per kernel: "
                  + records_line(recs) + floor
                  + f"; {time.perf_counter() - t19:.1f} s into phase 19")
        kernels_json += recs
        del p, pr, md, recs
        torch.cuda.empty_cache()

    # K1 alone at the full widths of its configurations at nstr 32:
    # bench.py's 8 x 8192 x 100 (thermal) and sw_lbl's 500 x 512 x 40
    # (beam), gp and gm 6.7 and 10.5 GB each; bit-equal to the plain
    # version on every 10th wave (the columns are wave-major), which the
    # plain K2 does not reach
    full = []
    for label, make, beam in (
            ("bench 8x8192x100 nstr 32",
             lambda: bench_problem(8, 8192, 100, 32, torch.float32, dev,
                                   "cuda"), False),
            ("sw_lbl 500x512x40 nstr 32",
             lambda: extra_problem(500, 512, 40, 32, beam=True, device=dev,
                                   kernel="cuda"), True)):
        p = make()
        ds = p.disort
        pr = ds._prepare(*p.args)
        L, B = pr["L"], pr["B"]
        nw, ncol = ds.options.nwave, ds.options.ncol
        ins = [pr["ssa_s"], pr["dtau"], pr["b_top_lay"], pr["slope"]]
        if beam:
            ins += [pr["fbeam"], ds._beam_cosine(pr)]
        fn = K.stage1_isotropic_beam if beam else K.stage1_isotropic
        plain = (K.stage1_isotropic_beam_plain if beam
                 else K.stage1_isotropic_plain)
        K.reset_launches()
        got = fn(*ins, ds._ang0)
        torch.cuda.synchronize()
        launches = K.launch_counts()[fn.__name__]
        assert launches == 1, (label, K.launch_counts())
        waves = torch.arange(0, nw, 10, device=dev)

        def tenth(x):
            """x's every 10th wave on its last (column) axis"""
            lead = x.shape[:-1]
            return x.reshape(*lead, nw, ncol).index_select(
                -2, waves).reshape(*lead, -1).contiguous()

        sub = [tenth(x) for x in ins]
        stage1_exact([tenth(x) for x in got], plain(*sub, ds._ang0),
                     f"K1{' beam' if beam else ''} {label}, every 10th wave")
        del got
        torch.cuda.empty_cache()
        ms = cuda_ms(lambda: fn(*ins, ds._ang0), 3)
        name = fn.__name__
        nbytes = R.kernel_bytes(name, 16, L, B)
        bound_ms, bound_by = R.bound(nbytes, kernel_flops(name, 16, L, B))
        rec = dict(name=name, path=label, launches=launches, ms=ms,
                   bound_ms=bound_ms, bound_by=bound_by, elements=L * B,
                   checked_waves=len(waves))
        k1_ptxas(rec, regs)
        rec["floor"] = k1_floor_text(16, L, B, clock_mhz)
        full.append(rec)
        del p, ds, pr, ins, sub
        torch.cuda.empty_cache()
    say("19", "K1 alone at full width, bit-equal to its plain version on "
              "every 10th wave: " + "; ".join(
                  f"{r['name']} on {r['path']} ({r['elements']} elements, "
                  f"{r['checked_waves']} waves checked) {r['ms']:.3f} ms, "
                  f"bound {r['bound_ms']:.3f} ms by {r['bound_by']} "
                  f"({r['bound_ms'] / r['ms']:.1%}), ptxas {r['ptxas']}, "
                  f"{r['floor']}" for r in full)
              + f"; {time.perf_counter() - t19:.1f} s into phase 19 [{card}]")

    # the configuration of this slice: aerosol_16str_beam at nstr 32, full
    # width (gp, gm 2.6 GB each, P 5.2 GB); float64 on every 10th wave
    label = "aerosol_32str_beam 500x128x40 nstr 32, HG g 0.8"
    p = extra_problem(500, 128, 40, 32, g=0.8, device=dev, kernel="cuda")
    ds64, args64, sel = wave_subset(p, 10, torch.float64, "torch")
    res = solve_and_check(p.disort, ds64, (p.prop, p.bc), args64,
                          dict(stage1_general=1, bvp_forward=1,
                               bvp_backward=1), label, sel=sel, steps=3)
    del ds64, args64
    torch.cuda.empty_cache()
    pr = p.disort._prepare(*p.args)
    md = p.disort._solve_mode(pr)
    near = resonance_margin(md) < RESONANCE_MARGIN
    recs = beam_records(label, res[0], pr, md, p.disort._ang0, near=near,
                        once=True)
    recs[0]["ptxas"] = regs.get("stage1_general_wide<9..16>")
    recs[1]["ptxas"] = regs.get("bvp_forward_wide<9..16>")
    recs[2]["ptxas"] = regs.get("bvp_backward_rows<16>")
    # where K4's time goes: the same launch without the Jacobi sweeps (its
    # outputs are not used)
    ms_k4_0 = cuda_ms(lambda: K.stage1_general(
        pr["ssa_s"], pr["pmom_s"], pr["dtau"], pr["b_top_lay"], pr["slope"],
        p.disort._ang0, thermal=False, sweeps=0, fbeam=pr["fbeam"],
        mur=md["mur"], lam0=md["lam0"]), 3)
    say("19", flux_line(label, res, card).replace(
        "plain:", f"plain on every 10th wave ({len(sel)} waves x 128 "
                  "columns):", 1)
        + f"; peak device memory {torch.cuda.max_memory_allocated() / 2**30:.1f}"
        " GiB; per kernel: " + records_line(recs)
        + f"; K4 without its 8 Jacobi sweeps {ms_k4_0:.3f} ms; ptxas: "
        + "; ".join(f"{r['name']} {r['ptxas']}" for r in recs)
        + f"; {time.perf_counter() - t19:.1f} s into phase 19")
    kernels_json += recs
    n_elem = pr["ssa_s"].numel()
    ms_k4_sweeps = recs[0]["ms"] - ms_k4_0
    del p, pr, md, recs, near
    torch.cuda.empty_cache()
    # a yardstick for the Jacobi part of K4 only: torch.linalg.eigh
    # (cuSOLVER) on as many symmetric 16 x 16 matrices as the problem has
    # elements, drawn from a seed, timed once over all of them; cuSOLVER's
    # batched solver refused 32,768 matrices in one call (torch 2.11, CUDA
    # 12.8), so they go in batches of EIGH_BATCH.  The port never calls it
    gen = torch.Generator(device=dev).manual_seed(19)
    sym = torch.randn((n_elem, 16, 16), generator=gen, device=dev)
    sym = sym + sym.transpose(1, 2)
    torch.linalg.eigh(sym[:EIGH_BATCH])
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    lam_eigh = [torch.linalg.eigh(sym[i:i + EIGH_BATCH])[0]
                for i in range(0, n_elem, EIGH_BATCH)]
    stop.record()
    torch.cuda.synchronize()
    ms_eigh = start.elapsed_time(stop)
    assert all(bool(torch.isfinite(w).all()) for w in lam_eigh)
    say("19", f"Jacobi yardstick: torch.linalg.eigh on {n_elem} symmetric "
              f"16 x 16 float32 matrices, {EIGH_BATCH} a call, "
              f"{ms_eigh:.3f} ms, once; K4's 8 Jacobi sweeps on as many "
              f"elements {ms_k4_sweeps:.3f} ms (K4 less K4 without its "
              f"sweeps; not a library call of the port) [{card}]")
    del sym, lam_eigh
    torch.cuda.empty_cache()

    # the radiances at nstr 32: K4 once per mode (32), K2 and K5 twice;
    # float64 on every 4th wave, run once, with float32's resonance floor:
    # on the columns with every layer over RESONANCE_MARGIN from a
    # resonance the floor never acts, so that run is the float64 answer
    # there (the plain float64 path at nstr 32 takes minutes a run)
    shape = (32, 64, 40, 32)
    nm = shape[3] - 1
    p = radiance_problem(torch.float32, dev, "cuda", shape=shape)
    ds = p.disort
    K.reset_launches()
    out = ds.intensities(p.prop, p.bc)
    torch.cuda.synchronize()
    launches = K.launch_counts()
    expect_launches(launches, stage1_general=shape[3], bvp_forward=2,
                    bvp_backward=2)
    ds64, args64, sel = wave_subset(p, 4, torch.float64, "torch")
    with float32_resonance_floor():
        ref_f, margin, _ = radiance_reference(ds64, args64[:2])
    ncol = ds.options.ncol
    near = (margin < RESONANCE_MARGIN).reshape(len(sel), ncol)
    sub = {k: out[k].index_select(0, sel) for k in ("flux", "uu")}
    res19 = radiance_errors(sub, ref_f, ref_f, near)
    del ds64, args64, ref_f, sub
    torch.cuda.empty_cache()
    ms_step = cuda_ms(lambda: ds.intensities(p.prop, p.bc)["uu"], 2)
    pr = ds._prepare(p.prop, p.bc, None)
    modes = ds._modes_batched(pr)
    fgp, fgm, fexpd, dblk, alb = modes["fold"]
    L, B = pr["L"], pr["B"]
    N = shape[3] // 2
    path = "radiances 32x64x40 nstr 32"
    # K4 at every mode of the path, as the path launches it: m = 0 (the
    # problem has no thermal source), then m = 1..31 with the modes' zero
    # thermal inputs; every column, bit-equal (asserted)
    ang0 = ds._ang0
    k4, k4_plain, lam00 = radiance_k4(ds, pr, modes)
    nmom = pr["pmom_s"].shape[1]
    recs = [kernel_record(
        "stage1_general", path + f", modes 0..{nm}",
        launches["stage1_general"], k4, k4_plain, (), {}, stage1_exact,
        STAGE1_TOL,
        (nm + 1) * kernel_flops("stage1_general", N, L, B, nmom=nmom,
                                sweeps=K.kernel_sweeps(N), thermal=False,
                                beam=True),
        reads=[pr["ssa_s"], pr["pmom_s"], pr["dtau"], pr["fbeam"],
               modes["mur"]] * (nm + 1) + [lam00, modes["lam0"]],
        once=True)]
    recs[0].update(bit_equal=True,
                   ptxas=regs.get("stage1_general_wide<9..16>"))
    # the folded columns near a beam resonance, from the float32 modes
    near_fold = (modes_margin(modes) < RESONANCE_MARGIN).reshape(nm * B)
    recs.append(kernel_record(
        "bvp_forward", path + f", modes 1..{nm} folded",
        launches["bvp_forward"], K.bvp_forward, K.bvp_forward_plain,
        (fgp, fgm, fexpd, dblk, alb, ang0), {}, bvp_check, BVP_TOL,
        kernel_flops("bvp_forward", N, L, nm * B), near=near_fold, once=True))
    Pm, gm_ = K.bvp_forward(fgp, fgm, fexpd, dblk, alb, ang0)
    recs.append(kernel_record(
        "bvp_backward", path + f", modes 1..{nm} folded",
        launches["bvp_backward"], K.bvp_backward, K.bvp_backward_plain,
        (fgp, fgm, fexpd, Pm, gm_, ang0), {}, bvp_check, BVP_TOL,
        kernel_flops("bvp_backward", N, L, nm * B), near=near_fold,
        once=True))
    recs[-1]["ptxas"] = regs.get("bvp_backward_rows<16>")
    nrad = out["uu"].numel()
    n_near = int(near.sum())
    say("19", f"radiances {'x'.join(map(str, shape[:3]))} nstr 32: launches "
              f"{launches}; uu {tuple(out['uu'].shape)} finite; vs the "
              f"float64 plain path with float32's resonance floor on every "
              f"4th wave ({len(sel)} waves x {ncol} columns): " + "; ".join(
                  f"{k} {a:.2e} on the {near.numel() - n_near} columns away "
                  f"from a resonance (<= 1e-4{' of the column' if k == 'uu' else ''}), "
                  f"{f:.2e} on the {n_near} near ones (<= {NEAR_RESONANCE_TOL})"
                  for k, (a, f, _, _) in res19.items())
              + f"; step {ms_step:.3f} ms = {nrad / ms_step * 1e3:.0f} "
              f"radiances/s ({nrad}); per kernel (K4 over the {nm + 1} "
              "modes, bit-equal to its plain version on every column): "
              + records_line(recs) + f" [{card}]")
    kernels_json += recs
    del p, ds, out, pr, modes, fgp, fgm, fexpd, dblk, alb, Pm, gm_, recs
    torch.cuda.empty_cache()
    say("19", f"phase 19 took {time.perf_counter() - t19:.1f} s [{card}]")
    return kernels_json


# ---- K2 at N = 5..7 at full width (phase 20) --------------------------------

# the stream counts between the repo's configurations whose K2 bodies are
# N = 5, 6, 7
NSTR_MID = (10, 12, 14)


def phase20(dev, card: str, regs: dict) -> list:
    """Phase 20: aerosol_16str_beam's configuration at nstr 10, 12 and 14
    through ``Disort.forward`` under ``"auto"``; returns the entries of the
    ``kernels`` line."""
    import torch

    from pyharp_tpu_torch.bench.problems import extra_problem

    t20 = time.perf_counter()
    kernels_json = []
    for nstr in NSTR_MID:
        N = nstr // 2
        label = (f"aerosol_16str_beam's configuration 500x128x40 at nstr "
                 f"{nstr}, HG g 0.8")
        p = extra_problem(500, 128, 40, nstr, g=0.8, device=dev,
                          kernel="auto")
        p64 = extra_problem(500, 128, 40, nstr, g=0.8, dtype=torch.float64,
                            device=dev, kernel="torch")
        res = solve_and_check(p.disort, p64.disort, (p.prop, p.bc),
                              (p64.prop, p64.bc, None),
                              dict(stage1_general=1, bvp_forward=1,
                                   bvp_backward=1), label)
        del p64
        torch.cuda.empty_cache()
        ds = p.disort
        pr = ds._prepare(p.prop, p.bc, None)
        md = ds._solve_mode(pr)
        near = resonance_margin(md) < RESONANCE_MARGIN
        path = f"aerosol 500x128x40 nstr {nstr}"
        recs = beam_records(path, res[0], pr, md, ds._ang0, near=near)
        # K2's entry: the one body the library builds at this N (the
        # half-warp team where pyharp_bvp_forward takes it, else one
        # thread per column)
        k2 = [k for k in (f"bvp_forward_half<{N}>", f"bvp_forward<{N}>")
              if k in regs]
        assert len(k2) == 1, (N, k2)
        for rec, name in zip(recs, (f"stage1_general<{N}>", k2[0],
                                    f"bvp_backward<{N}>")):
            rec["ptxas"] = regs.get(name)
        say("20", flux_line(label, res, card) + "; per kernel, all columns: "
                  + records_line(recs) + f"; K2's body {k2[0]} [{card}]")
        kernels_json += recs
        del p, ds, pr, md, recs, near
        torch.cuda.empty_cache()
    say("20", f"phase 20 took {time.perf_counter() - t20:.1f} s [{card}]")
    return kernels_json


def stream_path(phase, t0, card, clock_mhz, ptxas, label, p, want, stride,
                tag, reference=None):
    """A solve through ``kernel="auto"`` against the float64 plain path on
    every ``stride``-th wave (``reference``, its :func:`flux_reference`,
    where computed earlier), its kernels against their plain versions on
    its own inputs (every column, the plain versions once), its peak device
    memory and step (phases 21, 22); returns the kernels' entries."""
    import torch

    torch.cuda.reset_peak_memory_stats()
    ds64, args64, sel = wave_subset(p, stride, torch.float64, "torch")
    res = solve_and_check(p.disort, ds64, (p.prop, p.bc, p.temf), args64,
                          want, label, sel=sel if stride > 1 else None,
                          steps=3, reference=reference)
    del ds64, args64
    torch.cuda.empty_cache()
    pr = p.disort._prepare(p.prop, p.bc, p.temf)
    md = p.disort._solve_mode(pr)
    if "mur" in md:
        near = resonance_margin(md) < RESONANCE_MARGIN
        recs = beam_records(tag, res[0], pr, md, p.disort._ang0,
                            near=near, once=True)
    else:
        recs = thermal_records(tag, res[0], pr, md, p.disort._ang0,
                               once=True)
    floor = ""
    if recs[0]["name"].startswith("stage1_isotropic"):
        floor = "; " + k1_floor_text(md["sol"].gp.shape[0], pr["L"],
                                     pr["B"], clock_mhz)
    peak = torch.cuda.max_memory_allocated() / 2**30
    line = flux_line(label, res, card)
    if stride > 1:
        line = line.replace("plain:", f"plain on every {stride}th wave "
                            f"({len(sel)} waves):", 1)
    say(phase, line + f"; peak device memory {peak:.1f} GiB; step "
               f"{res[5]:.3f} ms; per kernel: " + records_line(ptxas(recs))
               + floor + f"; {time.perf_counter() - t0:.1f} s into "
               f"phase {phase}")
    for r in recs:
        r["peak_gib"] = peak
    del pr, md
    torch.cuda.empty_cache()
    return recs


def radiance_path(phase, dev, card, shape, ptxas, reference=None,
                  k4_modes=None) -> list:
    """The radiances of ``radiance_problem`` at ``shape`` (nwave, ncol,
    nlyr, nstr) through ``kernel="auto"``: K4 twice at N > 32 (m = 0, then
    the modes m >= 1 in one launch; phases 22, 23) and nstr times below
    (phase 21), K2 and K5 twice; float64 on every 10th wave with float32's
    resonance floor (on the columns with every layer over RESONANCE_MARGIN
    from a resonance the floor never acts, so there that run is the float64
    answer; ``reference``, :func:`radiance_reference`'s first two outputs
    under that floor, where computed earlier); each kernel against its
    plain version on the path's inputs, K4 bit-equal at every mode (at
    m = 0 and the modes ``k4_modes`` where given; every mode launched and
    timed).  The step is timed after the counted call, which also builds
    and uploads every mode's tables (printed as the first call).  Returns
    the kernels' entries."""
    import torch

    from pyharp_tpu_torch.bench.problems import radiance_problem
    from pyharp_tpu_torch.bench.roofline_run import kernel_flops
    from pyharp_tpu_torch.rt.disort import kernels as K

    nstr = shape[3]
    torch.cuda.reset_peak_memory_stats()
    p = radiance_problem(torch.float32, dev, "auto", shape=shape)
    ds = p.disort
    K.reset_launches()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    out = ds.intensities(p.prop, p.bc)
    stop.record()
    torch.cuda.synchronize()
    launches = K.launch_counts()
    # K4 at m = 0, then the modes: one launch at N > 32, one a mode below
    expect_launches(launches, stage1_general=(
        2 if nstr // 2 > K.BIG_MAX_N else nstr), bvp_forward=2,
                    bvp_backward=2)
    ds64, args64, sel = wave_subset(p, 10, torch.float64, "torch")
    if reference is None:
        with float32_resonance_floor():
            reference = radiance_reference(ds64, args64[:2])[:2]
    ref_f, margin = reference
    ncol = ds.options.ncol
    near = (margin < RESONANCE_MARGIN).reshape(len(sel), ncol)
    sub = {k: out[k].index_select(0, sel) for k in ("flux", "uu")}
    res = radiance_errors(sub, ref_f, ref_f, near)
    del ds64, args64, ref_f, sub
    torch.cuda.empty_cache()
    ms_first = start.elapsed_time(stop)
    ms_step = cuda_ms(lambda: ds.intensities(p.prop, p.bc)["uu"], 2)
    pr = ds._prepare(p.prop, p.bc, None)
    modes = ds._modes_batched(pr)
    fgp, fgm, fexpd, dblk, alb = modes["fold"]
    L, B, N, nm = pr["L"], pr["B"], modes["N"], len(modes["ms"])
    tag = f"radiances {'x'.join(map(str, shape[:3]))} nstr {nstr}"
    ang0 = ds._ang0
    k4_kernel, k4_plain, lam00 = radiance_k4(ds, pr, modes, k4_modes)
    # K4's time and its bound cover every mode
    timed = nm + 1
    nmom = pr["pmom_s"].shape[1]
    held = ("" if k4_modes is None else
            " (held at m = " + ", ".join(map(str, (0, *sorted(k4_modes))))
            + ")")
    recs = [kernel_record(
        "stage1_general", tag + f", modes 0..{nm}" + held,
        launches["stage1_general"],
        k4_kernel, k4_plain, (), {}, stage1_exact, STAGE1_TOL,
        timed * kernel_flops("stage1_general", N, L, B, nmom=nmom,
                             sweeps=K.kernel_sweeps(N), thermal=False,
                             beam=True),
        reads=[pr["ssa_s"], pr["pmom_s"], pr["dtau"], pr["fbeam"],
               modes["mur"]] * timed + [lam00, modes["lam0"]], once=True)]
    recs[0]["bit_equal"] = True
    if k4_modes is not None:           # its plain_ms times those modes
        recs[0]["plain_modes"] = len(k4_modes) + 1
    near_fold = (modes_margin(modes) < RESONANCE_MARGIN).reshape(nm * B)
    recs.append(kernel_record(
        "bvp_forward", tag + f", modes 1..{nm} folded",
        launches["bvp_forward"], K.bvp_forward, K.bvp_forward_plain,
        (fgp, fgm, fexpd, dblk, alb, ang0), {}, bvp_check, BVP_TOL,
        kernel_flops("bvp_forward", N, L, nm * B), near=near_fold, once=True))
    Pm, gm_ = K.bvp_forward(fgp, fgm, fexpd, dblk, alb, ang0)
    recs.append(kernel_record(
        "bvp_backward", tag + f", modes 1..{nm} folded",
        launches["bvp_backward"], K.bvp_backward, K.bvp_backward_plain,
        (fgp, fgm, fexpd, Pm, gm_, ang0), {}, bvp_check, BVP_TOL,
        kernel_flops("bvp_backward", N, L, nm * B), near=near_fold,
        once=True))
    peak = torch.cuda.max_memory_allocated() / 2**30
    nrad = out["uu"].numel()
    n_near = int(near.sum())
    say(phase, f"radiances {'x'.join(map(str, shape[:3]))} nstr {nstr}: "
               f"launches {launches}; uu {tuple(out['uu'].shape)} finite; vs "
               f"the float64 plain path with float32's resonance floor on "
               f"every 10th wave ({len(sel)} waves x {ncol} columns): "
               + "; ".join(
                   f"{k} {a:.2e} on the {near.numel() - n_near} columns away "
                   f"from a resonance (<= 1e-4{' of the column' if k == 'uu' else ''}), "
                   f"{f:.2e} on the {n_near} near ones (<= {NEAR_RESONANCE_TOL})"
                   for k, (a, f, _, _) in res.items())
               + f"; peak device memory {peak:.1f} GiB; step {ms_step:.3f} ms "
               f"= {nrad / ms_step * 1e3:.0f} radiances/s ({nrad}; the first "
               f"call, the tables built, {ms_first:.3f} ms); per "
               f"kernel (K4 over the {nm + 1} modes, bit-equal to its plain "
               f"version on every column{held}): " + records_line(ptxas(recs))
               + f" [{card}]")
    for r in recs:
        r["peak_gib"] = peak
    del p, ds, out, pr, modes, fgp, fgm, fexpd, dblk, alb, Pm, gm_
    torch.cuda.empty_cache()
    return recs


def folded_check(ssa, pmom, dtau, fbeam, mur, modes: dict, what: str):
    """K4's launch over several modes (``kernels.stage1_general_modes``, a
    beam and no thermal source) against the plain version of each:
    ``modes`` maps m to ``(angles, lam0, plain outputs)``; every mode's
    outputs bit-equal (asserted)."""
    from pyharp_tpu_torch.rt.disort import kernels as K

    ms = sorted(modes)
    got = K.stage1_general_modes(ssa, pmom, dtau, [modes[m][0] for m in ms],
                                 fbeam=fbeam, mur=mur,
                                 lam0s=[modes[m][1] for m in ms])
    for i, m in enumerate(ms):
        want = modes[m][2]
        stage1_exact([x[..., i, :] for x in got],
                     [want[j] for j in (0, 1, 2, 3, 7, 8)],
                     f"K4's modes launch {what} m {m}")


# ---- 34 to 64 streams (phase 21) --------------------------------------------

# the stream counts phase 21 holds the bodies of N = 17..32 at, each to its
# plain version: N = 17, 20, 24, 25, 32 (odd and even, the ends)
NSTR_BIG = (34, 40, 48, 50, 64)
# (L, B) of those checks: no multiple of K1's 4 or K4's 2 elements a block,
# and B no multiple of K2's 2 columns a block or K5's tile of 32
BIG_CHECK_SHAPE = (7, 1017)
# the full-width aerosol paths, (nstr, waves): aerosol_16str_beam's 500
# waves cut to what the card's memory holds beside the plain versions that
# check every column
AEROSOL_BIG = ((64, 100), (48, 200))
# the radiances at nstr 64 (waves, columns, layers, nstr)
RADIANCE_BIG = (8, 64, 20, 64)


def big_paths(dev):
    """Phase 21's solves: ``(key, problem, launches, stride, tag, label)``
    each, the problem built from its seed: aerosol_16str_beam's
    configuration at nstr 64 and 48 (HG g 0.8, a beam, 128 columns, 40
    layers), its 500 waves cut to the first ones (``AEROSOL_BIG``); the
    isotropic thermal and beam solves at nstr 64 (phase 19's shapes)."""
    import torch

    from pyharp_tpu_torch.bench.problems import bench_problem, extra_problem

    for nstr, nw in AEROSOL_BIG:
        yield (f"aerosol{nstr}",
               extra_problem(500, 128, 40, nstr, g=0.8, device=dev,
                             kernel="auto", first=nw),
               dict(stage1_general=1, bvp_forward=1, bvp_backward=1), 10,
               f"aerosol {nw}x128x40 nstr {nstr}",
               f"aerosol_16str_beam's configuration {nw}x128x40 (the first "
               f"{nw} of its 500 waves) at nstr {nstr}, HG g 0.8")
    yield ("thermal", bench_problem(8, 2048, 20, 64, torch.float32, dev,
                                    "auto"),
           dict(stage1_isotropic=1, bvp_forward=1, bvp_backward=1), 1,
           "bench 8x2048x20 nstr 64", "isotropic thermal 8x2048x20 nstr 64")
    yield ("beam", extra_problem(500, 64, 20, 64, beam=True, device=dev,
                                 kernel="auto"),
           dict(stage1_isotropic_beam=1, bvp_forward=1, bvp_backward=1), 10,
           "isotropic beam 500x64x20 nstr 64",
           "isotropic beam 500x64x20 nstr 64")


def path_references(dev, paths, radiance_shape) -> dict:
    """The float64 references of a phase's solves, computed before the
    kernels are built (``main`` runs them while ``nvcc`` compiles): each
    of ``paths(dev)``'s :func:`flux_reference` on its checked waves, and
    the radiances of ``radiance_shape``'s problem on every 10th wave under
    float32's resonance floor (:func:`radiance_reference`'s first two
    outputs), with the seconds they took."""
    import torch

    from pyharp_tpu_torch.bench.problems import radiance_problem

    t0 = time.perf_counter()
    refs = {}
    for key, p, _, stride, _, _ in paths(dev):
        ds64, args64, _ = wave_subset(p, stride, torch.float64, "torch")
        refs[key] = flux_reference(ds64, args64)
        del p, ds64, args64
    p = radiance_problem(torch.float32, dev, "auto", shape=radiance_shape)
    ds64, args64, _ = wave_subset(p, 10, torch.float64, "torch")
    with float32_resonance_floor():
        refs["radiances"] = radiance_reference(ds64, args64[:2])[:2]
    del p, ds64, args64
    torch.cuda.empty_cache()
    refs["seconds"] = time.perf_counter() - t0
    return refs


def phase21(dev, card: str, regs: dict, refs: dict | None = None) -> list:
    """Phase 21, 34 to 64 streams: the route, every body of N = 17..32
    against its plain version at ``NSTR_BIG``, then the four full-width
    paths of this range through ``kernel="auto"``; returns the entries of
    the ``kernels`` line.  ``refs``: the paths' float64 references
    (:func:`path_references` of :func:`big_paths`), computed earlier
    (else in each path)."""
    import torch

    from pyharp_tpu_torch.bench.problems import extra_problem, stage1_inputs
    from pyharp_tpu_torch.rt.disort import kernels as K
    from pyharp_tpu_torch.rt.disort.legendre import lepoly
    from pyharp_tpu_torch.rt.disort.solver import make_static_angles

    t21 = time.perf_counter()
    kernels_json = []
    clock_mhz = float(run(["nvidia-smi", "--query-gpu=clocks.max.sm",
                           "--format=csv,noheader,nounits"]).splitlines()[0])
    big = {n: regs.get(n.replace("_beam", "") + "_big"
                       + ("_beam" if n.endswith("_beam") else "")
                       + "<17..32>")
           for n in ("stage1_isotropic", "stage1_isotropic_beam",
                     "stage1_general", "bvp_backward")}
    big["bvp_forward"] = "; ".join(
        f"N = {span}: {regs.get(f'bvp_forward_big<{span}>')}"
        for span in ("17..24", "25..32"))

    def ptxas(recs):
        for r in recs:
            r["ptxas"] = big[r["name"]]
        return recs

    # the route: every nstr 2..64 in float32 on the card to the kernels
    # (phase 22 holds nstr 66..128 and the refusal past them)
    assert all(K.route("auto", "cuda", torch.float32, n) == "cuda"
               for n in range(1, 33))
    say("21", "route: float32 CUDA tensors at nstr 2..64 -> 'cuda'")
    bad = K.root_check()
    assert bad == 0, (f"K4's square root at N = 17..32 differs from sqrtf on "
                      f"{bad} float32 values in [1, 2^60]")
    say("21", "K4's square root without a range check equals sqrtf on every "
              "float32 in [1, 2^60], the range of 1 + tau^2 its rotations "
              f"keep to [{card}]")

    # each body against its plain version: K1 (thermal, beam) and K4
    # (thermal x beam at m = 0, m = 1 with a beam, at nstr 64 also m = 31
    # and 63) bit-equal on BIG_CHECK_SHAPE's elements, K2 and K5 on its B
    # columns x 8 layers
    msgs = []
    L, B = BIG_CHECK_SHAPE
    for nstr in NSTR_BIG:
        N = nstr // 2
        ang = make_static_angles(nstr, nstr, 0)
        rng = np.random.default_rng(900 + nstr)
        ssa, dtau, btop, slope = stage1_inputs(L, B, seed=910 + nstr,
                                               device=dev)
        fbeam = torch.tensor(rng.uniform(0.5, 4.0, B), dtype=torch.float32,
                             device=dev)
        mu0 = torch.tensor(rng.uniform(0.1, 1.0, B), dtype=torch.float32,
                           device=dev)
        mur = mu0[None].expand(L, B).contiguous()
        stage1_exact(K.stage1_isotropic(ssa, dtau, btop, slope, ang),
                     K.stage1_isotropic_plain(ssa, dtau, btop, slope, ang),
                     f"K1 nstr {nstr}")
        s1b = (ssa, dtau, btop, slope, fbeam, mur, ang)
        stage1_exact(K.stage1_isotropic_beam(*s1b),
                     K.stage1_isotropic_beam_plain(*s1b), f"K1 beam nstr {nstr}")
        pm = torch.tensor(
            np.stack([hg_moments(0.2 if b % 2 else 0.8, nstr)
                      for b in range(B)], axis=-1)[None].repeat(L, axis=0),
            dtype=torch.float32, device=dev)
        modes = (0, 1) + ((N - 1, nstr - 1) if nstr == NSTR_BIG[-1] else ())
        for m in modes:
            angm = make_static_angles(nstr, nstr, m)
            lam0 = lepoly(mu0, m, angm.lam_tables.shape[0] - 1).contiguous()
            for thermal in ((True, False) if m == 0 else (False,)):
                kw = dict(thermal=thermal, fbeam=fbeam, mur=mur, lam0=lam0)
                a4 = (ssa, pm, dtau, btop, slope, angm)
                stage1_exact(K.stage1_general(*a4, **kw),
                             K.stage1_general_plain(*a4, **kw),
                             f"K4 nstr {nstr} m {m} thermal {thermal}")
        p = extra_problem(3, B // 3, 8, nstr, g=0.8, device=dev,
                          kernel="torch", seed=nstr)
        ds = p.disort
        pr = ds._prepare(p.prop, p.bc, None)
        md = ds._solve_mode(pr)
        s5, a0 = md["sol"], ds._ang0
        e2 = bvp_check(K.bvp_forward(s5.gp, s5.gm, s5.expd, md["dblk"],
                                     pr["albedo"], a0), (md["P"], md["g"]),
                       f"K2 nstr {nstr}")
        bwd = (s5.gp, s5.gm, s5.expd, md["P"], md["g"], a0)
        e5 = bvp_check(K.bvp_backward(*bwd), K.bvp_backward_plain(*bwd),
                       f"K5 nstr {nstr}")
        msgs.append(f"nstr {nstr}: K1, K1 beam bit-equal; K4 (m "
                    + ", ".join(map(str, modes)) + f") bit-equal; K2 "
                    f"{e2:.2e}, K5 {e5:.2e}")
        del p, ds, pr, md, s5, bwd, pm
    torch.cuda.empty_cache()
    say("21", f"at L {L} x B {B} (stage 1) and {B} columns x 8 layers "
              "(BVP): " + "; ".join(msgs) + f" ({STAGE1_TOL}, asserted "
              f"bit-equal; {BVP_TOL}); {time.perf_counter() - t21:.1f} s "
              f"into phase 21 [{card}]")

    def path(label, p, want, stride, tag, reference):
        return stream_path("21", t21, card, clock_mhz, ptxas, label, p, want,
                           stride, tag, reference)

    for key, p, want, stride, tag, label in big_paths(dev):
        kernels_json += path(label, p, want, stride, tag,
                             None if refs is None else refs[key])
        del p
    torch.cuda.empty_cache()

    # the radiances at nstr 64: K4 once per mode (64), K2 and K5 twice
    kernels_json += radiance_path("21", dev, card, RADIANCE_BIG, ptxas,
                                  None if refs is None else refs["radiances"])
    say("21", f"phase 21 took {time.perf_counter() - t21:.1f} s [{card}]")
    return kernels_json


# ---- 66 to 128 streams (phase 22) -------------------------------------------

# the stream counts phase 22 holds the bodies of N = 33..64 at, each to its
# plain version: N = 33, 41, 48, 64 (odd and even, the ends)
NSTR_HUGE = (66, 82, 96, 128)
# (L, B) of those checks: L B no multiple of K1's 8 (thermal) or 6 (beam)
# or K4's 2 elements a block, B no multiple of K5's tile of 32; K2 and K5
# on its B columns x L layers
HUGE_CHECK_SHAPE = (3, 99)
# the paths at nstr 128 through kernel="auto", each cut to phase 22's
# time (the plain versions that check every column take 5-60 s a call
# there, by their launches more than their widths): aerosol_16str_beam's
# configuration, the first 10 of its 500 waves (128 columns, 40 layers);
# the isotropic thermal solve (waves, columns, layers) and the isotropic
# beam solve (its first 25 of 500 waves, 63 columns, 21 layers), each
# with an odd L B, so that they hold K1 and K1 beam at nstr 128 as the
# check shape does at the smaller nstr; the radiances (waves, columns,
# layers, nstr), K4 held at m = 0 and RADIANCE_HUGE_MODES (every mode
# timed)
AEROSOL_HUGE = (128, 10)
THERMAL_HUGE = (7, 255, 21)
BEAM_HUGE = (25, 63, 21)
RADIANCE_HUGE = (1, 16, 8, 128)
RADIANCE_HUGE_MODES = (1, 2, 63, 64, 126, 127)


def jacobi_offdiag(ssa, pmom, ang, sweeps: int) -> float:
    """The off-diagonal that K4's ``sweeps`` Jacobi sweeps leave: the
    symmetric matrix K = Lc^T Vhat Lc of each element formed and swept by
    the plain float32 operations (``solver._homogeneous_core``, bit-equal
    to K4), then max |(Y^T K Y)_ij|, i != j, over max |lam^2|, in float64,
    the largest over the elements."""
    import torch

    from pyharp_tpu_torch.rt.disort import solver as S
    from pyharp_tpu_torch.rt.disort.jacobi import jacobi_eigh
    from pyharp_tpu_torch.rt.disort.linsolve import cholesky_lower

    Se, So = S._parity_operators(ssa, pmom, ang)
    mu, w = S._const(ang.mu, ssa), S._const(ang.w, ssa)
    N = mu.shape[0]
    sqw, sqm, eye = torch.sqrt(w), torch.sqrt(mu), S._eye(N, ssa)

    def hat(M):
        core = eye - ssa[None, None] * (sqw[:, None, None, None] * M
                                         * sqw[None, :, None, None])
        return core / (sqm[:, None, None, None] * sqm[None, :, None, None])

    Lc = cholesky_lower(hat(Se), floor=1e-12)
    Km = S._umm(Lc.transpose(0, 1), S._mm(hat(So), Lc))
    lam2, Y = jacobi_eigh(Km, sweeps)
    Kd, Yd = Km.double(), Y.double()
    R = torch.einsum("ki...,kl...,lj...->ij...", Yd, Kd, Yd)
    off = R - torch.diag_embed(torch.diagonal(R, dim1=0, dim2=1)).movedim(
        (-2, -1), (0, 1))
    return float((off.abs().amax(dim=(0, 1))
                  / lam2.double().abs().amax(dim=0)).max())


def huge_paths(dev):
    """Phase 22's solves at nstr 128: ``(key, problem, launches, stride,
    tag, label)`` each, the problem built from its seed."""
    import torch

    from pyharp_tpu_torch.bench.problems import bench_problem, extra_problem

    nstr, nw = AEROSOL_HUGE
    yield ("aerosol",
           extra_problem(500, 128, 40, nstr, g=0.8, device=dev,
                         kernel="auto", first=nw),
           dict(stage1_general=1, bvp_forward=1, bvp_backward=1), 5,
           f"aerosol {nw}x128x40 nstr {nstr}",
           f"aerosol_16str_beam's configuration {nw}x128x40 (the first {nw} "
           f"of its 500 waves) at nstr {nstr}, HG g 0.8")
    nwave, ncol, nlyr = THERMAL_HUGE
    shape = f"{nwave}x{ncol}x{nlyr}"
    yield ("thermal",
           bench_problem(nwave, ncol, nlyr, 128, torch.float32, dev, "auto"),
           dict(stage1_isotropic=1, bvp_forward=1, bvp_backward=1), 1,
           f"bench {shape} nstr 128", f"isotropic thermal {shape} nstr 128")
    nwave, ncol, nlyr = BEAM_HUGE
    shape = f"{nwave}x{ncol}x{nlyr}"
    yield ("beam",
           extra_problem(500, ncol, nlyr, 128, beam=True, device=dev,
                         kernel="auto", first=nwave),
           dict(stage1_isotropic_beam=1, bvp_forward=1, bvp_backward=1), 5,
           f"isotropic beam {shape} nstr 128",
           f"isotropic beam {shape} (the first {nwave} of 500 waves) "
           "nstr 128")


def phase22_references(dev) -> dict:
    """What phase 22 needs of the plain versions alone, computed before the
    kernels are built: :func:`path_references` of :func:`huge_paths` and
    ``RADIANCE_HUGE``, and the off-diagonal K4's sweeps leave at N = 64
    (:func:`jacobi_offdiag`, on the first 2 layers x 128 columns of the
    aerosol path)."""
    from pyharp_tpu_torch.rt.disort import kernels as K

    t0 = time.perf_counter()
    refs = path_references(dev, huge_paths, RADIANCE_HUGE)
    p = next(huge_paths(dev))[1]
    pr = p.disort._prepare(p.prop, p.bc, p.temf)
    sweeps = K.kernel_sweeps(p.disort._ang0.mu.shape[0])
    refs["offdiag"] = (sweeps, jacobi_offdiag(
        pr["ssa_s"][:2], pr["pmom_s"][:2], p.disort._ang0, sweeps))
    del p, pr
    refs["seconds"] = time.perf_counter() - t0
    return refs


def phase22(dev, card: str, regs: dict, refs: dict | None = None) -> list:
    """Phase 22, 66 to 128 streams: the route, every body of N = 33..64
    against its plain version at ``NSTR_HUGE``, K4's off-diagonal after its
    sweeps at N = 64, then the four paths at nstr 128 through
    ``kernel="auto"``; returns the entries of the ``kernels`` line.
    ``refs``: :func:`phase22_references`, computed earlier (else here)."""
    import torch

    from pyharp_tpu_torch.bench.problems import stage1_inputs
    from pyharp_tpu_torch.rt.disort import kernels as K
    from pyharp_tpu_torch.rt.disort.legendre import lepoly
    from pyharp_tpu_torch.rt.disort.solver import make_static_angles

    t22 = time.perf_counter()
    kernels_json = []
    clock_mhz = float(run(["nvidia-smi", "--query-gpu=clocks.max.sm",
                           "--format=csv,noheader,nounits"]).splitlines()[0])
    lib = K.build().lib
    # elements (K1, K4), columns (K2, K5) an SM by the occupancy calculator
    per_sm = {"stage1_isotropic": lib.pyharp_stage1_isotropic_huge_occupancy(0),
              "stage1_isotropic_beam":
                  lib.pyharp_stage1_isotropic_huge_occupancy(1),
              "stage1_general": lib.pyharp_stage1_general_huge_occupancy(64),
              "bvp_forward": lib.pyharp_bvp_forward_huge_occupancy(64),
              "bvp_backward": lib.pyharp_bvp_backward_huge_occupancy()}
    unit = {"bvp_forward": "columns", "bvp_backward": "columns"}
    huge = {n: f"{regs.get(HUGE_PTXAS[n])}, {per_sm[n]} "
               f"{unit.get(n, 'elements')} an SM at N = 64"
            for n in HUGE_PTXAS}
    huge["bvp_forward"] += (f", {lib.pyharp_bvp_forward_huge_smem(64)} B "
                            "of shared memory a block (no cluster)")
    say("22", "the bodies of N = 33..64: " + "; ".join(
        f"{n} {v}" for n, v in huge.items()) + f" [{card}]")

    def ptxas(recs):
        for r in recs:
            r["ptxas"] = huge[r["name"]]
        return recs

    # the route: every nstr 2..128 in float32 on the card to the kernels
    # (and above, phase 23)
    assert all(K.route("auto", "cuda", torch.float32, n) == "cuda"
               for n in range(1, 65))
    say("22", "route: float32 CUDA tensors at nstr 2..128 -> 'cuda'")

    # each body against its plain version on HUGE_CHECK_SHAPE's elements:
    # K1 beam, and K1 against the beam variant's plain eigenstructure (the
    # same function), bit-equal (at nstr 128 on the isotropic paths below,
    # whose L B is as odd); K4 (m = 0 with a thermal source and a beam, m =
    # 1 with a beam, at nstr 128 also m = 63) bit-equal; K2 and K5 on its
    # B columns x L layers, on K4's m = 0 eigenstructure with a drawn
    # right-hand side and albedo
    msgs = []
    L, B = HUGE_CHECK_SHAPE
    for nstr in NSTR_HUGE:
        N = nstr // 2
        ang = make_static_angles(nstr, nstr, 0)
        rng = np.random.default_rng(1900 + nstr)
        ssa, dtau, btop, slope = stage1_inputs(L, B, seed=1910 + nstr,
                                               device=dev)
        fbeam = torch.tensor(rng.uniform(0.5, 4.0, B), dtype=torch.float32,
                             device=dev)
        mu0 = torch.tensor(rng.uniform(0.1, 1.0, B), dtype=torch.float32,
                           device=dev)
        mur = mu0[None].expand(L, B).contiguous()
        k1 = "K1, K1 beam on the isotropic paths"
        if nstr != NSTR_HUGE[-1]:
            s1b = (ssa, dtau, btop, slope, fbeam, mur, ang)
            want = K.stage1_isotropic_beam_plain(*s1b)
            stage1_exact(K.stage1_isotropic_beam(*s1b), want,
                         f"K1 beam nstr {nstr}")
            stage1_exact(K.stage1_isotropic(ssa, dtau, btop, slope, ang),
                         want[:7], f"K1 nstr {nstr}")
            k1 = "K1, K1 beam bit-equal"
            del want
        pm = torch.tensor(
            np.stack([hg_moments(0.2 if b % 2 else 0.8, nstr)
                      for b in range(B)], axis=-1)[None].repeat(L, axis=0),
            dtype=torch.float32, device=dev)
        modes = (0, 1) + ((N - 1,) if nstr == NSTR_HUGE[-1] else ())
        folded = {}
        for m in modes:
            angm = make_static_angles(nstr, nstr, m)
            lam0 = lepoly(mu0, m, angm.lam_tables.shape[0] - 1).contiguous()
            kw = dict(thermal=m == 0, fbeam=fbeam, mur=mur, lam0=lam0)
            a4 = (ssa, pm, dtau, btop, slope, angm)
            want = K.stage1_general_plain(*a4, **kw)
            stage1_exact(K.stage1_general(*a4, **kw), want,
                         f"K4 nstr {nstr} m {m} thermal {m == 0}")
            if m == 0:
                gp, gm, _, expd = want[:4]
            else:
                folded[m] = (angm, lam0, want)
            del want
        folded_check(ssa, pm, dtau, fbeam, mur, folded, f"nstr {nstr}")
        dblk = torch.tensor(rng.uniform(-1.0, 1.0, (2 * N, L, B)),
                            dtype=torch.float32, device=dev)
        alb = torch.tensor(rng.uniform(0.0, 0.6, B), dtype=torch.float32,
                           device=dev)
        P, g = K.bvp_forward_plain(gp, gm, expd, dblk, alb, ang)
        e2 = bvp_check(K.bvp_forward(gp, gm, expd, dblk, alb, ang), (P, g),
                       f"K2 nstr {nstr}")
        bwd = (gp, gm, expd, P, g, ang)
        e5 = bvp_check(K.bvp_backward(*bwd), K.bvp_backward_plain(*bwd),
                       f"K5 nstr {nstr}")
        msgs.append(f"nstr {nstr}: {k1}; K4 (m "
                    + ", ".join(map(str, modes)) + ", and m "
                    + ", ".join(map(str, modes[1:])) + " in one launch) "
                    f"bit-equal; K2 "
                    f"{e2:.2e}, K5 {e5:.2e}")
        del pm, gp, gm, expd, dblk, P, g, bwd
    torch.cuda.empty_cache()
    say("22", f"at L {L} x B {B} (stage 1) and {B} columns x {L} layers "
              "(BVP): " + "; ".join(msgs) + f" ({STAGE1_TOL}, asserted "
              f"bit-equal; {BVP_TOL}); {time.perf_counter() - t22:.1f} s "
              f"into phase 22 [{card}]")

    if refs is None:
        refs = phase22_references(dev)
        say("22", f"the float64 references took {refs['seconds']:.1f} s")
    sweeps, off = refs["offdiag"]
    say("22", f"K4's Jacobi at N = 64 (nstr 128) on 256 elements of the "
              "aerosol path (2 layers x 128 columns), float32 by the plain "
              f"operations: max |off-diagonal of Y^T K Y| / max |lam^2| "
              f"{off:.2e} after its {sweeps} sweeps")
    for key, p, want, stride, tag, label in huge_paths(dev):
        kernels_json += stream_path("22", t22, card, clock_mhz, ptxas, label,
                                    p, want, stride, tag, refs[key])
        del p
    torch.cuda.empty_cache()
    kernels_json += radiance_path("22", dev, card, RADIANCE_HUGE, ptxas,
                                  refs["radiances"], RADIANCE_HUGE_MODES)
    say("22", f"phase 22 took {time.perf_counter() - t22:.1f} s [{card}]")
    return kernels_json


# ---- beyond 128 streams (phase 23) -----------------------------------------

# the stream counts phase 23 holds the bodies of N > 64 at, each to its
# plain version: N = 65, 100, 128, 129, whose N (and 2N) rows fill 3, 4,
# 4 and 5 sets of 32 (the last partial, partial, full and partial)
NSTR_GLOBAL = (130, 200, 256, 258)
# (L, B) of those checks: L B = 111, no multiple of K1's 8 or K4's 2
# elements a block, B no multiple of K5's tile of 32; K2 and K5 on its B
# columns x L layers
GLOBAL_CHECK_SHAPE = (3, 37)
# the stream counts whose route phase 23 asserts
NSTR_ROUTE = (130, 256, 1000)
# the paths at nstr 256 through kernel="auto", cut for time as phase 22's
# (the plain versions that check every column are launch-bound: at
# N = 128 the plain K4's Jacobi alone is 2.3e6 tensor operations a call):
# aerosol_16str_beam's configuration, the first AEROSOL_GLOBAL[1] of its
# 500 waves and its first AEROSOL_GLOBAL[2] of 40 layers (128 columns; a
# float64 pass over 40 layers takes ~50 s there, and most columns lie near
# a resonance, which takes a second); the isotropic thermal solve (waves,
# columns, layers) and the isotropic beam solve (its first waves of 500,
# columns, layers), each with an odd L B; the radiances (waves, columns,
# layers, nstr), K4 held at m = 0 and RADIANCE_GLOBAL_MODES (every mode
# timed)
AEROSOL_GLOBAL = (256, 1, 10)
THERMAL_GLOBAL = (1, 63, 11)
BEAM_GLOBAL = (3, 21, 11)
RADIANCE_GLOBAL = (1, 4, 4, 256)
RADIANCE_GLOBAL_MODES = (1, 2, 127, 128, 254, 255)


def global_paths(dev):
    """Phase 23's solves at nstr 256: ``(key, problem, launches, stride,
    tag, label)`` each, the problem built from its seed."""
    import torch

    from pyharp_tpu_torch.bench.problems import bench_problem, extra_problem

    nstr, nw, nl = AEROSOL_GLOBAL
    yield ("aerosol",
           extra_problem(500, 128, nl, nstr, g=0.8, device=dev,
                         kernel="auto", first=nw),
           dict(stage1_general=1, bvp_forward=1, bvp_backward=1), 1,
           f"aerosol {nw}x128x{nl} nstr {nstr}",
           f"aerosol_16str_beam's configuration {nw}x128x{nl} (the first "
           f"{nw} of its 500 waves, {nl} of its 40 layers) at nstr {nstr}, "
           "HG g 0.8")
    nwave, ncol, nlyr = THERMAL_GLOBAL
    shape = f"{nwave}x{ncol}x{nlyr}"
    yield ("thermal",
           bench_problem(nwave, ncol, nlyr, nstr, torch.float32, dev, "auto"),
           dict(stage1_isotropic=1, bvp_forward=1, bvp_backward=1), 1,
           f"bench {shape} nstr {nstr}", f"isotropic thermal {shape} nstr {nstr}")
    nwave, ncol, nlyr = BEAM_GLOBAL
    shape = f"{nwave}x{ncol}x{nlyr}"
    yield ("beam",
           extra_problem(500, ncol, nlyr, nstr, beam=True, device=dev,
                         kernel="auto", first=nwave),
           dict(stage1_isotropic_beam=1, bvp_forward=1, bvp_backward=1), 1,
           f"isotropic beam {shape} nstr {nstr}",
           f"isotropic beam {shape} (the first {nwave} of 500 waves) "
           f"nstr {nstr}")


def phase23_references(dev) -> dict:
    """What phase 23 needs of the plain versions alone, computed before the
    kernels are built: :func:`path_references` of :func:`global_paths` and
    ``RADIANCE_GLOBAL``, and the off-diagonal K4's sweeps leave at N = 128
    (:func:`jacobi_offdiag`, on the first layer x 128 columns of the
    aerosol path)."""
    from pyharp_tpu_torch.rt.disort import kernels as K

    t0 = time.perf_counter()
    refs = path_references(dev, global_paths, RADIANCE_GLOBAL)
    p = next(global_paths(dev))[1]
    pr = p.disort._prepare(p.prop, p.bc, p.temf)
    sweeps = K.kernel_sweeps(p.disort._ang0.mu.shape[0])
    refs["offdiag"] = (sweeps, jacobi_offdiag(
        pr["ssa_s"][:1], pr["pmom_s"][:1], p.disort._ang0, sweeps))
    del p, pr
    refs["seconds"] = time.perf_counter() - t0
    return refs


def global_bodies(regs: dict, N: int) -> dict[str, str]:
    """Each body of N > 64 (``csrc/*_global.cu``): its ptxas line, the
    elements (K1, K4) or columns (K2, K5) an SM by the occupancy
    calculator and the global scratch a resident block keeps at ``N``."""
    from pyharp_tpu_torch.rt.disort import kernels as K

    lib = K.build().lib
    per_sm = {"stage1_isotropic": lib.pyharp_stage1_isotropic_global_occupancy(0),
              "stage1_isotropic_beam":
                  lib.pyharp_stage1_isotropic_global_occupancy(1),
              "stage1_general": lib.pyharp_stage1_general_global_occupancy(),
              "bvp_forward": lib.pyharp_bvp_forward_global_occupancy(),
              "bvp_backward": lib.pyharp_bvp_backward_global_occupancy(N)}
    # a launch over one unit of work runs one block
    slab = {"stage1_isotropic":
                lib.pyharp_stage1_isotropic_global_scratch(N, 0, 1),
            "stage1_isotropic_beam":
                lib.pyharp_stage1_isotropic_global_scratch(N, 1, 1),
            "stage1_general": lib.pyharp_stage1_general_global_scratch(N, 1),
            "bvp_forward": lib.pyharp_bvp_forward_global_scratch(N, 1),
            "bvp_backward": lib.pyharp_bvp_backward_global_scratch(N, 1)}
    unit = {"bvp_forward": "columns", "bvp_backward": "columns"}
    out = {n: f"{regs.get(GLOBAL_PTXAS[n])}, {per_sm[n]} "
              f"{unit.get(n, 'elements')} an SM, {4 * slab[n]} B of global "
              f"scratch a block at N = {N}"
           for n in GLOBAL_PTXAS}
    # K2: the cluster body up to its reach, the slab body past it
    c, smem, clusters, reach = cluster_info(N)
    past = reach + 1
    out["bvp_forward"] = (
        f"cluster body {regs.get(CLUSTER_PTXAS)}, {c} blocks a cluster, "
        f"{smem} B of shared memory a block, {clusters} clusters resident "
        f"at N = {N}, no scratch; slab body past N = {reach}: "
        f"{regs.get(GLOBAL_PTXAS['bvp_forward'])}, {per_sm['bvp_forward']} "
        f"columns an SM, "
        f"{4 * lib.pyharp_bvp_forward_global_scratch(past, 1)} B of global "
        f"scratch a block at N = {past}")
    return out


def cluster_info(N: int) -> tuple[int, int, int, int]:
    """K2's cluster body at N from the library: blocks a cluster (0 past
    the reach), shared memory a block in bytes, clusters resident, and
    the reach."""
    import ctypes

    from pyharp_tpu_torch.rt.disort import kernels as K

    out = (ctypes.c_int * 3)()
    reach = K.build().lib.pyharp_bvp_forward_cluster_info(N, out)
    return out[0], out[1], out[2], reach


def cluster_edge_check(dev) -> str:
    """K2's cluster sizing of the library against ``kernels.cluster_blocks``
    at every N = 65..171, then K2 bit-equal to its plain version at the
    reach (nstr 340, the cluster body at 8 blocks) and one past it (nstr
    342, the slab body) on 7 columns x 2 layers of K1's eigenstructure
    with a drawn right-hand side and albedo; returns the line to print."""
    import torch

    from pyharp_tpu_torch.bench.problems import stage1_inputs
    from pyharp_tpu_torch.rt.disort import kernels as K
    from pyharp_tpu_torch.rt.disort.solver import make_static_angles

    reach = K.cluster_reach()
    assert cluster_info(65)[3] == reach, (cluster_info(65), reach)
    for N in range(K.HUGE_MAX_N + 1, reach + 2):
        assert cluster_info(N)[0] == K.cluster_blocks(N), N
    L, B = 2, 7
    msgs = []
    for N in (reach, reach + 1):
        nstr = 2 * N
        ang = make_static_angles(nstr, nstr, 0)
        rng = np.random.default_rng(2400 + nstr)
        ssa, dtau, btop, slope = stage1_inputs(L, B, seed=2410 + nstr,
                                               device=dev)
        gp, gm, _, expd = K.stage1_isotropic(ssa, dtau, btop, slope, ang)[:4]
        dblk = torch.tensor(rng.uniform(-1.0, 1.0, (2 * N, L, B)),
                            dtype=torch.float32, device=dev)
        alb = torch.tensor(rng.uniform(0.0, 0.6, B), dtype=torch.float32,
                           device=dev)
        want = K.bvp_forward_plain(gp, gm, expd, dblk, alb, ang)
        got = K.bvp_forward(gp, gm, expd, dblk, alb, ang)
        assert all(bool(torch.equal(x, y)) for x, y in zip(got, want)), (
            f"K2 nstr {nstr}: not bit-equal to the plain version")
        c = cluster_info(N)[0]
        msgs.append(f"nstr {nstr} " + (f"(the cluster body, {c} blocks)"
                                       if c else "(the slab body)"))
        del gp, gm, expd, dblk, alb, want, got
    return (f"K2's cluster sizing equal to kernels.cluster_blocks at N = "
            f"65..{reach + 1} (reach {reach}); K2 bit-equal on {B} columns "
            f"x {L} layers at " + ", ".join(msgs))


def phase23(dev, card: str, regs: dict, refs: dict | None = None) -> list:
    """Phase 23, beyond 128 streams: the route at nstr 130, 256 and 1000,
    every body of N > 64 against its plain version at ``NSTR_GLOBAL``,
    K4's off-diagonal after its sweeps at N = 128, then the four paths at
    nstr 256 through ``kernel="auto"``; returns the entries of the
    ``kernels`` line.  ``refs``: :func:`phase23_references`, computed
    earlier (else here)."""
    import torch

    from pyharp_tpu_torch.bench.problems import extra_problem, stage1_inputs
    from pyharp_tpu_torch.rt.disort import kernels as K
    from pyharp_tpu_torch.rt.disort.legendre import lepoly
    from pyharp_tpu_torch.rt.disort.solver import make_static_angles

    t23 = time.perf_counter()
    kernels_json = []
    clock_mhz = float(run(["nvidia-smi", "--query-gpu=clocks.max.sm",
                           "--format=csv,noheader,nounits"]).splitlines()[0])
    bodies = global_bodies(regs, AEROSOL_GLOBAL[0] // 2)
    say("23", "the bodies of N > 64: " + "; ".join(
        f"{n} {v}" for n, v in bodies.items()) + f" [{card}]")

    def ptxas(recs):
        for r in recs:
            r["ptxas"] = bodies[r["name"]]
        return recs

    # the route: float32 on the card goes to the kernels at every nstr,
    # decided from the device, dtype and N before any launch
    K.reset_launches()
    for nstr in NSTR_ROUTE:
        assert K.route("auto", "cuda", torch.float32, nstr // 2) == "cuda"
        p = extra_problem(1, 2, 2, nstr, g=0.8, device=dev, kernel="auto")
        assert p.disort._kernels(dev, torch.float32).route == "cuda", nstr
        del p
    assert not any(K.launch_counts().values()), K.launch_counts()
    say("23", "route: float32 CUDA tensors at nstr "
              + ", ".join(map(str, NSTR_ROUTE)) + " -> 'cuda', before any "
              "launch")

    # each body against its plain version on GLOBAL_CHECK_SHAPE's elements:
    # K1 beam, and K1 against the beam variant's plain eigenstructure (the
    # same function), bit-equal; K4 (m = 0 with a thermal source and a
    # beam, m = 1 with a beam) bit-equal; K2 and K5 on its B columns x L
    # layers, on K4's m = 0 eigenstructure with a drawn right-hand side and
    # albedo
    msgs = []
    L, B = GLOBAL_CHECK_SHAPE
    for nstr in NSTR_GLOBAL:
        N = nstr // 2
        ang = make_static_angles(nstr, nstr, 0)
        rng = np.random.default_rng(2300 + nstr)
        ssa, dtau, btop, slope = stage1_inputs(L, B, seed=2310 + nstr,
                                               device=dev)
        fbeam = torch.tensor(rng.uniform(0.5, 4.0, B), dtype=torch.float32,
                             device=dev)
        mu0 = torch.tensor(rng.uniform(0.1, 1.0, B), dtype=torch.float32,
                           device=dev)
        mur = mu0[None].expand(L, B).contiguous()
        s1b = (ssa, dtau, btop, slope, fbeam, mur, ang)
        want = K.stage1_isotropic_beam_plain(*s1b)
        stage1_exact(K.stage1_isotropic_beam(*s1b), want,
                     f"K1 beam nstr {nstr}")
        stage1_exact(K.stage1_isotropic(ssa, dtau, btop, slope, ang),
                     want[:7], f"K1 nstr {nstr}")
        del want
        pm = torch.tensor(
            np.stack([hg_moments(0.2 if b % 2 else 0.8, nstr)
                      for b in range(B)], axis=-1)[None].repeat(L, axis=0),
            dtype=torch.float32, device=dev)
        # the plain K4 of m = 0 (a thermal source and a beam) and m = 1 (a
        # beam) in one pass (stage1_general_modes_plain: the bits of a call
        # each), against a launch each
        angs = [make_static_angles(nstr, nstr, m) for m in (0, 1)]
        lam0s = [lepoly(mu0, a.m, a.lam_tables.shape[0] - 1).contiguous()
                 for a in angs]
        wants = K.stage1_general_modes_plain(
            ssa, pm, dtau, angs, fbeam=fbeam, mur=mur, lam0s=lam0s,
            btop=btop, slope=slope)
        for a, lam0, want in zip(angs, lam0s, wants):
            got = K.stage1_general(ssa, pm, dtau, btop, slope, a,
                                   thermal=a.m == 0, fbeam=fbeam, mur=mur,
                                   lam0=lam0)
            stage1_exact(got, want,
                         f"K4 nstr {nstr} m {a.m} thermal {a.m == 0}")
        folded_check(ssa, pm, dtau, fbeam, mur,
                     {1: (angs[1], lam0s[1], wants[1])}, f"nstr {nstr}")
        gp, gm, _, expd = (x.contiguous() for x in wants[0][:4])
        del wants, got
        dblk = torch.tensor(rng.uniform(-1.0, 1.0, (2 * N, L, B)),
                            dtype=torch.float32, device=dev)
        alb = torch.tensor(rng.uniform(0.0, 0.6, B), dtype=torch.float32,
                           device=dev)
        P, g = K.bvp_forward_plain(gp, gm, expd, dblk, alb, ang)
        got = K.bvp_forward(gp, gm, expd, dblk, alb, ang)
        e2 = bvp_check(got, (P, g), f"K2 nstr {nstr}")
        assert all(bool(torch.equal(x, y)) for x, y in zip(got, (P, g))), (
            f"K2 nstr {nstr}: not bit-equal to the plain version")
        bwd = (gp, gm, expd, P, g, ang)
        e5 = bvp_check(K.bvp_backward(*bwd), K.bvp_backward_plain(*bwd),
                       f"K5 nstr {nstr}")
        msgs.append(f"nstr {nstr}: K1, K1 beam, K4 (m 0, 1, and m 1 through "
                    "the modes launch), K2 bit-equal "
                    f"(K2 {e2:.2e}); K5 {e5:.2e}")
        del pm, gp, gm, expd, dblk, P, g, bwd
    torch.cuda.empty_cache()
    say("23", f"at L {L} x B {B} (stage 1) and {B} columns x {L} layers "
              "(BVP): " + "; ".join(msgs) + f" ({STAGE1_TOL}, asserted "
              f"bit-equal; {BVP_TOL}); {time.perf_counter() - t23:.1f} s "
              f"into phase 23 [{card}]")
    say("23", cluster_edge_check(dev) + f"; {time.perf_counter() - t23:.1f}"
              f" s into phase 23 [{card}]")
    torch.cuda.empty_cache()

    if refs is None:
        refs = phase23_references(dev)
        say("23", f"the float64 references took {refs['seconds']:.1f} s")
    sweeps, off = refs["offdiag"]
    say("23", f"K4's Jacobi at N = 128 (nstr 256) on 128 elements of the "
              "aerosol path (1 layer x 128 columns), float32 by the plain "
              f"operations: max |off-diagonal of Y^T K Y| / max |lam^2| "
              f"{off:.2e} after its {sweeps} sweeps")
    for key, p, want, stride, tag, label in global_paths(dev):
        kernels_json += stream_path("23", t23, card, clock_mhz, ptxas, label,
                                    p, want, stride, tag, refs[key])
        del p
    torch.cuda.empty_cache()
    kernels_json += radiance_path("23", dev, card, RADIANCE_GLOBAL, ptxas,
                                  refs["radiances"], RADIANCE_GLOBAL_MODES)
    say("23", f"phase 23 took {time.perf_counter() - t23:.1f} s [{card}]")
    return kernels_json


def main() -> None:
    import torch

    # ---- phase 0: device --------------------------------------------------
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: torch.cuda.is_available() is false; "
                         "this script runs only on a CUDA GPU")
    import amars_lw_torch
    import amars_sw_torch
    from pyharp_tpu_torch.bench import roofline_run as R
    from pyharp_tpu_torch.bench.problems import (
        RAD_FLAGS, RAD_MU, RAD_PHI, RAD_SHAPE, RAD_TAU, bench_problem,
        extra_problem, radiance_problem, stage1_inputs)
    from pyharp_tpu_torch.bench.roofline_run import kernel_flops
    from pyharp_tpu_torch.rt.disort import kernels as K
    from pyharp_tpu_torch.rt.disort.disort import flux_epilogue
    from pyharp_tpu_torch.rt.disort.legendre import lepoly
    from pyharp_tpu_torch.rt.disort.solver import make_static_angles

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)
    card = run(["nvidia-smi", "--query-gpu=name,power.limit",
                "--format=csv,noheader"]).splitlines()[0]
    import yaml     # the band factory's YAML reader (phase 11)

    say("0", f"device {torch.cuda.get_device_name(0)} | nvidia-smi: {card} | "
             f"torch {torch.__version__} cuda {torch.version.cuda} | "
             f"{run([K._nvcc(), '--version']).splitlines()[-1]} | "
             f"PyYAML {yaml.__version__}")

    # ---- phase 1: build ----------------------------------------------------
    # while nvcc compiles, the card runs what phases 22 and 21 need of the
    # plain versions alone (their float64 references)
    with ThreadPoolExecutor(1) as pool:
        building = pool.submit(K.build)
        refs23 = phase23_references(dev)
        refs22 = phase22_references(dev)
        refs21 = path_references(dev, big_paths, RADIANCE_BIG)
        lib = building.result()
    regs = ptxas_summary(lib.ptxas_log)
    say("1", f"built {lib.path.name} in {lib.build_seconds:.1f} s (the "
             "float64 references of phases 23, 22 and 21 meanwhile, "
             f"{refs23['seconds']:.1f}, {refs22['seconds']:.1f} and "
             f"{refs21['seconds']:.1f} s); "
             "ptxas: " + "; ".join(f"{k}: {v}" for k, v in regs.items()))
    say("1", "the bodies of N = 9..16: K4 a team of 4 lanes per element, "
             "its Jacobi set in registers (stage1_general_wide<9..16>: "
             f"{regs.get('stage1_general_wide<9..16>')}); K2 a warp per "
             "column, prefix-max pivot bits (bvp_forward_wide<9..16>: "
             f"{regs.get('bvp_forward_wide<9..16>')}); K5 rows in parallel "
             "over 32 columns: " + "; ".join(
                 f"bvp_backward_rows<{n}> {regs.get(f'bvp_backward_rows<{n}>')}"
                 for n in range(9, 17)))
    say("1", "the bodies of N = 17..32, N a run-time argument (K1, K4 a "
             "warp per element, K2 a block of 4 warps per column, its tile "
             "of 6 x 5 at N <= 24 and of 8 x 7 above, K5 N warps over 32 "
             "columns): " + "; ".join(
                 f"{k} {v}" for k, v in regs.items()
                 if k.endswith(("<17..32>", "<17..24>", "<25..32>"))))
    say("1", "the bodies of N = 33..64, N a run-time argument (K1 a warp per "
             "element, two roots a lane; K4 a warp per element, two rows a "
             "lane; K2 a block of 8 warps per column, its system in shared "
             "memory; K5 32 warps over 32 columns): " + "; ".join(
                 f"{k} {v}" for k, v in regs.items() if k.endswith("<33..64>")))
    say("1", "K2 at N = 5..7: one thread per column at N = 5, 6 ("
             + "; ".join(f"bvp_forward<{n}> {regs.get(f'bvp_forward<{n}>')}"
                         for n in (5, 6))
             + "); the half-warp team at N = 7 (bvp_forward_half<7> "
             f"{regs.get('bvp_forward_half<7>')})")

    # ---- phase 2: K1 against its plain version -----------------------------
    k1_err = {}
    for nstr, L, B in tuple((n, 37, 4096) for n in NSTR_ALL) + ((8, 100, 65536),):
        ang = make_static_angles(nstr, nstr, 0)
        ins = stage1_inputs(L, B, seed=nstr + L, device=dev)
        k1_err[(nstr, L, B)] = stage1_check(
            K.stage1_isotropic(*ins, ang), K.stage1_isotropic_plain(*ins, ang),
            f"K1 nstr {nstr} L {L} B {B}")
    say("2", "K1 max|err|/max|ref| " + ", ".join(
        f"nstr {n} L {L} B {B}: {e:.2e}" for (n, L, B), e in k1_err.items())
        + f" ({STAGE1_TOL})")

    # ---- phase 3: K2 + K3 against their plain versions ---------------------
    msgs = []
    for nstr in NSTR_ALL:
        for L, ncol in PHASE3_SHAPES[0 if nstr in NSTR_MAIN else 1:]:
            p = bench_problem(2, ncol, L, nstr,
                              torch.float32, dev, "cuda",
                              seed=nstr * L)
            ds, prop, bc, temf = p.disort, p.prop, p.bc, p.temf
            ang = ds._ang0
            pr = ds._prepare(prop, bc, temf)
            md = ds._solve_mode(pr)
            sol = md["sol"]
            e2 = bvp_check((md["P"], md["g"]), K.bvp_forward_plain(
                sol.gp, sol.gm, sol.expd, md["dblk"], pr["albedo"], ang),
                f"K2 nstr {nstr} L {L}")
            e3 = bvp_check(
                K.bvp_backward_flux(sol.gp, sol.gm, sol.expd, md["P"], md["g"],
                                    md["ptop_p"], md["ptop_m"], md["pb_p"],
                                    md["pb_m"], ang),
                K.bvp_backward_flux_plain(sol.gp, sol.gm, sol.expd, md["P"],
                                          md["g"], md["ptop_p"], md["ptop_m"],
                                          md["pb_p"], md["pb_m"], ang),
                f"K3 nstr {nstr} L {L}")
            msgs.append(f"nstr {nstr} L {L}: K2 {e2:.2e} K3 {e3:.2e}")
    say("3", "max|err|/max|ref| on 1024 (L 100; nstr 4/8/16) and 1018 (L 37) "
             "columns: "
             + "; ".join(msgs) + f" ({BVP_TOL})")

    # ---- phase 4: Disort.forward at the bench shape ------------------------
    nwave, ncol, nlyr, nstr = 8, 8192, 100, 8
    p = bench_problem(nwave, ncol, nlyr, nstr,
                      torch.float32, dev, "cuda")
    ds, prop, bc, temf, w = p.disort, p.prop, p.bc, p.temf, p.weights

    def step(disort):
        return torch.einsum("g,g...->...", w, disort.forward(prop, bc, temf))

    K.reset_launches()
    flux = ds.forward(prop, bc, temf)
    torch.cuda.synchronize()
    launches = K.launch_counts()
    expect_launches(launches, stage1_isotropic=1, bvp_forward=1,
                    bvp_backward_flux=1)
    assert flux.shape == (nwave, ncol, nlyr + 1, 2)
    assert bool(torch.isfinite(flux).all())

    p64 = bench_problem(nwave, ncol, nlyr, nstr,
                        torch.float64, dev, "torch")
    ds64, prop64, bc64, temf64 = p64.disort, p64.prop, p64.bc, p64.temf
    ref = ds64.forward(prop64, bc64, temf64)
    err4 = float((flux.double() - ref).abs().max() / ref.abs().max())
    assert err4 <= 1e-4, f"bench forward vs float64 plain: {err4:.2e}"
    del p64, ds64, prop64, bc64, temf64, ref

    p = bench_problem(nwave, ncol, nlyr, nstr, torch.float32, dev,
                      "torch")
    ds_plain = p.disort
    ms_kernel = cuda_ms(lambda: step(ds), 10)
    ms_plain = cuda_ms(lambda: step(ds_plain), 10)
    say("4", f"forward {nwave}x{ncol}x{nlyr} nstr {nstr}: launches {launches}; "
             f"max|err|/max|flux| vs float64 plain on all columns "
             f"{err4:.2e} (<= 1e-4); kernel path {ms_kernel:.3f} ms/step "
             f"= {ncol / ms_kernel * 1e3:.0f} columns/s, plain float32 path "
             f"{ms_plain:.3f} ms/step = {ncol / ms_plain * 1e3:.0f} columns/s "
             f"[{card}]")

    # each kernel against its plain version on the path's own inputs, every
    # column of the bench shape, held to phase 2's and 3's bounds
    pr = ds._prepare(prop, bc, temf)
    md = ds._solve_mode(pr)
    kernels_json = thermal_records(f"bench {nwave}x{ncol}x{nlyr} nstr {nstr}",
                                   launches, pr, md, ds._ang0)
    say("4", "per kernel at the bench shape, all columns: "
             + records_line(kernels_json))
    del p, ds, ds_plain, prop, bc, temf, pr, md, flux

    # ---- phase 5: amars_lw through the port ---------------------------------
    with tempfile.TemporaryDirectory() as tmp:
        forward, inputs = amars_lw_torch.build(tmp, dtype=torch.float32,
                                               device=dev, kernel="cuda")
        K.reset_launches()
        out = forward(*inputs)
        torch.cuda.synchronize()
    expect_launches(K.launch_counts(), stage1_isotropic=1, bvp_forward=1,
                    bvp_backward_flux=1)
    bflx = out["bflx"].double().cpu().numpy()[0]
    gold = np.asarray(json.loads((DATA / "amars_lw_bflx.json").read_text())
                      ["bflx"])
    err5 = float(np.abs(bflx - gold).max() / np.abs(gold).max())
    assert np.isfinite(bflx).all() and err5 <= 1e-4, err5
    assert abs(bflx[-1, 1]) < 1e-6, bflx[-1]
    assert np.all(bflx[:, 0] > 0)
    say("5", f"amars_lw bflx vs float64 golden max|err|/max|flux| {err5:.2e} "
             f"(<= 1e-4); TOA down {bflx[-1, 1]:.2e}; up-flux > 0 at all "
             f"{bflx.shape[0]} levels")

    # ---- phase 6: K1 beam, K4, K5 against their plain versions --------------
    msgs = []
    for nstr in NSTR_ALL:
        N = nstr // 2
        L, B = 37, 4096
        ang = make_static_angles(nstr, nstr, 0)
        rng = np.random.default_rng(100 + nstr)
        ssa, dtau, btop, slope = stage1_inputs(L, B, seed=200 + nstr,
                                               device=dev)
        fbeam = torch.tensor(rng.uniform(0.5, 4.0, B), dtype=torch.float32,
                             device=dev)
        mu0 = rng.uniform(0.1, 1.0, B)
        # a beam cosine on a resonance 1/lam_k in ~1% of the elements
        hit = torch.tensor(rng.uniform(size=(L, B)) < 0.01, device=dev)
        kk = int(rng.integers(N))

        def resonant(lam):
            mur = torch.tensor(np.broadcast_to(mu0, (L, B)).copy(),
                               dtype=torch.float32, device=dev)
            return torch.where(hit, 1.0 / lam[kk], mur).contiguous()

        mur = resonant(K.stage1_isotropic_plain(ssa, dtau, btop, slope,
                                                ang)[2])
        e1 = stage1_check(
            K.stage1_isotropic_beam(ssa, dtau, btop, slope, fbeam, mur, ang),
            K.stage1_isotropic_beam_plain(ssa, dtau, btop, slope, fbeam, mur,
                                          ang), f"K1 beam nstr {nstr}")
        pm = np.where(np.arange(B) % 2 == 0, 0.2, 0.8)
        pmom = torch.tensor(
            np.stack([hg_moments(g, nstr) for g in pm], axis=-1)[None]
            .repeat(L, axis=0), dtype=torch.float32, device=dev)
        lam0 = lepoly(torch.tensor(mu0, dtype=torch.float32, device=dev), 0,
                      ang.lam_tables.shape[0] - 1).contiguous()
        a4 = (ssa, pmom, dtau, btop, slope, ang)
        mur4 = resonant(K.stage1_general_plain(*a4)[2])
        e4, k4_equal = [], []
        for thermal in (True, False):
            for beam in (True, False):
                kw = dict(thermal=thermal)
                if beam:
                    kw.update(fbeam=fbeam, mur=mur4, lam0=lam0)
                got = K.stage1_general(*a4, **kw)
                ref = K.stage1_general_plain(*a4, **kw)
                e4.append(stage1_check(
                    got, ref, f"K4 nstr {nstr} thermal {thermal} beam {beam}"))
                k4_equal.append(all(bool(torch.equal(g, r))
                                    for g, r in zip(got, ref)))
        assert all(k4_equal), f"K4 nstr {nstr} is not bit-equal: {k4_equal}"
        # K4 at the modes m >= 1: the mode's tables, no thermal source, the
        # beam's Lam_l^m(mu0) and prefactor 2/(4 pi), HG g = 0.8 moments
        pm8 = torch.tensor(np.broadcast_to(
            hg_moments(0.8, nstr)[None, :, None], (L, nstr, B)).copy(),
            dtype=torch.float32, device=dev)
        mu0_t = torch.tensor(mu0, dtype=torch.float32, device=dev)
        zero = torch.zeros_like(ssa)
        e4m, eq4m = [], []
        for m in (range(1, nstr) if nstr in NSTR_MAIN else (1, 2, nstr - 1)):
            angm = make_static_angles(nstr, nstr, m)
            a4m = (ssa, pm8, dtau, zero, zero, angm)
            kw = dict(thermal=False, fbeam=fbeam, lam0=lepoly(
                mu0_t, m, angm.lam_tables.shape[0] - 1).contiguous(),
                mur=resonant(K.stage1_general_plain(*a4m, thermal=False)[2]))
            got = K.stage1_general(*a4m, **kw)
            ref = K.stage1_general_plain(*a4m, **kw)
            e4m.append(stage1_check(got, ref, f"K4 nstr {nstr} mode {m}"))
            eq4m.append(all(bool(torch.equal(g, r)) for g, r in zip(got, ref)))
        assert all(eq4m), f"K4 nstr {nstr} modes not bit-equal: {eq4m}"
        e5 = []
        for L5 in (100, 37) if nstr in NSTR_MAIN else (37,):
            p = extra_problem(2, 256, L5, nstr, g=0.8, device=dev,
                              kernel="cuda", seed=nstr * L5)
            ds, prop, bc = p.disort, p.prop, p.bc
            md = ds._solve_mode(ds._prepare(prop, bc, None))
            s5 = md["sol"]
            e5.append(bvp_check(
                K.bvp_backward(s5.gp, s5.gm, s5.expd, md["P"], md["g"], ang),
                K.bvp_backward_plain(s5.gp, s5.gm, s5.expd, md["P"], md["g"],
                                     ang), f"K5 nstr {nstr} L {L5}"))
        msgs.append(f"nstr {nstr}: K1 beam {e1:.2e}, K4 (thermal x beam) "
                    + "/".join(f"{e:.2e}" for e in e4) + " bit-equal "
                    + "/".join("yes" if q else "no" for q in k4_equal)
                    + f", K4 modes {'1..' if nstr in NSTR_MAIN else '1, 2, '}"
                    f"{nstr - 1} (beam, HG g 0.8) max {max(e4m):.2e} "
                    f"bit-equal {sum(eq4m)}/{len(eq4m)}"
                    + ", K5 L " + ("100/37 " if nstr in NSTR_MAIN else "37 ")
                    + "/".join(f"{e:.2e}" for e in e5))
    say("6", "max|err|/max|ref|: " + "; ".join(msgs)
             + f" (K1 beam, K4: {STAGE1_TOL}; K5: {BVP_TOL})")

    # ---- phases 7 and 8: aerosol_16str_beam and sw_lbl_4str_beam, full width --
    for phase, (nwave, ncol, nlyr, nstr, g, label, want) in (
            ("7", (500, 128, 40, 16, 0.8, "aerosol_16str_beam",
                   dict(stage1_general=1, bvp_forward=1, bvp_backward=1))),
            ("8", (500, 512, 40, 4, 0.0, "sw_lbl_4str_beam",
                   dict(stage1_isotropic_beam=1, bvp_forward=1,
                        bvp_backward_flux=1)))):
        N = nstr // 2
        p = extra_problem(nwave, ncol, nlyr, nstr, g=g, device=dev,
                          kernel="cuda")
        ds, prop, bc = p.disort, p.prop, p.bc
        p64 = extra_problem(nwave, ncol, nlyr, nstr, g=g,
                            dtype=torch.float64, device=dev,
                            kernel="torch")
        ds64, prop64, bc64 = p64.disort, p64.prop, p64.bc
        launches, err, err_near_f, err_near, n_near, ms = solve_and_check(
            ds, ds64, (prop, bc), (prop64, bc64, None), want, label)
        del p64, ds64, prop64, bc64
        say(phase, f"{label} {nwave}x{ncol}x{nlyr} nstr {nstr}: launches "
                   f"{launches}; max|err|/max|flux| vs float64 plain: "
                   f"{err:.2e} on the {nwave * ncol - n_near} columns with "
                   f"every layer over {RESONANCE_MARGIN} from a beam "
                   f"resonance (<= 1e-4); on the other {n_near}, "
                   f"{err_near_f:.2e} vs float64 plain with float32's "
                   f"resonance floor (<= {NEAR_RESONANCE_TOL}) and "
                   f"{err_near:.2e} vs float64 plain (reported: float32's "
                   f"floor, as in the JAX package); kernel path "
                   f"{ms:.3f} ms/step = {ncol / ms * 1e3:.0f} columns/s "
                   f"[{card}]")
        pr = ds._prepare(prop, bc, None)
        md = ds._solve_mode(pr)
        sol, ang = md["sol"], ds._ang0
        path = f"{label} {nwave}x{ncol}x{nlyr} nstr {nstr}"
        recs = beam_records(path, launches, pr, md, ang)
        recs[1]["ptxas"] = regs.get(("bvp_forward_team" if N == 8 else
                                     "bvp_forward") + f"<{N}>")
        if nstr == 16:
            recs[0]["ptxas"] = regs.get(f"stage1_general<{N}>")
            # built with --fmad=false: a multiply-add issues as two
            # instructions, so the issue-rate floor is twice the op bound
            recs[0]["no_fma_floor_ms"] = 2 * recs[0]["flops"] / R.PEAK["flops"] * 1e3
        bwd = (sol.gp, sol.gm, sol.expd, md["P"], md["g"])
        tops = (md["ptop_p"], md["ptop_m"], md["pb_p"], md["pb_m"])
        if nstr == 16:
            kernels_json += [r for r in recs if r["name"] != "bvp_forward"]
            # K3 against K5 + the flux epilogue on the same inputs, N = 8
            fused = K.bvp_backward_flux(*bwd, *tops, ang)
            split = flux_epilogue(sol, *K.bvp_backward(*bwd, ang), *tops, ang)
            ab = max(rel_err(f, s) for f, s in zip(fused, split))
            ms_k3 = cuda_ms(lambda: K.bvp_backward_flux(*bwd, *tops, ang), 20)
            ms_k5e = cuda_ms(lambda: flux_epilogue(
                sol, *K.bvp_backward(*bwd, ang), *tops, ang), 20)
            say(phase, f"A/B at N = 8 on the path's inputs: K3 {ms_k3:.3f} ms; "
                       f"K5 + flux epilogue {ms_k5e:.3f} ms; fluxes differ by "
                       f"{ab:.2e} of max (the gate stays N <= 4) [{card}]")
        else:
            kernels_json.insert(1, recs[0])
        say(phase, "per kernel, all columns: " + records_line(recs)
                   + "; ptxas: " + "; ".join(
                       f"{r['name']} {r['ptxas']}" for r in recs if "ptxas" in r)
                   + ("; K4 issue-rate floor without FMA "
                      f"{recs[0]['no_fma_floor_ms']:.3f} ms" if nstr == 16
                      else "") + f" [{card}]")
        del p, ds, prop, bc, pr, md, sol, bwd, tops, recs
        torch.cuda.empty_cache()

    # ---- phase 9: amars_sw through the port ---------------------------------
    forward, inputs, _ = amars_sw_torch.build(dtype=torch.float32, device=dev,
                                              kernel="cuda")
    K.reset_launches()
    out = forward(*inputs)
    torch.cuda.synchronize()
    expect_launches(K.launch_counts(), stage1_isotropic_beam=1, bvp_forward=1,
                    bvp_backward_flux=1)
    golden = json.loads((DATA / "amars_sw_flux.json").read_text())
    gold = np.asarray(golden["flux"])
    sw = out["flux"].double().cpu().numpy()
    assert sw.shape == gold.shape, (sw.shape, gold.shape)
    err9 = float(np.abs(sw - gold).max() / np.abs(gold).max())
    toa = float(out["tot_flux_down_toa"][0])
    surf = float(out["tot_flux_down_surf"][0])
    assert np.isfinite(sw).all() and err9 <= 1e-4, err9
    assert abs(toa - AMARS_SW_TOA) < 0.5, toa
    assert 0.0 < surf < toa, (surf, toa)
    say("9", f"amars_sw TOA down-flux {toa:.4f} W/m^2 (within 0.5 of "
             f"{AMARS_SW_TOA}; float64 golden {golden['tot_flux_down_toa']:.4f}"
             f"), surface {surf:.4f}; flux vs float64 golden max|err|/max|flux|"
             f" {err9:.2e} (<= 1e-4)")

    # ---- phase 10: K6 against its plain version and K2 + K3/K5 -------------
    msgs = []
    for nstr in (4, 8, 16):
        for L, ncol in PHASE3_SHAPES + K6_EDGE_SHAPES:
            p = bench_problem(2, ncol, L, nstr,
                              torch.float32, dev, "cuda",
                              seed=3 * nstr + L)
            ds, prop, bc, temf = p.disort, p.prop, p.bc, p.temf
            pr = ds._prepare(prop, bc, temf)
            md = ds._solve_mode(pr)
            ang, ins = ds._ang0, bvp_inputs(pr, md)
            what = f"K6 nstr {nstr} L {L}"
            errs, note = [], ""
            for flux_only in (False, True):
                kw = dict(wmu=ang.w * ang.mu, flux_only=flux_only)
                got = K.bvp_fused(*ins, **kw)
                want = K.bvp_fused_plain(*ins, **kw)
                if L == 1 and flux_only:
                    errs.append(bvp_check(got[1:], want[1:],
                                          what + ", ab_last"))
                    note = single_layer_check(got[0], want[0], ins, kw, what)
                else:
                    errs.append(bvp_check(got, want, what))
                errs.append(max(k6_against_pair(ins, md, ang, flux_only,
                                                what)[0]))
            msgs.append(f"nstr {nstr} L {L}: (a, b) {errs[0]:.2e}/{errs[1]:.2e}"
                        f", flux {errs[2]:.2e}/{errs[3]:.2e}{note}")
    say("10", "K6 max|err|/max|ref| vs plain / vs K2 + K5 or K2 + K3 on 1024 "
              "(L 100) and 1018 (L 37, 1, 25) columns: " + "; ".join(msgs)
              + f" ({BVP_TOL}; {K6_PAIR_TOL}; at L 1 the flux mode's "
              f"layer-top sums vs the float64 plain version <= "
              f"{SINGLE_LAYER_TOL} max|ref|, the float32 plain version's "
              "reading beside, and its ab_last to the plain version)")
    k6_paths = (
        ("bench 8x8192x100 nstr 8", True,
         lambda: bench_problem(8, 8192, 100, 8, torch.float32, dev, "cuda")),
        ("aerosol_16str_beam 500x128x40 nstr 16", False,
         lambda: extra_problem(500, 128, 40, 16, g=0.8, device=dev,
                               kernel="cuda")),
        ("sw_lbl_4str_beam 500x512x40 nstr 4", True,
         lambda: extra_problem(500, 512, 40, 4, device=dev,
                               kernel="cuda")))
    for path, flux_only, make in k6_paths:
        p = make()
        ds, prop, bc, temf = p.disort, p.prop, p.bc, p.temf
        pr = ds._prepare(prop, bc, temf)
        md = ds._solve_mode(pr)
        rec, line = k6_record(path, pr, md, ds._ang0, flux_only)
        say("10", line + f" [{card}]")
        kernels_json.append(rec)
        del p, ds, prop, bc, temf, pr, md
        torch.cuda.empty_cache()

    # ---- phase 11: the YAML Radiation path ----------------------------------
    import amars_yaml_torch as ay

    def flux_errs(got: dict, total, ref: dict, ref_total):
        """Band name (and "total") -> (max|err| / max|flux|, max|err| /
        max|band flux|) of ``got`` against ``ref`` (numpy, float64), per
        band and for the total.  max|flux| is the largest flux of ``ref``
        over all bands and the total, the scale of the configuration; the
        second number, relative to the band's own largest flux, is reported:
        in an optically thin band float32 rounding of exp(-lam dtau) near 1
        is amplified in 1 - exp(-lam dtau)."""
        pairs = list(ref.items()) + [("total", ref_total)]
        scale = max(float(np.abs(np.asarray(w)).max()) for _, w in pairs)
        out = {}
        for name, want in pairs:
            g = (total if name == "total" else got[name]).double().cpu().numpy()
            w = np.asarray(want)
            assert g.shape == w.shape and np.isfinite(g).all(), name
            err = float(np.abs(g - w).max())
            out[name] = (err / scale, err / float(np.abs(w).max()))
        return out

    def errs_text(errs: dict) -> str:
        return ", ".join(f"{k} {a:.2e} ({b:.2e})" for k, (a, b) in errs.items())

    def counted(rad, inputs, fuse):
        """One forward with the counts set to 0 just before it; K1, K2 and
        K3 must each launch once per band, or once in all when fused."""
        K.reset_launches()
        total, aux = rad.forward(*inputs, return_aux=True, fuse_bands=fuse)
        torch.cuda.synchronize()
        launches = K.launch_counts()
        n = 1 if fuse else len(rad.bands)
        expect_launches(launches, stage1_isotropic=n, bvp_forward=n,
                        bvp_backward_flux=n)
        return total, ay.band_fluxes(rad, aux), launches

    with tempfile.TemporaryDirectory() as tmp:
        for config in ("ck", "lbl"):
            golden = json.loads((DATA / f"amars_yaml_{config}_flux.json")
                                .read_text())
            rad, inputs = ay.build(config, tmp, nlyr=golden["nlyr"],
                                   ncol=golden["ncol"], nstr=golden["nstr"],
                                   dtype=torch.float32, device=dev,
                                   kernel="cuda")
            nwave = {n: b.rtsolver.options.nwave for n, b in rad.bands.items()}
            assert nwave == golden["nwave"], (nwave, golden["nwave"])
            seq, seq_b, l_seq = counted(rad, inputs, False)
            fus, fus_b, l_fus = counted(rad, inputs, True)
            gold_b = {n: np.asarray(w)[None] for n, w in
                      golden["bands"].items()}
            gold_t = np.asarray(golden["total"])[None]
            errs = flux_errs(seq_b, seq, gold_b, gold_t)
            assert max(a for a, _ in errs.values()) <= 1e-4, errs
            fvs = max([rel_err(fus, seq)]
                      + [rel_err(fus_b[n], seq_b[n]) for n in seq_b])
            assert fvs <= 1e-6, fvs
            # the float32 plain path on the card, for the float32 floor
            rad32, in32 = ay.build(config, tmp, nlyr=golden["nlyr"],
                                   ncol=golden["ncol"], nstr=golden["nstr"],
                                   dtype=torch.float32, device=dev,
                                   kernel="torch")
            tot32, aux32 = rad32.forward(*in32, return_aux=True)
            errs32 = flux_errs(ay.band_fluxes(rad32, aux32), tot32, gold_b,
                               gold_t)
            say("11", f"amarsw-{config}: {sum(nwave.values())} bins "
                      f"({'/'.join(map(str, nwave.values()))}) x 1 column x "
                      f"{golden['nlyr']} layers, nstr {golden['nstr']}: "
                      f"launches sequential {l_seq}, fused {l_fus}; "
                      "vs JAX float64 golden, max|err|/max|flux| (<= 1e-4; "
                      "in brackets max|err|/max|band flux|, reported): "
                      + errs_text(errs) + "; the float32 plain path: "
                      + errs_text(errs32) + f"; fused vs sequential "
                      f"{fvs:.2e} (<= 1e-6)")
            del rad, inputs, seq, fus, seq_b, fus_b, rad32, in32

        # amarsw-lbl at 16 columns of an atmosphere drawn per layer and
        # column: timed both ways, fused against sequential, the float64
        # plain path on the first and the last column; then each kernel of
        # the fused solve against its plain version on that solve's inputs,
        # and K6 on them
        ncol, cols = 16, [0, 15]
        rad, inputs = ay.build("lbl", tmp, ncol=ncol, dtype=torch.float32,
                               device=dev, kernel="cuda", seed=11)
        nbins = sum(b.rtsolver.options.nwave for b in rad.bands.values())
        seq, seq_b, l_seq = counted(rad, inputs, False)
        fus, fus_b, l_fus = counted(rad, inputs, True)
        fvs = max([rel_err(fus, seq)]
                  + [rel_err(fus_b[n], seq_b[n]) for n in seq_b])
        assert fvs <= 1e-6, fvs
        ms_seq = cuda_ms(lambda: rad.forward(*inputs, fuse_bands=False), 10)
        ms_fus = cuda_ms(lambda: rad.forward(*inputs, fuse_bands=True), 10)
        rad64, _ = ay.build("lbl", tmp, ncol=len(cols), dtype=torch.float64,
                            device=dev, kernel="torch")
        conc, dz, bc, atm = inputs
        ref, aux64 = rad64.forward(
            conc[cols].double(), dz.double(), bc,
            {k: v[cols].double() for k, v in atm.items()}, return_aux=True)
        ref_b = {n: f.cpu().numpy()
                 for n, f in ay.band_fluxes(rad64, aux64).items()}
        err64 = {}
        for how, tot, bands in (("sequential", seq, seq_b),
                                ("fused", fus, fus_b)):
            errs = flux_errs({n: f[cols] for n, f in bands.items()},
                             tot[cols], ref_b, ref.cpu().numpy())
            assert max(a for a, _ in errs.values()) <= 1e-4, (how, errs)
            err64[how] = errs
        del rad64, ref, aux64, ref_b
        say("11", f"amarsw-lbl {nbins} bins x {ncol} columns x 40 layers = "
                  f"{nbins * ncol} problems, nstr 8, temperature, pressure "
                  f"and concentrations drawn per layer and column: "
                  f"sequential {ms_seq:.3f} ms/step = "
                  f"{nbins * ncol / ms_seq * 1e3:.0f} problems/s, launches "
                  f"{l_seq}; fused {ms_fus:.3f} ms/step = "
                  f"{nbins * ncol / ms_fus * 1e3:.0f} problems/s, launches "
                  f"{l_fus}; fused vs sequential {fvs:.2e} (<= 1e-6); vs the "
                  f"float64 plain path on columns {cols}, max|err|/max|flux| "
                  "(<= 1e-4; max|err|/max|band flux|): "
                  + "; ".join(f"{how} {errs_text(e)}"
                              for how, e in err64.items()) + f" [{card}]")

        ((_, _, fused_ds, args),) = rad._fused_problems(*inputs)
        pr = fused_ds._prepare(*args)
        md = fused_ds._solve_mode(pr)
        path = f"amarsw-lbl {nbins}x{ncol}x40 nstr 8 fused"
        recs = thermal_records(path, l_fus, pr, md, fused_ds._ang0)
        say("11", "per kernel on the fused solve's inputs, all columns: "
                  + records_line(recs) + f" [{card}]")
        rec, line = k6_record(path, pr, md, fused_ds._ang0, True)
        say("11", line + f" [{card}]")
        kernels_json.append(rec)
        del rad, inputs, conc, atm, args, pr, md, recs

    # ---- phase 12: radiances_8str_4mu_2phi_3tau at full width --------------
    nwave, ncol, nlyr, nstr = RAD_SHAPE
    N, nm = nstr // 2, nstr - 1
    p = radiance_problem(torch.float32, dev, "cuda")
    ds, prop, bc = p.disort, p.prop, p.bc
    K.reset_launches()
    out = ds.intensities(prop, bc)
    torch.cuda.synchronize()
    launches = K.launch_counts()
    expect_launches(launches, stage1_general=nstr, bvp_forward=2,
                    bvp_backward=2)
    assert out["uu"].shape == (nwave, ncol, len(RAD_TAU), len(RAD_PHI),
                               len(RAD_MU)), out["uu"].shape
    p64 = radiance_problem(torch.float64, dev, "torch")
    ds64, prop64, bc64 = p64.disort, p64.prop, p64.bc
    ref, margin, per_mode = radiance_reference(ds64, (prop64, bc64))
    with float32_resonance_floor():
        ref_f = radiance_reference(ds64, (prop64, bc64))[0]
    near = (margin < RESONANCE_MARGIN).reshape(nwave, ncol)
    n_near = int(near.sum())
    res12 = radiance_errors(out, ref, ref_f, near)
    del p64, ref, ref_f, ds64, prop64, bc64
    fwd = ds.forward(prop, bc)
    fvf = float(((out["flux"] - fwd).abs()
                 - 2e-4 * fwd.abs()).max() / fwd.abs().max())
    assert fvf <= 1e-5, f"intensities flux vs forward: {fvf:.2e}"
    up = [i for i, mu in enumerate(RAD_MU) if mu > 0]
    assert bool((out["uu"][..., up] > 0).all()), "uu <= 0 looking up"
    nrad = nwave * ncol * len(RAD_MU) * len(RAD_PHI) * len(RAD_TAU)
    path = (f"radiances_8str_4mu_2phi_3tau {nwave}x{ncol}x{nlyr} nstr {nstr}")
    say("12", f"{path}, flags {RAD_FLAGS}, user mu {RAD_MU}, phi "
              f"{tuple(round(p, 4) for p in RAD_PHI)}, tau {RAD_TAU}: "
              f"launches {launches}; uu {tuple(out['uu'].shape)} finite; "
              "max|err| per column vs the float64 plain path (flux over "
              "max|flux|, uu over the column's max|uu|, every (tau, phi, "
              "mu)): " + errors_text(res12, n_near, nwave * ncol)
              + f"; flux vs forward's |err| - 2e-4 |ref| {fvf:.2e} of "
              "max|flux| (<= 1e-5); uu > 0 looking up at every user tau "
              f"(min {float(out['uu'][..., up].min()):.3e}) [{card}]")
    del out, fwd

    # the step and how it divides: m = 0's kernels, the modes' kernels, the
    # sweeps and corrections (Disort._radiances), the rest (preparation,
    # Legendre tables, stacking, the BVP right-hand sides)
    ms_step = cuda_ms(lambda: ds.intensities(prop, bc)["uu"], 10)
    pieces = step_pieces(ds, prop, bc, 10)
    pr = ds._prepare(prop, bc, None)
    md = ds._solve_mode(pr, flux_only=False)
    modes = ds._modes_batched(pr)
    ang0, sol = ds._ang0, md["sol"]
    L, B = pr["L"], pr["B"]
    zero = torch.zeros_like(pr["ssa_s"])
    angs = [ds._angles(m) for m in modes["ms"]]
    fgp, fgm, fexpd, dblk, alb = modes["fold"]

    def m0_kernels():
        K.stage1_general(pr["ssa_s"], pr["pmom_s"], pr["dtau"],
                         pr["b_top_lay"], pr["slope"], ang0, thermal=False,
                         fbeam=pr["fbeam"], mur=md["mur"], lam0=md["lam0"])
        P0, g0 = K.bvp_forward(sol.gp, sol.gm, sol.expd, md["dblk"],
                               pr["albedo"], ang0)
        return K.bvp_backward(sol.gp, sol.gm, sol.expd, P0, g0, ang0)

    def k4_modes(k4):
        def run():
            return tuple(t for a, l0 in zip(angs, modes["lam0"])
                         for t in k4(pr["ssa_s"], pr["pmom_s"], pr["dtau"],
                                     zero, zero, a, thermal=False,
                                     fbeam=pr["fbeam"], mur=modes["mur"],
                                     lam0=l0))
        return run

    def modes_kernels():
        k4_modes(K.stage1_general)()
        Pm, gm_ = K.bvp_forward(fgp, fgm, fexpd, dblk, alb, ang0)
        return K.bvp_backward(fgp, fgm, fexpd, Pm, gm_, ang0)

    ms_m0 = cuda_ms(m0_kernels, 10)
    ms_mk = cuda_ms(modes_kernels, 10)
    sw_m0 = pieces.pop("radiances_without_modes")
    total = sum(pieces.values())
    say("12", f"step {ms_step:.3f} ms (CUDA events) = "
              f"{nrad / ms_step * 1e3:.0f} radiances/s ({nrad} radiances); "
              f"the step piece by piece on the host clock, each piece ending "
              f"in a synchronize, {total:.3f} ms: "
              + ", ".join(f"{k} {v:.3f}" for k, v in pieces.items())
              + f" ms; so m = 0 kernels (K4, K2, K5; CUDA events) "
              f"{ms_m0:.3f} ms, m >= 1 kernels ({nm} K4, K2, K5 folded) "
              f"{ms_mk:.3f} ms, sweeps + corrections "
              f"{pieces['radiances']:.3f} ms (without the modes m >= 1 "
              f"{sw_m0:.3f} ms), the rest (preparation, glue) "
              f"{total - ms_m0 - ms_mk - pieces['radiances']:.3f} ms "
              f"[{card}]")

    # each kernel of the modes against its plain version on these inputs
    near_cols = margin < RESONANCE_MARGIN                  # (B,)
    near_fold = (per_mode < RESONANCE_MARGIN).reshape(nm * B)
    k4_equal = all(bool(torch.equal(g, r)) for g, r in zip(
        k4_modes(K.stage1_general)(), k4_modes(K.stage1_general_plain)()))
    assert k4_equal, "K4 on the modes m >= 1 is not bit-equal to its plain version"
    nmom = pr["pmom_s"].shape[1]
    # the modes' launches of the counted run: all of K4's but m = 0's
    recs = [kernel_record(
        "stage1_general", path + f", modes 1..{nm}",
        launches["stage1_general"] - 1,
        k4_modes(K.stage1_general), k4_modes(K.stage1_general_plain), (), {},
        stage1_check, STAGE1_TOL,
        nm * kernel_flops("stage1_general", N, L, B, nmom=nmom,
                          sweeps=K.kernel_sweeps(N), thermal=False, beam=True),
        near=near_cols,
        reads=[pr["ssa_s"], pr["pmom_s"], pr["dtau"], pr["fbeam"],
               modes["mur"]] * nm + [modes["lam0"]])]
    recs[0].update(bit_equal=k4_equal,
                   ptxas=f"even m: {regs.get(f'stage1_general<{N}>')}; odd m: "
                         f"{regs.get(f'stage1_general_odd_m<{N}>')}")
    recs.append(kernel_record(
        "bvp_forward", path + f", modes 1..{nm} folded",
        launches["bvp_forward"], K.bvp_forward, K.bvp_forward_plain,
        (fgp, fgm, fexpd, dblk, alb, ang0), {}, bvp_check, BVP_TOL,
        kernel_flops("bvp_forward", N, L, nm * B), near=near_fold))
    Pm, gm_ = K.bvp_forward(fgp, fgm, fexpd, dblk, alb, ang0)
    recs.append(kernel_record(
        "bvp_backward", path + f", modes 1..{nm} folded",
        launches["bvp_backward"], K.bvp_backward, K.bvp_backward_plain,
        (fgp, fgm, fexpd, Pm, gm_, ang0), {}, bvp_check, BVP_TOL,
        kernel_flops("bvp_backward", N, L, nm * B), near=near_fold))
    del Pm, gm_
    say("12", "per kernel of the modes m >= 1, all columns: "
              + records_line(recs) + "; K4 bit-equal to its plain version "
              f"at every mode (asserted); K4 ptxas {recs[0]['ptxas']} [{card}]")
    kernels_json += recs
    tp0 = torch.zeros((N, L, nm * B), dtype=torch.float32, device=dev)
    for what, kw in (("m = 0", {}),
                     (f"modes 1..{nm} folded",
                      dict(ins=(fgp, fgm, fexpd, dblk, alb, tp0, tp0),
                           near=near_fold))):
        rec, line = k6_record(f"{path}, {what}", pr, md, ang0, False, **kw)
        say("12", line + f" [{card}]")
        kernels_json.append(rec)
    del p, ds, prop, bc, pr, md, modes, sol, fgp, fgm, fexpd, dblk, alb, tp0
    torch.cuda.empty_cache()

    # ---- phase 13: the static route under kernel="auto" ---------------------
    msgs = []
    for nstr, dtype in ((6, torch.float32), (12, torch.float32),
                        (8, torch.float64)):
        shape = (4, 256, 20, nstr)
        p = radiance_problem(dtype, dev, "auto", shape=shape,
                             seed=nstr)
        ds, prop, bc = p.disort, p.prop, p.bc
        p64 = radiance_problem(torch.float64, dev, "torch",
                               shape=shape, seed=nstr)
        ds64, prop64, bc64 = p64.disort, p64.prop, p64.bc
        route = ds._kernels(prop.device, prop.dtype).route
        f32 = dtype == torch.float32
        assert route == ("cuda" if f32 else "torch"), (nstr, dtype, route)
        K.reset_launches()
        flux = ds.forward(prop, bc)
        torch.cuda.synchronize()
        l_fwd = K.launch_counts()
        K.reset_launches()
        out = ds.intensities(prop, bc)
        torch.cuda.synchronize()
        l_int = K.launch_counts()
        # forward: K4, K2, then K3 (N <= 4) or K5; intensities: K4 per
        # mode, K2 and K5 twice
        back = "bvp_backward_flux" if nstr // 2 <= 4 else "bvp_backward"
        expect_launches(l_fwd, **({"stage1_general": 1, "bvp_forward": 1,
                                   back: 1} if f32 else {}))
        expect_launches(l_int, **(dict(stage1_general=nstr, bvp_forward=2,
                                       bvp_backward=2) if f32 else {}))
        # forward's columns near a beam resonance of m = 0, as phase 7; in
        # float64 the floor is float64's, so every column is held to 1e-4
        near0 = (resonance_margin(ds64._solve_mode(ds64._prepare(
            prop64, bc64, None))) < RESONANCE_MARGIN).reshape(shape[:2]) & f32
        fwd = {"flux": ds64.forward(prop64, bc64)}
        with float32_resonance_floor():
            fwd_f = {"flux": ds64.forward(prop64, bc64)}
        res_f = radiance_errors({"flux": flux}, fwd, fwd_f, near0,
                                keys=("flux",))
        ref, margin, _ = radiance_reference(ds64, (prop64, bc64))
        with float32_resonance_floor():
            ref_f = radiance_reference(ds64, (prop64, bc64))[0]
        near = (margin < RESONANCE_MARGIN).reshape(shape[:2]) & f32
        res = radiance_errors(out, ref, ref_f, near)
        n = shape[0] * shape[1]
        msgs.append(f"nstr {nstr} {str(dtype)[6:]}: route {route!r}, "
                    f"launches forward {l_fwd}, intensities {l_int}; forward "
                    + errors_text(res_f, int(near0.sum()), n)
                    + "; intensities " + errors_text(res, int(near.sum()), n))
        if f32:
            # the kernels at this N on forward's own inputs, timed
            pr = ds._prepare(prop, bc, None)
            recs = beam_records(
                f"radiance problem {'x'.join(map(str, shape[:3]))} nstr "
                f"{nstr}, forward", l_fwd, pr, ds._solve_mode(pr), ds._ang0,
                near=near0.reshape(-1), sums_vs_float64=True)
            kernels_json += recs
            k3 = [r for r in recs if "plain_max_rel_err_vs_float64" in r]
            msgs.append(f"nstr {nstr} per kernel, all columns: "
                        + records_line(recs) + "".join(
                            f" (K3's sums: the float32 plain version "
                            f"{r['plain_max_rel_err_vs_float64']:.2e} of "
                            f"max|ref| from float64; K3 against it "
                            f"{r['vs_plain_excess_over_rtol']:.2e} of "
                            f"max|ref| over 3e-4 rtol, reported)"
                            for r in k3))
            del pr, recs
        del p, p64, ds, prop, bc, ds64, prop64, bc64, ref, ref_f, out, flux
    say("13", "Disort.forward and .intensities on CUDA tensors, kernel="
              "'auto', 4x256x20 radiance problems: " + "; ".join(msgs)
              + f" [{card}]")

    # ---- phase 14: band radiances ---------------------------------------------
    from pyharp_tpu_torch.opacity.base import AttenuatorOptions
    from pyharp_tpu_torch.radiation import (Radiation, RadiationBandOptions,
                                            RadiationOptions)
    from pyharp_tpu_torch.rt.disort.disort import DisortOptions

    nwave, ncol, nlyr = 64, 16, 40
    op = AttenuatorOptions(species_names=("S8", "H2SO4"),
                           species_weights=(256.0e-3, 98.0e-3))

    def sw_radiation(dtype, kernel):
        """``tests/test_band.py:358-390``'s aerosol band with out-directions
        (S8 + H2SO4, 2000-50000 cm^-1), at 64 bins x 16 columns x 40 layers."""
        bop = RadiationBandOptions(
            name="sw", nlyr=nlyr, ncol=ncol,
            wave_lower=(2000.0,) * nwave, wave_upper=(50000.0,) * nwave,
            outdirs="(0., 0.) (60., 30.) (30., 90.)",
            wavenumber=tuple(np.linspace(2000.0, 50000.0, nwave)),
            attenuators=(
                ("s8", op.replace(species_ids=(0,), type="s8_fuller",
                                  opacity_files=("s8_k_fuller.txt",))),
                ("h2so4", op.replace(species_ids=(1,), type="h2sO4_simple",
                                     opacity_files=("h2so4.txt",)))),
            disort=DisortOptions(flags="lamber,quiet,usrang,"
                                 "intensity_correction", nstr=8, nmom=8,
                                 kernel=kernel))
        rad = Radiation(RadiationOptions(bands=("sw",), band_options=(bop,)),
                        dtype=dtype, device=dev)
        kw = dict(dtype=dtype, device=dev)
        gen = torch.Generator().manual_seed(14)
        conc = (1e-4 * (0.5 + torch.rand((ncol, nlyr, 2), generator=gen))
                ).to(**kw)
        bc = dict(fbeam=torch.full((nwave, ncol), float(np.pi), **kw),
                  umu0=torch.full((nwave, ncol), 0.8, **kw),
                  albedo=torch.full((nwave, ncol), 0.3, **kw))
        return rad, (conc, torch.full((nlyr,), 2000.0, **kw), bc)

    rad, args = sw_radiation(torch.float32, "cuda")
    K.reset_launches()
    got = rad.band_radiances(*args)["sw"]
    torch.cuda.synchronize()
    launches = K.launch_counts()
    expect_launches(launches, stage1_isotropic_beam=1, bvp_forward=1,
                    bvp_backward=1)
    rad64, args64 = sw_radiation(torch.float64, "torch")
    want = rad64.band_radiances(*args64)["sw"]
    e14 = rel_err(got.double(), want)
    assert got.shape == (nwave, ncol, 3) and bool((got > 0).all()), got.shape
    assert e14 <= 1e-4, e14
    say("14", f"Radiation.band_radiances, the S8 + H2SO4 band with 3 "
              f"out-directions, {nwave} bins x {ncol} columns x {nlyr} layers, "
              f"nstr 8 (isotropic: K1 beam at m = 0, the modes m >= 1 carry no "
              f"source): launches {launches}; (nwave, ncol, nray) "
              f"{tuple(got.shape)}, all > 0; max|err|/max|ref| vs the float64 "
              f"plain path {e14:.2e} (<= 1e-4)")
    del rad, args, rad64, args64, got, want

    # ---- phase 15: Beer-Lambert at the bench shape ----------------------------
    from pyharp_tpu_torch.bench import scaling
    from pyharp_tpu_torch.rt import BeerLambert, BeerLambertOptions
    from pyharp_tpu_torch.rt import toa_radiance

    nwave, ncol, nlyr, nstr = SHARDED_SHAPE

    def beer_lambert(dtype):
        p = bench_problem(
            nwave, ncol, nlyr, nstr, dtype, dev, "torch",
            distinct_bins=True)
        ds, prop, bc, temf = p.disort, p.prop, p.bc, p.temf
        bl = BeerLambert(BeerLambertOptions(
            nstr=nstr, wave_lower=ds.options.wave_lower,
            wave_upper=ds.options.wave_upper))
        kw = dict(dtype=dtype, device=dev)
        bc = dict(bc, fbeam=torch.full((nwave, ncol), float(np.pi), **kw),
                  umu0=torch.linspace(0.2, 1.0, ncol, **kw).expand(nwave,
                                                                   ncol))
        # toa_radiance: the layers top-down, the levels' Planck source
        tau = prop[..., 0].flip(-1)
        src = temf.flip(-1)[None] ** 4 * 5.67e-8 / np.pi
        mu = torch.tensor([0.3, 0.6, 1.0], **kw)
        return bl, (prop, bc, temf), (tau, src.expand(nwave, -1, -1), mu)

    bl, args, targs = beer_lambert(torch.float32)
    bl64, args64, targs64 = beer_lambert(torch.float64)
    got = bl.forward(*args)
    want = bl64.forward(*args64)
    e15 = rel_err(got.double(), want)
    assert got.shape == (nwave, ncol, nlyr + 1, 2), got.shape
    assert bool(torch.isfinite(got).all()) and e15 <= 1e-4, e15
    rad = toa_radiance(*targs, alpha=0.5)
    rad64 = toa_radiance(*targs64, alpha=0.5)
    e15t = rel_err(rad.double(), rad64)
    assert rad.shape == (nwave, ncol, 3) and e15t <= 1e-4, e15t
    ms_bl = cuda_ms(lambda: bl.forward(*args), 10)
    ms_toa = cuda_ms(lambda: toa_radiance(*targs, alpha=0.5), 10)
    say("15", f"BeerLambert.forward {nwave}x{ncol}x{nlyr} nstr {nstr}, "
              f"thermal with the bins' edges and a beam: max|err|/max|flux| "
              f"float32 vs float64 on the card {e15:.2e} (<= 1e-4), "
              f"{ms_bl:.3f} ms; toa_radiance alpha 0.5, 3 rays: {e15t:.2e} "
              f"(<= 1e-4), {ms_toa:.3f} ms [{card}]")
    del bl, bl64, args, args64, targs, targs64, got, want, rad, rad64

    # ---- phase 16: the sharded bench problem at world size 1 over NCCL --------
    import torch.distributed as dist

    from pyharp_tpu_torch.parallel import (init_distributed,
                                           make_radiation_mesh)
    from pyharp_tpu_torch.parallel.dryrun import _free_port
    from pyharp_tpu_torch.parallel.sharded import _with_band_edges

    init_distributed(f"localhost:{_free_port()}", 1, 0, backend="nccl")
    try:
        mesh = make_radiation_mesh(1, 1)
        step, sargs = scaling.build_sharded_step(
            mesh, nwave, ncol, nlyr, nstr, device=dev, kernel="cuda")
        K.reset_launches()
        got = step(*sargs)
        torch.cuda.synchronize()
        launches = K.launch_counts()
        expect_launches(launches, stage1_isotropic=1, bvp_forward=1,
                        bvp_backward_flux=1)
        p = bench_problem(
            nwave, ncol, nlyr, nstr, torch.float32, dev, "cuda",
            distinct_bins=True)
        ds, prop, bc, temf, w = p.disort, p.prop, p.bc, p.temf, p.weights

        def unsharded():
            return torch.einsum("g,g...->...", w, ds.forward(prop, bc, temf))

        ref = unsharded()
        assert got.shape == (ncol, nlyr + 1, 2), got.shape
        assert torch.equal(got, ref), float((got - ref).abs().max())
        p64 = bench_problem(
            nwave, ncol, nlyr, nstr, torch.float64, dev, "torch",
            distinct_bins=True)
        ds64, prop64, bc64, temf64 = p64.disort, *p64.args
        w64 = p64.weights
        e16 = rel_err(got.double(), torch.einsum(
            "g,g...->...", w64, ds64.forward(prop64, bc64, temf64)))
        assert bool(torch.isfinite(got).all()) and e16 <= 1e-4, e16
        del p64, ds64, prop64, bc64, temf64, w64
        ms16 = [cuda_ms(unsharded, 10), cuda_ms(lambda: step(*sargs), 10),
                cuda_ms(lambda: step(*sargs), 10), cuda_ms(unsharded, 10)]
        red = got.clone()
        ms_red = cuda_ms(lambda: dist.all_reduce(
            red, group=mesh.get_group("wave")), 10)
        say("16", f"sharded band flux {nwave}x{ncol}x{nlyr} nstr {nstr}, "
                  f"mesh (1, 1) over NCCL: launches {launches}; bit-equal to "
                  f"the unsharded forward + weighted sum; max|err|/max|flux| "
                  f"vs float64 plain {e16:.2e} (<= 1e-4); ms/step unsharded, "
                  f"sharded, sharded, unsharded: "
                  + ", ".join(f"{m:.3f}" for m in ms16)
                  + f"; the all_reduce of the {tuple(red.shape)} float32 band "
                  f"flux alone {ms_red:.3f} ms [{card}]")
        path = f"sharded bench {nwave}x{ncol}x{nlyr} nstr {nstr}, mesh 1x1"
        pr = ds._prepare(prop, _with_band_edges(ds, bc, prop), temf)
        md = ds._solve_mode(pr)
        recs = thermal_records(path, launches, pr, md, ds._ang0)
        say("16", "per kernel on the sharded path's inputs: "
                  + records_line(recs))
        kernels_json += recs
        ref17 = ref.double().cpu().numpy()
        del p, step, sargs, got, ref, red, ds, prop, bc, temf, pr, md
    finally:
        dist.destroy_process_group()
    torch.cuda.empty_cache()

    # ---- phase 17: two ranks sharing the card over gloo -----------------------
    from pyharp_tpu_torch.parallel import spawn

    with tempfile.TemporaryDirectory() as tmp:
        spawn(phase17_rank, 2, tmp, backend="gloo", device="cuda")
        recs17 = [json.loads(Path(tmp, f"rank{r}.json").read_text())
                  for r in range(2)]
        msgs = []
        for n_col, n_wave in PHASE17_MESHES:
            tag = f"{n_col}x{n_wave}"
            errs = []
            for r, rec in enumerate(recs17):
                part = np.load(Path(tmp, f"rank{r}_{tag}.npy"))
                m = ncol // n_col
                want = ref17[rec[tag]["col_index"] * m:][:m]
                np.testing.assert_allclose(part, want, rtol=5e-6, atol=1e-8)
                errs.append(float(np.abs(part - want).max()
                                  / np.abs(want).max()))
            msgs.append(
                f"mesh ({n_col}, {n_wave}): launches per rank "
                + " / ".join(str(rec[tag]["launches"]) for rec in recs17)
                + "; max|err|/max|flux| vs the unsharded result "
                + " / ".join(f"{e:.2e}" for e in errs)
                + " (rtol 5e-6, atol 1e-8); ms/step per rank "
                + " / ".join(f"{rec[tag]['ms']:.3f}" for rec in recs17))
    say("17", f"two ranks on one card over gloo ({recs17[0]['device']}): "
              + "; ".join(msgs) + f" [{card}]")
    say("17", "partition_overhead_run "
              + json.dumps(recs17[0]["partition"]) + f" [{card}]")

    # ---- phase 18: the measurement drivers of pyharp_tpu_torch.bench -------
    from pyharp_tpu_torch.bench import columns, extra, rmse_run, stages

    t18 = time.perf_counter()

    def driver(fn, argv=(), **kw):
        """``fn(argv, **kw)`` with what it prints relayed as phase 18's
        lines."""
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            out = fn(list(argv), **kw)
        for line in buf.getvalue().splitlines():
            if line.strip():
                say("18", line)
        return out

    # each roofline row and each stage of stages (a) is also run through the
    # kernels' plain versions on the same inputs and held to them
    errs18 = {}
    rows = driver(R.main, check=plain_check(errs18))
    assert len(rows) == 6 and all(r["ms"] > 0 for r in rows), rows
    # raises unless within 10% and bit-equal
    driver(stages.main, check=plain_check(errs18))
    assert len(errs18) == 10, errs18
    say("18", "the roofline's rows and stages (a) against the plain versions "
              "on the same inputs, max|err|/max|ref|: "
              + "; ".join(f"{k} {e:.2e}" for k, e in errs18.items())
              + f" ({STAGE1_TOL} for stage 1, {BVP_TOL} for a BVP, K6 "
              f"within {K6_PAIR_TOL} of the pair)")
    rec = driver(columns.main)
    assert rec["value"] > 0, rec
    out = driver(extra.main)
    want18 = {
        "sw_lbl_4str_beam": dict(stage1_isotropic_beam=1, bvp_forward=1,
                                 bvp_backward_flux=1),
        "aerosol_16str_beam": dict(stage1_general=1, bvp_forward=1,
                                   bvp_backward=1),
        "thermal_lw_8str_100lyr_bigbatch": dict(stage1_isotropic=1,
                                                bvp_forward=1,
                                                bvp_backward_flux=1),
        "radiances_8str_4mu_2phi_3tau": dict(stage1_general=8, bvp_forward=2,
                                             bvp_backward=2)}
    for r in out["results"]:
        assert r["launches"] == want18[r["config"]], (r["config"],
                                                      r["launches"])
    assert [r["config"] for r in out["results"]] == list(want18)

    # the big batch, at a B no other phase runs: forward against the float64
    # plain path on every column, as phase 4 holds it, and K1-K3 against
    # their plain versions on its own inputs
    big = "thermal_lw_8str_100lyr_bigbatch"
    nwave, ncol, nlyr, nstr, kw = extra.CONFIGS[big]
    p = extra_problem(nwave, ncol, nlyr, nstr, device=dev, kernel="cuda", **kw)
    flux = p.disort.forward(*p.args)
    p64 = extra_problem(nwave, ncol, nlyr, nstr, dtype=torch.float64,
                        device=dev, kernel="torch", **kw)
    err_big = rel_err(flux.double(), p64.disort.forward(*p64.args))
    del p64
    torch.cuda.empty_cache()
    assert err_big <= 1e-4, f"{big} forward vs float64 plain: {err_big:.2e}"
    pr = p.disort._prepare(*p.args)
    md = p.disort._solve_mode(pr)
    path = f"{big} {nwave}x{ncol}x{nlyr} nstr {nstr}"
    launches = next(r["launches"] for r in out["results"]
                    if r["config"] == big)
    recs = thermal_records(path, launches, pr, md, p.disort._ang0)
    kernels_json += recs
    say("18", f"{path}: forward max|err|/max|flux| vs float64 plain on all "
              f"columns {err_big:.2e} (<= 1e-4); per kernel, all columns: "
              + records_line(recs) + f" [{card}]")
    del p, flux, pr, md, recs
    torch.cuda.empty_cache()

    # the accuracy matrix in float32 through the kernels
    photons = rmse_run.MC_PHOTONS
    K.reset_launches()
    mc = rmse_run.mc_case_errors(photons, torch.float32, dev)
    bad = {k: e for k, e in mc.items() if not max(e) < rmse_run.MC_TOL}
    assert not bad, f"float32 vs MC at {photons:.0e} photons: {bad}"
    anchors = rmse_run.anchor(torch.float32, dev)
    bad = [a for a in anchors if not a[4] < rmse_run.ANCHOR_TOL]
    assert not bad, f"float32 H-function anchor: {bad}"
    matrix = rmse_run.matrix(1_000_000, torch.float32, dev)
    l18 = K.launch_counts()
    missing = [k for k in KERNEL_TABLE if k != "bvp_fused" and not l18[k]]
    assert not missing, f"the rmse runs launched no {missing}"
    say("18", f"rmse_run float32 through the kernels (launches {l18}): "
              f"tests/test_oracle_mc.py's cases at {photons:.0e} photons, "
              "max|err|/scale (up, down): "
              + "; ".join(f"{k} {u:.2e}, {d:.2e}" for k, (u, d) in mc.items())
              + f" (< {rmse_run.MC_TOL}); H-function anchor rel err "
              + ", ".join(f"w0 {w} mu0 {m}: {r:.2e}"
                          for w, m, _, _, r in anchors)
              + f" (< {rmse_run.ANCHOR_TOL}); the matrix at 1e6 photons:")
    for line in rmse_run.report(matrix, anchors, 1_000_000, torch.float32,
                                dev).splitlines():
        if line.strip():
            say("18", line)
    say("18", f"phase 18 took {time.perf_counter() - t18:.1f} s [{card}]")

    # ---- phase 19: 18 to 32 streams -----------------------------------------
    kernels_json += phase19(dev, card, regs)

    # ---- phase 20: K2 at N = 5..7 at full width ---------------------------
    kernels_json += phase20(dev, card, regs)

    # ---- phase 21: 34 to 64 streams -----------------------------------------
    kernels_json += phase21(dev, card, regs, refs21)

    # ---- phase 22: 66 to 128 streams ----------------------------------------
    kernels_json += phase22(dev, card, regs, refs22)

    # ---- phase 23: beyond 128 streams ---------------------------------------
    kernels_json += phase23(dev, card, regs, refs23)

    print(card)
    print(json.dumps({"kernels": kernels_json}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    sys.path[:0] = [str(REPO), str(REPO / "examples")]
    main()
