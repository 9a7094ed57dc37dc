"""Time K1, K4 and K2 at N = 16 (nstr 32), K5 at N = 9..16, K2 at N = 5..7,
K1, K4 and K2 at N = 17..32, K1, K4, K2 and K5 at N = 33..64, K4 over the
radiance modes at N = 128, K2's bodies above N = 32, the solve steps they
run in, and the plain LU against another tree's, in turns, on the card;
K1's, K4's and K2's cycles by phase at N = 17..32, K4's at N = 64, K2's at
N = 64 and 128.

    git archive <commit> pyharp_tpu_torch/rt/disort | tar -x -C _checkout/parent
    python3 tools/wide_ab.py --parent _checkout/parent

Builds this tree's kernel library and the other tree's (``--parent``)
with the same ``kernels.build``, in parallel, each into a library of its
own, and prints the ptxas report of their bodies at N = 9..16.  With
``--parent .`` the two libraries are built from the same sources, which
times the tool against itself.  Each part times its calls over
``--reps`` calls with CUDA events, in turns:

- ``kernels``, in the order parent, this tree, this tree, parent, after
  checking the parent's library against this tree's (K1 and K4 bit-equal,
  K2 within the BVP bound ``|err| <= 3e-5 max|ref| + 3e-4 |ref|``): K1 on
  the isotropic thermal solve of bench.py's widths at 20 layers (8 x 2048
  x 20, nstr 32) and its beam variant on the isotropic beam solve (500 x
  64 x 20, nstr 32), the two K1 shapes of ``chip_smoke.py`` phase 19; K4
  and K2 on the inputs of aerosol_32str_beam (500 x 128 x 40, nstr 32, HG
  g = 0.8, a beam: K4 once, K2 once; K4 also without its Jacobi sweeps)
  and of the radiances at nstr 32 (32 x 64 x 40: K4 at each of the 32
  modes, K2 on the 31 folded modes).
- ``k5``, in the same order and checked the same way (within the BVP
  bound; whether the two are bit-equal is recorded): K5 on the inputs of
  the five paths of ``chip_smoke.py`` phase 19, the isotropic thermal
  solve (8 x 2048 x 20, nstr 32), the aerosol configuration at nstr 22
  (32 x 128 x 20, HG g = 0.8), the isotropic beam (500 x 64 x 20, nstr
  32), aerosol_32str_beam and the radiances' folded modes at nstr 32.
- ``k2_mid``, in the same order: K2 on the inputs of aerosol_16str_beam's
  configuration (500 x 128 x 40, HG g = 0.8, a beam) at nstr 10, 12 and
  14, the paths of ``chip_smoke.py`` phase 20, checked within the BVP
  bound away from a beam resonance and within 1e-3 of max|ref| near one.
- ``steps``: the solve steps whose glue calls ``solver._umv`` (the node
  intensities at N > 4), each in three setups: the parent's library and
  the parent's ``_umv`` (``parent``), this tree's library and the
  parent's ``_umv`` (``parent_glue``), this tree's both (``new``), in the
  order parent, parent_glue, new, new, parent_glue, parent.  So
  parent_glue - parent is the library's share and new - parent_glue the
  glue's.  Each setup's output is compared with this tree's, bit for bit.
- ``plain_lu``: the plain K2 (``kernels.bvp_forward_plain``) on the
  isotropic thermal solve's inputs at nstr 32, with the parent's
  ``linsolve.lu_solve`` and with this tree's, in the order parent, this
  tree, this tree, parent, once each.

- ``big``, in the order parent, this tree, this tree, parent: K1, K4 and
  K2 at N = 17..32 on the full-width inputs of ``chip_smoke.py`` phase 21,
  aerosol_16str_beam's configuration at nstr 64 (its first 100 waves x 128
  x 40) and nstr 48 (200 waves), the isotropic thermal (8 x 2048 x 20: K1
  and K2) and beam (500 x 64 x 20: K1 beam and K2) solves at nstr 64 and
  the radiances at nstr 64 (8 x 64 x 20: K4 over the 64 modes, K2 on the
  folded modes), after checking the parent's results against this tree's
  (K1 and K4 bit-equal, K2 within the BVP bound).  Only the bodies of N =
  17..32 (``BIG_SOURCES``) are built for it, so the two libraries build in
  about a minute.  The elements (K1, K4) and columns (K2) an SM holds, by
  the occupancy calculator, go beside the times; first, K4's square root
  without a range check against ``sqrtf`` on every float32 in [1, 2^60]
  (``kernels.root_check``).
- ``huge``, as ``big`` at N = 33..64 (only ``HUGE_SOURCES`` built), on
  the full-width inputs of ``chip_smoke.py`` phase 22 at nstr 128:
  aerosol_16str_beam's configuration (its first 25 waves x 128 x 40; K4
  also without its Jacobi sweeps, so that the difference is the sweeps'
  time), the isotropic thermal (8 x 512 x 20) and beam (the first 125 of
  500 waves x 64 x 20) solves and the radiances (2 x 16 x 10: K4 over the
  127 modes m >= 1, by a launch a mode where the library has no launch
  over modes, the parent's loop, else by that one launch, checked
  bit-equal), K5 beside K2 on each; where the parent has no bodies of N =
  33..64, this tree's library is timed against itself in turns.
- ``huge_cycles``: K4 at N = 33..64 of this tree and of the parent (or of
  ``--parent-profile``, a tree whose body carries the marks) built with
  ``PYHARP_BIG_PROFILE``, once each on the aerosol inputs at nstr 128,
  with and without a thermal source: the ``clock64()`` cycles of each
  phase (``K4_HUGE_PHASES``), as ``big_cycles``.
- ``k4_trees``: K4's bodies at N > 32 (only ``csrc/stage1_general_huge.cu``
  and ``csrc/stage1_general_global.cu`` built) of the parent, of the trees
  of ``--trees`` (``name=dir,...``: variants of this tree's sources) and of
  this tree, checked bit-equal to one another, then timed in turns (the
  trees in order, then in reverse): K4 on the inputs of ``chip_smoke.py``
  phase 22's aerosol path (its first 10 waves x 128 x 40 at nstr 128) with
  and without its Jacobi sweeps, over the radiance modes at nstr 128 (1 x
  16 x 8), on phase 23's aerosol path (1 wave x 128 x 10 layers at nstr
  256) with and without its sweeps, and over the radiance modes at nstr
  256 (1 x 4 x 4; not the parent's loop of 255 launches, timed once
  alone).  A tree without the launch over modes runs a launch a mode.
- ``k2_trees``: K2's bodies above N = 32 (only ``csrc/bvp_forward_huge.cu``
  and ``csrc/bvp_forward_global.cu`` built; the stage-1 bodies above N =
  32 of this tree, built apart, make the inputs) of the parent, of the
  trees of ``--trees`` and of this tree, checked against one another
  (bit-equal at N > 64, within the BVP bound at N = 33..64), then timed in
  turns (the trees in order, then in reverse) on K2's inputs on the paths
  of ``chip_smoke.py`` phases 22 and 23: aerosol_16str_beam's
  configuration (10 waves x 128 x 40 at nstr 128; 1 wave x 128 x 10 at
  256), the isotropic thermal (7 x 255 x 21; 1 x 63 x 11) and beam (25 x
  63 x 21; 3 x 21 x 11) solves and the radiances' folded modes (1 x 16 x
  8; 1 x 4 x 4).  Beside each, once, as a yardstick and not the same
  function: ``torch.linalg.solve`` on the first layer's 2N x 2N systems
  with the N + 1 right-hand sides over the same columns (the port never
  calls it).
- ``k2_cycles``: K2 of this tree and of the parent (or of
  ``--parent-profile``) built with ``PYHARP_BIG_PROFILE``, once each on the
  first columns of the isotropic thermal solves of phases 22 (32 of 7 x
  255 columns, N = 64) and 23 (16 of 63, N = 128), as many as the card
  holds at once: the ``clock64()`` cycles of each phase (``K2_PHASES``),
  a warp's over all layers and a column-layer's.
- ``global_modes``: K4 at N > 64 (only ``csrc/stage1_general_global.cu``
  built) over the 255 modes m >= 1 of the radiances at nstr 256 (1 x 4 x
  4, one wave, as ``chip_smoke.py`` phase 23 cuts them), the parent's
  launch a mode against this tree's one launch, checked bit-equal, in the
  same order (one call a turn).
- ``big_cycles``: K1, K4 and K2 at N = 17..32 of this tree and of the
  parent (where its sources carry the marks) built with
  ``PYHARP_BIG_PROFILE``, once each on the aerosol inputs at nstr 64 and
  48 (K4 also with a thermal source, so its two LUs run), K2 on the
  isotropic thermal solve at nstr 64, K1 on the isotropic thermal and
  beam solves at nstr 64: the ``clock64()`` cycles of each phase
  (``BIG_PROF_MARK`` in the sources), summed over the warps (K1, K4) or
  blocks (K2) and divided by their count, and each phase's share.

The parent's ``_umv`` and ``lu_solve`` are read from its ``solver.py``
and ``linsolve.py`` and run in this tree's modules.  One JSON line goes
to stdout and to ``wide_ab.json`` in ``--out-dir`` (the build directory
by default).  Needs a CUDA card; raises without one.
"""

from __future__ import annotations

import argparse
import ast
import json
import sys
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

REPO = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO))

DISORT = Path("pyharp_tpu_torch/rt/disort")
PARTS = ("kernels", "k5", "k2_mid", "steps", "plain_lu", "big", "big_cycles",
         "huge", "huge_cycles", "global_modes", "k4_trees", "k2_cycles",
         "k2_trees")
# the parts that time the whole libraries (the others build the bodies of
# N = 17..32 or 33..64 alone)
FULL_PARTS = ("kernels", "k5", "k2_mid", "steps", "plain_lu")
BIG_SOURCES = ("stage1_isotropic_big.cu", "stage1_general_big.cu",
               "bvp_forward_big.cu", "bvp_backward_big.cu")
HUGE_SOURCES = tuple(s.replace("_big", "_huge") for s in BIG_SOURCES)
GLOBAL_K4 = ("stage1_general_global.cu",)
K4_WIDE = ("stage1_general_huge.cu", "stage1_general_global.cu")
# K2's bodies above N = 32, and the stage-1 bodies that make their inputs
K2_WIDE = ("bvp_forward_huge.cu", "bvp_forward_global.cu")
STAGE1_WIDE = ("stage1_isotropic_huge.cu", "stage1_general_huge.cu",
               "stage1_isotropic_global.cu", "stage1_general_global.cu")
# the phases of BIG_PROF_MARK in the two bodies
K4_PHASES = ("moments, contractions and Cholesky", "K = Lc^T Vhat Lc",
             "sweeps", "D and the eigenvectors", "beam particular",
             "thermal LUs")
# the phases of BIG_PROF_MARK in K4's body of N = 33..64
K4_HUGE_PHASES = ("moments, contractions and Cholesky", "K = Lc^T Vhat Lc",
                  "sweeps: the chain to the next a_pq (and the p loops)",
                  "sweeps: row work and barrier", "D and the eigenvectors",
                  "gp, gm", "beam particular", "thermal LUs")
# the phases of BIG_PROF_MARK in K2's bodies (the big, huge, slab and
# cluster bodies; the last only in the cluster body)
K2_PHASES = ("staging", "block build", "pivot search and row moves",
             "updates", "back substitution", "stores", "carry",
             "cluster barrier waits")
K1_PHASES = ("table staging", "half choice and bisection", "Newton",
             "eigenvector max", "eigenvector normalised and stored",
             "thermal particular", "beam LU, zs and beam particular",
             "barrier and the block's stores")


def parent_function(path: Path, name: str, module):
    """The function ``name`` of the source file ``path``, defined in the
    namespace of ``module`` (this tree's counterpart of that file)."""
    tree = ast.parse(path.read_text())
    node = next(n for n in tree.body
                if isinstance(n, ast.FunctionDef) and n.name == name)
    ns = dict(vars(module))
    exec(compile(ast.Module([node], []), str(path), "exec"), ns)
    return ns[name]


def occupancy(lib, name: str, N: int) -> int:
    """Elements (K4) or columns (K2) an SM holds at N by the occupancy
    calculator, from the library's ``pyharp_<name>_occupancy``; for K1
    (``stage1_isotropic_big``) N is 1 for the beam variant, 0 for the
    thermal one."""
    import ctypes

    fn = getattr(lib.lib, f"pyharp_{name}_occupancy")
    fn.argtypes, fn.restype = [ctypes.c_int], ctypes.c_int
    return int(fn(N))


def big_k1_call(p):
    """K1's call on an isotropic path's inputs, the beam variant where the
    path has a beam."""
    from pyharp_tpu_torch.rt.disort import kernels as K

    ds = p.disort
    pr = ds._prepare(*p.args)
    s1 = (pr["ssa_s"], pr["dtau"], pr["b_top_lay"], pr["slope"])
    if not pr["has_beam"]:
        return lambda: K.stage1_isotropic(*s1, ds._ang0)
    mur = ds._beam_cosine(pr)
    return lambda: K.stage1_isotropic_beam(*s1, pr["fbeam"], mur, ds._ang0)


# K1's timings of ``big`` and ``huge``, on the isotropic paths: (key, path)
BIG_K1 = (("big_k1_thermal_8x2048x20_nstr64", "iso_thermal_8x2048x20_nstr64"),
          ("big_k1_beam_500x64x20_nstr64", "iso_beam_500x64x20_nstr64"))
HUGE_K1 = (("huge_k1_thermal_8x512x20_nstr128",
            "iso_thermal_8x512x20_nstr128"),
           ("huge_k1_beam_125x64x20_nstr128", "iso_beam_125x64x20_nstr128"))


def big_inputs(what: str, dev):
    """The problem of one path of ``big``: ``(problem, has_k4,
    radiances)``."""
    import torch

    from pyharp_tpu_torch.bench.problems import (bench_problem, extra_problem,
                                                 radiance_problem)

    if what == "aerosol_100x128x40_nstr64":
        return extra_problem(500, 128, 40, 64, g=0.8, device=dev,
                             kernel="cuda", first=100), True, False
    if what == "aerosol_200x128x40_nstr48":
        return extra_problem(500, 128, 40, 48, g=0.8, device=dev,
                             kernel="cuda", first=200), True, False
    if what == "iso_thermal_8x2048x20_nstr64":
        return bench_problem(8, 2048, 20, 64, torch.float32, dev,
                             "cuda"), False, False
    if what == "iso_beam_500x64x20_nstr64":
        return extra_problem(500, 64, 20, 64, beam=True, device=dev,
                             kernel="cuda"), False, False
    if what == "radiances_8x64x20_nstr64":
        return radiance_problem(torch.float32, dev, "cuda",
                                shape=(8, 64, 20, 64)), True, True
    if what == "aerosol_25x128x40_nstr128":
        return extra_problem(500, 128, 40, 128, g=0.8, device=dev,
                             kernel="cuda", first=25), True, False
    if what == "iso_thermal_8x512x20_nstr128":
        return bench_problem(8, 512, 20, 128, torch.float32, dev,
                             "cuda"), False, False
    if what == "iso_beam_125x64x20_nstr128":
        return extra_problem(500, 64, 20, 128, beam=True, device=dev,
                             kernel="cuda", first=125), False, False
    if what == "radiances_2x16x10_nstr128":
        return radiance_problem(torch.float32, dev, "cuda",
                                shape=(2, 16, 10, 128)), True, True
    # the paths of chip_smoke.py phases 22 and 23 (K2's inputs there)
    if what == "aerosol_10x128x40_nstr128":
        return extra_problem(500, 128, 40, 128, g=0.8, device=dev,
                             kernel="cuda", first=10), True, False
    if what == "iso_thermal_7x255x21_nstr128":
        return bench_problem(7, 255, 21, 128, torch.float32, dev,
                             "cuda"), False, False
    if what == "iso_beam_25x63x21_nstr128":
        return extra_problem(500, 63, 21, 128, beam=True, device=dev,
                             kernel="cuda", first=25), False, False
    if what == "radiances_1x16x8_nstr128":
        return radiance_problem(torch.float32, dev, "cuda",
                                shape=(1, 16, 8, 128)), True, True
    if what == "aerosol_1x128x10_nstr256":
        return extra_problem(500, 128, 10, 256, g=0.8, device=dev,
                             kernel="cuda", first=1), True, False
    if what == "iso_thermal_1x63x11_nstr256":
        return bench_problem(1, 63, 11, 256, torch.float32, dev,
                             "cuda"), False, False
    if what == "iso_beam_3x21x11_nstr256":
        return extra_problem(500, 21, 11, 256, beam=True, device=dev,
                             kernel="cuda", first=3), False, False
    assert what == "radiances_1x4x4_nstr256", what
    return radiance_problem(torch.float32, dev, "cuda",
                            shape=(1, 4, 4, 256)), True, True


BIG_PATHS = ("aerosol_100x128x40_nstr64", "aerosol_200x128x40_nstr48",
             "iso_thermal_8x2048x20_nstr64", "iso_beam_500x64x20_nstr64",
             "radiances_8x64x20_nstr64")
HUGE_PATHS = ("aerosol_25x128x40_nstr128", "iso_thermal_8x512x20_nstr128",
              "iso_beam_125x64x20_nstr128", "radiances_2x16x10_nstr128")
# K2's paths of k2_trees: chip_smoke.py phase 22's at nstr 128, phase 23's
# at nstr 256
K2_PATHS = ("aerosol_10x128x40_nstr128", "iso_thermal_7x255x21_nstr128",
            "iso_beam_25x63x21_nstr128", "radiances_1x16x8_nstr128",
            "aerosol_1x128x10_nstr256", "iso_thermal_1x63x11_nstr256",
            "iso_beam_3x21x11_nstr256", "radiances_1x4x4_nstr256")
# k2_cycles: (path, its first columns), as many columns as the card holds
# at once, so that each block (cluster) runs one column
K2_CYCLE_PATHS = (("iso_thermal_7x255x21_nstr128", 32),
                  ("iso_thermal_1x63x11_nstr256", 16))


class _K2Inputs(Exception):
    """Raised by :func:`k2_inputs`'s stand-in for K2 with its arguments."""


def k2_inputs(what: str, dev):
    """K2's arguments on a path of ``big_inputs``, as its solve passes them
    (the folded modes on the radiances): the solve runs stage 1 with the
    library in use and stops at K2's call."""
    from pyharp_tpu_torch.rt.disort import kernels as K

    p, _, radiances = big_inputs(what, dev)
    ds = p.disort
    real = K.bvp_forward

    def capture(*a):
        raise _K2Inputs(a)

    K.bvp_forward = capture
    try:
        if radiances:
            ds._modes_batched(ds._prepare(p.prop, p.bc, None))
        else:
            ds._solve_mode(ds._prepare(*p.args))
    except _K2Inputs as e:
        return e.args[0]
    finally:
        K.bvp_forward = real
    raise AssertionError(f"{what}: the solve did not reach K2")


def linalg_solve_ms(a2, reps: int) -> float:
    """The yardstick of k2_trees: ``torch.linalg.solve`` on the first
    layer's 2N x 2N systems (the carry above it zero) with K2's N + 1
    right-hand sides, over the same columns; ms a call."""
    import torch

    from chip_smoke import cuda_ms

    gp, gm, expd, dblk = (x[..., 0, :] if x.dim() > 2 else x
                          for x in a2[:4])
    N, B = gp.shape[0], gp.shape[-1]
    gpE = gp * expd[None]
    M = torch.cat([-torch.cat([gm, gpE], dim=1),
                   torch.cat([gpE, gm], dim=1)], dim=0)
    eye = torch.eye(N, dtype=gp.dtype, device=gp.device)
    sel = torch.cat([torch.zeros_like(eye), eye])[:, :, None].expand(
        2 * N, N, B)
    rhs = torch.cat([sel, dblk[:, None]], dim=1)
    A = M.permute(2, 0, 1).contiguous()
    R = rhs.permute(2, 0, 1).contiguous()
    return cuda_ms(lambda: torch.linalg.solve(A, R), reps)


def modes_call(ds, pr):
    """K4 over the modes m >= 1 of a radiance solve on its inputs ``pr``,
    stacked as the radiances take them: one launch over every mode
    (``kernels.stage1_general_modes``) where the library in use has it
    (this tree at N > 32), else a launch a mode (the parent's loop, and
    every tree at N <= 32)."""
    import torch

    from pyharp_tpu_torch.rt.disort import kernels as K
    from pyharp_tpu_torch.rt.disort.legendre import lepoly

    ms = range(1, ds.nstr)
    N = ds.nstr // 2
    angs = [ds._angles(m) for m in ms]
    G = ds._ang0.lam_tables.shape[0]
    lam0 = torch.stack([lepoly(pr["umu0"], m, G - 1) for m in ms])
    s4 = (pr["ssa_s"], pr["pmom_s"], pr["dtau"])
    kw = dict(fbeam=pr["fbeam"], mur=ds._beam_cosine(pr))
    zero = torch.zeros_like(pr["ssa_s"])
    entry = f"pyharp_stage1_general{K._body(N)}_modes"

    def fn():
        if N <= K.BIG_MAX_N or hasattr(K._library.lib, entry):
            return K.stage1_general_modes(*s4, angs, lam0s=lam0, **kw)
        return K._stack_modes([K.stage1_general(*s4, zero, zero, a,
                                                thermal=False, lam0=l0, **kw)
                               for a, l0 in zip(angs, lam0)])
    return fn


def big_calls(p, k4: bool, radiances: bool):
    """K4's, K2's and K5's calls on a path's inputs, as the path launches
    them: ``(k4_fn or None, k2_fn, k5_fn, N)``."""
    from pyharp_tpu_torch.rt.disort import kernels as K

    ds = p.disort
    if radiances:
        pr = ds._prepare(p.prop, p.bc, None)
        modes = ds._modes_batched(pr)
        fold = modes["fold"]
        k4_fn = modes_call(ds, pr)
        P, g = K.bvp_forward(*fold, ds._ang0)
        return (k4_fn, lambda: K.bvp_forward(*fold, ds._ang0),
                lambda: K.bvp_backward(*fold[:3], P, g, ds._ang0), modes["N"])
    pr = ds._prepare(*p.args)
    md = ds._solve_mode(pr)
    sol, ang = md["sol"], ds._ang0
    k4_fn = None
    if k4:
        k4_fn = lambda thermal=False, sweeps=None: K.stage1_general(
            pr["ssa_s"], pr["pmom_s"], pr["dtau"], pr["b_top_lay"],
            pr["slope"], ang, thermal=thermal, sweeps=sweeps,
            fbeam=pr["fbeam"], mur=md["mur"], lam0=md["lam0"])
    a2 = (sol.gp, sol.gm, sol.expd, md["dblk"], pr["albedo"], ang)
    a5 = (sol.gp, sol.gm, sol.expd, md["P"], md["g"], ang)
    return (k4_fn, lambda: K.bvp_forward(*a2), lambda: K.bvp_backward(*a5),
            sol.gp.shape[0])


def big_part(args, res, libs, timed, lib_setups, lib_turns, dev,
             kind: str = "big") -> None:
    """The part ``big`` or ``huge`` (module docstring)."""
    import torch

    from chip_smoke import bvp_check
    from pyharp_tpu_torch.rt.disort import kernels as K

    def use(name):
        K._library = libs[name]

    k1s, paths = (BIG_K1, BIG_PATHS) if kind == "big" else (HUGE_K1,
                                                             HUGE_PATHS)
    for key, what in k1s:
        use("new")
        p = big_inputs(what, dev)[0]
        k1_fn = big_k1_call(p)
        ref = k1_fn()
        use("parent")
        assert all(torch.equal(a, b) for a, b in zip(k1_fn(), ref)), (
            f"K1 of the parent differs from this tree's on {what}")
        del ref
        timed(key, k1_fn, lib_setups, lib_turns, args.reps)
        beam = "beam" in key
        for who, lb in libs.items():
            res[f"{key}_{who}_per_sm"] = occupancy(
                lb, f"stage1_isotropic_{kind}", int(beam))
        print(f"{key}: elements per SM {res[f'{key}_new_per_sm']} (new), "
              f"{res[f'{key}_parent_per_sm']} (parent)", flush=True)
        del p, k1_fn
        torch.cuda.empty_cache()
    use("new")
    if kind == "big":
        res["big_root_check_bad"] = K.root_check()
        print(f"K4's root against sqrtf on [1, 2^60]: "
              f"{res['big_root_check_bad']} differ", flush=True)
    for what in paths:
        use("new")
        p, k4, radiances = big_inputs(what, dev)
        k4_fn, k2_fn, k5_fn, N = big_calls(p, k4, radiances)
        if k4_fn is not None:
            ref = k4_fn()
            use("parent")
            got = k4_fn()
            assert all(torch.equal(a, b) for a, b in zip(got, ref)), (
                f"K4 of the parent differs from this tree's on {what}")
            del got, ref
            timed(f"{kind}_k4_{what}", k4_fn, lib_setups, lib_turns,
                  args.reps)
            if kind == "huge" and not radiances:
                timed(f"huge_k4_{what}_0_sweeps", lambda: k4_fn(sweeps=0),
                      lib_setups, lib_turns, args.reps)
        use("new")
        ref = k2_fn()
        use("parent")
        res[f"{kind}_k2_{what}_max_rel_err"] = bvp_check(
            k2_fn(), ref, f"K2 of the parent on {what}")
        del ref
        timed(f"{kind}_k2_{what}", k2_fn, lib_setups, lib_turns, args.reps)
        if kind == "huge":
            use("new")
            ref = k5_fn()
            use("parent")
            res[f"huge_k5_{what}_max_rel_err"] = bvp_check(
                k5_fn(), ref, f"K5 of the parent on {what}")
            del ref
            timed(f"huge_k5_{what}", k5_fn, lib_setups, lib_turns, args.reps)
        for who, lb in libs.items():
            res[f"{kind}_{what}_{who}_per_sm"] = {
                "k4_elements": occupancy(lb, f"stage1_general_{kind}", N),
                "k2_columns": occupancy(lb, f"bvp_forward_{kind}", N)}
        print(f"{what}: per SM {res[f'{kind}_{what}_new_per_sm']} (new), "
              f"{res[f'{kind}_{what}_parent_per_sm']} (parent)", flush=True)
        del p, k4_fn, k2_fn, k5_fn
        torch.cuda.empty_cache()
    use("new")


def big_cycles(res, who: str, lib, dev, card: str) -> None:
    """The part ``big_cycles`` (module docstring) on one tree's library
    (``who``: ``new`` or ``parent``)."""
    import ctypes

    import torch

    from pyharp_tpu_torch.rt.disort import kernels as K

    K._library = lib
    counters = (ctypes.c_ulonglong * 9)()

    def cycles(name, phases, fn):
        reader = getattr(lib.lib, f"pyharp_{name}_profile")
        reader.argtypes, reader.restype = [ctypes.c_void_p], ctypes.c_int
        torch.cuda.synchronize()
        assert reader(ctypes.addressof(counters)) == 0
        fn()
        torch.cuda.synchronize()
        assert reader(ctypes.addressof(counters)) == 0
        units = counters[8]
        per = [counters[i] / units for i in range(len(phases))]
        tot = sum(per)
        return {"units": units, "cycles_per_unit": tot,
                "phases": {ph: [c, c / tot] for ph, c in zip(phases, per)}}

    for key, what in BIG_K1:
        key = f"{who}_cycles_{key[4:]}"
        k1_fn = big_k1_call(big_inputs(what, dev)[0])
        res[key] = cycles("stage1_isotropic_big", K1_PHASES, k1_fn)
        res[key]["elements_per_sm"] = occupancy(
            lib, "stage1_isotropic_big", int("beam" in key))
        print(f"{key}: {res[key]} [{card}]", flush=True)
        del k1_fn
        torch.cuda.empty_cache()
    for what, k2_only in (("aerosol_100x128x40_nstr64", False),
                          ("aerosol_200x128x40_nstr48", False),
                          ("iso_thermal_8x2048x20_nstr64", True)):
        p, k4, radiances = big_inputs(what, dev)
        k4_fn, k2_fn, _, N = big_calls(p, k4, radiances)
        if not k2_only:
            for thermal in (False, True):
                key = (f"{who}_cycles_k4_{what}"
                       + ("_thermal" if thermal else ""))
                res[key] = cycles("stage1_general_big", K4_PHASES,
                                  lambda: k4_fn(thermal))
                res[key]["elements_per_sm"] = occupancy(
                    lib, "stage1_general_big", N)
                print(f"{key}: {res[key]} [{card}]", flush=True)
        key = f"{who}_cycles_k2_{what}"
        res[key] = cycles("bvp_forward_big", K2_PHASES, k2_fn)
        res[key]["columns_per_sm"] = occupancy(lib, "bvp_forward_big", N)
        print(f"{key}: {res[key]} [{card}]", flush=True)
        del p, k4_fn, k2_fn
        torch.cuda.empty_cache()


def huge_cycles(res, who: str, lib, dev, card: str) -> None:
    """The part ``huge_cycles`` (module docstring) on one tree's library
    built with ``PYHARP_BIG_PROFILE`` (``who``: ``new`` or ``parent``)."""
    import ctypes

    import torch

    from pyharp_tpu_torch.rt.disort import kernels as K

    K._library = lib
    counters = (ctypes.c_ulonglong * 9)()
    reader = lib.lib.pyharp_stage1_general_huge_profile
    reader.argtypes, reader.restype = [ctypes.c_void_p], ctypes.c_int
    what = "aerosol_25x128x40_nstr128"
    p, k4, radiances = big_inputs(what, dev)
    k4_fn, _, _, N = big_calls(p, k4, radiances)
    for thermal in (False, True):
        torch.cuda.synchronize()
        assert reader(ctypes.addressof(counters)) == 0
        k4_fn(thermal)
        torch.cuda.synchronize()
        assert reader(ctypes.addressof(counters)) == 0
        units = counters[8]
        per = [counters[i] / units for i in range(len(K4_HUGE_PHASES))]
        tot = sum(per)
        key = f"{who}_cycles_k4_{what}" + ("_thermal" if thermal else "")
        res[key] = {"units": units, "cycles_per_unit": tot,
                    "phases": {ph: [c, c / tot]
                               for ph, c in zip(K4_HUGE_PHASES, per)},
                    "elements_per_sm": occupancy(lib, "stage1_general_huge",
                                                 N)}
        print(f"{key}: {res[key]} [{card}]", flush=True)
    del p, k4_fn
    torch.cuda.empty_cache()


def k2_cycles(res, who: str, lib, stage1, dev, card: str) -> None:
    """The part ``k2_cycles`` (module docstring) on one tree's K2 library
    built with ``PYHARP_BIG_PROFILE`` (``who``: ``new`` or ``parent``);
    ``stage1`` makes the inputs."""
    import ctypes

    import torch

    from pyharp_tpu_torch.rt.disort import kernels as K

    counters = (ctypes.c_ulonglong * 9)()
    for what, cols in K2_CYCLE_PATHS:
        N = int(what.rsplit("nstr", 1)[1]) // 2
        name = ("bvp_forward_huge" if N <= K.HUGE_MAX_N
                else "bvp_forward_global")
        reader = getattr(lib.lib, f"pyharp_{name}_profile", None)
        if reader is None:              # a tree without the marks
            continue
        reader.argtypes, reader.restype = [ctypes.c_void_p], ctypes.c_int
        K._library = stage1
        a2 = k2_inputs(what, dev)
        a2 = tuple(x[..., :cols].contiguous() for x in a2[:5]) + (a2[5],)
        L = a2[0].shape[2]
        K._library = lib
        torch.cuda.synchronize()
        assert reader(ctypes.addressof(counters)) == 0
        K.bvp_forward(*a2)
        torch.cuda.synchronize()
        assert reader(ctypes.addressof(counters)) == 0
        units = counters[8]
        per = [counters[i] / units for i in range(len(K2_PHASES))]
        tot = sum(per)
        key = f"{who}_cycles_k2_{what}_first{cols}"
        # each block (cluster) runs one column: a warp's cycles over L
        # layers are that column's
        res[key] = {"units": units, "cycles_per_unit": tot,
                    "cycles_per_column_layer": tot / L,
                    "phases": {ph: [c, c / tot]
                               for ph, c in zip(K2_PHASES, per)}}
        print(f"{key}: {res[key]} [{card}]", flush=True)
        del a2
        torch.cuda.empty_cache()


def k2_trees(res, libs, stage1, timed, dev, card: str, reps: int) -> None:
    """The part ``k2_trees`` (module docstring); ``libs`` name -> K2
    library, ``parent`` first; ``stage1`` makes the inputs."""
    import torch

    from chip_smoke import bvp_check
    from pyharp_tpu_torch.rt.disort import kernels as K

    setups = {name: (lambda lb=lb: setattr(K, "_library", lb))
              for name, lb in libs.items()}
    names = list(libs)
    for what in K2_PATHS:
        K._library = stage1
        a2 = k2_inputs(what, dev)
        N = a2[0].shape[0]
        fn = lambda: K.bvp_forward(*a2)
        ref = None
        agree = []                 # the trees that agree with the parent
        for name in names:
            setups[name]()
            got = fn()
            if ref is None:
                ref = got
            try:
                if N > K.HUGE_MAX_N:
                    assert all(bool(torch.equal(a, b))
                               for a, b in zip(got, ref)), (
                        f"K2 of {name} differs from {names[0]}'s on {what}")
                else:
                    bvp_check(got, ref, f"K2 of {name} on {what}")
                agree.append(name)
            except AssertionError as e:
                res[f"k2_{what}_{name}_fails"] = str(e)
                print(f"k2_{what}: {e} [{card}]", flush=True)
        del ref, got
        timed(f"k2_{what}", fn, setups, tuple(agree) + tuple(agree[::-1]),
              reps)
        res[f"k2_{what}_linalg_solve_one_layer_ms"] = linalg_solve_ms(
            a2, reps)
        print(f"k2_{what}: torch.linalg.solve on one layer "
              f"{res[f'k2_{what}_linalg_solve_one_layer_ms']:.3f} ms "
              f"(L = {a2[0].shape[2]}) [{card}]", flush=True)
        del a2, fn
        torch.cuda.empty_cache()


def global_modes(args, res, libs, timed, dev, card: str) -> None:
    """The part ``global_modes`` (module docstring)."""
    import torch

    from pyharp_tpu_torch.bench.problems import radiance_problem
    from pyharp_tpu_torch.rt.disort import kernels as K

    K._library = libs["new"]
    p = radiance_problem(torch.float32, dev, "cuda", shape=(1, 4, 4, 256))
    ds = p.disort
    fn = modes_call(ds, ds._prepare(p.prop, p.bc, None))
    ref = fn()
    K._library = libs["parent"]
    got = fn()
    assert all(torch.equal(a, b) for a, b in zip(got, ref)), (
        "K4 of the parent differs from this tree's on the modes at nstr 256")
    del got, ref
    setups = {name: (lambda lb=lb: setattr(K, "_library", lb))
              for name, lb in libs.items()}
    timed("global_k4_radiance_modes_1x4x4_nstr256", fn, setups,
          ("parent", "new", "new", "parent"), 1)
    res["global_k4_modes_launch_in_parent"] = hasattr(
        libs["parent"].lib, "pyharp_stage1_general_global_modes")
    del p, ds, fn
    torch.cuda.empty_cache()


def k4_trees(res, libs, timed, dev, card: str) -> None:
    """The part ``k4_trees`` (module docstring); ``libs`` name -> library,
    ``parent`` first."""
    import torch

    from pyharp_tpu_torch.bench.problems import (extra_problem,
                                                 radiance_problem)
    from pyharp_tpu_torch.rt.disort import kernels as K
    from pyharp_tpu_torch.rt.disort.legendre import lepoly

    def aerosol(nstr, first, nlyr):
        p = extra_problem(500, 128, nlyr, nstr, g=0.8, device=dev,
                          kernel="cuda", first=first)
        ds = p.disort
        pr = ds._prepare(*p.args)
        lam0 = lepoly(pr["umu0"], 0,
                      ds._ang0.lam_tables.shape[0] - 1).contiguous()
        mur = ds._beam_cosine(pr)
        return lambda sweeps=None: K.stage1_general(
            pr["ssa_s"], pr["pmom_s"], pr["dtau"], pr["b_top_lay"],
            pr["slope"], ds._ang0, thermal=False, sweeps=sweeps,
            fbeam=pr["fbeam"], mur=mur, lam0=lam0)

    def modes(shape):
        p = radiance_problem(torch.float32, dev, "cuda", shape=shape)
        return modes_call(p.disort, p.disort._prepare(p.prop, p.bc, None))

    setups = {name: (lambda lb=lb: setattr(K, "_library", lb))
              for name, lb in libs.items()}

    def turns(what, fn, names, reps):
        ref = None
        for name in names:
            setups[name]()
            got = fn()
            if ref is None:
                ref = got
            assert all(bool(torch.equal(a, b)) for a, b in zip(got, ref)), (
                f"K4 of {name} differs from {names[0]}'s on {what}")
        del ref, got
        timed(what, fn, setups, tuple(names) + tuple(names[::-1]), reps)

    names = list(libs)
    for nstr, first, nlyr in ((128, 10, 40), (256, 1, 10)):
        fn = aerosol(nstr, first, nlyr)
        what = f"k4_aerosol_{first}x128x{nlyr}_nstr{nstr}"
        turns(what, fn, names, 2)
        turns(what + "_0_sweeps", lambda: fn(0), names, 2)
        del fn
        torch.cuda.empty_cache()
    turns("k4_radiance_modes_1x16x8_nstr128", modes((1, 16, 8, 128)), names,
          2)
    fn = modes((1, 4, 4, 256))
    turns("k4_radiance_modes_1x4x4_nstr256", fn, names[1:], 1)
    setups["parent"]()
    t0 = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    res["k4_radiance_modes_1x4x4_nstr256_parent_one_call_ms"] = (
        time.perf_counter() - t0) * 1e3
    print(f"k4_radiance_modes_1x4x4_nstr256, the parent's loop, one call: "
          f"{res['k4_radiance_modes_1x4x4_nstr256_parent_one_call_ms']:.1f}"
          f" ms [{card}]", flush=True)
    del fn
    torch.cuda.empty_cache()


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--parent", type=Path, required=True)
    ap.add_argument("--reps", type=int, default=3)
    ap.add_argument("--parts", default=",".join(PARTS),
                    help=f"comma-separated, of {', '.join(PARTS)}")
    ap.add_argument("--parent-profile", type=Path, default=None,
                    help="a tree whose K4 body of N = 33..64 (K2's bodies "
                         "above N = 32) carries the profile marks "
                         "(huge_cycles, k2_cycles; default --parent)")
    ap.add_argument("--trees", default="",
                    help="k4_trees, k2_trees: name=dir,... trees beside "
                         "the parent and this one")
    ap.add_argument("--out-dir", type=Path,
                    default=REPO / "pyharp_tpu_torch" / "_build" / "ab")
    args = ap.parse_args()
    parts = args.parts.split(",")
    assert set(parts) <= set(PARTS), parts

    import torch

    if not torch.cuda.is_available():
        raise SystemExit("wide_ab: needs a CUDA card")
    from chip_smoke import (NEAR_RESONANCE_TOL, RESONANCE_MARGIN, bvp_check,
                            cuda_ms, near_err, ptxas_summary,
                            resonance_margin, run)
    from pyharp_tpu_torch.bench.problems import (bench_problem, extra_problem,
                                                 radiance_problem)
    from pyharp_tpu_torch.rt.disort import disort as D
    from pyharp_tpu_torch.rt.disort import kernels as K
    from pyharp_tpu_torch.rt.disort import linsolve, solver
    from pyharp_tpu_torch.rt.disort.legendre import lepoly

    card = run(["nvidia-smi", "--query-gpu=name,power.limit",
                "--format=csv,noheader"]).splitlines()[0]
    t0 = time.perf_counter()
    ab = REPO / "pyharp_tpu_torch" / "_build" / "ab"
    pcsrc = args.parent / DISORT / "csrc"
    jobs = {}
    if set(parts) & set(FULL_PARTS):
        jobs["new"] = (K.CSRC, K.BUILD_DIR, None, ())
        jobs["parent"] = (pcsrc, ab / "parent", None, ())
    if "big" in parts:
        jobs["new_big"] = (K.CSRC, ab / "new_big", BIG_SOURCES, ())
        jobs["parent_big"] = (pcsrc, ab / "parent_big", BIG_SOURCES, ())
    if "huge" in parts:
        jobs["new_huge"] = (K.CSRC, ab / "new_huge", HUGE_SOURCES, ())
        if (pcsrc / HUGE_SOURCES[0]).exists():
            jobs["parent_huge"] = (pcsrc, ab / "parent_huge", HUGE_SOURCES,
                                   ())
    if "huge_cycles" in parts:
        pprof = (args.parent_profile or args.parent) / DISORT / "csrc"
        jobs["huge_profile"] = (K.CSRC, ab / "huge_profile", HUGE_SOURCES,
                                ("PYHARP_BIG_PROFILE",))
        if (pprof / HUGE_SOURCES[0]).exists():
            jobs["parent_huge_profile"] = (pprof, ab / "parent_huge_profile",
                                           HUGE_SOURCES,
                                           ("PYHARP_BIG_PROFILE",))
    if "global_modes" in parts:
        jobs["new_global"] = (K.CSRC, ab / "new_global", GLOBAL_K4, ())
        jobs["parent_global"] = (pcsrc, ab / "parent_global", GLOBAL_K4, ())
    trees = dict(t.split("=") for t in args.trees.split(",") if t)
    if "k4_trees" in parts:
        jobs["trees_parent"] = (pcsrc, ab / "trees_parent", K4_WIDE, ())
        for name, tree in trees.items():
            jobs[f"trees_{name}"] = (Path(tree) / DISORT / "csrc",
                                     ab / f"trees_{name}", K4_WIDE, ())
        jobs["trees_new"] = (K.CSRC, ab / "trees_new", K4_WIDE, ())
    if {"k2_cycles", "k2_trees"} & set(parts):
        jobs["k2_stage1"] = (K.CSRC, ab / "k2_stage1", STAGE1_WIDE, ())
    if "k2_cycles" in parts:
        pprof = (args.parent_profile or args.parent) / DISORT / "csrc"
        jobs["k2_profile_parent"] = (pprof, ab / "k2_profile_parent",
                                     K2_WIDE, ("PYHARP_BIG_PROFILE",))
        jobs["k2_profile_new"] = (K.CSRC, ab / "k2_profile_new", K2_WIDE,
                                  ("PYHARP_BIG_PROFILE",))
    if "k2_trees" in parts:
        jobs["k2_trees_parent"] = (pcsrc, ab / "k2_trees_parent", K2_WIDE,
                                   ())
        for name, tree in trees.items():
            jobs[f"k2_trees_{name}"] = (Path(tree) / DISORT / "csrc",
                                        ab / f"k2_trees_{name}", K2_WIDE, ())
        jobs["k2_trees_new"] = (K.CSRC, ab / "k2_trees_new", K2_WIDE, ())
    if "big_cycles" in parts:
        jobs["profile"] = (K.CSRC, ab / "profile", BIG_SOURCES,
                           ("PYHARP_BIG_PROFILE",))
        jobs["parent_profile"] = (pcsrc, ab / "parent_profile", BIG_SOURCES,
                                  ("PYHARP_BIG_PROFILE",))
    with ThreadPoolExecutor(len(jobs)) as pool:
        futs = {k: pool.submit(K.build, *v) for k, v in jobs.items()}
        built = {k: f.result() for k, f in futs.items()}
    regs = {f"{who}:{k}": v
            for who, lb in built.items()
            for k, v in ptxas_summary(lb.ptxas_log).items()
            if "wide" in k or "big" in k or "huge" in k or "global" in k
            or k.startswith("bvp_backward")
            or k in ("bvp_forward<5>", "bvp_forward<6>", "bvp_forward<7>",
                     "bvp_forward_half<7>")}
    print(f"built {sorted(built)} in {time.perf_counter() - t0:.1f} s; "
          f"ptxas: {regs}", flush=True)
    libs = {"new": built.get("new"), "parent": built.get("parent")}
    new_umv, new_lu = D._umv, K.lu_solve

    def use(name):
        K._library = libs[name]

    def timed(what, fn, setups, turns, reps):
        ms = {}
        for name in turns:
            setups[name]()
            ms.setdefault(name, []).append(cuda_ms(fn, reps))
        setups["new"]()
        res[what] = ms
        print(f"{what}: {ms} [{card}]", flush=True)

    lib_setups = {name: (lambda name=name: use(name)) for name in libs}
    lib_turns = ("parent", "new", "new", "parent")
    dev = torch.device("cuda", 0)
    res = {"card": card, "ptxas": regs, "reps": args.reps,
           "parent": str(args.parent)}

    if "kernels" in parts:
        # K1 on phase 19's isotropic thermal and beam solves at nstr 32
        use("new")
        p = bench_problem(8, 2048, 20, 32, torch.float32, dev, "cuda")
        pr = p.disort._prepare(*p.args)
        s1 = (pr["ssa_s"], pr["dtau"], pr["b_top_lay"], pr["slope"])
        k1 = lambda: K.stage1_isotropic(*s1, p.disort._ang0)
        pb = extra_problem(500, 64, 20, 32, beam=True, device=dev,
                           kernel="cuda")
        prb = pb.disort._prepare(*pb.args)
        s1b = (prb["ssa_s"], prb["dtau"], prb["b_top_lay"], prb["slope"],
               prb["fbeam"], pb.disort._beam_cosine(prb))
        k1b = lambda: K.stage1_isotropic_beam(*s1b, pb.disort._ang0)
        refs = (k1(), k1b())
        use("parent")
        for what, fn, ref in (("thermal", k1, refs[0]),
                              ("beam", k1b, refs[1])):
            assert all(torch.equal(a, b) for a, b in zip(fn(), ref)), (
                f"K1 {what} of the parent differs from this tree's")
        del refs
        timed("k1_thermal_8x2048x20", k1, lib_setups, lib_turns, args.reps)
        timed("k1_beam_500x64x20", k1b, lib_setups, lib_turns, args.reps)
        del p, pr, s1, pb, prb, s1b
        torch.cuda.empty_cache()

        # aerosol_32str_beam
        p = extra_problem(500, 128, 40, 32, g=0.8, device=dev, kernel="cuda")
        use("new")
        pr = p.disort._prepare(*p.args)
        md = p.disort._solve_mode(pr)
        ang = p.disort._ang0
        sol = md["sol"]
        k4 = lambda sweeps=None: K.stage1_general(
            pr["ssa_s"], pr["pmom_s"], pr["dtau"], pr["b_top_lay"],
            pr["slope"], ang, thermal=False, sweeps=sweeps,
            fbeam=pr["fbeam"], mur=md["mur"], lam0=md["lam0"])
        k2 = lambda: K.bvp_forward(sol.gp, sol.gm, sol.expd, md["dblk"],
                                   pr["albedo"], ang)
        ref4, ref2 = k4(), k2()
        use("parent")
        got = k4()
        assert all(torch.equal(a, b) for a, b in zip(got, ref4)), (
            "K4 of the parent differs from this tree's on aerosol_32str_beam")
        bvp_check(k2(), ref2, "K2 of the parent on aerosol_32str_beam")
        del got, ref4, ref2
        timed("k4_aerosol", k4, lib_setups, lib_turns, args.reps)
        timed("k4_aerosol_0_sweeps", lambda: k4(0), lib_setups, lib_turns,
              args.reps)
        timed("k2_aerosol", k2, lib_setups, lib_turns, args.reps)
        del p, pr, md, sol
        torch.cuda.empty_cache()

        # the radiances at nstr 32: K4 at every mode, K2 on the folded modes
        use("new")
        p = radiance_problem(torch.float32, dev, "cuda",
                             shape=(32, 64, 40, 32))
        ds = p.disort
        pr = ds._prepare(p.prop, p.bc, None)
        modes = ds._modes_batched(pr)
        fgp, fgm, fexpd, dblk, alb = modes["fold"]
        ang0 = ds._ang0
        zero = torch.zeros_like(pr["ssa_s"])
        lam00 = lepoly(pr["umu0"], 0,
                       ang0.lam_tables.shape[0] - 1).contiguous()
        calls = [(pr["b_top_lay"], pr["slope"], ang0, lam00)] + [
            (zero, zero, ds._angles(m), l0)
            for m, l0 in zip(modes["ms"], modes["lam0"])]

        def k4_modes():
            return tuple(t for bt, sl, a, l0 in calls
                         for t in K.stage1_general(
                             pr["ssa_s"], pr["pmom_s"], pr["dtau"], bt, sl,
                             a, thermal=False, fbeam=pr["fbeam"],
                             mur=modes["mur"], lam0=l0))

        k2f = lambda: K.bvp_forward(fgp, fgm, fexpd, dblk, alb, ang0)
        ref4, ref2 = k4_modes(), k2f()
        use("parent")
        got = k4_modes()
        assert all(torch.equal(a, b) for a, b in zip(got, ref4)), (
            "K4 of the parent differs from this tree's on the radiance modes")
        bvp_check(k2f(), ref2, "K2 of the parent on the folded modes")
        del got, ref4, ref2
        timed("k4_radiance_modes", k4_modes, lib_setups, lib_turns,
              args.reps)
        timed("k2_folded", k2f, lib_setups, lib_turns, args.reps)
        del p, ds, pr, modes, fgp, fgm, fexpd, dblk, alb, calls, zero
        torch.cuda.empty_cache()

    if "k5" in parts:
        # K5 on the inputs of phase 19's five paths
        use("new")
        for what, make, fold in (
                ("k5_iso_thermal_8x2048x20_nstr32", lambda: bench_problem(
                    8, 2048, 20, 32, torch.float32, dev, "cuda"), False),
                ("k5_aerosol_32x128x20_nstr22", lambda: extra_problem(
                    32, 128, 20, 22, g=0.8, device=dev, kernel="cuda"),
                 False),
                ("k5_iso_beam_500x64x20_nstr32", lambda: extra_problem(
                    500, 64, 20, 32, beam=True, device=dev, kernel="cuda"),
                 False),
                ("k5_aerosol_32str_beam_500x128x40", lambda: extra_problem(
                    500, 128, 40, 32, g=0.8, device=dev, kernel="cuda"),
                 False),
                ("k5_radiances_folded_32x64x40_nstr32",
                 lambda: radiance_problem(torch.float32, dev, "cuda",
                                          shape=(32, 64, 40, 32)), True)):
            p = make()
            ds = p.disort
            if fold:
                modes = ds._modes_batched(ds._prepare(p.prop, p.bc, None))
                fgp, fgm, fexpd, dblk, alb = modes["fold"]
                P, g = K.bvp_forward(fgp, fgm, fexpd, dblk, alb, ds._ang0)
                a5 = (fgp, fgm, fexpd, P, g, ds._ang0)
                del modes, dblk, alb
            else:
                md = ds._solve_mode(ds._prepare(*p.args))
                sol = md["sol"]
                a5 = (sol.gp, sol.gm, sol.expd, md["P"], md["g"], ds._ang0)
                del md, sol
            k5 = lambda: K.bvp_backward(*a5)
            ref = k5()
            use("parent")
            got = k5()
            bvp_check(got, ref, f"K5 of the parent on {what}")
            res[what + "_bit_equal_to_new"] = all(
                bool(torch.equal(x, y)) for x, y in zip(got, ref))
            del got, ref
            timed(what, k5, lib_setups, lib_turns, args.reps)
            del p, ds, a5, k5
            torch.cuda.empty_cache()

    if "k2_mid" in parts:
        # K2 on the inputs of phase 20's paths
        for nstr in (10, 12, 14):
            use("new")
            p = extra_problem(500, 128, 40, nstr, g=0.8, device=dev,
                              kernel="cuda")
            ds = p.disort
            pr = ds._prepare(*p.args)
            md = ds._solve_mode(pr)
            sol = md["sol"]
            a2 = (sol.gp, sol.gm, sol.expd, md["dblk"], pr["albedo"],
                  ds._ang0)
            near = resonance_margin(md) < RESONANCE_MARGIN
            del pr, md, sol
            k2 = lambda: K.bvp_forward(*a2)
            ref = k2()
            use("parent")
            got = k2()
            what = f"k2_aerosol_500x128x40_nstr{nstr}"
            bvp_check([x[..., ~near] for x in got],
                      [y[..., ~near] for y in ref],
                      f"K2 of the parent on {what}, away from a resonance")
            err = near_err(got, ref, near) if bool(near.any()) else 0.0
            assert err <= NEAR_RESONANCE_TOL, (what, err)
            res[what + "_bit_equal_to_new"] = all(
                bool(torch.equal(x, y)) for x, y in zip(got, ref))
            del got, ref
            timed(what, k2, lib_setups, lib_turns, args.reps)
            del p, ds, a2, near, k2
            torch.cuda.empty_cache()

    if "steps" in parts:
        old_umv = parent_function(args.parent / DISORT / "solver.py", "_umv",
                                  solver)

        def setup(name, umv):
            def go():
                use(name)
                D._umv = umv
            return go

        setups = {"parent": setup("parent", old_umv),
                  "parent_glue": setup("new", old_umv),
                  "new": setup("new", new_umv)}
        turns = ("parent", "parent_glue", "new", "new", "parent_glue",
                 "parent")
        for what, make, radiances in (
                ("step_iso_thermal_8x2048x20_nstr32", lambda: bench_problem(
                    8, 2048, 20, 32, torch.float32, dev, "cuda"), False),
                ("step_iso_beam_500x64x20_nstr32", lambda: extra_problem(
                    500, 64, 20, 32, beam=True, device=dev, kernel="cuda"),
                 False),
                ("step_aerosol_32str_beam_500x128x40", lambda: extra_problem(
                    500, 128, 40, 32, g=0.8, device=dev, kernel="cuda"),
                 False),
                ("step_radiances_32x64x40_nstr32", lambda: radiance_problem(
                    torch.float32, dev, "cuda", shape=(32, 64, 40, 32)),
                 True),
                ("step_aerosol_16str_beam_500x128x40", lambda: extra_problem(
                    500, 128, 40, 16, g=0.8, device=dev, kernel="cuda"),
                 False),
                ("step_radiances_8str_32x512x40", lambda: radiance_problem(
                    torch.float32, dev, "cuda"), True)):
            p = make()
            if radiances:
                fn = lambda: p.disort.intensities(p.prop, p.bc)["uu"]
            else:
                fn = lambda: p.disort.forward(*p.args)
            setups["new"]()
            ref = fn()
            same = {}
            for name in ("parent", "parent_glue"):
                setups[name]()
                same[name] = bool(torch.equal(fn(), ref))
            del ref
            timed(what, fn, setups, turns, args.reps)
            res[what + "_bit_equal_to_new"] = same
            del p, fn
            torch.cuda.empty_cache()

    if "plain_lu" in parts:
        old_lu = parent_function(args.parent / DISORT / "linsolve.py",
                                 "lu_solve", linsolve)

        def setup_lu(lu):
            def go():
                K.lu_solve = lu
            return go

        use("new")
        p = bench_problem(8, 2048, 20, 32, torch.float32, dev, "cuda")
        pr = p.disort._prepare(*p.args)
        md = p.disort._solve_mode(pr)
        sol = md["sol"]
        k2p = lambda: K.bvp_forward_plain(sol.gp, sol.gm, sol.expd,
                                          md["dblk"], pr["albedo"],
                                          p.disort._ang0)
        setups = {"parent": setup_lu(old_lu), "new": setup_lu(new_lu)}
        ref = k2p()
        setups["parent"]()
        res["plain_k2_bit_equal_to_new"] = all(
            bool(torch.equal(a, b)) for a, b in zip(k2p(), ref))
        del ref
        timed("plain_k2_iso_thermal_8x2048x20_nstr32", k2p, setups,
              lib_turns, 1)
        del p, pr, md, sol
        torch.cuda.empty_cache()

    if "big" in parts:
        libs = {"new": built["new_big"], "parent": built["parent_big"]}
        big_part(args, res, libs, timed, lib_setups, lib_turns, dev)
    if "huge" in parts:
        libs = {"new": built["new_huge"],
                "parent": built.get("parent_huge", built["new_huge"])}
        res["huge_parent_has_bodies"] = "parent_huge" in built
        big_part(args, res, libs, timed, lib_setups, lib_turns, dev, "huge")
    if "huge_cycles" in parts:
        for who, name in (("parent", "parent_huge_profile"),
                          ("new", "huge_profile")):
            lb = built.get(name)
            if lb is not None and hasattr(
                    lb.lib, "pyharp_stage1_general_huge_profile"):
                huge_cycles(res, who, lb, dev, card)
    if "global_modes" in parts:
        global_modes(args, res, {"new": built["new_global"],
                                 "parent": built["parent_global"]},
                     timed, dev, card)
    if "k4_trees" in parts:
        k4_trees(res, {name: built[f"trees_{name}"]
                       for name in ("parent", *trees, "new")},
                 timed, dev, card)
    if "k2_cycles" in parts:
        for who in ("parent", "new"):
            k2_cycles(res, who, built[f"k2_profile_{who}"],
                      built["k2_stage1"], dev, card)
    if "k2_trees" in parts:
        k2_trees(res, {name: built[f"k2_trees_{name}"]
                       for name in ("parent", *trees, "new")},
                 built["k2_stage1"], timed, dev, card, args.reps)
    if "big_cycles" in parts:
        for who in ("parent", "new"):
            lb = built["profile" if who == "new" else "parent_profile"]
            if hasattr(lb.lib, "pyharp_stage1_isotropic_big_profile"):
                big_cycles(res, who, lb, dev, card)

    K._library = libs["new"]
    line = json.dumps(res)
    args.out_dir.mkdir(parents=True, exist_ok=True)
    (args.out_dir / "wide_ab.json").write_text(line + "\n")
    print(line)


if __name__ == "__main__":
    main()
