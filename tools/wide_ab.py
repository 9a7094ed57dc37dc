"""Time K4 and K2 at N = 16 (nstr 32) against another tree's bodies, in
turns, on the card.

    git archive <commit> pyharp_tpu_torch/rt/disort/csrc | tar -x -C _checkout/parent
    python3 tools/wide_ab.py --parent _checkout/parent

Builds this tree's kernel library (``kernels.build``) and, in parallel,
the parent tree's ``stage1_general_wide.cu`` and ``bvp_forward_wide.cu``
into a library of their own, and prints each body's ptxas report.  Then,
on the inputs of aerosol_32str_beam (500 x 128 x 40, nstr 32, HG g = 0.8,
a beam: K4 once, K2 once) and of the radiances at nstr 32 (32 x 64 x 40:
K4 at each of the 32 modes, K2 on the 31 folded modes), it checks the
parent's bodies against this tree's (K4 bit-equal, K2 within the BVP
bound ``|err| <= 3e-5 max|ref| + 3e-4 |ref|``) and times each over
``--reps`` calls with CUDA events, in the order parent, this tree, this
tree, parent.  K4 is also timed without its Jacobi sweeps.  One JSON line
goes to stdout and to ``wide_ab.json`` in ``--out-dir`` (the build
directory by default).  Needs a CUDA card; raises without one.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import subprocess
import sys
import time
from pathlib import Path

REPO = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO))

WIDE = {"stage1_general_wide.cu": "pyharp_stage1_general_wide",
        "bvp_forward_wide.cu": "pyharp_bvp_forward_wide"}


class Swapped:
    """The kernel library with its wide entry points taken from another
    build; the wrappers call ``build().call`` and so go through it."""

    def __init__(self, base, entries: dict):
        self.base = base
        self.entries = entries  # entry name -> ctypes function

    def call(self, name, *args):
        fn = self.entries.get(name)
        if fn is None:
            return self.base.call(name, *args)
        rc = fn(*args)
        if rc != 0:
            raise RuntimeError(f"{name}: kernel launch failed: {rc}")


def start_build(K, src: Path, out: Path):
    out.parent.mkdir(parents=True, exist_ok=True)
    cmd = [K._nvcc(), *K.NVCC_FLAGS, *K.SOURCES[src.name], "-shared", "-o",
           str(out), str(src)]
    return subprocess.Popen(cmd, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--parent", type=Path, required=True)
    ap.add_argument("--reps", type=int, default=3)
    ap.add_argument("--out-dir", type=Path,
                    default=REPO / "pyharp_tpu_torch" / "_build" / "ab")
    args = ap.parse_args()

    import torch

    if not torch.cuda.is_available():
        raise SystemExit("wide_ab: needs a CUDA card")
    from chip_smoke import bvp_check, cuda_ms, ptxas_summary, run
    from pyharp_tpu_torch.bench.problems import extra_problem, radiance_problem
    from pyharp_tpu_torch.rt.disort import kernels as K
    from pyharp_tpu_torch.rt.disort.legendre import lepoly

    card = run(["nvidia-smi", "--query-gpu=name,power.limit",
                "--format=csv,noheader"]).splitlines()[0]
    build_dir = REPO / "pyharp_tpu_torch" / "_build" / "ab"
    procs = {}
    for src in WIDE:
        so = build_dir / f"parent_{Path(src).stem}.so"
        procs[src] = (so, start_build(
            K, args.parent / "pyharp_tpu_torch/rt/disort/csrc" / src, so))
    t0 = time.perf_counter()
    lib = K.build()
    regs = {f"new:{k}": v for k, v in ptxas_summary(lib.ptxas_log).items()
            if "wide" in k}
    entries = {}
    for src, (so, proc) in procs.items():
        log = proc.communicate()[0]
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for the parent's {src}:\n{log}")
        regs.update({f"parent:{k}": v for k, v in ptxas_summary(log).items()})
        fn = getattr(ctypes.CDLL(str(so)), WIDE[src])
        fn.argtypes = K._SIGNATURES[WIDE[src]]
        fn.restype = ctypes.c_int
        entries[WIDE[src]] = fn
    print(f"built in {time.perf_counter() - t0:.1f} s; ptxas: {regs}",
          flush=True)
    libs = {"new": lib, "parent": Swapped(lib, entries)}
    turns = ("parent", "new", "new", "parent")

    def use(name):
        K._library = libs[name]

    def timed(what, fn):
        ms = {}
        for name in turns:
            use(name)
            ms.setdefault(name, []).append(cuda_ms(fn, args.reps))
        res[what] = ms
        print(f"{what}: {ms} [{card}]", flush=True)

    dev = torch.device("cuda", 0)
    res = {"card": card, "ptxas": regs, "reps": args.reps}

    # aerosol_32str_beam
    p = extra_problem(500, 128, 40, 32, g=0.8, device=dev, kernel="cuda")
    use("new")
    pr = p.disort._prepare(*p.args)
    md = p.disort._solve_mode(pr)
    ang = p.disort._ang0
    sol = md["sol"]
    k4 = lambda sweeps=None: K.stage1_general(
        pr["ssa_s"], pr["pmom_s"], pr["dtau"], pr["b_top_lay"], pr["slope"],
        ang, thermal=False, sweeps=sweeps, fbeam=pr["fbeam"], mur=md["mur"],
        lam0=md["lam0"])
    k2 = lambda: K.bvp_forward(sol.gp, sol.gm, sol.expd, md["dblk"],
                               pr["albedo"], ang)
    ref4, ref2 = k4(), k2()
    use("parent")
    got = k4()
    assert all(torch.equal(a, b) for a, b in zip(got, ref4)), (
        "K4 of the parent differs from this tree's on aerosol_32str_beam")
    bvp_check(k2(), ref2, "K2 of the parent on aerosol_32str_beam")
    del got, ref4, ref2
    timed("k4_aerosol", k4)
    timed("k4_aerosol_0_sweeps", lambda: k4(0))
    timed("k2_aerosol", k2)
    del p, pr, md, sol
    torch.cuda.empty_cache()

    # the radiances at nstr 32: K4 at every mode, K2 on the folded modes
    use("new")
    p = radiance_problem(torch.float32, dev, "cuda", shape=(32, 64, 40, 32))
    ds = p.disort
    pr = ds._prepare(p.prop, p.bc, None)
    modes = ds._modes_batched(pr)
    fgp, fgm, fexpd, dblk, alb = modes["fold"]
    ang0 = ds._ang0
    zero = torch.zeros_like(pr["ssa_s"])
    lam00 = lepoly(pr["umu0"], 0, ang0.lam_tables.shape[0] - 1).contiguous()
    calls = [(pr["b_top_lay"], pr["slope"], ang0, lam00)] + [
        (zero, zero, ds._angles(m), l0)
        for m, l0 in zip(modes["ms"], modes["lam0"])]

    def k4_modes():
        return tuple(t for bt, sl, a, l0 in calls
                     for t in K.stage1_general(
                         pr["ssa_s"], pr["pmom_s"], pr["dtau"], bt, sl, a,
                         thermal=False, fbeam=pr["fbeam"], mur=modes["mur"],
                         lam0=l0))

    k2f = lambda: K.bvp_forward(fgp, fgm, fexpd, dblk, alb, ang0)
    ref4, ref2 = k4_modes(), k2f()
    use("parent")
    got = k4_modes()
    assert all(torch.equal(a, b) for a, b in zip(got, ref4)), (
        "K4 of the parent differs from this tree's on the radiance modes")
    bvp_check(k2f(), ref2, "K2 of the parent on the folded modes")
    del got, ref4, ref2
    timed("k4_radiance_modes", k4_modes)
    timed("k2_folded", k2f)
    K._library = lib
    line = json.dumps(res)
    args.out_dir.mkdir(parents=True, exist_ok=True)
    (args.out_dir / "wide_ab.json").write_text(line + "\n")
    print(line)


if __name__ == "__main__":
    main()
