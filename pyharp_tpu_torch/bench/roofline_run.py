"""Each kernel against the H100's roofline (PyTorch port of
``pyharp_tpu/bench/roofline_run.py``).

    python -m pyharp_tpu_torch.bench.roofline_run [--ncol 8192] [--device cuda]

A kernel's bound is the least time the card could take for its work: the
larger of its bytes (each input read once, each output stored once) over
the HBM rate and its float32 operations over the float32 rate, the H100
SXM's published peaks (``profile.PEAKS``).  Both are counted from the
shapes (:func:`kernel_bytes`, :func:`kernel_flops`), so a bound means the
same work whatever implements it; :func:`tensor_bytes` counts the same
bytes from the tensors a call reads and returns.

As the JAX runner does, the two-kernel BVP gets a second ceiling, the
min-bytes floor (:func:`bvp_min_bytes`): gp, gm, E, dblk, tp and tm read
once and the level sums written once, the P/g round trip between the two
kernels left out.  K6, the single-pass BVP, is the kernel built to reach
it.

Not ported: the JAX runner's issue model (``issue_count_per_layer``: the
per-layer equations of the BVP counted with ``jax.make_jaxpr``, at 1024
VPU lanes x 0.94 GHz).  It models the TPU's vector unit and means nothing
on the H100, where the operation bound above takes its place.

``main`` times, at the bench shape (8 x 8192 x 100, nstr 8), the rows of
the JAX runner: stage 1 general with 8 moments (K4), stage 1 isotropic
(K1), the BVP to (a, b) (K2 + K5) and to the level sums (K2 + K3), and
adds K6 in both modes; it prints a markdown table and one JSON line.
"""

from __future__ import annotations

import argparse
import functools
import json

import torch

from ..core.device import DEFAULT_DEVICE, resolve_device
from ..rt.disort import kernels as K
from ..rt.disort.solver import bvp_rhs, make_static_angles
from .problems import stage_inputs
from .profile import PEAKS, card_line, measure, timed_calls

F32 = 4
PEAK = PEAKS["h100"]


def _lu_flops(n: int, k: int) -> int:
    """Flops of one n x n pivoted LU solve with k right-hand sides."""
    elim = sum((n - c - 1) * (1 + 2 * (n - c - 1 + k)) for c in range(n))
    return elim + n + k * n * n


def kernel_flops(name: str, N: int, L: int, B: int, *, nmom: int = 0,
                 sweeps: int = 0, thermal: bool = True,
                 beam: bool = False, flux_only: bool = False) -> int:
    """Float32 operations of one call, counted from the algorithm's terms
    (each add, multiply, divide, square root or compare one operation; the
    selects of pivoting and clamps not counted), so a lower bound of the
    work the kernel does on these inputs."""
    if name in ("stage1_isotropic", "stage1_isotropic_beam"):
        bis = 10 if N <= 4 else 12
        per = (N * (bis * (6 * N + 3) + 2 * (6 * N + 9))
               + N * (N * max(N - 2, 0) + 10 * N + 4) + 3 * N)
        if N > K.NARROW_MAX_N:
            # per root: the midpoint and K.WIDE_BISECT sums s - ssa sum c v
            # (a subtract, divide, multiply and add a term), two Newton
            # steps, the eigenvector and its normalisation
            per = (N * ((1 + K.WIDE_BISECT) * (4 * N + 3) + 2 * (6 * N + 9)
                        + 15 * N + 6) + 3 * N)
        if name.endswith("_beam"):
            per += _lu_flops(N, 1) + N * N + 6 * N + 2 * N * N + 2 * N + 7 * N + 4
        return per * L * B
    if name == "stage1_general":
        nuse = N * N * 2 + N * (N + 1) // 2 + (N * N if thermal or beam else 0)
        terms = min(nmom, 2 * N - 1) // 2 + 1          # per parity
        per = (2 * terms * nuse + 6 * (N * (N + 1) // 2 + N * N)
               + N ** 3 // 3 + 2 * N + 2 * N * N * (N + 1) + 2 * N * N
               + sweeps * N * (N - 1) // 2 * (22 + 6 * (N - 2) + 6 * N)
               + 2 * N + N * N * (N + 2) + 3 * N * N + N * (2 * N * N + 3)
               + N * (6 * N + 2) + 2 * N)
        if thermal:
            per += 2 * _lu_flops(N, 1) + 6 * N
        if beam:
            per += (2 * N * (4 * N + 2) + 8 * N + N * (2 * N + 4)
                    + _lu_flops(N, 1) + 7 * N + 4 * N * N + 5 * N)
        return per * L * B
    M = 2 * N
    if name == "bvp_fused":     # K2's forward, then K3's sums or K5's sweep
        back = "bvp_backward_flux" if flux_only else "bvp_backward"
        return (kernel_flops("bvp_forward", N, L, B)
                + kernel_flops(back, N, L, B))
    if name == "bvp_forward":
        per = 4 * N ** 3 + 4 * N * N + _lu_flops(M, N + 1) + 4 * N * N * (N + 1)
        return per * L * B
    if name == "bvp_backward_flux":
        return (14 * N * N + 4 * N) * L * B
    if name == "bvp_backward":
        return 9 * N * N * L * B
    raise KeyError(name)


def kernel_bytes(name: str, N: int, L: int, B: int, *, nmom: int = 0,
                 thermal: bool = True, beam: bool = False,
                 flux_only: bool = False, nlam0: int | None = None) -> int:
    """Bytes one call must move, from the shapes: each float32 input read
    once and each output stored once (``tensor_bytes`` of the call's
    tensors).  ``nmom``: K4's moments; ``thermal`` and ``beam``: K4's
    sources (without a thermal source K4 reads no btop, slope and stores no
    particular); ``nlam0``: the rows of K4's Lam_l(mu0) table (nmom + 1
    unless given); ``flux_only``: K6's mode (the (a, b) mode reads no tp,
    tm)."""
    LB, sq, vec = L * B, N * N * L * B, N * L * B
    if name in ("stage1_isotropic", "stage1_isotropic_beam"):
        n = 4 * LB + 2 * sq + 5 * vec                 # ssa dtau btop slope
        if name.endswith("_beam"):
            n += B + LB + 2 * vec                     # fbeam mur -> zp zm
        return F32 * n
    if name == "stage1_general":
        # ssa pmom dtau -> gp gm lam expd
        n = 2 * LB + nmom * LB + 2 * sq + 2 * vec
        if thermal:
            n += 2 * LB + 3 * vec                 # btop slope -> y0p y0m y1
        if beam:
            nlam0 = nmom + 1 if nlam0 is None else nlam0
            n += B + LB + nlam0 * B + 2 * vec         # fbeam mur lam0 -> zp zm
        return F32 * n
    gpgm_e = 2 * sq + vec
    Pg = 2 * sq + 2 * vec                      # (2N, N, L, B), (2N, L, B)
    if name == "bvp_forward":                          # + dblk albedo -> P g
        return F32 * (gpgm_e + 2 * vec + B + Pg)
    if name == "bvp_backward_flux":                    # + P g tp tm pb -> fl
        return F32 * (gpgm_e + Pg + 2 * vec + 2 * N * B + 2 * LB + 2 * B)
    if name == "bvp_backward":                         # + P g -> a b
        return F32 * (gpgm_e + Pg + 2 * vec)
    if name == "bvp_fused":                            # + dblk albedo [tp tm]
        n = gpgm_e + 2 * vec + B
        n += 2 * vec + 2 * LB + 2 * N * B if flux_only else 2 * vec
        return F32 * n
    raise KeyError(name)


def bvp_min_bytes(N: int, L: int, B: int) -> int:
    """The two-kernel BVP's min-bytes floor (JAX ``kernel_counts``'s third
    count): gp, gm, E, dblk, tp, tm read once, the level sums written
    once; no P/g round trip."""
    return L * B * F32 * ((2 * N * N + N + 2 * N + 2 * N) + 2)


def stored_bytes(t: torch.Tensor) -> int:
    """Bytes a kernel stores for the output ``t``: none for a broadcast
    view whose storage holds fewer elements than it shows
    (``kernels.zero_particular``, K4's thermal particular without a thermal
    source), else every element."""
    n = t.numel() * t.element_size()
    return 0 if t.untyped_storage().nbytes() < n else n


def tensor_bytes(reads, outs) -> int:
    """Bytes of a call from its tensors: every element of ``reads`` read
    once, ``stored_bytes`` of each of ``outs``."""
    reads = [t for t in reads if isinstance(t, torch.Tensor)]
    outs = [t for t in outs if isinstance(t, torch.Tensor)]
    return (sum(t.numel() * t.element_size() for t in reads)
            + sum(stored_bytes(t) for t in outs))


def bound(nbytes: float, flops: float) -> tuple[float, str]:
    """``(bound_ms, bound_by)``: the larger of the bytes over the HBM rate
    and the operations over the float32 rate, and which one it is."""
    bytes_ms = nbytes / PEAK["bytes"] * 1e3
    ops_ms = flops / PEAK["flops"] * 1e3
    by = "bytes" if bytes_ms >= ops_ms else "operations"
    return max(bytes_ms, ops_ms), by


def kernel_fn(name: str, plain: bool = False):
    """The kernel wrapper ``name`` of ``kernels``, or its plain version."""
    return getattr(K, name + "_plain" if plain else name)


def _row(name, fn, args, nbytes, flops, min_bytes=None, iters=10,
         plain=None, check=None):
    sec = measure(fn, *args, iters=iters)
    if check is not None:
        check(name, fn(*args), plain(*args))
    bms, by = bound(nbytes, flops)
    rec = dict(name=name, ms=sec * 1e3, bytes=nbytes, flops=flops,
               gbps=nbytes / sec / 1e9, bound_ms=bms, bound_by=by,
               share_of_bound=bms / (sec * 1e3))
    if min_bytes is not None:
        rec["min_bytes"] = min_bytes
        rec["min_bytes_ms"] = min_bytes / PEAK["bytes"] * 1e3
    return rec


def run(ncol: int = 8192, nwave: int = 8, nlyr: int = 100, nstr: int = 8,
        device: torch.device | str = DEFAULT_DEVICE, iters: int = 10,
        check=None) -> list[dict]:
    """The rows of the table, each a dict: ``ms`` (CUDA events on the card,
    the host clock on the CPU), ``bytes``, ``flops``, ``bound_ms``,
    ``bound_by``, ``share_of_bound``, and for the BVP rows the min-bytes
    floor ``min_bytes_ms``.

    ``check(name, got, want)``, where given, is called once per row, in the
    rows' order, with the outputs of the row's call and of the same call
    through the kernels' plain versions on the same inputs (chained as the
    kernels are), for the caller to hold one to the other."""
    dev = resolve_device(device)
    N, L, B = nstr // 2, nlyr, nwave * ncol
    nmom = nstr
    sweeps = K.kernel_sweeps(N)
    ang = make_static_angles(nstr, nstr, 0)
    x = stage_inputs(L, B, nstr, device=dev)
    ssa, pmom, dtau, btop, slope = (x[k] for k in ("ssa", "pmom", "dtau",
                                                   "btop", "slope"))
    rows = [
        _row("stage-1 general, nmom 8 (K4)", K.stage1_general,
             (ssa, pmom, dtau, btop, slope, ang),
             kernel_bytes("stage1_general", N, L, B, nmom=nmom),
             kernel_flops("stage1_general", N, L, B, nmom=nmom,
                          sweeps=sweeps), iters=iters,
             plain=K.stage1_general_plain, check=check),
        _row("stage-1 isotropic (K1)", K.stage1_isotropic,
             (ssa, dtau, btop, slope, ang),
             kernel_bytes("stage1_isotropic", N, L, B),
             kernel_flops("stage1_isotropic", N, L, B), iters=iters,
             plain=K.stage1_isotropic_plain, check=check)]

    # the BVP on K4's outputs, as the JAX runner sets it up
    gp, gm, _, expd, y0p, y0m, y1 = K.stage1_general(ssa, pmom, dtau, btop,
                                                     slope, ang)
    tp, tm = y0p, y0m
    bp, bm = y0p + y1 * dtau[None], y0m + y1 * dtau[None]
    pb_p, pb_m = bp[:, -1].contiguous(), bm[:, -1].contiguous()
    dblk = bvp_rhs(tp, tm, bp, bm, x["ftop"], -pb_p).contiguous()
    alb = x["albedo"]

    def ab(gp, gm, expd, dblk, alb, plain=False):
        P, g = kernel_fn("bvp_forward", plain)(gp, gm, expd, dblk, alb, ang)
        return kernel_fn("bvp_backward", plain)(gp, gm, expd, P, g, ang)

    def flux(gp, gm, expd, dblk, alb, tp, tm, pb_p, pb_m, plain=False):
        P, g = kernel_fn("bvp_forward", plain)(gp, gm, expd, dblk, alb, ang)
        back = kernel_fn("bvp_backward_flux", plain)
        return back(gp, gm, expd, P, g, tp, tm, pb_p, pb_m, ang)

    def fused(*args, flux_only, plain=False):
        return kernel_fn("bvp_fused", plain)(*args, wmu=wmu,
                                             flux_only=flux_only)

    wmu = ang.w * ang.mu
    floor = bvp_min_bytes(N, L, B)
    k2 = (kernel_bytes("bvp_forward", N, L, B),
          kernel_flops("bvp_forward", N, L, B))
    for back, label, fn, args in (
            ("bvp_backward", "BVP (a, b) (K2 + K5)", ab,
             (gp, gm, expd, dblk, alb)),
            ("bvp_backward_flux", "BVP flux (K2 + K3)", flux,
             (gp, gm, expd, dblk, alb, tp, tm, pb_p, pb_m))):
        rows.append(_row(label, fn, args,
                         k2[0] + kernel_bytes(back, N, L, B),
                         k2[1] + kernel_flops(back, N, L, B), floor, iters,
                         functools.partial(fn, plain=True), check))
    if N in K.FUSED_N:
        for flux_only, label in ((False, "(a, b)"), (True, "flux")):
            rows.append(_row(
                f"BVP {label}, single pass (K6)",
                functools.partial(fused, flux_only=flux_only),
                (gp, gm, expd, dblk, alb, tp, tm),
                kernel_bytes("bvp_fused", N, L, B, flux_only=flux_only),
                kernel_flops("bvp_fused", N, L, B, flux_only=flux_only),
                floor, iters,
                functools.partial(fused, flux_only=flux_only, plain=True),
                check))
    return rows


def table(rows: list[dict]) -> str:
    out = ["| kernel | ms | GB/s | bound ms (by) | share of bound | "
           "min-bytes floor ms | x floor |",
           "|---|---|---|---|---|---|---|"]
    for r in rows:
        fl = r.get("min_bytes_ms")
        out.append(
            f"| {r['name']} | {r['ms']:.3f} | {r['gbps']:.1f} | "
            f"{r['bound_ms']:.3f} ({r['bound_by']}) | "
            f"{r['share_of_bound']:.1%} | "
            + (f"{fl:.3f} | {r['ms'] / fl:.2f}x |" if fl else "- | - |"))
    return "\n".join(out)


def main(argv=None, check=None) -> list[dict]:
    """The command line; ``check`` as :func:`run`'s."""
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--ncol", type=int, default=8192)
    ap.add_argument("--nwave", type=int, default=8)
    ap.add_argument("--nlyr", type=int, default=100)
    ap.add_argument("--nstr", type=int, default=8)
    ap.add_argument("--device", default=DEFAULT_DEVICE)
    a = ap.parse_args(argv)
    rows = run(a.ncol, a.nwave, a.nlyr, a.nstr, a.device,
               timed_calls(a.device), check)
    card = card_line(a.device)
    print(f"# ROOFLINE: the port's kernels on {card}\n")
    print(f"Problem: nstr={a.nstr} (N={a.nstr // 2}), nlyr={a.nlyr}, "
          f"batch={a.nwave * a.ncol} ({a.nwave} x {a.ncol}), float32. "
          f"Bounds at the H100 SXM's {PEAK['bytes'] / 1e12:.2f} TB/s and "
          f"{PEAK['flops'] / 1e12:.0f} TFLOP/s (float32); "
          + ("CUDA events." if resolve_device(a.device).type == "cuda"
             else "the host clock (a CPU run: the times are not the card's)."))
    print()
    print(table(rows))
    print()
    print(json.dumps({"card": card, "nstr": a.nstr, "nlyr": a.nlyr,
                      "batch": a.nwave * a.ncol, "rows": rows}))
    return rows


if __name__ == "__main__":
    main()
