"""K4 over the modes of a radiance solve in one call
(``kernels.stage1_general_modes``), on the CPU.

On CPU tensors the wrapper runs the plain version of every mode in one pass;
``test_modes_are_the_per_mode_loop`` holds it, bit for bit, to a call of
``stage1_general`` a mode stacked as ``Disort._modes_batched`` stacked them
(the modes next to the batch axis).  On the card at N > 32 it is one launch
of ``csrc/stage1_general_huge.cu`` (N = 33..64) or
``csrc/stage1_general_global.cu`` (N > 64) whose element index runs over
(mode, layer, column); ``test_folded_launch_addressing`` models that
launch's index decoding (``K4Element`` of ``csrc/general_huge.cuh``), its
table words (``kernels._modes_tables``), its lam0 and its output addressing
in numpy, warp by warp, at N = 33 (a warp an element, the huge body's
grid) and N = 65 (a grid-stride loop over fewer warps than elements, the
global body's), with a stand-in for the body that reads every input an
element reads, and holds every mode's outputs to where the loop and the
stack put them.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

from pyharp_tpu_torch.rt.disort import kernels as K
from pyharp_tpu_torch.rt.disort.legendre import lepoly
from pyharp_tpu_torch.rt.disort.solver import make_static_angles

from .test_torch_wide_k4_team import _inputs

F32 = np.float32


def _modes_inputs(nstr: int, L: int, B: int, ms, seed: int):
    ssa, pmom, dtau, _, _, fbeam, mur, mu0 = _inputs(nstr, L, B, seed)
    angs = [make_static_angles(nstr, nstr, m) for m in ms]
    G = angs[0].lam_tables.shape[0]
    lam0s = [lepoly(mu0, m, G - 1).contiguous() for m in ms]
    return ssa, pmom, dtau, angs, fbeam, mur, lam0s


@pytest.mark.parametrize("nstr, L, B", [(4, 11, 16), (8, 3, 5), (8, 1, 1)])
def test_modes_are_the_per_mode_loop(nstr, L, B):
    """Every mode m = 1..nstr-1 in one call gives the bits of a
    ``stage1_general`` call a mode (no thermal source, a beam), stacked at
    the axis before the batch: gp, gm ``(N, N, L, nm, B)``, lam, expd, zp,
    zm ``(N, L, nm, B)``; lam0 as a list of ``(G, B)`` or one
    ``(nm, G, B)`` tensor alike; no launch counted on the CPU."""
    ms = range(1, nstr)
    ssa, pmom, dtau, angs, fbeam, mur, lam0s = _modes_inputs(nstr, L, B, ms,
                                                             nstr + L)
    zero = torch.zeros_like(ssa)
    outs = [K.stage1_general(ssa, pmom, dtau, zero, zero, a, thermal=False,
                             fbeam=fbeam, mur=mur, lam0=l0)
            for a, l0 in zip(angs, lam0s)]
    want = [torch.stack([o[i] for o in outs], dim=-2)
            for i in (0, 1, 2, 3, 7, 8)]
    K.reset_launches()
    for lam0 in (lam0s, torch.stack(lam0s)):
        got = K.stage1_general_modes(ssa, pmom, dtau, angs, fbeam=fbeam,
                                     mur=mur, lam0s=lam0)
        assert len(got) == len(want)
        N, nm = nstr // 2, len(angs)
        assert got[0].shape == (N, N, L, nm, B)
        assert got[2].shape == (N, L, nm, B)
        for idx, (x, w) in enumerate(zip(got, want)):
            assert torch.equal(x, w), f"output {idx}"
    assert K.stage1_general.launches == 0


def _stand_in(ssa, pmom, dtau, fbeam, mur, lam0, tab, mode, N):
    """A body's outputs from what an element reads: its ssa, dtau, mur,
    fbeam, its column of pmom and of its mode's lam0, its mode's tables and
    m.  ``(gp, gm, lam, expd, zp, zm)``, float32."""
    base = tab[:N * N].reshape(N, N) + F32(1e-3) * F32(mode)
    x = ssa + F32(2.0) * dtau + F32(3.0) * mur + F32(5.0) * fbeam
    x = x + F32(7.0) * pmom.sum(dtype=F32) + F32(11.0) * lam0.sum(dtype=F32)
    mu = tab[-5 * N:-4 * N]
    return (base + x, base - x, mu * x, mu - x, mu * F32(mode) + x,
            tab[N:2 * N] * x)


@pytest.mark.parametrize("N, ms, L, B, warps", [
    (33, (1, 2, 5, 32, 65), 3, 5, None), (65, (1, 64, 129), 2, 3, 7)])
def test_folded_launch_addressing(N, ms, L, B, warps):
    """The folded launch's addressing, modelled: warp w of a launch over
    nm L B elements takes element ef = w (the huge body: a warp an element,
    2 a block, the last block's second warp idle where nm L B is odd) or
    ef = w, w + W, ... (the global body: W resident warps in a grid-stride
    loop); it decodes mode i = ef // (L B), e = ef - i L B, layer = e // B,
    b = e - layer B; reads ssa, dtau, mur at e, fbeam at b, pmom's column
    (layer, :, b), lam0 at i G B + l B + b, its mode's tables through the
    i-th pointer of ``kernels._modes_tables``' words and its m from word
    nm + i; and writes output (r, k) at (r N + k) nm L B + (layer nm + i) B
    + b.  Every mode's outputs land where the per-mode loop and the stack
    put them, every element once."""
    nstr = 2 * N
    ssa, pmom, dtau, angs, fbeam, mur, lam0s = _modes_inputs(nstr, L, B, ms,
                                                             N)
    nm, lb = len(angs), L * B
    G = angs[0].lam_tables.shape[0]
    tabs, words = K._modes_tables(angs, torch.device("cpu"))
    by_ptr = {t.data_ptr(): t.numpy() for t in tabs}
    words = words.numpy()
    lam0 = torch.stack(lam0s).numpy().ravel()
    ssa_f, dtau_f, mur_f = (x.numpy().ravel() for x in (ssa, dtau, mur))
    pm, fb = pmom.numpy(), fbeam.numpy()
    total = nm * lb
    os_ = nm * lb
    flat = [np.full(N * N * os_, np.nan, F32) for _ in range(2)] + [
        np.full(N * os_, np.nan, F32) for _ in range(4)]
    seen = np.zeros(total, int)
    if warps is None:                   # the huge body: 2 warps a block
        grid = (total + 1) // 2
        starts, stride = range(2 * grid), None
    else:                               # the global body: W warps
        grid = (min(warps, total) + 1) // 2
        starts, stride = range(2 * grid), 2 * grid
    for w in starts:
        efs = ([w] if w < total else []) if stride is None else range(
            w, total, stride)
        for ef in efs:
            seen[ef] += 1
            i = ef // lb
            e = ef - i * lb
            layer = e // B
            b = e - layer * B
            o = (layer * nm + i) * B + b
            tab = by_ptr[int(words[i])]
            mode = int(words[nm + i])
            col = lam0[i * G * B + np.arange(G) * B + b]
            outs = _stand_in(ssa_f[e], pm[layer, :, b], dtau_f[e], fb[b],
                             mur_f[e], col, tab, mode, N)
            for x, f in zip(outs, flat):
                idx = np.arange(x.size) * os_ + o
                f[idx] = x.ravel()
    assert (seen == 1).all()
    want = []
    for i, a in enumerate(angs):        # the per-mode loop, then the stack
        tab = K.general_tables(a)
        l0 = lam0s[i].numpy()
        per = [np.zeros((N, N, L, B), F32)] * 2 + [np.zeros((N, L, B), F32)] * 4
        per = [x.copy() for x in per]
        for layer in range(L):
            for b in range(B):
                outs = _stand_in(ssa.numpy()[layer, b], pm[layer, :, b],
                                 dtau.numpy()[layer, b], fb[b],
                                 mur.numpy()[layer, b], l0[:, b], tab, a.m, N)
                for x, y in zip(per, outs):
                    x[..., layer, b] = y
        want.append(per)
    for k in range(6):
        stacked = np.stack([w[k] for w in want], axis=-2)
        got = flat[k].reshape(stacked.shape)
        np.testing.assert_array_equal(got, stacked, err_msg=f"output {k}")
