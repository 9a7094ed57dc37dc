"""A float32 numpy model of K2's cluster body at N > 64
(``csrc/bvp_forward_global.cu``), held to the plain version's bits, and
its sizing (``kernels.cluster_blocks``, the mirror of the source's).

A column runs on a cluster of C blocks.  Column j of its 2N x (3N + 1)
system lives in block j mod C.  Each elimination step the block that owns
column col finds the plain bubble's records of that column over the row
sets (``record_bits_global``), rotates the column as the bubble's swaps
do, forms f_r = a_r,col (1 / a_col,col) for the rows below the pivot and
writes f and the record words into buffer col mod 3 of every block; each
block then rotates the rows of its own columns right of col by the words
it was sent and takes a_rj - f_r a_col,j, the owner of column col + 1
taking that column first and searching it while its other warps update
the rest (which warp moves an entry does not change it).  Back
substitution gives each right-hand side to the block that holds it, the
rows of U gathered from the blocks of their columns, each sum in
ascending column order; the build and the carry are those of the bodies
below (``test_torch_big_bvp``'s ``big_forward``).  Every operation is the
plain version's, so the model and the body (built with --fmad=false) give
``bvp_forward_plain``'s bits; ``chip_smoke.py`` phase 23 asserts them on
the card at nstr 130, 200, 256, 258.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

from pyharp_tpu_torch.rt.disort import kernels as K

from . import test_torch_big_bvp as big
from .test_torch_global_bvp import _iso_layer_inputs, record_bits_global

F32 = np.float32


@pytest.fixture(autouse=True)
def one_thread():
    """One intra-op thread: the tensors here are mid-sized, and with
    several test processes on the machine their threads contend."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _rotate_rows(S, col: int, bits) -> None:
    """The bubble's swaps of row col with each record (``bits``, row order)
    on the columns ``S`` ``(rows, columns)``, in place."""
    recs = np.flatnonzero(bits)
    if recs.size == 0:
        return
    v = S[col].copy()
    for r in recs:
        x = S[r].copy()
        S[r] = v
        v = x
    S[col] = v


class Block:
    """One block of the cluster: its columns j = rank (mod C) (``sys``,
    column-major as in shared memory) and its three buffers of f and of
    the record words."""

    def __init__(self, A, rank: int, C: int):
        self.cols = np.arange(rank, A.shape[1], C)
        self.sys = A[:, rank::C].copy()
        self.f = [None] * 3
        self.words = [None] * 3

    def local(self, j: int) -> int:
        return int(np.flatnonzero(self.cols == j)[0])


def cluster_block_lu(A, m: int, nq: int, C: int) -> None:
    """The cluster body's elimination and back substitution in float32 on
    one column's system ``A`` ``(m, m + nq)`` over C blocks, in place."""
    blocks = [Block(A, r, C) for r in range(C)]

    def pivot(kk: int) -> None:
        """The owner of column kk: its records, the column rotated, f and
        the words into buffer kk mod 3 of every block."""
        own = blocks[kk % C]
        cp = own.sys[:, own.local(kk)]
        bits = record_bits_global(cp.copy(), kk, m)[:m]
        _rotate_rows(cp[:, None], kk, bits)
        inv = F32(1.0) / cp[kk]
        f = cp * inv                        # rows below kk are read
        for blk in blocks:
            blk.f[kk % 3] = f.copy()
            blk.words[kk % 3] = bits.copy()

    def step(blk: Block, k: int, sel) -> None:
        """Step k on the block's columns ``sel`` (local indices), from
        its own buffers."""
        if len(sel) == 0:
            return
        S = blk.sys[:, sel]
        _rotate_rows(S, k, blk.words[k % 3])
        S[k + 1:] = S[k + 1:] - blk.f[k % 3][k + 1:, None] * S[k][None]
        blk.sys[:, sel] = S

    with np.errstate(all="ignore"):
        pivot(0)
        for k in range(m - 1):
            kk = k + 1
            look = kk + 1 < m
            if look:                        # the owner of kk: that column first
                owner = blocks[kk % C]
                step(owner, k, [owner.local(kk)])
                pivot(kk)
            for blk in blocks:
                sel = [u for u, j in enumerate(blk.cols)
                       if j > k and not (look and j == kk)]
                step(blk, k, sel)
        for blk in blocks:                  # the system as the blocks hold it
            A[:, blk.cols] = blk.sys
        for i in range(m - 1, -1, -1):      # each block's right-hand sides
            acc = A[i, m:].copy()
            for c in range(i + 1, m):
                acc = acc - A[i, c] * A[c, m:]
            A[i, m:] = acc / A[i, i]


@pytest.mark.parametrize("nstr", (130, 258))
def test_cluster_forward_is_the_plain_forward(nstr, monkeypatch):
    """Column by column, the cluster body (C blocks as the sizing gives at
    N = 65 and 129, and 8 at N = 129) gives ``bvp_forward_plain``'s float32
    bits, the Lambertian fold on the last layer included."""
    N = nstr // 2
    ins, ang = _iso_layer_inputs(nstr, L=2, B=1, seed=2100 + nstr)
    wmu = (ang.w * ang.mu).astype(F32)
    want = K.bvp_forward_plain(*ins, ang)
    for C in sorted({K.cluster_blocks(N), 8}):
        monkeypatch.setattr(big, "block_lu",
                            lambda A, m, nq: cluster_block_lu(A, m, nq, C))
        got = big.big_forward(*(x.numpy() for x in ins), wmu)
        for x, w in zip(got, want):
            assert np.isfinite(x).all()
            np.testing.assert_array_equal(x, w.numpy(), err_msg=f"C = {C}")


@pytest.mark.parametrize("nr", [130, 258])
def test_cluster_block_lu_is_lu_solve(nr):
    """The cluster's elimination over 2, 4 and 8 blocks, on drawn float32
    systems of 130 and 258 rows with tied entries and 9 right-hand sides,
    gives the plain ``lu_solve``'s bits."""
    from pyharp_tpu_torch.rt.disort.linsolve import lu_solve

    rng = np.random.default_rng(nr)
    nq = 9
    A = rng.choice(np.array([0.0, 1.0, -1.0, 0.5, 2.0, -3.0], F32),
                   (nr, nr)) + np.eye(nr, dtype=F32) * F32(0.25)
    A[:, : nr // 2] += rng.standard_normal((nr, nr // 2)).astype(F32)
    rhs = rng.standard_normal((nr, nq)).astype(F32)
    want = lu_solve(torch.from_numpy(A)[..., None],
                    torch.from_numpy(rhs)[..., None]).numpy()[..., 0]
    for C in (2, 4, 8):
        sys_ = np.concatenate([A, rhs], axis=1)
        cluster_block_lu(sys_, nr, nq, C)
        np.testing.assert_array_equal(sys_[:, nr:], want, err_msg=f"C {C}")


def test_cluster_sizes_at_the_checked_stream_counts():
    """The sizing gives one block at N = 65 (nstr 130), two at 100, four
    at 128 and 129, eight at 150, each within a block's 227 KB and none
    smaller fitting."""
    for N, C in ((65, 1), (100, 2), (128, 4), (129, 4), (150, 8)):
        assert K.cluster_blocks(N) == C, N
        assert 4 * K.cluster_floats(N, C) <= K.CLUSTER_SMEM_LIMIT
        if C > 1:
            assert 4 * K.cluster_floats(N, C // 2) > K.CLUSTER_SMEM_LIMIT


@pytest.mark.parametrize("side", ("inside", "outside"))
def test_cluster_reach_at_both_sides_of_its_edge(side):
    """The reach is N = 170 (nstr 340): there a cluster of 8 blocks holds
    the column in 231,164 B a block; at N = 171 no cluster of the portable
    sizes does (233,896 B a block at 8), and the slab body takes it."""
    reach = K.cluster_reach()
    assert reach == 170
    if side == "inside":
        assert K.cluster_blocks(reach) == 8
        assert 4 * K.cluster_floats(reach, 8) == 231164
        assert 4 * K.cluster_floats(reach, 8) <= K.CLUSTER_SMEM_LIMIT
        assert all(K.cluster_blocks(N) for N in range(K.HUGE_MAX_N + 1,
                                                      reach + 1))
    else:
        assert K.cluster_blocks(reach + 1) == 0
        assert 4 * K.cluster_floats(reach + 1, 8) == 233896
        assert 4 * K.cluster_floats(reach + 1, 8) > K.CLUSTER_SMEM_LIMIT
        assert not any(K.cluster_blocks(N) for N in range(reach + 1, 400))
