"""The column/wave sharding over ``torch.distributed`` ranks against the
JAX package's unsharded answer.

Two gloo ranks on the CPU, spawned once for the module, run
``sharded_forward`` and ``sharded_band_flux`` on the (col x wave) meshes
(2, 1) and (1, 2) (``tests/_torch_parallel_worker.py``): thermal with
distinct per-bin edges, a beam and one phase moment, nstr 4.  Their
blocks, written with ``checkpoint.save_array_sharded``, are assembled here
and held to JAX's unsharded float64 ``forward`` and weighted sum within
1e-12 of max|flux| (the same float64 operations on fewer columns or
bins).
"""

import json

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pyharp_tpu.parallel import mesh as jmesh
from pyharp_tpu.parallel import sharded as jsharded
from pyharp_tpu.rt.disort.disort import Disort as JDisort
from pyharp_tpu.rt.disort.disort import DisortOptions as JDisortOptions

from pyharp_tpu_torch.parallel import (band_input_specs, bc_specs,
                                       dryrun_multigpu, init_distributed,
                                       make_radiation_mesh, spawn)
from pyharp_tpu_torch.utils import checkpoint

from . import _torch_parallel_worker as worker

TAGS = [f"{c}x{w}" for c, w in worker.MESHES]


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    """The directory the two ranks wrote their blocks to."""
    out = tmp_path_factory.mktemp("ranks")
    spawn(worker.run, 2, str(out), backend="gloo", device="cpu")
    return out


@pytest.fixture(scope="module")
def reference():
    """JAX's unsharded float64 flux and band flux of the problem."""
    p = worker.problem()
    ds = JDisort(JDisortOptions(**p["options"], kernel="xla"))
    bc = {k: jnp.asarray(v) for k, v in p["bc"].items()}
    flux = np.asarray(ds.forward(jnp.asarray(p["prop"]), bc,
                                 jnp.asarray(p["temf"])))
    return flux, np.einsum("g,g...->...", p["weights"], flux)


def _close(got, want, rel=1e-12):
    assert got.shape == want.shape
    err = np.abs(got - want).max() / np.abs(want).max()
    assert err <= rel, err
    return err


@pytest.mark.parametrize("tag", TAGS)
def test_sharded_forward(ranks, reference, tag):
    _close(checkpoint.load_array_sharded(str(ranks / f"forward_{tag}")),
           reference[0])


@pytest.mark.parametrize("tag", TAGS)
def test_sharded_band_flux(ranks, reference, tag):
    got = checkpoint.load_array_sharded(str(ranks / f"band_{tag}"))
    assert got.shape == (worker.NCOL, worker.NLYR + 1, 2)
    _close(got, reference[1])


def test_wrong_edges_fail_the_comparison(ranks, reference):
    """A wave shard that integrates Planck over the first shard's edges
    misses by far more than the tolerance; with one wave shard the same
    edges are the right ones."""
    wrong = checkpoint.load_array_sharded(str(ranks / "wrong_edges_1x2"))
    err = np.abs(wrong - reference[0]).max() / np.abs(reference[0]).max()
    assert err > 1e-3
    _close(checkpoint.load_array_sharded(str(ranks / "wrong_edges_2x1")),
           reference[0])


@pytest.mark.parametrize("tag", TAGS)
def test_shard_band_inputs(ranks, tag):
    p = worker.problem()
    temf = p["temf"]
    want = dict(conc=np.arange(worker.NCOL * worker.NLYR * 2,
                               dtype=np.float64).reshape(worker.NCOL,
                                                         worker.NLYR, 2),
                albedo=p["bc"]["albedo"], temp=temf[:, :-1],
                wavenumber=np.asarray(worker.WAVE_EDGES[:-1]))
    for name, x in want.items():
        np.testing.assert_array_equal(
            checkpoint.load_array_sharded(str(ranks / f"{name}_{tag}")), x)


def test_refusals(ranks, monkeypatch):
    """A mesh that does not cover the world, and a split that does not
    divide evenly, raise on the ranks; a mesh of more than one rank needs
    a process group; NCCL needs CUDA."""
    with open(ranks / "refusals.json") as f:
        seen = json.load(f)
    assert seen["mesh_size"] == "mesh 2x2 != 2 ranks"
    assert "does not split evenly over 2 'col' shards" in seen["uneven"]
    with pytest.raises(ValueError, match=r"mesh 2x1 != 1 ranks"):
        make_radiation_mesh(2, 1)
    assert make_radiation_mesh().shape == (1, 1)
    assert init_distributed() is None           # one process: a no-op
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="NCCL backend needs CUDA"):
        init_distributed("localhost:1", 2, 0, backend="nccl")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        init_distributed("localhost:1", 2, 0)


def test_specs_match_jax():
    jspecs = jmesh.band_input_specs()
    assert band_input_specs() == {k: tuple(v) for k, v in jspecs.items()}
    p = worker.problem()
    bc = dict(p["bc"], wvnmlo=np.zeros(4), wvnmhi=np.ones(4),
              radius=np.ones((4, 4)), h_lev=np.ones((4, 7)),
              gensrc=np.ones((4, 4, 6, 4)))
    for case in (bc, dict(bc, radius=6.4e6)):
        assert bc_specs(case) == {k: tuple(v) for k, v in
                                  jsharded._bc_specs(case).items()}


def test_dryrun_multigpu_cpu(capfd):
    dryrun_multigpu(2, "cpu")
    assert "dryrun_multigpu: 2 ranks (gloo, cpu), mesh (1, 2)" in \
        capfd.readouterr().out
