"""Save and restore the tables of attenuators, bands and ``Radiation`` objects
(PyTorch port of ``pyharp_tpu/utils/checkpoint.py``).

State is a flat ``{path: array}`` mapping in a compressed ``.npz``: no
pickling, host side only.  The paths are the JAX package's leaf paths,
``<band>/<attenuator>/<leaf>`` (``b1/s8/kdata``), and the port's buffer
names are the JAX leaf names (``convert.RFM_LEAVES``), so a file saved by
either package loads into the other.  ``None`` leaves (an RFM's
``weights`` without ck) are no state on either side.  An attenuator
without buffers (the analytic clouds, Freedman, the radio absorbers)
contributes nothing.

The sharded array files of :func:`save_array_sharded` use the JAX
package's JSON index, so files written by either package load in the
other.
"""

from __future__ import annotations

import glob
import json
import os
from typing import Any, Mapping

import numpy as np
import torch


def _buffers(module: Any):
    """``(key, owner, name, tensor)`` for each tensor buffer, the key with
    ``/`` between nested names."""
    if not isinstance(module, torch.nn.Module):
        return
    for key, buf in module.named_buffers():
        owner = module
        *path, name = key.split(".")
        for p in path:
            owner = getattr(owner, p)
        yield "/".join(key.split(".")), owner, name, buf


def state_dict(module: Any, prefix: str = "") -> dict[str, np.ndarray]:
    """A module's array state as ``{path: ndarray}``.

    Accepts an attenuator (an ``nn.Module``), a ``RadiationBand`` (state =
    its attenuators) or a ``Radiation`` (state = its bands).
    """
    out: dict[str, np.ndarray] = {}
    if hasattr(module, "bands"):            # Radiation
        for name, band in module.bands.items():
            out.update(state_dict(band, f"{prefix}{name}/"))
        return out
    if hasattr(module, "attenuators"):      # RadiationBand
        for name, a in module.attenuators.items():
            out.update(state_dict(a, f"{prefix}{name}/"))
        return out
    for key, _, _, buf in _buffers(module):
        out[prefix + key] = buf.detach().cpu().numpy()
    return out


def load_state(module: Any, state: Mapping[str, np.ndarray],
               prefix: str = ""):
    """Replace ``module``'s buffers from ``state`` in place and return it.

    Shapes must match; each buffer keeps its dtype and device, so a
    float32 module restores float32 however the state was saved.  Raises
    ``KeyError`` on a missing key and ``ValueError`` on a shape mismatch.
    """
    if hasattr(module, "bands"):
        for name, band in module.bands.items():
            load_state(band, state, f"{prefix}{name}/")
        return module
    if hasattr(module, "attenuators"):
        for name, a in module.attenuators.items():
            load_state(a, state, f"{prefix}{name}/")
        return module
    new = []
    for key, owner, name, buf in _buffers(module):
        key = prefix + key
        if key not in state:
            raise KeyError(f"checkpoint is missing state for {key!r}")
        arr = np.asarray(state[key])
        if arr.shape != tuple(buf.shape):
            raise ValueError(
                f"shape mismatch for {key!r}: checkpoint {arr.shape} vs "
                f"module {tuple(buf.shape)}")
        new.append((owner, name, torch.tensor(arr, dtype=buf.dtype,
                                              device=buf.device)))
    for owner, name, t in new:
        owner._buffers[name] = t
    return module


def save(path: str, module: Any) -> None:
    """Save a module's state to a compressed ``.npz``."""
    sd = state_dict(module)
    if not sd:
        raise ValueError("module has no array state to save")
    np.savez_compressed(path, **sd)


def load(path: str, module: Any):
    """Restore ``module``'s state from :func:`save` output (either
    package's); returns the module."""
    with np.load(path) as z:
        state = {k: z[k] for k in z.files}
    return load_state(module, state)


# ---------------------------------------------------------------------------
# sharded array IO: each rank writes only its own shard, no gather
# ---------------------------------------------------------------------------

def save_array_sharded(prefix: str, arr, mesh=None, spec=()) -> list[str]:
    """Write this rank's shard of a distributed array.

    ``arr`` is the local shard of a global array laid out over ``mesh``
    (``parallel.RadiationMesh``) by ``spec``, a tuple of mesh axis names or
    ``None`` per dimension (``parallel.band_input_specs``).  This rank
    writes ``<prefix>.p<rank>.s0.npy`` and the index
    ``<prefix>.p<rank>.json`` (the global shape, the dtype, ``process`` =
    the rank, and the shard's ``[start, stop)`` per dimension); a shard
    that a mesh axis outside ``spec`` replicates is written only by the
    rank at index 0 of that axis, and the others write nothing.  Without
    a mesh, one ``<prefix>.npy``.  Returns the paths this rank wrote.
    """
    a = arr.detach().cpu().numpy() if isinstance(arr, torch.Tensor) \
        else np.asarray(arr)
    if mesh is None:
        path = f"{prefix}.npy"
        np.save(path, a)
        return [path]
    if any(mesh.index(ax) != 0 for ax in mesh.axis_names if ax not in spec):
        return []
    spec = tuple(spec) + (None,) * (a.ndim - len(spec))
    index, shape = [], []
    for n, ax in zip(a.shape, spec):
        k = 0 if ax is None else mesh.index(ax)
        index.append([k * n, (k + 1) * n])
        shape.append(n * (1 if ax is None else mesh.size(ax)))
    fn = f"{prefix}.p{mesh.rank}.s0.npy"
    np.save(fn, a)
    meta = {"global_shape": shape, "dtype": str(a.dtype),
            "process": mesh.rank,
            "shards": [{"file": os.path.basename(fn), "index": index}]}
    mpath = f"{prefix}.p{mesh.rank}.json"
    with open(mpath, "w") as f:
        json.dump(meta, f)
    return [fn, mpath]


def load_array_sharded(prefix: str) -> np.ndarray:
    """Assemble the global array from every rank's shard files (host side,
    numpy): all ``<prefix>.p*.json`` indexes in the directory, or the one
    ``<prefix>.npy``.  Raises unless the shards cover the array."""
    if os.path.exists(f"{prefix}.npy"):
        return np.load(f"{prefix}.npy")
    metas = sorted(glob.glob(f"{prefix}.p*.json"))
    if not metas:
        raise FileNotFoundError(f"no shard index files match {prefix}.p*.json")
    with open(metas[0]) as f:
        shape = json.load(f)["global_shape"]
    out = None
    filled = np.zeros(shape, bool)
    dirname = os.path.dirname(os.path.abspath(metas[0]))
    for mpath in metas:
        with open(mpath) as f:
            meta = json.load(f)
        if meta["global_shape"] != shape:
            raise ValueError(f"inconsistent global shapes under {prefix}")
        if out is None:
            out = np.zeros(shape, np.dtype(meta["dtype"]))
        for rec in meta["shards"]:
            sl = tuple(slice(a, b) for a, b in rec["index"])
            out[sl] = np.load(os.path.join(dirname, rec["file"]))
            filled[sl] = True
    if not bool(filled.all()):
        raise ValueError(
            f"shard files under {prefix} do not cover the global array "
            "(gather all ranks' files first)")
    return out
