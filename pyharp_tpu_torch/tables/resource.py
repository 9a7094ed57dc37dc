"""Resource lookup (port of ``pyharp_tpu/tables/resource.py``).

A search path of directories: the working directory and then the
repository's ``data/`` directory, unless the caller sets another list
(the package data directory always stays last) or adds to it.  ``~`` is
expanded and absolute paths pass through.
"""

from __future__ import annotations

import os
import threading
from pathlib import Path

_lock = threading.Lock()

_PACKAGE_DATA = Path(__file__).resolve().parents[2] / "data"

_search_paths: list[str] = [".", str(_PACKAGE_DATA)]


def set_search_paths(paths: str | list[str]) -> None:
    """Replace the search path list (a colon-separated string is accepted);
    the package data directory is appended."""
    global _search_paths
    if isinstance(paths, str):
        paths = [p for p in paths.split(":") if p]
    with _lock:
        _search_paths = list(paths) + [str(_PACKAGE_DATA)]


def get_search_paths() -> list[str]:
    with _lock:
        return list(_search_paths)


def add_resource_directory(path: str, prepend: bool = True) -> None:
    """Put ``path`` first on the search path, or last with ``prepend=False``."""
    with _lock:
        if prepend:
            _search_paths.insert(0, path)
        else:
            _search_paths.append(path)


def find_resource(filename: str) -> str:
    """Resolve ``filename``: ``~`` expansion, absolute paths as they are,
    otherwise the first match on the search path."""
    filename = os.path.expanduser(filename)
    if os.path.isabs(filename):
        if os.path.exists(filename):
            return filename
        raise FileNotFoundError(filename)
    paths = get_search_paths()
    for d in paths:
        cand = os.path.join(d, filename)
        if os.path.exists(cand):
            return cand
    raise FileNotFoundError(
        f"Could not find resource {filename!r} on search path {paths!r}. "
        "Add its directory with pyharp_tpu_torch.add_resource_directory(...)")
