"""ASCII table ingestion, host side in numpy (port of
``pyharp_tpu/tables/ascii.py``: comment stripping, whitespace-separated
numeric tables, their row and column counts, header-named columns, the
aMars aerosol profile)."""

from __future__ import annotations

import io

import numpy as np

from .resource import find_resource


def decomment_file(path: str, comment: str = "#") -> str:
    """The file's text with everything from ``comment`` to the end of each
    line removed."""
    out = []
    with open(path) as f:
        for line in f:
            i = line.find(comment)
            if i >= 0:
                line = line[:i] + "\n"
            out.append(line)
    return "".join(out)


def read_data_table(name: str) -> np.ndarray:
    """A whitespace-separated numeric table, comments stripped, as float64
    ``(rows, cols)``."""
    path = find_resource(name)
    data = np.loadtxt(io.StringIO(decomment_file(path)), dtype=np.float64,
                      ndmin=2)
    if data.size == 0:
        raise ValueError(f"Empty file: {path}")
    return data


def get_num_cols(name: str) -> int:
    return read_data_table(name).shape[1]


def get_num_rows(name: str) -> int:
    return read_data_table(name).shape[0]


def read_data_vector(name: str) -> dict[str, np.ndarray]:
    """Column name -> column of a table whose first line names its columns
    (after any ``#``); columns are ``col0, col1, ...`` when the names do
    not match the column count."""
    path = find_resource(name)
    with open(path) as f:
        first = f.readline()
    names = first.lstrip("#").split()
    data = read_data_table(name)
    if len(names) != data.shape[1]:
        names = [f"col{i}" for i in range(data.shape[1])]
    return {n: data[:, i] for i, n in enumerate(names)}


def read_stellar_flux(flux_file: str, wave_file: str
                      ) -> tuple[np.ndarray, np.ndarray]:
    """Paired stellar flux and wavelength text files -> (flux, wavelength),
    float64."""
    flux = read_data_table(flux_file).ravel()
    wave = read_data_table(wave_file).ravel()
    if flux.shape != wave.shape:
        raise ValueError(
            f"flux ({flux.shape}) and wavelength ({wave.shape}) sizes differ")
    return flux, wave


def read_aerosol_profile(name: str) -> np.ndarray:
    """The 4-column aMars aerosol profile (p [bar], T [K], SO4AER, S8AER),
    float64 ``(rows, 4)``: the first line is a header, and lines without
    exactly four numbers are skipped."""
    path = find_resource(name)
    rows = []
    with open(path) as f:
        f.readline()
        for line in f:
            vals = line.split()
            if len(vals) == 4:
                try:
                    rows.append([float(v) for v in vals])
                except ValueError:
                    pass
    return np.asarray(rows, dtype=np.float64)
