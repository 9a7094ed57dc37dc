"""YAML band factory (port of ``pyharp_tpu/radiation/factory.py``).

The band-configuration schema (``examples/amarsw-ck.yaml``,
``examples/amarsw-lbl.yaml``):

* ``opacity-sources``: a list of {name, class, data, dependent-species};
* ``bands``: the band names, each with a top-level node holding ``units``,
  ``grid-type`` (``regular`` | ``cktable``), ``wavenumber-range``,
  ``resolution`` (regular grids), ``opacity`` (source names), ``rt-solver``
  and ``flags``;
* ``Disort-flags``: a map of booleans turned into the solver's flag string.

Opacity ``class`` strings map onto the attenuator types of
``radiation/band.py``.  A configuration is a parsed dict, a file path or
YAML text; text is parsed with PyYAML, imported when a configuration
arrives as text.
"""

from __future__ import annotations

from pathlib import Path

from ..opacity.base import AttenuatorOptions
from ..rt.disort.disort import DisortOptions
from ..tables.rfm import read_weights_rfm
from .band import RadiationBandOptions
from .radiation import RadiationOptions

# class string -> attenuator type
_CLASS_MAP = {
    "Hitran": "rfm",          # line-by-line RFM-schema table
    "HitranCK": "rfm",        # correlated-k RFM-schema table
    "HeliosCK": "rfm",
    "RFM": "rfm",
    "S8Fuller": "s8_fuller",
    "H2SO4Simple": "h2so4_simple",
    "XIZ-H2-H2-CIA": "h2_h2_cia",
    "XIZ-H2-He-CIA": "h2_he_cia",
    "SimpleCloud": "simple_cloud",
    "Grey": "grey",
    "FreedmanSimple": "freedman_simple",
    "FreedmanSimple2": "freedman_simple",
    "FreedmanMean": "freedman_mean",
    "FreedmanMean2": "freedman_mean",
    "radio-NH3": "radio_nh3",
    "radio-H2O": "radio_h2o",
    "radio-H2S": "radio_h2s",
    "radio-PH3": "radio_ph3",
    "radio-CIA": "radio_cia",
    "radio-Electron": "radio_electron",
}

_BAND_FLAG_MAP = {
    "thermal_emission": "planck",
}


def load_config(config: str | dict) -> dict:
    """A parsed configuration from a dict, a YAML file path or YAML text."""
    if not isinstance(config, str):
        return config
    import yaml

    try:
        with open(config) as f:
            return yaml.safe_load(f)
    except FileNotFoundError:
        return yaml.safe_load(config)


def _disort_flag_string(flag_map: dict[str, bool] | None) -> str:
    if not flag_map:
        return "lamber,quiet,onlyfl"
    return ",".join(k for k, v in flag_map.items() if v)


def _attenuator(sources, species, species_names, species_weights, oname,
                bname):
    src = _pick_source(sources.get(oname, []), bname)
    atype = _CLASS_MAP.get(src["class"], src["class"])
    sid = species[oname][0] if oname in species else 0
    return src, AttenuatorOptions(
        type=atype, opacity_files=(src["data"],), species_ids=(sid,),
        species_names=species_names, species_weights=species_weights)


def create_radiation_options(config: str | dict,
                             species: dict[str, tuple[int, float]],
                             nlyr: int, ncol: int = 1,
                             nstr: int = 8) -> RadiationOptions:
    """``RadiationOptions`` from a YAML file path, YAML text or a parsed
    dict.

    Args:
      species: species name -> (species id, molecular weight kg/mol), the
        host model's species registry.
    """
    node = load_config(config)
    sources: dict[str, list] = {}
    for src in node.get("opacity-sources", []):
        sources.setdefault(src["name"], []).append(src)

    names = sorted(species, key=lambda n: species[n][0])
    species_names = tuple(names)
    species_weights = tuple(species[n][1] for n in names)
    dis_flags = _disort_flag_string(node.get("Disort-flags"))

    band_names = tuple(node.get("bands", ()))
    band_opts = []
    for bname in band_names:
        b = node[bname]
        wmin, wmax = b.get("wavenumber-range", (0.0, 0.0))
        grid_type = b.get("grid-type", "regular")

        attenuators = []
        ck_weights: tuple[float, ...] = ()
        nwave = None
        wave_grid: tuple[float, ...] = ()
        if grid_type == "cktable":
            for oname in b.get("opacity", ()):
                src, aop = _attenuator(sources, species, species_names,
                                       species_weights, oname, bname)
                attenuators.append((f"{oname}-{bname}", aop))
                if aop.type == "rfm" and not ck_weights:
                    ck_weights = tuple(float(x)
                                       for x in read_weights_rfm(src["data"]))
                    nwave = len(ck_weights)
        else:  # regular grid
            res = float(b.get("resolution", 1.0))
            if res <= 0.0 or res > (wmax - wmin):
                # res > span would invert the clipped outer bin edges
                raise ValueError(
                    f"band {bname}: resolution {res} must be in (0, "
                    f"{wmax - wmin}] (the wavenumber-range span)")
            nwave = max(int(round((wmax - wmin) / res)) + 1, 2)
            # samples wmin + i res, each owning a bin of width res
            wave_grid = tuple(wmin + i * res for i in range(nwave))
            for oname in b.get("opacity", ()):
                _, aop = _attenuator(sources, species, species_names,
                                     species_weights, oname, bname)
                attenuators.append((f"{oname}-{bname}", aop))

        flags = dis_flags
        for fl in b.get("flags", ()):
            mapped = _BAND_FLAG_MAP.get(fl, fl)
            if mapped not in flags:
                flags = flags + "," + mapped

        solver = b.get("rt-solver", "Disort").lower()
        if solver == "disort":
            solver_name = "disort"
        elif solver in ("beerlambert", "beer_lambert", "beer-lambert"):
            solver_name = "beer_lambert"
        else:
            raise ValueError(f"Unknown rt-solver: {b.get('rt-solver')}")

        nw = nwave or 1
        if wave_grid:
            # regular grid: per-bin edges subdivide [wmin, wmax], the outer
            # bins clipped to the band (half width), so the bins tile it
            # exactly and adjacent bands do not count their seam twice
            wave_lower = tuple(max(w - res / 2, wmin) for w in wave_grid)
            wave_upper = tuple(min(w + res / 2, wmax) for w in wave_grid)
        else:
            # cktable: every g-point stands for the whole band
            wave_lower = (float(wmin),) * nw
            wave_upper = (float(wmax),) * nw
        band_opts.append(RadiationBandOptions(
            name=bname, solver_name=solver_name, nlyr=nlyr, ncol=ncol,
            wave_lower=wave_lower, wave_upper=wave_upper,
            wavenumber=wave_grid, attenuators=tuple(attenuators),
            disort=DisortOptions(flags=flags, nstr=nstr, nmom=nstr, nwave=nw,
                                 ncol=ncol, nlyr=nlyr),
            ck_weights=ck_weights))

    return RadiationOptions(bands=band_names, band_options=tuple(band_opts))


def _pick_source(cands: list[dict], bname: str) -> dict:
    """The opacity source entry for band ``bname``:

    1. if any candidate has a ``band:`` key, exactly one must equal
       ``bname``;
    2. a single candidate wins;
    3. otherwise ``bname`` must appear in exactly one candidate's ``data``
       file name.  Anything else raises: a wrong pick is never silent.
    """
    if not cands:
        raise ValueError(f"band {bname}: no opacity source found")
    tagged = [c for c in cands if "band" in c]
    if tagged:
        hits = [c for c in tagged if str(c["band"]) == bname]
        if len(hits) == 1:
            return hits[0]
        raise ValueError(
            f"band {bname}: {len(hits)} opacity sources declare "
            f"band: {bname!r} (need exactly 1); declared bands: "
            f"{[str(c.get('band')) for c in cands]}")
    if len(cands) == 1:
        return cands[0]
    # the file's own name: a directory such as a temporary one may hold
    # another band's name
    hits = [c for c in cands
            if bname.lower() in Path(str(c.get("data", ""))).name.lower()]
    if len(hits) == 1:
        return hits[0]
    datas = [str(c.get("data", "")) for c in cands]
    raise ValueError(
        f"band {bname}: ambiguous opacity source — {len(cands)} candidates "
        f"share the name and {len(hits)} of their data filenames contain "
        f"{bname!r} ({datas}); disambiguate with an explicit 'band: "
        f"{bname}' key on the intended opacity-sources entry")
