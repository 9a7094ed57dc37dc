"""The port's measurement layer (``pyharp_tpu_torch/bench``) against the
JAX package's scripts, on the CPU.

* The problems: ``bench_problem`` and ``extra_problem`` give the float32
  arrays of ``bench.build_problem`` and ``bench_extra.build`` bit for bit;
  ``radiance_problem`` the draw of ``bench_extra.py:149-153``;
  ``stage_inputs`` the draw of ``pyharp_tpu/bench/stages.py:52-62``.
* ``stages.split_forward``: the stages chained give ``Disort.forward``'s
  flux bit for bit.
* ``roofline_run``: ``kernel_bytes`` equals the bytes of each kernel's
  tensors (``tensor_bytes``) on small problems, up to N = 32, and
  ``kernel_flops`` grows with N through N = 32; at the bench shape the
  bounds of K1, K2 and K3 are 0.438, 0.657 and 0.674 ms; the BVP's
  min-bytes floor is JAX ``roofline_run.kernel_counts``'s.
* ``rmse_run._solver_fluxes`` against JAX ``rmse_run._solver_fluxes`` in
  float64 within 1e-10 relative (the same plain algorithms; they agree to
  ~1e-15); ``rmse_run.main`` writes only its ``--out``.
* ``scaling_run`` on 2 gloo ranks at 32 columns gives finite ratios.
* Every driver raises without CUDA unless given ``--device cpu``.

The steps of ``bench.py`` and ``bench_extra.py`` against the port's are in
``tests/test_torch_bench_steps.py`` and ``tests/test_torch_bench_extra.py``.
"""

import hashlib
from pathlib import Path

import numpy as np
import pytest
import torch

import bench
import bench_extra
from pyharp_tpu.bench import rmse_run as jrmse
from pyharp_tpu.bench import roofline_run as jroof

from pyharp_tpu_torch.bench import (columns, extra, problems, rmse_run,
                                    roofline_run as R, scaling_run, stages)
from pyharp_tpu_torch.rt.disort import kernels as K
from pyharp_tpu_torch.rt.disort.solver import bvp_rhs, make_static_angles

REPO = Path(__file__).resolve().parents[1]
EXTRA = {   # bench_extra.py's configurations, cut to 2 x 4 x 10
    "sw_lbl_4str_beam": (4, dict(beam=True, planck=False)),
    "aerosol_16str_beam": (16, dict(beam=True, planck=False, g=0.8)),
    "thermal_lw_8str_100lyr_bigbatch": (8, dict(beam=False, planck=True)),
}


def _same(jax_arr, tensor):
    want = np.asarray(jax_arr)
    got = tensor.numpy()
    assert got.dtype == want.dtype == np.float32
    np.testing.assert_array_equal(got, want)


def test_bench_problem_is_build_problem():
    _, (prop, bc, temf) = bench.build_problem(4, nwave=2, nlyr=10, nstr=8)
    p = problems.bench_problem(2, 4, 10, 8, device="cpu")
    _same(prop, p.prop)
    _same(temf, p.temf)
    assert set(bc) == set(p.bc)
    for k in bc:
        _same(bc[k], p.bc[k])
    assert p.disort.options.wave_lower == (1.0, 1.0)
    assert p.disort.options.wave_upper == (500.0, 500.0)


@pytest.mark.parametrize("name", list(EXTRA))
def test_extra_problem_is_bench_extra_build(name):
    nstr, kw = EXTRA[name]
    _, (prop, bc, temf) = bench_extra.build(2, 4, 10, nstr, **kw)
    p = problems.extra_problem(2, 4, 10, nstr, device="cpu", **kw)
    _same(prop, p.prop)
    assert set(bc) == set(p.bc)
    for k in bc:
        _same(bc[k], p.bc[k])
    assert (temf is None) == (p.temf is None)
    if temf is not None:
        _same(temf, p.temf)


def test_radiance_problem_is_bench_extra_draw():
    nwave, ncol, nlyr, nstr = 3, 5, 7, 8
    rng = np.random.default_rng(0)                 # bench_extra.py:149-153
    prop = np.zeros((nwave, ncol, nlyr, 2 + nstr), np.float32)
    prop[..., 0] = rng.uniform(0.01, 0.5, (nwave, ncol, nlyr))
    prop[..., 1] = rng.uniform(0.1, 0.9, (nwave, ncol, nlyr))
    prop[..., 2:] = 0.7 ** np.arange(1, nstr + 1)
    p = problems.radiance_problem(torch.float32, "cpu",
                                  shape=(nwave, ncol, nlyr, nstr))
    np.testing.assert_array_equal(p.prop.numpy(), prop)
    want = dict(albedo=0.2, fbeam=np.pi, umu0=0.7)
    assert set(p.bc) == set(want)
    for k, v in want.items():
        np.testing.assert_array_equal(p.bc[k].numpy(),
                                      np.full((nwave, ncol), v, np.float32))
    assert p.disort.options.user_mu == (-0.8, -0.4, 0.4, 0.8)
    assert p.disort.options.user_tau == (0.5, 2.0, 5.0)


def test_stage_inputs_are_stages_draw():
    L, B, nstr = 5, 12, 8
    rng = np.random.default_rng(0)     # pyharp_tpu/bench/stages.py:52-62
    want = dict(ssa=rng.uniform(0.0, 0.6, (L, B)),
                pmom=rng.uniform(0.0, 0.3, (L, nstr, B)),
                dtau=rng.uniform(0.001, 0.8, (L, B)),
                btop=rng.uniform(0.0, 1.0, (L, B)),
                slope=rng.uniform(-0.1, 0.1, (L, B)),
                albedo=np.full((B,), 0.1),
                ftop=np.zeros((nstr // 2, B)),
                bot_rhs=rng.uniform(0.0, 1.0, (nstr // 2, B)))
    got = problems.stage_inputs(L, B, nstr, device="cpu")
    assert set(got) == set(want)
    for k, v in want.items():
        np.testing.assert_array_equal(got[k].numpy(), v.astype(np.float32))


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_split_forward_is_forward_bit_for_bit(dtype):
    p = problems.bench_problem(2, 4, 10, 8, dtype, "cpu")
    rows, flux = stages.split_forward(p.disort, *p.args, iters=1, rounds=2)
    assert list(rows) == ["preparation", "stage 1 (K1)", "glue",
                          "BVP (K2, K3)", "flux assembly", "forward"]
    assert all(v > 0 for v in rows.values())
    assert torch.equal(flux, p.disort.forward(*p.args))
    assert K.launch_counts()["stage1_isotropic"] == 0     # CPU: no kernel


def test_stages_main_on_cpu(capsys):
    rec = stages.main(["--ncol", "2", "--nwave", "2", "--nlyr", "6",
                       "--device", "cpu"])
    assert rec["bit_equal"] and rec["card"] == "cpu"
    assert list(rec["split_ms"]) == ["preparation", "stage 1 (K1)", "glue",
                                     "BVP (K2, K3)", "flux assembly",
                                     "forward"]
    assert all(v > 0 for v in rec["split_ms"].values())
    assert np.isfinite(rec["solver"]["columns_per_s"])
    out = capsys.readouterr().out
    assert "chained stages bit-equal to forward: yes" in out


def test_check_split_names_the_gap():
    rows = {"preparation": 1.0, "stage 1 (K1)": 0.1, "forward": 2.0}
    with pytest.raises(AssertionError, match="in no row"):
        stages.check_split(rows)
    rows["forward"] = 1.05
    assert abs(stages.check_split(rows) - 1.1 / 1.05) < 1e-12


def _kernel_calls(N, L, B):
    """(name, kernel_bytes keywords, reads, outputs) of every kernel on a
    small CPU problem (the wrappers run their plain versions)."""
    nstr = 2 * N
    ang = make_static_angles(nstr, nstr, 0)
    x = problems.stage_inputs(L, B, nstr, device="cpu")
    ssa, pmom, dtau, btop, slope = (x[k] for k in ("ssa", "pmom", "dtau",
                                                   "btop", "slope"))
    fbeam = torch.full((B,), 3.0)
    mur = torch.full((L, B), 0.55)
    lam0 = torch.rand((ang.lam_tables.shape[0], B))
    calls = []
    s1 = (ssa, dtau, btop, slope)
    calls.append(("stage1_isotropic", {}, s1,
                  K.stage1_isotropic(*s1, ang)))
    calls.append(("stage1_isotropic_beam", {}, s1 + (fbeam, mur),
                  K.stage1_isotropic_beam(*s1, fbeam, mur, ang)))
    for thermal in (True, False):
        for beam in (True, False):
            kw = dict(fbeam=fbeam, mur=mur, lam0=lam0) if beam else {}
            reads = ((ssa, pmom, dtau) + ((btop, slope) if thermal else ())
                     + tuple(kw.values()))
            calls.append(("stage1_general",
                          dict(nmom=nstr, thermal=thermal, beam=beam),
                          reads, K.stage1_general(ssa, pmom, dtau, btop,
                                                  slope, ang, thermal=thermal,
                                                  **kw)))
    gp, gm, _, expd, y0p, y0m, y1 = K.stage1_general(ssa, pmom, dtau, btop,
                                                     slope, ang)
    bp, bm = y0p + y1 * dtau[None], y0m + y1 * dtau[None]
    pb_p, pb_m = bp[:, -1].contiguous(), bm[:, -1].contiguous()
    dblk = bvp_rhs(y0p, y0m, bp, bm, x["ftop"], -pb_p).contiguous()
    alb = x["albedo"]
    fwd = (gp, gm, expd, dblk, alb)
    P, g = K.bvp_forward(*fwd, ang)
    calls.append(("bvp_forward", {}, fwd, (P, g)))
    bwd = (gp, gm, expd, P, g)
    tops = (y0p, y0m, pb_p, pb_m)
    calls.append(("bvp_backward_flux", {}, bwd + tops,
                  K.bvp_backward_flux(*bwd, *tops, ang)))
    calls.append(("bvp_backward", {}, bwd, K.bvp_backward(*bwd, ang)))
    for flux_only in (False, True):
        reads = fwd + ((y0p, y0m) if flux_only else ())
        calls.append(("bvp_fused", dict(flux_only=flux_only), reads,
                      K.bvp_fused(*fwd, y0p, y0m, wmu=ang.w * ang.mu,
                                  flux_only=flux_only)))
    return calls


@pytest.mark.parametrize("N", [1, 2, 4, 17, 32, 33])
def test_kernel_bytes_is_the_tensor_count(N):
    L, B = 3, 5
    calls = _kernel_calls(N, L, B)
    assert {c[0] for c in calls} == set(K.launch_counts())
    for name, kw, reads, outs in calls:
        assert R.kernel_bytes(name, N, L, B, **kw) == R.tensor_bytes(
            reads, outs), (name, kw)


@pytest.mark.parametrize("name", ["stage1_isotropic", "stage1_isotropic_beam",
                                  "stage1_general", "bvp_forward",
                                  "bvp_backward"])
def test_kernel_flops_grow_with_n(name):
    """Per element the operations of the solves' kernels grow with N
    through N = 64 (nstr 128, the bodies of ``csrc/*_big.cu`` and
    ``csrc/*_huge.cu``), and K4's 8 sweeps of N (N - 1) / 2 rotations lead
    its count at N = 32 and 64."""
    kw = dict(nmom=128, sweeps=8) if name == "stage1_general" else {}
    per = [R.kernel_flops(name, N, 1, 1, **kw) for N in range(16, 65)]
    assert all(b > a > 0 for a, b in zip(per, per[1:]))
    if name == "stage1_general":
        for N in (32, 64):
            assert per[N - 16] > 8 * (N * (N - 1) // 2) * 6 * N


def test_bench_shape_bounds():
    """The PR 6/7 records' bounds (PERF.md section 6), from shapes alone."""
    N, L, B = 4, 100, 8 * 8192
    got = {name: R.bound(R.kernel_bytes(name, N, L, B),
                         R.kernel_flops(name, N, L, B))
           for name in ("stage1_isotropic", "bvp_forward",
                        "bvp_backward_flux")}
    assert {k: (round(ms, 3), by) for k, (ms, by) in got.items()} == {
        "stage1_isotropic": (0.438, "bytes"), "bvp_forward": (0.657, "bytes"),
        "bvp_backward_flux": (0.674, "bytes")}


@pytest.mark.parametrize("N", [1, 2, 4, 8])
def test_bvp_min_bytes_is_jax_floor(N):
    L, B = 100, 8 * 8192
    assert R.bvp_min_bytes(N, L, B) == jroof.kernel_counts(
        L, B, N, 2 * N, K.kernel_sweeps(N))[1][2]


def test_roofline_rows_on_cpu():
    rows = R.run(ncol=2, nwave=2, nlyr=4, nstr=8, device="cpu", iters=1)
    assert [r["name"] for r in rows] == [
        "stage-1 general, nmom 8 (K4)", "stage-1 isotropic (K1)",
        "BVP (a, b) (K2 + K5)", "BVP flux (K2 + K3)",
        "BVP (a, b), single pass (K6)", "BVP flux, single pass (K6)"]
    floor = R.bvp_min_bytes(4, 4, 4) / R.PEAK["bytes"] * 1e3
    for r in rows:
        assert r["ms"] > 0 and r["bound_ms"] > 0
        assert r.get("min_bytes_ms", floor) == pytest.approx(floor)
    assert "| BVP flux (K2 + K3) |" in R.table(rows)


def test_check_hooks_see_every_row_beside_its_plain_version():
    """``check`` gets each roofline row and each stage of ``stages`` (a)
    with the plain versions' outputs; on the CPU the wrappers run the plain
    versions, so the two are equal."""
    seen = []

    def check(name, got, want):
        seen.append(name)
        assert len(got) == len(want) >= 2
        for g, w in zip(got, want):
            assert torch.equal(g, w)

    rows = R.run(ncol=2, nwave=2, nlyr=4, nstr=8, device="cpu", iters=1,
                 check=check)
    stages.solver_stages(2, 2, 4, 8, "cpu", iters=1, check=check)
    assert seen == [r["name"] for r in rows] + [
        "stage 1 (K4)", "stage 1 + BVP (K2 + K5)"]


_BLEV = np.linspace(1.0, 3.0, 5)


@pytest.mark.parametrize("source,nstr,kw", [
    ("beam", 8, dict(ssa=0.9, g=0.0, albedo=0.2)),
    ("beam", 8, dict(ssa=0.9, g=0.7, albedo=0.2)),
    ("thermal", 8, dict(ssa=0.35, g=0.0, albedo=0.15, blev=_BLEV,
                        bsurf=3.5)),
    ("fisot", 8, dict(ssa=0.8, g=0.0, albedo=0.3)),
    ("beam", 4, dict(ssa=0.9, g=0.0, albedo=0.2)),
    ("beam", 16, dict(ssa=0.9, g=0.0, albedo=0.2)),
], ids=["beam", "beam-hg", "thermal", "fisot", "beam-nstr4", "beam-nstr16"])
def test_solver_fluxes_match_jax_f64(source, nstr, kw):
    dtau = np.full(4, 0.1)
    want = jrmse._solver_fluxes(dtau, nstr=nstr, source=source, **kw)
    got = rmse_run._solver_fluxes(dtau, nstr=nstr, source=source, **kw)
    scale = max(np.abs(w).max() for w in want)
    for g, w in zip(got, want):
        assert g.shape == w.shape == (5,)
        assert np.abs(g - w).max() <= 1e-10 * scale


def _digest(path):
    return hashlib.sha256(path.read_bytes()).hexdigest()


def test_rmse_main_writes_only_out(tmp_path, monkeypatch, capsys):
    before = _digest(REPO / "RMSE.md")
    monkeypatch.chdir(tmp_path)
    out = tmp_path / "rmse" / "table.md"
    out.parent.mkdir()
    rows, anchors = rmse_run.main(["--photons", "1e4", "--out", str(out),
                                   "--device", "cpu"])
    assert len(rows) == 2 * 4 * 3 and len(anchors) == 3
    assert all(np.isfinite(r[3]) and r[3] < 0.1 for r in rows)
    assert all(a[4] < rmse_run.ANCHOR_TOL for a in anchors)
    text = out.read_text()
    assert "| thick | fisot w0=0.8 | 16 |" in text
    assert capsys.readouterr().out.startswith(text)
    assert sorted(p.name for p in tmp_path.iterdir()) == ["rmse"]
    assert _digest(REPO / "RMSE.md") == before


def test_scaling_run_on_two_gloo_ranks():
    (r,) = scaling_run.sweep((2,), cols_per_rank=16, nlyr=6)
    assert r["ranks"] == 2 and r["ncol_total"] == 32
    assert r["backend"] == "gloo" and r["cols_per_rank"] == 16
    for k in ("overhead_vs_serialized_shards",
              "partition_overhead_vs_single"):
        assert np.isfinite(r[k]) and r[k] > 0, k
    proj = scaling_run.projection(3e5, r["allreduce_bytes_per_column"])
    for p in proj.values():
        assert 0 < p["projected_efficiency_unoverlapped"] <= 1


def test_columns_and_extra_on_cpu():
    rec = columns.run(2, "cpu", iters=1)
    assert rec["metric"] == "columns_per_s_per_chip_8str_100lyr"
    assert rec["value"] > 0 and rec["card"] == "cpu"
    sw = extra.run_config("sw_lbl_4str_beam", "cpu", shrink=512, iters=1)
    assert sw["shape"] == dict(nwave=500, ncol=1, nlyr=40, nstr=4)
    assert sw["wavecol_solves_per_s"] > 0 and sw["launches"] == {}
    rad = extra.run_config("radiances_8str_4mu_2phi_3tau", "cpu",
                           shrink=512, iters=1)
    assert rad["radiances_per_s"] > 0 and rad["first_call_s"] > 0


@pytest.mark.parametrize("main", [
    R.main, stages.main, columns.main, extra.main, rmse_run.main,
    scaling_run.main],
    ids=["roofline_run", "stages", "columns", "extra", "rmse_run",
         "scaling_run"])
def test_drivers_need_cuda_unless_told_cpu(main):
    assert not torch.cuda.is_available()
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        main([])
