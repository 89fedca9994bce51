"""The port's bench (``srmeetsps_cuda_tpu_torch/bench.py``) held to
``bench.py``.

``bench.py`` runs here on the CPU with its Pallas kernels in interpret mode
on the resident stencil route, the energy tracked inside the kernel, as
tests/test_torch_e2e.py forces it: the same energy mode as the port's
stencil CG, so outer-iteration counts are equal and final energies within
rtol 5e-4 (the e2e contract). The sections run small (48 x 64, n = 4)
through their function arguments, on bench.py's own arrays, which the port
draws bit for bit.

The accuracy gates run at bench.py's size on both sides; bench.py's CPU
route there is the jnp CG with the energy evaluated by XLA, the port's the
tracked energy. Measured gaps: rmse 3.0e-5 (bf16 1.3e-5), normals 5.1e-4
degrees (bf16 3.7e-4), bench.py's values rounded to 5 and 3 decimals;
held at 1e-4 and 2e-3 degrees.
"""

import json
import math
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import bench as jbench
from srmeetsps_cuda_tpu.config import SolverConfig as JConfig
from srmeetsps_cuda_tpu.parallel import batched as jbatched
from srmeetsps_cuda_tpu.runtime import solver as jsolver
from srmeetsps_cuda_tpu.solve import pallas_cg
from srmeetsps_cuda_tpu.solve import pallas_cg_vmem as pvm
from srmeetsps_cuda_tpu_torch import bench
from srmeetsps_cuda_tpu_torch.config import SolverConfig
from srmeetsps_cuda_tpu_torch.models import srps as tsrps
from srmeetsps_cuda_tpu_torch.runtime import solver as tsolver

CPU = torch.device("cpu")
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
GRID = dict(h=48, w=64, n=4)
E_RTOL = 5e-4
RMSE_TOL = 1e-4
DEG_TOL = 2e-3
# The key set of bench.py's main line, less vs_baseline (its baseline is a
# TPU time).
MAIN_KEYS = {
    "metric", "value", "unit", "seconds_per_solve", "seconds_per_solve_mean",
    "sustained_solves_per_sec", "iterations", "final_energy", "device",
    "dataset",
    "fast_sustained_solves_per_sec", "fast_device_time_ratio",
    "fast_final_energy",
    "bf16_sustained_solves_per_sec", "bf16_device_time_ratio",
    "bf16_final_energy", "bf16_energy_delta_rel", "bf16_energy_ok",
    "ms_per_outer_iter", "ms_per_cg_iter_streaming", "cg_bytes_per_iter_mb",
    "gbps", "ms_per_cg_iter", "pcg_matvec_gflops",
    "matpath_solves_per_sec", "matpath_seconds_per_solve",
    "matpath_load_seconds", "matpath_final_energy", "matpath_energy_matches",
    "sf4_solves_per_sec", "sf4_seconds_per_solve", "sf4_iterations",
    "sf4_final_energy",
    "batched4_solves_per_sec", "batched4_seconds_per_batch",
    "batched4_iterations", "batched4_lockstep_solves_per_sec",
    "1080p_solves_per_sec", "1080p_seconds_per_solve", "1080p_iterations",
    "1080p_ms_per_outer_iter", "1080p_ms_per_cg_iter",
    "1080p_pcg_matvec_gflops",
    "rmse", "rmse_init", "rmse_golden", "normals_err_deg", "accuracy_ok",
    "bf16_rmse", "bf16_normals_err_deg", "bf16_accuracy_ok",
}
# A main run at the test size: a short CG and outer loop, one timed run
# each, short device-metric chains.
SMALL = dict(cfg=SolverConfig(cg_max_iter=8, max_iterations=3), runs=1,
             sustained=1, big=dict(GRID),
             dm=dict(outer=(1, 2), caps=(6, 2), calls=1, reps=1))


def data_of(pkg, sf=2):
    d = pkg.synthetic_dataset(GRID["h"], GRID["w"], 2, GRID["n"], 3)
    return pkg._sf4_data(d) if sf == 4 else d


@pytest.fixture(scope="module")
def jax_runs():
    """bench.py's fused solves of the test grid at sf 2 and 4 (Pallas
    interpret mode, resident stencil route), and its accuracy gates."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(pallas_cg, "INTERPRET", True)
        mp.setattr(pvm, "vmem_mode", lambda *a, **k: "full_stencil")
        runs = {}
        for sf in (2, 4):
            _, final = jbench._fused_best(data_of(jbench, sf),
                                          JConfig(use_pallas=True), runs=1)
            runs[sf] = (int(final.iteration), float(final.energy))
        data = data_of(jbench)
        cfg = JConfig(use_pallas=True)
        prob, st = jsolver.prepare(data, cfg)
        finals, _ = jbatched.solve_batched_streaming([st] * 2, [prob] * 2, 2,
                                                     cfg)
        runs["batched"] = [int(f.iteration) for f in finals]
    runs["accuracy"] = jbench.accuracy_metrics()
    return runs


@pytest.mark.parametrize("sf", [2, 4])
@pytest.mark.parametrize("h,w", [(48, 64), (40, 32)])
def test_inputs_bit_equal_to_bench_py(h, w, sf):
    got, want = (pkg.synthetic_dataset(h, w, sf, 3, 3)
                 for pkg in (bench, jbench))
    crops = [pkg._crop_data(d, h - 8, w - 16)
             for pkg, d in ((bench, got), (jbench, want))]
    sf4 = [pkg._sf4_data(d) for pkg, d in ((bench, got), (jbench, want))]
    for a, b in ((got, want), crops, sf4):
        assert a.sf == b.sf
        for k in ("I", "K", "mask", "z0"):
            x, y = np.asarray(getattr(a, k)), np.asarray(getattr(b, k))
            assert x.dtype == y.dtype and x.shape == y.shape, k
            assert np.array_equal(x, y), k


def test_accuracy_matches_bench_py(jax_runs):
    want = jax_runs["accuracy"]
    got = bench.accuracy_metrics(CPU)
    assert set(got) == set(want)
    for k in ("accuracy_ok", "bf16_accuracy_ok"):
        assert got[k] is want[k] is True, k
    assert got["rmse_golden"] == want["rmse_golden"] == 1.009
    for k in ("rmse", "rmse_init", "bf16_rmse"):
        assert abs(got[k] - want[k]) < RMSE_TOL, (k, got[k], want[k])
    for k in ("normals_err_deg", "bf16_normals_err_deg"):
        assert abs(got[k] - want[k]) < DEG_TOL, (k, got[k], want[k])


def test_headline_and_4k_sections_match_bench_py(jax_runs):
    iters, energy = jax_runs[2]
    times, final = bench._fused_best(data_of(bench), SolverConfig(), CPU,
                                     runs=2)
    assert len(times) == 2 and min(times) > 0
    assert final.iteration == iters
    np.testing.assert_allclose(float(final.energy), energy, rtol=E_RTOL)
    # bench_4k's input at the test grid is the headline's.
    line = bench.bench_4k(CPU, runs=1, **GRID)
    assert tuple(line) == bench.KEYS["4k"]
    assert line["metric"] == "4k_sf2_e2e_solve"
    assert line["iterations"] == iters
    np.testing.assert_allclose(line["final_energy"], energy, rtol=E_RTOL)


def test_sf4_section_matches_bench_py(jax_runs):
    iters, energy = jax_runs[4]
    got = bench.sf4_metrics(CPU, data_of(bench), runs=1)
    assert got["sf4_iterations"] == iters
    np.testing.assert_allclose(got["sf4_final_energy"], energy, rtol=E_RTOL)
    assert got["sf4_solves_per_sec"] == 1.0 / got["sf4_seconds_per_solve"]


def test_matpath_section_matches_bench_py(jax_runs):
    _, energy = jax_runs[2]
    data = data_of(bench)
    _, final = bench._fused_best(data, SolverConfig(), CPU, runs=1)
    got = bench.matpath_metrics(CPU, data, float(final.energy), runs=1)
    assert got["matpath_energy_matches"] is True
    np.testing.assert_allclose(got["matpath_final_energy"], energy,
                               rtol=E_RTOL)
    assert got["matpath_load_seconds"] > 0


def test_batched_sections_match_bench_py(jax_runs):
    got = bench.batched_metrics(CPU, 2, data=data_of(bench), rounds=1,
                                reps=1)
    assert got["batched2_iterations"] == jax_runs["batched"]
    assert got["batched2_lockstep_solves_per_sec"] > 0
    # Mixed geometry: the full-size lane (padded to itself) is the solo
    # solve, lane by lane bit for bit.
    mixed = bench.bench_batched_mixed(
        CPU, 2, base=data_of(bench), sizes=((48, 64), (40, 48)), runs=1)
    assert tuple(mixed) == bench.KEYS["batched-mixed"]
    assert mixed["sizes"] == [[48, 64], [40, 48]]
    assert mixed["iterations"][0] == jax_runs[2][0]


def test_retry_then_omit():
    seq = iter([-1.0, 2.0, math.nan, 0.0, -3.0, -1.0, 5.0])
    assert [bench._retry_then_omit(lambda: next(seq)) for _ in range(4)] == [
        2.0, None, None, 5.0]


@pytest.mark.parametrize("slope", [1e-3, -1e-3])
def test_device_metrics_marginals(slope):
    """A timer whose time is ``slope`` x the chain's work: a positive
    slope gives ms per unit of work of exactly 1e3 x slope, a negative one
    an inverted marginal, retried and then left out."""
    data = data_of(bench)
    cfg = SolverConfig(cg_max_iter=8)
    prob, st = tsolver.prepare(data, cfg, CPU)
    calls = []

    def timer(fn):
        w = int(fn())
        calls.append(w)
        return 1.0 + slope * w, w

    got = bench.device_metrics(prob, st, 2, cfg, CPU, outer=(1, 3),
                               caps=(5, 2), calls=2, reps=2, timer=timer)
    hw = GRID["h"] * GRID["w"]
    if slope > 0:
        assert got["ms_per_outer_iter"] == pytest.approx(1.0)
        assert got["ms_per_cg_iter"] == pytest.approx(1.0)
        assert got["ms_per_cg_iter_streaming"] == pytest.approx(1.0)
        assert got["cg_bytes_per_iter_mb"] == 21 * 4 * hw / 1e6
        assert got["gbps"] == pytest.approx(21 * 4 * hw / 1e-3 / 1e9)
        assert got["pcg_matvec_gflops"] == pytest.approx(18 * hw / 1e-3 / 1e9)
        assert not any(k.endswith("_error") for k in got)
        # Each length warmed once, then 2 reps: 6 timed chains a marginal.
        assert len(calls) == 3 * 6
    else:
        assert set(got) == {"outer_iter_measure_error",
                            "cg_iter_measure_error",
                            "cg_iter_streaming_measure_error"}
        assert len(calls) == 3 * 12
    # The CG chains' work is what the kernel reports: cap + 1 per launch
    # (the streaming chain's timings follow the outer chain's).
    first = len(calls) // 3
    assert calls[first:first + 6] == [12, 6] * 3


@pytest.mark.parametrize("failing", [None, "sf4"])
def test_main_prints_every_section(failing, monkeypatch, capsys):
    if failing:
        def boom(*a, **k):
            raise RuntimeError("forced failure")
        monkeypatch.setattr(bench, f"{failing}_metrics", boom)
    rc = bench.main(["--cpu"], data=data_of(bench), **SMALL)
    lines = [json.loads(s) for s in capsys.readouterr().out.splitlines()]
    assert len(lines) == 9  # one per section
    for a, b in zip(lines, lines[1:]):
        assert set(a) <= set(b)
    last = lines[-1]
    if failing is None:
        assert rc == 0
        assert set(last) == MAIN_KEYS == set(bench.KEYS["main"])
        assert last["device"] == "cpu" and last["dataset"] == "synthetic"
        assert last["matpath_energy_matches"] is True
        assert last["accuracy_ok"] is True and last["bf16_accuracy_ok"]
    else:
        assert rc == 1
        assert last[f"{failing}_error"] == "RuntimeError: forced failure"
        assert set(last) == {k for k in MAIN_KEYS
                             if not k.startswith(failing)} | {
            f"{failing}_error"}


def test_main_keys_are_bench_py_keys():
    """Every key of the port's lines is one bench.py's source writes."""
    src = open(os.path.join(REPO, "bench.py")).read()
    assert '"vs_baseline"' in src
    for key in MAIN_KEYS | set(bench.KEYS["4k"]) | set(
            bench.KEYS["batched-mixed"]):
        stem = key.removeprefix("1080p_").removeprefix("batched4_")
        assert f'{stem}"' in src, key


def test_without_cuda_and_cpu_flag_exits_nonzero():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    proc = subprocess.run(
        [sys.executable, "-m", "srmeetsps_cuda_tpu_torch.bench"], cwd=REPO,
        capture_output=True, text=True, timeout=120)
    assert proc.returncode != 0
    assert proc.stdout == ""
    assert "--cpu" in proc.stderr


@pytest.mark.slow
@pytest.mark.parametrize("h,w", [(2176, 3840), (544, 960)],
                         ids=["4k", "4k-cut-16"])
def test_4k_input_stops_within_one_of_jax(h, w):
    """bench.py's 4K input (2176 x 3840, n = 8; and a cut of it to 1/16 of
    its pixels) on the CPU through both packages: the JAX package on its
    CPU route (the jnp CG, the energy by XLA) and the port with its plain
    versions (the stencil CG, the energy tracked in it). The f32 energy's
    rounding and the unconverged CG's route can set where such a solve
    stops, so the counts are held within one; both traces are printed."""
    data = bench.synthetic_dataset(h, w, 2, 8)
    jcfg, cfg = JConfig(use_pallas=True), SolverConfig()
    jprob, jst = jsolver.prepare(data, jcfg)
    jfinal, jtrace = jsolver._jit_solve_fused(jst, jprob, 2, jcfg)
    prob, st = tsolver.prepare(data, cfg, CPU)
    tfinal, ttrace = tsrps.solve_fused(st, prob, 2, cfg)
    j, t = int(jfinal.iteration), tfinal.iteration
    print(f"{h}x{w}: JAX {j} outer iterations, energies "
          f"{np.asarray(jtrace)[:j].tolist()}; port {t}, energies "
          f"{ttrace[:t].tolist()}")
    assert abs(j - t) <= 1
