"""What the port's spans record of a depth solve's scale factor and CG
form, and the benchmark's ``depth_cg_sf4_roofline`` that reads them.

Under ``torch.profiler``, through ``runtime.solver.solve`` and ``prepare``
+ ``solve_batch(mode="lockstep")`` at 96 x 128: every ``srps.depth_cg``
span records the solve's ``sf`` and the form of its CG (``"plain"``,
``"scaled"`` or ``"pcg"``), and ``srps.prepare.bicubic`` its ``factor``.
The reader, on made-up timelines and stores: the least time of
``bench_torch/roofline_sf4.py`` over the device time of the kernels
launched in the ranges, and no number where a range records another sf,
or none. Imports no JAX.
"""

import collections

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from bench_torch import roofline, roofline_sf4, run
from bench_torch.trace import Span, Timeline, Tracer
from srmeetsps_cuda_tpu_torch import trace
from srmeetsps_cuda_tpu_torch.config import RuntimeConfig, SolverConfig
from srmeetsps_cuda_tpu_torch.io.synthetic import lambertian_dataset
from srmeetsps_cuda_tpu_torch.models import srps
from srmeetsps_cuda_tpu_torch.parallel import batched
from srmeetsps_cuda_tpu_torch.runtime import solver

CPU = torch.device("cpu")


@pytest.fixture(autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def traced(route, sf, jacobi):
    cfg = SolverConfig(max_iterations=2, cg_max_iter=20,
                       jacobi_preconditioner=jacobi)
    datas = [lambertian_dataset(96, 128, sf, n=4, c=3, seed=k)[0]
             for k in range(2)]
    with profile(activities=[ProfilerActivity.CPU]):
        if route == "solve":
            solver.solve(datas[0], cfg, RuntimeConfig(fused_outer_loop=True),
                         device=CPU, verbose=False)
        else:
            pairs = [solver.prepare(d, cfg, CPU) for d in datas]
            batched.solve_batch([s for _, s in pairs], [p for p, _ in pairs],
                                sf, cfg, mode="lockstep")
    return trace.records()


@pytest.mark.parametrize("route", ["solve", "lockstep"])
@pytest.mark.parametrize("sf,jacobi,form", [(4, False, "plain"),
                                            (4, True, "pcg"),
                                            (2, False, "plain"),
                                            (2, True, "scaled")])
def test_depth_cg_records_sf_and_form(route, sf, jacobi, form):
    recs = traced(route, sf, jacobi)
    names = collections.Counter(r["name"] for r in recs)
    cg = [r["attrs"] for r in recs if r["name"] == "srps.depth_cg"]
    assert cg and len(cg) == names["srps.iteration"]
    lanes = 1 if route == "solve" else 2
    assert cg == [{"lanes": lanes, "sf": sf, "form": form}] * len(cg)
    bicubic = [r["attrs"] for r in recs
               if r["name"] == "srps.prepare.bicubic"]
    assert bicubic == [{"factor": sf}] * names["srps.prepare"]


@pytest.mark.parametrize("operator,jacobi,sf,form", [
    ("stencil", False, 1, "plain"), ("stencil", True, 1, "scaled"),
    ("stencil", True, 4, "pcg"), ("direct", False, 4, "plain"),
    ("direct", True, 2, "pcg"), ("direct_host_r0", True, 1, "pcg")])
def test_cg_form_follows_the_route(operator, jacobi, sf, form):
    cfg = SolverConfig(cg_operator=operator, jacobi_preconditioner=jacobi)
    assert srps.cg_form(sf, cfg) == form


# -- the reader, on made-up timelines -----------------------------------------


def ev(cat, name, t0, t1, corr=None):
    e = {"ph": "X", "cat": cat, "name": name, "ts": t0 * 1e6,
         "dur": (t1 - t0) * 1e6}
    if corr is not None:
        e["args"] = {"correlation": corr}
    return e


def launch(name, at, start, end, corr):
    return [ev("cuda_runtime", "cudaLaunchKernel", at, at + 0.001, corr),
            ev("kernel", name, start, end, corr)]


def cg_pass(attrs, monkeypatch):
    """Two depth CG ranges, [1, 2] and [5, 6]. The first launches the CG
    kernel (0.5 s, run after its range closed) and a copy (no kernel);
    the second one kernel of 0.25 s. A kernel launched outside both does
    not count. Their records carry ``attrs`` (one dict a range)."""
    events = [ev("user_annotation", "srps.iteration", 0.0, 4.0),
              ev("user_annotation", "srps.depth_cg", 1.0, 2.0),
              ev("user_annotation", "srps.iteration", 4.0, 8.0),
              ev("user_annotation", "srps.depth_cg", 5.0, 6.0)]
    events += launch("cg", 1.5, 2.5, 3.0, 1)
    events += [ev("cuda_runtime", "cudaMemcpyAsync", 1.6, 1.7, 2),
               ev("gpu_memcpy", "copy", 3.0, 3.5, 2)]
    events += launch("cg", 5.5, 6.0, 6.25, 3)
    events += launch("glue", 7.0, 7.0, 7.9, 4)
    recs = []
    for k, a in enumerate(attrs):
        recs += [{"name": "srps.iteration", "ordinal": k, "parent": None,
                  "request": 0, "attrs": {}, "counts": {}},
                 {"name": "srps.depth_cg", "ordinal": k,
                  "parent": ["srps.iteration", k], "request": 0,
                  "attrs": a, "counts": {"cg_iters": 101}}]
    monkeypatch.setattr(trace, "records", lambda: [dict(r) for r in recs])
    monkeypatch.setattr(trace, "totals", lambda: {})
    # The benchmark tracer's depth_cg spans: each lane's pixels and CG
    # iterations.
    prof = Tracer(CPU)
    prof.spans = [Span("depth_cg", 0.0, {"pixels": [px], "iters": [it],
                                         "lanes": 1})
                  for px, it in ((1000, 101), (800, 60))]
    return type("Ctx", (), {"timeline": Timeline(events), "prof": prof})()


def sf4_read(ctx):
    return run.metric_reader("depth_cg_sf4_roofline")(ctx)


def test_reader_returns_the_counts_share(monkeypatch):
    sf4 = {"lanes": 1, "sf": 4, "form": "plain"}
    ctx = cg_pass([sf4, sf4], monkeypatch)
    least = (1000 * (roofline_sf4.OPS_PROLOGUE + roofline_sf4.OPS_PER_ITER
                     * 101) + 800 * (roofline_sf4.OPS_PROLOGUE
                                     + roofline_sf4.OPS_PER_ITER * 60)) \
        / roofline.PEAK_F32_FLOPS
    assert sf4_read(ctx) == pytest.approx(100.0 * least / 0.75)


@pytest.mark.parametrize("second", [{"lanes": 1, "sf": 2, "form": "plain"},
                                    {"lanes": 1}])
def test_reader_gives_nothing_unless_every_range_is_sf4(second, monkeypatch):
    ctx = cg_pass([{"lanes": 1, "sf": 4, "form": "plain"}, second],
                  monkeypatch)
    assert sf4_read(ctx) is None


def test_sf4_count_adds_the_tile_term_to_the_sf2_count():
    # Per pixel and CG iteration: the multiply-add of ktw and the 4 x 4
    # tile's 15 additions over its 16 pixels; the prologue makes no fold
    # of ktw into the planes (9 additions) and adds M x0's tile term. The
    # planes read and written once are the same.
    assert roofline_sf4.OPS_PER_ITER == pytest.approx(
        roofline.OPS_PER_ITER + 2 + 15 / 16)
    assert roofline_sf4.OPS_PROLOGUE == pytest.approx(
        roofline.OPS_PROLOGUE - 9 + 2 + 15 / 16)
    px = 240 * 320 * 16
    assert roofline_sf4.cg_bytes(px) == roofline.cg_bytes(px)
    assert roofline_sf4.least_seconds(px, 101)[1] == "ops"
    assert roofline_sf4.least_seconds(px, 0)[1] == "bytes"


def test_traced_rehearsal_at_sf4_reads_no_device_share():
    # The CPU has no device timeline: the traced pass runs and is correct,
    # the counters are read, the roofline shares absent.
    bench = run.load_json(run.ROOT / "BENCHMARK.json")
    cell = run.find_cell(bench, "mitten_sf4.interactive")
    conf = run.load_json(run.HERE / "configs" / "mitten_sf4.json")
    conf.update(grid=[96, 128], pool=2)
    res = run.run_cell(bench, cell, 2 ** 31 + 5, 0.5, True, CPU, conf=conf,
                       log=lambda _: None)
    assert res["correct"] is True, res["checks"]
    m = res["metrics"]
    assert 0 < m["cg_iters_per_solve"]["value"] <= 101
    assert "depth_cg_sf4_roofline" not in m and "depth_cg_roofline" not in m
    recs = trace.records()
    cg = [r["attrs"] for r in recs if r["name"] == "srps.depth_cg"]
    assert cg and all(a["sf"] == 4 and a["form"] == "plain" for a in cg)
