"""The port's spans and counters (``srmeetsps_cuda_tpu_torch/trace.py``).

Off (no ``torch.profiler`` session), the solve enters no
``record_function``, records nothing and runs the same operations. Under a
profiler, through ``runtime.solver.solve`` and ``prepare`` +
``solve_batch(mode="lockstep")``, the spans nest as the phases do, each
capture's spans share a request id, the counters count what the solve did
(its host reads, its CG iterations, its uploaded bytes), and every record
joins one ``user_annotation`` range of the exported trace. 96 x 128, as
the benchmark's CPU rehearsals. The launch registry counts by kernel name.
"""

import collections
import glob
import json
import os

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile
from torch.utils._python_dispatch import TorchDispatchMode

from srmeetsps_cuda_tpu_torch import trace
from srmeetsps_cuda_tpu_torch.config import RuntimeConfig, SolverConfig
from srmeetsps_cuda_tpu_torch.io.synthetic import lambertian_dataset
from srmeetsps_cuda_tpu_torch.parallel import batched
from srmeetsps_cuda_tpu_torch.runtime import solver

CPU = torch.device("cpu")
CFG = SolverConfig(max_iterations=4, cg_max_iter=30)
FUSED = RuntimeConfig(fused_outer_loop=True)
PREPARE = ["srps.prepare.upload", "srps.prepare.mean", "srps.prepare.inpaint",
           "srps.prepare.bilateral", "srps.prepare.bicubic",
           "srps.prepare.problem", "srps.prepare.state"]
PHASES = ["srps.lighting", "srps.albedo", "srps.depth_operator",
          "srps.depth_cg", "srps.normals"]


@pytest.fixture(scope="module")
def captures():
    return [lambertian_dataset(96, 128, 2, n=4, c=3, seed=k)[0]
            for k in range(2)]


@pytest.fixture(autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def solve(data):
    final, metrics = solver.solve(data, CFG, FUSED, device=CPU,
                                  verbose=False)
    return final, [m for m in metrics if "energy" in m]


def lockstep(datas):
    pairs = [solver.prepare(d, CFG, CPU) for d in datas]
    return batched.solve_batch([s for _, s in pairs], [p for p, _ in pairs],
                               2, CFG, mode="lockstep")


def profiled(fn, *args, path=None):
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        out = fn(*args)
    if path is not None:
        prof.export_chrome_trace(str(path))
    return out


def outputs(final):
    return [getattr(final, k).numpy() for k in ("z", "rho", "s", "N")]


def children(recs, parent):
    return [r["name"] for r in recs if r["parent"] == parent]


def test_off_enters_no_range_and_records_nothing(captures, monkeypatch):
    class Refused:
        def __init__(self, *_):
            raise AssertionError("record_function entered with tracing off")

    monkeypatch.setattr(torch.profiler, "record_function", Refused)
    monkeypatch.setattr(torch.autograd.profiler, "record_function", Refused)
    trace.STORE.clear()
    solve(captures[0])
    lockstep(captures)
    assert trace.STORE.spans == [] and trace.STORE.loose == {}
    assert trace.records() == [] and trace.totals() == {}


class Ops(TorchDispatchMode):
    def __init__(self):
        super().__init__()
        self.names = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        self.names.append(str(func))
        return func(*args, **(kwargs or {}))


@pytest.mark.parametrize("route", ["solve", "lockstep"])
def test_outputs_and_operations_equal_on_and_off(captures, route):
    def run():
        with Ops() as ops:
            if route == "solve":
                final, metrics = solve(captures[0])
                got = [outputs(final), [m["energy"] for m in metrics]]
            else:
                finals, traces = lockstep(captures)
                got = [[outputs(f) for f in finals],
                       [t.numpy() for t in traces]]
        return got, [n for n in ops.names if not n.startswith("profiler")]

    off, ops_off = run()
    on, ops_on = profiled(run)
    assert ops_on == ops_off
    np.testing.assert_equal(on, off)


def test_solve_spans_and_counts(captures, tmp_path):
    data = captures[0]
    final, metrics = profiled(solve, data, path=tmp_path / "t.json")
    recs = trace.records()
    n = len(metrics)
    assert n == final.iteration >= 2
    names = collections.Counter(r["name"] for r in recs)
    assert names["srps.prepare"] == 1 and names["srps.results"] == 1
    assert names["srps.iteration"] == n and names["srps.stop"] == n + 1
    assert children(recs, None) == (["srps.prepare"] + ["srps.stop",
                                    "srps.iteration"] * n
                                    + ["srps.stop", "srps.results"])
    assert children(recs, ["srps.prepare", 0]) == PREPARE
    assert children(recs, ["srps.prepare.problem", 0]) == [
        "srps.prepare.upload"] * 2
    for k in range(n):
        assert children(recs, ["srps.iteration", k]) == PHASES
    # One capture: one request id on every span.
    assert {r["request"] for r in recs} == {0}
    # n stop tests (the first iteration is not tested), the energy and CG
    # count of each iteration read after the loop, one synchronise.
    tot = trace.totals()
    assert tot["host_reads"] == n + 2 * n + 1
    assert [r["counts"]["cg_iters"] for r in recs
            if r["name"] == "srps.depth_cg"] == [
        m["cg_iterations"] for m in metrics]
    assert tot["cg_iters"] == sum(m["cg_iterations"] for m in metrics)
    f32 = sum(np.asarray(a, np.float32).nbytes
              for a in (data.z0, data.I, data.mask))
    assert tot["h2d_bytes"] == f32
    assert all(r["attrs"] == {"pinned": False} for r in recs
               if r["name"] == "srps.prepare.upload")
    assert_joins(recs, tmp_path / "t.json")


def test_lockstep_spans_and_counts(captures, tmp_path, monkeypatch):
    # The kernel's per-lane counts of each batch iteration, before a
    # stopped lane is frozen.
    seen = []
    step = batched._iteration_lockstep

    def counted(*args, **kw):
        out = step(*args, **kw)
        seen.append(out.cg_iters.tolist())
        return out

    monkeypatch.setattr(batched, "_iteration_lockstep", counted)
    finals, traces = profiled(lockstep, captures, path=tmp_path / "t.json")
    recs = trace.records()
    B, n = len(captures), len(seen)
    assert n == max(f.iteration for f in finals)
    names = collections.Counter(r["name"] for r in recs)
    assert names["srps.prepare"] == B and names["srps.iteration"] == n
    assert names["srps.stop"] == 2 * n + 1 and names["srps.results"] == 1
    for k in range(n):
        assert [(r["name"], r["attrs"]) for r in recs
                if r["parent"] == ["srps.iteration", k]] == (
            [(p, {"lane": b}) for b in range(B)
             for p in ("srps.lighting", "srps.albedo",
                       "srps.depth_operator")]
            + [("srps.depth_operator", {"lanes": B}),
               ("srps.depth_cg", {"lanes": B, "sf": 2, "form": "plain"})]
            + [("srps.normals", {"lane": b}) for b in range(B)])
    # A capture's request id covers its preparation and its lane's phases;
    # the batch's own spans carry none.
    assert [r["request"] for r in recs if r["name"] == "srps.prepare"] \
        == list(range(B))
    for r in recs:
        if "lane" in r["attrs"]:
            assert r["request"] == r["attrs"]["lane"]
        elif r["parent"] is None and r["name"] != "srps.prepare":
            assert r["request"] is None
    # n + 1 stop tests and the B lanes' iteration counts read by
    # ``unstack``.
    tot = trace.totals()
    assert tot["host_reads"] == n + 1 + B
    assert [r["counts"]["cg_iters"] for r in recs
            if r["name"] == "srps.depth_cg"] == [sum(c) for c in seen]
    assert [int(f.cg_iters) for f in finals] == [
        seen[f.iteration - 1][b] for b, f in enumerate(finals)]
    assert tot["h2d_bytes"] == sum(
        np.asarray(a, np.float32).nbytes
        for d in captures for a in (d.z0, d.I, d.mask))
    assert_joins(recs, tmp_path / "t.json")


def assert_joins(recs, path):
    """Every record is the k-th ``user_annotation`` range of its name,
    inside the range of its parent, and no ``srps.*`` range is left."""
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    ranges = collections.defaultdict(list)
    for e in sorted(events, key=lambda e: e.get("ts", 0)):
        if e.get("cat") == "user_annotation" and \
                e["name"].startswith("srps."):
            ranges[e["name"]].append((e["ts"], e["ts"] + e["dur"]))
    assert collections.Counter(r["name"] for r in recs) == {
        k: len(v) for k, v in ranges.items()}
    for r in recs:
        a, b = ranges[r["name"]][r["ordinal"]]
        if r["parent"] is not None:
            pa, pb = ranges[r["parent"][0]][r["parent"][1]]
            assert pa <= a and b <= pb


def test_a_new_session_starts_empty(captures):
    profiled(solve, captures[0])
    first = trace.records()
    assert first
    profiled(lambda: None)
    assert trace.records() == [] and trace.totals() == {}
    profiled(solve, captures[0])
    again = trace.records()
    assert [(r["name"], r["ordinal"]) for r in again] == [
        (r["name"], r["ordinal"]) for r in first]


def test_profile_dir_writes_the_spans_beside_the_trace(captures, tmp_path):
    rt = RuntimeConfig(fused_outer_loop=True, profile_dir=str(tmp_path))
    solver.solve(captures[0], CFG, rt, device=CPU, verbose=False)
    (chrome,) = glob.glob(os.path.join(tmp_path, "*.pt.trace.json"))
    lines = chrome[:-len(".pt.trace.json")] + ".spans.jsonl"
    with open(lines) as f:
        recs = [json.loads(line) for line in f]
    assert recs == trace.records()
    assert_joins(recs, chrome)


def test_launch_registry_counts_by_name_and_reads_a_copy(monkeypatch):
    """The launch registry, profiler or not: counts add up by name, and a
    read is a copy that later launches and edits of it leave alone."""
    monkeypatch.setattr(trace, "_launches", {})
    assert trace.launch_counts() == {}
    trace.launched("stencil_cg")
    trace.launched("inpaint", 32)
    trace.launched("stencil_cg jacobi", 0)
    with profile(activities=[ProfilerActivity.CPU]):
        trace.launched("stencil_cg")
        trace.launched("inpaint", 32)
    got = trace.launch_counts()
    assert got == {"stencil_cg": 2, "inpaint": 64, "stencil_cg jacobi": 0}
    got["stencil_cg"] = 99
    trace.launched("cgs_cg")
    assert got == {"stencil_cg": 99, "inpaint": 64, "stencil_cg jacobi": 0}
    assert trace.launch_counts() == {"stencil_cg": 2, "inpaint": 64,
                                     "stencil_cg jacobi": 0, "cgs_cg": 1}
