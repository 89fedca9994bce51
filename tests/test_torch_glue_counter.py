"""When the glue runs from CUDA graphs, and how a traced run says so.

The engagement rule (``models/glue.py``: a CUDA device and no per-phase
check), the ``glue`` attribute and the ``glue_replays`` counter of every
``srps.iteration`` span on the single and the lockstep route, and
``bench_torch/metrics/glue_replay_pct.py`` on made-up timelines. On the
CPU the glue runs eagerly; the graphs' contract is rehearsed as in
``tests/test_torch_glue_graphs.py``. The seam: a lockstep batch runs the
single solve's per-lane phase functions, and no estimator itself.
"""

import sys

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from bench_torch import run
from bench_torch.trace import Timeline
from srmeetsps_cuda_tpu_torch import trace as tracing
from srmeetsps_cuda_tpu_torch.config import RuntimeConfig, SolverConfig
from srmeetsps_cuda_tpu_torch.io.synthetic import lambertian_dataset
from srmeetsps_cuda_tpu_torch.models import glue, srps
from srmeetsps_cuda_tpu_torch.parallel import batched
from srmeetsps_cuda_tpu_torch.runtime import solver
from test_torch_glue_graphs import Rehearsal

CPU = torch.device("cpu")
CFG = SolverConfig(max_iterations=4, cg_max_iter=30)


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


def as_if_on_a_card(monkeypatch):
    """The engagement rule as on a CUDA device, the graphs rehearsed; no
    kept single solve (``glue.Kept``) but those made under it."""
    monkeypatch.setattr(glue, "_kept", {})
    rule = glue.engages
    monkeypatch.setattr(glue, "engages",
                        lambda device, check: rule(torch.device("cuda"), check))
    monkeypatch.setattr(glue, "Glue", Rehearsal)


def iterations(fn):
    """``(glue attribute, glue_replays, lanes)`` of each ``srps.iteration``
    span of ``fn()`` run under the profiler."""
    with profile(activities=[ProfilerActivity.CPU]):
        fn()
    return [(r["attrs"]["glue"], r["counts"]["glue_replays"],
             r["attrs"].get("lanes", 1))
            for r in tracing.records() if r["name"] == "srps.iteration"]


def solve(data, rt=RuntimeConfig(fused_outer_loop=True)):
    return lambda: solver.solve(data, CFG, rt, device=CPU, verbose=False)


def lockstep(datas):
    def go():
        pairs = [solver.prepare(d, CFG, CPU) for d in datas]
        return batched.solve_batch([s for _, s in pairs],
                                   [p for p, _ in pairs], 2, CFG,
                                   mode="lockstep")
    return go


def test_engagement_rule():
    cuda = torch.device("cuda", 0)
    assert glue.engages(cuda, None)
    assert not glue.engages(CPU, None)
    assert not glue.engages(cuda, srps.check_finite)
    assert not glue.engages(CPU, srps.check_finite)
    # Where the rule is false a solve's holder never leaves eager mode.
    for check in (None, srps.check_finite):
        g = glue.for_solve(CPU, check)
        for _ in range(3):
            assert g.mode == "eager"
            with g.iteration():
                pass
        assert g.mode == "eager" and g.graphs == {}


def step(g):
    with g.iteration():
        pass


def test_a_glue_holder_walks_eager_capture_replay():
    g = glue.Glue(CPU)
    assert g.mode == "eager"
    step(g)
    assert g.mode == "capture"
    g.graphs.update(a=None, b=None)
    step(g)
    assert g.mode == "replay"
    g.close()
    assert g.graphs == {}


def test_eager_halves_return_fresh_values_and_leave_the_state():
    """In eager mode a half is its function's values and the depth the
    CG's own; nothing is written into the state."""
    g = glue.Glue(CPU)
    st = srps.SRPSState(*(torch.zeros(2, 3) for _ in range(9)))
    s, rho, op = g.run("a", st, ("s", "rho"),
                       lambda: (torch.ones(2, 3), torch.ones(2, 3), "op"))
    assert op == "op" and s is not st.s and rho is not st.rho
    z = torch.ones(2, 3)
    assert g.depth(st, z) is z
    assert all(torch.equal(t, torch.zeros(2, 3)) for t in st)
    assert g.graphs == {}


def test_lockstep_lanes_run_the_single_solves_phases(captures, monkeypatch):
    """A lockstep batch of B = 2 runs ``srps``'s per-lane phase functions
    B times an outer iteration, and calls none of the estimators itself:
    the seam between the two modules."""
    calls = {"lighting_to_operator": [], "normals": []}
    for name, got in calls.items():
        def counted(*args, _fn=getattr(srps, name), _got=got, **kw):
            _got.append(kw.get("lane"))
            return _fn(*args, **kw)
        monkeypatch.setattr(srps, name, counted)
    callers = set()
    for name in ("estimate_lighting", "s_moments", "estimate_albedo",
                 "build_depth_operator", "depth_normals"):
        def seen(*args, _fn=getattr(srps, name), **kw):
            callers.add(sys._getframe(1).f_globals["__name__"])
            return _fn(*args, **kw)
        monkeypatch.setattr(srps, name, seen)
    its = iterations(lockstep(captures))
    B = len(captures)
    assert B == 2 and len(its) >= 2
    for got in calls.values():
        assert got == list(range(B)) * len(its)
    assert batched.__name__ not in callers and srps.__name__ in callers


@pytest.mark.parametrize("route", ["single", "lockstep"])
def test_the_cpu_runs_the_glue_eagerly(captures, route):
    fn = solve(captures[0]) if route == "single" else lockstep(captures)
    its = iterations(fn)
    B = 1 if route == "single" else len(captures)
    assert len(its) >= 2
    assert its == [("eager", 0, B)] * len(its)


def test_a_check_runs_the_glue_eagerly(captures, monkeypatch):
    as_if_on_a_card(monkeypatch)
    checked = iterations(solve(captures[0], RuntimeConfig(
        fused_outer_loop=True, nan_check=True)))
    assert {g for g, _, _ in checked} == {"eager"}
    assert sum(n for _, n, _ in checked) == 0


@pytest.mark.parametrize("route", ["single", "lockstep"])
def test_spans_say_how_the_glue_ran(captures, route, monkeypatch):
    as_if_on_a_card(monkeypatch)
    fn = solve(captures[0]) if route == "single" else lockstep(captures)
    its = iterations(fn)
    B = 1 if route == "single" else len(captures)
    n = len(its)
    assert n >= 3
    assert its == ([("eager", 0, B), ("capture", 0, B)]
                   + [("replay", B, B)] * (n - 2))


# -- bench_torch/metrics/glue_replay_pct.py ------------------------------------


def ev(name, t0, t1):
    return {"ph": "X", "cat": "user_annotation", "name": name,
            "ts": t0 * 1e6, "dur": (t1 - t0) * 1e6}


def rec(ordinal, attrs, counts):
    return {"name": "srps.iteration", "ordinal": ordinal, "parent": None,
            "request": 0, "attrs": attrs, "counts": counts}


def replay_pct(recs, monkeypatch):
    events = [ev(r["name"], 2 * k, 2 * k + 1) for k, r in enumerate(recs)]
    monkeypatch.setattr(tracing, "records", lambda: [dict(r) for r in recs])
    monkeypatch.setattr(tracing, "totals", lambda: {})
    ctx = type("Ctx", (), {"timeline": Timeline(events)})()
    return run.metric_reader("glue_replay_pct")(ctx)


def test_replay_share_over_lane_iterations(monkeypatch):
    single = [rec(0, {"glue": "eager"}, {"glue_replays": 0}),
              rec(1, {"glue": "capture"}, {"glue_replays": 0}),
              rec(2, {"glue": "replay"}, {"glue_replays": 1}),
              rec(3, {"glue": "replay"}, {"glue_replays": 1})]
    assert replay_pct(single, monkeypatch) == pytest.approx(50.0)
    batch = [rec(0, {"lanes": 4, "glue": "eager"}, {"glue_replays": 0}),
             rec(1, {"lanes": 4, "glue": "capture"}, {"glue_replays": 0}),
             rec(2, {"lanes": 4, "glue": "replay"}, {"glue_replays": 4})]
    assert replay_pct(batch, monkeypatch) == pytest.approx(100 / 3)
    eager = [rec(k, {"glue": "eager"}, {"glue_replays": 0}) for k in range(3)]
    assert replay_pct(eager, monkeypatch) == 0.0


def test_no_replay_share_without_the_counter(monkeypatch):
    assert replay_pct([], monkeypatch) is None
    # A program that counts no replays (an older one): nothing to read.
    older = [rec(k, {}, {}) for k in range(3)]
    assert replay_pct(older, monkeypatch) is None
