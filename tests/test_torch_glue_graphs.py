"""The outer iteration's glue from CUDA graphs (``models/glue.py``) against
the eager glue, over whole solves.

On a CUDA card (marked ``cuda``, skipped without one): the single fused
solve, lockstep batches of 2 and 4 and stream mode, at 96 x 128 and 480 x
640, sf 2 and 4, with the graphs and with the eager glue (the engagement
rule, ``glue.engages``, forced false): z, rho, s, N, dz, the energy traces
and every CG count bit for bit; ``glue_replays`` counts the iterations
less the eager and the capture one; the iterates that ``dump_iterations``
keeps equal the eager run's.

On the CPU the same comparisons run with the graphs' contract rehearsed
(:class:`Rehearsal`): the first ``replay`` of a half records its function,
every later one calls that function again and writes its results into the
tensors the first returned, as a replay writes a graph's outputs. This
holds the in-place state, the frozen lanes and the copies kept for the
caller to what the eager path computes.

This file imports no JAX, so it runs on a card's machine too: ``python -m
pytest --noconftest tests/test_torch_glue_graphs.py``.
"""

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile
from torch.utils._pytree import tree_leaves

from srmeetsps_cuda_tpu_torch import trace as tracing
from srmeetsps_cuda_tpu_torch.config import RuntimeConfig, SolverConfig
from srmeetsps_cuda_tpu_torch.io.synthetic import lambertian_dataset
from srmeetsps_cuda_tpu_torch.models import glue, srps
from srmeetsps_cuda_tpu_torch.parallel import batched
from srmeetsps_cuda_tpu_torch.runtime import solver

ROUTES = ["single", "lockstep2", "lockstep4", "stream"]
FIELDS = ("z", "rho", "s", "N", "dz")
CARD_CFG = SolverConfig()
CPU_CFG = SolverConfig(max_iterations=5, cg_max_iter=30)


class Rehearsal(glue.Glue):
    """The graphs' contract on the CPU: a replay runs the captured
    function on the tensors it captured and writes the tensors it
    returned."""

    def replay(self, name, fn):
        got = self.graphs.get(name)
        if got is None:
            got = self.graphs[name] = (fn, fn())
        else:
            for old, new in zip(tree_leaves(got[1]), tree_leaves(got[0]())):
                old.copy_(new)
        return got[1]


@pytest.fixture
def card() -> torch.device:
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


@pytest.fixture(autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def use_graphs(monkeypatch, on: bool, device):
    """The engagement rule forced off, or on the CPU its rehearsal; with
    no kept single solve (``glue.Kept``) but those made under it, which
    go when it is undone."""
    monkeypatch.setattr(glue, "_kept", {})
    if not on:
        monkeypatch.setattr(glue, "engages", lambda device, check: False)
    elif device.type == "cpu":
        monkeypatch.setattr(glue, "engages",
                            lambda device, check: check is None)
        monkeypatch.setattr(glue, "Glue", Rehearsal)


def host(t):
    return t.detach().cpu().numpy()


def solve_route(route, h, w, sf, cfg, device, monkeypatch):
    """One solve of ``route``: the lanes' final fields and traces, every
    CG count in launch order, and the spans' glue modes and replays."""
    cg = []
    depth_cg = srps.depth_cg

    def counted(*args, **kw):
        out = depth_cg(*args, **kw)
        cg.append(host(out[2]).reshape(-1).tolist())
        return out

    monkeypatch.setattr(srps, "depth_cg", counted)
    B = {"single": 1, "stream": 3}.get(route) or int(route[-1])
    datas = [lambertian_dataset(h, w, sf, n=6, c=3, seed=k)[0]
             for k in range(B)]
    pairs = [solver.prepare(d, cfg, device) for d in datas]
    with profile(activities=[ProfilerActivity.CPU]):
        if route == "single":
            final, trace = srps.solve_fused(pairs[0][1], pairs[0][0], sf, cfg)
            finals, traces = [final], [trace]
        else:
            finals, traces = batched.solve_batch(
                [s for _, s in pairs], [p for p, _ in pairs], sf, cfg,
                mode=route.rstrip("0123456789"))
    its = [r for r in tracing.records() if r["name"] == "srps.iteration"]
    return {"fields": [[host(getattr(f, k)) for k in FIELDS] for f in finals],
            "traces": [host(t) for t in traces],
            "iterations": [int(f.iteration) for f in finals],
            "cg": cg,
            "glue": [r["attrs"]["glue"] for r in its],
            "replays": sum(r["counts"]["glue_replays"] for r in its),
            "lanes": B}


def expected_replays(res, route):
    """Every iteration but a solve's first two replays its lanes' glue."""
    if route == "stream" or route == "single":
        return sum(max(n - 2, 0) for n in res["iterations"])
    return res["lanes"] * max(max(res["iterations"]) - 2, 0)


def compare_route(route, h, w, sf, cfg, device, monkeypatch):
    use_graphs(monkeypatch, False, device)
    eager = solve_route(route, h, w, sf, cfg, device, monkeypatch)
    monkeypatch.undo()
    use_graphs(monkeypatch, True, device)
    graphs = solve_route(route, h, w, sf, cfg, device, monkeypatch)
    for key in ("fields", "traces", "iterations", "cg"):
        np.testing.assert_equal(graphs[key], eager[key], err_msg=key)
    assert set(eager["glue"]) == {"eager"} and eager["replays"] == 0
    assert max(graphs["iterations"]) >= 3
    assert graphs["replays"] == expected_replays(graphs, route)
    solves = [["eager", "capture"] + ["replay"] * (n - 2)
              for n in graphs["iterations"]]
    # A stream batch is its lanes' solves in turn; a lockstep batch runs
    # as many iterations as its longest lane.
    want = sum(solves, []) if route == "stream" else max(solves, key=len)
    assert graphs["glue"] == want
    return graphs


def kept_iterates(data, cfg, device, tmp_path, monkeypatch):
    """The iterates that ``dump_iterations`` keeps, as host arrays."""
    kept = []
    monkeypatch.setattr(solver, "_iteration_outputs", lambda st, *_:
                        kept.append([host(getattr(st, k)) for k in FIELDS]))
    rt = RuntimeConfig(fused_outer_loop=True, dump_iterations=True,
                       dump_dir=str(tmp_path), dump_format="npz")
    solver.solve(data, cfg, rt, device=device, verbose=False)
    return kept


def compare_kept(cfg, device, tmp_path, monkeypatch):
    data = lambertian_dataset(96, 128, 2, n=6, c=3, seed=0)[0]
    use_graphs(monkeypatch, False, device)
    eager = kept_iterates(data, cfg, device, tmp_path / "eager", monkeypatch)
    monkeypatch.undo()
    use_graphs(monkeypatch, True, device)
    graphs = kept_iterates(data, cfg, device, tmp_path / "graphs",
                           monkeypatch)
    assert len(graphs) >= 3
    np.testing.assert_equal(graphs, eager)
    # Distinct iterates: none was overwritten by a later one.
    assert not np.array_equal(graphs[-1][0], graphs[-2][0])


# -- on the CPU: the rehearsal ------------------------------------------------


@pytest.mark.parametrize("sf", [2, 4])
@pytest.mark.parametrize("route", ROUTES)
def test_rehearsed_graphs_equal_the_eager_solve(route, sf, monkeypatch):
    compare_route(route, 96, 128, sf, CPU_CFG, torch.device("cpu"),
                  monkeypatch)


def test_rehearsed_lockstep_freezes_lanes_that_stopped(monkeypatch):
    got = compare_route("lockstep4", 96, 128, 2,
                        SolverConfig(max_iterations=10, cg_max_iter=30),
                        torch.device("cpu"), monkeypatch)
    # The lanes stop at different iterations: the graphs froze the early
    # ones as the eager path does.
    assert len(set(got["iterations"])) > 1


def test_rehearsed_kept_iterates_equal_the_eager_ones(tmp_path, monkeypatch):
    compare_kept(CPU_CFG, torch.device("cpu"), tmp_path, monkeypatch)


# -- on the card ---------------------------------------------------------------


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(96, 128), (480, 640)])
@pytest.mark.parametrize("sf", [2, 4])
@pytest.mark.parametrize("route", ROUTES)
def test_graphs_equal_the_eager_solve_on_the_card(card, route, sf, shape,
                                                  monkeypatch):
    compare_route(route, *shape, sf, CARD_CFG, card, monkeypatch)


@pytest.mark.cuda
def test_kept_iterates_equal_the_eager_ones_on_the_card(card, tmp_path,
                                                        monkeypatch):
    compare_kept(CARD_CFG, card, tmp_path, monkeypatch)


@pytest.mark.cuda
def test_a_later_solve_captures_in_the_same_pool(card, monkeypatch):
    """Solves one after another, each capturing and freeing its graphs:
    the pool outlives them, and after the first solve a capture takes no
    new device memory."""
    data = lambertian_dataset(480, 640, 2, n=6, c=3, seed=0)[0]
    prob, st = solver.prepare(data, CARD_CFG, card)
    first, _ = srps.solve_fused(st, prob, 2, CARD_CFG)
    srps.solve_fused(st, prob, 2, CARD_CFG)
    torch.cuda.synchronize()
    reserved = torch.cuda.memory_reserved()
    for _ in range(3):
        again, _ = srps.solve_fused(st, prob, 2, CARD_CFG)
    torch.cuda.synchronize()
    assert torch.cuda.memory_reserved() == reserved
    for k in FIELDS:
        assert torch.equal(getattr(again, k), getattr(first, k))
