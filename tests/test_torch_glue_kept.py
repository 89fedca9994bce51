"""The single solve's glue graphs kept across solves (``models/glue.py``:
``Kept``), against eager solves of the same captures.

``runtime.solver.solve`` keeps its graphs, and the problem and state
tensors they read, for the next solve of the same key: that solve builds
its problem into the kept tensors, copies its initial state into them and
replays from its first outer iteration. Held here, for solves one after
another: z, rho, s, N, dz, the energy traces and the CG counts bit for bit
the eager solves'; every ``srps.iteration`` of a later solve ``"replay"``;
another fx, lam or grid captures anew and replaces the kept solve; what
``prepare`` returned and what an earlier solve returned stay as they
were; ``build_problem(..., into=)`` is a fresh build, field by field; and
``nan_check``, ``dump_iterations`` and ``resume_from`` as without kept
graphs.

On the CPU the graphs' contract is rehearsed (``test_torch_glue_graphs.
Rehearsal``: a replay re-runs the captured function on the tensors it
captured), at 96 x 128. On a CUDA card (marked ``cuda``, skipped without
one) the same at 480 x 640, with the card's memory held too: after a key's
first solve, later ones reserve no new memory and allocate no more at
their peak.

This file imports no JAX, so it runs on a card's machine too: ``python -m
pytest --noconftest tests/test_torch_glue_kept.py``.
"""

import dataclasses

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from srmeetsps_cuda_tpu_torch import trace as tracing
from srmeetsps_cuda_tpu_torch.config import (Preferences, RuntimeConfig,
                                             SolverConfig)
from srmeetsps_cuda_tpu_torch.io.synthetic import lambertian_dataset
from srmeetsps_cuda_tpu_torch.models import glue, srps
from srmeetsps_cuda_tpu_torch.runtime import solver
from test_torch_glue_graphs import FIELDS, host, use_graphs

FUSED = RuntimeConfig(fused_outer_loop=True)
CFG = {"cpu": SolverConfig(max_iterations=5, cg_max_iter=30),
       "cuda": SolverConfig()}
GRID = {"cpu": (96, 128), "cuda": (480, 640)}


@pytest.fixture(params=["cpu", pytest.param("cuda", marks=pytest.mark.cuda)])
def device(request) -> torch.device:
    if request.param == "cuda" and not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    dev = torch.device(request.param)
    glue.drop(dev)
    yield dev
    glue.drop(dev)


@pytest.fixture(autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def captures(device, sf, count=2, grid=None):
    h, w = grid or GRID[device.type]
    return [lambertian_dataset(h, w, sf, n=6, c=3, seed=k)[0]
            for k in range(count)]


def run(data, device, cfg, rt=FUSED, prefs=Preferences()):
    """One ``solver.solve``: the final fields, energies and CG counts as
    host values, and each ``srps.iteration``'s glue mode and replays."""
    with profile(activities=[ProfilerActivity.CPU]):
        final, metrics = solver.solve(data, cfg, rt, device=device,
                                      prefs=prefs, verbose=False)
    its = [r for r in tracing.records() if r["name"] == "srps.iteration"]
    recs = [m for m in metrics if "energy" in m]
    return {"fields": [host(getattr(final, k)) for k in FIELDS],
            "energies": [m["energy"] for m in recs],
            "cg": [m["cg_iterations"] for m in recs],
            "iterations": final.iteration,
            "glue": [r["attrs"]["glue"] for r in its],
            "replays": sum(r["counts"]["glue_replays"] for r in its)}


def eager(datas, device, cfg, monkeypatch, rt=FUSED, prefs=Preferences()):
    """Each capture's solve with the glue eager throughout; then the
    graphs (on the CPU their rehearsal) engaged for what follows."""
    use_graphs(monkeypatch, False, device)
    got = [run(d, device, cfg, rt, prefs) for d in datas]
    monkeypatch.undo()
    use_graphs(monkeypatch, True, device)
    return got


def same(got, want):
    for key in ("fields", "energies", "cg", "iterations"):
        np.testing.assert_equal(got[key], want[key], err_msg=key)


def captured(res):
    """A key's first solve: eager, capture, then replays."""
    n = res["iterations"]
    assert n >= 3
    assert res["glue"] == ["eager", "capture"] + ["replay"] * (n - 2)
    assert res["replays"] == n - 2


def replayed(res):
    """A later solve of the key: every iteration replays."""
    assert res["iterations"] >= 2
    assert res["glue"] == ["replay"] * res["iterations"]
    assert res["replays"] == res["iterations"]


@pytest.mark.parametrize("sf", [2, 4])
def test_later_solves_replay_from_the_first_iteration(device, sf,
                                                      monkeypatch):
    datas = captures(device, sf, 3)
    cfg = CFG[device.type]
    want = eager(datas, device, cfg, monkeypatch)
    first = run(datas[0], device, cfg)
    captured(first)
    same(first, want[0])
    for data, w in zip(datas[1:] + datas[:1], want[1:] + want[:1]):
        got = run(data, device, cfg)
        replayed(got)
        same(got, w)


@pytest.mark.parametrize("change", ["fx", "lam", "grid"])
def test_another_key_captures_anew(device, change, monkeypatch):
    data = captures(device, 2, 1)[0]
    cfg = CFG[device.type]
    other, ocfg = data, cfg
    if change == "fx":
        K = np.array(data.K, np.float32)
        K[0, 0] *= 1.25
        other = dataclasses.replace(data, K=K)
    elif change == "lam":
        ocfg = dataclasses.replace(cfg, lam=0.5)
    else:
        h, w = GRID[device.type]
        other = captures(device, 2, 1, (h // 2, w // 2))[0]
    want = eager([other], device, ocfg, monkeypatch)[0]
    captured(run(data, device, cfg))
    before = glue._kept[glue._slot(device)]
    got = run(other, device, ocfg)
    captured(got)
    same(got, want)
    after = glue._kept[glue._slot(device)]
    assert after is not before and after.key != before.key
    assert before.glue.graphs == {}
    # The new key is the one kept now.
    again = run(other, device, ocfg)
    replayed(again)
    same(again, want)


def test_another_cg_block_replays_the_kept_graphs(device, monkeypatch):
    """The CG runs eagerly between the graphs, so its block is no part of
    what a capture bakes in: a solve with another block replays, bit for
    bit the eager solve with that block (on the card the block sets the
    CG's tiles, and so its sums' order)."""
    data = captures(device, 2, 1)[0]
    cfg = CFG[device.type]
    prefs = Preferences(block_x=128, block_y=8)
    want = eager([data], device, cfg, monkeypatch, prefs=prefs)[0]
    captured(run(data, device, cfg))
    before = glue._kept[glue._slot(device)]
    got = run(data, device, cfg, prefs=prefs)
    replayed(got)
    same(got, want)
    assert glue._kept[glue._slot(device)] is before


def test_earlier_results_stay_as_they_were(device, monkeypatch):
    """What ``prepare`` returned and the final that a solve returned are
    the caller's: later solves write neither."""
    datas = captures(device, 2, 3)
    cfg = CFG[device.type]
    use_graphs(monkeypatch, True, device)
    prepared = []
    prepare = solver.prepare

    def probe(*args, **kw):
        out = prepare(*args, **kw)
        prepared.append((out[1], [host(getattr(out[1], k)) for k in FIELDS]))
        return out

    monkeypatch.setattr(solver, "prepare", probe)
    kept = []
    for data in datas:
        final, _ = solver.solve(data, cfg, FUSED, device=device,
                                verbose=False)
        kept.append((final, [host(getattr(final, k)) for k in FIELDS],
                     *prepared[-1]))
    for final, values, state, initial in kept:
        np.testing.assert_equal([host(getattr(final, k)) for k in FIELDS],
                                values)
        np.testing.assert_equal([host(getattr(state, k)) for k in FIELDS],
                                initial)
    # Each final is a tensor of its own, not the kept state's.
    kept_state = glue._kept[glue._slot(device)].state
    for final, *_ in kept:
        assert all(getattr(final, k).data_ptr()
                   != getattr(kept_state, k).data_ptr() for k in FIELDS)


def fields(prob):
    out = []
    for k, v in prob._asdict().items():
        if k == "gm":
            out += [(f"gm.{j}", m) for j, m in v._asdict().items()]
        else:
            out.append((k, v))
    return out


@pytest.mark.parametrize("image_dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("sf", [2, 4])
def test_build_problem_into_kept_tensors_is_a_fresh_build(device, sf,
                                                          image_dtype):
    cfg = dataclasses.replace(CFG[device.type], image_dtype=image_dtype)
    a, b = captures(device, sf, 2)
    kept, _ = solver.prepare(a, cfg, device)
    ptrs = [v.data_ptr() for _, v in fields(kept) if torch.is_tensor(v)]
    fresh, fresh_state = solver.prepare(b, cfg, device)
    into, into_state = solver.prepare(b, cfg, device, into=kept)
    assert [v.data_ptr() for _, v in fields(into)
            if torch.is_tensor(v)] == ptrs
    assert into.I.dtype == srps.IMAGE_DTYPES[image_dtype]
    for (name, got), (_, want) in zip(fields(into), fields(fresh)):
        if torch.is_tensor(want):
            assert got.dtype == want.dtype and got.shape == want.shape, name
            assert torch.equal(got, want), name
        else:
            assert got == want, name
    # The state has tensors of its own, equal to a fresh build's.
    for k in FIELDS:
        assert torch.equal(getattr(into_state, k), getattr(fresh_state, k))
        assert getattr(into_state, k).data_ptr() not in ptrs


@pytest.mark.parametrize("image_dtype", ["float32", "bfloat16"])
def test_build_problem_keeps_the_masked_stack_and_its_sum(device,
                                                          image_dtype):
    """The stack is the images masked in f32, then cast, laid out
    channel-major and contiguous; ``SI2`` sums the cast products over the
    images in the order of a stack laid out as the images arrive."""
    data = captures(device, 2, 1)[0]
    n, c, h, w = np.shape(data.I)
    prob = srps.build_problem(data.I, data.mask, data.K, 2,
                              data.z0[0], device, image_dtype=image_dtype)
    mask = (srps.to_f32(data.mask, device) != 0).to(torch.float32)
    masked = (srps.to_f32(data.I, device).permute(1, 0, 2, 3) * mask).to(
        srps.IMAGE_DTYPES[image_dtype])
    assert prob.I.is_contiguous() and prob.I.shape == (c, n, h * w)
    assert torch.equal(prob.I, masked.reshape(c, n, h * w))
    assert torch.equal(prob.SI2, torch.sum((masked * masked).float(), dim=1))


def test_a_check_runs_eagerly_and_leaves_the_kept_solve(device,
                                                        monkeypatch):
    datas = captures(device, 2, 2)
    cfg = CFG[device.type]
    checked = RuntimeConfig(fused_outer_loop=True, nan_check=True)
    want = eager(datas[1:], device, cfg, monkeypatch)[0]
    captured(run(datas[0], device, cfg))
    entry = glue._kept[glue._slot(device)]
    got = run(datas[1], device, cfg, checked)
    assert set(got["glue"]) == {"eager"} and got["replays"] == 0
    same(got, want)
    assert glue._kept[glue._slot(device)] is entry
    again = run(datas[1], device, cfg)
    replayed(again)
    same(again, want)


def test_a_failed_solve_frees_the_kept_solve(device, monkeypatch):
    """A solve that raises part way leaves the kept tensors half written:
    the kept solve goes with it, and the next solve of the key captures
    anew."""
    datas = captures(device, 2, 2)
    cfg = CFG[device.type]
    want = eager(datas[1:], device, cfg, monkeypatch)[0]
    captured(run(datas[0], device, cfg))
    depth_cg = srps.depth_cg
    calls = []

    def failing(*args, **kw):
        calls.append(1)
        if len(calls) == 2:
            raise RuntimeError("a planted fault")
        return depth_cg(*args, **kw)

    monkeypatch.setattr(srps, "depth_cg", failing)
    with pytest.raises(RuntimeError, match="planted"):
        run(datas[0], device, cfg)
    assert glue._slot(device) not in glue._kept
    monkeypatch.setattr(srps, "depth_cg", depth_cg)
    got = run(datas[1], device, cfg)
    captured(got)
    same(got, want)


def iterates(data, device, cfg, tmp_path, monkeypatch, **rt):
    """The iterates that ``dump_iterations`` keeps, as host arrays, and
    the solve's glue modes."""
    kept = []
    monkeypatch.setattr(solver, "_iteration_outputs", lambda st, *_:
                        kept.append([host(getattr(st, k)) for k in FIELDS]))
    res = run(data, device, cfg, RuntimeConfig(
        fused_outer_loop=True, dump_iterations=True, dump_dir=str(tmp_path),
        dump_format="npz", **rt))
    return kept, res


def test_dumped_iterates_of_a_replayed_solve(device, tmp_path, monkeypatch):
    datas = captures(device, 2, 2)
    cfg = CFG[device.type]
    use_graphs(monkeypatch, False, device)
    want, _ = iterates(datas[1], device, cfg, tmp_path / "eager",
                       monkeypatch)
    monkeypatch.undo()
    use_graphs(monkeypatch, True, device)
    captured(run(datas[0], device, cfg))
    got, res = iterates(datas[1], device, cfg, tmp_path / "kept",
                        monkeypatch)
    replayed(res)
    assert len(got) >= 3
    np.testing.assert_equal(got, want)
    # Distinct iterates: none was overwritten by a later one.
    assert not np.array_equal(got[-1][0], got[-2][0])


def test_resume_writes_the_checkpoint_into_the_kept_state(device, tmp_path,
                                                          monkeypatch):
    """A solve resumed from a checkpoint on the kept path: the
    checkpoint's state is copied into the kept tensors and replayed on,
    bit for bit the eager resumed solve."""
    datas = captures(device, 2, 2)
    cfg = CFG[device.type]
    short = dataclasses.replace(cfg, max_iterations=1)
    use_graphs(monkeypatch, False, device)
    run(datas[1], device, short, RuntimeConfig(
        fused_outer_loop=True, dump_iterations=True, dump_dir=str(tmp_path),
        dump_format="npz"))
    monkeypatch.undo()
    ck = str(tmp_path / "checkpoint.npz")
    resume = RuntimeConfig(fused_outer_loop=True, resume_from=ck)
    want_plain = eager(datas[1:], device, cfg, monkeypatch)[0]
    monkeypatch.undo()
    want = eager(datas[1:], device, cfg, monkeypatch, resume)[0]
    captured(run(datas[0], device, cfg))
    got = run(datas[1], device, cfg, resume)
    assert got["iterations"] > 2
    assert got["glue"] == ["replay"] * (got["iterations"] - 2)
    same(got, want)
    # The kept state holds the resumed solve's final; a plain solve after
    # it replays from its own initial state.
    again = run(datas[1], device, cfg)
    replayed(again)
    same(again, want_plain)


@pytest.mark.cuda
@pytest.mark.parametrize("sf", [2, 4])
def test_later_solves_take_no_new_memory_on_the_card(sf):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    dev = torch.device("cuda")
    glue.drop(dev)
    datas = captures(dev, sf, 4)
    cfg = CFG["cuda"]
    try:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        solver.solve(datas[0], cfg, FUSED, device=dev, verbose=False)
        torch.cuda.synchronize()
        first = torch.cuda.max_memory_allocated()
        reserved = torch.cuda.memory_reserved()
        for data in datas[1:]:
            torch.cuda.reset_peak_memory_stats()
            solver.solve(data, cfg, FUSED, device=dev, verbose=False)
            torch.cuda.synchronize()
            assert torch.cuda.memory_reserved() == reserved
            assert torch.cuda.max_memory_allocated() <= first
    finally:
        glue.drop(dev)
