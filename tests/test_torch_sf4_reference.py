"""The port at sf 4 against the benchmark's plain reference, on the CPU.

Seeded captures of the benchmark's ``mitten_sf4`` deployment (and of
``mitten_sf2``, the same rig at sf 2) cut to 96 x 128 (LR 24 x 32 at sf
4), drawn by ``bench_torch/data.py``, are solved by the port's
``runtime.solver.solve`` (the fused outer loop, as the benchmark's
``interactive`` traffic) and by ``bench_torch/reference.py`` for as many
outer iterations, and held to the configuration's limits by
``bench_torch/check.py``: z_init, z, rho, s, N, the energy trace, the
stopping rule and the CG counts. Two controls have to fail the same
comparison: the reference in TF32 (rounded on the CPU) in the port's
place, and a port whose stencil matvec drops the ``ktw * tilesum`` term,
which only sf 4 has. Imports no JAX.
"""

import json
from pathlib import Path

import pytest
import torch

from bench_torch import check
from bench_torch import data as bdata
from bench_torch.reference import Reference
from srmeetsps_cuda_tpu_torch.config import RuntimeConfig, SolverConfig
from srmeetsps_cuda_tpu_torch.runtime import solver
from srmeetsps_cuda_tpu_torch.solve import stencil_cg

CONFIGS = Path(__file__).resolve().parent.parent / "bench_torch" / "configs"
CPU = torch.device("cpu")
GRID = (96, 128)
CAPTURES = 2


def config(name: str) -> dict:
    with open(CONFIGS / f"{name}.json") as f:
        return json.load(f)


def pool(conf: dict) -> list:
    return bdata.make_pool(conf["content_seed"], CAPTURES, *GRID, conf["sf"],
                           conf["n"], conf["c"], conf["fx"], conf["fy"], CPU)


@pytest.fixture(autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def port_answer(cap, conf: dict, monkeypatch) -> dict:
    """The port's solve of ``cap`` in the keys of ``Reference.solve``, its
    initial depth taken from ``prepare`` as the benchmark takes it."""
    zinit = []
    prepare = solver.prepare

    def kept(*args, **kw):
        out = prepare(*args, **kw)
        zinit.append(out[1].z)
        return out
    monkeypatch.setattr(solver, "prepare", kept)
    final, metrics = solver.solve(cap, SolverConfig(**conf["solver"]),
                                  RuntimeConfig(fused_outer_loop=True),
                                  device=CPU, verbose=False)
    monkeypatch.setattr(solver, "prepare", prepare)
    recs = [m for m in metrics if "energy" in m]
    out = {k: getattr(final, k).numpy() for k in ("z", "rho", "s", "N")}
    out.update(z_init=zinit[0].numpy(), energies=[m["energy"] for m in recs],
               cg=[m["cg_iterations"] for m in recs])
    return out


def port_numbers(conf: dict, monkeypatch) -> dict:
    readings = []
    for cap in pool(conf):
        got = port_answer(cap, conf, monkeypatch)
        ref = Reference(CPU).solve(cap, conf["solver"],
                                   iterations=len(got["energies"]))
        readings.append(check.compare(got, ref, conf["solver"]))
    return check.worst(readings)


@pytest.mark.parametrize("name", ["mitten_sf4", "mitten_sf2"])
def test_port_holds_the_reference_within_the_limits(name, monkeypatch):
    conf = config(name)
    numbers = port_numbers(conf, monkeypatch)
    ok, table = check.verdict(numbers, conf["limits"])
    print(name, table)
    assert ok, table
    assert numbers["stop"] == 0 and numbers["cg_iters"] == 0


@pytest.mark.parametrize("name", ["mitten_sf4", "mitten_sf2"])
def test_tf32_control_is_not_correct(name):
    conf = config(name)
    readings = []
    for cap in pool(conf):
        ctl = Reference(CPU, tf32=True).solve(cap, conf["solver"])
        ref = Reference(CPU).solve(cap, conf["solver"],
                                   iterations=len(ctl["energies"]))
        readings.append(check.compare(ctl, ref, conf["solver"]))
    ok, table = check.verdict(check.worst(readings), conf["limits"])
    print("control", name, table)
    assert not ok


def drop_tile_sum(monkeypatch):
    """The stencil matvec without its sf = 4 term ``ktw * tilesum(v)``."""
    orig = stencil_cg.stencil_matvec

    def matvec(C, v, ktw, sf):
        return orig(C, v, ktw, 2 if sf == 4 else sf)
    monkeypatch.setattr(stencil_cg, "stencil_matvec", matvec)


@pytest.mark.parametrize("name,correct", [("mitten_sf4", False),
                                          ("mitten_sf2", True)])
def test_a_dropped_tile_sum_fails_at_sf4_alone(name, correct, monkeypatch):
    drop_tile_sum(monkeypatch)
    conf = config(name)
    numbers = port_numbers(conf, monkeypatch)
    ok, table = check.verdict(numbers, conf["limits"])
    print("dropped tile sum", name, table)
    assert ok is correct
    if not correct:
        assert numbers["z_mm"] > conf["limits"]["z_mm"]
