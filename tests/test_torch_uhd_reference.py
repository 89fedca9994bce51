"""The port on the 4K rig's deployment against the benchmark's plain
reference, on the CPU.

Seeded captures of the benchmark's ``uhd_sf2`` deployment (2160 x 3840
colour over 1080 x 1920 depth, sf 2, n 20) cut to 72 x 128, the same 16:9
shape at sf 2, drawn by ``bench_torch/data.py``, are solved by the port's
``runtime.solver.solve`` (the fused outer loop, as the benchmark's
``interactive`` traffic, with the configuration's solver block: the depth
CG on the direct operator, the plain version of ``csrc/direct_cg.cu`` on
the CPU) and by ``bench_torch/reference.py`` for as many
outer iterations, and held to the configuration's limits by
``bench_torch/check.py``. The cut keeps the focal length in pixels, fx = fy
= 1920, as ``test_torch_sf4_reference.py`` keeps the fixture's: with fx
scaled with the width (64 at 128 columns) the depth CG converges before
its cap after 70-101 iterations, and where it stops then follows the order
of the arithmetic (the two sides part by 2-6 iterations), while at the
deployment's size every depth CG runs to its cap. The reference in TF32
(rounded on the CPU) in the port's place has to fail the same comparison.
Imports no JAX.
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

CONF = json.loads((Path(__file__).resolve().parent.parent / "bench_torch"
                   / "configs" / "uhd_sf2.json").read_text())
CPU = torch.device("cpu")
GRID = (72, 128)
CAPTURES = 2


@pytest.fixture(autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def pool() -> list:
    return bdata.make_pool(CONF["content_seed"], CAPTURES, *GRID, CONF["sf"],
                           CONF["n"], CONF["c"], CONF["fx"], CONF["fy"], CPU)


def port_answer(cap, monkeypatch) -> dict:
    """The port's solve of ``cap`` in the keys of ``Reference.solve``, its
    initial depth taken from ``prepare`` as the benchmark takes it."""
    zinit = []
    prepare = solver.prepare

    def kept(*args, **kw):
        out = prepare(*args, **kw)
        zinit.append(out[1].z)
        return out
    monkeypatch.setattr(solver, "prepare", kept)
    final, metrics = solver.solve(cap, SolverConfig(**CONF["solver"]),
                                  RuntimeConfig(fused_outer_loop=True),
                                  device=CPU, verbose=False)
    monkeypatch.setattr(solver, "prepare", prepare)
    recs = [m for m in metrics if "energy" in m]
    out = {k: getattr(final, k).numpy() for k in ("z", "rho", "s", "N")}
    out.update(z_init=zinit[0].numpy(), energies=[m["energy"] for m in recs],
               cg=[m["cg_iterations"] for m in recs])
    return out


def test_port_holds_the_reference_within_the_limits(monkeypatch):
    readings = []
    for cap in pool():
        got = port_answer(cap, monkeypatch)
        ref = Reference(CPU).solve(cap, CONF["solver"],
                                   iterations=len(got["energies"]))
        readings.append(check.compare(got, ref, CONF["solver"]))
    numbers = check.worst(readings)
    ok, table = check.verdict(numbers, CONF["limits"])
    print("uhd_sf2", table)
    assert ok, table
    assert numbers["stop"] == 0 and numbers["cg_iters"] == 0


def test_tf32_control_is_not_correct():
    readings = []
    for cap in pool():
        ctl = Reference(CPU, tf32=True).solve(cap, CONF["solver"])
        ref = Reference(CPU).solve(cap, CONF["solver"],
                                   iterations=len(ctl["energies"]))
        readings.append(check.compare(ctl, ref, CONF["solver"]))
    ok, table = check.verdict(check.worst(readings), CONF["limits"])
    print("control uhd_sf2", table)
    assert not ok

