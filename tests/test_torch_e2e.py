"""The port's whole solve and CLI.

The fused solve is held to the JAX package's default accelerator path
(Pallas stencil CG in interpret mode, tracked energy, fused outer loop) on
tests/test_e2e.py's synthetic dataset, as test_pallas_cg_vmem.py:488-509
holds the JAX paths to each other: equal outer-iteration counts, energies
within rtol 5e-4 per iteration, and the depth after iteration 1 within
rtol 1e-4.
"""

import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from test_e2e import synthetic_data
from srmeetsps_cuda_tpu.config import RuntimeConfig as JRuntime
from srmeetsps_cuda_tpu.config import SolverConfig as JConfig
from srmeetsps_cuda_tpu.models import srps as jsrps
from srmeetsps_cuda_tpu.runtime import solver as jsolver
from srmeetsps_cuda_tpu.solve import pallas_cg
from srmeetsps_cuda_tpu.solve import pallas_cg_vmem as pvm
from srmeetsps_cuda_tpu_torch import cli
from srmeetsps_cuda_tpu_torch.config import RuntimeConfig, SolverConfig
from srmeetsps_cuda_tpu_torch.io.mat_loader import save_mat_dataset
from srmeetsps_cuda_tpu_torch.models import srps as tsrps
from srmeetsps_cuda_tpu_torch.runtime import solver as tsolver

CPU = torch.device("cpu")
BASE = dict(cg_max_iter=10, inpaint_iters=32, max_iterations=4)
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture
def interpret_full_stencil(monkeypatch):
    monkeypatch.setattr(pallas_cg, "INTERPRET", True)
    monkeypatch.setattr(pvm, "vmem_mode", lambda *a, **k: "full_stencil")


def test_fused_solve_matches_jax_default_path(rng, interpret_full_stencil):
    data, _ = synthetic_data(rng, h=32, w=32, sf=2)
    jfinal, jmetrics = jsolver.solve(
        data, JConfig(**BASE, use_pallas=True, kernel_energy=True),
        JRuntime(fused_outer_loop=True), verbose=False)
    tfinal, tmetrics = tsolver.solve(
        data, SolverConfig(**BASE), RuntimeConfig(fused_outer_loop=True),
        device=CPU, verbose=False)
    assert tfinal.iteration == int(jfinal.iteration)
    je = [m["energy"] for m in jmetrics if "iteration" in m]
    te = [m["energy"] for m in tmetrics if "iteration" in m]
    assert len(te) == len(je) == tfinal.iteration
    np.testing.assert_allclose(te, je, rtol=5e-4)
    assert all(m["cg_iterations"] == 11 for m in tmetrics if "iteration" in m)

    # Iteration 1 from the same data through each package's prepare.
    jcfg = JConfig(**BASE, use_pallas=True)
    jp, js = jsolver.prepare(data, jcfg)
    tp, ts = tsolver.prepare(data, SolverConfig(**BASE), CPU)
    np.testing.assert_allclose(ts.z.numpy(), np.asarray(js.z), rtol=1e-5,
                               atol=1e-4)
    j1 = jsrps.srps_iteration(js, jp, 2, jcfg)
    t1 = tsrps.srps_iteration(ts, tp, 2, SolverConfig(**BASE))
    assert int(t1.cg_iters) == int(j1.cg_iters) == 11
    np.testing.assert_allclose(t1.z.numpy(), np.asarray(j1.z), rtol=1e-4,
                               atol=1e-4)
    np.testing.assert_allclose(float(t1.energy), float(j1.energy), rtol=5e-4)


def test_fused_trace_is_nan_padded(rng):
    data, _ = synthetic_data(rng, h=24, w=16, sf=2)
    cfg = SolverConfig(cg_max_iter=5, inpaint_iters=8, max_iterations=2)
    prob, st = tsolver.prepare(data, cfg, CPU)
    seen = []
    final, trace = tsrps.solve_fused(st, prob, 2, cfg,
                                     on_iteration=seen.append)
    assert trace.shape == (cfg.max_iterations + 2,)
    n = final.iteration
    assert [s.iteration for s in seen] == list(range(1, n + 1))
    assert torch.equal(trace[:n], torch.stack([s.energy for s in seen]))
    assert torch.isnan(trace[n:]).all()


def test_stepwise_and_fused_agree(rng):
    data, _ = synthetic_data(rng, h=32, w=32, sf=2)
    cfg = SolverConfig(**BASE)
    fin = {}
    for fused in (False, True):
        fin[fused], metrics = tsolver.solve(
            data, cfg, RuntimeConfig(fused_outer_loop=fused), device=CPU,
            verbose=False)
    assert fin[True].iteration == fin[False].iteration
    assert torch.equal(fin[True].z, fin[False].z)
    assert float(fin[True].energy) == float(fin[False].energy)


def test_cli_cpu_on_mat5_dataset(rng, tmp_path, capsys):
    data, _ = synthetic_data(rng, h=32, w=32, sf=2)
    path = str(tmp_path / "ds.mat")
    save_mat_dataset(path, data, fmt="mat5")
    out = tmp_path / "out"
    metrics = tmp_path / "m.jsonl"
    rc = cli.main(["--dstype", "matlab", "--dsloc", path, "--cpu",
                   "--cg-max-iter", "10", "--dump", "--dump-format", "npz",
                   "--dump-dir", str(out), "--metrics-jsonl", str(metrics)])
    assert rc == 0
    text = capsys.readouterr().out
    assert "Iteration 01 summary" in text and "Done!" in text
    recs = [json.loads(line) for line in metrics.read_text().splitlines()]
    assert [r["iteration"] for r in recs] == list(range(1, len(recs) + 1))
    assert all(np.isfinite(r["energy"]) and r["cg_iterations"] == 11
               for r in recs)
    for name in ("state.npz", "state_final.npz", "checkpoint.npz"):
        assert (out / name).exists(), name
    final = np.load(out / "state_final.npz")
    assert final["z"].shape == (int((data.mask != 0).sum()),)
    assert np.all(np.isfinite(final["z"]))
    ck = np.load(out / "checkpoint.npz")
    assert int(ck["iteration"]) == len(recs)


def test_cli_help_exits_zero(capsys):
    assert cli.main([]) == 0
    assert "--cpu" in capsys.readouterr().out


def test_cli_rejects_oversized_thread_block():
    with pytest.raises(SystemExit, match="1..1024"):
        cli.main(["--dsloc", "a.mat", "--blockx", "512", "--blocky", "4"])


def test_cli_without_cuda_requires_cpu_flag(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(SystemExit, match="--cpu"):
        cli.main(["--dsloc", str(tmp_path / "x.mat")])


def test_port_imports_no_jax():
    """Every module of the port imports neither JAX nor the JAX package."""
    code = """
import pkgutil, sys
before = set(sys.modules)
import srmeetsps_cuda_tpu_torch as pkg
for m in pkgutil.walk_packages(pkg.__path__, pkg.__name__ + "."):
    __import__(m.name)
new = set(sys.modules) - before
bad = sorted(n for n in new if n.split(".")[0] in ("jax", "jaxlib", "srmeetsps_cuda_tpu"))
assert not bad, bad
sharded = {"srmeetsps_cuda_tpu_torch.parallel." + m
           for m in ("shard_cg", "shard_kernels", "sharded")}
assert sharded <= new, sorted(sharded - new)
print(len([n for n in new if n.startswith("srmeetsps_cuda_tpu_torch")]))
"""
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert int(proc.stdout.strip()) >= 20
