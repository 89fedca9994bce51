"""Files written by one package read by the other: a JAX checkpoint resumes
in the port with the iteration counter and energy continuing, and the
port's dumps and checkpoints have the JAX package's format."""

import numpy as np
import pytest
import torch

from test_e2e import synthetic_data
from srmeetsps_cuda_tpu.config import RuntimeConfig as JRuntime
from srmeetsps_cuda_tpu.config import SolverConfig as JConfig
from srmeetsps_cuda_tpu.io import writers as jwriters
from srmeetsps_cuda_tpu.models import srps as jsrps
from srmeetsps_cuda_tpu.runtime import solver as jsolver
from srmeetsps_cuda_tpu.solve import pallas_cg
from srmeetsps_cuda_tpu.solve import pallas_cg_vmem as pvm
from srmeetsps_cuda_tpu_torch import interop
from srmeetsps_cuda_tpu_torch.config import RuntimeConfig, SolverConfig
from srmeetsps_cuda_tpu_torch.io import writers as twriters
from srmeetsps_cuda_tpu_torch.runtime import solver as tsolver

CPU = torch.device("cpu")
BASE = dict(cg_max_iter=10, inpaint_iters=32)


@pytest.fixture
def interpret_full_stencil(monkeypatch):
    monkeypatch.setattr(pallas_cg, "INTERPRET", True)
    monkeypatch.setattr(pvm, "vmem_mode", lambda *a, **k: "full_stencil")


def test_jax_checkpoint_resumes_in_port(rng, tmp_path, interpret_full_stencil):
    data, _ = synthetic_data(rng, h=32, w=32, sf=2)
    jcfg = JConfig(**BASE, use_pallas=True, max_iterations=1)
    jp, js = jsolver.prepare(data, jcfg)
    j1 = jsrps.srps_iteration(js, jp, 2, jcfg)
    ck = str(tmp_path / "checkpoint.npz")
    jwriters.save_checkpoint(ck, j1, 1)

    # One more iteration each: iteration 2 > max_iterations = 1 stops.
    jfinal, jm = jsolver.solve(data, jcfg, JRuntime(resume_from=ck),
                               verbose=False)
    tfinal, tm = tsolver.solve(data, SolverConfig(**BASE, max_iterations=1),
                               RuntimeConfig(resume_from=ck), device=CPU,
                               verbose=False)
    assert [m["iteration"] for m in tm] == [m["iteration"] for m in jm] == [2]
    assert tfinal.iteration == int(jfinal.iteration) == 2
    assert float(tfinal.last_energy) == float(j1.energy)
    np.testing.assert_allclose(tm[0]["energy"], jm[0]["energy"], rtol=5e-4)
    np.testing.assert_allclose(tm[0]["relative_error"],
                               jm[0]["relative_error"], rtol=5e-2, atol=1e-6)
    np.testing.assert_allclose(tfinal.z.numpy(), np.asarray(jfinal.z),
                               rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("fmt", ["npz", "mat5"])
def test_port_dumps_match_jax_dumps(rng, tmp_path, fmt):
    data, _ = synthetic_data(rng, h=24, w=16, sf=2)
    jp, js = jsolver.prepare(data, JConfig(inpaint_iters=8))
    ts = interop.state_from_numpy(js, CPU)
    mask = np.array(jp.mask)
    jwriters.dump_state(str(tmp_path / "j"), js, mask, fmt=fmt)
    twriters.dump_state(str(tmp_path / "t"), ts, torch.from_numpy(mask),
                        fmt=fmt)
    if fmt == "npz":
        a, b = np.load(tmp_path / "j/state.npz"), np.load(tmp_path / "t/state.npz")
        for k in ("s", "rho", "z", "N"):
            np.testing.assert_array_equal(a[k], b[k])
    else:
        for k in ("s", "rho", "z", "N"):
            np.testing.assert_array_equal(
                jwriters.load_mat_any(str(tmp_path / f"j/{k}.mat"))["x"],
                jwriters.load_mat_any(str(tmp_path / f"t/{k}.mat"))["x"])


def test_port_checkpoint_loads_in_jax(rng, tmp_path):
    data, _ = synthetic_data(rng, h=24, w=16, sf=2)
    tp, ts = tsolver.prepare(data, SolverConfig(inpaint_iters=8), CPU)
    path = str(tmp_path / "ck.npz")
    twriters.save_checkpoint(path, ts._replace(iteration=3), 3)
    ck = jwriters.load_checkpoint(path)
    assert int(ck["iteration"]) == 3
    np.testing.assert_array_equal(ck["z"], ts.z.numpy())
    back = tsolver.state_from_checkpoint(twriters.load_checkpoint(path), CPU)
    assert back.iteration == 3 and torch.equal(back.rho, ts.rho)


def test_mat73_writer_matches_jax_container(tmp_path):
    pytest.importorskip("h5py")
    x = np.arange(12, dtype=np.float32)
    twriters.save_vector_mat(str(tmp_path / "t.mat"), x)
    jwriters.save_vector_mat(str(tmp_path / "j.mat"), x)
    a = jwriters.load_mat_any(str(tmp_path / "t.mat"))["x"]
    np.testing.assert_array_equal(a, jwriters.load_mat_any(
        str(tmp_path / "j.mat"))["x"])
