"""The port's sharded outer iteration on row bands and its ``('data', 'x',
'y')`` mesh (``parallel/sharded.py``: ``shard_problem_rows``,
``shard_state_rows``, ``srps_iteration_sharded``, ``make_mesh``,
``shard_pytree``, ``step_sharded``, ``solve_sharded``, ``dryrun``) against
the JAX package's GSPMD mesh and the port's own unsharded and whole-grid
glue solves, on the CPU.

Bounds: against JAX ``step_sharded`` / ``solve_sharded`` on conftest's 8
virtual CPU devices, the JAX suite's own (tests/test_parallel.py:124-156):
energy rtol 1e-2, z relative RMS 2e-2, equal outer iterations, traces at
rtol 1e-2. Port to port (one banded step against the unsharded
``srps_iteration`` on the same inputs): iteration 1's s within 1e-4
relative (test_torch_model.py's lighting bound) and the energy at rtol 1e-3
(``dryrun``'s). Whole solves: equal outer iterations, traces at rtol 1e-3.
"""

import dataclasses

import numpy as np
import pytest
import torch

from test_parallel import make_problem
from srmeetsps_cuda_tpu.config import SolverConfig as JConfig
from srmeetsps_cuda_tpu.parallel import sharded as jsharded
from srmeetsps_cuda_tpu_torch import interop
from srmeetsps_cuda_tpu_torch.config import SolverConfig
from srmeetsps_cuda_tpu_torch.io.synthetic import lambertian_dataset
from srmeetsps_cuda_tpu_torch.models import srps as tsrps
from srmeetsps_cuda_tpu_torch.parallel import shard_cg as scg
from srmeetsps_cuda_tpu_torch.parallel import shard_kernels as sk
from srmeetsps_cuda_tpu_torch.parallel import sharded
from srmeetsps_cuda_tpu_torch.runtime.solver import prepare

CPU = torch.device("cpu")
# A second CPU device name: a mesh alternating "cpu" and "cpu:0" holds its
# shards in groups, as shards on distinct devices are.
CPU0 = torch.device("cpu", 0)
S_RTOL, E_RTOL = 1e-4, 1e-3
FORMS = {"std": {}, "cgs": {"cg_variant": "cgs"},
         "jacobi": {"jacobi_preconditioner": True},
         "bf16": {"image_dtype": "bfloat16"}}


def _pair(h, w, seed=0):
    """test_parallel.make_problem's problem in both packages: ``(jax prob,
    jax state, port prob, port state)``."""
    jp, js = make_problem(np.random.default_rng(seed), h=h, w=w)
    return (jp, js, interop.problem_from_numpy(jp, CPU),
            interop.state_from_numpy(js, CPU))


def _bit_equal(a, b) -> bool:
    """Equal bits, NaN where the other is NaN (host scalars compare as
    values)."""
    if not isinstance(a, torch.Tensor):
        return a == b
    return a.dtype == b.dtype and a.shape == b.shape and torch.equal(
        a.nan_to_num(), b.nan_to_num()) and torch.equal(a.isnan(), b.isnan())


def _rel_rms(got, want):
    got, want = (np.asarray(a, np.float64) for a in (got, want))
    return float(np.sqrt(np.mean((got - want) ** 2) / np.mean(want ** 2)))


def _step(tp, ts, mesh, cfg=SolverConfig(max_iterations=2)):
    """One ``step_sharded`` of the port on ``mesh``, gathered."""
    out = sharded.step_sharded(sharded.shard_pytree(ts, mesh),
                               sharded.shard_pytree(tp, mesh), 2, cfg, mesh)
    return sharded.gather(out)


@pytest.mark.parametrize("n,data", [(8, 2), (8, 1), (4, 2), (6, 1)])
def test_make_mesh_matches_jax(n, data):
    mine = sharded.make_mesh(n, data=data, devices="cpu")
    theirs = jsharded.make_mesh(n, data=data)
    assert mine.shape == dict(theirs.shape)
    assert mine.lane(0).size == n // data
    assert all(d == CPU for d in mine.devices.ravel())


def test_step_sharded_matches_jax_and_unsharded():
    """(b): 8 row bands of 4 rows against JAX's 8-way GSPMD step and the
    port's unsharded step."""
    jp, js, tp, ts = _pair(32, 32)
    jcfg, cfg = JConfig(max_iterations=2), SolverConfig(max_iterations=2)
    mesh = sharded.make_mesh(8, devices="cpu")
    jmesh = jsharded.make_mesh(8, data=1)
    jout = jsharded.step_sharded(jsharded.shard_pytree(js, jmesh),
                                 jsharded.shard_pytree(jp, jmesh), 2, jcfg)
    out = _step(tp, ts, mesh)
    np.testing.assert_allclose(float(out.energy), float(jout.energy),
                               rtol=1e-2)
    assert _rel_rms(out.z, jout.z) < 2e-2
    ref = tsrps.srps_iteration(ts, tp, 2, cfg)
    assert _rel_rms(out.s, ref.s) < S_RTOL
    np.testing.assert_allclose(float(out.energy), float(ref.energy),
                               rtol=E_RTOL)
    assert out.iteration == 1 and out.z.shape == (32, 32)


def test_solve_sharded_matches_jax():
    """(c): the fused outer loop on 8 row bands against JAX's on 8
    devices."""
    jp, js, tp, ts = _pair(32, 64)
    jmesh = jsharded.make_mesh(8, data=1)
    jfinal, jtrace = jsharded.solve_sharded(
        jsharded.shard_pytree(js, jmesh), jsharded.shard_pytree(jp, jmesh),
        2, JConfig(max_iterations=2), jmesh)
    mesh = sharded.make_mesh(8, devices="cpu")
    final, trace = sharded.solve_sharded(
        sharded.shard_pytree(ts, mesh), sharded.shard_pytree(tp, mesh), 2,
        SolverConfig(max_iterations=2), mesh)
    assert isinstance(final, sharded.Bands)
    n_it = int(jfinal.iteration)
    assert final.parts[0].iteration == n_it
    np.testing.assert_allclose(trace[:n_it].numpy(),
                               np.asarray(jtrace)[:n_it], rtol=1e-2)


def _lambertian(form):
    data, _ = lambertian_dataset(64, 32, 2, n=4, c=3, seed=1)
    cfg = SolverConfig(max_iterations=3, cg_max_iter=30, inpaint_iters=8,
                       **FORMS[form])
    return data, cfg


def _trace(run):
    final, trace = run
    return trace[:final.iteration].tolist()


@pytest.mark.parametrize("form", list(FORMS))
def test_banded_solve_matches_grid_glue_and_unsharded(form):
    """(d): every phase on 4 row bands against the whole-grid glue with the
    same sharded CG and against the unsharded solve of the same recurrence
    (Jacobi: the direct operator's PCG; the stencil CG takes the scaled
    form at sf <= 2), and the standard CG on a bf16 image stack."""
    data, cfg = _lambertian(form)
    prob, st = prepare(data, cfg, CPU)
    mesh = scg.make_mesh_1d(4, CPU)
    bands = _trace(sharded.solve_fused_sharded(st, prob, 2, cfg, mesh))
    grid = _trace(sharded.solve_fused_sharded(st, prob, 2, cfg, mesh,
                                              glue="grid"))
    solo = _trace(tsrps.solve_fused(st, prob, 2, dataclasses.replace(
        cfg, cg_operator="direct" if form == "jacobi" else "stencil")))
    assert len(bands) == len(grid) == len(solo) > 1
    np.testing.assert_allclose(bands, grid, rtol=1e-3)
    np.testing.assert_allclose(bands, solo, rtol=1e-3)


def test_bands_hold_a_share_of_the_grid():
    """(e): no leaf of a placed problem or state has the grid's h rows, and
    each shard holds at most (hb + 2) / h of the whole problem, state and
    depth operator (whose nine planes the bands keep in F and R0), plus the
    replicated leaves."""
    data, cfg = _lambertian("std")
    prob, st = prepare(data, cfg, CPU)
    h = prob.mask.shape[0]
    for n in (2, 4, 8):
        mesh = scg.make_mesh_1d(n, CPU)
        pb = sharded.shard_problem_rows(prob, mesh)
        sb = sharded.shard_state_rows(st, mesh)
        for tree in (pb, sb):
            for part in tree.parts:
                for name, v in part._asdict().items():
                    for t in v if isinstance(v, tuple) else (v,):
                        if isinstance(t, torch.Tensor) and name != "I":
                            assert h not in t.shape[-2:], (name, t.shape)
        assert pb.parts[0].I.shape[-1] == prob.I.shape[-1]
        whole = sum(t.nbytes for tree in (prob, st) for v in tree
                    for t in (v if isinstance(v, tuple) else (v,))
                    if isinstance(t, torch.Tensor))
        whole += 9 * prob.mask.nbytes
        rep = sum(getattr(st, k).nbytes for k in sharded.REPLICATED)
        per = sharded.shard_bytes(pb, sb)
        assert len(per) == n
        assert max(per) <= whole * (h // n + 2) / h + rep, (per, whole)
        assert max(per) < 2 * whole / n


def _break_z_halos(monkeypatch):
    monkeypatch.setattr(sharded, "_refresh_depth", lambda zs: None)


def _count_halo_rows(monkeypatch):
    """The lighting's ATA over each band's halo rows too."""
    def lighting(I, rho, N, bands):
        _, atb = tsrps.lighting_sums(I, sharded.owned(rho), sharded.owned(N),
                                     bands)
        ata, _ = tsrps.lighting_sums(torch.zeros((rho.shape[0], 1,
                                                  rho[0].numel())),
                                     rho, N, bands)
        return ata, atb

    monkeypatch.setattr(sharded, "_lighting_partials", lighting)


@pytest.mark.parametrize("fault", [_break_z_halos, _count_halo_rows],
                         ids=["z halo not refreshed before the normals",
                              "halo rows in the lighting's sums"])
def test_port_bounds_catch_a_fault(fault, monkeypatch):
    """(f): a banded step with a stale halo or a double-counted band edge
    lands outside (b)'s port-to-port bounds (the sound step is inside them:
    test_step_sharded_matches_jax_and_unsharded)."""
    _, _, tp, ts = _pair(32, 32)
    ref = tsrps.srps_iteration(ts, tp, 2, SolverConfig(max_iterations=2))
    fault(monkeypatch)
    out = _step(tp, ts, sharded.make_mesh(8, devices="cpu"))
    s_gap = _rel_rms(out.s, ref.s)
    e_gap = abs(float(out.energy) / float(ref.energy) - 1)
    assert s_gap > S_RTOL or e_gap > E_RTOL, (s_gap, e_gap)


@pytest.mark.parametrize("form", list(FORMS))
def test_repeated_banded_solve_is_bit_equal(form):
    """(g), and the same bits where the shards fall into three groups (as on
    distinct devices: the per-shard halo copies and partials between
    groups)."""
    data, cfg = _lambertian(form)
    prob, st = prepare(data, cfg, CPU)
    mesh = scg.make_mesh_1d(4, CPU)
    runs = [sharded.solve_fused_sharded(st, prob, 2, cfg, mesh)
            for _ in range(2)]
    runs.append(sharded.solve_fused_sharded(
        st, prob, 2, cfg, scg.make_mesh_1d(4, [CPU, CPU0, CPU0, CPU])))
    first = runs[0]
    for final, trace in runs[1:]:
        assert final.iteration == first[0].iteration
        assert _bit_equal(trace, first[1])
        assert all(map(_bit_equal, final, first[0]))


def test_dryrun_covers_the_data_axis(monkeypatch):
    """(h): ``dryrun(8, "cpu")`` steps 2 lanes on a ('data', 'x', 'y') =
    (2, 2, 2) mesh, each lane in 4 row bands, held to its solo step."""
    seen = []
    step = sharded.step_sharded

    def spy(state, prob, sf, cfg, mesh, block=(256, 4)):
        if isinstance(prob, sharded.Lanes):
            seen.append((mesh.shape, [p.mesh.size for p in prob.trees]))
        return step(state, prob, sf, cfg, mesh, block)

    monkeypatch.setattr(sharded, "step_sharded", spy)
    traces = sharded.dryrun(8, "cpu")
    assert seen == [({"data": 2, "x": 2, "y": 2}, [4, 4])]
    assert len(traces) == 3
    energies = sharded.dryrun_mesh(8, "cpu")
    assert len(energies) == 2 and np.all(np.isfinite(energies))


def test_placement_round_trip_and_halo_rows():
    """Placement then ``gather`` gives the trees back bit for bit; each band
    holds its neighbours' edge rows, zeros at the global top and bottom; the
    LR fields and I split into owned rows and pixels."""
    data, cfg = _lambertian("std")
    prob, st = prepare(data, cfg, CPU)
    mesh = scg.make_mesh_1d(4, [CPU, CPU0, CPU0, CPU])
    pb = sharded.shard_problem_rows(prob, mesh)
    sb = sharded.shard_state_rows(st, mesh)
    assert [p.mask.shape[-3] for p in pb.parts] == [1, 2, 1]
    for tree, bands in ((prob, pb), (st, sb)):
        back = sharded.gather(bands, CPU)
        for name, a in tree._asdict().items():
            b = getattr(back, name)
            pairs = zip(a, b) if isinstance(a, tuple) else [(a, b)]
            assert all(_bit_equal(x, y) for x, y in pairs), name
    z = torch.cat([p.z.flatten(-3, -2) for p in sb.parts]).reshape(4, 18, 32)
    assert torch.equal(z[0, 0], torch.zeros(32))
    assert torch.equal(z[3, -1], torch.zeros(32))
    assert torch.equal(z[1, 0], st.z[15]) and torch.equal(z[1, -1], st.z[32])
    assert pb.parts[1].masks.shape == (2, 8, 16)
    assert pb.parts[1].I.shape == (3, 4, 2 * 16 * 32)
    assert torch.equal(pb.F[1][:, 6], pb.parts[1].gm.fwd_x)


def test_exchange_bands_across_groups():
    t = torch.arange(4 * 6 * 2, dtype=torch.float32).reshape(4, 6, 2)
    parts = [t[:1].clone(), t[1:3].clone(), t[3:].clone()]
    sharded.exchange_bands(parts)
    got = torch.cat(parts)
    assert got[0, 0].eq(0).all() and got[3, -1].eq(0).all()
    for j in range(1, 4):
        assert torch.equal(got[j, 0], t[j - 1, -2])
        assert torch.equal(got[j - 1, -1], t[j, 1])
    assert torch.equal(got[:, 1:-1], t[:, 1:-1])


def test_banded_cg_reads_the_stacks_in_place(monkeypatch):
    """On a one-device mesh the depth CG's shards hold the placed problem's
    F and R0 stacks and the state's z bands themselves: no per-solve copy."""
    data, cfg = _lambertian("std")
    prob, st = prepare(data, cfg, CPU)
    mesh = scg.make_mesh_1d(4, CPU)
    pb = sharded.shard_problem_rows(prob, mesh)
    sb = sharded.shard_state_rows(st, mesh)
    seen = []
    new = sk.new_shards

    def spy(devices, **kw):
        seen.append(kw)
        return new(devices, **kw)

    monkeypatch.setattr(sk, "new_shards", spy)
    sharded.srps_iteration_sharded(sb, pb, 2, cfg)
    (kw,) = seen
    assert kw["F"] is pb.F[0] and kw["R0"] is pb.R0[0]
    assert kw["x0"] is sb.parts[0].z


def test_placement_refuses_indivisible_heights():
    _, _, tp, ts = _pair(32, 32)
    with pytest.raises(ValueError, match=r"grid \(32, 32\)"):
        sharded.shard_problem_rows(tp, scg.make_mesh_1d(3, CPU))
    with pytest.raises(ValueError, match="multiple of sf=2"):
        sharded.shard_pytree(tp, sharded.make_mesh(32, devices="cpu"))
    mesh = sharded.make_mesh(4, data=2, devices="cpu")
    with pytest.raises(ValueError, match="one data group"):
        sharded.shard_pytree(tp, mesh)


def test_one_spatial_device_runs_the_unsharded_step():
    """x y = 1: the lane lives whole on its device and steps as
    ``srps.srps_iteration`` does, bit for bit."""
    _, _, tp, ts = _pair(32, 32)
    mesh = sharded.make_mesh(2, data=2, devices="cpu")
    from srmeetsps_cuda_tpu_torch.parallel.batched import (stack_problems,
                                                           stack_states)

    lanes = sharded.step_sharded(
        sharded.shard_pytree(stack_states([ts, ts]), mesh, batched=True),
        sharded.shard_pytree(stack_problems([tp, tp]), mesh, batched=True),
        2, SolverConfig(max_iterations=2), mesh)
    ref = tsrps.srps_iteration(ts, tp, 2, SolverConfig(max_iterations=2))
    for out in lanes.trees:
        assert torch.equal(out.z, ref.z) and torch.equal(out.energy,
                                                         ref.energy)
