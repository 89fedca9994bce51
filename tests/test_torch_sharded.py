"""The port's row-sharded depth CG and solve (``parallel/shard_cg.py``,
``parallel/shard_kernels.py``, ``parallel/sharded.py``, ``--sharded``)
against the JAX package's.

The CG is held to JAX ``shard_cg.cg_sharded*`` on tests/test_shard_cg.py's
seeded 64 x 32 problem, with the same operator fields: equal iteration
counts, x within 1e-4 relative RMS after 2 iterations (the JAX suite's
bound, test_shard_cg.py:124) and 3e-2 after 12 (``chip_smoke.X_TOL``; the
grid is at least 40 x 32, where ROADMAP Queue 3 shows that bound holds).
The port's r0 comes from its per-shard prologue; JAX ``shard_cg`` is given
its residual b = rhs - M x0. The JAX references compile for seconds each,
so tier-1 keeps the standard CG at every sf and shard count; the rest is
marked ``slow``.
"""

import functools
import json

import jax
import numpy as np
import pytest
import torch
from jax.sharding import Mesh

import chip_smoke
from test_e2e import synthetic_data
from test_shard_cg import _setup
from srmeetsps_cuda_tpu import cli as jcli
from srmeetsps_cuda_tpu.config import SolverConfig as JConfig
from srmeetsps_cuda_tpu.models import srps as jsrps
from srmeetsps_cuda_tpu.parallel import shard_cg as jshard
from srmeetsps_cuda_tpu.parallel import sharded as jsharded
from srmeetsps_cuda_tpu.solve import pallas_cg
from srmeetsps_cuda_tpu_torch import cli, interop
from srmeetsps_cuda_tpu_torch.config import SolverConfig
from srmeetsps_cuda_tpu_torch.io.mat_loader import save_mat_dataset
from srmeetsps_cuda_tpu_torch.io.synthetic import lambertian_dataset
from srmeetsps_cuda_tpu_torch.models import srps as tsrps
from srmeetsps_cuda_tpu_torch.ops.gradients import GradientMasks
from srmeetsps_cuda_tpu_torch.parallel import shard_cg as scg
from srmeetsps_cuda_tpu_torch.parallel import shard_kernels as sk
from srmeetsps_cuda_tpu_torch.parallel import sharded
from srmeetsps_cuda_tpu_torch.solve import cgs_cg as cg
from srmeetsps_cuda_tpu_torch.solve import stencil_cg as sc

CPU = torch.device("cpu")
X_BOUND = {2: 1e-4, 12: chip_smoke.X_TOL[12]}
slow = pytest.mark.slow


@functools.lru_cache(maxsize=None)
def _problem(sf):
    """test_shard_cg._setup's problem at 64 x 32 in both packages, with the
    port's CG inputs made from the JAX arrays: ``(jax, port)``, each a dict
    of x0, op and invd = 1 / diag(M); the JAX one also holds the residual
    b = rhs - M x0."""
    import jax.numpy as jnp

    prob, st, op = _setup(np.random.default_rng(0), 64, 32, sf)
    mv = functools.partial(jsrps.depth_matvec, op=op, prob=prob, sf=sf,
                           lam=1.0)
    b = jsrps.depth_rhs(op, prob, sf, 1.0) - mv(st.z)
    invd = 1.0 / jsrps.depth_diag(op, prob, sf, 1.0)
    t = lambda a: torch.as_tensor(np.array(a, np.float32))  # noqa: E731
    port = {"x0": t(st.z), "op": tsrps.DepthOperator(*map(t, op)),
            "gm": GradientMasks(*map(t, prob.gm)), "ktw": t(prob.ktw),
            "z0t": t(prob.z0t), "invd": t(invd)}
    return ({"prob": prob, "x0": st.z, "op": op, "b": b, "invd": invd,
             "z": jnp.asarray(st.z)}, port)


@functools.lru_cache(maxsize=None)
def _jax_cg(variant, sf, cap):
    """JAX ``shard_cg.cg_sharded*`` on 8 CPU devices: (x, iterations)."""
    j, _ = _problem(sf)
    p = j["prob"]
    mesh = Mesh(np.array(jax.devices()[:8]), ("x",))
    common = (p.gm, p.mask, p.masks)
    kw = dict(sf=sf, lam=1.0, tol=1e-9, max_iter=cap)
    if variant == "jacobi":
        x, k, _ = jshard.cg_sharded_jacobi(mesh, "x", j["x0"], j["b"],
                                           j["invd"], j["op"], *common, **kw)
    else:
        fn = jshard.cg_sharded_cgs if variant == "cgs" else jshard.cg_sharded
        x, k, _ = fn(mesh, "x", j["x0"], j["b"], j["op"], *common, **kw)
    return np.asarray(x), int(k)


def _port_cg(variant, sf, n, cap, plain=False, mesh=None):
    _, p = _problem(sf)
    mesh = mesh or scg.make_mesh_1d(n, CPU)
    args = (p["x0"], p["op"], p["gm"], p["ktw"], p["z0t"])
    kw = dict(sf=sf, lam=1.0, max_iter=cap, plain=plain)
    if variant == "jacobi":
        return scg.cg_sharded_jacobi(mesh, p["x0"], p["invd"], *args[1:],
                                     **kw)
    fn = scg.cg_sharded_cgs if variant == "cgs" else scg.cg_sharded
    return fn(mesh, *args, **kw)


def _rel_rms(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.sqrt(np.mean((got - want) ** 2))
                 / np.sqrt(np.mean(want ** 2)))


def _cases():
    """(variant, sf, n, cap): tier-1 keeps the standard CG at cap 2 on every
    sf and shard count and cap 12 at sf 2 (the Jacobi form is held to the
    JAX package in tier-1 by test_solve_fused_sharded_matches_jax).
    After 12 iterations at sf 4 this problem's x is no invariant: a float64
    CG lies 0.22-0.31 (relative RMS) from the port's and the JAX package's
    f32 CGs (ROADMAP Queue 3), so sf 4 is held after 2."""
    out = []
    for variant in ("std", "cgs", "jacobi"):
        for sf in (1, 2, 4):
            for n in (1, 2, 4, 8):
                for cap in (2, 12) if sf < 4 else (2,):
                    tier1 = variant == "std" and (
                        cap == 2 or (sf == 2 and n in (2, 8)))
                    out.append(pytest.param(
                        variant, sf, n, cap, marks=() if tier1 else slow,
                        id=f"{variant}-sf{sf}-n{n}-cap{cap}"))
    return out


@pytest.mark.parametrize("variant,sf,n,cap", _cases())
def test_sharded_cg_matches_jax(variant, sf, n, cap):
    xj, kj = _jax_cg(variant, sf, cap)
    x, k, _ = _port_cg(variant, sf, n, cap)
    assert int(k) == kj
    assert _rel_rms(x.numpy(), xj) < X_BOUND[cap]


@pytest.mark.parametrize("n", [2, 8])
def test_sharded_cgs_two_iterations_match_jax_standard_cg(n):
    """At 2 iterations CGS is standard CG algebraically: the port's sharded
    CGS against JAX ``cg_sharded`` (test_shard_cg.py:222-242's bound)."""
    xj, kj = _jax_cg("std", 2, 2)
    x, k, _ = _port_cg("cgs", 2, n, 2)
    assert int(k) == kj
    np.testing.assert_allclose(x.numpy(), xj, rtol=1e-4, atol=1e-4)


@pytest.fixture
def interpret(monkeypatch):
    monkeypatch.setattr(pallas_cg, "INTERPRET", True)


@pytest.mark.parametrize("variant,sf", [
    ("cgs", 2), pytest.param("std", 2, marks=slow),
    pytest.param("jacobi", 2, marks=slow), pytest.param("cgs", 4, marks=slow),
    pytest.param("std", 4, marks=slow)])
def test_sharded_cg_matches_shard_pallas_kernels(variant, sf, interpret):
    """The port's CG against the TPU kernels 10-14 themselves
    (``shard_pallas.cg_sharded_pallas_*`` in interpret mode) on 2 shards, 2
    iterations."""
    from srmeetsps_cuda_tpu.parallel import shard_pallas

    j, _ = _problem(sf)
    p = j["prob"]
    mesh = Mesh(np.array(jax.devices()[:2]), ("x",))
    assert shard_pallas.shard_pallas_supported(64, 32, sf, 2)
    fn = (shard_pallas.cg_sharded_pallas_cgs if variant == "cgs"
          else shard_pallas.cg_sharded_pallas_std)
    xj, kj, _ = fn(mesh, "x", j["z"], j["op"], p.gm, p.mask, p.masks, p.z0t,
                   sf=sf, lam=1.0, tol=1e-9, max_iter=2,
                   invd=j["invd"] if variant == "jacobi" else None)
    x, k, _ = _port_cg(variant, sf, 2, 2)
    assert int(k) == int(kj)
    assert _rel_rms(x.numpy(), np.asarray(xj)) < X_BOUND[2]


def test_solve_fused_sharded_matches_jax(rng):
    """The whole sharded solve on 8 shards against JAX
    ``solve_fused_sharded`` (its jnp halo-exchange PCG on 8 CPU devices) with
    test_shard_cg.py:161-184's configuration and bounds: equal outer
    iterations, energies at rtol 1e-3."""
    prob, st, _ = _setup(rng, 64, 32, 2)
    jcfg = JConfig(max_iterations=3, jacobi_preconditioner=True,
                   cg_max_iter=30)
    mesh = jsharded.make_mesh_1d(8)
    out, trace = jax.jit(functools.partial(
        jsharded.solve_fused_sharded, sf=2, cfg=jcfg, mesh=mesh))(
        jsharded.shard_pytree_rows(st, mesh),
        jsharded.shard_pytree_rows(prob, mesh))
    tp = interop.problem_from_numpy(prob, CPU)
    ts = interop.state_from_numpy(st, CPU)
    cfg = SolverConfig(max_iterations=3, jacobi_preconditioner=True,
                       cg_max_iter=30)
    final, ttrace = sharded.solve_fused_sharded(
        ts, tp, 2, cfg, scg.make_mesh_1d(8, CPU))
    n_it = int(out.iteration)
    assert final.iteration == n_it
    np.testing.assert_allclose(ttrace[:n_it].numpy(),
                               np.asarray(trace)[:n_it], rtol=1e-3)
    assert interop.to_numpy(final)["z"].shape == (64, 32)


@pytest.mark.parametrize("n", [1, 4])
def test_dryrun_holds_sharded_to_unsharded_solve(n):
    traces = sharded.dryrun(n)
    assert len(traces) == 3 and all(np.all(np.isfinite(t)) for t in traces)


def test_repeated_sharded_solve_is_bit_equal():
    data, _ = lambertian_dataset(64, 32, 2, n=4, c=3, seed=1)
    prob, st, _ = chip_smoke.depth_operator(data, CPU)
    cfg = SolverConfig(max_iterations=2, cg_max_iter=15, inpaint_iters=8)
    mesh = scg.make_mesh_1d(4, CPU)
    runs = [sharded.solve_fused_sharded(st, prob, 2, cfg, mesh)
            for _ in range(2)]
    n_it = runs[0][0].iteration
    assert n_it == runs[1][0].iteration
    assert torch.equal(runs[0][1][:n_it], runs[1][1][:n_it])
    assert torch.equal(runs[0][0].z, runs[1][0].z)
    for variant in ("std", "cgs", "jacobi"):
        a, b = (_port_cg(variant, 2, 4, 12) for _ in range(2))
        assert all(torch.equal(u, v) for u, v in zip(a, b)), variant


def _faulty(ops, fault):
    """``ops`` with one halo read as 0 by a per-shard step."""
    def zero_halo(t):
        t[..., 0, :] = 0
        t[..., -1, :] = 0

    if fault == "r halo in sweep A":
        def step_a(s, k):
            zero_halo(s.r)
            ops.step_a(s, k)
        return dict(vars(ops), step_a=step_a)
    if fault == "(r, w, s) halo in the CGS sweep":
        def cgs_step(s, k):
            zero_halo(s.rws)
            ops.cgs_step(s, k)
        return dict(vars(ops), cgs_step=cgs_step)
    if fault == "rz from <r, r> in sweep B":
        def step_b(s, k):
            ops.step_b(s, k)
            s.own[1] = s.own[0]
        return dict(vars(ops), step_b=step_b)
    assert fault == "F halo in the prologue"

    def prologue(s):
        zero_halo(s.F)
        ops.prologue(s)
    return dict(vars(ops), prologue=prologue)


FAULTS = {"std": ("r halo in sweep A", "F halo in the prologue"),
          "cgs": ("(r, w, s) halo in the CGS sweep",
                  "F halo in the prologue")}


@pytest.mark.parametrize("variant", ["std", "cgs"])
def test_chip_bounds_catch_a_halo_read_as_zero(variant, monkeypatch):
    """``chip_smoke.py`` phase 3g holds the 4-shard CG to the unsharded
    plain CG by the update x - x0 and the residual, from the warm and a cold
    start (``UPD_BOUND``, ``RES_BOUND``). The plain per-shard steps stay
    inside every bound; a step that reads a halo row as 0 fails one."""
    from types import SimpleNamespace

    data, _ = lambertian_dataset(96, 64, 2, n=8, c=3, seed=2)
    prob, st, op = chip_smoke.depth_operator(data, CPU)
    mesh = scg.make_mesh_1d(4, CPU)
    fn = scg.cg_sharded_cgs if variant == "cgs" else scg.cg_sharded
    plain = sk.PLAIN
    caught = {}
    for fault in (None,) + FAULTS[variant]:
        ops = plain if fault is None else SimpleNamespace(
            **_faulty(plain, fault))
        monkeypatch.setattr(sk, "PLAIN", ops)
        caught[fault] = []
        for start, cap in [(s, c) for s in ("warm", "cold") for c in (2, 12)]:
            x0 = st.z if start == "warm" else torch.zeros_like(st.z)
            args = (x0, op, prob.gm, prob.ktw, prob.z0t)
            if variant == "cgs":
                px, _, pr = cg.cgs_cg_plain(*args, sf=2, lam=1.0,
                                            max_iter=cap)
            else:
                px, _, pr, _ = sc.stencil_cg_plain(*args, prob.z0u, sf=2,
                                                   lam=1.0, max_iter=cap)
            x, _, r = fn(mesh, *args, sf=2, lam=1.0, max_iter=cap,
                         plain=True)
            upd = chip_smoke.rel_rms(x - x0, px - x0)
            gap = abs(float(r) - float(pr)) / abs(float(pr))
            if upd > chip_smoke.UPD_BOUND[start][cap]:
                caught[fault].append(f"{start} update cap {cap}: {upd:.2e}")
            if gap > chip_smoke.RES_BOUND[start][cap]:
                caught[fault].append(f"{start} residual cap {cap}: {gap:.2e}")
    assert not caught.pop(None)
    assert all(caught.values()), caught


@functools.lru_cache(maxsize=None)
def _solve_case(form):
    data, _ = lambertian_dataset(96, 64, 2, n=8, c=3, seed=2)
    cfg = SolverConfig(max_iterations=3,
                       jacobi_preconditioner=form == "jacobi")
    return data, cfg, float(chip_smoke.depth_operator(data, CPU)[2].const)


def _plain_solve_trace(form):
    """``chip_smoke.py`` phase 4j's reference: the energies of the sharded
    solve with the plain per-shard steps (``sk.PLAIN``) on 4 shards."""
    from srmeetsps_cuda_tpu_torch.runtime.solver import prepare

    data, cfg, _ = _solve_case(form)
    prob, st = prepare(data, cfg, CPU)
    with chip_smoke.plain_shard_steps():
        final, trace = sharded.solve_fused_sharded(
            st, prob, 2, cfg, scg.make_mesh_1d(4, CPU))
    return trace[:final.iteration].tolist()


@functools.lru_cache(maxsize=None)
def _sound_trace(form):
    trace = _plain_solve_trace(form)
    assert _plain_solve_trace(form) == trace
    return trace


@pytest.mark.parametrize("form,fault", [
    ("jacobi", "r halo in sweep A"), ("jacobi", "F halo in the prologue"),
    ("jacobi", "rz from <r, r> in sweep B"), ("std", "r halo in sweep A")])
def test_phase_4j_energy_bound_catches_a_faulty_step(form, fault,
                                                     monkeypatch):
    """Phase 4j holds the sharded solve's energies to the plain-step run's
    at ``energy_bound(first, const)`` per outer iteration. A solve whose
    per-shard steps read a halo as 0, or take rz from <r, r>, lands outside
    it (printed with ``-s``), while the plain steps repeat the reference
    exactly. (Sweep A's p built from r in place of
    invd r is not caught where the CG converges: it is a descent method
    all the same.)"""
    from types import SimpleNamespace

    _, _, const = _solve_case(form)
    sound = _sound_trace(form)
    monkeypatch.setattr(sk, "PLAIN",
                        SimpleNamespace(**_faulty(sk.PLAIN, fault)))
    faulty = _plain_solve_trace(form)
    ratio = max(abs(x - y) for x, y in zip(faulty, sound)) \
        / chip_smoke.energy_bound(sound[0], const)
    print(f"{form}, {fault}: max energy gap {ratio:.3g} of the bound")
    assert ratio > 5, (ratio, faulty, sound)


def _mat(tmp_path, h=32, w=32):
    data, _ = synthetic_data(np.random.default_rng(0), h=h, w=w, sf=2)
    path = str(tmp_path / "ds.mat")
    save_mat_dataset(path, data, fmt="mat5")
    return path


def test_cli_sharded_matches_jax_cli(tmp_path, capsys):
    """``--cpu --sharded 4`` against the JAX CLI's ``--sharded 4`` (jnp
    halo-exchange CG on 4 of the 8 CPU devices): the printed energies of
    every outer iteration, the metrics and the outputs."""
    path = _mat(tmp_path)
    argv = ["--dsloc", path, "--sharded", "4", "--cg-max-iter", "10",
            "--max-iterations", "3"]
    metrics, out = tmp_path / "m.jsonl", tmp_path / "out"

    def energies(main, extra):
        assert main(argv + extra) == 0
        text = capsys.readouterr().out
        assert "sharded solve (4 devices)" in text and "Done!" in text
        return [float(line.split("Error:")[1]) for line in text.splitlines()
                if line.startswith("Iteration ")]

    mine = energies(cli.main, ["--cpu", "--metrics-jsonl", str(metrics),
                               "--dump", "--dump-format", "npz",
                               "--dump-dir", str(out)])
    theirs = energies(jcli.main, [])
    assert len(mine) == len(theirs) > 0
    np.testing.assert_allclose(mine, theirs, rtol=1e-3)
    recs = [json.loads(line) for line in metrics.read_text().splitlines()]
    assert recs[-1]["devices"] == 4 and recs[-1]["iterations"] == len(mine)
    assert np.all(np.isfinite(np.load(out / "state_final.npz")["z"]))


def test_cli_sharded_refuses_indivisible_heights(tmp_path):
    path = _mat(tmp_path, h=36)
    with pytest.raises(SystemExit, match="divisible by 8"):
        cli.main(["--dsloc", path, "--cpu", "--sharded", "8"])


def test_mesh_halo_exchange_and_all_reduce():
    mesh = scg.make_mesh_1d(3, CPU)
    assert mesh.devices == (CPU,) * 3
    with pytest.raises(ValueError, match="3 devices"):
        scg.make_mesh_1d(3, [CPU, CPU])
    t = torch.arange(6 * 2, dtype=torch.float32).reshape(6, 2)
    bands = scg.scatter_rows(t, mesh, halo=True)
    assert [tuple(b.shape) for b in bands] == [(4, 2)] * 3
    assert torch.equal(bands[0][0], torch.zeros(2))
    assert torch.equal(bands[2][-1], torch.zeros(2))
    assert torch.equal(bands[1], t[1:5])
    assert torch.equal(scg.gather_rows([sk.inner(b) for b in bands], CPU), t)
    planes = [torch.full((6, 2), float(i)) for i in range(3)]
    scg.exchange_halos(planes, k=2)
    assert planes[0][:2].eq(0).all() and planes[2][-2:].eq(2).all()
    assert planes[1][:2].eq(0).all() and planes[1][-2:].eq(2).all()
    assert planes[0][-2:].eq(1).all() and planes[2][:2].eq(1).all()
    owns = [torch.tensor([1.0, 2.0], dtype=torch.float64) * i
            for i in range(3)]
    gathered = [torch.zeros(3, 2, dtype=torch.float64) for _ in range(3)]
    scg.all_reduce(owns, gathered)
    assert all(torch.equal(g, torch.stack(owns)) for g in gathered)
    assert scg.check_rows(64, 8, 4) == 8
    with pytest.raises(ValueError, match="multiple of sf=4"):
        scg.check_rows(48, 8, 4)


def test_wrappers_take_plain_versions_on_cpu():
    before = (sk.prologue.launches, sk.step_a.launches, sk.step_b.launches,
              sk.cgs_step.launches)
    for variant in ("std", "cgs", "jacobi"):
        got = _port_cg(variant, 2, 2, 3)
        want = _port_cg(variant, 2, 2, 3, plain=True)
        assert all(torch.equal(a, b) for a, b in zip(got, want))
    assert before == (sk.prologue.launches, sk.step_a.launches,
                      sk.step_b.launches, sk.cgs_step.launches)
    meta = scg.make_mesh_1d(2, "meta")
    with pytest.raises(ValueError, match="cpu or cuda"):
        _port_cg("std", 2, 2, 3, mesh=meta)


@pytest.mark.cuda
@pytest.mark.parametrize("variant", ["std", "cgs", "jacobi"])
def test_cuda_shards_match_plain(variant):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    mesh = scg.make_mesh_1d(4, "cuda")
    counter = {"std": sk.step_a, "cgs": sk.cgs_step, "jacobi": sk.step_b}
    before = counter[variant].launches
    x, k, _ = _port_cg(variant, 2, 4, 12, mesh=mesh)
    torch.cuda.synchronize()
    assert counter[variant].launches > before
    px, pk, _ = _port_cg(variant, 2, 4, 12, mesh=mesh, plain=True)
    assert int(k) == int(pk)
    assert _rel_rms(x.cpu().numpy(), px.cpu().numpy()) < X_BOUND[12]
