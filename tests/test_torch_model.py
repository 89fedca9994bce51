"""The port's model estimators against the JAX package's on the same seeded
problem (tests/test_trajectory.py's render fixture and conftest's random
problem). Lighting rtol 1e-4 (the 4x4 adjugate amplifies roundoff); the
moments, albedo and depth-operator fields rtol 1e-5."""

import dataclasses

import numpy as np
import pytest
import torch

from test_trajectory import _trajectory_fixture
from srmeetsps_cuda_tpu import config as jconfig
from srmeetsps_cuda_tpu.models import srps as jsrps
from srmeetsps_cuda_tpu_torch import config as tconfig
from srmeetsps_cuda_tpu_torch import interop
from srmeetsps_cuda_tpu_torch.models import srps as tsrps

CPU = torch.device("cpu")
OP_FIELDS = ("P11", "P12", "P13", "P22", "P23", "P33", "QB1", "QB2", "QB3")


def _close(got, want, rtol, scale=True):
    got, want = np.asarray(got), np.asarray(want)
    atol = rtol * np.abs(want).max() if scale else 0.0
    np.testing.assert_allclose(got, want, rtol=rtol, atol=atol)


@pytest.fixture
def pair(rng):
    """(JAX prob, state, sf) of the trajectory render fixture."""
    jp, js, _, _, sf, _ = _trajectory_fixture(rng)
    return jp, js, sf


def test_config_defaults_match_jax():
    for ours, theirs in [(tconfig.SolverConfig(), jconfig.SolverConfig()),
                         (tconfig.RuntimeConfig(), jconfig.RuntimeConfig()),
                         (tconfig.Preferences(), jconfig.Preferences())]:
        mine = dataclasses.asdict(ours)
        ref = dataclasses.asdict(theirs)
        ref["cg_variant"] = ref.get("pallas_cg_variant")
        for k, v in mine.items():
            assert ref[k] == v, k


def test_build_problem_and_init_state_match(small_problem):
    sp = small_problem
    K = [[sp["fx"], 0, sp["cx"]], [0, sp["fy"], sp["cy"]], [0, 0, 1]]
    z0s = sp["z0"][0]
    jp = jsrps.build_problem(sp["I"], sp["mask"], K, sp["sf"], z0s)
    tp = tsrps.build_problem(sp["I"], sp["mask"], K, sp["sf"], z0s, CPU)
    for name in ("I", "mask", "masks", "z0s", "xx", "yy", "SI2", "z0t", "ktw"):
        _close(getattr(tp, name), getattr(jp, name), 1e-6)
    assert tp.fx == float(jp.fx) and tp.fy == float(jp.fy)
    for a, b in zip(tp.gm, jp.gm):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    js = jsrps.init_state(jp, sp["z"])
    ts = tsrps.init_state(tp, sp["z"])
    for name in ("z", "rho", "s", "N", "dz"):
        _close(getattr(ts, name), getattr(js, name), 1e-6)
    assert ts.iteration == 0 and np.isnan(float(ts.energy))


def test_interop_roundtrip(pair):
    jp, js, sf = pair
    tp = interop.problem_from_numpy(jp, CPU)
    back = interop.to_numpy(tp)
    for name in ("I", "mask", "z0t", "ktw"):
        np.testing.assert_array_equal(back[name], np.asarray(getattr(jp, name)))
    for a, b in zip(back["gm"], jp.gm):
        np.testing.assert_array_equal(a, np.asarray(b))
    ts = interop.state_from_numpy(js._asdict(), CPU)
    assert ts.iteration == int(js.iteration)
    np.testing.assert_array_equal(interop.to_numpy(ts)["N"], np.asarray(js.N))


def test_estimators_match(pair):
    jp, js, sf = pair
    tp = interop.problem_from_numpy(jp, CPU)
    ts = interop.state_from_numpy(js, CPU)
    s_j = jsrps.estimate_lighting(jp, js.rho, js.N, js.s)
    s_t = tsrps.estimate_lighting(tp, ts.rho, ts.N, ts.s)
    _close(s_t, s_j, 1e-4)
    # Downstream of one lighting: feed both the JAX s, so each estimator
    # is compared on identical inputs.
    s = np.asarray(s_j)
    mj = jsrps.s_moments(jp, s)
    mt = tsrps.s_moments(tp, torch.from_numpy(np.array(s)))
    _close(mt.G, mj.G, 1e-5)
    _close(mt.J, mj.J, 1e-5)
    rj = jsrps.estimate_albedo(jp, mj, js.N, js.rho)
    rt = tsrps.estimate_albedo(tp, mt, ts.N, ts.rho)
    _close(rt, rj, 1e-5)
    rho = np.asarray(rj)
    opj = jsrps.build_depth_operator(jp, mj, rho, js.dz, 1.0)
    opt = tsrps.build_depth_operator(tp, mt, torch.from_numpy(np.array(rho)),
                                     ts.dz, 1.0)
    for name in OP_FIELDS:
        _close(getattr(opt, name), getattr(opj, name), 1e-5)
    # const = sum B^2 and the energy are sums of terms far larger than
    # themselves (sum I^2 - 2 sum rho J + ...): the suite's energy bound.
    _close(opt.const, opj.const, 5e-4, scale=False)
    _close(tsrps.depth_rhs(opt, tp, sf, 1.0), jsrps.depth_rhs(opj, jp, sf, 1.0),
           1e-5)
    _close(tsrps.depth_diag(opt, tp, sf, 1.0),
           jsrps.depth_diag(opj, jp, sf, 1.0), 1e-5)
    v = np.asarray(js.z)
    _close(tsrps.depth_matvec(ts.z, opt, tp, sf, 1.0),
           jsrps.depth_matvec(v, opj, jp, sf, 1.0), 1e-5)
    _close(tsrps.depth_energy(ts.z, opt, tp, sf, 1.0),
           jsrps.depth_energy(v, opj, jp, sf, 1.0), 5e-4, scale=False)


def test_degenerate_channel_keeps_previous_lighting_and_albedo(pair):
    """Channel 0 with zero albedo makes its 4x4 Gram singular: the solve
    goes non-finite and s_prev is kept (srps.py:255-260); an all-zero
    lighting makes den = 0 and rho_prev is kept (srps.py:372)."""
    jp, js, sf = pair
    tp = interop.problem_from_numpy(jp, CPU)
    ts = interop.state_from_numpy(js, CPU)
    rho = np.array(js.rho)
    rho[0] = 0.0
    s_prev = np.random.default_rng(3).standard_normal(js.s.shape).astype(
        np.float32)
    s_j = np.asarray(jsrps.estimate_lighting(jp, rho, js.N, s_prev))
    s_t = tsrps.estimate_lighting(tp, torch.from_numpy(rho), ts.N,
                                  torch.from_numpy(s_prev)).numpy()
    np.testing.assert_array_equal(s_t[:, 0], s_prev[:, 0])
    np.testing.assert_array_equal(s_j[:, 0], s_prev[:, 0])
    _close(s_t[:, 1:], s_j[:, 1:], 1e-4)

    s = np.array(s_j)
    s[:, 1] = 0.0
    rho_prev = np.full(np.asarray(js.rho).shape, 0.25, np.float32)
    mt = tsrps.s_moments(tp, torch.from_numpy(s))
    rt = tsrps.estimate_albedo(tp, mt, ts.N, torch.from_numpy(rho_prev))
    rj = jsrps.estimate_albedo(jp, jsrps.s_moments(jp, s), js.N, rho_prev)
    mask = np.asarray(jp.mask)
    np.testing.assert_array_equal(rt[1].numpy(), 0.25 * mask)
    _close(rt, rj, 1e-5)


def test_iteration_one_matches_jnp_path(pair):
    """One outer iteration with the generic CG path on both sides
    (Jacobi PCG on the CPU; use_pallas=False in JAX): same CG iteration
    count, energy and depth to f32 roundoff at a short cap."""
    jp, js, sf = pair
    tp = interop.problem_from_numpy(jp, CPU)
    ts = interop.state_from_numpy(js, CPU)
    kw = dict(cg_max_iter=3, jacobi_preconditioner=True)
    jn = jsrps.srps_iteration(js, jp, sf, jconfig.SolverConfig(**kw))
    tn = tsrps.srps_iteration(ts, tp, sf, tconfig.SolverConfig(**kw))
    assert int(tn.cg_iters) == int(jn.cg_iters) == 4
    assert tn.iteration == int(jn.iteration) == 1
    _close(tn.z, jn.z, 1e-4)
    _close(tn.energy, jn.energy, 1e-4, scale=False)


def test_should_stop_semantics():
    cfg = tconfig.SolverConfig(max_iterations=3)
    nan = float("nan")

    def st(e, last, it):
        return tsrps.SRPSState(None, None, None, None, None, torch.tensor(e),
                               torch.tensor(last), it, None)

    assert not bool(tsrps.should_stop(st(10.0, nan, 1), cfg))
    assert bool(tsrps.should_stop(st(11.0, 10.0, 2), cfg))  # increase
    assert bool(tsrps.should_stop(st(10.0, 10.01, 2), cfg))  # rel < tol
    assert not bool(tsrps.should_stop(st(9.0, 10.0, 3), cfg))
    assert bool(tsrps.should_stop(st(9.0, 10.0, 4), cfg))  # cap


@pytest.mark.parametrize("case", ["cgs", "jacobi-off-cpu"])
def test_unported_depth_solvers_raise(pair, case):
    """Jacobi off the CPU (a meta tensor stands in for a CUDA one), with
    the standard or the CGS variant, refuses before any arithmetic instead
    of running another solver."""
    jp, js, sf = pair
    tp = interop.problem_from_numpy(jp, CPU)
    ts = interop.state_from_numpy(js, CPU)
    mom = tsrps.s_moments(tp, ts.s)
    variant = "cgs" if case == "cgs" else "pipe"
    cfg = tconfig.SolverConfig(jacobi_preconditioner=True, cg_variant=variant)
    z = ts.z.to("meta")
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        tsrps.estimate_depth(tp, mom, ts.rho, ts.dz, z, sf, cfg)


@pytest.mark.parametrize("jacobi", [False, True])
def test_generic_cg_matches_jax(pair, jacobi):
    """solve/cg.py against the JAX conjugate_gradient on the depth system:
    same iteration count (cap + 1), x and residual to f32 roundoff after
    3 iterations."""
    from functools import partial

    from srmeetsps_cuda_tpu.solve.cg import conjugate_gradient as jcg
    from srmeetsps_cuda_tpu_torch.solve.cg import conjugate_gradient as tcg

    jp, js, sf = pair
    tp = interop.problem_from_numpy(jp, CPU)
    ts = interop.state_from_numpy(js, CPU)
    mj = jsrps.s_moments(jp, js.s)
    opj = jsrps.build_depth_operator(jp, mj, js.rho, js.dz, 1.0)
    opt = tsrps.build_depth_operator(tp, tsrps.s_moments(tp, ts.s), ts.rho,
                                     ts.dz, 1.0)
    mvj = partial(jsrps.depth_matvec, op=opj, prob=jp, sf=sf, lam=1.0)
    mvt = partial(tsrps.depth_matvec, op=opt, prob=tp, sf=sf, lam=1.0)
    bj = jsrps.depth_rhs(opj, jp, sf, 1.0) - mvj(js.z)
    bt = tsrps.depth_rhs(opt, tp, sf, 1.0) - mvt(ts.z)
    dj = jsrps.depth_diag(opj, jp, sf, 1.0)
    dt = tsrps.depth_diag(opt, tp, sf, 1.0)
    rj = jcg(mvj, bj, js.z, tol=1e-9, max_iter=2,
             precond=(lambda r: r / dj) if jacobi else None)
    rt = tcg(mvt, bt, ts.z, tol=1e-9, max_iter=2,
             precond=(lambda r: r / dt) if jacobi else None)
    assert int(rt.iterations) == int(rj.iterations) == 3
    _close(rt.x, rj.x, 1e-4)
    _close(rt.residual_sq, rj.residual_sq, 1e-3, scale=False)
