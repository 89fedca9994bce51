"""The port's Chronopoulos-Gear CG against the JAX package's Pallas kernel
``pallas_cg_cgs._kernel`` (interpret mode).

The CGS recurrence reorders standard CG's rounding, and the CG is
ill-conditioned and unconverged at these caps, so iterates are held to the
JAX suite's own CGS bounds (tests/test_pallas_cg.py:246): relative RMS of
x within 1e-4 after 2 iterations and 5e-2 after 12, with equal iteration
counts.
"""

import functools

import numpy as np
import pytest
import torch

import chip_smoke
from test_pallas_cg import _problem
from srmeetsps_cuda_tpu.config import SolverConfig as JConfig
from srmeetsps_cuda_tpu.models import srps as jsrps
from srmeetsps_cuda_tpu.solve import pallas_cg
from srmeetsps_cuda_tpu.solve.pallas_cg_cgs import cg_pallas_cgs
from srmeetsps_cuda_tpu_torch import interop
from srmeetsps_cuda_tpu_torch import trace as tracing
from srmeetsps_cuda_tpu_torch.config import SolverConfig
from srmeetsps_cuda_tpu_torch.io.synthetic import lambertian_dataset
from srmeetsps_cuda_tpu_torch.models import srps as tsrps
from srmeetsps_cuda_tpu_torch.solve import cgs_cg as cg
from srmeetsps_cuda_tpu_torch.solve import stencil_cg as sc

CPU = torch.device("cpu")


@pytest.fixture(autouse=True)
def interpret_mode(monkeypatch):
    monkeypatch.setattr(pallas_cg, "INTERPRET", True)


@functools.lru_cache(maxsize=None)
def _both(h, w, sf, seed=0):
    """The same seeded problem in both packages: (JAX prob, state, mom, op)
    and (port prob, state, mom, op). Cached: no test modifies them."""
    jp, js, jm, jop = _problem(np.random.default_rng(seed), h, w, sf)
    tp = interop.problem_from_numpy(jp, CPU)
    ts = interop.state_from_numpy(js, CPU)
    tm = tsrps.s_moments(tp, ts.s)
    top = tsrps.build_depth_operator(tp, tm, ts.rho, ts.dz, 1.0)
    return (jp, js, jm, jop), (tp, ts, tm, top)


def _rel_rms(got, want):
    want = np.asarray(want)
    d = np.asarray(got) - want
    return float(np.sqrt(np.mean(d ** 2)) / max(np.sqrt(np.mean(want ** 2)),
                                                1e-12))


@pytest.mark.parametrize("sf", [1, 2, 4])
def test_plain_cgs_matches_pallas_cgs(sf):
    (jp, js, _, jop), (tp, ts, _, top) = _both(40, 32, sf)
    for max_iter, bound in [(2, 1e-4), (12, 5e-2)]:
        xj, kj, rj = cg_pallas_cgs(js.z, jop, jp.gm, jp.ktw, jp.z0t, sf=sf,
                                   lam=1.0, tol=1e-4, max_iter=max_iter)
        xt, kt, rt = cg.cgs_cg(ts.z, top, tp.gm, tp.ktw, tp.z0t, sf=sf,
                               lam=1.0, tol=1e-4, max_iter=max_iter)
        assert int(kt) == int(kj), max_iter
        assert _rel_rms(xt.numpy(), xj) < bound, max_iter


def test_batched_plain_lanes_match_solo():
    lanes = [_both(32, 32, 2, seed=b)[1] for b in range(2)]
    args = [(ts.z, top, tp.gm, tp.ktw, tp.z0t) for tp, ts, _, top in lanes]
    stack = lambda i: torch.stack([a[i] for a in args])  # noqa: E731
    op = type(args[0][1])(*(torch.stack(f) for f in zip(*[a[1] for a in args])))
    gm = type(args[0][2])(*(torch.stack(f) for f in zip(*[a[2] for a in args])))
    xb, kb, rb = cg.cgs_cg_plain(stack(0), op, gm, stack(3), stack(4), sf=2,
                                 lam=1.0, tol=1e-4, max_iter=10)
    assert xb.shape == (2, 32, 32) and kb.shape == rb.shape == (2,)
    for b, a in enumerate(args):
        x1, k1, r1 = cg.cgs_cg_plain(*a, sf=2, lam=1.0, tol=1e-4, max_iter=10)
        assert int(kb[b]) == int(k1)
        np.testing.assert_allclose(xb[b].numpy(), x1.numpy(), rtol=1e-6,
                                   atol=1e-6)


def test_converged_lane_stops_and_cap_runs_max_iter_plus_one():
    """At sf = 1 the system converges below a loose tolerance and the lane
    stops early; at the unreachable default tolerance the cap decides."""
    _, (tp, ts, _, top) = _both(16, 32, 1)
    args = (ts.z, top, tp.gm, tp.ktw, tp.z0t)
    _, k_loose, r_loose = cg.cgs_cg_plain(*args, sf=1, lam=1.0, tol=1e-2,
                                          max_iter=50)
    assert int(k_loose) < 51 and float(r_loose) <= 1e-4
    _, (tp, ts, _, top) = _both(16, 32, 2)
    for cap in (0, 1, 5):
        _, k, _ = cg.cgs_cg_plain(ts.z, top, tp.gm, tp.ktw, tp.z0t, sf=2,
                                  lam=1.0, max_iter=cap)
        assert int(k) == cap + 1


def test_estimate_depth_cgs_matches_jax():
    """estimate_depth with cg_variant="cgs" against the JAX package's CGS
    routing (use_pallas, pallas_cg_variant="cgs"), at the JAX suite's
    energy bound for this route (tests/test_pallas_cg.py:297, 5e-2). The
    observed gap is far smaller: equal iteration counts (26), energies
    1242.93 (JAX) and 1242.86 (port), 5.3e-5 apart relative, and depths
    6e-4 apart in relative RMS."""
    (jp, js, jm, _), (tp, ts, tm, _) = _both(32, 32, 2)
    zj, ej, kj = jsrps.estimate_depth(
        jp, jm, js.rho, js.dz, js.z, 2,
        JConfig(cg_tol=1e-4, cg_max_iter=25, use_pallas=True,
                pallas_cg_variant="cgs"))
    zt, et, kt = tsrps.estimate_depth(
        tp, tm, ts.rho, ts.dz, ts.z, 2,
        SolverConfig(cg_tol=1e-4, cg_max_iter=25, cg_variant="cgs"))
    assert int(kt) == int(kj)
    np.testing.assert_allclose(float(et), float(ej), rtol=5e-2)
    assert np.all(zt.numpy()[np.asarray(jp.mask) == 0] == 0)


def test_wrapper_takes_plain_version_on_cpu():
    _, (tp, ts, _, top) = _both(16, 32, 2)
    args = (ts.z, top, tp.gm, tp.ktw, tp.z0t)
    before = tracing.launch_counts()
    got = cg.cgs_cg(*args, sf=2, lam=1.0, max_iter=3)
    want = cg.cgs_cg_plain(*args, sf=2, lam=1.0, max_iter=3)
    assert tracing.launch_counts() == before
    for a, b in zip(got, want):
        assert torch.equal(a, b)


def test_wrapper_rejects_other_devices():
    _, (tp, ts, _, top) = _both(16, 32, 2)
    meta = lambda t: t.to("meta")  # noqa: E731
    with pytest.raises(ValueError, match="cpu or cuda"):
        cg.cgs_cg(meta(ts.z)[None], type(top)(*map(meta, top)), tp.gm,
                  tp.ktw, tp.z0t, sf=2, lam=1.0)


FAULTS = ("x0 returned", "beta = 0", "alpha without its beta term",
          "alpha x 0.9", "s without beta s", "p from r'")


def _faulty_cgs(fault, x0, op, gm, ktw, z0t, *, sf, max_iter):
    """``cgs_cg_plain`` of one problem run to its cap with ``fault``.
    Returns ``(x, gamma)``."""
    C = sc.build_c_planes(op, gm, ktw, 1.0, sf)

    def mv(v):
        return sc.stencil_matvec(C, v, ktw, sf)

    x = x0
    r = sc.depth_rhs_fields(op, gm, z0t, 1.0) - mv(x0)
    w = mv(r)
    gamma, delta = sc.lane_dot(r, r), sc.lane_dot(w, r)
    gamma_old = alpha_old = torch.ones_like(gamma)
    s = p = torch.zeros_like(x0)
    for k in range(1, max_iter + 2):
        beta = (torch.zeros_like(gamma) if k == 1 or fault == "beta = 0"
                else gamma / gamma_old)
        denom = delta - beta * gamma / alpha_old
        if fault == "alpha without its beta term":
            denom = delta
        alpha = gamma / denom * (0.9 if fault == "alpha x 0.9" else 1.0)
        s = w if fault == "s without beta s" else w + beta * s
        r_new = r - alpha * s
        p = (r_new if fault == "p from r'" else r) + beta * p
        x = x + alpha * p
        w = mv(r_new)
        gamma_old, alpha_old = gamma, alpha
        gamma, delta = sc.lane_dot(r_new, r_new), sc.lane_dot(w, r_new)
        r = r_new
    return (x0 if fault == "x0 returned" else x), gamma


@pytest.fixture
def one_thread():
    """One torch thread: several test workers share the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("h,w,sf", [(240, 320, 2), (120, 160, 1),
                                    (240, 320, 4)])
def test_chip_bounds_catch_faulty_recurrences(h, w, sf, one_thread):
    """``chip_smoke.py`` phase 3c holds the kernel to the plain version by
    the relative RMS of the update x - x0 from the main path's warm start
    and of x from a cold start x0 = 0, and by the relative gap of gamma =
    <r, r>, after 2 and 12 iterations (``chip_smoke.UPD_BOUND`` /
    ``RES_BOUND``). The plain version's recurrence written out here stays
    inside every bound; each faulty copy fails at least one."""
    data, _ = lambertian_dataset(h, w, sf, n=8, c=3, seed=sf)
    prob, st, op = chip_smoke.depth_operator(data, CPU)
    warm = (st.z, op, prob.gm, prob.ktw, prob.z0t)
    starts = {"warm": warm, "cold": (torch.zeros_like(st.z),) + warm[1:]}
    caught = {f: [] for f in (None,) + FAULTS}
    for (start, args), cap in [(s, c) for s in starts.items()
                               for c in (2, 12)]:
        x0 = args[0]
        px, _, pg = cg.cgs_cg_plain(*args, sf=sf, lam=1.0, max_iter=cap)
        for fault in caught:
            x, g = _faulty_cgs(fault, *args, sf=sf, max_iter=cap)
            upd = chip_smoke.rel_rms(x - x0, px - x0)
            gap = abs(float(g) - float(pg)) / abs(float(pg))
            if upd > chip_smoke.UPD_BOUND[start][cap]:
                caught[fault].append(f"{start} update cap {cap}: {upd:.2e}")
            if gap > chip_smoke.RES_BOUND[start][cap]:
                caught[fault].append(f"{start} gamma cap {cap}: {gap:.2e}")
    assert not caught.pop(None)
    missed = [f for f, c in caught.items() if not c]
    assert not missed, missed


@pytest.mark.cuda
@pytest.mark.parametrize("sf", [1, 2, 4])
def test_cuda_kernel_matches_plain(sf):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    lanes = [_both(40, 32, sf, seed=b)[1] for b in range(2)]
    dev = torch.device("cuda")
    mv = lambda a: a.to(dev)  # noqa: E731
    args = [(mv(ts.z), type(top)(*map(mv, top)), type(tp.gm)(*map(mv, tp.gm)),
             mv(tp.ktw), mv(tp.z0t)) for tp, ts, _, top in lanes]
    for a in args:
        before = tracing.launch_counts().get("cgs_cg", 0)
        x, k, _ = cg.cgs_cg(*a, sf=sf, lam=1.0, max_iter=12)
        torch.cuda.synchronize()
        assert tracing.launch_counts().get("cgs_cg", 0) == before + 1
        px, pk, _ = cg.cgs_cg_plain(*a, sf=sf, lam=1.0, max_iter=12)
        assert int(k) == int(pk)
        assert _rel_rms(x.cpu().numpy(), px.cpu().numpy()) < 5e-2
    stack = lambda i: torch.stack([a[i] for a in args])  # noqa: E731
    op = type(args[0][1])(*(torch.stack(f) for f in zip(*[a[1] for a in args])))
    gm = type(args[0][2])(*(torch.stack(f) for f in zip(*[a[2] for a in args])))
    xb, kb, _ = cg.cgs_cg(stack(0), op, gm, stack(3), stack(4), sf=sf,
                          lam=1.0, max_iter=12)
    for b, a in enumerate(args):
        x1, k1, _ = cg.cgs_cg(*a, sf=sf, lam=1.0, max_iter=12)
        assert torch.equal(xb[b], x1) and int(kb[b]) == int(k1)
