"""The port's Jacobi-preconditioned stencil CG against the JAX package.

``stencil_cg(..., invd=1/diag(M))`` runs the scaled form at sf <= 2 and
the in-sweep PCG form at sf = 4, as the TPU kernel
``pallas_cg_vmem._kernel_vmem_stencil`` does on resident grids; it is held
to that kernel (interpret mode, forced ``"full_stencil"``), to the
1080p-class kernel ``_kernel_vmem_hybrid_stencil`` (forced
``"hybrid_stencil"``, in-sweep PCG only), to the JAX jnp PCG, and through
``estimate_depth``, the lockstep solve and the fused solve.

Bounds are the JAX suite's for Jacobi (tests/test_pallas_cg_vmem.py:62-88):
equal iteration counts, x within 2e-4 after 2 iterations and within the
unconverged-CG drift bound 3e-2 after the long cap (15; 10 at sf = 4,
where the preconditioned residual stagnates in f32 noise, and 8 at sf = 4
on 16 x 32, where that happens by iteration 10: there the port's plain
version ends 3.8 from a float64 run of itself, the Pallas kernel 0.05 and
the jnp PCG 0.09, while at cap 8 all three lie within 0.02 of it), the
reported residual within 1e-3 relative, and energies within 5e-4. The scaled and
the in-sweep forms are algebraically one recurrence, so across forms the
long cap gets the drift bound only. The update ``x - x0`` is compared as a
relative RMS too, since x itself would pass with x0 returned unchanged.
"""

import functools
import io
import json
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
from test_e2e import synthetic_data
from test_pallas_cg import _problem
from test_torch_batched import _jax_lanes, jax_to_numpy
from srmeetsps_cuda_tpu.config import RuntimeConfig as JRuntime
from srmeetsps_cuda_tpu.config import SolverConfig as JConfig
from srmeetsps_cuda_tpu.models import srps as jsrps
from srmeetsps_cuda_tpu.parallel import batched as jbatched
from srmeetsps_cuda_tpu.runtime import solver as jsolver
from srmeetsps_cuda_tpu.solve import pallas_cg
from srmeetsps_cuda_tpu.solve import pallas_cg_vmem as pvm
from srmeetsps_cuda_tpu.solve.cg import conjugate_gradient as jcg
from srmeetsps_cuda_tpu_torch import cli, interop
from srmeetsps_cuda_tpu_torch.config import RuntimeConfig, SolverConfig
from srmeetsps_cuda_tpu_torch.io.mat_loader import save_mat_dataset
from srmeetsps_cuda_tpu_torch.io.synthetic import lambertian_dataset
from srmeetsps_cuda_tpu_torch.models import srps as tsrps
from srmeetsps_cuda_tpu_torch.parallel import batched
from srmeetsps_cuda_tpu_torch.runtime import solver as tsolver
from srmeetsps_cuda_tpu_torch.solve import stencil_cg as sc

CPU = torch.device("cpu")
SHORT, LONG = 2e-4, 3e-2


@pytest.fixture(autouse=True)
def interpret_full_stencil(monkeypatch):
    monkeypatch.setattr(pallas_cg, "INTERPRET", True)
    monkeypatch.setattr(pvm, "vmem_mode", lambda *a, **k: "full_stencil")


@functools.lru_cache(maxsize=None)
def _both(h, w, sf, seed=0):
    """The same seeded problem in both packages with ``invd = 1 / diag``:
    (JAX prob, state, mom, op, invd) and (port prob, state, mom, op,
    invd). Cached: no test modifies them."""
    jp, js, jm, jop = _problem(np.random.default_rng(seed), h, w, sf)
    jinvd = 1.0 / jsrps.depth_diag(jop, jp, sf, 1.0)
    tp = interop.problem_from_numpy(jp, CPU)
    ts = interop.state_from_numpy(js, CPU)
    tm = tsrps.s_moments(tp, ts.s)
    top = tsrps.build_depth_operator(tp, tm, ts.rho, ts.dz, 1.0)
    tinvd = 1.0 / tsrps.depth_diag(top, tp, sf, 1.0)
    return (jp, js, jm, jop, jinvd), (tp, ts, tm, top, tinvd)


def _pallas(j, sf, max_iter, jacobi=True, tol=1e-4):
    jp, js, _, jop, jinvd = j
    x, k, r1, e = pvm.cg_pallas_vmem_fromop(
        js.z, jop, jp.gm, jp.ktw, jp.z0t, sf=sf, lam=1.0, tol=tol,
        max_iter=max_iter, invd=jinvd if jacobi else None, with_energy=True,
        z0u=jp.z0up)
    return np.asarray(x), int(k), float(r1), float(e + jop.const)


def _port(t, sf, max_iter, jacobi=True, tol=1e-4):
    tp, ts, _, top, tinvd = t
    x, k, r1, e = sc.stencil_cg(
        ts.z, top, tp.gm, tp.ktw, tp.z0t, tp.z0u, sf=sf, lam=1.0, tol=tol,
        max_iter=max_iter, invd=tinvd if jacobi else None)
    return x.numpy(), int(k), float(r1), float(e + top.const)


def _rel_rms(got, want):
    d = np.asarray(got, np.float64) - np.asarray(want, np.float64)
    return float(np.sqrt(np.mean(d ** 2))
                 / max(np.sqrt(np.mean(np.asarray(want, np.float64) ** 2)),
                       1e-30))


def _hold(t, sf, got, want, bound):
    """Port result ``got`` against ``want`` (x, iters, r1, energy)."""
    x0 = t[1].z.numpy()
    assert got[1] == want[1]
    np.testing.assert_allclose(got[0], want[0], rtol=bound, atol=bound)
    assert _rel_rms(got[0] - x0, want[0] - x0) < (1e-3 if bound == SHORT
                                                   else LONG)
    np.testing.assert_allclose(got[3], want[3], rtol=5e-4)


@pytest.mark.parametrize("sf", [1, 2])
def test_scale_c_planes_matches_scale_c_band(sf, monkeypatch):
    """C' against the TPU prologue's ``_build_c_band`` and ``_scale_c_band``
    run on its padded frame (a plain roll stands in for the in-kernel lane
    roll)."""
    (jp, _, _, jop, jinvd), (tp, _, _, top, tinvd) = _both(16, 32, sf)
    h, w = 16, 32
    roll = lambda a, di, dj: jnp.roll(a, (-di, -dj), (0, 1))  # noqa: E731
    monkeypatch.setattr(pvm, "_shift", roll)
    geo = pallas_cg.geometry(h, w, pvm.vmem_th(h, w))
    f = pvm.stack_fields_rows(jop, jp.gm, jp.ktw, geo, invd=jinvd)
    c_band = pvm._build_c_band(f, 1.0, sf, geo.hp, shift=roll)
    want = np.asarray(pvm._scale_c_band(c_band, jnp.sqrt(f[pvm.IVDR]),
                                        geo.hp))[:, :h, :w]
    got = sc.scale_c_planes(sc.build_c_planes(top, tp.gm, tp.ktw, 1.0, sf),
                            tinvd).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-6,
                               atol=1e-6 * np.abs(want).max())


@pytest.mark.parametrize("sf,h,w", [
    pytest.param(1, 48, 32, marks=pytest.mark.slow), (2, 48, 32), (4, 16, 32),
    pytest.param(4, 48, 32, marks=pytest.mark.slow)])
def test_plain_jacobi_matches_pallas_kernel(sf, h, w):
    """Scaled form (sf <= 2) and in-sweep PCG (sf = 4) against the same
    forms of ``_kernel_vmem_stencil``; the tracked energy also against the
    port's own ``depth_energy`` at the result."""
    j, t = _both(h, w, sf)
    long_cap = 15 if sf < 4 else 10 if h > 16 else 8
    for cap, bound in [(2, SHORT), (long_cap, LONG)]:
        want = _pallas(j, sf, cap)
        got = _port(t, sf, cap)
        _hold(t, sf, got, want, bound)
        np.testing.assert_allclose(got[2], want[2], rtol=1e-3)
        tp, _, _, top, _ = t
        e_ref = float(tsrps.depth_energy(torch.from_numpy(got[0]) * tp.mask,
                                         top, tp, sf, 1.0))
        np.testing.assert_allclose(got[3], e_ref, rtol=5e-4)


@pytest.mark.parametrize("case,sf,h", [("plain", 2, 48), ("scaled", 2, 48),
                                       ("pcg", 4, 16)])
def test_hybrid_stencil_kernel_covered(case, sf, h, monkeypatch):
    """Kernel 2 by coverage: ``_kernel_vmem_hybrid_stencil`` (forced)
    against the port, plain and Jacobi. The TPU's hybrid mode has only the
    in-sweep PCG: at sf = 2 the port's scaled form meets it within the
    drift bound, at sf = 4 its own PCG within the same-form bounds. Plain
    CG's residual after the long cap is held to the drift bound, as the JAX
    suite holds no plain-CG residual tighter."""
    monkeypatch.setattr(pvm, "vmem_mode", lambda *a, **k: "hybrid_stencil")
    j, t = _both(h, 32, sf)
    jacobi = case != "plain"
    for cap, bound in [(2, SHORT), (15 if sf < 4 else 8, LONG)]:
        want = _pallas(j, sf, cap, jacobi=jacobi)
        got = _port(t, sf, cap, jacobi=jacobi)
        _hold(t, sf, got, want, bound)
        np.testing.assert_allclose(
            got[2], want[2],
            rtol=1e-3 if bound == SHORT or case == "pcg" else LONG)


@pytest.mark.parametrize("sf", [2, 4])
def test_plain_jacobi_matches_jnp_pcg(sf):
    """The JAX package's generic PCG (``precond = r / diag``) on the same
    system: its recurrence is the in-sweep one."""
    from functools import partial

    (jp, js, _, jop, _), t = _both(48, 32, sf)
    matvec = partial(jsrps.depth_matvec, op=jop, prob=jp, sf=sf, lam=1.0)
    diag = jsrps.depth_diag(jop, jp, sf, 1.0)
    b_res = jsrps.depth_rhs(jop, jp, sf, 1.0) - matvec(js.z)
    for cap, bound in [(2, SHORT), (15 if sf < 4 else 10, LONG)]:
        ref = jcg(matvec, b_res, js.z, tol=1e-4, max_iter=cap,
                  precond=lambda r: r / diag)
        xt, kt, rt, _ = _port(t, sf, cap)
        assert kt == int(ref.iterations)
        np.testing.assert_allclose(xt, np.asarray(ref.x), rtol=bound,
                                   atol=bound)
        x0 = t[1].z.numpy()
        assert _rel_rms(xt - x0, np.asarray(ref.x) - x0) < (
            1e-3 if bound == SHORT else LONG)
        np.testing.assert_allclose(rt, float(ref.residual_sq),
                                   rtol=1e-3 if bound == SHORT else LONG)


def test_jacobi_form_follows_sf():
    assert sc.jacobi_form(1) == sc.jacobi_form(2) == "scaled"
    assert sc.jacobi_form(4) == "pcg"


def test_wrapper_rejects_other_devices_with_jacobi():
    _, (tp, ts, _, top, tinvd) = _both(16, 32, 2)
    meta = lambda a: a.to("meta")  # noqa: E731
    with pytest.raises(ValueError, match="cpu or cuda"):
        sc.stencil_cg(meta(ts.z), type(top)(*map(meta, top)), tp.gm, tp.ktw,
                      tp.z0t, tp.z0u, sf=2, lam=1.0, invd=meta(tinvd))


def test_wrapper_takes_plain_version_on_cpu_with_jacobi():
    _, (tp, ts, _, top, tinvd) = _both(16, 32, 2)
    args = (ts.z, top, tp.gm, tp.ktw, tp.z0t, tp.z0u)
    before = (sc.stencil_cg.launches, sc.stencil_cg.jacobi_launches)
    got = sc.stencil_cg(*args, sf=2, lam=1.0, max_iter=3, invd=tinvd,
                        planes=True)
    want = sc.stencil_cg_plain(*args, sf=2, lam=1.0, max_iter=3, invd=tinvd,
                               planes=True)
    assert (sc.stencil_cg.launches, sc.stencil_cg.jacobi_launches) == before
    for a, b in zip(got, want):
        assert torch.equal(a, b)
    C = sc.build_c_planes(top, tp.gm, tp.ktw, 1.0, 2)
    assert torch.equal(got[4], sc.scale_c_planes(C, tinvd))


# ---------------------------------------------------------------------------
# Bounds that catch faulty recurrences (chip_smoke.py phase 3d)
# ---------------------------------------------------------------------------

FAULTS = {"scaled": ("x0 returned", "s_i^2 for s_i s_i+d", "r0 unscaled",
                     "x = x0 + y", "beta = 0", "e0 at y = 0"),
          "pcg": ("x0 returned", "beta = 0", "p from r", "energy from <r, r>")}


def _faulty(fault, x0, op, gm, ktw, z0t, z0u, invd, *, sf, max_iter):
    """One lane of the plain Jacobi CG run to its cap with ``fault``
    (``None``: the right recurrence). Returns ``(x, reported residual,
    e_part)``."""
    form = sc.jacobi_form(sf)
    C = sc.build_c_planes(op, gm, ktw, 1.0, sf)
    r = sc.depth_rhs_fields(op, gm, z0t, 1.0) - sc.stencil_matvec(C, x0, ktw,
                                                                   sf)
    e = sc.warm_start_energy(
        torch.zeros_like(x0) if fault == "e0 at y = 0" else x0, op, gm, z0u,
        1.0, sf)
    x = x0
    if form == "scaled":
        s = torch.sqrt(invd)
        C = (s * s * C if fault == "s_i^2 for s_i s_i+d"
             else sc.scale_c_planes(C, invd))
        r = r if fault == "r0 unscaled" else s * r
        x = torch.zeros_like(x0)
    pcg = form == "pcg"
    r1 = sc.lane_dot(r * r, invd) if pcg else sc.lane_dot(r, r)
    p = torch.zeros_like(x0)
    r0 = r1
    for k in range(1, max_iter + 2):
        beta = 0.0 if k == 1 or fault == "beta = 0" else r1 / r0
        p = (invd * r if pcg and fault != "p from r" else r) + beta * p
        w = sc.stencil_matvec(C, p, ktw, sf)
        alpha = r1 / sc.lane_dot(p, w)
        e = e - alpha * (sc.lane_dot(r, r) if fault == "energy from <r, r>"
                         else r1)
        x = x + alpha * p
        r = r - alpha * w
        r0 = r1
        r1 = sc.lane_dot(r * r, invd) if pcg else sc.lane_dot(r, r)
    rr = sc.lane_dot(r, r)
    if form == "scaled":
        x = x0 + (x if fault == "x = x0 + y" else s * x)
        rr = torch.sum(r * r / invd)
    return (x0 if fault == "x0 returned" else x), rr, e


@pytest.fixture
def one_thread():
    """One torch thread: several test workers share the cores, and this
    test's 240 x 320 sweeps are where their threads would contend."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("h,w,sf", [(240, 320, 2), (120, 160, 1),
                                    (240, 320, 4)])
def test_chip_bounds_catch_faulty_recurrences(h, w, sf, one_thread):
    """Phase 3d holds the kernel to the plain version by the relative RMS
    of the update x - x0 from the main path's warm start and of x from a
    cold start x0 = 0, and by the relative gap of the reported residual,
    after 2 and 12 iterations (``chip_smoke.UPD_BOUND``/``RES_BOUND``), and
    by the tracked energy from the warm start at phase 3's bound
    (``chip_smoke.energy_excess``). The right recurrence in float64 (a
    reordering of every sum) stays inside every bound; each faulty copy
    fails at least one."""
    data, _ = lambertian_dataset(h, w, sf, n=8, c=3, seed=sf)
    prob, st, op = chip_smoke.depth_operator(data, CPU)
    invd = 1.0 / tsrps.depth_diag(op, prob, sf, 1.0)
    const = float(op.const)
    warm = (st.z, op, prob.gm, prob.ktw, prob.z0t, prob.z0u)
    starts = {"warm": warm, "cold": (torch.zeros_like(st.z),) + warm[1:]}
    f64 = lambda t: (t.double() if isinstance(t, torch.Tensor)  # noqa: E731
                     else type(t)(*(a.double() for a in t)))
    caught = {f: [] for f in (None,) + FAULTS[sc.jacobi_form(sf)]}
    for (start, args), cap in [(s, c) for s in starts.items()
                               for c in (2, 12)]:
        x0 = args[0]
        px, _, pr, pe = sc.stencil_cg_plain(*args, sf=sf, lam=1.0,
                                            max_iter=cap, invd=invd)
        for fault in caught:
            if fault is None:
                fx, fr, fe = _faulty(None, *map(f64, args), invd.double(),
                                     sf=sf, max_iter=cap)
            else:
                fx, fr, fe = _faulty(fault, *args, invd, sf=sf, max_iter=cap)
            upd = chip_smoke.rel_rms(fx - x0, px - x0)
            gap = abs(float(fr) - float(pr)) / abs(float(pr))
            if upd > chip_smoke.UPD_BOUND[start][cap]:
                caught[fault].append(f"{start} update cap {cap}: {upd:.2e}")
            if gap > chip_smoke.RES_BOUND[start][cap]:
                caught[fault].append(f"{start} residual cap {cap}: {gap:.2e}")
            ratio = chip_smoke.energy_excess(fe, pe, const)[1]
            if start == "warm" and ratio > 1:
                caught[fault].append(f"warm energy cap {cap}: {ratio:.2e}")
    assert not caught.pop(None)
    missed = [f for f, c in caught.items() if not c]
    assert not missed, missed


# ---------------------------------------------------------------------------
# The depth estimator, the lockstep solve and the whole solve
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("variant", ["pipe", "cgs"])
def test_estimate_depth_jacobi_matches_jax(variant):
    """JAX routes Jacobi to its scaled kernel with the tracked energy
    (pipe) or to the jnp PCG with ``depth_energy`` at the result (cgs,
    which has no preconditioned kernel); the port runs its Jacobi stencil
    CG for both, evaluating the energy at the result for cgs."""
    (jp, js, jm, _, _), (tp, ts, tm, _, _) = _both(32, 32, 2)
    kw = dict(cg_tol=1e-4, cg_max_iter=12, jacobi_preconditioner=True)
    zj, ej, kj = jsrps.estimate_depth(
        jp, jm, js.rho, js.dz, js.z, 2,
        JConfig(**kw, use_pallas=True, pallas_cg_variant=variant))
    zt, et, kt = tsrps.estimate_depth(
        tp, tm, ts.rho, ts.dz, ts.z, 2, SolverConfig(**kw, cg_variant=variant))
    assert int(kt) == int(kj)
    np.testing.assert_allclose(zt.numpy(), np.asarray(zj), rtol=LONG,
                               atol=LONG)
    np.testing.assert_allclose(float(et), float(ej), rtol=5e-4)
    assert np.all(zt.numpy()[np.asarray(jp.mask) == 0] == 0)


def test_lockstep_jacobi_matches_jax_solve_batched():
    """Two outer iterations of both lockstep solves, each depth CG one
    lane-batched Jacobi launch, at test_torch_batched.py's bounds for
    lockstep against JAX."""
    probs, states = _jax_lanes(2)
    pb, st = jbatched.stack_problems(probs), jbatched.stack_states(states)
    _, jtrace = jbatched.solve_batched(
        st, pb, 2, JConfig(max_iterations=2, use_pallas=True,
                           jacobi_preconditioner=True))
    tpb = interop.problem_from_numpy(jax_to_numpy(pb), CPU)
    tst = interop.state_from_numpy(jax_to_numpy(st), CPU)
    final, ttrace = batched.solve_batched(
        tst, tpb, 2, SolverConfig(max_iterations=2, jacobi_preconditioner=True))
    jtrace, ttrace = np.asarray(jtrace), ttrace.numpy()
    for b in range(2):
        nj = int(np.isfinite(jtrace[b]).sum())
        nt = int(np.isfinite(ttrace[b]).sum())
        assert abs(nj - nt) <= 1 and int(final.iteration[b]) == nt
        m = min(nj, nt)
        np.testing.assert_allclose(ttrace[b, :m], jtrace[b, :m], rtol=1e-2)


def test_fused_jacobi_solve_matches_jax(rng):
    """The slice as a whole: the fused solve with Jacobi against the JAX
    package's kernel route (scaled Jacobi kernel, tracked energy, fused
    loop) on tests/test_e2e.py's synthetic dataset."""
    data, _ = synthetic_data(rng, h=32, w=32, sf=2)
    base = dict(cg_max_iter=10, inpaint_iters=32, max_iterations=4,
                jacobi_preconditioner=True)
    jcfg = JConfig(**base, use_pallas=True, kernel_energy=True)
    jfinal, jmetrics = jsolver.solve(data, jcfg,
                                     JRuntime(fused_outer_loop=True),
                                     verbose=False)
    tcfg = SolverConfig(**base)
    tfinal, tmetrics = tsolver.solve(data, tcfg,
                                     RuntimeConfig(fused_outer_loop=True),
                                     device=CPU, verbose=False)
    je = [m["energy"] for m in jmetrics if "iteration" in m]
    te = [m["energy"] for m in tmetrics if "iteration" in m]
    n = min(len(je), len(te))
    assert abs(len(je) - len(te)) <= 1
    if len(je) != len(te):
        # Only where the last step lies within the stopping rule's band.
        last = te if len(te) > len(je) else je
        assert abs(last[n] - last[n - 1]) / abs(last[n]) < 2 * 5e-3
    np.testing.assert_allclose(te[:n], je[:n], rtol=0, atol=5e-4 * abs(je[0]))

    jp, js = jsolver.prepare(data, jcfg)
    tp, ts = tsolver.prepare(data, tcfg, CPU)
    j1 = jsrps.srps_iteration(js, jp, 2, jcfg)
    t1 = tsrps.srps_iteration(ts, tp, 2, tcfg)
    assert int(t1.cg_iters) == int(j1.cg_iters) == 11
    np.testing.assert_allclose(t1.z.numpy(), np.asarray(j1.z), rtol=1e-4,
                               atol=1e-4)
    np.testing.assert_allclose(float(t1.energy), float(j1.energy), rtol=5e-4)


def test_lockstep_jacobi_is_one_batched_call_per_outer_iteration(rng,
                                                                 monkeypatch):
    cfg = SolverConfig(cg_max_iter=5, inpaint_iters=8, max_iterations=2,
                       jacobi_preconditioner=True)
    pairs = [tsolver.prepare(synthetic_data(rng, h=16, w=16, sf=2)[0], cfg,
                             CPU) for _ in range(3)]
    calls = _record_plain(monkeypatch)
    finals, traces = batched.solve_batch([s for _, s in pairs],
                                         [p for p, _ in pairs], 2, cfg,
                                         mode="lockstep")
    assert len(calls) == max(int(f.iteration) for f in finals)
    assert all(c == (3, 16, 16) for c in calls)


def _record_plain(monkeypatch):
    """Record the invd shape of every ``stencil_cg_plain`` call (None
    without Jacobi), still running it."""
    calls = []
    real = sc.stencil_cg_plain

    def spy(*a, invd=None, **k):
        calls.append(None if invd is None else tuple(invd.shape))
        return real(*a, invd=invd, **k)

    monkeypatch.setattr(sc, "stencil_cg_plain", spy)
    return calls


def _mat(rng, tmp_path, name):
    data, _ = synthetic_data(rng, h=32, w=32, sf=2)
    path = str(tmp_path / name)
    save_mat_dataset(path, data, fmt="mat5")
    return path


@pytest.mark.parametrize("form", ["single", "comma", "serve"])
def test_cli_jacobi_cpu_routes_through_plain_jacobi(form, rng, tmp_path,
                                                    monkeypatch, capsys):
    """``--jacobi --cpu``: every depth CG of a single, a comma (lockstep)
    and a served solve is the plain Jacobi stencil CG."""
    a = _mat(rng, tmp_path, "a.mat")
    calls = _record_plain(monkeypatch)
    argv = ["--cpu", "--jacobi", "--cg-max-iter", "5", "--max-iterations",
            "2"]
    if form == "single":
        assert cli.main(argv + ["--dsloc", a]) == 0
        want = [(32, 32)]
    elif form == "comma":
        assert cli.main(argv + ["--dsloc", f"{a},{a}", "--batch-mode",
                                "lockstep"]) == 0
        want = [(2, 32, 32)]
    else:
        monkeypatch.setattr(sys, "stdin", io.StringIO(f"{a}\nquit\n"))
        assert cli.main(argv + ["--serve"]) == 0
        lines = [json.loads(s) for s in capsys.readouterr().out.splitlines()
                 if s.startswith("{")]
        assert "error" not in lines[1] and lines[1]["iterations"] >= 1
        want = [(32, 32)]
    assert calls and set(calls) == set(want)


@pytest.mark.cuda
@pytest.mark.parametrize("sf", [1, 2, 4])
def test_cuda_jacobi_kernel_matches_plain(sf):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    _, (tp, ts, _, top, tinvd) = _both(40, 32, sf)
    dev = torch.device("cuda")
    mv = lambda a: a.to(dev)  # noqa: E731
    args = (mv(ts.z), type(top)(*map(mv, top)), type(tp.gm)(*map(mv, tp.gm)),
            mv(tp.ktw), mv(tp.z0t), mv(tp.z0u))
    before = sc.stencil_cg.jacobi_launches
    x, k, r1, e, C = sc.stencil_cg(*args, sf=sf, lam=1.0, max_iter=12,
                                   planes=True, invd=mv(tinvd))
    torch.cuda.synchronize()
    assert sc.stencil_cg.jacobi_launches == before + 1
    px, pk, pr, pe, pC = sc.stencil_cg_plain(*args, sf=sf, lam=1.0,
                                              max_iter=12, planes=True,
                                              invd=mv(tinvd))
    assert int(k) == int(pk)
    assert torch.equal(C, pC)
    x0 = ts.z.numpy()
    assert _rel_rms(x.cpu().numpy() - x0, px.cpu().numpy() - x0) < 0.25
    np.testing.assert_allclose(float(r1), float(pr), rtol=0.1)
    const = float(top.const)
    np.testing.assert_allclose(float(e) + const, float(pe) + const,
                               rtol=5e-4)
