"""The port's stencil CG against the JAX package's depth operator and its
Pallas kernel ``pallas_cg_vmem._kernel_vmem_stencil`` (interpret mode).

The 9-plane collapse is exact algebra, so the matvec and the planes agree
to f32 roundoff. The CG is ill-conditioned and unconverged at these caps,
so iterates agree tightly after 2 iterations and drift within the JAX
suite's own bounds after 12 (tests/test_pallas_cg_vmem.py:43, 470). The
12-iteration x bound is applied on that test's 40x32 grid: on a 16x32 grid
the Pallas kernel itself ends 0.066 from a float64 CG at sf=2 while the
port ends 0.0015 from it, so two f32 orders differ by more than the bound
there; the energy bound holds on both grids.
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from test_pallas_cg import _problem
from srmeetsps_cuda_tpu.models import srps as jsrps
from srmeetsps_cuda_tpu.solve import pallas_cg
from srmeetsps_cuda_tpu.solve import pallas_cg_vmem as pvm
from srmeetsps_cuda_tpu_torch import interop
from srmeetsps_cuda_tpu_torch import trace as tracing
from srmeetsps_cuda_tpu_torch.models import srps as tsrps
from srmeetsps_cuda_tpu_torch.solve import stencil_cg as sc
from srmeetsps_cuda_tpu_torch.solve.cg import tol_squared

CPU = torch.device("cpu")


@pytest.fixture(autouse=True)
def interpret_full_stencil(monkeypatch):
    monkeypatch.setattr(pallas_cg, "INTERPRET", True)
    monkeypatch.setattr(pvm, "vmem_mode", lambda *a, **k: "full_stencil")


def _both(h, w, sf, seed=0):
    """The same seeded problem in both packages: (JAX prob, state, op) and
    (port prob, state, op)."""
    jp, js, jm, jop = _problem(np.random.default_rng(seed), h, w, sf)
    tp = interop.problem_from_numpy(jp, CPU)
    ts = interop.state_from_numpy(js, CPU)
    top = tsrps.build_depth_operator(tp, tsrps.s_moments(tp, ts.s), ts.rho,
                                     ts.dz, 1.0)
    return (jp, js, jop), (tp, ts, top)


def _pallas(j, sf, tol, max_iter):
    jp, js, jop = j
    x, k, r1, e = pvm.cg_pallas_vmem_fromop(
        js.z, jop, jp.gm, jp.ktw, jp.z0t, sf=sf, lam=1.0, tol=tol,
        max_iter=max_iter, with_energy=True, z0u=jp.z0up)
    return np.asarray(x), int(k), float(r1), float(e + jop.const)


def _port(t, sf, tol, max_iter, **kw):
    tp, ts, top = t
    x, k, r1, e = sc.stencil_cg(ts.z, top, tp.gm, tp.ktw, tp.z0t, tp.z0u,
                                sf=sf, lam=1.0, tol=tol, max_iter=max_iter,
                                **kw)
    return x.numpy(), int(k), float(r1), float(e + top.const)


@pytest.mark.parametrize("sf", [1, 2, 4])
def test_stencil_matvec_matches_depth_matvec(sf):
    (jp, js, jop), (tp, ts, top) = _both(24, 32, sf)
    v = np.random.default_rng(1).standard_normal((24, 32)).astype(np.float32)
    want = np.asarray(jsrps.depth_matvec(v, jop, jp, sf, 1.0))
    C = sc.build_c_planes(top, tp.gm, tp.ktw, 1.0, sf)
    got = sc.stencil_matvec(C, torch.from_numpy(v), tp.ktw, sf).numpy()
    scale = np.abs(want).max()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5 * scale)


@pytest.mark.parametrize("sf", [1, 2, 4])
def test_c_planes_match_build_c_band(sf):
    """The unpadded planes against the TPU prologue's own
    ``_build_c_band`` run on its padded frame (a plain roll stands in for
    the in-kernel lane roll)."""
    (jp, js, jop), (tp, ts, top) = _both(16, 32, sf)
    h, w = 16, 32
    geo = pallas_cg.geometry(h, w, pvm.vmem_th(h, w))
    f = pvm.stack_fields_rows(jop, jp.gm, jp.ktw, geo)
    roll = lambda a, di, dj: jnp.roll(a, (-di, -dj), (0, 1))  # noqa: E731
    want = np.asarray(pvm._build_c_band(f, 1.0, sf, geo.hp, shift=roll))
    got = sc.build_c_planes(top, tp.gm, tp.ktw, 1.0, sf).numpy()
    np.testing.assert_allclose(got, want[:, :h, :w], rtol=1e-6,
                               atol=1e-6 * np.abs(want).max())


# sf = 1 and 4 of this 40x32 case are slow-tier, as the JAX suite's
# SF_TIERED; the 16x32 energy test below covers all three in tier-1.
@pytest.mark.parametrize("sf", [pytest.param(1, marks=pytest.mark.slow), 2,
                                pytest.param(4, marks=pytest.mark.slow)])
def test_plain_cg_matches_pallas_kernel(sf):
    j, t = _both(40, 32, sf)
    for max_iter, bound in [(2, 5e-5), (12, 3e-2)]:
        xj, kj, rj, ej = _pallas(j, sf, 1e-4, max_iter)
        xt, kt, rt, et = _port(t, sf, 1e-4, max_iter)
        assert kt == kj, max_iter
        np.testing.assert_allclose(xt, xj, rtol=bound, atol=bound)
        np.testing.assert_allclose(et, ej, rtol=5e-4)


@pytest.mark.parametrize("sf", [1, 2, 4])
def test_tracked_energy_matches_pallas_and_depth_energy(sf):
    """At the reference tolerance (unreachable: the cap decides) the
    tracked energy matches the Pallas kernel's and the port's own
    re-evaluation at the final iterate."""
    j, t = _both(16, 32, sf)
    xj, kj, rj, ej = _pallas(j, sf, 1e-9, 12)
    xt, kt, rt, et = _port(t, sf, 1e-9, 12)
    assert kt == kj == 13
    np.testing.assert_allclose(et, ej, rtol=5e-4)
    tp, ts, top = t
    e_ref = float(tsrps.depth_energy(torch.from_numpy(xt) * tp.mask, top, tp,
                                     sf, 1.0))
    np.testing.assert_allclose(et, e_ref, rtol=5e-4)


def test_energy_planes_match_unpadded_jax_planes():
    (jp, js, jop), (tp, ts, top) = _both(16, 32, 2)
    want = np.asarray(jp.z0up)[:, pallas_cg.RING:pallas_cg.RING + 16, :32]
    np.testing.assert_array_equal(tp.z0u.numpy(), want)


def test_cap_runs_max_iter_plus_one():
    _, t = _both(16, 32, 2)
    for cap in (0, 1, 5):
        assert _port(t, 2, 1e-9, cap)[1] == cap + 1


def test_wrapper_takes_plain_version_on_cpu():
    _, (tp, ts, top) = _both(16, 32, 2)
    before = tracing.launch_counts()
    x, k, r1, e, C = sc.stencil_cg(ts.z, top, tp.gm, tp.ktw, tp.z0t, tp.z0u,
                                   sf=2, lam=1.0, max_iter=3, planes=True)
    px, pk, pr, pe, pC = sc.stencil_cg_plain(
        ts.z, top, tp.gm, tp.ktw, tp.z0t, tp.z0u, sf=2, lam=1.0, max_iter=3,
        planes=True)
    assert tracing.launch_counts() == before
    assert C.shape == (9, 16, 32)
    for a, b in [(x, px), (k, pk), (r1, pr), (e, pe), (C, pC)]:
        assert torch.equal(a, b)


def test_wrapper_rejects_other_devices():
    _, (tp, ts, top) = _both(16, 32, 2)
    with pytest.raises(ValueError, match="cpu or cuda"):
        sc.stencil_cg(ts.z.to("meta"), top, tp.gm, tp.ktw, tp.z0t, tp.z0u,
                      sf=2, lam=1.0)


def test_tol_squared_is_the_f32_square():
    for tol in (1e-9, 1e-4, 0.3):
        assert tol_squared(tol) == float(jnp.float32(tol) ** 2)


@pytest.mark.cuda
@pytest.mark.parametrize("sf", [1, 2, 4])
def test_cuda_kernel_matches_plain(sf):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    _, (tp, ts, top) = _both(40, 32, sf)
    dev = torch.device("cuda")
    mv = lambda a: a.to(dev)  # noqa: E731
    op = type(top)(*[mv(a) for a in top])
    gm = type(tp.gm)(*[mv(a) for a in tp.gm])
    args = (mv(ts.z), op, gm, mv(tp.ktw), mv(tp.z0t), mv(tp.z0u))
    before = tracing.launch_counts().get("stencil_cg", 0)
    x, k, r1, e, C = sc.stencil_cg(*args, sf=sf, lam=1.0, max_iter=12,
                                   planes=True)
    torch.cuda.synchronize()
    assert tracing.launch_counts().get("stencil_cg", 0) == before + 1
    px, pk, pr, pe, pC = sc.stencil_cg_plain(*args, sf=sf, lam=1.0,
                                              max_iter=12, planes=True)
    assert int(k) == int(pk) == 13
    np.testing.assert_allclose(C.cpu().numpy(), pC.cpu().numpy(), rtol=1e-5,
                               atol=1e-6 * float(pC.abs().max()))
    np.testing.assert_allclose(x.cpu().numpy(), px.cpu().numpy(), rtol=3e-2,
                               atol=3e-2)
    const = float(top.const)
    np.testing.assert_allclose(float(e) + const, float(pe) + const,
                               rtol=5e-4)
