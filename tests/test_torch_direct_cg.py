"""The port's direct mask-gated matvec CG against the JAX package.

``direct_cg`` ports the direct family of TPU kernels: ``_kernel_vmem``
(modes "full" and "full_packed") and ``_kernel_vmem_hybrid`` with the
tracked energy, the band-streamed ``pallas_cg_pipe._kernel`` (r0 built in
the kernel, or given), the single-buffer ``pallas_cg_fused._kernel`` and the
two-call ``pallas_cg._cg_kernel_a/_b``. Its plain version is held to each of
them, run in interpret mode (and to the vmem kernels with their mode
forced), and the ``"direct"`` and ``"direct_host_r0"`` solves, single and
lockstep, to the JAX routes that reach those kernels.

Bounds are the JAX suite's (tests/test_pallas_cg.py:217-226,
tests/test_pallas_cg_vmem.py:62-88): equal iteration counts; x within 5e-5
after 2 iterations and within the unconverged-CG drift
bound 3e-2 after 12, on 40 x 32; the update ``x - x0`` as a relative RMS
(1e-3 and 3e-2), since x itself would pass with x0 returned unchanged; the
reported residual within 1e-3 after 2 iterations and 3e-2 after 12; the
energy within 5e-4. A residual at the f32 floor (8 orders of magnitude
below the first) is held at 1e-8 of the first. The matvecs agree to f32
roundoff: 2e-6 of the largest |M v|.
"""

import functools
import itertools

import numpy as np
import pytest
import torch

import chip_smoke
from test_e2e import synthetic_data
from test_torch_batched import _jax_lanes, jax_to_numpy
from test_torch_jacobi import _both, _rel_rms
from srmeetsps_cuda_tpu.config import RuntimeConfig as JRuntime
from srmeetsps_cuda_tpu.config import SolverConfig as JConfig
from srmeetsps_cuda_tpu.models import srps as jsrps
from srmeetsps_cuda_tpu.parallel import batched as jbatched
from srmeetsps_cuda_tpu.runtime import solver as jsolver
from srmeetsps_cuda_tpu.solve import pallas_cg
from srmeetsps_cuda_tpu.solve import pallas_cg_vmem as pvm
from srmeetsps_cuda_tpu.solve.pallas_cg_fused import cg_pallas_fused
from srmeetsps_cuda_tpu.solve.pallas_cg_pipe import (
    cg_pallas_pipelined, cg_pallas_pipelined_fromop)
from srmeetsps_cuda_tpu_torch import interop
from srmeetsps_cuda_tpu_torch import trace as tracing
from srmeetsps_cuda_tpu_torch.config import RuntimeConfig, SolverConfig
from srmeetsps_cuda_tpu_torch.io.synthetic import lambertian_dataset
from srmeetsps_cuda_tpu_torch.models import srps as tsrps
from srmeetsps_cuda_tpu_torch.ops import gradients as gradops
from srmeetsps_cuda_tpu_torch.ops.grid import tilesum
from srmeetsps_cuda_tpu_torch.parallel import batched
from srmeetsps_cuda_tpu_torch.runtime import solver as tsolver
from srmeetsps_cuda_tpu_torch.solve import direct_cg as dc
from srmeetsps_cuda_tpu_torch.solve import stencil_cg as sc

CPU = torch.device("cpu")
X_SHORT, LONG = 5e-5, 3e-2
SF_TIERED = [pytest.param(1, marks=pytest.mark.slow), 2,
             pytest.param(4, marks=pytest.mark.slow)]


@pytest.fixture(autouse=True)
def interpret_mode(monkeypatch):
    monkeypatch.setattr(pallas_cg, "INTERPRET", True)


def _port_args(t, x0=None):
    tp, ts, _, top, _ = t
    return (ts.z if x0 is None else x0, top, tp.gm, tp.ktw, tp.z0t, tp.z0u)


def _hold(t, got, want, cap, sf, energy=True):
    """Port result ``got`` = (x, iters, rr, e_part) against the JAX
    kernel's ``want`` = (x, iters, rr[, e_part]) at the module's bounds."""
    tp, ts, _, top, _ = t
    x0 = ts.z.numpy()
    gx, gk, gr = got[0].numpy(), int(got[1]), float(got[2])
    wx, wk, wr = np.asarray(want[0]), int(want[1]), float(want[2])
    short = cap == 2
    bound = X_SHORT if short else LONG
    assert gk == wk
    np.testing.assert_allclose(gx, wx, rtol=bound, atol=bound)
    assert _rel_rms(gx - x0, wx - x0) < (1e-3 if short else LONG)
    # A residual 8 orders of magnitude below the first one (sf = 1 after
    # 12 iterations) is at the f32 floor: it is held at 1e-8 of <r0, r0>.
    r0 = (sc.depth_rhs_fields(top, tp.gm, tp.z0t, 1.0)
          - dc.direct_matvec(ts.z, top, tp.gm, tp.ktw, 1.0, sf))
    np.testing.assert_allclose(gr, wr, rtol=1e-3 if short else LONG,
                               atol=1e-8 * float(sc.lane_dot(r0, r0)))
    if energy:
        const = float(top.const)
        np.testing.assert_allclose(float(got[3]) + const,
                                   float(want[3]) + const, rtol=5e-4)


# ---------------------------------------------------------------------------
# The matvec
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("sf", SF_TIERED)
def test_direct_matvec_matches_depth_matvec_and_stencil(sf):
    """``direct_matvec`` against the JAX ``depth_matvec`` (KT^T KT through
    the box resample) and against the port's 9-plane stencil: the same
    operator, to f32 roundoff."""
    (jp, _, _, jop, _), (tp, _, _, top, _) = _both(40, 32, sf)
    v = np.random.default_rng(5).standard_normal((40, 32)).astype(np.float32)
    got = dc.direct_matvec(torch.from_numpy(v), top, tp.gm, tp.ktw, 1.0,
                           sf).numpy()
    want = np.asarray(jsrps.depth_matvec(v, jop, jp, sf, 1.0))
    scale = np.abs(want).max()
    np.testing.assert_allclose(got, want, rtol=0, atol=2e-6 * scale)
    C = sc.build_c_planes(top, tp.gm, tp.ktw, 1.0, sf)
    st = sc.stencil_matvec(C, torch.from_numpy(v), tp.ktw, sf).numpy()
    np.testing.assert_allclose(got, st, rtol=0, atol=2e-6 * scale)


# ---------------------------------------------------------------------------
# The plain version against each TPU kernel of the family
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("jacobi", [False, True])
@pytest.mark.parametrize("sf", SF_TIERED)
def test_plain_matches_pipe_fromop(sf, jacobi):
    """Kernel 5 with r0 built in the kernel (``cg_pallas_pipelined_fromop``),
    plain and with its in-sweep Jacobi: rz drives alpha and beta, <r, r>
    stops and is reported."""
    j, t = _both(40, 32, sf)
    jp, js, _, jop, jinvd = j
    for cap in (2, 12):
        want = cg_pallas_pipelined_fromop(
            js.z, jop, jp.gm, jp.ktw, jp.z0t, sf=sf, lam=1.0, tol=1e-4,
            max_iter=cap, invd=jinvd if jacobi else None)
        got = dc.direct_cg_plain(*_port_args(t), sf=sf, lam=1.0, tol=1e-4,
                                 max_iter=cap,
                                 invd=t[4] if jacobi else None)
        assert got[3] is None
        _hold(t, got, want, cap, sf, energy=False)


@pytest.mark.parametrize("kernel", ["two_call", "fused", "pipe"])
def test_plain_given_residual_matches(kernel):
    """``direct_cg_plain(b=...)`` against kernels 7/8 (``cg_pallas``), 6
    (``cg_pallas_fused``) and 5 given its residual
    (``cg_pallas_pipelined``), with ``b = rhs - M z`` built by the JAX
    package's ``depth_matvec`` on both sides."""
    j, t = _both(40, 32, 2)
    jp, js, _, jop, _ = j
    fn = {"two_call": pallas_cg.cg_pallas, "fused": cg_pallas_fused,
          "pipe": cg_pallas_pipelined}[kernel]
    jb = jsrps.depth_rhs(jop, jp, 2, 1.0) - jsrps.depth_matvec(js.z, jop, jp,
                                                               2, 1.0)
    tb = torch.from_numpy(np.asarray(jb))
    for cap in (2, 12):
        want = fn(js.z, jb, jop, jp.gm, jp.ktw, sf=2, lam=1.0, tol=1e-4,
                  max_iter=cap)
        got = dc.direct_cg_plain(*_port_args(t), sf=2, lam=1.0, tol=1e-4,
                                 max_iter=cap, b=tb)
        _hold(t, got, want, cap, 2, energy=False)


@pytest.mark.parametrize("mode,jacobi", [
    ("full", False), ("full", True),
    pytest.param("full_packed", False, marks=pytest.mark.slow),
    ("full_packed", True), ("hybrid", False),
    pytest.param("hybrid", True, marks=pytest.mark.slow)])
def test_plain_energy_matches_vmem_kernels(mode, jacobi, monkeypatch):
    """Kernels 3 (``_kernel_vmem``, "full" and "full_packed") and 4
    (``_kernel_vmem_hybrid``) with the tracked energy, their mode forced as
    tests/test_pallas_cg_vmem.py forces it; under Jacobi the energy takes
    alpha * rz (pallas_cg_vmem.py:1118)."""
    monkeypatch.setattr(pvm, "vmem_mode", lambda *a, **k: mode)
    j, t = _both(40, 32, 2)
    jp, js, _, jop, jinvd = j
    for cap in (2, 12):
        want = pvm.cg_pallas_vmem_fromop(
            js.z, jop, jp.gm, jp.ktw, jp.z0t, sf=2, lam=1.0, tol=1e-4,
            max_iter=cap, invd=jinvd if jacobi else None, with_energy=True,
            z0u=jp.z0up)
        got = dc.direct_cg_plain(*_port_args(t), sf=2, lam=1.0, tol=1e-4,
                                 max_iter=cap, invd=t[4] if jacobi else None,
                                 with_energy=True)
        _hold(t, got, want, cap, 2)


def test_energy_tracks_depth_energy_at_the_result():
    """The tracked energy against the port's ``depth_energy`` at the
    result, plain and Jacobi."""
    _, t = _both(40, 32, 2)
    tp, _, _, top, tinvd = t
    for invd in (None, tinvd):
        x, _, _, e = dc.direct_cg_plain(*_port_args(t), sf=2, lam=1.0,
                                        tol=1e-4, max_iter=12, invd=invd,
                                        with_energy=True)
        want = float(tsrps.depth_energy(x * tp.mask, top, tp, 2, 1.0))
        np.testing.assert_allclose(float(e + top.const), want, rtol=5e-4)


def test_lanes_equal_solo_runs():
    """B = 3 lanes of the plain version equal their B = 1 runs bit for bit
    (the card's kernel likewise: chip_smoke.py phase 3f)."""
    lanes, st = chip_smoke.stacked_lanes(32, 64, 2, range(3), CPU)
    for kw in ({"with_energy": True}, {"with_energy": True, "invd": st[6]}):
        xb, kb, rb, eb = dc.direct_cg_plain(*st[:6], sf=2, lam=1.0, tol=1e-4,
                                            max_iter=12, **kw)
        for b, ln in enumerate(lanes):
            one = dict(kw, invd=ln[6]) if "invd" in kw else kw
            x1, k1, r1, e1 = dc.direct_cg_plain(*ln[:6], sf=2, lam=1.0,
                                                tol=1e-4, max_iter=12, **one)
            assert torch.equal(xb[b], x1) and int(kb[b]) == int(k1)
            assert torch.equal(rb[b], r1) and torch.equal(eb[b], e1)


# ---------------------------------------------------------------------------
# The wrapper
# ---------------------------------------------------------------------------


def test_wrapper_takes_plain_version_on_cpu():
    _, t = _both(16, 32, 2)
    before = tracing.launch_counts()
    for kw in ({"with_energy": True}, {"invd": t[4], "with_energy": True},
               {"b": torch.ones_like(t[1].z)}):
        got = dc.direct_cg(*_port_args(t), sf=2, lam=1.0, max_iter=3, **kw)
        want = dc.direct_cg_plain(*_port_args(t), sf=2, lam=1.0, max_iter=3,
                                  **kw)
        for a, b in zip(got, want):
            assert (a is None and b is None) or torch.equal(a, b)
    assert tracing.launch_counts() == before


def test_wrapper_rejects_other_devices_and_energy_with_given_residual():
    _, t = _both(16, 32, 2)
    meta = lambda a: a.to("meta")  # noqa: E731
    x0, op, gm, ktw, z0t, z0u = _port_args(t)
    with pytest.raises(ValueError, match="cpu or cuda"):
        dc.direct_cg(meta(x0), type(op)(*map(meta, op)),
                     type(gm)(*map(meta, gm)), meta(ktw), meta(z0t),
                     meta(z0u), sf=2, lam=1.0)
    with pytest.raises(ValueError, match="given residual"):
        dc.direct_cg(x0, op, gm, ktw, z0t, z0u, sf=2, lam=1.0, b=x0,
                     with_energy=True)


# ---------------------------------------------------------------------------
# Bounds that catch faulty kernels (chip_smoke.py phase 3f)
# ---------------------------------------------------------------------------

FAULTS = {False: ("no t1 halo in Dx^T",),
          True: ("energy from rr under Jacobi", "beta from rr under Jacobi",
                 "no t1 halo in Dx^T")}
# The narrower thread block of phase 3f.
BLOCK_X = 32


def _block_matvec(p, op, gm, ktw, sf, tile):
    """``direct_matvec`` as a kernel with block-local tiles BLOCK_X wide
    computes it. ``tile="p halo 1"``: p staged with a one-pixel halo, so t1
    at (i, j +- 1) reads p(i, j +- 2) as 0 at a block's last (first)
    column. ``tile="t1 halo 0"``: t1 staged with none, so Dx^T reads fwd_x
    t1 at j - 1 (bwd_x t1 at j + 1) as 0 at a block's first (last)
    column."""
    sh = gradops.shift
    col = torch.arange(p.shape[-1]) % BLOCK_X
    first, last = col == 0, col == BLOCK_X - 1
    g = gradops.grad_x(p, gm)
    h = gradops.grad_y(p, gm)
    t2 = op.P12 * g + op.P22 * h - op.P23 * p
    t3 = op.P13 * g + op.P23 * h - op.P33 * p
    fw, bw = sh(gm.fwd_x, 0, -1), sh(gm.bwd_x, 0, -1)
    fe, be = sh(gm.fwd_x, 0, 1), sh(gm.bwd_x, 0, 1)
    pe, pw = sh(p, 0, 1), sh(p, 0, -1)
    if tile == "p halo 1":
        pee = torch.where(last, 0.0, sh(p, 0, 2))
        pww = torch.where(first, 0.0, sh(p, 0, -2))
    else:
        pee, pww = sh(p, 0, 2), sh(p, 0, -2)
    # t1 at (i, j + 1) and (i, j - 1), as column j sees them.
    ge = fe * (pee - pe) + be * (pe - p)
    gw = fw * (p - pw) + bw * (pw - pww)
    oe = type(op)(*(sh(f, 0, 1) if f.dim() else f for f in op))
    ow = type(op)(*(sh(f, 0, -1) if f.dim() else f for f in op))
    t1e = oe.P11 * ge + oe.P12 * sh(h, 0, 1) - oe.P13 * pe
    t1w = ow.P11 * gw + ow.P12 * sh(h, 0, -1) - ow.P13 * pw
    t1 = op.P11 * g + op.P12 * h - op.P13 * p
    if tile == "t1 halo 0":
        t1e = torch.where(last, 0.0, t1e)
        t1w = torch.where(first, 0.0, t1w)
    dxt = fw * t1w - gm.fwd_x * t1 + gm.bwd_x * t1 - be * t1e
    return ktw * tilesum(p, sf) + (dxt + gradops.grad_y_t(t2, gm) - t3)


def test_one_pixel_p_halo_is_exact():
    """M v reads v at (i, j +- 2) only through fwd_x(j + 1) bwd_x(j + 1) = 0
    (the masks are exclusive), so a p tile with a one-pixel halo gives M v
    bit for bit; without a t1 halo the block edges go wrong."""
    data, _ = lambertian_dataset(64, 96, 2, n=4, c=3, seed=2)
    prob, st, op = chip_smoke.depth_operator(data, CPU)
    v = torch.randn(st.z.shape, generator=torch.Generator().manual_seed(0))
    want = dc.direct_matvec(v, op, prob.gm, prob.ktw, 1.0, 2)
    assert torch.equal(_block_matvec(v, op, prob.gm, prob.ktw, 2,
                                     "p halo 1"), want)
    bad = _block_matvec(v, op, prob.gm, prob.ktw, 2, "t1 halo 0")
    assert float((bad - want).abs().max()) > 1e-2 * float(want.abs().max())


# ---------------------------------------------------------------------------
# The persistent kernel's phase A (csrc/direct_cg.cu), modelled on the CPU
# ---------------------------------------------------------------------------

STAGING_FAULTS = ("F halo row dropped", "t1 at the halo from unstaged F")
# Grids with partial tiles on both edges at each block (h, w multiples of
# sf; 244 x 324 for sf = 4).
STAGING_GRID = {1: (242, 322), 2: (242, 322), 4: (244, 324)}


def _staging_inputs(h, w, seed=3):
    """Seeded (r, p_old, invd, op, gm, ktw): a mask with holes, so that the
    gradient masks switch between forward, backward and none."""
    g = torch.Generator().manual_seed(seed)
    rnd = lambda: torch.randn(h, w, generator=g)  # noqa: E731
    mask = (torch.rand(h, w, generator=g) > 0.15).to(torch.float32)
    gm = gradops.GradientMasks.from_mask(mask)
    op = tsrps.DepthOperator(*(rnd() for _ in range(9)), torch.tensor(0.0))
    invd = torch.rand(h, w, generator=g) + 0.5
    return rnd(), rnd(), invd, op, gm, rnd().abs()


def _staged_matvec(r, p_old, invd, beta, op, gm, ktw, lam, sf, block,
                   fault=None):
    """``M p`` with ``p = z + beta p_old`` (``z = invd r``, or ``r``
    without ``invd``) staged as the kernel's phase A stages it, tile by
    tile of ``stencil_cg.tile_plan``: r, p_old (invd) and F's 10 fields
    with a one-pixel halo, zeros outside the image; p formed at every
    staged pixel; g, h, t1..t3 and the mask products once per staged
    pixel; w at the tile's pixels from the products of its neighbours, in
    the kernel's sum order. A neighbour beyond the staged region reads
    seeded noise: the kernel reads another plane's edge row or a margin
    column there. This models the staging geometry, not the kernel's
    roundings: p is rounded twice here as in the kernel and ``cg_loop``,
    but nvcc may contract the kernel's t1..t3 and w to FMA, which the
    model does not follow (the kernel is held to ``direct_cg_plain`` on the
    card instead). ``fault``: one of STAGING_FAULTS."""
    h, w = r.shape
    plan = sc.tile_plan(h, w, block)
    th, tw = plan.th, plan.tw
    pad = lambda a: torch.nn.functional.pad(  # noqa: E731
        a, (1, plan.tiles_x * tw + 1 - w, 1, plan.tiles_y * th + 1 - h))
    names = ("fwd_x", "bwd_x", "fwd_y", "bwd_y", "P11", "P12", "P13", "P22",
             "P23", "P33")
    planes = [pad(t) for t in (*gm, *op[:6])]
    rr, pp, kt = pad(r), pad(p_old), pad(ktw)
    ii = None if invd is None else pad(invd)
    noise = torch.Generator().manual_seed(11)
    out = torch.empty(h, w)
    for _, i0, j0, rows, cols in plan.tile_rects():
        win = (slice(i0, i0 + th + 2), slice(j0, j0 + tw + 2))
        f = dict(zip(names, (a[win].clone() for a in planes)))
        for a in f.values():
            if fault == "F halo row dropped":
                a[0], a[-1] = 0.0, 0.0
            elif fault == "t1 at the halo from unstaged F":
                a[:, 0], a[:, -1] = 0.0, 0.0
        z = rr[win] if ii is None else ii[win] * rr[win]
        p = z + beta * pp[win]
        ext = torch.randn(th + 4, tw + 4, generator=noise) * 1e3
        ext[1:-1, 1:-1] = p
        pe, pw = ext[1:-1, 2:], ext[1:-1, :-2]
        ps, pn = ext[2:, 1:-1], ext[:-2, 1:-1]
        gx = f["fwd_x"] * (pe - p) + f["bwd_x"] * (p - pw)
        gy = f["fwd_y"] * (ps - p) + f["bwd_y"] * (p - pn)
        t1 = f["P11"] * gx + f["P12"] * gy - f["P13"] * p
        t2 = f["P12"] * gx + f["P22"] * gy - f["P23"] * p
        t3 = f["P13"] * gx + f["P23"] * gy - f["P33"] * p
        fx, bxt = f["fwd_x"] * t1, f["bwd_x"] * t1
        fy, byt = f["fwd_y"] * t2, f["bwd_y"] * t2
        rs, cs = slice(1, th + 1), slice(1, tw + 1)
        dxt = ((fx[rs, :tw] - fx[rs, cs]) + bxt[rs, cs]) - bxt[rs, 2:]
        dyt = ((fy[:th, cs] - fy[rs, cs]) + byt[rs, cs]) - byt[2:, cs]
        ata = (dxt + dyt) - t3[rs, cs]
        wt = (kt[i0 + 1:i0 + th + 1, j0 + 1:j0 + tw + 1]
              * tilesum(p[rs, cs], sf) + lam * ata)
        out[i0:i0 + rows, j0:j0 + cols] = wt[:rows, :cols]
    return out


@pytest.mark.parametrize("block", chip_smoke.BLOCKS,
                         ids=lambda b: f"{b[0]}x{b[1]}")
@pytest.mark.parametrize("sf", [1, 2, 4])
def test_staged_phase_a_matvec_is_direct_matvec(sf, block):
    """The kernel's phase A staging, modelled: bit for bit ``direct_matvec``
    of ``p = z + beta p_old``, plain and Jacobi (``z = invd r``), at each
    block of chip_smoke.BLOCKS (tile plans of partial tiles on both
    edges)."""
    h, w = STAGING_GRID[sf]
    r, p_old, invd, op, gm, ktw = _staging_inputs(h, w)
    beta, lam = 0.37, 0.7
    for iv in (None, invd):
        p = (r if iv is None else iv * r) + beta * p_old
        want = dc.direct_matvec(p, op, gm, ktw, lam, sf)
        got = _staged_matvec(r, p_old, iv, beta, op, gm, ktw, lam, sf, block)
        assert torch.equal(got, want)


@pytest.mark.parametrize("fault", STAGING_FAULTS)
def test_staged_phase_a_faults_fail(fault):
    """Staging that drops F's halo rows, or takes t1 at the ring's columns
    from F that was not staged there, is no longer ``direct_matvec``."""
    h, w = STAGING_GRID[2]
    r, p_old, invd, op, gm, ktw = _staging_inputs(h, w)
    want = dc.direct_matvec(r + 0.37 * p_old, op, gm, ktw, 0.7, 2)
    got = _staged_matvec(r, p_old, None, 0.37, op, gm, ktw, 0.7, 2, (32, 16),
                         fault=fault)
    assert float((got - want).abs().max()) > 1e-2 * float(want.abs().max())


def test_direct_cg_refuses_the_on_chip_layout():
    """The direct kernel has the device layout alone: ``layout="on-chip"``
    (which the stencil and CGS wrappers take) raises before anything runs,
    on either device."""
    x0 = torch.zeros(8, 8)
    with pytest.raises(ValueError, match="device layout only"):
        dc.direct_cg(x0, None, None, None, None, None, sf=1, lam=1.0,
                     layout="on-chip")


def _faulty(fault, x0, op, gm, ktw, z0t, z0u, invd, *, sf, max_iter):
    """One lane of the direct CG with r0 and the energy in the kernel, run
    to its cap with ``fault`` (``None``: the right recurrence). Returns
    ``(x, <r, r>, e_part)``."""
    if fault == "no t1 halo in Dx^T":
        mv = lambda v: _block_matvec(v, op, gm, ktw, sf, "t1 halo 0")  # noqa: E731
    else:
        mv = lambda v: dc.direct_matvec(v, op, gm, ktw, 1.0, sf)  # noqa: E731
    r = sc.depth_rhs_fields(op, gm, z0t, 1.0) - mv(x0)
    e = sc.warm_start_energy(x0, op, gm, z0u, 1.0, sf)
    jac = invd is not None
    dot = sc.lane_dot
    r1 = dot(r * r, invd) if jac else dot(r, r)
    rr = dot(r, r)
    x, p, r0, rr0 = x0, torch.zeros_like(x0), r1, rr
    for k in range(1, max_iter + 2):
        if k == 1:
            beta = 0.0
        elif fault == "beta from rr under Jacobi":
            beta = rr / rr0
        else:
            beta = r1 / r0
        p = (invd * r if jac else r) + beta * p
        w = mv(p)
        alpha = r1 / dot(p, w)
        e = e - alpha * (rr if fault == "energy from rr under Jacobi"
                         else r1)
        x = x + alpha * p
        r = r - alpha * w
        r0, rr0 = r1, rr
        rr = dot(r, r)
        r1 = dot(r * r, invd) if jac else rr
    return x, rr, e


@pytest.fixture
def one_thread():
    """One torch thread: several test workers share the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("jacobi", [False, True])
# sf = 4 runs on phase 3's sf-4 grid: on 240 x 320 the float64 CG lies
# 1.2e-5 from the f32 one after 12 iterations from the cold start, above
# UPD_BOUND, while the card's kernel lies 2.7e-7 from its plain version.
@pytest.mark.parametrize("h,w,sf", [
    pytest.param(120, 160, 1, marks=pytest.mark.slow), (240, 320, 2),
    pytest.param(480, 640, 4, marks=pytest.mark.slow)])
def test_chip_bounds_catch_faulty_recurrences(h, w, sf, jacobi, one_thread):
    """Phase 3f holds the kernel to the plain version as phase 3d does: the
    relative RMS of the update x - x0 from the main path's warm start and
    of x from a cold start, the relative gap of <r, r> after 2 and 12
    iterations (``chip_smoke.UPD_BOUND``/``RES_BOUND``), and the tracked
    energy from the warm start at phase 3's bound
    (``chip_smoke.energy_excess``). The right recurrence in float64 stays
    inside every bound; each faulty copy fails at least one."""
    data, _ = lambertian_dataset(h, w, sf, n=8, c=3, seed=sf)
    prob, st, op = chip_smoke.depth_operator(data, CPU)
    invd = 1.0 / tsrps.depth_diag(op, prob, sf, 1.0) if jacobi else None
    const = float(op.const)
    warm = (st.z, op, prob.gm, prob.ktw, prob.z0t, prob.z0u)
    starts = {"warm": warm, "cold": (torch.zeros_like(st.z),) + warm[1:]}
    f64 = lambda t: (t.double() if isinstance(t, torch.Tensor)  # noqa: E731
                     else type(t)(*(a.double() for a in t)))
    caught = {f: [] for f in (None,) + FAULTS[jacobi]}
    for (start, args), cap in [(s, c) for s in starts.items()
                               for c in (2, 12)]:
        x0 = args[0]
        px, _, pr, pe = dc.direct_cg_plain(*args, sf=sf, lam=1.0,
                                           max_iter=cap, invd=invd,
                                           with_energy=True)
        for fault in caught:
            if fault is None:
                fx, fr, fe = _faulty(None, *map(f64, args),
                                     None if invd is None else invd.double(),
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
# The depth-CG routing, the solves and the lockstep solve
# ---------------------------------------------------------------------------

# (cg_operator, cg_variant, jacobi) -> the CG that runs, whether it gets
# invd, a given residual, the tracked energy; and whether depth_energy
# evaluates the energy at the result.
ROUTES = {
    ("stencil", "pipe", False): ("stencil_cg", False, False, True, False),
    ("stencil", "cgs", False): ("cgs_cg", False, False, False, True),
    ("stencil", "pipe", True): ("stencil_cg", True, False, True, False),
    ("stencil", "cgs", True): ("stencil_cg", True, False, True, True),
    ("direct", "pipe", False): ("direct_cg", False, False, True, False),
    ("direct", "cgs", False): ("cgs_cg", False, False, False, True),
    ("direct", "pipe", True): ("direct_cg", True, False, True, False),
    ("direct", "cgs", True): ("direct_cg", True, False, True, False),
    ("direct_host_r0", "pipe", False): ("direct_cg", False, True, False, True),
    ("direct_host_r0", "cgs", False): ("direct_cg", False, True, False, True),
    ("direct_host_r0", "pipe", True): ("direct_cg", True, True, False, True),
    ("direct_host_r0", "cgs", True): ("direct_cg", True, True, False, True),
}


@functools.lru_cache(maxsize=None)
def _small_port_problem():
    data, _ = synthetic_data(np.random.default_rng(7), h=16, w=16, sf=2)
    cfg = SolverConfig(cg_max_iter=4, inpaint_iters=8)
    prob, st = tsolver.prepare(data, cfg, CPU)
    mom = tsrps.s_moments(prob, st.s)
    return prob, st, mom


@pytest.mark.parametrize("route", list(ROUTES),
                         ids=lambda r: "-".join(map(str, r)))
def test_depth_cg_routing(route, monkeypatch):
    """Which CG ``depth_cg`` runs for each ``cg_operator``, ``cg_variant``
    and Jacobi, with which inputs, and where the energy comes from."""
    operator, variant, jacobi = route
    name, with_invd, with_b, tracked, at_result = ROUTES[route]
    calls, energies = [], []
    for fn in ("stencil_cg", "cgs_cg", "direct_cg"):
        real = getattr(tsrps, fn)

        def spy(*a, _fn=fn, _real=real, **k):
            calls.append((_fn, k.get("invd") is not None,
                          k.get("b") is not None, k.get("with_energy",
                                                        _fn == "stencil_cg")))
            return _real(*a, **k)

        monkeypatch.setattr(tsrps, fn, spy)
    real_energy = tsrps.depth_energy
    monkeypatch.setattr(tsrps, "depth_energy",
                        lambda *a: energies.append(1) or real_energy(*a))
    prob, st, mom = _small_port_problem()
    cfg = SolverConfig(cg_max_iter=4, cg_operator=operator,
                       cg_variant=variant, jacobi_preconditioner=jacobi)
    z, e, k = tsrps.estimate_depth(prob, mom, st.rho, st.dz, st.z, 2, cfg)
    assert calls == [(name, with_invd, with_b, tracked)]
    assert bool(energies) == at_result
    assert 1 <= int(k) <= 5 and bool(torch.isfinite(e))
    assert z.shape == st.z.shape


def test_unknown_cg_operator_raises():
    prob, st, mom = _small_port_problem()
    with pytest.raises(ValueError, match="cg_operator"):
        tsrps.estimate_depth(prob, mom, st.rho, st.dz, st.z, 2,
                             SolverConfig(cg_operator="sparse"))


BASE = dict(cg_max_iter=10, inpaint_iters=32, max_iterations=4)


def _traces_agree(jmetrics, tmetrics, jfinal, tfinal):
    je = [m["energy"] for m in jmetrics if "iteration" in m]
    te = [m["energy"] for m in tmetrics if "iteration" in m]
    assert tfinal.iteration == int(jfinal.iteration) == len(te) == len(je)
    np.testing.assert_allclose(te, je, rtol=5e-4)


def test_fused_direct_solve_matches_jax(rng, monkeypatch):
    """The slice as a whole: the fused solve with ``cg_operator="direct"``
    against the JAX package's direct kernel route (``_kernel_vmem`` forced
    to "full", tracked energy, fused loop): equal outer iterations, the
    energy trace within 5e-4."""
    monkeypatch.setattr(pvm, "vmem_mode", lambda *a, **k: "full")
    data, _ = synthetic_data(rng, h=32, w=32, sf=2)
    jfinal, jm = jsolver.solve(
        data, JConfig(**BASE, use_pallas=True, kernel_energy=True),
        JRuntime(fused_outer_loop=True), verbose=False)
    tfinal, tm = tsolver.solve(data, SolverConfig(**BASE, cg_operator="direct"),
                               RuntimeConfig(fused_outer_loop=True),
                               device=CPU, verbose=False)
    _traces_agree(jm, tm, jfinal, tfinal)


@pytest.mark.parametrize("route", ["two_call", "stream"])
def test_fused_host_r0_solve_matches_jax(route, rng):
    """``cg_operator="direct_host_r0"`` against the JAX two-call route
    (``pallas_fused_loop=False``: ``cg_pallas`` given the residual built in
    XLA) and the streaming route (``pallas_vmem_resident=False``: kernel 5),
    both with the energy evaluated at the result."""
    data, _ = synthetic_data(rng, h=32, w=32, sf=2)
    jcfg = (JConfig(**BASE, use_pallas=True, pallas_fused_loop=False)
            if route == "two_call" else
            JConfig(**BASE, use_pallas=True, pallas_vmem_resident=False))
    jfinal, jm = jsolver.solve(data, jcfg, JRuntime(fused_outer_loop=True),
                               verbose=False)
    tfinal, tm = tsolver.solve(
        data, SolverConfig(**BASE, cg_operator="direct_host_r0"),
        RuntimeConfig(fused_outer_loop=True), device=CPU, verbose=False)
    _traces_agree(jm, tm, jfinal, tfinal)


def test_lockstep_direct_matches_jax_solve_batched(monkeypatch):
    """Two outer iterations of both lockstep solves with the direct CG (the
    JAX package's lane-batched kernel 5 under
    ``pallas_vmem_resident=False``), each depth CG one lane-batched
    ``direct_cg_plain`` call, at test_torch_batched.py's lockstep bounds."""
    calls = []
    real = dc.direct_cg_plain

    def spy(x0, *a, **k):
        calls.append(tuple(x0.shape))
        return real(x0, *a, **k)

    monkeypatch.setattr(dc, "direct_cg_plain", spy)
    probs, states = _jax_lanes(2)
    pb, st = jbatched.stack_problems(probs), jbatched.stack_states(states)
    _, jtrace = jbatched.solve_batched(
        st, pb, 2, JConfig(max_iterations=2, use_pallas=True,
                           pallas_vmem_resident=False))
    tpb = interop.problem_from_numpy(jax_to_numpy(pb), CPU)
    tst = interop.state_from_numpy(jax_to_numpy(st), CPU)
    final, ttrace = batched.solve_batched(
        tst, tpb, 2, SolverConfig(max_iterations=2, cg_operator="direct"))
    jtrace, ttrace = np.asarray(jtrace), ttrace.numpy()
    for b in range(2):
        nj = int(np.isfinite(jtrace[b]).sum())
        nt = int(np.isfinite(ttrace[b]).sum())
        assert abs(nj - nt) <= 1 and int(final.iteration[b]) == nt
        m = min(nj, nt)
        np.testing.assert_allclose(ttrace[b, :m], jtrace[b, :m], rtol=1e-2)
    assert calls and set(calls) == {(2, 32, 32)}
    assert len(calls) == int(final.iteration.max())


@pytest.mark.cuda
@pytest.mark.parametrize("sf", [1, 2, 4])
def test_cuda_direct_kernel_matches_plain(sf):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    _, t = _both(40, 32, sf)
    dev = torch.device("cuda")
    mv = lambda a: a.to(dev)  # noqa: E731
    tp, ts, _, top, tinvd = t
    args = (mv(ts.z), type(top)(*map(mv, top)), type(tp.gm)(*map(mv, tp.gm)),
            mv(tp.ktw), mv(tp.z0t), mv(tp.z0u))
    # 30 x 3 splits sf = 4 tiles between blocks.
    for invd, block in itertools.product((None, mv(tinvd)),
                                         ((256, 4), (30, 3))):
        before = tracing.launch_counts().get("direct_cg", 0)
        x, k, r1, e = dc.direct_cg(*args, sf=sf, lam=1.0, max_iter=12,
                                   invd=invd, with_energy=True, block=block)
        torch.cuda.synchronize()
        assert tracing.launch_counts().get("direct_cg", 0) == before + 1
        px, pk, pr, pe = dc.direct_cg_plain(*args, sf=sf, lam=1.0,
                                            max_iter=12, invd=invd,
                                            with_energy=True)
        assert int(k) == int(pk)
        x0 = ts.z.numpy()
        assert _rel_rms(x.cpu().numpy() - x0, px.cpu().numpy() - x0) < 0.25
        np.testing.assert_allclose(float(r1), float(pr), rtol=0.1)
        const = float(top.const)
        np.testing.assert_allclose(float(e) + const, float(pe) + const,
                                   rtol=5e-4)
