"""Chronopoulos-Gear depth CG: one fused sweep and one reduction point per
iteration.

Port of the TPU kernel ``srmeetsps_cuda_tpu/solve/pallas_cg_cgs.py::
_kernel`` (reached through ``cg_pallas_cgs`` and ``cg_pallas_cgs_batched``,
srps.py:567-586, batched.py:167-169), B >= 1 lanes, sf in {1, 2, 4}. Two
versions of one function live here:

* :func:`cgs_cg_plain` — plain PyTorch on ``(h, w)`` planes or ``(B, h,
  w)`` lanes. The CPU path and the tests use it; on a CUDA device it is the
  reference the kernel is held against.
* :func:`cgs_cg` — the wrapper of the hand-written persistent CUDA kernel
  in ``csrc/cgs_cg.cu``: all lanes and all CG iterations in one
  cooperative launch over the tiles of ``stencil_cg.tile_plan``. A CPU
  tensor takes the plain version; a CUDA tensor launches the kernel or
  raises (a refused cooperative launch too). It counts its runs as
  ``"cgs_cg"`` (``trace.launched``); ``cgs_cg.last_launch`` the last one.

The recurrence (pallas_cg_cgs.py:1-33) reorders standard CG's rounding:

    gamma = <r, r>, delta = <w, r>, w = M r
    beta = gamma / gamma_old (0 at the first iteration)
    alpha = gamma / (delta - beta gamma / alpha_old)
    s = w + beta s; r' = r - alpha s; p = r + beta p; x += alpha p; w' = M r'

from ``r0 = rhs - M x0``, ``w0 = M r0``, with the stop rule and the cap of
the standard kernel (``gamma <= tol^2`` or ``max_iter + 1`` iterations).
``M`` is applied through the 9 stencil planes of ``stencil_cg``. No energy
is tracked, as in the TPU kernel: the caller evaluates it at the result.
Per iteration and lane the kernel streams 15 f32 planes in its on-chip
layout and 19 in its device-memory layout (74 and 93 MB at 960 x 1280),
against about 29 flops per pixel; on the H100 it is bound by instruction
issue rather than by those bytes (PERF.md).
"""

from __future__ import annotations

import ctypes

import torch

from .. import trace as tracing
from .cg import tol_squared
from .stencil_cg import (INFO_KEYS, LAYOUTS, N_STENCIL, TILE_PART_ROWS,
                         build_c_planes, depth_rhs_fields, lane_dot,
                         launch_error, launch_info, one_lane, pack_lanes,
                         per_pixel, stencil_matvec, tile_plan)

# Device scalar slots written by the kernels (csrc/cgs_cg.cu).
S_GAMMA, S_ITERS = 0, 7
N_SCAL = 9
RWS_ROWS = 6


def cgs_cg_plain(x0, op, gm, ktw, z0t, *, sf: int, lam: float,
                 tol: float = 1e-9, max_iter: int = 100):
    """Plain PyTorch version of the kernel. Returns ``(x, iters, r1)``,
    the scalars one per lane; ``active`` flags on the device replace the
    early exit, so nothing is read back to the host."""
    C = build_c_planes(op, gm, ktw, lam, sf)
    tol_sq = tol_squared(tol)

    def mv(v):
        return stencil_matvec(C, v, ktw, sf)

    x = x0
    r = depth_rhs_fields(op, gm, z0t, lam) - mv(x0)
    w = mv(r)
    gamma = lane_dot(r, r)
    delta = lane_dot(w, r)
    one = torch.ones_like(gamma)
    gamma_old, alpha_old = one, one
    s = torch.zeros_like(x0)
    p = torch.zeros_like(x0)
    active = torch.ones(gamma.shape, dtype=torch.bool, device=x0.device)
    iters = torch.zeros(gamma.shape, dtype=torch.int32, device=x0.device)
    for k in range(1, max_iter + 2):
        active = active & (gamma > tol_sq)
        iters = iters + active.to(torch.int32)
        if k == 1:
            beta = torch.zeros_like(gamma)
        else:
            beta = gamma / torch.where(gamma_old == 0, one, gamma_old)
        denom = delta - beta * gamma / alpha_old
        alpha = gamma / torch.where(denom == 0, one, denom)
        bp, ap = per_pixel(beta), per_pixel(alpha)
        s_new = w + bp * s
        r_new = r - ap * s_new
        p_new = r + bp * p
        x_new = x + ap * p_new
        w_new = mv(r_new)
        on = per_pixel(active)
        x = torch.where(on, x_new, x)
        p = torch.where(on, p_new, p)
        s = torch.where(on, s_new, s)
        r = torch.where(on, r_new, r)
        w = torch.where(on, w_new, w)
        gamma_old = torch.where(active, gamma, gamma_old)
        alpha_old = torch.where(active, alpha, alpha_old)
        gamma = torch.where(active, lane_dot(r_new, r_new), gamma)
        delta = torch.where(active, lane_dot(w_new, r_new), delta)
    return x, iters, gamma


def _library():
    """The built kernel library with its C signature declared."""
    from .. import native

    lib = native.load("cgs_cg")
    vp, ci, cf = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    lib.srps_cgs_cg.argtypes = [vp] * 9 + [
        ci, ci, ci, ci, cf, cf, ci, ci, ci, ci, ctypes.POINTER(ci), vp]
    lib.srps_cgs_cg.restype = ci
    return lib


def cgs_cg(x0, op, gm, ktw, z0t, *, sf: int, lam: float, tol: float = 1e-9,
           max_iter: int = 100, block=(256, 4), layout=None):
    """The Chronopoulos-Gear depth CG: the CUDA kernels for a CUDA ``x0``,
    the plain version for a CPU one. ``x0`` is (h, w) for one problem or
    (B, h, w) for B lanes in one launch, every other input with the same
    leading axes. ``block`` is the (x, y) thread-block shape; ``layout``
    forces the kernel's, as in ``stencil_cg``. Returns ``(x, iters, r1)``
    like ``cg_pallas_cgs[_batched]``; each lane's result is bit for bit
    that of its own B = 1 launch."""
    if x0.device.type == "cpu":
        return cgs_cg_plain(x0, op, gm, ktw, z0t, sf=sf, lam=lam, tol=tol,
                            max_iter=max_iter)
    if x0.dim() == 2:
        out = cgs_cg(*one_lane(x0, op, gm, ktw, z0t), sf=sf, lam=lam,
                     tol=tol, max_iter=max_iter, block=block, layout=layout)
        return tuple(t[0] for t in out)
    F, R0, (bx, by) = pack_lanes("cgs_cg", x0, op, gm, ktw, z0t, sf=sf,
                                 max_iter=max_iter, block=block)
    B, h, w = x0.shape
    dev = x0.device
    plan = tile_plan(h, w, (bx, by))
    x, p = torch.empty_like(x0), torch.empty_like(x0)
    rws = torch.empty((B, RWS_ROWS, h, w), dtype=torch.float32, device=dev)
    C = torch.empty((B, N_STENCIL, h, w), dtype=torch.float32, device=dev)
    part = torch.empty(TILE_PART_ROWS * B * plan.tiles, dtype=torch.float32,
                       device=dev)
    scal = torch.empty((B, N_SCAL), dtype=torch.float32, device=dev)
    info = (ctypes.c_int * len(INFO_KEYS))()
    stream = torch.cuda.current_stream(dev).cuda_stream
    err = _library().srps_cgs_cg(
        F.data_ptr(), R0.data_ptr(), x0.data_ptr(), x.data_ptr(),
        p.data_ptr(), rws.data_ptr(), C.data_ptr(), part.data_ptr(),
        scal.data_ptr(), B, h, w, sf, float(lam), tol_squared(tol),
        int(max_iter), bx, by, LAYOUTS[layout], info, stream)
    if err != 0:
        raise launch_error("CGS", err)
    cgs_cg.last_launch = launch_info(info, plan, 1)
    tracing.launched("cgs_cg")
    return x, scal[:, S_ITERS].to(torch.int32), scal[:, S_GAMMA]


cgs_cg.last_launch = None
