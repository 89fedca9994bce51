"""Depth CG through the 9-point stencil collapse of the depth operator.

Port of the TPU kernel ``srmeetsps_cuda_tpu/solve/pallas_cg_vmem.py::
_kernel_vmem_stencil`` (reached through ``cg_pallas_vmem_fromop``, srps.py:
574-578), in its main-path form: plain CG, energy tracked, one problem,
sf in {1, 2, 4}. Two versions of one function live here:

* :func:`stencil_cg_plain` — plain PyTorch. The CPU path and the tests use
  it; on a CUDA device it serves only as the reference the kernel is held
  against.
* :func:`stencil_cg` — the wrapper of the hand-written CUDA kernels in
  ``csrc/stencil_cg.cu``. A CPU tensor takes the plain version; a CUDA
  tensor launches the kernels or raises. ``stencil_cg.launches`` counts
  the kernel runs.

Both compute, from the warm start ``x0``:

* the 9 coefficient planes ``C = [C0, C+x, C-x, C+y, C-y, C+x+y, C+x-y,
  C-x+y, C-x-y]`` of ``M = KT^T KT + lam A^T A`` with ``(M v)[i] = sum_d
  C_d[i] v[i + d]`` ("+x" is column j + 1, "+y" row i + 1); at sf = 4 the
  KT^T KT term stays out of the planes and is applied as
  ``ktw * tilesum(v)``;
* ``r0 = rhs - M x0`` with ``rhs = KT^T z0s + lam A^T B``;
* the energy at ``x0`` in residual form, then the CG identity
  ``E -= alpha * r1`` per iteration (the caller adds ``lam * sum B^2``);
* the reference's CG: beta = 0 at k = 1, guarded divisions, stop when
  ``r1 <= tol^2`` or after ``max_iter + 1`` iterations.

The kernel is bound by memory bandwidth: about 19 f32 planes move per
iteration (93 MB at 960 x 1280) against about 40 flops per pixel.
"""

from __future__ import annotations

import ctypes

import torch

from ..ops import gradients as gradops
from ..ops.grid import box_upsample_adjoint, tilesum
from .cg import tol_squared

N_STENCIL = 9
# Device scalar slots written by the kernels (csrc/stencil_cg.cu).
S_R1, S_E, S_ITERS = 1, 5, 7
N_SCAL = 9
MAX_BLOCK_THREADS = 1024


def make_ktw(mask: torch.Tensor, masks: torch.Tensor, sf: int) -> torch.Tensor:
    """``mask * up(masks) / sf^4``: the HR-layout weight of KT^T KT, so that
    ``KT^T KT v = ktw * tilesum(v)`` (pallas_cg.py:380-385)."""
    return mask * box_upsample_adjoint(masks, sf) / float(sf * sf)


def energy_planes(masks: torch.Tensor, z0s: torch.Tensor, sf: int) -> torch.Tensor:
    """(2, h, w): ``up(masks)`` and ``up(masks * z0s)``, the loop-invariant
    planes of the KT term of the energy (pallas_cg_vmem.py:339-351, without
    the TPU padding)."""
    s2 = float(sf * sf)
    u1 = box_upsample_adjoint(masks, sf) * s2
    u2 = box_upsample_adjoint(z0s * masks, sf) * s2
    return torch.stack([u1, u2])


def build_c_planes(op, gm, ktw: torch.Tensor, lam: float, sf: int) -> torch.Tensor:
    """The (9, h, w) stencil planes of M (``_build_c_band``).

    Expanding ``Dx' P Dx``-type products with the exclusive fwd/bwd masks
    (a*b = 0, a^2 = a) cancels every +-2 offset, so A^T A has 3x3 support;
    at sf <= 2 the box resample's tile mates lie within +-1 too, so KT^T KT
    folds in by the pixel's row and column phase."""
    if sf not in (1, 2, 4):
        raise ValueError(f"unsupported sf: {sf}")
    sh = gradops.shift
    P11, P12, P13 = op.P11, op.P12, op.P13
    P22, P23, P33 = op.P22, op.P23, op.P33
    ax, bx, ay, by = gm
    cx = ax - bx
    cy = ay - by
    E1 = ax * (P11 + cy * P12 + P13)
    E2 = bx * (P11 - cy * P12 - P13)
    F1 = ay * (P22 + cx * P12 + P23)
    F2 = by * (P22 - cx * P12 - P23)
    paa = ax * ay * P12
    pab = ax * by * P12
    pba = bx * ay * P12
    pbb = bx * by * P12
    cpe = -(E1 + sh(E2, 0, 1))
    cme = -(sh(E1, 0, -1) + E2)
    cpy = -(F1 + sh(F2, 1, 0))
    cmy = -(sh(F1, -1, 0) + F2)
    cpp = -(sh(pba, 0, 1) + sh(pab, 1, 0))
    cpm = sh(pbb, 0, 1) + sh(paa, -1, 0)
    cmp_ = sh(paa, 0, -1) + sh(pbb, 1, 0)
    cmm = -(sh(pab, 0, -1) + sh(pba, -1, 0))
    c0 = (sh(ax * P11, 0, -1) + (ax + bx) * P11 + sh(bx * P11, 0, 1)
          + sh(ay * P22, -1, 0) + (ay + by) * P22 + sh(by * P22, 1, 0)
          + 2.0 * (cx * cy * P12 + cx * P13 + cy * P23) + P33)
    cs = [lam * c for c in (c0, cpe, cme, cpy, cmy, cpp, cpm, cmp_, cmm)]
    if sf == 1:
        cs[0] = cs[0] + ktw
    elif sf == 2:
        h, w = ktw.shape
        dev = ktw.device
        pxe = (torch.arange(w, device=dev) % 2 == 0)[None, :]
        pye = (torch.arange(h, device=dev) % 2 == 0)[:, None]
        zero = torch.zeros_like(ktw)
        kxe = torch.where(pxe, ktw, zero)
        kxo = ktw - kxe
        cs[0] = cs[0] + ktw
        cs[1] = cs[1] + kxe
        cs[2] = cs[2] + kxo
        cs[3] = cs[3] + torch.where(pye, ktw, zero)
        cs[4] = cs[4] + torch.where(pye, zero, ktw)
        cs[5] = cs[5] + torch.where(pye, kxe, zero)
        cs[6] = cs[6] + torch.where(pye, zero, kxe)
        cs[7] = cs[7] + torch.where(pye, kxo, zero)
        cs[8] = cs[8] + torch.where(pye, zero, kxo)
    return torch.stack(cs)


def stencil_matvec(C: torch.Tensor, v: torch.Tensor, ktw: torch.Tensor,
                   sf: int) -> torch.Tensor:
    """``M v = sum_d C_d v[i + d]`` (+ ``ktw * tilesum(v)`` at sf = 4)."""
    sh = gradops.shift
    pe = sh(v, 0, 1)
    pw = sh(v, 0, -1)
    w = (C[0] * v + C[1] * pe + C[2] * pw + C[3] * sh(v, 1, 0)
         + C[4] * sh(v, -1, 0) + C[5] * sh(pe, 1, 0) + C[6] * sh(pe, -1, 0)
         + C[7] * sh(pw, 1, 0) + C[8] * sh(pw, -1, 0))
    if sf == 4:
        w = w + ktw * tilesum(v, sf)
    return w


def depth_rhs_fields(op, gm, z0t: torch.Tensor, lam: float) -> torch.Tensor:
    """``rhs = KT^T z0s + lam (Dx^T QB1 + Dy^T QB2 - QB3)``."""
    atb = gradops.grad_x_t(op.QB1, gm) + gradops.grad_y_t(op.QB2, gm) - op.QB3
    return z0t + lam * atb


def warm_start_energy(x: torch.Tensor, op, gm, z0u: torch.Tensor, lam: float,
                      sf: int) -> torch.Tensor:
    """Depth energy at ``x`` without ``lam * sum B^2``, each term in its
    per-pixel residual form (``_e0_band``): the identity x'Mx - 2x'rhs is
    unusable in f32, its two dots being ~1e6 times the energy."""
    g = gradops.grad_x(x, gm)
    h = gradops.grad_y(x, gm)
    quad = (op.P11 * g * g + op.P22 * h * h + op.P33 * x * x
            + 2.0 * (op.P12 * g * h - op.P13 * g * x - op.P23 * h * x))
    lin = op.QB1 * g + op.QB2 * h - op.QB3 * x
    edata = torch.sum(quad - 2.0 * lin)
    t = tilesum(x, sf) * (1.0 / (sf * sf))
    rkt = z0u[0] * t - z0u[1]
    ekt = torch.sum(rkt * rkt) * (1.0 / (sf * sf))
    return ekt + lam * edata


def stencil_cg_plain(x0, op, gm, ktw, z0t, z0u, *, sf: int, lam: float,
                     tol: float = 1e-9, max_iter: int = 100, planes: bool = False):
    """Plain PyTorch version of the kernel. Returns ``(x, iters, r1,
    e_part)`` (and the C planes with ``planes=True``) as device tensors;
    an ``active`` flag on the device replaces the early exit, so nothing is
    read back to the host."""
    C = build_c_planes(op, gm, ktw, lam, sf)
    tol_sq = tol_squared(tol)
    x = x0
    r = depth_rhs_fields(op, gm, z0t, lam) - stencil_matvec(C, x0, ktw, sf)
    e = warm_start_energy(x0, op, gm, z0u, lam, sf)
    r1 = torch.sum(r * r)
    r0 = torch.zeros_like(r1)
    p = torch.zeros_like(x0)
    active = torch.ones((), dtype=torch.bool, device=x0.device)
    iters = torch.zeros((), dtype=torch.int32, device=x0.device)
    for k in range(1, max_iter + 2):
        active = active & (r1 > tol_sq)
        iters = iters + active.to(torch.int32)
        if k == 1:
            beta = torch.zeros_like(r1)
        else:
            beta = r1 / torch.where(r0 == 0, torch.ones_like(r0), r0)
        p_new = r + beta * p
        w = stencil_matvec(C, p_new, ktw, sf)
        pw = torch.sum(p_new * w)
        alpha = r1 / torch.where(pw == 0, torch.ones_like(pw), pw)
        e = torch.where(active, e - alpha * r1, e)
        x = torch.where(active, x + alpha * p_new, x)
        r_new = r - alpha * w
        rr = torch.sum(r_new * r_new)
        r = torch.where(active, r_new, r)
        p = torch.where(active, p_new, p)
        r0 = torch.where(active, r1, r0)
        r1 = torch.where(active, rr, r1)
    out = (x, iters, r1, e)
    return out + (C,) if planes else out


def _library():
    """The built kernel library with its C signature declared."""
    from .. import native

    lib = native.load("stencil_cg")
    vp, ci, cf = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    lib.srps_stencil_cg.argtypes = [vp] * 12 + [ci, ci, ci, cf, cf, ci, ci,
                                                 ci, vp]
    lib.srps_stencil_cg.restype = ci
    return lib


def _check(name: str, t: torch.Tensor, shape, device) -> None:
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")
    if t.dtype != torch.float32:
        raise TypeError(f"{name} must be float32, got {t.dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} has shape {tuple(t.shape)}, expected {shape}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def stencil_cg(x0, op, gm, ktw, z0t, z0u, *, sf: int, lam: float,
               tol: float = 1e-9, max_iter: int = 100, block=(256, 4),
               planes: bool = False):
    """The depth CG: the CUDA kernels for a CUDA ``x0``, the plain version
    for a CPU ``x0``. ``block`` is the (x, y) thread-block shape of the
    kernels. Returns ``(x, iters, r1, e_part)`` like
    ``cg_pallas_vmem_fromop(..., with_energy=True)``, plus the C planes with
    ``planes=True``."""
    if x0.device.type == "cpu":
        return stencil_cg_plain(x0, op, gm, ktw, z0t, z0u, sf=sf, lam=lam,
                                tol=tol, max_iter=max_iter, planes=planes)
    if x0.device.type != "cuda":
        raise ValueError(f"stencil_cg runs on cpu or cuda, not {x0.device}")
    if sf not in (1, 2, 4):
        raise ValueError(f"unsupported sf: {sf}")
    h, w = x0.shape
    if h % sf or w % sf:
        raise ValueError(f"grid ({h}, {w}) is not a multiple of sf={sf}")
    bx, by = (int(b) for b in block)
    if bx <= 0 or by <= 0 or bx * by > MAX_BLOCK_THREADS:
        raise ValueError(f"thread block {bx}x{by} must hold 1..1024 threads")
    if max_iter < 0:
        raise ValueError(f"max_iter must be >= 0, got {max_iter}")
    dev = x0.device
    fields = {"P11": op.P11, "P12": op.P12, "P13": op.P13, "P22": op.P22,
              "P23": op.P23, "P33": op.P33, "fwd_x": gm[0], "bwd_x": gm[1],
              "fwd_y": gm[2], "bwd_y": gm[3], "ktw": ktw, "QB1": op.QB1,
              "QB2": op.QB2, "QB3": op.QB3, "z0t": z0t, "x0": x0}
    for name, t in fields.items():
        _check(name, t, (h, w), dev)
    _check("z0u", z0u, (2, h, w), dev)
    F = torch.stack([fields[k] for k in ("P11", "P12", "P13", "P22", "P23",
                                          "P33", "fwd_x", "bwd_x", "fwd_y",
                                          "bwd_y", "ktw")])
    R0 = torch.stack([op.QB1, op.QB2, op.QB3, z0t])
    x, r, p0, p1, wv = (torch.empty_like(x0) for _ in range(5))
    C = torch.empty((N_STENCIL, h, w), dtype=torch.float32, device=dev)
    nb = (-(-w // bx)) * (-(-h // by))
    part = torch.empty(2 * nb, dtype=torch.float32, device=dev)
    scal = torch.empty(N_SCAL, dtype=torch.float32, device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    err = _library().srps_stencil_cg(
        F.data_ptr(), R0.data_ptr(), z0u.data_ptr(), x0.data_ptr(),
        x.data_ptr(), r.data_ptr(), p0.data_ptr(), p1.data_ptr(),
        wv.data_ptr(), C.data_ptr(), part.data_ptr(), scal.data_ptr(),
        h, w, sf, float(lam), tol_squared(tol), int(max_iter), bx, by, stream)
    if err != 0:
        raise RuntimeError(f"stencil CG kernel launch failed: CUDA error {err}")
    stencil_cg.launches += 1
    out = (x, scal[S_ITERS].to(torch.int32), scal[S_R1], scal[S_E])
    return out + (C,) if planes else out


stencil_cg.launches = 0
