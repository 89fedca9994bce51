"""Depth CG through the 9-point stencil collapse of the depth operator.

Port of the TPU kernel ``srmeetsps_cuda_tpu/solve/pallas_cg_vmem.py::
_kernel_vmem_stencil`` (reached through ``cg_pallas_vmem_fromop[_batched]``,
srps.py:541-578, batched.py:155-173) in all its forms: plain CG or Jacobi
PCG, energy tracked, B >= 1 lanes, sf in {1, 2, 4}. It also covers
``_kernel_vmem_hybrid_stencil`` (pallas_cg_vmem.py:708), the same CG for
1080p-class grids whose C planes the TPU re-streams from HBM: the H100 has
no residency limit, so nothing here depends on the grid size. Two versions
of one function live here:

* :func:`stencil_cg_plain` — plain PyTorch, on ``(h, w)`` planes or on
  ``(B, h, w)`` lanes. The CPU path and the tests use it; on a CUDA device
  it serves only as the reference the kernel is held against.
* :func:`stencil_cg` — the wrapper of the hand-written CUDA kernels in
  ``csrc/stencil_cg.cu``: one problem (h, w) as the B = 1 case of a lane
  batch (B, h, w), all lanes in one launch. A CPU tensor takes the plain
  version; a CUDA tensor launches the kernels or raises.
  ``stencil_cg.launches`` counts the kernel runs, and
  ``stencil_cg.jacobi_launches`` those of them in a Jacobi form.

Both compute, per lane, from the warm start ``x0``:

* the 9 coefficient planes ``C = [C0, C+x, C-x, C+y, C-y, C+x+y, C+x-y,
  C-x+y, C-x-y]`` of ``M = KT^T KT + lam A^T A`` with ``(M v)[i] = sum_d
  C_d[i] v[i + d]`` ("+x" is column j + 1, "+y" row i + 1); at sf = 4 the
  KT^T KT term stays out of the planes and is applied as
  ``ktw * tilesum(v)``;
* ``r0 = rhs - M x0`` with ``rhs = KT^T z0s + lam A^T B``;
* the energy at ``x0`` in residual form, then the CG identity
  ``E -= alpha * r1`` per iteration (the caller adds ``lam * sum B^2``);
* the reference's CG: beta = 0 at k = 1, guarded divisions, stop when
  the stop dot is ``<= tol^2`` or after ``max_iter + 1`` iterations.

With ``invd = 1 / diag(M)`` the CG is Jacobi-preconditioned, in one of the
TPU kernel's two forms (:func:`jacobi_form`):

* ``"scaled"`` (sf <= 2, the default there): plain CG on ``S M S`` with
  ``S = diag(sqrt(invd))``. M x0 uses the unscaled planes; then
  ``C'_d[i] = (s_i C_d[i]) s_{i+d}``, ``r' = s (rhs - M x0)``, the
  correction y iterates from 0 and ``x = x0 + s y``. ``<r', r'>`` drives
  the stop test and the energy; the reported residual is
  ``sum r'^2 / invd``.
* ``"pcg"`` (sf = 4, where KT^T KT is outside the planes): the in-sweep
  PCG, ``p = invd r + beta p``; ``rz = sum r^2 invd`` drives alpha, beta
  and the energy, and ``<r, r>`` the stop test and the reported residual.

The TPU's 1080p-class kernel has only the PCG form, so at sf <= 2 on such
grids the port (scaled) and the JAX package (PCG) run two algebraically
equal recurrences whose iterates agree only within the unconverged-CG
drift bounds.

The kernel is bound by memory bandwidth: about 19 f32 planes move per
iteration and lane (93 MB at 960 x 1280; 21 in the PCG form) against about
27 flops per pixel.
"""

from __future__ import annotations

import ctypes

import torch

from ..ops import gradients as gradops
from ..ops.grid import box_upsample_adjoint, tilesum
from .cg import tol_squared

N_STENCIL = 9
# Device scalar slots of the standard-CG kernels (csrc/std_cg.cuh, shared
# by stencil_cg.cu and direct_cg.cu): r1 is the dot that drives alpha and
# beta, rr the reported residual.
S_R1, S_E, S_ITERS, S_RR = 1, 5, 7, 9
N_SCAL = 10
# Rows of per-block partial sums per lane.
PART_ROWS = 3
# The kernels' jacobi argument.
JACOBI_MODES = {None: 0, "scaled": 1, "pcg": 2}
MAX_BLOCK_THREADS = 1024
F_ROWS = ("P11", "P12", "P13", "P22", "P23", "P33", "fwd_x", "bwd_x",
          "fwd_y", "bwd_y", "ktw")


def lane_dot(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``<a, b>`` over the trailing (h, w) plane of each lane."""
    return torch.sum(a * b, dim=(-2, -1))


def per_pixel(s: torch.Tensor) -> torch.Tensor:
    """A per-lane scalar broadcast over its lane's (h, w) plane."""
    return s[..., None, None]


def make_ktw(mask: torch.Tensor, masks: torch.Tensor, sf: int) -> torch.Tensor:
    """``mask * up(masks) / sf^4``: the HR-layout weight of KT^T KT, so that
    ``KT^T KT v = ktw * tilesum(v)`` (pallas_cg.py:380-385)."""
    return mask * box_upsample_adjoint(masks, sf) / float(sf * sf)


def energy_planes(masks: torch.Tensor, z0s: torch.Tensor, sf: int) -> torch.Tensor:
    """(..., 2, h, w): ``up(masks)`` and ``up(masks * z0s)``, the
    loop-invariant planes of the KT term of the energy
    (pallas_cg_vmem.py:339-351, without the TPU padding)."""
    s2 = float(sf * sf)
    u1 = box_upsample_adjoint(masks, sf) * s2
    u2 = box_upsample_adjoint(z0s * masks, sf) * s2
    return torch.stack([u1, u2], dim=-3)


def build_c_planes(op, gm, ktw: torch.Tensor, lam: float, sf: int,
                   row0: int = 0) -> torch.Tensor:
    """The (..., 9, h, w) stencil planes of M (``_build_c_band``). ``row0``
    is the image row of the planes' first row (-1 for a row shard's fields
    with a halo row above), whose parity the sf = 2 fold reads.

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
        h, w = ktw.shape[-2:]
        dev = ktw.device
        pxe = (torch.arange(w, device=dev) % 2 == 0)[None, :]
        pye = ((torch.arange(h, device=dev) + row0) % 2 == 0)[:, None]
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
    return torch.stack(cs, dim=-3)


def stencil_matvec(C: torch.Tensor, v: torch.Tensor, ktw: torch.Tensor,
                   sf: int) -> torch.Tensor:
    """``M v = sum_d C_d v[i + d]`` (+ ``ktw * tilesum(v)`` at sf = 4)."""
    sh = gradops.shift
    c = C.unbind(-3)
    pe = sh(v, 0, 1)
    pw = sh(v, 0, -1)
    w = (c[0] * v + c[1] * pe + c[2] * pw + c[3] * sh(v, 1, 0)
         + c[4] * sh(v, -1, 0) + c[5] * sh(pe, 1, 0) + c[6] * sh(pe, -1, 0)
         + c[7] * sh(pw, 1, 0) + c[8] * sh(pw, -1, 0))
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
    edata = torch.sum(quad - 2.0 * lin, dim=(-2, -1))
    t = tilesum(x, sf) * (1.0 / (sf * sf))
    rkt = z0u[..., 0, :, :] * t - z0u[..., 1, :, :]
    ekt = torch.sum(rkt * rkt, dim=(-2, -1)) * (1.0 / (sf * sf))
    return ekt + lam * edata


def jacobi_form(sf: int) -> str:
    """The Jacobi form a solve at ``sf`` runs: ``"scaled"`` at sf <= 2 and
    ``"pcg"`` at sf = 4 (where KT^T KT is not in the C planes), as the TPU
    kernel chooses on the grids where all of its state is resident
    (pallas_cg_vmem.py:1427)."""
    return "scaled" if sf in (1, 2) else "pcg"


def scale_c_planes(C: torch.Tensor, invd: torch.Tensor) -> torch.Tensor:
    """``C'_d[i] = (s_i C_d[i]) s_{i+d}`` with ``s = sqrt(invd)``, the
    planes of ``S M S`` (``_scale_c_band``). Outside the image s reads 0,
    where C_d is 0 already."""
    sh = gradops.shift
    s = torch.sqrt(invd)
    se = sh(s, 0, 1)
    sw = sh(s, 0, -1)
    mates = (s, se, sw, sh(s, 1, 0), sh(s, -1, 0), sh(se, 1, 0),
             sh(se, -1, 0), sh(sw, 1, 0), sh(sw, -1, 0))
    return torch.stack([(s * c) * m for c, m in zip(C.unbind(-3), mates)],
                       dim=-3)


def cg_loop(x, r, matvec, *, tol: float, max_iter: int, invd=None, e=None):
    """The reference's standard CG of every depth-CG kernel from the iterate
    ``x`` and its residual ``r`` (per lane): beta = 0 at k = 1, guarded
    divisions, stop when ``<r, r> <= tol^2`` or after ``max_iter + 1``
    iterations. With ``invd`` it is the in-sweep Jacobi PCG: ``p = invd r +
    beta p``, ``rz = sum r^2 invd`` drives alpha and beta. A tracked energy
    ``e`` takes ``E -= alpha * r1`` (r1 = rz under Jacobi). An ``active``
    flag per lane on the device replaces the early exit, so nothing is read
    back to the host. Returns ``(x, iters, rr, r, e)``."""
    pcg = invd is not None
    tol_sq = tol_squared(tol)
    rr = lane_dot(r, r)
    r1 = lane_dot(r * r, invd) if pcg else rr
    r0 = torch.zeros_like(r1)
    p = torch.zeros_like(x)
    active = torch.ones(r1.shape, dtype=torch.bool, device=x.device)
    iters = torch.zeros(r1.shape, dtype=torch.int32, device=x.device)
    for k in range(1, max_iter + 2):
        active = active & (rr > tol_sq)
        iters = iters + active.to(torch.int32)
        if k == 1:
            beta = torch.zeros_like(r1)
        else:
            beta = r1 / torch.where(r0 == 0, torch.ones_like(r0), r0)
        p_new = (invd * r if pcg else r) + per_pixel(beta) * p
        w = matvec(p_new)
        pw = lane_dot(p_new, w)
        alpha = r1 / torch.where(pw == 0, torch.ones_like(pw), pw)
        if e is not None:
            e = torch.where(active, e - alpha * r1, e)
        on = per_pixel(active)
        x = torch.where(on, x + per_pixel(alpha) * p_new, x)
        r_new = r - per_pixel(alpha) * w
        rr_new = lane_dot(r_new, r_new)
        r1_new = lane_dot(r_new * r_new, invd) if pcg else rr_new
        r = torch.where(on, r_new, r)
        p = torch.where(on, p_new, p)
        r0 = torch.where(active, r1, r0)
        r1 = torch.where(active, r1_new, r1)
        rr = torch.where(active, rr_new, rr)
    return x, iters, rr, r, e


def stencil_cg_plain(x0, op, gm, ktw, z0t, z0u, *, sf: int, lam: float,
                     tol: float = 1e-9, max_iter: int = 100,
                     planes: bool = False, invd=None):
    """Plain PyTorch version of the kernel, on ``(h, w)`` planes or
    ``(B, h, w)`` lanes (every input with the same leading axis). ``invd``
    turns on Jacobi preconditioning in the form :func:`jacobi_form` picks.
    Returns ``(x, iters, r1, e_part)`` (and the C planes with
    ``planes=True``, C' in the scaled form) as device tensors, the scalars
    one per lane (:func:`cg_loop`)."""
    form = None if invd is None else jacobi_form(sf)
    pcg = form == "pcg"
    C = build_c_planes(op, gm, ktw, lam, sf)
    x = x0
    r = depth_rhs_fields(op, gm, z0t, lam) - stencil_matvec(C, x0, ktw, sf)
    e = warm_start_energy(x0, op, gm, z0u, lam, sf)
    if form == "scaled":
        s = torch.sqrt(invd)
        C = scale_c_planes(C, invd)
        r = s * r
        x = torch.zeros_like(x0)
    x, iters, rr, r, e = cg_loop(
        x, r, lambda v: stencil_matvec(C, v, ktw, sf), tol=tol,
        max_iter=max_iter, invd=invd if pcg else None, e=e)
    if form == "scaled":
        x = x0 + s * x
        rr = torch.sum(torch.where(invd > 0, r * r / invd,
                                   torch.zeros_like(r)), dim=(-2, -1))
    out = (x, iters, rr, e)
    return out + (C,) if planes else out


def _library():
    """The built kernel library with its C signature declared."""
    from .. import native

    lib = native.load("stencil_cg")
    vp, ci, cf = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    lib.srps_stencil_cg.argtypes = [vp] * 13 + [ci, ci, ci, ci, cf, cf, ci,
                                                 ci, ci, ci, vp]
    lib.srps_stencil_cg.restype = ci
    return lib


def check_tensor(name: str, t: torch.Tensor, shape, device) -> None:
    """Raise unless ``t`` is a contiguous float32 tensor of ``shape`` on
    ``device``: what the CUDA kernels take."""
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")
    if t.dtype != torch.float32:
        raise TypeError(f"{name} must be float32, got {t.dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} has shape {tuple(t.shape)}, expected {shape}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def pack_lanes(kernel: str, x0, op, gm, ktw, z0t, *, sf: int, max_iter: int,
               block, invd=None, r0: bool = True):
    """Check the inputs of a CUDA launch over the lanes of ``x0`` (B, h, w)
    (and ``invd`` where given) and stack the packs every depth-CG kernel
    reads: F (B, 11, h, w) = [P11..P33, fwd_x, bwd_x, fwd_y, bwd_y, ktw]
    and R0 (B, 4, h, w) = [QB1, QB2, QB3, z0t] (None with ``r0=False``, for
    a kernel given its residual). Returns ``(F, R0, (bx, by), blocks per
    lane)``."""
    if x0.device.type != "cuda":
        raise ValueError(f"{kernel} runs on cpu or cuda, not {x0.device}")
    if x0.dim() != 3:
        raise ValueError(f"{kernel}: x0 must be (B, h, w), got "
                         f"{tuple(x0.shape)}")
    if sf not in (1, 2, 4):
        raise ValueError(f"unsupported sf: {sf}")
    B, h, w = x0.shape
    if h % sf or w % sf:
        raise ValueError(f"grid ({h}, {w}) is not a multiple of sf={sf}")
    bx, by = (int(b) for b in block)
    if bx <= 0 or by <= 0 or bx * by > MAX_BLOCK_THREADS:
        raise ValueError(f"thread block {bx}x{by} must hold 1..1024 threads")
    if max_iter < 0:
        raise ValueError(f"max_iter must be >= 0, got {max_iter}")
    fields = {"P11": op.P11, "P12": op.P12, "P13": op.P13, "P22": op.P22,
              "P23": op.P23, "P33": op.P33, "fwd_x": gm[0], "bwd_x": gm[1],
              "fwd_y": gm[2], "bwd_y": gm[3], "ktw": ktw, "QB1": op.QB1,
              "QB2": op.QB2, "QB3": op.QB3, "z0t": z0t, "x0": x0}
    if invd is not None:
        fields["invd"] = invd
    for name, t in fields.items():
        check_tensor(name, t, (B, h, w), x0.device)
    F = torch.stack([fields[k] for k in F_ROWS], dim=1)
    R0 = torch.stack([op.QB1, op.QB2, op.QB3, z0t], dim=1) if r0 else None
    return F, R0, (bx, by), (-(-w // bx)) * (-(-h // by))


def one_lane(x0, op, gm, *planes):
    """(h, w) inputs of one problem as a lane batch of B = 1."""
    one = lambda t: t.unsqueeze(0)  # noqa: E731
    return (one(x0), type(op)(*map(one, op)), type(gm)(*map(one, gm)),
            *map(one, planes))


def stencil_cg(x0, op, gm, ktw, z0t, z0u, *, sf: int, lam: float,
               tol: float = 1e-9, max_iter: int = 100, block=(256, 4),
               planes: bool = False, invd=None):
    """The depth CG: the CUDA kernels for a CUDA ``x0``, the plain version
    for a CPU one. ``x0`` is (h, w) for one problem or (B, h, w) for B
    lanes in one launch; every other input carries the same leading axes
    (``z0u`` is (..., 2, h, w)). ``block`` is the (x, y) thread-block
    shape. ``invd`` (like ``x0``) turns on Jacobi preconditioning in the
    form :func:`jacobi_form` picks from ``sf``. Returns
    ``(x, iters, r1, e_part)`` like ``cg_pallas_vmem_fromop[_batched](...,
    with_energy=True)``, the scalars one per lane, plus the C planes
    (..., 9, h, w) with ``planes=True``. Each lane's result is bit for bit
    that of its own B = 1 launch."""
    if x0.device.type == "cpu":
        return stencil_cg_plain(x0, op, gm, ktw, z0t, z0u, sf=sf, lam=lam,
                                tol=tol, max_iter=max_iter, planes=planes,
                                invd=invd)
    if x0.dim() == 2:
        out = stencil_cg(*one_lane(x0, op, gm, ktw, z0t, z0u), sf=sf,
                         lam=lam, tol=tol, max_iter=max_iter, block=block,
                         planes=planes,
                         invd=None if invd is None else invd.unsqueeze(0))
        return tuple(t[0] for t in out)
    form = None if invd is None else jacobi_form(sf)
    F, R0, (bx, by), nb = pack_lanes("stencil_cg", x0, op, gm, ktw, z0t,
                                     sf=sf, max_iter=max_iter, block=block,
                                     invd=invd)
    B, h, w = x0.shape
    dev = x0.device
    check_tensor("z0u", z0u, (B, 2, h, w), dev)
    x, r, p0, p1, wv = (torch.empty_like(x0) for _ in range(5))
    C = torch.empty((B, N_STENCIL, h, w), dtype=torch.float32, device=dev)
    part = torch.empty(B * PART_ROWS * nb, dtype=torch.float32, device=dev)
    scal = torch.empty((B, N_SCAL), dtype=torch.float32, device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    err = _library().srps_stencil_cg(
        F.data_ptr(), R0.data_ptr(), z0u.data_ptr(), x0.data_ptr(),
        None if invd is None else invd.data_ptr(), x.data_ptr(),
        r.data_ptr(), p0.data_ptr(), p1.data_ptr(), wv.data_ptr(),
        C.data_ptr(), part.data_ptr(), scal.data_ptr(), B, h, w, sf,
        float(lam), tol_squared(tol), int(max_iter), bx, by,
        JACOBI_MODES[form], stream)
    if err != 0:
        raise RuntimeError(f"stencil CG kernel launch failed: CUDA error {err}")
    stencil_cg.launches += 1
    if form is not None:
        stencil_cg.jacobi_launches += 1
    out = (x, scal[:, S_ITERS].to(torch.int32), scal[:, S_RR], scal[:, S_E])
    return out + (C,) if planes else out


stencil_cg.launches = 0
stencil_cg.jacobi_launches = 0
