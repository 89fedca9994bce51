"""SRmeetsPS model: the three alternating least-squares estimators.

Port of ``srmeetsps_cuda_tpu/models/srps.py`` (reference SRPS.cu:276-335 and
devicecalls.cu). The structure is the JAX package's:

* **Lighting**: all (image, channel) 4x4 normal equations at once — the
  Gram matrices depend on the channel only — solved by the closed-form
  adjugate; a singular system keeps the previous lighting.
* **Albedo**: the diagonal normal equations' closed-form per-pixel
  solution ``rho = sum_i sh_i I_i / sum_i sh_i^2``, from the lighting Gram
  ``G_c`` and the correlation images ``J``.
* **Depth**: ``A^T A`` of the linearised normal-consistency term collapses
  onto six per-pixel Gram fields ``P..`` and the rhs onto ``QB1..3``; the
  CG then runs on the 9-point stencil form of ``M = KT^T KT + lam A^T A``
  (``solve/stencil_cg.py``, or ``solve/cgs_cg.py`` for the
  Chronopoulos-Gear variant), or with ``cg_operator`` set on the direct
  mask-gated matvec (``solve/direct_cg.py``): the hand-written CUDA kernel
  on a CUDA device, its plain PyTorch version on the CPU.

State lives on dense ``(h, w)`` grids zeroed outside the mask. Contractions
run in full float32 (``device.set_precision``), as the JAX package's
``Precision.HIGHEST`` dots.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import numpy as np
import torch

from ..config import SolverConfig
from ..ops import gradients as gradops
from ..ops import grid as gridops
from ..ops.gradients import GradientMasks
from ..ops.normals import normals_from_depth
from ..solve.cgs_cg import cgs_cg
from ..solve.direct_cg import direct_cg
from ..solve.stencil_cg import (depth_rhs_fields, energy_planes, make_ktw,
                                stencil_cg)

# SolverConfig.cg_operator values: how the depth CG applies M.
CG_OPERATORS = ("stencil", "direct", "direct_host_r0")


class SRPSProblem(NamedTuple):
    """Static problem data. I (c, n, h*w) channel-major and pixel-flat;
    mask, xx, yy, z0t, ktw (h, w); masks, z0s (h/sf, w/sf); SI2 (c, h, w);
    z0u (2, h, w) = [up(masks), up(masks * z0s)], the energy planes."""

    I: torch.Tensor
    mask: torch.Tensor
    masks: torch.Tensor
    z0s: torch.Tensor
    xx: torch.Tensor
    yy: torch.Tensor
    fx: float
    fy: float
    gm: GradientMasks
    SI2: torch.Tensor
    z0t: torch.Tensor
    ktw: torch.Tensor
    z0u: torch.Tensor


class SRPSState(NamedTuple):
    """z (h, w); rho (c, h, w); s (n, c, 4); N (4, h, w); dz (h, w);
    energy and last_energy 0-d tensors; iteration a host int; cg_iters a
    0-d int32 tensor."""

    z: torch.Tensor
    rho: torch.Tensor
    s: torch.Tensor
    N: torch.Tensor
    dz: torch.Tensor
    energy: torch.Tensor
    last_energy: torch.Tensor
    iteration: int
    cg_iters: torch.Tensor


def _f32(a, device) -> torch.Tensor:
    """A row-major float32 tensor on ``device`` (MAT files load
    column-major, and elementwise ops would carry those strides on)."""
    if isinstance(a, torch.Tensor):
        return a.to(device=device, dtype=torch.float32).contiguous()
    return torch.as_tensor(np.ascontiguousarray(a, np.float32), device=device)


# ---------------------------------------------------------------------------
# Problem / state construction
# ---------------------------------------------------------------------------


def build_problem(I, mask, K, sf: int, z0s, device) -> SRPSProblem:
    """Assemble the problem on ``device``.

    Args:
      I: (n, c, h, w) images, zeroed outside the mask here (the reference
         gathers only masked pixels, SRPS.cu:222-234).
      mask: (h, w); binarised with the reference's predicate ``!= 0``.
      K: (3, 3) intrinsics.
      sf: integer scale factor; h and w must be multiples of it.
      z0s: (h/sf, w/sf) preprocessed LR depth.
    """
    mask = (_f32(mask, device) != 0).to(torch.float32)
    h, w = mask.shape
    I = _f32(I, device).permute(1, 0, 2, 3) * mask
    c_, n_ = I.shape[:2]
    masks = gridops.lr_mask(mask, sf)
    K = np.asarray(K, np.float32)
    xx, yy = gridops.meshgrid_camera(h, w, float(K[0][2]), float(K[1][2]),
                                     device=device)
    z0s = _f32(z0s, device) * masks
    return SRPSProblem(
        I=I.reshape(c_, n_, h * w).contiguous(),
        mask=mask,
        masks=masks,
        z0s=z0s,
        xx=xx * mask,
        yy=yy * mask,
        fx=float(K[0][0]),
        fy=float(K[1][1]),
        gm=GradientMasks.from_mask(mask),
        SI2=torch.sum(I * I, dim=1),
        z0t=gridops.resample_masked_t(z0s, mask, masks, sf),
        ktw=make_ktw(mask, masks, sf),
        z0u=energy_planes(masks, z0s, sf),
    )


def init_state(prob: SRPSProblem, z_init) -> SRPSState:
    """SRPS.cu:206-270: s = [0, 0, -1, 0] per (image, channel), rho = 0.5
    on the mask, normals from the initial depth."""
    h, w = prob.mask.shape
    c, n = prob.I.shape[:2]
    dev = prob.mask.device
    s = torch.zeros((n, c, 4), dtype=torch.float32, device=dev)
    s[:, :, 2] = -1.0
    rho = (0.5 * prob.mask).expand(c, h, w).contiguous()
    z = _f32(z_init, dev) * prob.mask
    N, dz = depth_normals(z, prob)
    nan = torch.tensor(math.nan, dtype=torch.float32, device=dev)
    return SRPSState(z=z, rho=rho, s=s, N=N, dz=dz, energy=nan,
                     last_energy=nan.clone(), iteration=0,
                     cg_iters=torch.zeros((), dtype=torch.int32, device=dev))


def depth_normals(z, prob: SRPSProblem):
    """``(N, dz)`` of the depth ``z`` through the masked gradients."""
    zx =gradops.grad_x(z, prob.gm)
    zy = gradops.grad_y(z, prob.gm)
    return normals_from_depth(z, zx, zy, prob.xx, prob.yy, prob.mask,
                              prob.fx, prob.fy)


# ---------------------------------------------------------------------------
# Lighting estimation
# ---------------------------------------------------------------------------


def estimate_lighting(prob: SRPSProblem, rho, N, s_prev=None) -> torch.Tensor:
    """Per-(image, channel) first-order SH lighting least squares
    (devicecalls.cu:408-444). Where the closed-form solve is non-finite
    (a degenerate channel: ATA singular) ``s_prev`` is kept, as the
    reference's CG never moves off a zero warm-start residual."""
    c, n, P = prob.I.shape
    rf = rho.reshape(c, P)
    Nf = N.reshape(4, P)
    R2 = rf * rf
    ata = {}
    for a in range(4):
        for b in range(a, 4):
            ata[(a, b)] = torch.sum(R2 * (Nf[a] * Nf[b])[None, :], dim=-1)
    ATA = torch.stack([
        torch.stack([ata[(min(a, b), max(a, b))] for b in range(4)], dim=-1)
        for a in range(4)
    ], dim=-2)  # (c, 4, 4)
    T = rf[:, None, :] * Nf[None, :, :]  # (c, 4, P)
    ATb = _pixel_contraction(prob.I, T)  # (c, n, 4)
    inv = _inv4(ATA)
    sol = torch.einsum("cab,cnb->nca", inv, ATb)
    if s_prev is None:
        return sol
    ok = torch.all(torch.isfinite(sol), dim=-1, keepdim=True)
    return torch.where(ok, sol, s_prev)


def _pixel_chunks(P: int, max_chunks: int = 1024, min_len: int = 256) -> int:
    """The largest chunk count S <= max_chunks dividing P with chunks of
    at least min_len pixels (1 when none does)."""
    for S in range(min(max_chunks, P // min_len), 1, -1):
        if P % S == 0:
            return S
    return 1


def _pixel_contraction(I: torch.Tensor, T: torch.Tensor) -> torch.Tensor:
    """``out[c, n, a] = sum_p I[c, n, p] T[c, a, p]`` in full f32.

    One ``bmm`` over the pixel axis leaves cuBLAS a 20 x 4 output per
    channel, and it streams the whole image stack through a few blocks (18
    ms per call at 960 x 1280, n = 20 on an H100). The pixel axis is split
    into S chunks instead — strided views of I and T, no copy — giving S
    small products per channel that fill the card, whose partial sums are
    then added."""
    c, n, P = I.shape
    S = _pixel_chunks(P)
    m = P // S
    out = []
    for ci in range(c):
        a = I[ci].view(n, S, m).transpose(0, 1)  # (S, n, m)
        b = T[ci].view(-1, S, m).permute(1, 2, 0)  # (S, m, 4)
        out.append(torch.bmm(a, b).sum(dim=0))
    return torch.stack(out)


def _inv4(A: torch.Tensor) -> torch.Tensor:
    """Batched explicit 4x4 inverse by the 2x2-minor Laplace expansion
    (adjugate / det). A singular matrix gives det = 0 and non-finite
    entries, which the caller's ``s_prev`` retention relies on — unlike
    ``torch.linalg.inv``, which raises."""
    a = [[A[..., i, j] for j in range(4)] for i in range(4)]
    s0 = a[0][0] * a[1][1] - a[0][1] * a[1][0]
    s1 = a[0][0] * a[1][2] - a[0][2] * a[1][0]
    s2 = a[0][0] * a[1][3] - a[0][3] * a[1][0]
    s3 = a[0][1] * a[1][2] - a[0][2] * a[1][1]
    s4 = a[0][1] * a[1][3] - a[0][3] * a[1][1]
    s5 = a[0][2] * a[1][3] - a[0][3] * a[1][2]
    c5 = a[2][2] * a[3][3] - a[2][3] * a[3][2]
    c4 = a[2][1] * a[3][3] - a[2][3] * a[3][1]
    c3 = a[2][1] * a[3][2] - a[2][2] * a[3][1]
    c2 = a[2][0] * a[3][3] - a[2][3] * a[3][0]
    c1 = a[2][0] * a[3][2] - a[2][2] * a[3][0]
    c0 = a[2][0] * a[3][1] - a[2][1] * a[3][0]
    det = s0 * c5 - s1 * c4 + s2 * c3 + s3 * c2 - s4 * c1 + s5 * c0
    r = 1.0 / det
    adj = [
        [a[1][1] * c5 - a[1][2] * c4 + a[1][3] * c3,
         -a[0][1] * c5 + a[0][2] * c4 - a[0][3] * c3,
         a[3][1] * s5 - a[3][2] * s4 + a[3][3] * s3,
         -a[2][1] * s5 + a[2][2] * s4 - a[2][3] * s3],
        [-a[1][0] * c5 + a[1][2] * c2 - a[1][3] * c1,
         a[0][0] * c5 - a[0][2] * c2 + a[0][3] * c1,
         -a[3][0] * s5 + a[3][2] * s2 - a[3][3] * s1,
         a[2][0] * s5 - a[2][2] * s2 + a[2][3] * s1],
        [a[1][0] * c4 - a[1][1] * c2 + a[1][3] * c0,
         -a[0][0] * c4 + a[0][1] * c2 - a[0][3] * c0,
         a[3][0] * s4 - a[3][1] * s2 + a[3][3] * s0,
         -a[2][0] * s4 + a[2][1] * s2 - a[2][3] * s0],
        [-a[1][0] * c3 + a[1][1] * c1 - a[1][2] * c0,
         a[0][0] * c3 - a[0][1] * c1 + a[0][2] * c0,
         -a[3][0] * s3 + a[3][1] * s1 - a[3][2] * s0,
         a[2][0] * s3 - a[2][1] * s1 + a[2][2] * s0],
    ]
    return torch.stack(
        [torch.stack([adj[i][j] * r for j in range(4)], dim=-1)
         for i in range(4)], dim=-2)


# ---------------------------------------------------------------------------
# Shared s-moments (feed albedo and depth)
# ---------------------------------------------------------------------------


class SMoments(NamedTuple):
    G: torch.Tensor  # (c, 4, 4)    sum_i s_ic s_ic^T
    J: torch.Tensor  # (c, 4, h, w) sum_i s[i, c, k] * I[i, c]


def s_moments(prob: SRPSProblem, s) -> SMoments:
    h, w = prob.mask.shape
    c = prob.I.shape[0]
    G = torch.einsum("nck,ncl->ckl", s, s)
    sx = s.permute(1, 2, 0)  # (c, 4, n)
    J = torch.bmm(sx, prob.I).reshape(c, 4, h, w)
    return SMoments(G, J)


# ---------------------------------------------------------------------------
# Albedo estimation
# ---------------------------------------------------------------------------


def estimate_albedo(prob: SRPSProblem, mom: SMoments, N, rho_prev) -> torch.Tensor:
    """Closed-form per-pixel albedo (devicecalls.cu:497-548); where no image
    constrains a pixel (den = 0) the previous albedo is kept."""
    c = mom.J.shape[0]
    num = torch.stack([
        sum(N[k] * mom.J[i, k] for k in range(4)) for i in range(c)])
    NN = {(k, l): N[k] * N[l] for k in range(4) for l in range(k, 4)}
    den = torch.stack([
        sum((1.0 if k == l else 2.0) * mom.G[i, k, l] * NN[(k, l)]
            for k in range(4) for l in range(k, 4))
        for i in range(c)])
    pos = den > 0
    rho = torch.where(pos, num / torch.where(pos, den, torch.ones_like(den)),
                      rho_prev)
    return rho * prob.mask


# ---------------------------------------------------------------------------
# Depth estimation
# ---------------------------------------------------------------------------


class DepthOperator(NamedTuple):
    """Per-outer-iteration collapsed coefficient fields (all (h, w))."""

    P11: torch.Tensor
    P12: torch.Tensor
    P13: torch.Tensor
    P22: torch.Tensor
    P23: torch.Tensor
    P33: torch.Tensor
    QB1: torch.Tensor
    QB2: torch.Tensor
    QB3: torch.Tensor
    const: torch.Tensor  # 0-d: sum B^2


def build_depth_operator(prob: SRPSProblem, mom: SMoments, rho, dz,
                         lam: float) -> DepthOperator:
    """Collapse the sums over (channel, image) of the per-row coefficients
    ``A_k = (rho_c / dz) u_k`` (devicecalls.cu:583-599) into Gram fields:
    with u1 = fx s1 - xx s3, u2 = fy s2 - yy s3, u3 = s3 every pairwise sum
    over images reduces to G_c and every I-correlation to J."""
    fx, fy, xx, yy = prob.fx, prob.fy, prob.xx, prob.yy
    G = mom.G
    w1 = rho / dz
    w2 = w1 * w1
    w1r = w1 * rho
    c = w1.shape[0]
    A00 = sum(w2[i] * G[i, 0, 0] for i in range(c))
    A01 = sum(w2[i] * G[i, 0, 1] for i in range(c))
    A02 = sum(w2[i] * G[i, 0, 2] for i in range(c))
    A11 = sum(w2[i] * G[i, 1, 1] for i in range(c))
    A12 = sum(w2[i] * G[i, 1, 2] for i in range(c))
    A22 = sum(w2[i] * G[i, 2, 2] for i in range(c))
    D03 = sum(w1r[i] * G[i, 0, 3] for i in range(c))
    D13 = sum(w1r[i] * G[i, 1, 3] for i in range(c))
    D23 = sum(w1r[i] * G[i, 2, 3] for i in range(c))
    B0 = sum(w1[i] * mom.J[i, 0] for i in range(c))
    B1 = sum(w1[i] * mom.J[i, 1] for i in range(c))
    B2 = sum(w1[i] * mom.J[i, 2] for i in range(c))

    P11 = fx * fx * A00 - 2.0 * fx * xx * A02 + xx * xx * A22
    P22 = fy * fy * A11 - 2.0 * fy * yy * A12 + yy * yy * A22
    P33 = A22
    P12 = fx * fy * A01 - fx * yy * A02 - fy * xx * A12 + xx * yy * A22
    P13 = fx * A02 - xx * A22
    P23 = fy * A12 - yy * A22

    QB3 = B2 - D23
    QB1 = fx * (B0 - D03) - xx * QB3
    QB2 = fy * (B1 - D13) - yy * QB3
    const = (torch.sum(prob.SI2) - 2.0 * torch.sum(rho * mom.J[:, 3])
             + torch.dot(torch.sum(rho * rho, dim=(1, 2)), G[:, 3, 3]))
    return DepthOperator(P11, P12, P13, P22, P23, P33, QB1, QB2, QB3, const)


def depth_matvec(v, op: DepthOperator, prob: SRPSProblem, sf: int, lam: float):
    """``M v = KT^T KT v + lam A^T A v`` through the gradient stencils."""
    gm = prob.gm
    g = gradops.grad_x(v, gm)
    h = gradops.grad_y(v, gm)
    t1 = op.P11 * g + op.P12 * h - op.P13 * v
    t2 = op.P12 * g + op.P22 * h - op.P23 * v
    t3 = op.P13 * g + op.P23 * h - op.P33 * v
    ata = gradops.grad_x_t(t1, gm) + gradops.grad_y_t(t2, gm) - t3
    kt = gridops.resample_masked(v, prob.masks, sf)
    ktt = gridops.resample_masked_t(kt, prob.mask, prob.masks, sf)
    return ktt + lam * ata


def depth_rhs(op: DepthOperator, prob: SRPSProblem, sf: int, lam: float):
    """``rhs = KT^T z0s + lam A^T B`` (devicecalls.cu:743-745)."""
    return depth_rhs_fields(op, prob.gm, prob.z0t, lam)


def depth_diag(op: DepthOperator, prob: SRPSProblem, sf: int, lam: float):
    """Diagonal of M, for Jacobi preconditioning."""
    gm = prob.gm
    sh = gradops.shift
    sigx = gm.bwd_x - gm.fwd_x
    sigy = gm.bwd_y - gm.fwd_y
    dxx = (op.P11 * (gm.fwd_x + gm.bwd_x) + sh(op.P11 * gm.fwd_x, 0, -1)
           + sh(op.P11 * gm.bwd_x, 0, 1))
    dyy = (op.P22 * (gm.fwd_y + gm.bwd_y) + sh(op.P22 * gm.fwd_y, -1, 0)
           + sh(op.P22 * gm.bwd_y, 1, 0))
    cross = 2.0 * op.P12 * sigx * sigy
    lin = -2.0 * op.P13 * sigx - 2.0 * op.P23 * sigy
    d = prob.ktw + lam * (dxx + dyy + cross + lin + op.P33)
    return torch.where(d > 0, d, torch.ones_like(d))


def depth_energy(z_new, op: DepthOperator, prob: SRPSProblem, sf: int,
                 lam: float):
    """``||KT z - z0s||^2 + lam ||A z - B||^2`` via the Gram-field collapse
    (devicecalls.cu:762-767)."""
    g = gradops.grad_x(z_new, prob.gm)
    h = gradops.grad_y(z_new, prob.gm)
    e_data = (
        torch.sum(op.P11 * g * g + op.P22 * h * h + op.P33 * z_new * z_new)
        + 2.0 * torch.sum(op.P12 * g * h - op.P13 * g * z_new
                          - op.P23 * h * z_new)
        - 2.0 * torch.sum(op.QB1 * g + op.QB2 * h - op.QB3 * z_new)
        + op.const
    )
    r1 = gridops.resample_masked(z_new, prob.masks, sf) - prob.z0s
    return torch.sum(r1 * r1) + lam * e_data


def depth_cg(z, op: DepthOperator, prob: SRPSProblem, sf: int,
             cfg: SolverConfig, block=(256, 4), lanes=None):
    """The warm-started depth CG from ``z`` on ``op`` and its energy, for
    one problem, or for B lane-stacked ones in one launch with ``lanes``
    their per-lane ``(op, prob)`` pairs. Each kernel runs as its CUDA
    version for a CUDA ``z`` and its plain version for a CPU one; Jacobi
    preconditioning passes ``invd = 1 / diag(M)`` (srps.py:543-548 of the
    JAX package). The routes, by ``cfg.cg_operator``:

    * ``"stencil"``: plain CG runs :func:`stencil_cg` with the energy
      tracked inside the CG, Jacobi in its scaled form at sf <= 2 and its
      in-sweep PCG form at sf = 4; ``cg_variant="cgs"`` runs :func:`cgs_cg`
      and evaluates the energy at its result (srps.py:615-617). The CGS
      recurrence has no Jacobi form: with ``cg_variant="cgs"`` Jacobi runs
      the preconditioned stencil CG and evaluates the energy at its result,
      where the JAX package runs its jnp PCG (srps.py:595-617).
    * ``"direct"``: :func:`direct_cg` with r0 built in the kernel and the
      energy tracked (srps.py:550-554, 574-586); Jacobi is its in-sweep PCG.
      ``cg_variant="cgs"`` without Jacobi runs :func:`cgs_cg`, as the JAX
      CGS branch comes before residency (srps.py:567-568).
    * ``"direct_host_r0"``: ``b = rhs - M z`` by torch ops, then
      :func:`direct_cg` given ``b`` (with Jacobi, its PCG), the energy
      evaluated at the result (srps.py:587-608), whatever the variant.

    Returns ``(z_new, energy, cg_iterations)`` as device tensors, the
    scalars one per lane."""
    if cfg.cg_variant not in ("pipe", "cgs"):
        raise ValueError(f"unknown cg_variant {cfg.cg_variant!r}")
    if cfg.cg_operator not in CG_OPERATORS:
        raise ValueError(f"unknown cg_operator {cfg.cg_operator!r}")
    lam = cfg.lam

    def each(fn, t):
        """``fn(op, prob, t)`` of the problem, or stacked over the lanes."""
        if lanes is None:
            return fn(op, prob, t)
        return torch.stack([fn(o, p, t[b]) for b, (o, p) in enumerate(lanes)])

    kw = dict(sf=sf, lam=lam, tol=cfg.cg_tol, max_iter=cfg.cg_max_iter,
              block=block)
    invd = None
    if cfg.jacobi_preconditioner:
        invd = 1.0 / each(lambda o, p, _: depth_diag(o, p, sf, lam), z)
    e_part = None
    if cfg.cg_operator == "direct_host_r0":
        b = each(lambda o, p, zb: depth_rhs(o, p, sf, lam)
                 - depth_matvec(zb, o, p, sf, lam), z)
        x, iters, _, _ = direct_cg(z, op, prob.gm, prob.ktw, prob.z0t,
                                   prob.z0u, invd=invd, b=b, **kw)
    elif cfg.cg_variant == "cgs" and invd is None:
        x, iters, _ = cgs_cg(z, op, prob.gm, prob.ktw, prob.z0t, **kw)
    elif cfg.cg_operator == "direct":
        x, iters, _, e_part = direct_cg(z, op, prob.gm, prob.ktw, prob.z0t,
                                        prob.z0u, invd=invd,
                                        with_energy=True, **kw)
    else:
        x, iters, _, e_part = stencil_cg(z, op, prob.gm, prob.ktw, prob.z0t,
                                         prob.z0u, invd=invd, **kw)
        if cfg.cg_variant == "cgs":
            e_part = None
    z_new = x * prob.mask
    if e_part is None:
        energy = each(lambda o, p, zb: depth_energy(zb, o, p, sf, lam), z_new)
    else:
        energy = e_part + lam * op.const
    return z_new, energy, iters


def estimate_depth(prob: SRPSProblem, mom: SMoments, rho, dz, z, sf: int,
                   cfg: SolverConfig, block=(256, 4)):
    """Warm-started CG depth solve and its energy (devicecalls.cu:636-786):
    the depth operator, then :func:`depth_cg`. Returns ``(z_new, energy,
    cg_iterations)`` as device tensors."""
    op = build_depth_operator(prob, mom, rho, dz, cfg.lam)
    return depth_cg(z, op, prob, sf, cfg, block)


# ---------------------------------------------------------------------------
# One outer iteration and the outer loop
# ---------------------------------------------------------------------------


def srps_iteration(state: SRPSState, prob: SRPSProblem, sf: int,
                   cfg: SolverConfig, block=(256, 4)) -> SRPSState:
    """Lighting -> albedo -> depth -> normals (SRPS.cu:276-335 body)."""
    s = estimate_lighting(prob, state.rho, state.N, state.s)
    mom = s_moments(prob, s)
    rho = estimate_albedo(prob, mom, state.N, state.rho)
    z, energy, cg_iters = estimate_depth(prob, mom, rho, state.dz, state.z,
                                         sf, cfg, block)
    N, dz = depth_normals(z, prob)
    return SRPSState(z=z, rho=rho, s=s, N=N, dz=dz, energy=energy,
                     last_energy=state.energy,
                     iteration=state.iteration + 1, cg_iters=cg_iters)


def should_stop(state: SRPSState, cfg: SolverConfig) -> torch.Tensor:
    """The reference's stopping rule with its NaN semantics
    (SRPS.cu:297-301): stop on an energy increase, a relative change below
    tolerance, or the iteration cap; NaN comparisons are false, so the
    first iteration never stops."""
    err, last = state.energy, state.last_energy
    rel = torch.abs(last - err) / torch.abs(err)
    return (err > last) | (rel < cfg.tolerance) | (
        state.iteration > cfg.max_iterations)


def solve_fused(state: SRPSState, prob: SRPSProblem, sf: int,
                cfg: SolverConfig, block=(256, 4), on_iteration=None):
    """The outer loop with one host read per iteration (the stop test).
    Returns the final state and the energy trace (NaN-padded, length
    ``max_iterations + 2``). ``on_iteration(state)`` sees every iterate."""
    trace = torch.full((cfg.max_iterations + 2,), math.nan,
                       dtype=torch.float32, device=prob.mask.device)
    st = state
    while st.iteration == 0 or not bool(should_stop(st, cfg)):
        st = srps_iteration(st, prob, sf, cfg, block)
        if st.iteration - 1 < trace.shape[0]:
            trace[st.iteration - 1] = st.energy
        if on_iteration is not None:
            on_iteration(st)
    return st, trace
