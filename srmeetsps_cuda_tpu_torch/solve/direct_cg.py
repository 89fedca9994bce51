"""Depth CG through the direct mask-gated matvec.

Port of the TPU kernels of the direct family, one computation that the JAX
package places six ways in TPU memory:

* ``solve/pallas_cg_vmem.py::_kernel_vmem`` (961, modes "full" and
  "full_packed") and ``_kernel_vmem_hybrid`` (1148), through
  ``cg_pallas_vmem_fromop[_batched]``: r0 built in the kernel, the energy
  tracked, plain or in-sweep Jacobi;
* ``solve/pallas_cg_pipe.py::_kernel`` (80), through
  ``cg_pallas_pipelined[_fromop][_batched]`` (464-631): r0 built in the
  kernel (with in-sweep Jacobi) or the residual given, no energy;
* ``solve/pallas_cg_fused.py::_kernel`` (50), through ``cg_pallas_fused``
  (218), and ``solve/pallas_cg.py::_cg_kernel_a``/``_cg_kernel_b`` (163,
  237), through ``cg_pallas`` (450): the residual given.

Two versions of one function live here:

* :func:`direct_cg_plain` — plain PyTorch, on ``(h, w)`` planes or ``(B,
  h, w)`` lanes. The CPU path and the tests use it; on a CUDA device it is
  the reference the kernel is held against.
* :func:`direct_cg` — the wrapper of the hand-written CUDA kernels in
  ``csrc/direct_cg.cu``, all lanes in one launch. A CPU tensor takes the
  plain version; a CUDA tensor launches the kernels or raises.
  ``direct_cg.launches`` counts the kernel runs, ``.jacobi_launches`` those
  with ``invd`` and ``.host_r0_launches`` those given their residual.

Both apply ``M = KT^T KT + lam A^T A`` as the TPU kernels do
(``_matvec_band``, pallas_cg_vmem.py:185), through the gradient masks and
the P fields (:func:`direct_matvec`), where ``stencil_cg`` applies its
9-plane collapse: the same operator, rounded differently in f32. From the
warm start ``x0``:

* ``b`` not given: ``r0 = rhs - M x0`` (``rhs = KT^T z0s + lam A^T B``),
  and with ``with_energy`` the energy at ``x0`` in residual form, then
  ``E -= alpha * r1`` per iteration (the caller adds ``lam * sum B^2``);
* ``b`` given: ``r0 = b``, no energy;
* ``invd`` given: the in-sweep Jacobi PCG, ``p = invd r + beta p``; ``rz``
  drives alpha, beta and the energy, ``<r, r>`` the stop test and the
  reported residual (pallas_cg_pipe.py:455-461). The direct family has no
  scaled form;
* the reference's CG otherwise (:func:`stencil_cg.cg_loop`).

The kernel is bound by memory bandwidth: about 21 f32 planes move per
iteration and lane (F's 11, then the CG state; 103 MB at 960 x 1280), 23
under Jacobi, against about 50 flops per pixel.
"""

from __future__ import annotations

import ctypes

import torch

from ..ops import gradients as gradops
from ..ops.grid import tilesum
from .cg import tol_squared
from .stencil_cg import (N_SCAL, PART_ROWS, S_E, S_ITERS, S_RR, cg_loop,
                         check_tensor, depth_rhs_fields, one_lane,
                         pack_lanes, warm_start_energy)


def direct_matvec(p, op, gm, ktw, lam: float, sf: int) -> torch.Tensor:
    """``M p = ktw * tilesum(p) + lam (Dx^T t1 + Dy^T t2 - t3)`` with
    ``t1..t3`` the P-field combinations of ``g = Dx p``, ``h = Dy p`` and
    ``p`` (``_matvec_band``)."""
    g = gradops.grad_x(p, gm)
    h = gradops.grad_y(p, gm)
    t1 = op.P11 * g + op.P12 * h - op.P13 * p
    t2 = op.P12 * g + op.P22 * h - op.P23 * p
    t3 = op.P13 * g + op.P23 * h - op.P33 * p
    ata = gradops.grad_x_t(t1, gm) + gradops.grad_y_t(t2, gm) - t3
    return ktw * tilesum(p, sf) + lam * ata


def direct_cg_plain(x0, op, gm, ktw, z0t, z0u, *, sf: int, lam: float,
                    tol: float = 1e-9, max_iter: int = 100, invd=None,
                    b=None, with_energy: bool = False):
    """Plain PyTorch version of the kernel, on ``(h, w)`` planes or ``(B,
    h, w)`` lanes. Returns ``(x, iters, rr, e_part)`` as device tensors, the
    scalars one per lane, ``e_part`` None without ``with_energy``."""
    if b is not None and with_energy:
        raise ValueError("a given residual has no tracked energy")
    if b is None:
        r = depth_rhs_fields(op, gm, z0t, lam) - direct_matvec(x0, op, gm,
                                                               ktw, lam, sf)
    else:
        r = b
    e = warm_start_energy(x0, op, gm, z0u, lam, sf) if with_energy else None
    x, iters, rr, _, e = cg_loop(
        x0, r, lambda v: direct_matvec(v, op, gm, ktw, lam, sf), tol=tol,
        max_iter=max_iter, invd=invd, e=e)
    return x, iters, rr, e


def _library():
    """The built kernel library with its C signature declared."""
    from .. import native

    lib = native.load("direct_cg")
    vp, ci, cf = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    lib.srps_direct_cg.argtypes = [vp] * 13 + [ci, ci, ci, ci, cf, cf, ci, ci,
                                               ci, ci, vp]
    lib.srps_direct_cg.restype = ci
    return lib


def direct_cg(x0, op, gm, ktw, z0t, z0u, *, sf: int, lam: float,
              tol: float = 1e-9, max_iter: int = 100, block=(256, 4),
              invd=None, b=None, with_energy: bool = False):
    """The direct-matvec depth CG: the CUDA kernels for a CUDA ``x0``, the
    plain version for a CPU one. ``x0`` is (h, w) for one problem or (B,
    h, w) for B lanes in one launch; every other input carries the same
    leading axes (``z0u`` is (..., 2, h, w) and is read only with
    ``with_energy``). ``block`` is the (x, y) thread-block shape. Returns
    ``(x, iters, rr, e_part)`` like ``cg_pallas_vmem_fromop[_batched](...,
    with_energy=True)``, ``e_part`` None without ``with_energy``. Each
    lane's result is bit for bit that of its own B = 1 launch."""
    if b is not None and with_energy:
        raise ValueError("a given residual has no tracked energy")
    if x0.device.type == "cpu":
        return direct_cg_plain(x0, op, gm, ktw, z0t, z0u, sf=sf, lam=lam,
                               tol=tol, max_iter=max_iter, invd=invd, b=b,
                               with_energy=with_energy)
    if x0.dim() == 2:
        one = lambda t: None if t is None else t.unsqueeze(0)  # noqa: E731
        out = direct_cg(*one_lane(x0, op, gm, ktw, z0t), one(z0u), sf=sf,
                        lam=lam, tol=tol, max_iter=max_iter, block=block,
                        invd=one(invd), b=one(b), with_energy=with_energy)
        return tuple(None if t is None else t[0] for t in out)
    F, R0, (bx, by), nb = pack_lanes("direct_cg", x0, op, gm, ktw, z0t,
                                     sf=sf, max_iter=max_iter, block=block,
                                     invd=invd, r0=b is None)
    B, h, w = x0.shape
    dev = x0.device
    if with_energy:
        check_tensor("z0u", z0u, (B, 2, h, w), dev)
    if b is not None:
        check_tensor("b", b, (B, h, w), dev)
    x, r, p0, p1, wv = (torch.empty_like(x0) for _ in range(5))
    part = torch.empty(B * PART_ROWS * nb, dtype=torch.float32, device=dev)
    scal = torch.empty((B, N_SCAL), dtype=torch.float32, device=dev)
    ptr = lambda t: None if t is None else t.data_ptr()  # noqa: E731
    stream = torch.cuda.current_stream(dev).cuda_stream
    err = _library().srps_direct_cg(
        F.data_ptr(), ptr(R0), ptr(z0u if with_energy else None),
        x0.data_ptr(), ptr(b), ptr(invd), x.data_ptr(), r.data_ptr(),
        p0.data_ptr(), p1.data_ptr(), wv.data_ptr(), part.data_ptr(),
        scal.data_ptr(), B, h, w, sf, float(lam), tol_squared(tol),
        int(max_iter), bx, by, int(with_energy), stream)
    if err != 0:
        raise RuntimeError(f"direct CG kernel launch failed: CUDA error {err}")
    direct_cg.launches += 1
    if invd is not None:
        direct_cg.jacobi_launches += 1
    if b is not None:
        direct_cg.host_r0_launches += 1
    return (x, scal[:, S_ITERS].to(torch.int32), scal[:, S_RR],
            scal[:, S_E] if with_energy else None)


direct_cg.launches = 0
direct_cg.jacobi_launches = 0
direct_cg.host_r0_launches = 0
