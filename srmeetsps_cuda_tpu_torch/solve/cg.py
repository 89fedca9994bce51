"""Matrix-free conjugate gradient on tensors, with no host reads.

Port of ``srmeetsps_cuda_tpu/solve/cg.py`` (reference devicecalls.cu:229-279).
The loop runs ``max_iter + 1`` times in Python and keeps every scalar on the
device: an ``active`` flag freezes the iterate once the reference's test
``r1 > tol^2 and k <= max_iter`` fails, so the host never waits on a dot
product. Semantics match the reference:

  - warm start: the caller passes the residualised rhs ``b - M x0`` and the
    current iterate ``x0``;
  - beta = 0 at k = 1, and the r0 = 0 and <p, Mp> = 0 divisions are guarded;
  - ``k <= max_iter`` with post-increment admits one extra iteration, so a
    cap of 100 runs 101 iterations.

No solve path of the port runs it (the depth CG, Jacobi included, is
``stencil_cg``); it is the generic reference the tests hold that CG to, as
the JAX package's jnp PCG is.
"""

from __future__ import annotations

from typing import Callable, NamedTuple, Optional

import numpy as np
import torch


class CGResult(NamedTuple):
    x: torch.Tensor
    iterations: torch.Tensor  # int32 scalar: iterations executed
    residual_sq: torch.Tensor  # final squared residual norm


def _dot(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return torch.sum(a * b)


def tol_squared(tol: float) -> float:
    """The stop threshold as the reference forms it: ``tol * tol`` in f32."""
    t = np.float32(tol)
    return float(t * t)


def conjugate_gradient(matvec: Callable, b_residual: torch.Tensor,
                       x0: torch.Tensor, *, tol: float = 1e-9,
                       max_iter: int = 100,
                       precond: Optional[Callable] = None) -> CGResult:
    """Solve ``M (x - x0) = b_residual`` and return ``x``.

    ``precond`` is an optional closure ``z = P^{-1} r``; the stop test then
    stays on ``<r, r>`` while the recurrence uses ``<r, z>``."""
    tol_sq = tol_squared(tol)
    x = x0
    r = b_residual
    z = r if precond is None else precond(r)
    p = torch.zeros_like(z)
    rz0 = torch.zeros((), dtype=torch.float32, device=r.device)
    rz1 = _dot(r, z)
    rr = rz1 if precond is None else _dot(r, r)
    active = torch.ones((), dtype=torch.bool, device=r.device)
    iters = torch.zeros((), dtype=torch.int32, device=r.device)
    for k in range(1, max_iter + 2):
        active = active & (rr > tol_sq)
        iters = iters + active.to(torch.int32)
        if k == 1:
            beta = torch.zeros_like(rz1)
        else:
            beta = rz1 / torch.where(rz0 == 0, torch.ones_like(rz0), rz0)
        p_new = z + beta * p
        w = matvec(p_new)
        pw = _dot(p_new, w)
        alpha = rz1 / torch.where(pw == 0, torch.ones_like(pw), pw)
        x = torch.where(active, x + alpha * p_new, x)
        r_new = r - alpha * w
        z_new = r_new if precond is None else precond(r_new)
        rz_next = _dot(r_new, z_new)
        rr_next = rz_next if precond is None else _dot(r_new, r_new)
        r = torch.where(active, r_new, r)
        z = torch.where(active, z_new, z)
        p = torch.where(active, p_new, p)
        rz0 = torch.where(active, rz1, rz0)
        rz1 = torch.where(active, rz_next, rz1)
        rr = torch.where(active, rr_next, rr)
    return CGResult(x, iters, rr)
