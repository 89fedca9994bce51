"""The row-sharded solve: the outer loop with its depth CG over a row mesh.

Port of the 1-D row-band half of ``srmeetsps_cuda_tpu/parallel/sharded.py``
(:128-250, :305-369; BASELINE.md configuration 5). The glue (lighting,
s-moments, albedo, depth operator, normals, the energy) runs on the whole
grid on the mesh's first device, as the single solve runs it; the JAX
package runs the same numbers under GSPMD. Only the depth CG is split into
row bands on the shard devices (``parallel/shard_cg.py``), and x is
gathered back. The JAX package's ``('data', 'x', 'y')`` GSPMD mesh
(``make_mesh``, ``shard_pytree``, ``solve_sharded``) has no counterpart.
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch

from ..config import SolverConfig
from ..models import srps
from .shard_cg import (RowMesh, cg_sharded, cg_sharded_cgs,
                       cg_sharded_jacobi, make_mesh_1d)


def estimate_depth_sharded(prob, mom, rho, dz, z, sf: int, cfg: SolverConfig,
                           mesh: RowMesh, block=(256, 4)):
    """The depth solve with the CG over the row shards of ``mesh``, r0 from
    the per-shard prologue (the JAX kernel route, sharded.py:153-207):
    ``--jacobi`` runs the in-sweep Jacobi PCG at every sf and whatever the
    variant, ``cg_variant="cgs"`` the Chronopoulos-Gear CG, otherwise the
    standard CG. The energy is evaluated at the result on every route.
    Returns ``(z_new, energy, cg_iterations)`` as device tensors."""
    lam = cfg.lam
    op = srps.build_depth_operator(prob, mom, rho, dz, lam)
    args = (op, prob.gm, prob.ktw, prob.z0t)
    kw = dict(sf=sf, lam=lam, tol=cfg.cg_tol, max_iter=cfg.cg_max_iter,
              block=block)
    if cfg.jacobi_preconditioner:
        invd = 1.0 / srps.depth_diag(op, prob, sf, lam)
        x, k, _ = cg_sharded_jacobi(mesh, z, invd, *args, **kw)
    elif cfg.cg_variant == "cgs":
        x, k, _ = cg_sharded_cgs(mesh, z, *args, **kw)
    else:
        x, k, _ = cg_sharded(mesh, z, *args, **kw)
    z_new = x * prob.mask
    return z_new, srps.depth_energy(z_new, op, prob, sf, lam), k


def srps_iteration_sharded(state, prob, sf: int, cfg: SolverConfig,
                           mesh: RowMesh, block=(256, 4)):
    """One outer iteration with the depth CG on the row mesh."""
    s = srps.estimate_lighting(prob, state.rho, state.N, state.s)
    mom = srps.s_moments(prob, s)
    rho = srps.estimate_albedo(prob, mom, state.N, state.rho)
    z, energy, cg_iters = estimate_depth_sharded(
        prob, mom, rho, state.dz, state.z, sf, cfg, mesh, block)
    N, dz = srps.depth_normals(z, prob)
    return srps.SRPSState(z=z, rho=rho, s=s, N=N, dz=dz, energy=energy,
                          last_energy=state.energy,
                          iteration=state.iteration + 1, cg_iters=cg_iters)


def solve_fused_sharded(state, prob, sf: int, cfg: SolverConfig,
                        mesh: RowMesh, block=(256, 4), on_iteration=None):
    """The outer loop of ``srps.solve_fused`` with the sharded depth CG: one
    host read per outer iteration (the stop test). Returns the final state
    and the energy trace (NaN-padded, length ``max_iterations + 2``)."""
    trace = torch.full((cfg.max_iterations + 2,), math.nan,
                       dtype=torch.float32, device=prob.mask.device)
    st = state
    while st.iteration == 0 or not bool(srps.should_stop(st, cfg)):
        st = srps_iteration_sharded(st, prob, sf, cfg, mesh, block)
        if st.iteration - 1 < trace.shape[0]:
            trace[st.iteration - 1] = st.energy
        if on_iteration is not None:
            on_iteration(st)
    return st, trace


def dryrun(n_shards: int, devices="cpu") -> list:
    """Solve a tiny seeded problem on ``n_shards`` row shards (on
    ``devices``, see ``make_mesh_1d``) with the standard CG, the CGS and
    Jacobi, and hold each to the unsharded solve of the same recurrence:
    equal outer iterations and energies within rtol 1e-3. The unsharded
    Jacobi PCG is the direct operator's (the stencil CG takes the scaled
    form at sf <= 2). Returns the per-variant traces."""
    from ..io.synthetic import lambertian_dataset
    from ..runtime.solver import prepare

    mesh = make_mesh_1d(n_shards, devices)
    sf = 2
    h = 8 * sf * n_shards
    data, _ = lambertian_dataset(h, 24, sf, n=4, c=3, seed=0)
    out = []
    for variant, jacobi in (("pipe", False), ("cgs", False), ("pipe", True)):
        cfg = SolverConfig(max_iterations=2, cg_max_iter=20,
                           cg_variant=variant, jacobi_preconditioner=jacobi,
                           inpaint_iters=8)
        prob, st = prepare(data, cfg, mesh.devices[0])
        final, trace = solve_fused_sharded(st, prob, sf, cfg, mesh)
        ref, ref_trace = srps.solve_fused(st, prob, sf, dataclasses.replace(
            cfg, cg_operator="direct" if jacobi else cfg.cg_operator))
        n_it = final.iteration
        got = trace[:n_it].cpu().numpy()
        want = ref_trace[:ref.iteration].cpu().numpy()
        if n_it != ref.iteration or not np.all(np.isfinite(got)):
            raise AssertionError(f"sharded {variant} jacobi={jacobi}: "
                                 f"{n_it} outer iterations {got}, unsharded "
                                 f"{ref.iteration} {want}")
        np.testing.assert_allclose(got, want, rtol=1e-3,
                                   err_msg=f"{variant} jacobi={jacobi}")
        out.append(got)
    return out
