"""Row-sharded depth CG on a single-process row mesh.

Port of ``srmeetsps_cuda_tpu/parallel/shard_cg.py`` and of the loop half of
``parallel/shard_pallas.py`` (:789-970). The JAX package runs one program
over ``jax.devices()`` through ``shard_map``; so does this module, over a
:class:`RowMesh`: a list of devices, one per row shard, repeats allowed (4
shards on one card, as the JAX suite runs 8 shards on virtual CPU devices).
One process drives every shard. The grid's h rows are cut into N bands of
h / N rows, a multiple of sf, so that sf x sf tiles never cross a shard and
a band's first row is even. The three solves, :func:`cg_sharded`,
:func:`cg_sharded_cgs` and :func:`cg_sharded_jacobi`, keep the JAX
recurrences, stopping rules and guarded divisions; r0 = rhs - M x0 comes
from the per-shard prologue (the route of ``cg_sharded_pallas_*``). Each
runs max_iter + 1 iterations with the ``active`` flag on the device and
reads nothing back to the host, by one of three routes
(:func:`choose_route`):

* "persistent", every shard on one CUDA device: :func:`persistent`, one
  cooperative launch of ``csrc/shard_cg.cu`` for the whole solve over
  every shard. The shards' planes are (N, ...) stacks; the tile that
  writes a shard's edge row writes it into the adjacent shard's halo row
  too, and every CTA adds the shards' sums in shard order after each grid
  barrier;
* "steps", shards on distinct devices (or ``route="steps"``): the host
  loops below drive the per-step kernels of :mod:`.shard_kernels`,
  :func:`exchange_halos` fills a halo plane's neighbour rows from the
  adjacent shards by device-to-device copies, zeros at the global top and
  bottom (the semantics of ``shard_cg._halo_rows``), and :func:`all_reduce`
  gathers every shard's float64 sums into each shard, in shard order; each
  shard adds them in that order on its own device, so every shard holds
  the same scalars, as after ``psum``;
* "plain", every shard on the CPU (or ``plain=True``): the same loops with
  the plain per-shard steps.

Halo rows: the fields F (and R0, x0, invd) once per solve; per iteration r
(standard and Jacobi: p's halo rows are recomputed from r's) or the (r, w,
s) set a CGS sweep writes.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple, Optional, Sequence

import torch

from .. import trace as tracing
from ..solve.cg import tol_squared
from ..solve.stencil_cg import (F_ROWS, INFO_KEYS, launch_error, launch_info,
                                tile_plan)
from . import shard_kernels as sk


class RowMesh(NamedTuple):
    """Shard i of a row-sharded solve lives on ``devices[i]``."""

    devices: tuple

    @property
    def size(self) -> int:
        return len(self.devices)


def make_mesh_1d(n: int, devices) -> RowMesh:
    """A row mesh of ``n`` shards: shard i on ``devices[i]``, or every shard
    on ``devices`` when it is one device. Repeats are allowed."""
    if isinstance(devices, (str, torch.device)):
        devices = [devices] * n
    devices = tuple(torch.device(d) for d in devices)
    if n < 1 or len(devices) != n:
        raise ValueError(f"a mesh of {n} shards needs {n} devices, got "
                         f"{len(devices)}")
    return RowMesh(devices)


def check_rows(h: int, n: int, sf: int) -> int:
    """The band height h / n; raises unless it is a whole multiple of sf."""
    if h % n or (h // n) % sf:
        raise ValueError(f"{h} rows do not split into {n} row shards of a "
                         f"multiple of sf={sf} rows")
    return h // n


def exchange_halos(planes: Sequence[torch.Tensor], k: int = 1) -> None:
    """Fill the k halo rows at each end of every shard's ``(..., hb + 2k,
    w)`` planes with the adjacent shards' k edge rows, in place; the rows
    at the global top and bottom are left as they are (zeros)."""
    n = len(planes)
    for i in range(n):
        if i > 0:
            planes[i][..., :k, :].copy_(planes[i - 1][..., -2 * k:-k, :])
        if i < n - 1:
            planes[i][..., -k:, :].copy_(planes[i + 1][..., k:2 * k, :])


def all_reduce(owns: Sequence[torch.Tensor],
               gathered: Sequence[torch.Tensor]) -> None:
    """Every shard's (K,) sums ``owns[i]`` into row i of each shard's
    ``gathered`` (N, K), in place: through the first shard's copy."""
    root = gathered[0]
    for i, own in enumerate(owns):
        root[i].copy_(own)
    for g in gathered[1:]:
        g.copy_(root)


def stack_rows(t: torch.Tensor, n: int, device) -> torch.Tensor:
    """The n row bands of ``t`` (..., h, w) as halo planes stacked on
    ``device``, (n, ..., h / n + 2, w): each band's neighbour rows filled
    from the adjacent bands, zeros at the global top and bottom."""
    *lead, h, w = t.shape
    hb = h // n
    e = torch.zeros((n, *lead, hb + 2, w), dtype=torch.float32,
                    device=device)
    e[..., 1:-1, :].copy_(t.reshape(*lead, n, hb, w).movedim(-3, 0))
    exchange_halos(e.unbind(0))
    return e


def scatter_rows(t: torch.Tensor, mesh: RowMesh, halo: bool):
    """The row bands of ``t`` (..., h, w), one per shard on its device, as
    halo planes (``halo=True``, neighbour rows exchanged) or as (..., h /
    N, w) copies."""
    n = mesh.size
    hb = t.shape[-2] // n
    pad = 1 if halo else 0
    out = []
    for i, dev in enumerate(mesh.devices):
        band = t[..., i * hb:(i + 1) * hb, :]
        e = torch.zeros(band.shape[:-2] + (hb + 2 * pad, band.shape[-1]),
                        dtype=torch.float32, device=dev)
        e[..., pad:pad + hb, :].copy_(band)
        out.append(e)
    if halo:
        exchange_halos(out)
    return out


def gather_rows(bands: Sequence[torch.Tensor], device) -> torch.Tensor:
    """The bands stacked back into the whole grid on ``device``."""
    return torch.cat([b.to(device) for b in bands], dim=-2)


def choose_route(devices, plain: bool = False, route=None) -> str:
    """The route of a sharded solve over shards on ``devices`` (see the
    module): "plain" with ``plain``; "steps" with ``route="steps"`` (on a
    CPU shard its steps take their plain versions); else "plain" where
    every shard is on the CPU, "persistent" where every shard is on one
    CUDA device, and "steps" otherwise. A route never falls back to
    another: a refused launch or a failed build raises."""
    if route not in (None, "steps"):
        raise ValueError(f"route must be None or 'steps', got {route!r}")
    devices = [torch.device(d) for d in devices]
    if plain:
        return "plain"
    if route == "steps":
        return "steps"
    if all(d.type == "cpu" for d in devices):
        return "plain"
    if len(set(devices)) == 1 and devices[0].type == "cuda":
        return "persistent"
    return "steps"


def groups(mesh: RowMesh) -> list:
    """``(device, first shard, shard count)`` of each run of consecutive
    shards on one device, in shard order: one group on a one-device mesh,
    one per shard on distinct devices."""
    out = []
    for i, dev in enumerate(mesh.devices):
        if out and out[-1][0] == dev:
            out[-1][2] += 1
        else:
            out.append([dev, i, 1])
    return [tuple(g) for g in out]


def _band_shards(mesh, *, F, R0, x0, invd, h, w, sf, lam, tol, max_iter,
                 cgs, block):
    """The :class:`shard_kernels.Shard` of each shard of ``mesh`` over the
    halo stacks ``F`` (n_g, 11, hb + 2, w), ``R0`` (n_g, 4, ...), ``x0``
    and ``invd`` (n_g, hb + 2, w; or None) of each group of
    :func:`groups`, their halo rows filled: on a one-device mesh the
    stacks themselves, with no copy, else views of each shard's planes."""
    if max_iter < 0:
        raise ValueError(f"max_iter must be >= 0, got {max_iter}")
    ops = dict(F=F, R0=R0, x0=x0, invd=invd)
    if len(F) == 1:
        ops = {k: None if v is None else v[0] for k, v in ops.items()}
    else:
        ops = {k: None if v is None else [s for t in v for s in t.unbind(0)]
               for k, v in ops.items()}
    return sk.new_shards(mesh.devices, h=h, w=w, sf=sf, lam=lam,
                         tol2=tol_squared(tol), max_iter=max_iter,
                         block=tuple(block), cgs=cgs, **ops)


def _shards(mesh, x0, op, gm, ktw, z0t, *, sf, lam, tol, max_iter, cgs,
            invd, block):
    """The per-shard operands and state of one sharded solve from
    whole-grid (h, w) operands, banded here: on a one-device mesh views
    into (N, ...) stacks (``Shard.stack``)."""
    h, w = x0.shape
    n = mesh.size
    hb = check_rows(h, n, sf)
    if w % sf:
        raise ValueError(f"width {w} is not a multiple of sf={sf}")
    fields = {"P11": op.P11, "P12": op.P12, "P13": op.P13, "P22": op.P22,
              "P23": op.P23, "P33": op.P33, "fwd_x": gm[0], "bwd_x": gm[1],
              "fwd_y": gm[2], "bwd_y": gm[3], "ktw": ktw}
    planes = dict(F=torch.stack([fields[k] for k in F_ROWS]),
                  R0=torch.stack([op.QB1, op.QB2, op.QB3, z0t]), x0=x0,
                  invd=invd)
    if len(set(mesh.devices)) == 1:
        split = lambda t: [stack_rows(t, n, mesh.devices[0])]  # noqa: E731
    else:
        split = lambda t: [b[None] for b in scatter_rows(  # noqa: E731
            t, mesh, True)]
    ops = {k: None if t is None else split(t) for k, t in planes.items()}
    return _band_shards(mesh, h=hb, w=w, sf=sf, lam=lam, tol=tol,
                        max_iter=max_iter, cgs=cgs, block=block, **ops)


def _reduce(shards) -> None:
    all_reduce([s.own for s in shards], [s.gathered for s in shards])


def _finish(shards, x0):
    """The whole-grid x on x0's device and the scalars of shard 0 (every
    shard holds the same)."""
    x = gather_rows([s.x for s in shards], x0.device)
    iters, r1 = sk.result(shards[0])
    return x, iters.to(x0.device), r1.to(x0.device)


def _steps(shards, ops) -> None:
    """One solve by the host loop over the per-shard steps ``ops``
    (``shard_kernels.KERNELS`` or ``PLAIN``): halo rows exchanged and sums
    gathered between the steps."""
    cgs = shards[0].cgs
    for s in shards:
        ops.prologue(s)
    if cgs:
        exchange_halos([s.rws[0] for s in shards])
        for s in shards:
            ops.cgs_w0(s)
        exchange_halos([s.rws[:3] for s in shards])
    else:
        exchange_halos([s.r for s in shards])
    _reduce(shards)
    for k in range(1, shards[0].max_iter + 2):
        if cgs:
            for s in shards:
                ops.cgs_step(s, k)
            dst = 3 * (k % 2)
            exchange_halos([s.rws[dst:dst + 3] for s in shards])
        else:
            for s in shards:
                ops.step_a(s, k)
            _reduce(shards)
            for s in shards:
                ops.step_b(s, k)
            exchange_halos([s.r for s in shards])
        _reduce(shards)
    for s in shards:
        ops.finish(s)


def persistent(shards) -> Optional[dict]:
    """Kernels 10-14 as one cooperative launch: the whole CG solve over
    every shard of a one-device mesh (``Shard.stack``), by
    ``csrc/shard_cg.cu``'s ``shard_std_kernel`` (standard CG, or the
    in-sweep Jacobi PCG where the shards hold invd) or ``shard_cgs_kernel``
    (CGS), on the device's current stream. Shards on the CPU take the
    plain version (the host loop over the plain steps). Returns what the C
    entry reported of the launch (``launch_info``; None for the plain
    version); a refused launch raises. Counts ``"shard_cg persistent"``
    (and ``... jacobi``, ``... cgs``) in the launch registry."""
    s = shards[0]
    if all(t.device.type == "cpu" for t in shards):
        _steps(shards, sk.PLAIN)
        return None
    if s.stack is None or s.device.type != "cuda":
        raise ValueError(f"the persistent shard kernels run the shards of "
                         f"one CUDA device, not {[t.device for t in shards]}")
    st, n = s.stack, len(shards)
    plan = tile_plan(s.h, s.w, s.block)
    jac = s.invd is not None
    part = torch.empty((4 if s.cgs else 3) * n * plan.tiles,
                       dtype=torch.float32, device=s.device)
    info = (ctypes.c_int * len(INFO_KEYS))()
    lib = sk._library()
    common = (n, s.h, s.w, s.sf, float(s.lam), float(s.tol2),
              int(s.max_iter), *s.block)
    with torch.cuda.device(s.device):
        stream = torch.cuda.current_stream(s.device).cuda_stream
        if s.cgs:
            err = lib.srps_shard_cgs(
                st.F.data_ptr(), st.R0.data_ptr(), st.x0.data_ptr(),
                st.x.data_ptr(), st.pc.data_ptr(), st.rws.data_ptr(),
                st.C.data_ptr(), part.data_ptr(), st.scal.data_ptr(),
                *common, info, stream)
        else:
            err = lib.srps_shard_std(
                st.F.data_ptr(), st.R0.data_ptr(), st.x0.data_ptr(),
                st.invd.data_ptr() if jac else None, st.x.data_ptr(),
                st.r.data_ptr(), st.p.data_ptr(), st.wv.data_ptr(),
                st.C.data_ptr(), part.data_ptr(), st.scal.data_ptr(),
                *common, int(jac), info, stream)
    if err != 0:
        raise launch_error("row-shard CG", err)
    out = launch_info(info, plan, 1 if s.cgs else 2)
    persistent.last_launch = out
    tracing.launched("shard_cg persistent")
    tracing.launched("shard_cg persistent jacobi", int(jac))
    tracing.launched("shard_cg persistent cgs", int(s.cgs))
    return out


persistent.last_launch = None


def _run(mesh, shards, plain, route) -> None:
    """One sharded solve over ``shards`` by the route :func:`choose_route`
    picks."""
    how = choose_route(mesh.devices, plain, route)
    if how == "persistent":
        persistent(shards)
    else:
        _steps(shards, sk.PLAIN if how == "plain" else sk.KERNELS)


def _solve(mesh, x0, op, gm, ktw, z0t, *, cgs, invd, plain, route, **kw):
    shards = _shards(mesh, x0, op, gm, ktw, z0t, cgs=cgs, invd=invd, **kw)
    _run(mesh, shards, plain, route)
    return _finish(shards, x0)


def cg_bands(mesh: RowMesh, F, R0, x0, invd=None, *, sf: int, lam: float,
             tol: float = 1e-9, max_iter: int = 100, block=(256, 4),
             cgs: bool = False):
    """The sharded CG on band-resident operands (the row-sharded outer
    iteration's, ``parallel/sharded.py``): per group of :func:`groups`, the
    halo stacks ``F`` (n_g, 11, hb + 2, w) in ``F_ROWS`` order, ``R0``
    (n_g, 4, hb + 2, w): QB1, QB2, QB3, z0t, ``x0`` and, for the Jacobi
    PCG, ``invd`` (n_g, hb + 2, w), their halo rows filled. On a one-device
    mesh the kernel reads the stacks in place. ``cgs`` runs the
    Chronopoulos-Gear CG (no Jacobi form); the route is the mesh's
    (:func:`choose_route`). Returns ``(x, iterations, r1)``: x per group
    (n_g, hb, w), the scalars on the first shard's device."""
    hb, w = x0[0].shape[-2] - 2, x0[0].shape[-1]
    shards = _band_shards(mesh, F=F, R0=R0, x0=x0, invd=invd, h=hb, w=w,
                          sf=sf, lam=lam, tol=tol, max_iter=max_iter,
                          cgs=cgs, block=block)
    _run(mesh, shards, False, None)
    if shards[0].stack is not None:
        xs = [shards[0].stack.x]
    else:
        xs = [torch.stack([s.x for s in shards[first:first + count]])
              for _, first, count in groups(mesh)]
    iters, r1 = sk.result(shards[0])
    return xs, iters, r1


def cg_sharded(mesh: RowMesh, x0, op, gm, ktw, z0t, *, sf: int, lam: float,
               tol: float = 1e-9, max_iter: int = 100, block=(256, 4),
               plain: bool = False, route=None):
    """Warm-started reference-semantics CG over the row shards of ``mesh``
    (JAX ``shard_cg.cg_sharded`` / ``shard_pallas.cg_sharded_pallas_std``).
    Whole-grid (h, w) inputs on any device; ``op`` has P11..P33 and
    QB1..QB3, ``gm`` the 4 gradient masks. ``plain`` and ``route`` as
    :func:`choose_route`. Returns ``(x, iterations, <r, r>)`` on x0's
    device."""
    return _solve(mesh, x0, op, gm, ktw, z0t, sf=sf, lam=lam, tol=tol,
                  max_iter=max_iter, block=block, cgs=False, invd=None,
                  plain=plain, route=route)


def cg_sharded_jacobi(mesh: RowMesh, x0, invd, op, gm, ktw, z0t, *, sf: int,
                      lam: float, tol: float = 1e-9, max_iter: int = 100,
                      block=(256, 4), plain: bool = False, route=None):
    """Jacobi-preconditioned CG over the row shards (JAX
    ``shard_cg.cg_sharded_jacobi``, ``cg_sharded_pallas_std(invd=...)``):
    p = invd r + beta p, rz drives alpha and beta, <r, r> the stop test, at
    every sf. ``invd = 1 / diag(M)``, (h, w). Returns ``(x, iterations,
    <r, r>)``."""
    return _solve(mesh, x0, op, gm, ktw, z0t, sf=sf, lam=lam, tol=tol,
                  max_iter=max_iter, block=block, cgs=False, invd=invd,
                  plain=plain, route=route)


def cg_sharded_cgs(mesh: RowMesh, x0, op, gm, ktw, z0t, *, sf: int,
                   lam: float, tol: float = 1e-9, max_iter: int = 100,
                   block=(256, 4), plain: bool = False, route=None):
    """Chronopoulos-Gear CG over the row shards (JAX
    ``shard_cg.cg_sharded_cgs``, ``cg_sharded_pallas_cgs``): one sweep,
    one (r, w, s) halo exchange and one shard-order (gamma, delta) sum per
    iteration. Returns ``(x, iterations, gamma)``."""
    return _solve(mesh, x0, op, gm, ktw, z0t, sf=sf, lam=lam, tol=tol,
                  max_iter=max_iter, block=block, cgs=True, invd=None,
                  plain=plain, route=route)
