"""Row-sharded depth CG on a single-process row mesh.

Port of ``srmeetsps_cuda_tpu/parallel/shard_cg.py`` and of the loop half of
``parallel/shard_pallas.py`` (:789-970). The JAX package runs one program
over ``jax.devices()`` through ``shard_map``; so does this module, over a
:class:`RowMesh`: a list of devices, one per row shard, repeats allowed (4
shards on one card, as the JAX suite runs 8 shards on virtual CPU devices).
One process drives every shard:

* the grid's h rows are cut into N bands of h / N rows, a multiple of sf, so
  that sf x sf tiles never cross a shard and a band's first row is even;
* :func:`exchange_halos` fills a halo plane's neighbour rows from the
  adjacent shards by device-to-device copies, zeros at the global top and
  bottom (the semantics of ``shard_cg._halo_rows``);
* :func:`all_reduce` gathers every shard's float64 sums into each shard, in
  shard order; each shard adds them in that order on its own device, so
  every shard holds the same scalars, as after ``psum``.

The three loops, :func:`cg_sharded`, :func:`cg_sharded_cgs` and
:func:`cg_sharded_jacobi`, keep the JAX recurrences, stopping rules and
guarded divisions; r0 = rhs - M x0 comes from the per-shard prologue (the
route of ``cg_sharded_pallas_*``). Each launches max_iter + 1 iterations
with the ``active`` flag on the device and reads nothing back to the host.
The per-shard steps are those of
:mod:`.shard_kernels`: the CUDA kernels of ``csrc/shard_cg.cu`` on a CUDA
shard, their plain versions on a CPU shard (``plain=True``: the plain
versions on every shard).

Halo exchanges: the fields F (and R0, x0, invd) once per solve; per
iteration one exchange of r (standard and Jacobi: sweep A recomputes p on
the halo rows) or one stacked exchange of (r, w, s) (CGS).
"""

from __future__ import annotations

from typing import NamedTuple, Sequence

import torch

from ..solve.cg import tol_squared
from ..solve.stencil_cg import F_ROWS
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


def scatter_rows(t: torch.Tensor, mesh: RowMesh, halo: bool):
    """The row bands of ``t`` (..., h, w), one per shard on its device, as
    halo planes (``halo=True``, neighbour rows exchanged) or as (..., h / N,
    w) copies."""
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


def _shards(mesh, x0, op, gm, ktw, z0t, *, sf, lam, tol, max_iter, cgs,
            invd, block):
    """The per-shard operands and state of one sharded solve."""
    h, w = x0.shape
    n = mesh.size
    hb = check_rows(h, n, sf)
    if w % sf:
        raise ValueError(f"width {w} is not a multiple of sf={sf}")
    if max_iter < 0:
        raise ValueError(f"max_iter must be >= 0, got {max_iter}")
    fields = {"P11": op.P11, "P12": op.P12, "P13": op.P13, "P22": op.P22,
              "P23": op.P23, "P33": op.P33, "fwd_x": gm[0], "bwd_x": gm[1],
              "fwd_y": gm[2], "bwd_y": gm[3], "ktw": ktw}
    F = scatter_rows(torch.stack([fields[k] for k in F_ROWS]), mesh, True)
    R0 = scatter_rows(torch.stack([op.QB1, op.QB2, op.QB3, z0t]), mesh, True)
    X0 = scatter_rows(x0, mesh, True)
    INVD = [None] * n if invd is None else scatter_rows(invd, mesh, True)
    return [sk.new_shard(n, device=dev, h=hb, w=w, sf=sf, lam=lam,
                         tol2=tol_squared(tol), max_iter=max_iter,
                         block=tuple(block), cgs=cgs, F=F[i], R0=R0[i],
                         x0=X0[i], invd=INVD[i])
            for i, dev in enumerate(mesh.devices)]


def _reduce(shards) -> None:
    all_reduce([s.own for s in shards], [s.gathered for s in shards])


def _finish(shards, x0):
    """The whole-grid x on x0's device and the scalars of shard 0 (every
    shard holds the same)."""
    x = gather_rows([s.x for s in shards], x0.device)
    iters, r1 = sk.result(shards[0])
    return x, iters.to(x0.device), r1.to(x0.device)


def _cg_std(mesh, x0, op, gm, ktw, z0t, *, sf, lam, tol, max_iter, invd,
            block, plain):
    ops = sk.PLAIN if plain else sk.KERNELS
    shards = _shards(mesh, x0, op, gm, ktw, z0t, sf=sf, lam=lam, tol=tol,
                     max_iter=max_iter, cgs=False, invd=invd, block=block)
    for s in shards:
        ops.prologue(s)
    exchange_halos([s.r for s in shards])
    _reduce(shards)
    for k in range(1, max_iter + 2):
        for s in shards:
            ops.step_a(s, k)
        _reduce(shards)
        for s in shards:
            ops.step_b(s, k)
        exchange_halos([s.r for s in shards])
        _reduce(shards)
    for s in shards:
        ops.finish(s)
    return _finish(shards, x0)


def cg_sharded(mesh: RowMesh, x0, op, gm, ktw, z0t, *, sf: int, lam: float,
               tol: float = 1e-9, max_iter: int = 100, block=(256, 4),
               plain: bool = False):
    """Warm-started reference-semantics CG over the row shards of ``mesh``
    (JAX ``shard_cg.cg_sharded`` / ``shard_pallas.cg_sharded_pallas_std``).
    Whole-grid (h, w) inputs on any device; ``op`` has P11..P33 and
    QB1..QB3, ``gm`` the 4 gradient masks. Returns ``(x, iterations,
    <r, r>)`` on x0's device."""
    return _cg_std(mesh, x0, op, gm, ktw, z0t, sf=sf, lam=lam, tol=tol,
                   max_iter=max_iter, invd=None, block=block, plain=plain)


def cg_sharded_jacobi(mesh: RowMesh, x0, invd, op, gm, ktw, z0t, *, sf: int,
                      lam: float, tol: float = 1e-9, max_iter: int = 100,
                      block=(256, 4), plain: bool = False):
    """Jacobi-preconditioned CG over the row shards (JAX
    ``shard_cg.cg_sharded_jacobi``, ``cg_sharded_pallas_std(invd=...)``):
    p = invd r + beta p, rz drives alpha and beta, <r, r> the stop test, at
    every sf. ``invd = 1 / diag(M)``, (h, w). Returns ``(x, iterations,
    <r, r>)``."""
    return _cg_std(mesh, x0, op, gm, ktw, z0t, sf=sf, lam=lam, tol=tol,
                   max_iter=max_iter, invd=invd, block=block, plain=plain)


def cg_sharded_cgs(mesh: RowMesh, x0, op, gm, ktw, z0t, *, sf: int,
                   lam: float, tol: float = 1e-9, max_iter: int = 100,
                   block=(256, 4), plain: bool = False):
    """Chronopoulos-Gear CG over the row shards (JAX
    ``shard_cg.cg_sharded_cgs``, ``cg_sharded_pallas_cgs``): one sweep,
    one stacked (r, w, s) halo exchange and one gathered (gamma, delta) per
    iteration. Returns ``(x, iterations, gamma)``."""
    ops = sk.PLAIN if plain else sk.KERNELS
    shards = _shards(mesh, x0, op, gm, ktw, z0t, sf=sf, lam=lam, tol=tol,
                     max_iter=max_iter, cgs=True, invd=None, block=block)
    for s in shards:
        ops.prologue(s)
    exchange_halos([s.rws[0] for s in shards])
    for s in shards:
        ops.cgs_w0(s)
    exchange_halos([s.rws[:3] for s in shards])
    _reduce(shards)
    for k in range(1, max_iter + 2):
        for s in shards:
            ops.cgs_step(s, k)
        dst = 3 * (k % 2)
        exchange_halos([s.rws[dst:dst + 3] for s in shards])
        _reduce(shards)
    for s in shards:
        ops.finish(s)
    return _finish(shards, x0)
