"""The sharded solve: the outer iteration on row bands, and the ``('data',
'x', 'y')`` mesh.

Port of ``srmeetsps_cuda_tpu/parallel/sharded.py`` (BASELINE.md
configuration 5). One process drives every shard of a :class:`RowMesh` (a
device per shard, repeats allowed).

**Row bands** (JAX ``shard_pytree_rows``, :135-150, and the GSPMD run of
``srps_iteration_sharded`` on them): :func:`shard_problem_rows` and
:func:`shard_state_rows` place a problem and a state as :class:`Bands`.
The N shards of the mesh fall into groups, the runs of consecutive shards
on one device (``shard_cg.groups``: one group on a one-device mesh, one
per shard on distinct devices), and a group holds each field of its n_g
shards as one tensor:

* every (..., h, w) field as its n_g row bands of hb = h / N owned rows,
  each with one halo row at each end (the neighbour's edge row, zeros at
  the global top and bottom), shaped (..., n_g, hb + 2, w): the band axis
  just before the rows, so that ``models/srps.py``'s functions, which
  index a field's components from the front, take a group of bands as
  they take a grid. The gradient masks and ktw are planes of the group's
  halo stack F (n_g, 11, hb + 2, w, ``F_ROWS`` order) and z0t a plane of R0
  (n_g, 4, hb + 2, w); each outer iteration writes the depth operator's
  P11..P33 and QB1..QB3 into the other planes, and the depth CG reads the
  stacks in place (``shard_cg.cg_bands``: on a one-device mesh the
  persistent kernel, with no copy);
* the LR fields ``masks`` and ``z0s`` as (n_g, hb / sf, w / sf), owned rows
  only;
* the image stack I (c, n, h w) as the group's own pixels, (c, n, n_g hb
  w): no stencil reads it, so it has no halo;
* s, the energies and ``cg_iters`` replicated, a copy on each group's
  device; ``fx``, ``fy`` and ``iteration`` stay host scalars.

:func:`srps_iteration_sharded` runs every phase on the bands: each phase
computes its fields on the owned rows, and the halo rows are refreshed
(``exchange_bands``: copies of the edge rows between adjacent bands) only
where a stencil reads them: the operator's planes in F and R0 (the CG's
fields, and ``depth_diag``'s P11 and P22 at i +- 1), invd (the Jacobi
PCG's p on its halo rows) and z (the next CG's x0, the normals and the
energy at i +- 1). rho, N and dz are read on their owned rows alone: their
halo rows are not kept current. Every reduction counts owned rows once,
as per-band partials added in shard order on the first shard's device,
the result copied to every group: the lighting's normal equations, the
operator's constant and the energy; the CG adds its sums in shard order
too. A repeated banded solve is bit-equal.

**The mesh** (JAX ``make_mesh``, ``shard_pytree``, ``step_sharded``,
``solve_sharded``, :40-118): :func:`make_mesh` builds a ``('data', 'x',
'y')`` :class:`Mesh`; :func:`shard_pytree` places lane b of a batched tree
on data group b. The JAX package lets GSPMD cut a lane's grid into x row
blocks and y column blocks; the port's hand-written shard kernels exchange
rows, so a lane's x y spatial devices hold it in x y row bands (a single
device, x y = 1, holds the whole lane). The numbers are the unsharded
solve's up to sum order in both packages.
"""

from __future__ import annotations

import dataclasses
import math
from typing import NamedTuple

import numpy as np
import torch
import torch.nn.functional as nnf

from ..config import SolverConfig
from ..models import srps
from ..ops.gradients import GradientMasks
from ..solve.stencil_cg import F_ROWS
from .shard_cg import (RowMesh, cg_bands, cg_sharded, cg_sharded_cgs,
                       cg_sharded_jacobi, check_rows, groups, make_mesh_1d)

# Fields of the problem and the state by how they are placed (all other
# tensor fields are (..., h, w) halo bands).
PIXELS = ("I",)
LR_ROWS = ("masks", "z0s")
REPLICATED = ("s", "energy", "last_energy", "cg_iters")
# The depth operator's planes lead the halo stacks F and R0, in its order.
N_OP_F, N_OP_R0 = 6, 3
assert F_ROWS[:N_OP_F] == srps.DepthOperator._fields[:N_OP_F]


class Bands(NamedTuple):
    """A problem or a state placed in row bands over ``mesh`` (see the
    module): ``parts[g]`` is the ``SRPSProblem`` / ``SRPSState`` of group g
    of ``shard_cg.groups(mesh)``; a problem also holds each group's halo
    stacks ``F`` and ``R0``. ``h`` is the whole grid's row count."""

    mesh: RowMesh
    h: int
    parts: tuple
    F: tuple = ()
    R0: tuple = ()


class Lanes(NamedTuple):
    """A batched tree placed on a :class:`Mesh`: lane b's problem or state
    on its data group (:class:`Bands`, or the whole tree on one device)."""

    trees: tuple


def owned(t: torch.Tensor) -> torch.Tensor:
    """The owned rows of a halo band (or of a group of bands)."""
    return t[..., 1:-1, :]


def _band_rows(t, first: int, count: int, hb: int, device):
    """Bands ``first .. first + count - 1`` of ``t`` (..., h, w), each with
    its halo rows, as (..., count, hb + 2, w) on ``device``."""
    pad = nnf.pad(t, (0, 0, 1, 1))
    return torch.stack([pad[..., (first + j) * hb:(first + j + 1) * hb + 2, :]
                        for j in range(count)], dim=-3).to(device)


def _copy_slice(t, lo: int, hi: int, dim: int, device):
    """``t`` between ``lo`` and ``hi`` along ``dim`` as a tensor of its own
    on ``device`` (the whole of ``t`` where the slice covers it)."""
    if lo == 0 and hi == t.shape[dim]:
        return t.to(device)
    part = t.narrow(dim, lo, hi - lo)
    out = torch.empty(part.shape, dtype=t.dtype, device=device)
    return out.copy_(part)


def _place(tree, mesh: RowMesh, group) -> dict:
    """The fields of ``tree`` for ``group`` = (device, first, count)."""
    dev, first, count = group

    def split(v, dim):
        m = v.shape[dim] // mesh.size
        return _copy_slice(v, first * m, (first + count) * m, dim, dev)

    def band(v):
        return _band_rows(v, first, count, v.shape[-2] // mesh.size, dev)

    out = {}
    for name, v in tree._asdict().items():
        if name in PIXELS:
            out[name] = split(v, -1)
        elif name in LR_ROWS:
            out[name] = split(v, -2).unflatten(-2, (count, -1))
        elif isinstance(v, GradientMasks):
            out[name] = GradientMasks(*map(band, v))
        elif name in REPLICATED or not isinstance(v, torch.Tensor):
            out[name] = v.to(dev) if isinstance(v, torch.Tensor) else v
        else:
            out[name] = band(v)
    return out


def shard_problem_rows(prob: srps.SRPSProblem, mesh: RowMesh) -> Bands:
    """``prob`` in row bands over ``mesh`` (see the module). Raises
    ``ValueError`` where its h rows do not split into ``mesh.size`` bands
    of a multiple of sf rows. Nothing of ``prob`` stays referenced, but I
    where one group holds every band (it is then the group's I)."""
    h, w = prob.mask.shape
    sf = h // prob.masks.shape[-2]
    try:
        hb = check_rows(h, mesh.size, sf)
    except ValueError as e:
        raise ValueError(f"grid ({h}, {w}): {e}") from None
    parts, Fs, R0s = [], [], []
    for group in groups(mesh):
        dev, _, count = group
        f = _place(prob, mesh, group)
        F = torch.zeros((count, len(F_ROWS), hb + 2, w), dtype=torch.float32,
                        device=dev)
        R0 = torch.zeros((count, 4, hb + 2, w), dtype=torch.float32,
                         device=dev)
        F[:, N_OP_F:N_OP_F + 4] = torch.stack(f["gm"], dim=1)
        F[:, F_ROWS.index("ktw")] = f["ktw"]
        R0[:, N_OP_R0] = f["z0t"]
        f.update(gm=GradientMasks(*F[:, N_OP_F:N_OP_F + 4].unbind(1)),
                 ktw=F[:, F_ROWS.index("ktw")], z0t=R0[:, N_OP_R0])
        parts.append(srps.SRPSProblem(**f))
        Fs.append(F)
        R0s.append(R0)
    return Bands(mesh, h, tuple(parts), tuple(Fs), tuple(R0s))


def shard_state_rows(state: srps.SRPSState, mesh: RowMesh) -> Bands:
    """``state`` in row bands over ``mesh`` (see the module)."""
    h = state.z.shape[-2]
    if h % mesh.size:
        raise ValueError(f"grid {tuple(state.z.shape)}: {h} rows do not "
                         f"split into {mesh.size} row shards")
    return Bands(mesh, h, tuple(srps.SRPSState(**_place(state, mesh, g))
                                for g in groups(mesh)))


def gather_field(tree: Bands, name: str, device=None):
    """Field ``name`` of ``tree`` back on the whole grid, on ``device`` (by
    default the first shard's)."""
    device = device or tree.mesh.devices[0]
    v = [getattr(p, name) for p in tree.parts]
    if not isinstance(v[0], (torch.Tensor, GradientMasks)):
        return v[0]
    if name in REPLICATED:
        return v[0].to(device)
    if isinstance(v[0], GradientMasks):
        return GradientMasks(*(_unband_planes([m[k] for m in v], device)
                               for k in range(4)))
    if name in PIXELS:
        return torch.cat([t.to(device) for t in v], dim=-1)
    if name in LR_ROWS:
        return torch.cat([t.to(device).flatten(-3, -2) for t in v], dim=-2)
    return _unband_planes(v, device)


def _unband_planes(v, device):
    return torch.cat([owned(t).to(device).flatten(-3, -2) for t in v], dim=-2)


def gather(tree: Bands, device=None):
    """The whole-grid problem or state of ``tree`` on ``device`` (by
    default the first shard's): the owned rows of every band, in order."""
    kind = type(tree.parts[0])
    return kind(**{name: gather_field(tree, name, device)
                   for name in kind._fields})


def shard_bytes(*trees: Bands) -> list:
    """The bytes each shard of the mesh holds of ``trees`` (placed on one
    mesh): its share of each banded tensor (and of the halo stacks), every
    replicated tensor whole. Views count once, with their storage."""
    mesh = trees[0].mesh
    out = []
    for g, (_, _, count) in enumerate(groups(mesh)):
        banded, whole = {}, {}
        for tree in trees:
            part = tree.parts[g]
            stacks = [t[g] for t in (tree.F, tree.R0) if t]
            for name, v in list(part._asdict().items()) + [
                    ("F", t) for t in stacks]:
                for t in (v if isinstance(v, GradientMasks) else (v,)):
                    if not isinstance(t, torch.Tensor):
                        continue
                    st = t.untyped_storage()
                    (whole if name in REPLICATED else banded)[
                        st.data_ptr()] = st.nbytes()
        per = sum(banded.values()) // count + sum(whole.values())
        out += [per] * count
    return out


def exchange_bands(parts, axis: int = -3) -> None:
    """Refresh the halo rows of a field held in bands, in place: ``parts``
    are the groups' tensors in shard order, each band on ``axis`` just
    before the rows (..., n_g, hb + 2, w); each band's halo rows get the
    adjacent bands' edge rows, zeros at the global top and bottom."""
    parts = [t.movedim(axis, -3) for t in parts]
    for t in parts:
        if t.shape[-3] > 1:
            t[..., 1:, 0, :].copy_(t[..., :-1, -2, :])
            t[..., :-1, -1, :].copy_(t[..., 1:, 1, :])
    for a, b in zip(parts, parts[1:]):
        b[..., 0, 0, :].copy_(a[..., -1, -2, :])
        a[..., -1, -1, :].copy_(b[..., 0, 1, :])
    parts[0][..., 0, 0, :].zero_()
    parts[-1][..., -1, -1, :].zero_()


def _refresh_depth(zs) -> None:
    """The halo rows of z after the depth CG: the normals, the energy and
    the next CG's x0 read z at i +- 1."""
    exchange_bands(zs)


def _mesh_sum(parts):
    """Per-band partial sums (tuples of tensors, in shard order) added in
    shard order on the first band's device."""
    dev = parts[0][0].device
    total = list(parts[0])
    for p in parts[1:]:
        total = [a + b.to(dev) for a, b in zip(total, p)]
    return total


def _owned_problem(pb: srps.SRPSProblem) -> srps.SRPSProblem:
    """A group's problem on its owned rows (views); I and the LR fields
    hold owned rows only already."""
    return pb._replace(mask=owned(pb.mask), xx=owned(pb.xx),
                       yy=owned(pb.yy), SI2=owned(pb.SI2),
                       z0t=owned(pb.z0t), ktw=owned(pb.ktw),
                       z0u=owned(pb.z0u),
                       gm=GradientMasks(*(owned(m) for m in pb.gm)))


def _lighting_partials(I, rho, N, bands: int):
    """Each band's lighting normal equations over its owned pixels: I a
    group's pixels, rho and N its halo bands (``srps.lighting_sums``)."""
    return srps.lighting_sums(I, owned(rho), owned(N), bands)


def srps_iteration_sharded(state: Bands, prob: Bands, sf: int,
                           cfg: SolverConfig, block=(256, 4)) -> Bands:
    """One outer iteration with every phase on the row bands of ``prob``
    and ``state`` (see the module): the depth CG by ``shard_cg.cg_bands``
    on the route of the mesh (``--jacobi``: the in-sweep Jacobi PCG at
    every sf and whatever the variant; ``cg_variant="cgs"``: the
    Chronopoulos-Gear CG; else the standard CG; the JAX kernel route,
    sharded.py:153-207)."""
    lam, mesh = cfg.lam, prob.mesh
    grp = groups(mesh)
    sts = state.parts
    # Lighting: per-band normal equations over owned pixels, in shard order.
    parts = []
    for pb, st, (_, _, n) in zip(prob.parts, sts, grp):
        ata, atb = _lighting_partials(pb.I, st.rho, st.N, n)
        parts += [(ata[:, j], atb[:, j]) for j in range(n)]
    s = srps.solve_lighting(*_mesh_sum(parts), sts[0].s)
    # s-moments, albedo and the operator's fields, pointwise per group on
    # the owned rows; the operator's planes into F and R0.
    ss, rhos, consts, ops = [], [], [], []
    for pb, st, F, R0, (dev, _, n) in zip(prob.parts, sts, prob.F, prob.R0,
                                          grp):
        po = _owned_problem(pb)
        sg = s.to(dev)
        mom = srps.s_moments(po, sg)
        rho_o = srps.estimate_albedo(po, mom, owned(st.N), owned(st.rho))
        rho = torch.zeros_like(st.rho)
        owned(rho).copy_(rho_o)
        op = srps.build_depth_operator(po, mom, rho_o, owned(st.dz), lam,
                                       const=0.0)
        for k in range(N_OP_F):
            owned(F[:, k]).copy_(op[k])
        for k in range(N_OP_R0):
            owned(R0[:, k]).copy_(op[N_OP_F + k])
        c = srps.depth_const(owned(pb.SI2), rho_o, mom, bands=True)
        consts += [(c[j],) for j in range(n)]
        ss.append(sg)
        rhos.append(rho)
    exchange_bands([F[:, :N_OP_F] for F in prob.F], axis=0)
    exchange_bands([R0[:, :N_OP_R0] for R0 in prob.R0], axis=0)
    const, = _mesh_sum(consts)
    for F, R0, (dev, _, _) in zip(prob.F, prob.R0, grp):
        ops.append(srps.DepthOperator(*F[:, :N_OP_F].unbind(1),
                                      *R0[:, :N_OP_R0].unbind(1),
                                      const.to(dev)))
    # The depth CG on the stacks in place.
    invd = None
    if cfg.jacobi_preconditioner:
        invd = [(1.0 / srps.depth_diag(op, pb, sf, lam)).contiguous()
                for op, pb in zip(ops, prob.parts)]
        exchange_bands(invd)
    xs, cg_iters, _ = cg_bands(
        mesh, prob.F, prob.R0, [st.z for st in sts], invd, sf=sf, lam=lam,
        tol=cfg.cg_tol, max_iter=cfg.cg_max_iter, block=block,
        cgs=cfg.cg_variant == "cgs" and invd is None)
    zs = []
    for x, pb, st in zip(xs, prob.parts, sts):
        z = torch.zeros_like(st.z)
        torch.mul(x.to(z.device), owned(pb.mask), out=owned(z))
        zs.append(z)
    _refresh_depth(zs)
    # The energy: per-band partials over owned rows, in shard order.
    parts = []
    for z, op, pb, (_, _, n) in zip(zs, ops, prob.parts, grp):
        e = srps.depth_energy(z, op._replace(const=0.0), pb, sf, lam,
                              rows=slice(1, -1))
        parts += [(e[j],) for j in range(n)]
    e_sum, = _mesh_sum(parts)
    energy = e_sum + lam * const
    out = []
    for z, pb, st, sg, rho, (dev, _, _) in zip(zs, prob.parts, sts, ss, rhos,
                                               grp):
        N, dz = srps.depth_normals(z, pb)
        out.append(srps.SRPSState(
            z=z, rho=rho, s=sg, N=N, dz=dz, energy=energy.to(dev),
            last_energy=st.energy, iteration=st.iteration + 1,
            cg_iters=cg_iters.to(dev)))
    return Bands(mesh, state.h, tuple(out))


def _iteration_grid_glue(state, prob, sf: int, cfg: SolverConfig,
                         mesh: RowMesh, block=(256, 4)):
    """One outer iteration of whole-grid trees with the glue on the whole
    grid and only the depth CG on the row mesh, its operands banded per
    solve: the route the banded one replaced, kept as the reference that
    tests/test_torch_mesh.py and ``chip_smoke.py`` 4j hold it to."""
    lam = cfg.lam
    s = srps.estimate_lighting(prob, state.rho, state.N, state.s)
    mom = srps.s_moments(prob, s)
    rho = srps.estimate_albedo(prob, mom, state.N, state.rho)
    op = srps.build_depth_operator(prob, mom, rho, state.dz, lam)
    args = (op, prob.gm, prob.ktw, prob.z0t)
    kw = dict(sf=sf, lam=lam, tol=cfg.cg_tol, max_iter=cfg.cg_max_iter,
              block=block)
    if cfg.jacobi_preconditioner:
        invd = 1.0 / srps.depth_diag(op, prob, sf, lam)
        x, cg_iters, _ = cg_sharded_jacobi(mesh, state.z, invd, *args, **kw)
    elif cfg.cg_variant == "cgs":
        x, cg_iters, _ = cg_sharded_cgs(mesh, state.z, *args, **kw)
    else:
        x, cg_iters, _ = cg_sharded(mesh, state.z, *args, **kw)
    z = x * prob.mask
    energy = srps.depth_energy(z, op, prob, sf, lam)
    N, dz = srps.depth_normals(z, prob)
    return srps.SRPSState(z=z, rho=rho, s=s, N=N, dz=dz, energy=energy,
                          last_energy=state.energy,
                          iteration=state.iteration + 1, cg_iters=cg_iters)


def solve_fused_sharded(state, prob, sf: int, cfg: SolverConfig,
                        mesh: RowMesh, block=(256, 4), on_iteration=None,
                        glue: str = "bands"):
    """The outer loop of ``srps.solve_fused`` on the row mesh: one host
    read per outer iteration (the stop test). ``glue="bands"`` runs every
    phase on row bands (:func:`srps_iteration_sharded`): placed
    :class:`Bands` in, the final state in bands out; whole-grid trees are
    placed on ``mesh`` here and the final state is gathered back onto
    their device. ``glue="grid"`` runs the whole-grid glue on whole-grid
    trees, the reference the banded route is held to
    (:func:`_iteration_grid_glue`). Returns the final state and the energy
    trace (NaN-padded, length ``max_iterations + 2``) on the first shard's
    device."""
    if glue not in ("bands", "grid"):
        raise ValueError(f"glue must be 'bands' or 'grid', got {glue!r}")
    whole = isinstance(prob, srps.SRPSProblem)
    if glue == "grid":
        if not whole:
            raise ValueError("glue='grid' takes whole-grid trees")
        step = lambda st: _iteration_grid_glue(  # noqa: E731
            st, prob, sf, cfg, mesh, block)
        head = lambda st: st  # noqa: E731
    else:
        if whole:
            device = prob.mask.device
            prob = shard_problem_rows(prob, mesh)
            state = shard_state_rows(state, mesh)
        elif prob.mesh != mesh:
            raise ValueError(f"the trees are placed on {prob.mesh}, not "
                             f"on {mesh}")
        step = lambda st: srps_iteration_sharded(  # noqa: E731
            st, prob, sf, cfg, block)
        head = lambda st: st.parts[0]  # noqa: E731
    trace = torch.full((cfg.max_iterations + 2,), math.nan,
                       dtype=torch.float32, device=mesh.devices[0])
    st = state
    while head(st).iteration == 0 or not bool(
            srps.should_stop(head(st), cfg)):
        st = step(st)
        lead = head(st)
        if lead.iteration - 1 < trace.shape[0]:
            trace[lead.iteration - 1] = lead.energy.to(trace.device)
        if on_iteration is not None:
            on_iteration(lead)
    if glue == "bands" and whole:
        st = gather(st, device)
    return st, trace


# ---------------------------------------------------------------------------
# The ('data', 'x', 'y') mesh
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class Mesh:
    """A ``('data', 'x', 'y')`` mesh: ``devices`` (data, x, y), an object
    array of ``torch.device`` (repeats allowed). Data group b's x y
    devices hold its lanes in x y row bands (:meth:`lane`)."""

    devices: np.ndarray
    axis_names: tuple = ("data", "x", "y")

    @property
    def shape(self) -> dict:
        return dict(zip(self.axis_names, self.devices.shape))

    def lane(self, b: int) -> RowMesh:
        """The row mesh of data group b's spatial devices."""
        flat = list(self.devices[b].ravel())
        return make_mesh_1d(len(flat), flat)


def make_mesh(n_devices: int, data: int = 1, devices=None) -> Mesh:
    """A ``('data', 'x', 'y')`` mesh of ``n_devices`` positions (JAX
    ``make_mesh``): ``data`` groups, the spatial factor n / data split as
    squarely as possible, x <= y. ``devices``: one device for every
    position (a repeated device), or ``n_devices`` of them; by default the
    CUDA card (``device.resolve_device``), or ``"cpu"``."""
    if n_devices < 1 or data < 1 or n_devices % data:
        raise ValueError(f"{n_devices} devices do not split into {data} "
                         f"data groups")
    if devices is None:
        from ..device import resolve_device

        devices = resolve_device()
    if isinstance(devices, (str, torch.device)):
        devices = [devices] * n_devices
    devices = [torch.device(d) for d in devices]
    if len(devices) != n_devices:
        raise ValueError(f"a mesh of {n_devices} devices got "
                         f"{len(devices)}")
    spatial = n_devices // data
    x = next(f for f in range(int(math.isqrt(spatial)), 0, -1)
             if spatial % f == 0)
    arr = np.empty(n_devices, dtype=object)
    arr[:] = devices
    return Mesh(arr.reshape(data, x, spatial // x))


def _on_device(tree, device):
    """The whole tree on ``device``."""
    def move(v):
        if isinstance(v, GradientMasks):
            return GradientMasks(*(m.to(device) for m in v))
        return v.to(device) if isinstance(v, torch.Tensor) else v

    return type(tree)(*(move(v) for v in tree))


def _place_lane(tree, rows: RowMesh):
    if rows.size == 1:
        return _on_device(tree, rows.devices[0])
    if isinstance(tree, srps.SRPSProblem):
        return shard_problem_rows(tree, rows)
    return shard_state_rows(tree, rows)


def shard_pytree(tree, mesh: Mesh, batched: bool = False):
    """Place a problem or a state on ``mesh`` (JAX ``shard_pytree``): an
    unbatched tree (on a mesh of one data group) on the spatial devices,
    in x y row bands (:class:`Bands`), or whole on the device where x y =
    1; a batched tree (stacked as ``parallel.batched.stack_problems``
    stacks, B lanes, a multiple of the data groups) lane by lane, lane b on
    data group b * data // B (:class:`Lanes`). Raises ``ValueError`` where
    h does not split into x y bands of a multiple of sf rows."""
    from .batched import unstack

    data = mesh.shape["data"]
    if not batched:
        if data != 1:
            raise ValueError(f"an unbatched tree takes a mesh of one data "
                             f"group, not {mesh.shape}")
        return _place_lane(tree, mesh.lane(0))
    lanes = unstack(tree)
    if len(lanes) % data:
        raise ValueError(f"{len(lanes)} lanes do not split into {data} "
                         f"data groups")
    return Lanes(tuple(_place_lane(t, mesh.lane(b * data // len(lanes)))
                       for b, t in enumerate(lanes)))


def _lane_mesh(tree) -> list:
    return list(tree.mesh.devices) if isinstance(tree, Bands) \
        else [tree.mask.device if isinstance(tree, srps.SRPSProblem)
              else tree.z.device]


def _check_placed(prob, mesh: Mesh) -> None:
    devs = {d for d in mesh.devices.ravel()}
    if not set(_lane_mesh(prob)) <= devs:
        raise ValueError(f"the tree is not placed on {mesh.shape} mesh "
                         f"devices {sorted(map(str, devs))}")


def step_sharded(state, prob, sf: int, cfg: SolverConfig, mesh: Mesh,
                 block=(256, 4)):
    """One outer iteration of a tree placed by :func:`shard_pytree` (JAX
    ``step_sharded``; the mesh is explicit): on row bands where x y > 1
    (:func:`srps_iteration_sharded`), ``srps.srps_iteration`` on the lane's
    device where x y = 1; every lane of a batched tree, each lane's
    launches queued before any host read."""
    if isinstance(prob, Lanes):
        return Lanes(tuple(step_sharded(s, p, sf, cfg, mesh, block)
                           for s, p in zip(state.trees, prob.trees)))
    _check_placed(prob, mesh)
    if isinstance(prob, Bands):
        return srps_iteration_sharded(state, prob, sf, cfg, block)
    return srps.srps_iteration(state, prob, sf, cfg, block)


def solve_sharded(state, prob, sf: int, cfg: SolverConfig, mesh: Mesh,
                  block=(256, 4)):
    """The fused outer loop of an unbatched tree (or one lane of a batched
    one) placed by :func:`shard_pytree` (JAX ``solve_sharded``). Returns
    ``(final, trace)`` as ``srps.solve_fused``, the final state placed as
    the input was."""
    if isinstance(prob, Lanes):
        raise ValueError("solve_sharded takes one lane; step_sharded "
                         "steps a batch")
    _check_placed(prob, mesh)
    if isinstance(prob, Bands):
        return solve_fused_sharded(state, prob, sf, cfg, prob.mesh, block)
    return srps.solve_fused(state, prob, sf, cfg, block)


# ---------------------------------------------------------------------------
# Multi-device dry run
# ---------------------------------------------------------------------------


def dryrun_mesh(n_devices: int, devices=None, batch=None) -> list:
    """The data-axis half of JAX ``dryrun`` (:258-303): a
    ``make_mesh(n_devices, data=batch)`` mesh (batch 2 where n_devices is
    even), ``batch`` seeded lanes at the JAX dry run's tiny shapes (h
    rounded up to x y bands of a multiple of sf rows), one
    :func:`step_sharded` of the batch; raises unless every energy is
    finite and each lane's is within rtol 1e-3 of its solo step. Returns
    the lanes' energies."""
    from ..pre import preprocess_depth

    if batch is None:
        batch = 2 if n_devices % 2 == 0 else 1
    mesh = make_mesh(n_devices, data=batch, devices=devices)
    dev = mesh.devices.flat[0]
    sx, sy = mesh.shape["x"], mesh.shape["y"]
    sf, n, c = 2, 2, 3
    h = max(16, 2 * sf * sx)
    w = max(16, 2 * sf * sy)
    h += (-h) % (sf * sx)
    w += (-w) % (sf * sy)
    h += (-h) % (sf * sx * sy)
    rng = np.random.default_rng(0)
    yy, xx = np.mgrid[0:h, 0:w]
    mask = (((yy - h / 2) ** 2 + (xx - w / 2) ** 2) < (0.45 * min(h, w)) ** 2
            ).astype(np.float32)
    K = [[300.0, 0, w / 2 - 0.5], [0, 300.0, h / 2 - 0.5], [0, 0, 1]]
    cfg = SolverConfig(max_iterations=2)
    probs, states = [], []
    for _ in range(batch):
        I = rng.random((n, c, h, w)).astype(np.float32)
        z0 = (rng.random((n, h // sf, w // sf)).astype(np.float32) + 1.0) \
            * 50.0
        zs, z_init = preprocess_depth(torch.as_tensor(z0, device=dev), h, w,
                                      cfg)
        pb = srps.build_problem(I, mask, K, sf, zs, dev)
        probs.append(pb)
        states.append(srps.init_state(pb, z_init))
    from .batched import stack_problems, stack_states

    prob_b = shard_pytree(stack_problems(probs), mesh, batched=True)
    state_b = shard_pytree(stack_states(states), mesh, batched=True)
    out = step_sharded(state_b, prob_b, sf, cfg, mesh)
    energies = [float(t.parts[0].energy if isinstance(t, Bands)
                      else t.energy) for t in out.trees]
    solo = [float(srps.srps_iteration(st, pb, sf, cfg).energy)
            for st, pb in zip(states, probs)]
    if not all(map(math.isfinite, energies)):
        raise AssertionError(f"mesh {mesh.shape}: energies {energies}")
    np.testing.assert_allclose(energies, solo, rtol=1e-3,
                               err_msg=f"mesh {mesh.shape} lanes vs solo")
    return energies


def dryrun(n_shards: int, devices=None, batch=None) -> list:
    """JAX ``dryrun``: first :func:`dryrun_mesh` (the data axis, ``batch``
    as there), then a tiny seeded problem on ``n_shards`` row shards (on
    ``devices``, see ``make_mesh_1d``; by default every shard on the CUDA
    device, which ``device.resolve_device`` requires, or ``"cpu"``) with
    the standard CG, the CGS and Jacobi, each held to the unsharded solve
    of the same recurrence: equal outer iterations and energies within
    rtol 1e-3. The unsharded Jacobi PCG is the direct operator's (the
    stencil CG takes the scaled form at sf <= 2). Returns the row-mesh
    half's per-variant traces."""
    from ..device import resolve_device
    from ..io.synthetic import lambertian_dataset
    from ..runtime.solver import prepare

    if devices is None:
        devices = resolve_device()
    dryrun_mesh(n_shards, devices, batch)
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
