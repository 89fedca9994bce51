"""The per-shard kernels of the row-sharded depth CG, and their plain
versions.

Port of the TPU kernels of ``srmeetsps_cuda_tpu/parallel/shard_pallas.py``
(``_prologue_kernel`` :124, ``_cgs_sweep_kernel`` :249, ``_std_kernel_a``
:375, ``_std_kernel_b`` :440, ``_std_kernel_b_jac`` :495) as the
hand-written CUDA kernels of ``csrc/shard_cg.cu``. A :class:`Shard` holds
one row band of ``h`` rows: its operands, its CG state and its scalars
(:func:`new_shards`; on a mesh whose shards all lie on one device, views
into (N, ...) stacks, which the persistent kernels of
``shard_cg.persistent`` read whole). Each step below has a plain PyTorch
version (``*_plain``); the wrapper of the same name takes the plain version
for a shard on the CPU and launches the kernel, on the shard's device and
current stream, for a shard on a CUDA device (or raises). The row-shard
loops of ``parallel/shard_cg.py`` call the steps in this order, exchanging
halo rows and gathering the shards' sums in between:

* :func:`prologue` (kernel 10): the 9 stencil planes C from the fields with
  their halo rows, ``x = x0``, ``r0 = rhs - M x0``, the sums ``<r0, r0>``
  and, under Jacobi, ``rz0``; for CGS then :func:`cgs_w0`: ``w0 = M r0``
  and the sums ``gamma0``, ``delta0``;
* :func:`step_a` (kernel 12): the combine of the gathered sums, then
  ``p = z + beta p_old`` (``z = invd r`` under Jacobi, else r), ``w = M p``
  and ``<p, w>``; p's halo rows are recomputed from r's, so only r is
  exchanged per iteration;
* :func:`step_b` (kernels 13 and 14): the combine of ``<p, w>``, then
  ``x += alpha p``, ``r -= alpha w`` and ``<r, r>`` (and ``rz``);
* :func:`cgs_step` (kernel 11): the combine of ``(gamma, delta)``, then one
  Chronopoulos-Gear sweep from one set of the (r, w, s) halo planes into
  the other;
* :func:`finish`: the last combine.

A halo plane is (h + 2, w): rows 0 and h + 1 hold the neighbour shards'
edge rows (zeros at the global top and bottom). The combine adds the N
shards' sums (``gathered``, (N, 2) float64) in shard order, so every shard
holds the same scalars. Each launch on one shard is counted in the launch
registry (``trace.launched``): ``"shard_cg prologue"`` (with the CGS w0),
``"shard_cg sweep_a"``, ``"shard_cg sweep_b"`` (``"shard_cg sweep_b
jacobi"`` those in the Jacobi form, kernel 14) and ``"shard_cg
cgs_sweep"``.
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools
from types import SimpleNamespace
from typing import Optional

import torch

from .. import trace as tracing
from ..ops import gradients as gradops
from ..ops.gradients import GradientMasks
from ..ops.grid import tilesum
from ..solve.stencil_cg import (MAX_BLOCK_THREADS, N_STENCIL, N_SCAL,
                                build_c_planes, depth_rhs_fields)

# Device scalar slots (csrc/std_cg.cuh, csrc/cgs_common.cuh).
S_ITERS, S_RR = 7, 9
CGS_S_GAMMA, CGS_S_ITERS = 0, 7
CGS_N_SCAL = 9
PART_ROWS = 3
F64 = torch.float64


@dataclasses.dataclass
class Shard:
    """One row band of a sharded depth CG on ``device``. ``F`` (11 halo
    planes: P11..P33, fwd_x, bwd_x, fwd_y, bwd_y, ktw), ``R0`` (4 halo
    planes: QB1, QB2, QB3, z0t), ``x0`` (a halo plane) and ``invd`` (a halo
    plane under Jacobi, else None) are the operands; the rest is the state
    :func:`new_shards` allocates."""

    device: torch.device
    h: int
    w: int
    sf: int
    lam: float
    tol2: float
    max_iter: int
    block: tuple
    cgs: bool
    F: torch.Tensor
    R0: torch.Tensor
    x0: torch.Tensor
    invd: Optional[torch.Tensor]
    stack: Optional[SimpleNamespace] = None  # one device: the (N, ...) stacks
    x: torch.Tensor = None
    C: torch.Tensor = None
    r: torch.Tensor = None      # standard CG: r's halo plane
    p: torch.Tensor = None      # standard CG: (2, h + 2, w) ping-pong p
    wv: torch.Tensor = None     # standard CG: w = M p
    rws: torch.Tensor = None    # CGS: (6, h + 2, w), (r, w, s) of two sets
    pc: torch.Tensor = None     # CGS: p
    part: torch.Tensor = None
    own: torch.Tensor = None
    gathered: torch.Tensor = None
    scal: torch.Tensor = None   # the kernels' scalars
    st: dict = None             # the plain versions' scalars


def _state(lead: tuple, n: int, h: int, w: int, nb: int, cgs: bool,
           device) -> dict:
    """The zeroed CG state of :class:`Shard`, each tensor with the leading
    axes ``lead``."""
    z = lambda *s, dtype=torch.float32: torch.zeros(  # noqa: E731
        lead + s, dtype=dtype, device=device)
    st = dict(x=z(h, w), C=z(N_STENCIL, h, w), part=z(PART_ROWS * nb),
              own=z(2, dtype=F64), gathered=z(n, 2, dtype=F64),
              scal=z(CGS_N_SCAL if cgs else N_SCAL))
    if cgs:
        st.update(rws=z(6, h + 2, w), pc=z(h, w))
    else:
        st.update(r=z(h + 2, w), p=z(2, h + 2, w), wv=z(h, w))
    return st


def new_shards(devices, *, F, R0, x0, invd, **kw) -> list:
    """The :class:`Shard` of each of ``devices`` (one per shard), with its
    state allocated (zeros); ``kw`` are the other fields up to ``cgs``.
    The operands F, R0, x0 and invd (or None) are per-shard lists, or,
    where every shard lies on one device, (N, ...) stacks: then each state
    tensor is one stacked allocation too, every shard holds views into the
    stacks, and ``stack`` holds the stacks."""
    n = len(devices)
    h, w, cgs = kw["h"], kw["w"], kw["cgs"]
    bx, by = kw["block"]
    if bx <= 0 or by <= 0 or bx * by > MAX_BLOCK_THREADS:
        raise ValueError(f"thread block {bx}x{by} must hold 1..1024 threads")
    nb = (-(-w // bx)) * (-(-h // by))
    ops = dict(F=F, R0=R0, x0=x0, invd=invd)
    pick = lambda d, i: {k: None if v is None else v[i]  # noqa: E731
                         for k, v in d.items()}
    if isinstance(F, torch.Tensor):
        stack = SimpleNamespace(**ops, **_state((n,), n, h, w, nb, cgs,
                                                devices[0]))
        fields = [pick(vars(stack), i) for i in range(n)]
    else:
        stack = None
        fields = [dict(pick(ops, i), **_state((), n, h, w, nb, cgs, dev))
                  for i, dev in enumerate(devices)]
    return [Shard(device=dev, stack=stack, **kw, **f)
            for dev, f in zip(devices, fields)]


def result(sh: Shard):
    """``(iters, r1)`` of a finished solve, as 0-d tensors on the shard's
    device: the iterations run and the stop dot (``<r, r>``, or gamma)."""
    if sh.st is not None:
        st = sh.st
        return st["iters"], (st["gamma"] if sh.cgs else st["rr"])
    s = sh.scal
    if sh.cgs:
        return s[CGS_S_ITERS].to(torch.int32), s[CGS_S_GAMMA]
    return s[S_ITERS].to(torch.int32), s[S_RR]


# ---------------------------------------------------------------------------
# Plain versions
# ---------------------------------------------------------------------------


def inner(t: torch.Tensor) -> torch.Tensor:
    """The h rows of a halo plane (or stack)."""
    return t[..., 1:-1, :]


def halo_matvec(C, v, ktw, sf: int) -> torch.Tensor:
    """``M v`` on a shard's rows: ``sum_d C_d v[i + d]`` from the halo plane
    ``v`` (+ ``ktw * tilesum(v)`` at sf = 4; tiles never cross a shard)."""
    sh = gradops.shift
    c = C.unbind(-3)
    pe, pw = sh(v, 0, 1), sh(v, 0, -1)
    w = (c[0] * inner(v) + c[1] * inner(pe) + c[2] * inner(pw)
         + c[3] * v[2:] + c[4] * v[:-2] + c[5] * pe[2:] + c[6] * pe[:-2]
         + c[7] * pw[2:] + c[8] * pw[:-2])
    if sf == 4:
        w = w + ktw * tilesum(inner(v), sf)
    return w


def _ktw(sh: Shard) -> torch.Tensor:
    return inner(sh.F[10])


def _dot(a, b) -> torch.Tensor:
    return torch.sum(a * b, dtype=F64)


def _sum_column(g: torch.Tensor, k: int) -> torch.Tensor:
    """Column k of the gathered sums, added in shard order."""
    s = g[0, k]
    for j in range(1, g.shape[0]):
        s = s + g[j, k]
    return s


def prologue_plain(sh: Shard) -> None:
    F = sh.F
    gm = GradientMasks(*F[6:10])
    op = SimpleNamespace(P11=F[0], P12=F[1], P13=F[2], P22=F[3], P23=F[4],
                         P33=F[5])
    sh.C.copy_(inner(build_c_planes(op, gm, F[10], sh.lam, sh.sf, row0=-1)))
    sh.x.copy_(inner(sh.x0))
    R0 = sh.R0
    qb = SimpleNamespace(QB1=R0[0], QB2=R0[1], QB3=R0[2])
    rhs = inner(depth_rhs_fields(qb, gm, R0[3], sh.lam))
    r = rhs - halo_matvec(sh.C, sh.x0, _ktw(sh), sh.sf)
    r_plane = sh.rws[0] if sh.cgs else sh.r
    inner(r_plane).copy_(r)
    rr = _dot(r, r)
    sh.own.copy_(torch.stack([rr, _dot(r * r, inner(sh.invd))
                              if sh.invd is not None else rr]))


def cgs_w0_plain(sh: Shard) -> None:
    r = sh.rws[0]
    w0 = halo_matvec(sh.C, r, _ktw(sh), sh.sf)
    inner(sh.rws[1]).copy_(w0)
    sh.own.copy_(torch.stack([_dot(inner(r), inner(r)), _dot(w0, inner(r))]))


def _std_scalars(sh: Shard, step: str) -> None:
    """std_cg.cuh's scal_init / scal_a / scal_b on the plain scalars."""
    g = sh.gathered
    a = _sum_column(g, 0)
    rz = _sum_column(g, 1) if sh.invd is not None else a
    dev = sh.device
    f32 = lambda v: torch.as_tensor(v, dtype=torch.float32, device=dev)  # noqa: E731
    if step == "init":
        rr = a.float()
        act = (rr > sh.tol2) & (0 <= sh.max_iter)
        sh.st = {"r0": f32(0.0), "r1": rz.float(), "rr": rr,
                 "alpha": f32(0.0), "beta": f32(0.0), "act": act,
                 "iters": act.to(torch.int32), "k": f32(1.0)}
        return
    st = sh.st
    act = st["act"]
    one = f32(1.0)
    if step == "a":
        pw = a.float()
        alpha = st["r1"] / torch.where(pw == 0, one, pw)
        st["alpha"] = torch.where(act, alpha, st["alpha"])
        return
    rr, r1 = a.float(), rz.float()
    r1_old = st["r1"]
    k = st["k"] + 1.0
    on = (rr > sh.tol2) & (k - 1.0 <= sh.max_iter)
    new = {"r0": r1_old, "r1": r1, "rr": rr, "k": k,
           "beta": r1 / torch.where(r1_old == 0, one, r1_old),
           "iters": st["iters"] + on.to(torch.int32), "act": on}
    for key, v in new.items():
        st[key] = torch.where(act, v, st[key])


def step_a_plain(sh: Shard, k: int) -> None:
    _std_scalars(sh, "init" if k == 1 else "b")
    st = sh.st
    act, beta = st["act"], st["beta"]
    p_old, p_new = sh.p[(k + 1) % 2], sh.p[k % 2]
    z = sh.r if sh.invd is None else sh.invd * sh.r
    p = z + beta * p_old
    w = halo_matvec(sh.C, p, _ktw(sh), sh.sf)
    p_new.copy_(torch.where(act, p, p_new))
    sh.wv.copy_(torch.where(act, w, sh.wv))
    sh.own[0] = _dot(inner(p), w)


def step_b_plain(sh: Shard, k: int) -> None:
    _std_scalars(sh, "a")
    st = sh.st
    act, alpha = st["act"], st["alpha"]
    p = inner(sh.p[k % 2])
    r = inner(sh.r)
    x_new = sh.x + alpha * p
    r_new = r - alpha * sh.wv
    sh.x.copy_(torch.where(act, x_new, sh.x))
    r.copy_(torch.where(act, r_new, r))
    rr = _dot(r_new, r_new)
    sh.own.copy_(torch.stack([rr, _dot(r_new * r_new, inner(sh.invd))
                              if sh.invd is not None else rr]))


def finish_plain(sh: Shard) -> None:
    if sh.cgs:
        _cgs_scalars(sh, first=False)
    else:
        _std_scalars(sh, "b")


def _cgs_scalars(sh: Shard, first: bool) -> None:
    """cgs_common.cuh's update on the plain scalars."""
    g = sh.gathered
    gamma, delta = _sum_column(g, 0).float(), _sum_column(g, 1).float()
    dev = sh.device
    one = torch.ones((), dtype=torch.float32, device=dev)
    if first:
        st = sh.st = {"gamma": gamma, "delta": delta, "gold": one,
                      "aold": one, "alpha": one, "beta": one * 0,
                      "act": torch.ones((), dtype=torch.bool, device=dev),
                      "iters": torch.zeros((), dtype=torch.int32, device=dev),
                      "k": one * 0}
        gold, aold = one, one
        run = st["act"]
    else:
        st = sh.st
        run = st["act"]
        gold, aold = st["gamma"], st["alpha"]
    it = st["k"] + 1.0
    on = run & (gamma > sh.tol2) & (it - 1.0 <= sh.max_iter)
    beta = torch.where(it == 1.0, one * 0,
                       gamma / torch.where(gold == 0, one, gold))
    denom = delta - beta * gamma / aold
    new = {"gold": gold, "aold": aold, "gamma": gamma, "delta": delta,
           "beta": beta, "alpha": gamma / torch.where(denom == 0, one, denom),
           "act": on, "iters": st["iters"] + on.to(torch.int32), "k": it}
    for key, v in new.items():
        st[key] = torch.where(run, v, st[key])


def cgs_step_plain(sh: Shard, k: int) -> None:
    _cgs_scalars(sh, first=k == 1)
    st = sh.st
    act, alpha, beta = st["act"], st["alpha"], st["beta"]
    src = (k + 1) % 2
    r, wo, so = sh.rws[3 * src:3 * src + 3]
    rn, wn, sn = sh.rws[3 * (1 - src):3 * (1 - src) + 3]
    s_new = wo + beta * so
    r_new = r - alpha * s_new
    p = inner(r) + beta * sh.pc
    x = sh.x + alpha * p
    w_new = halo_matvec(sh.C, r_new, _ktw(sh), sh.sf)
    sh.x.copy_(torch.where(act, x, sh.x))
    sh.pc.copy_(torch.where(act, p, sh.pc))
    for dst, v in ((rn, inner(r_new)), (wn, w_new), (sn, inner(s_new))):
        inner(dst).copy_(torch.where(act, v, inner(dst)))
    sh.own.copy_(torch.stack([_dot(inner(r_new), inner(r_new)),
                              _dot(w_new, inner(r_new))]))


# ---------------------------------------------------------------------------
# The CUDA kernels (csrc/shard_cg.cu)
# ---------------------------------------------------------------------------


@functools.lru_cache(maxsize=None)
def _library():
    """The built kernel library with its C signatures declared, once per
    process (every shard step of a solve calls it)."""
    from .. import native

    lib = native.load("shard_cg")
    vp, ci, cf = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    sigs = {
        "srps_shard_prologue": [vp] * 9 + [ci, ci, ci, cf] + [ci] * 3 + [vp],
        "srps_shard_cgs_w0": [vp] * 5 + [ci] * 5 + [vp],
        "srps_shard_step_a": [vp, ci] + [vp] * 10 + [ci, ci, ci, cf]
                             + [ci] * 5 + [vp],
        "srps_shard_step_b": [vp, ci] + [vp] * 8 + [ci] * 5 + [vp],
        "srps_shard_finish": [vp, ci, vp, cf, ci, ci, vp],
        "srps_shard_cgs_step": [vp, ci] + [vp] * 6 + [ci, vp, vp]
                               + [ci, ci, ci, cf] + [ci] * 4 + [vp],
        "srps_shard_cgs_finish": [vp, ci, vp, cf, ci, vp],
        "srps_shard_std": [vp] * 11 + [ci] * 4 + [cf, cf] + [ci] * 4
                          + [ctypes.POINTER(ci), vp],
        "srps_shard_cgs": [vp] * 9 + [ci] * 4 + [cf, cf] + [ci] * 3
                          + [ctypes.POINTER(ci), vp],
    }
    for name, args in sigs.items():
        fn = getattr(lib, name)
        fn.argtypes = args
        fn.restype = ci
    return lib


def _row0(t: torch.Tensor) -> int:
    """Address of row 0 of a halo plane (or of a stack's first plane)."""
    return t.data_ptr() + t.element_size() * t.shape[-1]


def _ptr(t: Optional[torch.Tensor]):
    """:func:`_row0` of a halo plane, or NULL for None."""
    return None if t is None else _row0(t)


def _launch(sh: Shard, name: str, *args) -> None:
    """``name`` of the library on the shard's device and current stream;
    raises on a CUDA error."""
    if sh.device.type != "cuda":
        raise ValueError(f"shard kernels run on cpu or cuda, not "
                         f"{sh.device}")
    with torch.cuda.device(sh.device):
        stream = torch.cuda.current_stream(sh.device).cuda_stream
        err = getattr(_library(), name)(*args, stream)
    if err != 0:
        raise RuntimeError(f"{name} failed: CUDA error {err}")


def prologue(sh: Shard) -> None:
    """Kernel 10: the C planes, x = x0, r0 and its sums (see module)."""
    if sh.device.type == "cpu":
        return prologue_plain(sh)
    r_plane = sh.rws if sh.cgs else sh.r
    _launch(sh, "srps_shard_prologue", _row0(sh.F), _row0(sh.R0),
            _row0(sh.x0), _ptr(sh.invd), sh.x.data_ptr(), _row0(r_plane),
            sh.C.data_ptr(), sh.part.data_ptr(), sh.own.data_ptr(), sh.h,
            sh.w, sh.sf, float(sh.lam), *sh.block, int(sh.invd is not None))
    tracing.launched("shard_cg prologue")


def cgs_w0(sh: Shard) -> None:
    """Kernel 10, CGS: w0 = M r0 and the sums gamma0, delta0 (r0's halo
    rows exchanged)."""
    if sh.device.type == "cpu":
        return cgs_w0_plain(sh)
    _launch(sh, "srps_shard_cgs_w0", sh.C.data_ptr(), _row0(sh.F),
            _row0(sh.rws), sh.part.data_ptr(), sh.own.data_ptr(), sh.h,
            sh.w, sh.sf, *sh.block)
    tracing.launched("shard_cg prologue")


def step_a(sh: Shard, k: int) -> None:
    """Kernel 12 at iteration k: the combine, then sweep A."""
    if sh.device.type == "cpu":
        return step_a_plain(sh, k)
    _launch(sh, "srps_shard_step_a", sh.gathered.data_ptr(),
            sh.gathered.shape[0], sh.scal.data_ptr(), sh.C.data_ptr(),
            _row0(sh.F), _row0(sh.r), _ptr(sh.invd), _row0(sh.p[(k + 1) % 2]),
            _row0(sh.p[k % 2]), sh.wv.data_ptr(), sh.part.data_ptr(),
            sh.own.data_ptr(), sh.h, sh.w, sh.sf, float(sh.tol2),
            int(sh.max_iter), *sh.block, int(sh.invd is not None),
            int(k == 1))
    tracing.launched("shard_cg sweep_a")


def step_b(sh: Shard, k: int) -> None:
    """Kernel 13 (14 under Jacobi) at iteration k: the combine of <p, w>,
    then sweep B."""
    if sh.device.type == "cpu":
        return step_b_plain(sh, k)
    jac = sh.invd is not None
    _launch(sh, "srps_shard_step_b", sh.gathered.data_ptr(),
            sh.gathered.shape[0], sh.scal.data_ptr(), sh.x.data_ptr(),
            _row0(sh.r), _row0(sh.p[k % 2]), sh.wv.data_ptr(), _ptr(sh.invd),
            sh.part.data_ptr(), sh.own.data_ptr(), sh.h, sh.w, *sh.block,
            int(jac))
    tracing.launched("shard_cg sweep_b")
    tracing.launched("shard_cg sweep_b jacobi", int(jac))


def cgs_step(sh: Shard, k: int) -> None:
    """Kernel 11 at iteration k: the combine, then one CGS sweep."""
    if sh.device.type == "cpu":
        return cgs_step_plain(sh, k)
    _launch(sh, "srps_shard_cgs_step", sh.gathered.data_ptr(),
            sh.gathered.shape[0], sh.scal.data_ptr(), sh.C.data_ptr(),
            _row0(sh.F), sh.x.data_ptr(), sh.pc.data_ptr(), _row0(sh.rws),
            (k + 1) % 2, sh.part.data_ptr(), sh.own.data_ptr(), sh.h, sh.w,
            sh.sf, float(sh.tol2), int(sh.max_iter), *sh.block, int(k == 1))
    tracing.launched("shard_cg cgs_sweep")


def finish(sh: Shard) -> None:
    """The last combine: the iteration count and the stop dot are final."""
    if sh.device.type == "cpu":
        return finish_plain(sh)
    g, n, scal = sh.gathered.data_ptr(), sh.gathered.shape[0], \
        sh.scal.data_ptr()
    if sh.cgs:
        _launch(sh, "srps_shard_cgs_finish", g, n, scal, float(sh.tol2),
                int(sh.max_iter))
    else:
        _launch(sh, "srps_shard_finish", g, n, scal, float(sh.tol2),
                int(sh.max_iter), int(sh.invd is not None))


# The steps a loop runs: the wrappers (kernel on a CUDA shard, plain version
# on a CPU shard), or the plain versions on any device.
KERNELS = SimpleNamespace(prologue=prologue, cgs_w0=cgs_w0, step_a=step_a,
                          step_b=step_b, cgs_step=cgs_step, finish=finish)
PLAIN = SimpleNamespace(prologue=prologue_plain, cgs_w0=cgs_w0_plain,
                        step_a=step_a_plain, step_b=step_b_plain,
                        cgs_step=cgs_step_plain, finish=finish_plain)
