"""The persistent row-shard CG (``parallel/shard_cg.py::persistent``,
``csrc/shard_cg.cu``'s ``shard_std_kernel`` and ``shard_cgs_kernel``).

The kernels run only on the card (``chip_smoke.py`` phases 3g and 4j hold
them to the plain per-shard steps); what surrounds them is held here:

* their sum order: a sharded CG whose dots are taken as the kernels take
  them (float32 per tile of ``tile_plan(hb, w, block)``, the tiles added in
  float64 per shard, the shards added in shard order) is the plain sharded
  CG to float32 roundoff, while a plan that drops or repeats one shard's
  tile is not;
* their halo rule: the tile that writes a shard's first or last row writes
  it into the adjacent shard's halo row, which gives the planes
  ``exchange_halos`` gives, zero rows at the global top and bottom
  included;
* the route a mesh takes, and the stacked layout it runs on.
"""

import functools

import pytest
import torch

import chip_smoke
from test_torch_persistent_plan import TILED_BOUND, _tile_sums
from srmeetsps_cuda_tpu_torch.parallel import shard_cg as scg
from srmeetsps_cuda_tpu_torch.parallel import shard_kernels as sk
from srmeetsps_cuda_tpu_torch.solve import stencil_cg as sc

CPU = torch.device("cpu")
BLOCKS = [(256, 4), (32, 16), (30, 3)]
H, W = 48, 40


@functools.lru_cache(maxsize=None)
def _lane(sf):
    """One seeded depth-CG problem of H x W: (x0, op, gm, ktw, z0t)."""
    torch.set_num_threads(1)
    lanes, _ = chip_smoke.stacked_lanes(H, W, sf, range(1), CPU)
    return lanes[0][:5]


def _shard_index(s) -> int:
    """Shard s's place in its one-device mesh (its views into the stacks)."""
    return (s.x.data_ptr() - s.stack.x.data_ptr()) // (s.x.numel() * 4)


def _kernel_order_steps(plan, fault=None):
    """``(steps, dot)``: the plain per-shard steps with every dot taken as
    the persistent kernels take it, float32 per tile of ``plan`` and the
    tiles in float64 (the loop adds the shards in shard order). ``fault``
    = (shard, tile, times): that shard's tile partial taken ``times``
    times (0: dropped, 2: repeated)."""
    cur = {}

    def dot(a, b):
        per_tile = _tile_sums(a, b, plan)
        if fault is not None and cur["shard"] == fault[0]:
            t = fault[1]
            per_tile[t // plan.tiles_x, t % plan.tiles_x] *= fault[2]
        return per_tile.double().sum()

    def at_shard(step):
        def run(s, *k):
            cur["shard"] = _shard_index(s)
            return step(s, *k)
        return run

    steps = type(sk.PLAIN)(**{k: at_shard(v)
                              for k, v in vars(sk.PLAIN).items()})
    return steps, dot


def _gaps(sf, n, block, cap, monkeypatch, fault=None):
    """The kernel-order CG against the plain sharded CG on n shards: the
    update x - x0 (relative RMS) and <r, r> (relative gap); the iteration
    counts must be equal."""
    x0, op, gm, ktw, z0t = _lane(sf)
    mesh = scg.make_mesh_1d(n, CPU)
    run = functools.partial(scg.cg_sharded, mesh, x0, op, gm, ktw, z0t,
                            sf=sf, lam=1.0, max_iter=cap, block=block,
                            plain=True)
    px, pk, pr = run()
    plan = sc.tile_plan(H // n, W, block)
    steps, dot = _kernel_order_steps(plan, fault)
    with monkeypatch.context() as m:
        m.setattr(sk, "PLAIN", steps)
        m.setattr(sk, "_dot", dot)
        x, k, r = run()
    assert int(k) == int(pk)
    return (chip_smoke.rel_rms(x - x0, px - x0),
            abs(float(r) - float(pr)) / abs(float(pr)))


@pytest.mark.parametrize("block", BLOCKS)
@pytest.mark.parametrize("sf", [2, 4])
@pytest.mark.parametrize("n", [2, 4])
def test_cg_with_kernel_sum_order_matches_plain_sharded_cg(n, sf, block,
                                                          monkeypatch):
    for cap, (b_upd, b_gap) in TILED_BOUND.items():
        upd, gap = _gaps(sf, n, block, cap, monkeypatch)
        assert upd <= b_upd and gap <= b_gap, (cap, upd, gap)


@pytest.mark.parametrize("times", [0, 2])
@pytest.mark.parametrize("block", [(32, 16), (30, 3)])
@pytest.mark.parametrize("n", [2, 4])
def test_a_shards_dropped_or_repeated_tile_breaks_the_bound(n, block, times,
                                                           monkeypatch):
    """The faulty tile lies at the grid's centre, in the last tile row of
    shard n / 2 - 1: a tile outside the object's mask adds zeros, and
    dropping it changes nothing."""
    plan = sc.tile_plan(H // n, W, block)
    tile = (plan.tiles_y - 1) * plan.tiles_x + plan.tiles_x // 2
    upd, gap = _gaps(2, n, block, 2, monkeypatch,
                     fault=(n // 2 - 1, tile, times))
    assert upd > 100 * TILED_BOUND[2][0] and \
        gap > 100 * TILED_BOUND[2][1], (upd, gap)


def _owner_writes(planes, plan):
    """The kernels' halo rule on a stack of halo planes (N, ..., hb + 2,
    w), in place: each tile of ``plan`` that holds a shard's first or last
    row writes its columns of that row into the adjacent shard's halo row
    (none at the global top and bottom)."""
    n, hb = planes.shape[0], plan.h
    for l in range(n):
        for _, i0, j0, rows, cols in plan.tile_rects():
            c = slice(j0, j0 + cols)
            if i0 == 0 and l > 0:
                planes[l - 1, ..., hb + 1, c] = planes[l, ..., 1, c]
            if i0 + rows == hb and l < n - 1:
                planes[l + 1, ..., 0, c] = planes[l, ..., hb, c]


@pytest.mark.parametrize("block", BLOCKS)
@pytest.mark.parametrize("lead", [(), (3,)], ids=["r", "rws"])
@pytest.mark.parametrize("n", [2, 4])
def test_owner_halo_writes_equal_the_exchange(n, lead, block):
    """r, and the (r, w, s) set a CGS sweep writes: the owner's writes give
    the planes exchange_halos gives, bit for bit, from halo rows that held
    garbage (NaN) between the shards and zeros at the global ends."""
    hb = 12
    g = torch.Generator().manual_seed(n)
    planes = torch.randn((n, *lead, hb + 2, 42), generator=g)
    planes[1:, ..., 0, :] = float("nan")
    planes[:-1, ..., -1, :] = float("nan")
    planes[0, ..., 0, :] = 0
    planes[-1, ..., -1, :] = 0
    want = planes.clone()
    scg.exchange_halos(want.unbind(0))
    _owner_writes(planes, sc.tile_plan(hb, 42, block))
    assert torch.equal(planes, want)
    assert not planes[0, ..., 0, :].any() and not planes[-1, ..., -1, :].any()


CUDA0 = torch.device("cuda", 0)


@pytest.mark.parametrize("devices,kw,route", [
    ([CUDA0] * 4, {}, "persistent"),
    (["cuda"] * 4, {}, "persistent"),
    ([CUDA0], {}, "persistent"),
    ([torch.device("cuda", i) for i in range(4)], {}, "steps"),
    ([CUDA0, torch.device("cuda", 1)] * 2, {}, "steps"),
    ([CUDA0] * 4, {"route": "steps"}, "steps"),
    ([CUDA0] * 4, {"plain": True}, "plain"),
    ([CPU] * 4, {}, "plain"),
    ([CPU] * 4, {"route": "steps"}, "steps"),
    ([torch.device("meta")] * 2, {}, "steps"),
], ids=["cuda0x4", "cudax4", "cuda0x1", "4 cards", "2 cards x2",
        "steps asked", "plain asked", "cpu", "cpu steps", "meta"])
def test_route_of_a_mesh(devices, kw, route):
    assert scg.choose_route(devices, **kw) == route


def test_unknown_route_raises():
    with pytest.raises(ValueError, match="route"):
        scg.choose_route([CPU], route="persistent")


@pytest.mark.parametrize("cgs,jacobi", [(False, False), (False, True),
                                        (True, False)],
                         ids=["std", "jacobi", "cgs"])
def test_one_device_mesh_runs_on_stacks(cgs, jacobi):
    """On a one-device mesh every shard's operands and state are views of
    (N, ...) stacks (what the persistent kernels read), with the halo rows
    of the per-shard allocation; the persistent wrapper's plain version on
    them is the plain route."""
    x0, op, gm, ktw, z0t = _lane(2)
    invd = torch.rand(H, W) + 0.5 if jacobi else None
    args = (x0, op, gm, ktw, z0t)
    kw = dict(sf=2, lam=1.0, tol=1e-9, max_iter=4, cgs=cgs, invd=invd,
              block=(32, 16))
    stacked = scg._shards(scg.make_mesh_1d(4, CPU), *args, **kw)
    apart = scg._shards(scg.make_mesh_1d(4, [CPU] * 3 + ["cpu:0"]), *args,
                        **kw)
    assert stacked[0].stack is not None and apart[0].stack is None
    planes = ("F", "R0", "x0") + (("invd",) if jacobi else ()) \
        + (("rws", "pc") if cgs else ("r", "p", "wv"))
    for i, (s, t) in enumerate(zip(stacked, apart)):
        assert _shard_index(s) == i
        for name in planes:
            a, b = getattr(s, name), getattr(t, name)
            assert a.data_ptr() == getattr(s.stack, name)[i].data_ptr()
            assert torch.equal(a, b), name
    scg.persistent(stacked)
    scg._steps(apart, sk.PLAIN)
    assert all(torch.equal(a, b) for a, b in
               zip(scg._finish(stacked, x0), scg._finish(apart, x0)))
