"""The tiles of the persistent stencil, CGS and direct kernels
(``solve/stencil_cg.py::tile_plan``, ``csrc/persistent.cuh``).

The kernels run only on the card (``chip_smoke.py`` phases 3-3f, which
also hold the layout and the CTA count that the C entry chooses from the
card's occupancy); what surrounds them is held here: the tiles cover every
pixel of every lane once, each has one owner and one slot whatever the
CTA count, they keep sf = 4 tile sums inside one tile, they do not depend
on the lane count, and a CG whose dots are taken as the kernels take them
(float32 per tile, the tiles added in float64) is the plain CG to f32
roundoff, while a plan that drops or repeats a tile's pixels is not.
"""

import pytest
import torch

import chip_smoke
from srmeetsps_cuda_tpu_torch.solve import stencil_cg as sc

CPU = torch.device("cpu")
# (h, w, block): the main path's shapes, grids that are not multiples of
# the tile, and blocks that are not multiples of 4 or of a warp.
PLANS = [(960, 1280, (256, 4)), (960, 1280, (32, 16)), (37, 45, (32, 16)),
         (50, 30, (30, 3)), (12, 20, (1, 1)), (1088, 1920, (256, 4))]
# CTA counts: one CTA, fewer CTAs than tiles, one and two resident per SM
# of an H100 (132 SMs).
CTAS = [1, 7, 132, 264]


def tiled_dot(a: torch.Tensor, b: torch.Tensor, plan) -> torch.Tensor:
    """``<a, b>`` per lane as the persistent kernels take it: a float32
    sum over each tile of ``plan``, then the tiles' sums added in float64
    and rounded to float32."""
    return _tile_sums(a, b, plan).double().sum(dim=(-2, -1)).float()


def _tile_sums(a, b, plan):
    """The float32 sum of a * b over each tile of ``plan``, (..., tiles_y,
    tiles_x)."""
    h, w = a.shape[-2:]
    ph, pw = plan.tiles_y * plan.th, plan.tiles_x * plan.tw
    v = torch.nn.functional.pad(a * b, (0, pw - w, 0, ph - h))
    v = v.reshape(*v.shape[:-2], plan.tiles_y, plan.th, plan.tiles_x, plan.tw)
    return v.sum(dim=(-3, -1), dtype=torch.float32)


@pytest.mark.parametrize("h,w,block", PLANS)
def test_every_pixel_of_every_lane_in_exactly_one_tile(h, w, block):
    plan = sc.tile_plan(h, w, block)
    count = torch.zeros(h, w, dtype=torch.int32)
    for t, i0, j0, rows, cols in plan.tile_rects():
        assert rows > 0 and cols > 0, t
        count[i0:i0 + rows, j0:j0 + cols] += 1
    assert bool((count == 1).all())


@pytest.mark.parametrize("ctas", CTAS)
@pytest.mark.parametrize("h,w,block", PLANS)
def test_every_tile_has_one_owner_and_one_slot(h, w, block, ctas):
    """Tile t of lane l goes to CTA (l T + t) mod G, slot (l T + t) // G
    (``persist::tile_of``): no two tiles share an owner's slot, each CTA
    owns ``Geo::count`` tiles, and ``set_ctas``'s slot count holds them."""
    B = 3
    plan = sc.tile_plan(h, w, block)
    n = B * plan.tiles
    owners = [plan.owner(lane, t, ctas) for lane in range(B)
              for t in range(plan.tiles)]
    assert len(set(owners)) == n
    slots = -(-n // ctas)
    per_cta = [0] * ctas
    for c, s in owners:
        assert 0 <= c < ctas and 0 <= s < slots
        per_cta[c] += 1
    assert per_cta == [(n - 1 - c) // ctas + 1 if c < n else 0
                       for c in range(ctas)]


@pytest.mark.parametrize("h,w,block", PLANS)
def test_tile_edges_are_multiples_of_4(h, w, block):
    plan = sc.tile_plan(h, w, block)
    bx, by = block
    assert plan.th % 4 == 0 and plan.tw % 4 == 0
    assert by <= plan.th < by + 4 and bx <= plan.tw < bx + 4
    for _, i0, j0, _, _ in plan.tile_rects():
        assert i0 % 4 == 0 and j0 % 4 == 0


@pytest.mark.parametrize("block", [(256, 4), (32, 16), (30, 3)])
def test_a_lanes_dots_are_its_solo_dots(block):
    """The tiles depend only on (h, w, block), so a lane's per-tile
    partials, and its dots, are bit for bit those of its solo launch."""
    g = torch.Generator().manual_seed(1)
    a = torch.randn(7, 100, 132, generator=g)
    b = torch.randn(7, 100, 132, generator=g)
    plan = sc.tile_plan(100, 132, block)
    lanes = tiled_dot(a, b, plan)
    for lane in range(7):
        assert torch.equal(lanes[lane], tiled_dot(a[lane], b[lane], plan))


@pytest.mark.parametrize("block", [(1025, 1), (64, 17), (0, 4), (4, -1)])
def test_block_outside_1_to_1024_threads_raises(block):
    with pytest.raises(ValueError, match="1..1024 threads"):
        sc.tile_plan(960, 1280, block)


@pytest.mark.parametrize("block", [(32, 16), (30, 3), (1, 1)])
def test_tiled_dot_is_the_exact_dot(block):
    g = torch.Generator().manual_seed(0)
    a = torch.randn(3, 37, 45, generator=g)
    b = torch.randn(3, 37, 45, generator=g)
    want = (a.double() * b.double()).sum(dim=(-2, -1))
    got = tiled_dot(a, b, sc.tile_plan(37, 45, block))
    assert torch.allclose(got.double(), want, rtol=1e-5, atol=1e-4)


def _tile_fault(plan, t, times):
    """:func:`tiled_dot` with tile t's partial taken ``times`` times (0:
    its pixels dropped, 2: repeated)."""
    def dot(a, b):
        per_tile = _tile_sums(a, b, plan)
        per_tile[..., t // plan.tiles_x, t % plan.tiles_x] *= times
        return per_tile.double().sum(dim=(-2, -1)).float()
    return dot


# The update x - x0 (relative RMS) and <r, r> (relative gap) of the tiled
# dots' CG against the plain one: after 2 iterations both stay under 1e-6,
# after 12 the f32 drift of the unconverged CG reaches 1.7e-4 / 2.7e-3 on
# a 40 x 36 grid; a dropped or repeated middle tile lands at 1.7e-2 / 7e-2
# or more after 2 iterations.
TILED_BOUND = {2: (1e-5, 1e-5), 12: (1e-3, 1e-2)}


@pytest.mark.parametrize("block", [(256, 4), (32, 16)])
@pytest.mark.parametrize("sf", [2, 4])
def test_cg_with_tiled_dots_matches_plain_cg(sf, block, monkeypatch):
    torch.set_num_threads(1)
    _, (x0, op, gm, ktw, z0t, _, _) = chip_smoke.stacked_lanes(
        48, 40, sf, range(2), CPU)
    C = sc.build_c_planes(op, gm, ktw, 1.0, sf)
    r0 = (sc.depth_rhs_fields(op, gm, z0t, 1.0)
          - sc.stencil_matvec(C, x0, ktw, sf))
    plain_dot = sc.lane_dot

    def mv(v):
        return sc.stencil_matvec(C, v, ktw, sf)

    def gaps(cap, dot):
        monkeypatch.setattr(sc, "lane_dot", plain_dot)
        px, pk, prr, _, _ = sc.cg_loop(x0, r0, mv, tol=1e-9, max_iter=cap)
        monkeypatch.setattr(sc, "lane_dot", dot)
        x, k, rr, _, _ = sc.cg_loop(x0, r0, mv, tol=1e-9, max_iter=cap)
        assert torch.equal(k, pk)
        upd = max(chip_smoke.rel_rms(x[b] - x0[b], px[b] - x0[b])
                  for b in range(2))
        return upd, float(((rr - prr).abs() / prr.abs()).max())

    plan = sc.tile_plan(48, 40, block)
    for cap, (b_upd, b_gap) in TILED_BOUND.items():
        upd, gap = gaps(cap, lambda a, b: tiled_dot(a, b, plan))
        assert upd <= b_upd and gap <= b_gap, (cap, upd, gap)
    for times in (0, 2):
        upd, gap = gaps(2, _tile_fault(plan, plan.tiles // 2, times))
        assert upd > 100 * TILED_BOUND[2][0] and \
            gap > 100 * TILED_BOUND[2][1], (times, upd, gap)
