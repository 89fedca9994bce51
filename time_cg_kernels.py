#!/usr/bin/env python3
"""Milliseconds per CG iteration of the stencil, CGS, direct and row-shard
kernels on the card.

    python3 time_cg_kernels.py

Run from the root of a checkout (the script imports the checkout's
``chip_smoke`` and ``srmeetsps_cuda_tpu_torch``), so that one script can time
two checkouts in turns on one card: ``cd other && python3
/path/to/time_cg_kernels.py`` (a checkout whose kernels take no ``layout``
has no device-layout entries). Each entry is CUDA-event time over 5 solves
at cap 100 (101 CG iterations; 3 at 1088 x 1920 and 4K), on the seeded
depth operators of ``chip_smoke.stacked_lanes``, divided by 101. The direct
CG runs in its three forms: r0 in the kernel with the energy tracked
("direct"), the same with its in-sweep Jacobi PCG ("direct jacobi") and
given its residual ("direct host_r0"). The row-shard CG runs in its
three forms on 4 shards of the card at 1088 x 1920 through
``parallel.shard_cg.cg_sharded*`` on the checkout's default route (one
persistent launch per solve where the checkout has the persistent shard
kernels, else the host loop over the per-step kernels), divided by 101
launched iterations whatever the Jacobi form stops at
(``shard_cg_iterations``). Prints one JSON line with
the card's name and power limit.
"""

import json
import os
import sys

sys.path.insert(0, os.getcwd())


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("time_cg_kernels: no CUDA device available", file=sys.stderr)
        return 1
    import chip_smoke as cs
    from srmeetsps_cuda_tpu_torch import native
    from srmeetsps_cuda_tpu_torch.solve import cgs_cg as cg
    from srmeetsps_cuda_tpu_torch.solve import direct_cg as dc
    from srmeetsps_cuda_tpu_torch.solve import stencil_cg as sc

    native.build_all(["stencil_cg", "cgs_cg", "direct_cg", "shard_cg"])
    dev = torch.device("cuda")
    lanes2, stacked2 = cs.stacked_lanes(960, 1280, 2, range(4), dev)
    lanes4, _ = cs.stacked_lanes(960, 1280, 4, range(1), dev)
    ln, l4 = lanes2[0], lanes4[0]

    def std(args, **kw):
        return lambda: sc.stencil_cg(*args, lam=1.0, max_iter=100, **kw)

    def direct(args, invd, sf, form, **kw):
        """The direct CG in ``form`` on the lane inputs ``args`` (x0, op,
        gm, ktw, z0t, z0u)."""
        b = None
        if form == "direct host_r0":
            b = (sc.depth_rhs_fields(args[1], args[2], args[4], 1.0)
                 - dc.direct_matvec(args[0], args[1], args[2], args[3], 1.0,
                                    sf))
        return lambda: dc.direct_cg(
            *args, sf=sf, lam=1.0, max_iter=100, b=b,
            invd=invd if form == "direct jacobi" else None,
            with_energy=form != "direct host_r0", **kw)

    forms = ("direct", "direct jacobi", "direct host_r0")

    runs = {
        "stencil_cg 960x1280 sf 2": std(ln[:6], sf=2),
        "stencil_cg 960x1280 sf 2 block 32x16": std(ln[:6], sf=2,
                                                    block=(32, 16)),
        "stencil_cg scaled 960x1280 sf 2": std(ln[:6], sf=2, invd=ln[6]),
        "stencil_cg pcg 960x1280 sf 4": std(l4[:6], sf=4, invd=l4[6]),
        "stencil_cg B=4 960x1280 sf 2": std(stacked2[:6], sf=2),
        "cgs_cg 960x1280 sf 2": lambda: cg.cgs_cg(*ln[:5], sf=2, lam=1.0,
                                                  max_iter=100),
    }
    if "layout" in sc.stencil_cg.__code__.co_varnames:
        # The device layout forced where the on-chip one is chosen.
        runs.update({
            "stencil_cg 960x1280 sf 2 device layout": std(
                ln[:6], sf=2, layout="device"),
            "cgs_cg 960x1280 sf 2 device layout": lambda: cg.cgs_cg(
                *ln[:5], sf=2, lam=1.0, max_iter=100, layout="device")})
    for form in forms:
        runs[f"{form} 960x1280 sf 2"] = direct(ln[:6], ln[6], 2, form)
        runs[f"{form} B=4 960x1280 sf 2"] = direct(stacked2[:6], stacked2[6],
                                                   2, form)
    runs["direct 960x1280 sf 2 block 32x16"] = direct(
        ln[:6], ln[6], 2, "direct", block=(32, 16))
    out = {name: cs.cuda_ms(fn, 5) / 101 for name, fn in runs.items()}
    del lanes2, stacked2, lanes4, ln, l4
    for h, w in ((1088, 1920), (2176, 3840)):
        big = cs.stacked_lanes(h, w, 2, range(1), dev)[0][0]
        out[f"stencil_cg {h}x{w} sf 2"] = cs.cuda_ms(
            std(big[:6], sf=2), 3) / 101
        out[f"cgs_cg {h}x{w} sf 2"] = cs.cuda_ms(
            lambda: cg.cgs_cg(*big[:5], sf=2, lam=1.0, max_iter=100),
            3) / 101
        if h == 1088:
            shard_cg_iterations = shard_times(big, out)
        if h == 2176:
            for form in forms:
                out[f"{form} {h}x{w} sf 2"] = cs.cuda_ms(
                    direct(big[:6], big[6], 2, form), 3) / 101
    print(json.dumps({"ms_per_cg_iteration": out,
                      "shard_cg_iterations": shard_cg_iterations,
                      "card": cs.gpu_label()}))
    return 0


def shard_times(lane, out) -> dict:
    """The row-shard CG on 4 shards of the card in its three forms on the
    lane inputs (x0, op, gm, ktw, z0t, z0u, invd) of 1088 x 1920 sf 2:
    ms per CG iteration into ``out``; returns each form's iterations."""
    import chip_smoke as cs
    from srmeetsps_cuda_tpu_torch.parallel import shard_cg as scg

    mesh = scg.make_mesh_1d(4, "cuda")
    x0, op, gm, ktw, z0t, _, invd = lane
    kw = dict(sf=2, lam=1.0, max_iter=100)
    runs = {"std": lambda: scg.cg_sharded(mesh, x0, op, gm, ktw, z0t, **kw),
            "cgs": lambda: scg.cg_sharded_cgs(mesh, x0, op, gm, ktw, z0t,
                                              **kw),
            "jacobi": lambda: scg.cg_sharded_jacobi(mesh, x0, invd, op, gm,
                                                    ktw, z0t, **kw)}
    iters = {}
    for form, fn in runs.items():
        out[f"shard_cg {form} 4 shards 1088x1920 sf 2"] = cs.cuda_ms(
            fn, 3) / 101
        iters[form] = int(fn()[1])
    return iters


if __name__ == "__main__":
    sys.exit(main())
