"""Whether ``chip_smoke.py`` phase 3c would catch a faulty CGS kernel.

    python3 tools/cgs_fault_check.py

Runs the plain Chronopoulos-Gear CG (``solve/cgs_cg.py``) on the CPU at
small sizes, next to copies of it with one fault each, on the inputs phase
3c uses (the depth operator of a seeded Lambertian dataset after a first
lighting and albedo update; the main path's warm start and a cold start
x0 = 0), and measures each copy as phase 3c measures the kernel: the
relative RMS of the update x - x0 and the relative gap of gamma = <r, r>
after 2 and 12 iterations, against the bounds ``CGS_UPD`` and
``CGS_GAMMA``. Prints one line per fault and grid with its largest
measures and whether a bound caught it; exits non-zero if a fault passes
every bound on some grid.
"""

from __future__ import annotations

import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

FAULTS = ("x0 returned", "beta = 0", "alpha without its beta term",
          "alpha x 0.9", "s without beta s", "p from r'")


def faulty_cgs(fault, x0, op, gm, ktw, z0t, *, sf, lam, max_iter):
    """``cgs_cg_plain`` of one problem run to its cap, with ``fault``."""
    import torch

    from srmeetsps_cuda_tpu_torch.solve.stencil_cg import (
        build_c_planes, depth_rhs_fields, lane_dot, stencil_matvec)

    C = build_c_planes(op, gm, ktw, lam, sf)

    def mv(v):
        return stencil_matvec(C, v, ktw, sf)

    x = x0
    r = depth_rhs_fields(op, gm, z0t, lam) - mv(x0)
    w = mv(r)
    gamma, delta = lane_dot(r, r), lane_dot(w, r)
    gamma_old = alpha_old = torch.ones_like(gamma)
    s = p = torch.zeros_like(x0)
    for k in range(1, max_iter + 2):
        beta = (torch.zeros_like(gamma) if k == 1 or fault == "beta = 0"
                else gamma / gamma_old)
        denom = delta - beta * gamma / alpha_old
        if fault == "alpha without its beta term":
            denom = delta
        alpha = gamma / denom * (0.9 if fault == "alpha x 0.9" else 1.0)
        s = w if fault == "s without beta s" else w + beta * s
        r_new = r - alpha * s
        p = (r_new if fault == "p from r'" else r) + beta * p
        x = x + alpha * p
        w = mv(r_new)
        gamma_old, alpha_old = gamma, alpha
        gamma, delta = lane_dot(r_new, r_new), lane_dot(w, r_new)
        r = r_new
    return (x0 if fault == "x0 returned" else x), gamma


def main() -> int:
    import torch

    import chip_smoke as cs
    from srmeetsps_cuda_tpu_torch.io.synthetic import lambertian_dataset
    from srmeetsps_cuda_tpu_torch.solve.cgs_cg import cgs_cg_plain

    cpu = torch.device("cpu")
    passed = []
    for h, w, sf in ((240, 320, 2), (120, 160, 1), (240, 320, 4)):
        data, _ = lambertian_dataset(h, w, sf, n=8, c=3, seed=sf)
        prob, st, op = cs.depth_operator(data, cpu)
        warm = (st.z, op, prob.gm, prob.ktw, prob.z0t)
        starts = {"warm": warm, "cold": (torch.zeros_like(st.z),) + warm[1:]}
        for fault in FAULTS:
            worst, caught = {}, []
            for start, args in starts.items():
                for cap in (2, 12):
                    px, _, pg = cgs_cg_plain(*args, sf=sf, lam=1.0,
                                             max_iter=cap)
                    x, g = faulty_cgs(fault, *args, sf=sf, lam=1.0,
                                      max_iter=cap)
                    upd = cs.rel_rms(x - args[0], px - args[0])
                    grel = abs(float(g) - float(pg)) / abs(float(pg))
                    worst[start, "update"] = max(worst.get((start, "update"),
                                                           0.0), upd)
                    worst[start, "gamma"] = max(worst.get((start, "gamma"),
                                                          0.0), grel)
                    if upd > cs.CGS_UPD[start][cap]:
                        caught.append(f"{start} update cap {cap}")
                    if grel > cs.CGS_GAMMA[start][cap]:
                        caught.append(f"{start} gamma cap {cap}")
            if not caught:
                passed.append((fault, h, w, sf))
            print(f"{h}x{w} sf={sf} {fault}: "
                  + ", ".join(f"{a} {m} {v:.2e}"
                              for (a, m), v in worst.items())
                  + f"; caught by {', '.join(caught) or 'NOTHING'}",
                  flush=True)
    if passed:
        print(f"faults that pass every bound: {passed}")
        return 1
    print("every fault is caught on every grid")
    return 0


if __name__ == "__main__":
    sys.exit(main())
