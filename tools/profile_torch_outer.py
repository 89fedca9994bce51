"""Where the PyTorch port's outer iteration spends its time on one CUDA card.

    python3 tools/profile_torch_outer.py [--h 960] [--w 1280] [--n 20]
        [--sf 2] [--iters 3] [--out FILE]

Prepares a seeded Lambertian dataset on the card, runs one outer iteration
to warm up, then runs ``--iters`` more phase by phase (lighting,
s-moments, albedo, depth operator, depth CG, normals) with a synchronise
after each phase for its wall time, under ``torch.profiler`` for the
device time by kernel and the device's busy share of the window. Prints a summary and the kernel
table, and writes the table to ``--out`` when given. Needs a CUDA device;
exits non-zero without one.
"""

from __future__ import annotations

import argparse
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--h", type=int, default=960)
    ap.add_argument("--w", type=int, default=1280)
    ap.add_argument("--n", type=int, default=20)
    ap.add_argument("--sf", type=int, default=2)
    ap.add_argument("--iters", type=int, default=3)
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)

    import torch
    from torch.profiler import ProfilerActivity, profile, record_function

    from srmeetsps_cuda_tpu_torch.config import SolverConfig
    from srmeetsps_cuda_tpu_torch.device import resolve_device
    from srmeetsps_cuda_tpu_torch.io.synthetic import lambertian_dataset
    from srmeetsps_cuda_tpu_torch.models import srps
    from srmeetsps_cuda_tpu_torch.runtime.solver import prepare
    from srmeetsps_cuda_tpu_torch.solve.stencil_cg import stencil_cg

    dev = resolve_device()
    cfg = SolverConfig()
    data, _ = lambertian_dataset(args.h, args.w, args.sf, args.n, 3)
    prob, st = prepare(data, cfg, dev)
    sf = args.sf
    phases = {k: 0.0 for k in ("lighting", "moments", "albedo",
                               "depth_operator", "depth_cg", "normals")}

    def step(st, record: bool):
        def timed(name, fn):
            t0 = time.perf_counter()
            with record_function(name):
                out = fn()
            torch.cuda.synchronize()
            if record:
                phases[name] += time.perf_counter() - t0
            return out

        s = timed("lighting", lambda: srps.estimate_lighting(
            prob, st.rho, st.N, st.s))
        mom = timed("moments", lambda: srps.s_moments(prob, s))
        rho = timed("albedo", lambda: srps.estimate_albedo(
            prob, mom, st.N, st.rho))
        op = timed("depth_operator", lambda: srps.build_depth_operator(
            prob, mom, rho, st.dz, cfg.lam))
        x, iters, _, e = timed("depth_cg", lambda: stencil_cg(
            st.z, op, prob.gm, prob.ktw, prob.z0t, prob.z0u, sf=sf,
            lam=cfg.lam, tol=cfg.cg_tol, max_iter=cfg.cg_max_iter))
        z = x * prob.mask
        N, dz = timed("normals", lambda: srps.depth_normals(z, prob))
        return srps.SRPSState(z=z, rho=rho, s=s, N=N, dz=dz,
                              energy=e + cfg.lam * op.const,
                              last_energy=st.energy,
                              iteration=st.iteration + 1, cg_iters=iters)

    st = step(st, record=False)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(args.iters):
            st = step(st, record=True)
        torch.cuda.synchronize()
        window = time.perf_counter() - t0
    # Device events minus the phase annotations, which the profiler also
    # places on the device timeline.
    busy_us = sum(e.time_range.elapsed_us() for e in prof.events()
                  if e.device_type == torch.autograd.DeviceType.CUDA
                  and e.name not in phases)
    label = torch.cuda.get_device_name(0)
    print(f"{label}: {args.h}x{args.w} n={args.n} sf={sf}, {args.iters} "
          f"outer iterations in {window * 1e3:.3f} ms "
          f"({window * 1e3 / args.iters:.3f} ms/outer-iter); device busy "
          f"{busy_us / 1e3:.3f} ms = {busy_us / 1e6 / window:.3f} of the "
          "window")
    for k, v in phases.items():
        print(f"  {k:<15} {v * 1e3 / args.iters:9.3f} ms/outer-iter (wall, "
              "synchronised)")
    table = prof.key_averages().table(sort_by="self_cuda_time_total",
                                      row_limit=25)
    if args.out:
        os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
        with open(args.out, "w") as f:
            f.write(table)
    print(table)
    return 0


if __name__ == "__main__":
    sys.exit(main())
