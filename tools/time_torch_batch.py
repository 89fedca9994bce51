"""Solve times of the PyTorch port's single and multi-object paths on one
CUDA card, taken in turns within one process.

    python3 tools/time_torch_batch.py [--h 960] [--w 1280] [--n 20]
        [--sf 2] [--lanes 4] [--rounds 2] [--out FILE]

Prepares ``--lanes`` seeded Lambertian datasets on the card (in memory: no
file loading), then runs each path ``2 * --rounds`` times in the order
A B C ... C B A: the single fused solve of lane 0 with the standard CG,
the Chronopoulos-Gear CG and (where the package has it) the Jacobi
preconditioned CG, and all lanes in stream and in lockstep mode with each. Each time is the host clock around the solve, between two
device synchronisations. One more run of each path under
``torch.profiler`` gives the device's busy share of the solve. Prints one
line per path and a JSON summary (written to ``--out`` when given). Needs
a CUDA device; exits non-zero without one.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--h", type=int, default=960)
    ap.add_argument("--w", type=int, default=1280)
    ap.add_argument("--n", type=int, default=20)
    ap.add_argument("--sf", type=int, default=2)
    ap.add_argument("--lanes", type=int, default=4)
    ap.add_argument("--rounds", type=int, default=2)
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)

    import torch
    from torch.profiler import ProfilerActivity, profile

    from srmeetsps_cuda_tpu_torch.config import SolverConfig
    from srmeetsps_cuda_tpu_torch.device import resolve_device
    from srmeetsps_cuda_tpu_torch.io.synthetic import lambertian_dataset
    from srmeetsps_cuda_tpu_torch.models import srps
    from srmeetsps_cuda_tpu_torch.parallel import batched
    from srmeetsps_cuda_tpu_torch.runtime.solver import prepare

    dev = resolve_device()
    sf = args.sf
    pairs = [prepare(lambertian_dataset(args.h, args.w, sf, args.n, 3,
                                        seed=s)[0], SolverConfig(), dev)
             for s in range(args.lanes)]
    probs = [p for p, _ in pairs]
    states = [s for _, s in pairs]
    cfgs = {"pipe": SolverConfig(), "cgs": SolverConfig(cg_variant="cgs"),
            "jacobi": SolverConfig(jacobi_preconditioner=True)}

    def single(variant):
        final, _ = srps.solve_fused(states[0], probs[0], sf, cfgs[variant])
        return [final.iteration]

    def multi(mode, variant):
        finals, _ = batched.solve_batch(states, probs, sf, cfgs[variant],
                                        mode=mode)
        return [int(f.iteration) for f in finals]

    paths = {}
    for variant in cfgs:
        paths[f"single {variant}"] = lambda v=variant: single(v)
        for mode in ("stream", "lockstep"):
            paths[f"{mode} {variant}"] = lambda m=mode, v=variant: multi(m, v)

    def timed(fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        iters = fn()
        torch.cuda.synchronize()
        return time.perf_counter() - t0, iters

    for fn in paths.values():  # warm-up: kernel builds, allocator, cuBLAS
        fn()
    names = list(paths)
    order = (names + names[::-1]) * args.rounds
    times = {k: [] for k in names}
    iters = {}
    for k in order:
        dt, iters[k] = timed(paths[k])
        times[k].append(dt)
    busy = {}
    for k in names:
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            window, _ = timed(paths[k])
        busy_us = sum(e.time_range.elapsed_us() for e in prof.events()
                      if e.device_type == torch.autograd.DeviceType.CUDA)
        busy[k] = busy_us / 1e6 / window
    label = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True,
        text=True).stdout.strip()
    summary = {"device": label, "grid": [args.h, args.w], "n": args.n,
               "sf": sf, "lanes": args.lanes, "paths": {}}
    for k in names:
        ts = sorted(times[k])
        solves = len(iters[k])
        outer = sum(iters[k])
        summary["paths"][k] = {
            "seconds": times[k], "solves_per_s": [solves / t for t in ts],
            "ms_per_outer_iteration": [1e3 * t / outer for t in ts],
            "outer_iterations": iters[k], "device_busy_share": busy[k]}
        print(f"[{label}] {k:<14} {solves} solve(s), outer iterations "
              f"{iters[k]}: {ts[0]:.4f}-{ts[-1]:.4f} s, "
              f"{solves / ts[-1]:.2f}-{solves / ts[0]:.2f} solves/s, "
              f"{1e3 * ts[0] / outer:.3f}-{1e3 * ts[-1] / outer:.3f} "
              f"ms/outer-iter per lane, device busy {busy[k]:.3f}",
              flush=True)
    text = json.dumps(summary)
    if args.out:
        os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
        with open(args.out, "w") as f:
            f.write(text + "\n")
    print(text)
    return 0


if __name__ == "__main__":
    sys.exit(main())
