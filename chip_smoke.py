#!/usr/bin/env python3
"""Smoke test of the PyTorch + CUDA port on one CUDA card.

    python3 chip_smoke.py

Phases (any failed check raises and the script exits non-zero; nothing
falls back to the CPU or to a plain version):

1. environment: the card's name and power limit, torch and CUDA versions;
2. build: the CUDA kernels from ``srmeetsps_cuda_tpu_torch/csrc``, one
   ``nvcc`` per source, all at once;
3. each kernel against its plain PyTorch version on the card, on depth
   operators built by the port from a seeded Lambertian dataset: the C
   planes, iteration counts, x after 2 and 12 iterations and the tracked
   energy, with the tolerances of tests/test_torch_stencil_cg.py, and the
   time per CG iteration of both;
3b. the lane-batched stencil CG (B = 4 seeds at 960 x 1280, sf = 2): each
   lane bit for bit its B = 1 launch, the batch against the plain version,
   ms per CG iteration of the batch and of four solo launches;
3c. the Chronopoulos-Gear CG kernel against its plain version on the three
   grids of phase 3, from the main path's warm start and from a cold start
   x0 = 0, at two thread-block shapes: iteration counts, the update x - x0
   and gamma = <r, r> after 2 and 12 iterations (bounds at CGS_UPD and
   CGS_GAMMA), B = 4 lanes bit for bit their solo launches;
4. the main path through the CLI entry point on a 960 x 1280, n = 20, c = 3,
   sf = 2 dataset written as a MAT v5 file: finite energies, the reference's
   stopping rule, a finite depth, every depth CG through the kernel; and the
   whole solve on a small input against the same solve on the CPU;
4b. the multi-object CLI (comma --dsloc, 4 lanes, one of them 944 x 1264
   and padded): stream lanes equal their solo CLI solves; lockstep makes
   one lane-batched launch per outer iteration and equals stream;
4c. ``--cg-variant cgs`` on the phase-4 dataset: every depth CG through the
   CGS kernel, at the cap, the stopping rule held, the energy trace within
   phase 3's energy bound of the standard run's; then the 4b run with
   ``--cg-variant cgs``: one lane-batched CGS launch per lockstep outer
   iteration, lockstep lanes bit for bit the stream lanes, and the lanes of
   the phase-4 file bit for bit its single CGS solve;
4d. ``--serve``: two single requests and one comma request answer with the
   iterations and energies of phases 4 and 4b.

The line before the last is a JSON object with one entry per kernel (its
times per CG iteration at 960 x 1280, sf = 2, and the least time the card
could take for the same work); the last line is
``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import contextlib
import io
import itertools
import json
import math
import os
import subprocess
import sys
import tempfile
import time

ROOT = os.path.dirname(os.path.abspath(__file__))

# Tolerances of tests/test_torch_stencil_cg.py (the JAX suite's own bounds).
X_TOL = {2: 5e-5, 12: 3e-2}
E_RTOL = 5e-4
# CGS against its plain version, after 2 and 12 iterations. From the main
# path's warm start x carries ~1000 mm while a first solve moves it by
# 0.01-0.08 mm, so x is compared as its update x - x0 (relative RMS), which
# only catches gross faults (x0 returned: 1.0); from a cold start x0 = 0
# all of x is the CG's, and it is held tight. gamma = <r, r> is compared as
# a relative gap. The largest gaps this phase measured on an H100 (4 seeds,
# both thread-block shapes, the three grids; PERF.md): update warm 9.7e-2
# (sf 1; 1.8e-2 at sf 2), cold 2.6e-7; gamma warm 1.7e-2, cold 3.6e-5
# after 2 and 7.2e-4 after 12 iterations. x0 returned unchanged, or a wrong
# alpha, beta, s or p recurrence, fails these bounds on every grid
# (tools/cgs_fault_check.py, with faulty copies of the plain version).
CGS_UPD = {"warm": {2: 0.25, 12: 0.25}, "cold": {2: 1e-5, 12: 1e-5}}
CGS_GAMMA = {"warm": {2: 0.1, 12: 0.1}, "cold": {2: 5e-4, 12: 1e-2}}

# The H100 SXM's published peaks (NVIDIA's data sheet, dense, 700 W).
HBM_BYTES_PER_S = 3.35e12
F32_FLOPS_PER_S = 67e12
# Flops per pixel counted from the kernels' arithmetic, each value computed
# once: the prologue (C planes ~70, rhs ~15, M x0 17, energy ~45 / w0 17 and
# two dots) and one CG iteration (stencil 17, vector updates and dots 10 or
# 12; the sf = 4 tile sum adds 2).
STENCIL_FLOPS = {"prologue": 150, "iteration": 27}
CGS_FLOPS = {"prologue": 125, "iteration": 29}
# f32 planes each function must read once and write once: F (11), R0 (4),
# Z0U (2, stencil only) and x0 in, x out.
STENCIL_PLANES, CGS_PLANES = 19, 17
# f32 planes one iteration of the kernels' design streams (the bound PERF.md
# quotes per CG iteration): 9 C planes and 10 state planes read or written.
ITERATION_PLANES = 19


def bound(hw: int, lanes: int, iters: int, planes: int, flops: dict,
          sf: int):
    """``(ms, "bytes" or "operations", stream_ms)`` per CG iteration: the
    least time the card could take for the function (inputs read once,
    outputs written once; the operations of the iterations this run's data
    needed), and the per-iteration streaming time of the kernels' design."""
    t_bytes = planes * 4 * hw * lanes / HBM_BYTES_PER_S
    per_iter = flops["iteration"] + (2 if sf == 4 else 0)
    t_ops = hw * lanes * (flops["prologue"] + iters * per_iter) \
        / F32_FLOPS_PER_S
    ms = 1e3 * max(t_bytes, t_ops) / iters
    stream = 1e3 * ITERATION_PLANES * 4 * hw * lanes / HBM_BYTES_PER_S
    return ms, "bytes" if t_bytes >= t_ops else "operations", stream


def gpu_label() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True)
    return out.stdout.strip().splitlines()[0]


def depth_operator(data, device):
    """The port's depth operator after the first lighting and albedo
    updates of a solve on ``data``, with the state it warm-starts from."""
    from srmeetsps_cuda_tpu_torch.config import SolverConfig
    from srmeetsps_cuda_tpu_torch.models import srps
    from srmeetsps_cuda_tpu_torch.runtime.solver import prepare

    prob, st = prepare(data, SolverConfig(), device)
    s = srps.estimate_lighting(prob, st.rho, st.N, st.s)
    mom = srps.s_moments(prob, s)
    rho = srps.estimate_albedo(prob, mom, st.N, st.rho)
    return prob, st, srps.build_depth_operator(prob, mom, rho, st.dz, 1.0)


def cuda_ms(fn, reps: int) -> float:
    """Milliseconds per call on the card, from CUDA events, after a warm-up."""
    import torch

    fn()
    torch.cuda.synchronize()
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(reps):
        fn()
    b.record()
    torch.cuda.synchronize()
    return a.elapsed_time(b) / reps


def check_close(name, got, want, rtol, atol):
    import numpy as np

    got, want = np.asarray(got), np.asarray(want)
    bad = np.abs(got - want) > atol + rtol * np.abs(want)
    if not np.all(np.isfinite(got)) or bad.any():
        raise AssertionError(
            f"{name}: {int(bad.sum())} of {got.size} values outside "
            f"rtol={rtol} atol={atol}; max abs diff "
            f"{float(np.max(np.abs(got - want)))}")


def kernel_vs_plain(label, shapes):
    """Phase 3. Returns the kernel's JSON entry (without launches)."""
    import torch

    from srmeetsps_cuda_tpu_torch.io.synthetic import lambertian_dataset
    from srmeetsps_cuda_tpu_torch.solve import stencil_cg as sc

    dev = torch.device("cuda")
    entry = None
    for (h, w, sf) in shapes:
        data, _ = lambertian_dataset(h, w, sf, n=8, c=3, seed=sf)
        prob, st, op = depth_operator(data, dev)
        args = (st.z, op, prob.gm, prob.ktw, prob.z0t, prob.z0u)
        const = float(op.const)
        errs = {}
        for cap in (2, 12, 100):
            before = sc.stencil_cg.launches
            x, k, _, e, C = sc.stencil_cg(*args, sf=sf, lam=1.0,
                                          max_iter=cap, planes=True)
            torch.cuda.synchronize()
            if sc.stencil_cg.launches != before + 1:
                raise AssertionError("stencil_cg did not count its launch")
            px, pk, _, pe, pC = sc.stencil_cg_plain(
                *args, sf=sf, lam=1.0, max_iter=cap, planes=True)
            # sf = 1 puts all of KT^T KT on the diagonal and converges
            # below the cap; at sf >= 2 tol^2 = 1e-18 is out of f32's reach.
            want = cap + 1 if sf > 1 else int(pk)
            if int(k) != int(pk) or int(k) != want:
                raise AssertionError(
                    f"{h}x{w} sf={sf} cap {cap}: iterations kernel {int(k)}, "
                    f"plain {int(pk)}, expected {want}")
            cmax = float(pC.abs().max())
            check_close(f"C planes {h}x{w} sf={sf}", C.cpu(), pC.cpu(),
                        1e-5, 1e-6 * cmax)
            if cap in X_TOL:
                check_close(f"x {h}x{w} sf={sf} cap {cap}", x.cpu(), px.cpu(),
                            X_TOL[cap], X_TOL[cap])
            # E = e_part + lam * sum B^2 with e_part ~ -const: its f32
            # rounding scales with |const|, so the bound is 5e-4 of E plus
            # 1e-6 of the constant it cancels (about 17 f32 ulps of it).
            check_close(f"energy {h}x{w} sf={sf} cap {cap} (const {const})",
                        float(e) + const, float(pe) + const, E_RTOL,
                        1e-6 * abs(const))
            errs[cap] = float((x - px).abs().max())
            errs_c = float((C - pC).abs().max())
        # Another thread-block shape (--blockx/--blocky): other partial sums,
        # the same bounds.
        xb, kb, _, _ = sc.stencil_cg(*args, sf=sf, lam=1.0, max_iter=12,
                                     block=(32, 16))
        px, pk, _, _ = sc.stencil_cg_plain(*args, sf=sf, lam=1.0,
                                           max_iter=12)
        if int(kb) != int(pk):
            raise AssertionError(f"block 32x16: iterations {int(kb)} vs "
                                 f"{int(pk)}")
        check_close(f"x {h}x{w} sf={sf} block 32x16", xb.cpu(), px.cpu(),
                    X_TOL[12], X_TOL[12])
        cap = 100
        run_k = lambda: sc.stencil_cg(*args, sf=sf, lam=1.0, max_iter=cap)  # noqa: E731
        run_p = lambda: sc.stencil_cg_plain(*args, sf=sf, lam=1.0,  # noqa: E731
                                            max_iter=cap)
        t_k1, t_p1, t_p2, t_k2 = (cuda_ms(run_k, 3), cuda_ms(run_p, 2),
                                  cuda_ms(run_p, 2), cuda_ms(run_k, 3))
        ms_k = (t_k1 + t_k2) / 2 / (cap + 1)
        ms_p = (t_p1 + t_p2) / 2 / (cap + 1)
        print(f"[{label}] stencil_cg {h}x{w} sf={sf}: iterations {int(k)} "
              f"equal; max|dx| at 2/12/101 iterations {errs[2]:.3e} / "
              f"{errs[12]:.3e} / {errs[100]:.3e}; max|dC| {errs_c:.3e}; "
              f"kernel {ms_k:.4f} ms/CG-iter, plain {ms_p:.4f} ms/CG-iter",
              flush=True)
        if (h, w, sf) == (960, 1280, 2):
            b_ms, b_by, s_ms = bound(h * w, 1, int(k), STENCIL_PLANES,
                                     STENCIL_FLOPS, sf)
            entry = {"name": "stencil_cg", "route": "cuda",
                     "source": "srmeetsps_cuda_tpu_torch/csrc/stencil_cg.cu",
                     "replaces": "srmeetsps_cuda_tpu/solve/pallas_cg_vmem.py:403",
                     "max_abs_err": errs[2], "ms": ms_k, "plain_ms": ms_p,
                     "bound_ms": b_ms, "bound_by": b_by,
                     "stream_bound_ms": s_ms, "library_ms": None,
                     "unit": "per CG iteration, 960x1280 sf 2, 101 "
                             "iterations"}
    return entry


def stacked_lanes(h, w, sf, seeds, device):
    """Per-lane depth-CG inputs ``(x0, op, gm, ktw, z0t, z0u)`` of seeded
    datasets, and the same stacked along a leading lane axis."""
    import torch

    from srmeetsps_cuda_tpu_torch.io.synthetic import lambertian_dataset

    lanes = []
    for seed in seeds:
        data, _ = lambertian_dataset(h, w, sf, n=8, c=3, seed=seed)
        prob, st, op = depth_operator(data, device)
        lanes.append((st.z, op, prob.gm, prob.ktw, prob.z0t, prob.z0u))
    first = lanes[0]
    stacked = []
    for i, v in enumerate(first):
        if isinstance(v, tuple):
            stacked.append(type(v)(*(torch.stack(f) for f in
                                     zip(*[ln[i] for ln in lanes]))))
        else:
            stacked.append(torch.stack([ln[i] for ln in lanes]))
    return lanes, stacked


def stencil_lanes(label, entry):
    """Phase 3b: B = 4 lanes of the stencil CG in one launch."""
    import torch

    from srmeetsps_cuda_tpu_torch.solve import stencil_cg as sc

    dev = torch.device("cuda")
    h, w, sf, B = 960, 1280, 2, 4
    lanes, stacked = stacked_lanes(h, w, sf, range(B), dev)
    for cap in (2, 12, 100):
        xb, kb, _, eb = sc.stencil_cg(*stacked, sf=sf, lam=1.0,
                                      max_iter=cap)
        for b, ln in enumerate(lanes):
            x1, k1, _, e1 = sc.stencil_cg(*ln, sf=sf, lam=1.0, max_iter=cap)
            if not (torch.equal(xb[b], x1) and int(kb[b]) == int(k1)
                    and torch.equal(eb[b], e1)):
                raise AssertionError(f"lane {b} at cap {cap} differs from "
                                     "its solo launch")
        if cap not in X_TOL:
            continue
        px, pk, _, pe = sc.stencil_cg_plain(*stacked, sf=sf, lam=1.0,
                                            max_iter=cap)
        if not torch.equal(kb, pk):
            raise AssertionError(f"batched iterations {kb.tolist()} vs plain "
                                 f"{pk.tolist()}")
        check_close(f"batched x cap {cap}", xb.cpu(), px.cpu(), X_TOL[cap],
                    X_TOL[cap])
        const = torch.stack([ln[1].const for ln in lanes])
        check_close(f"batched energy cap {cap}", (eb + const).cpu(),
                    (pe + const).cpu(), E_RTOL,
                    1e-6 * float(const.abs().max()))
    cap = 100
    run_b = lambda: sc.stencil_cg(*stacked, sf=sf, lam=1.0,  # noqa: E731
                                  max_iter=cap)

    def run_solo():
        for ln in lanes:
            sc.stencil_cg(*ln, sf=sf, lam=1.0, max_iter=cap)

    run_p = lambda: sc.stencil_cg_plain(*stacked, sf=sf, lam=1.0,  # noqa: E731
                                        max_iter=cap)
    t_b1, t_s1, t_p, t_s2, t_b2 = (cuda_ms(run_b, 3), cuda_ms(run_solo, 3),
                                   cuda_ms(run_p, 1), cuda_ms(run_solo, 3),
                                   cuda_ms(run_b, 3))
    n_it = int(kb[0])
    ms_b = (t_b1 + t_b2) / 2 / n_it
    ms_s = (t_s1 + t_s2) / 2 / n_it
    b_ms, b_by, _ = bound(h * w, B, n_it, STENCIL_PLANES, STENCIL_FLOPS, sf)
    entry["batched"] = {"lanes": B, "ms": ms_b, "solo_ms": ms_s,
                        "plain_ms": t_p / n_it, "bound_ms": b_ms,
                        "bound_by": b_by}
    print(f"[{label}] stencil_cg B={B} lanes {h}x{w} sf={sf}: every lane "
          f"bit-equal to its solo launch at caps 2/12/100, batch vs plain "
          f"within X_TOL/E_RTOL; batch {ms_b:.4f} ms/CG-iter vs 4 solo "
          f"launches {ms_s:.4f} ms/CG-iter, plain {t_p / n_it:.4f}",
          flush=True)


def rel_rms(got, want) -> float:
    d = (got - want).double()
    return float(d.square().mean().sqrt()
                 / want.double().square().mean().sqrt().clamp_min(1e-30))


def cgs_vs_plain(label, shapes):
    """Phase 3c. Returns the CGS kernel's JSON entry (without launches)."""
    import torch

    from srmeetsps_cuda_tpu_torch.solve import cgs_cg as cg

    dev = torch.device("cuda")
    entry = None
    for (h, w, sf) in shapes:
        lanes, stacked = stacked_lanes(h, w, sf, range(4), dev)
        gaps = {}
        for seed, ln in enumerate(lanes):
            warm = ln[:5]
            starts = {"warm": warm,
                      "cold": (torch.zeros_like(warm[0]),) + warm[1:]}
            for (start, args), cap, block in itertools.product(
                    starts.items(), (2, 12, 100), ((256, 4), (32, 16))):
                x0 = args[0]
                before = cg.cgs_cg.launches
                x, k, g = cg.cgs_cg(*args, sf=sf, lam=1.0, max_iter=cap,
                                    block=block)
                torch.cuda.synchronize()
                if cg.cgs_cg.launches != before + 1:
                    raise AssertionError("cgs_cg did not count its launch")
                px, pk, pg = cg.cgs_cg_plain(*args, sf=sf, lam=1.0,
                                             max_iter=cap)
                want = cap + 1 if sf > 1 else int(pk)
                where = (f"CGS {h}x{w} sf={sf} seed {seed} {start} cap {cap} "
                         f"block {block}")
                if int(k) != int(pk) or int(k) != want:
                    raise AssertionError(
                        f"{where}: iterations kernel {int(k)}, plain "
                        f"{int(pk)}, expected {want}")
                if not bool(torch.isfinite(x).all()):
                    raise AssertionError(f"{where}: x is not finite")
                if cap not in CGS_UPD[start]:
                    continue
                upd = rel_rms(x - x0, px - x0)
                grel = abs(float(g) - float(pg)) / abs(float(pg))
                old = gaps.get((start, cap), (0.0, 0.0))
                gaps[start, cap] = (max(old[0], upd), max(old[1], grel))
                if (seed, start, cap, block) == (0, "warm", 2, (256, 4)):
                    max_dx = float((x - px).abs().max())
                if upd > CGS_UPD[start][cap] or grel > CGS_GAMMA[start][cap]:
                    raise AssertionError(
                        f"{where}: relative RMS of the update {upd:.3e} "
                        f"(bound {CGS_UPD[start][cap]}), relative gap of "
                        f"gamma {grel:.3e} (bound {CGS_GAMMA[start][cap]})")
        xs, ks, gs = cg.cgs_cg(*stacked[:5], sf=sf, lam=1.0, max_iter=12)
        for b, ln in enumerate(lanes):
            x1, k1, g1 = cg.cgs_cg(*ln[:5], sf=sf, lam=1.0, max_iter=12)
            if not (torch.equal(xs[b], x1) and int(ks[b]) == int(k1)
                    and torch.equal(gs[b], g1)):
                raise AssertionError(f"CGS lane {b} differs from its solo "
                                     "launch")
        cap = 100
        warm = lanes[0][:5]
        run_k = lambda: cg.cgs_cg(*warm, sf=sf, lam=1.0, max_iter=cap)  # noqa: E731
        run_p = lambda: cg.cgs_cg_plain(*warm, sf=sf, lam=1.0,  # noqa: E731
                                        max_iter=cap)
        t_k1, t_p1, t_p2, t_k2 = (cuda_ms(run_k, 3), cuda_ms(run_p, 2),
                                  cuda_ms(run_p, 2), cuda_ms(run_k, 3))
        n_it = int(run_k()[1])
        ms_k = (t_k1 + t_k2) / 2 / (cap + 1)
        ms_p = (t_p1 + t_p2) / 2 / (cap + 1)
        print(f"[{label}] cgs_cg {h}x{w} sf={sf}: iterations equal "
              f"({n_it} at cap 100); relative RMS of the update / relative "
              f"gap of gamma, worst of 4 seeds and blocks 256x4 and 32x16: "
              + "; ".join(f"{st} cap {c} {u:.2e} / {g:.2e}"
                          for (st, c), (u, g) in gaps.items())
              + f"; max|dx| warm cap 2 {max_dx:.3e}; B=4 lanes bit-equal to "
              f"solo; kernel {ms_k:.4f} ms/CG-iter, plain {ms_p:.4f} "
              "ms/CG-iter", flush=True)
        if (h, w, sf) == (960, 1280, 2):
            b_ms, b_by, s_ms = bound(h * w, 1, n_it, CGS_PLANES, CGS_FLOPS,
                                     sf)
            entry = {"name": "cgs_cg", "route": "cuda",
                     "source": "srmeetsps_cuda_tpu_torch/csrc/cgs_cg.cu",
                     "replaces": "srmeetsps_cuda_tpu/solve/pallas_cg_cgs.py:87",
                     "max_abs_err": max_dx, "ms": ms_k, "plain_ms": ms_p,
                     "bound_ms": b_ms, "bound_by": b_by,
                     "stream_bound_ms": s_ms, "library_ms": None,
                     "update_rel_rms": gaps["warm", 2][0],
                     "gamma_rel_gap": gaps["warm", 2][1],
                     "unit": "per CG iteration, 960x1280 sf 2, 101 "
                             "iterations"}
    return entry


def stop_rule_held(energies, tol, max_iterations) -> bool:
    """The reference's rule (SRPS.cu:297-301): no earlier iteration met it,
    the last one did."""
    last = math.nan
    for k, e in enumerate(energies, start=1):
        rel = abs(last - e) / abs(e)
        stop = (e > last) or (rel < tol) or (k > max_iterations)
        if stop != (k == len(energies)):
            return False
        last = e
    return True


def write_dataset(tmp, h, w, seed, n=20, c=3, sf=2):
    """A seeded Lambertian dataset written as a MAT v5 file: ``(path, data,
    z_true)``."""
    from srmeetsps_cuda_tpu_torch.io.mat_loader import save_mat_dataset
    from srmeetsps_cuda_tpu_torch.io.synthetic import lambertian_dataset

    data, z_true = lambertian_dataset(h, w, sf, n, c, seed=seed)
    path = os.path.join(tmp, f"synthetic_{h}x{w}_sf{sf}_seed{seed}.mat")
    save_mat_dataset(path, data, fmt="mat5")
    return path, data, z_true


def run_cli(argv, tmp):
    """``cli.main`` with a metrics file in a fresh directory under ``tmp``:
    ``(records, wall seconds)``."""
    from srmeetsps_cuda_tpu_torch import cli

    metrics_path = os.path.join(tempfile.mkdtemp(dir=tmp), "metrics.jsonl")
    t0 = time.perf_counter()
    rc = cli.main(["--dstype", "matlab", *argv, "--metrics-jsonl",
                   metrics_path])
    wall = time.perf_counter() - t0
    if rc != 0:
        raise AssertionError(f"cli.main returned {rc}")
    with open(metrics_path) as f:
        return [json.loads(line) for line in f], wall


def kernel_counters():
    from srmeetsps_cuda_tpu_torch.solve import cgs_cg as cg
    from srmeetsps_cuda_tpu_torch.solve import stencil_cg as sc

    return {"stencil_cg": sc.stencil_cg, "cgs_cg": cg.cgs_cg}


def main_path(label, tmp, path, data, z_true, cli_extra=(),
              kernel="stencil_cg"):
    """Phase 4 (and 4c with ``--cg-variant cgs``) through ``cli.main``.
    Returns the outer iterations, energies, solve seconds and the launches
    of ``kernel`` counted in the run."""
    import numpy as np

    from srmeetsps_cuda_tpu_torch.ops.grid import masked_scatter_colmajor

    h, w = data.mask.shape
    n, sf = data.I.shape[0], data.sf
    counters = kernel_counters()
    for fn in counters.values():
        fn.launches = 0
    dump = tempfile.mkdtemp(dir=tmp)
    recs, wall = run_cli(["--dsloc", path, "--dump", "--dump-format", "npz",
                          "--dump-dir", dump, *cli_extra], tmp)
    launches = {k: fn.launches for k, fn in counters.items()}
    final = np.load(os.path.join(dump, "state_final.npz"))
    z = masked_scatter_colmajor(final["z"], data.mask)
    iters = [r for r in recs if "iteration" in r]
    summary = recs[-1]
    energies = [r["energy"] for r in iters]
    n_it = summary["iterations"]
    if len(iters) != n_it or not all(map(math.isfinite, energies)):
        raise AssertionError(f"energies not finite or incomplete: {iters}")
    if not stop_rule_held(energies, 5e-3, 10):
        raise AssertionError(f"stopping rule violated: {energies}")
    m = data.mask != 0
    if final["z"].shape != (int(m.sum()),) or not np.all(np.isfinite(z)):
        raise AssertionError("final depth is not finite / of the mask's size")
    others = {k: v for k, v in launches.items() if k != kernel}
    if launches[kernel] != n_it or any(others.values()):
        raise AssertionError(f"kernel runs {launches} for {n_it} outer "
                             f"iterations through {kernel}")
    if any(r["cg_iterations"] != 101 for r in iters):
        raise AssertionError(f"CG iterations not at the cap: {iters}")
    rmse = float(np.sqrt(np.mean((z[m] - z_true[m]) ** 2)))
    dt = summary["total_seconds"]
    print(f"[{label}] main path {' '.join(cli_extra)} {h}x{w} n={n} sf={sf}: "
          f"{n_it} outer iterations, final energy {energies[-1]:.4f}, solve "
          f"{dt:.4f} s ({1e3 * dt / n_it:.3f} ms/outer-iter), CLI wall "
          f"{wall:.3f} s, {kernel} launches {launches[kernel]}, depth RMSE "
          f"vs truth {rmse:.4f}", flush=True)
    print(f"[{label}] energy trace {energies}", flush=True)
    return {"iterations": n_it, "energies": energies, "seconds": dt,
            "launches": launches[kernel]}


def lane_traces(recs):
    """Per-lane energy traces of a multi-object run, in lane order."""
    lanes = {}
    for r in recs:
        if "iteration" in r:
            lanes.setdefault(r["object"], []).append(r["energy"])
    return list(lanes.values())


def solo_trace(path, pad_to=None):
    """The single fused solve of ``path`` (zero-padded to ``pad_to``)
    through the runtime API: its energy trace and the largest ``sum B^2``
    constant of its depth operators."""
    import torch

    from srmeetsps_cuda_tpu_torch.config import SolverConfig
    from srmeetsps_cuda_tpu_torch.io.mat_loader import load_mat_dataset
    from srmeetsps_cuda_tpu_torch.models import srps
    from srmeetsps_cuda_tpu_torch.runtime.solver import prepare

    cfg = SolverConfig()
    prob, st = prepare(load_mat_dataset(path), cfg, torch.device("cuda"),
                       pad_to=pad_to)
    consts = []

    def record(s):
        mom = srps.s_moments(prob, s.s)
        consts.append(float(srps.build_depth_operator(
            prob, mom, s.rho, s.dz, cfg.lam).const))

    final, trace = srps.solve_fused(st, prob, 2, cfg, on_iteration=record)
    return trace[:final.iteration].tolist(), max(consts, key=abs)


def energy_bound(first, const):
    """Phase 3's energy bound on a trace: E_RTOL of its first energy plus
    1e-6 of the constant ``E = e_part + lam * sum B^2`` cancels. The
    standard CG tracks e_part ~ -const in f32 through 101 subtractions, each
    rounded at the constant's ulp (0.5 at 5e6), so its energies are
    quantised and carry a rounding walk of a few ulps."""
    return E_RTOL * abs(first) + 1e-6 * abs(const)


def batched_path(label, tmp, paths, solo, padded, grid, variant="pipe"):
    """Phase 4b: the comma --dsloc in both modes with ``--cg-variant
    variant``. ``solo[path]`` is the single CLI run of a file in the same
    variant, where there is one; ``padded`` is the file that is padded to
    ``grid``. Returns the stream lanes and the lockstep launches."""
    lst = ",".join(paths)
    kernel = "cgs_cg" if variant == "cgs" else "stencil_cg"
    counters = kernel_counters()
    runs = {}
    for mode in ("stream", "lockstep"):
        for fn in counters.values():
            fn.launches = 0
        recs, wall = run_cli(["--dsloc", lst, "--batch-mode", mode,
                              "--cg-variant", variant], tmp)
        launches = {k: fn.launches for k, fn in counters.items()}
        lanes = lane_traces(recs)
        runs[mode] = (lanes, recs[-1]["solve_seconds"], launches[kernel], wall)
        if len(lanes) != len(paths) or recs[-1]["mode"] != mode:
            raise AssertionError(f"{mode}: {len(lanes)} lanes in {recs[-1]}")
        if any(n for k, n in launches.items() if k != kernel):
            raise AssertionError(f"{mode} {variant}: launches {launches}")
    stream, t_stream, n_stream, w_stream = runs["stream"]
    lock, t_lock, n_lock, w_lock = runs["lockstep"]
    for b, path in enumerate(paths):
        if path not in solo:
            continue
        want = solo[path]["energies"]
        if path != padded:
            if stream[b] != want:
                raise AssertionError(f"stream lane {b} {stream[b]} differs "
                                     f"from its solo solve {want}")
            continue
        # The padded lane: bit for bit the padded single solve. Against the
        # native solo solve the partial sums differ, and the energy is
        # quantised by the f32 rounding of its constant: phase 3's bound.
        trace, const = solo_trace(path, grid)
        if stream[b] != trace:
            raise AssertionError(f"padded stream lane {b} differs from the "
                                 "padded single solve")
        k = min(len(want), len(stream[b]))
        if abs(len(want) - len(stream[b])) > 1:
            raise AssertionError(f"padded lane: {len(stream[b])} vs "
                                 f"{len(want)} outer iterations")
        check_close(f"padded lane vs native solo (const {const})",
                    stream[b][:k], want[:k], 0, energy_bound(want[0], const))
    if n_stream != sum(map(len, stream)):
        raise AssertionError(f"stream: {n_stream} launches for "
                             f"{list(map(len, stream))} iterations")
    if lock != stream:
        raise AssertionError(f"lockstep lanes {lock} differ from stream "
                             f"lanes {stream}")
    if n_lock != max(map(len, lock)):
        raise AssertionError(f"lockstep: {n_lock} lane-batched launches for "
                             f"{max(map(len, lock))} outer iterations")
    B = len(paths)
    print(f"[{label}] batched CLI --cg-variant {variant}, {B} lanes (one "
          f"padded to {grid[0]}x{grid[1]}): stream lanes equal their solo "
          f"solves, lockstep equals stream; stream {t_stream:.4f} s "
          f"({B / t_stream:.2f} solves/s, {n_stream} {kernel} launches), "
          f"lockstep {t_lock:.4f} s ({B / t_lock:.2f} solves/s, {n_lock} "
          f"lane-batched launches for {max(map(len, lock))} outer "
          f"iterations); CLI wall {w_stream:.3f} / {w_lock:.3f} s",
          flush=True)
    return stream, n_lock


def serve_path(label, requests, answers):
    """Phase 4d: ``--serve`` with ``requests`` on stdin; each JSON answer
    must carry the iterations and final energy in ``answers``."""
    from srmeetsps_cuda_tpu_torch import cli

    buf = io.StringIO()
    stdin = sys.stdin
    sys.stdin = io.StringIO("".join(f"{r}\n" for r in requests) + "quit\n")
    try:
        with contextlib.redirect_stdout(buf):
            rc = cli.main(["--dstype", "matlab", "--serve"])
    finally:
        sys.stdin = stdin
    lines = [json.loads(line) for line in buf.getvalue().splitlines()
             if line.startswith("{")]
    if rc != 0 or lines[0] != {"serving": True, "pallas": True}:
        raise AssertionError(f"serve: rc {rc}, header {lines[:1]}")
    if len(lines) != len(requests) + 1:
        raise AssertionError(f"serve: {len(lines) - 1} answers for "
                             f"{len(requests)} requests: {lines}")
    for req, got, (n_it, energy) in zip(requests, lines[1:], answers):
        if (got.get("dsloc") != req or got.get("iterations") != n_it
                or got.get("final_energy") != energy):
            raise AssertionError(f"serve answered {got}, expected "
                                 f"iterations {n_it}, final energy {energy}")
    print(f"[{label}] serve: {len(requests)} requests answered as the CLI "
          "solved them; solve s " + ", ".join(
              f"{a['solve_seconds']}" for a in lines[1:]), flush=True)


def small_input_vs_cpu(label):
    """The whole solve on a small input, on the card and on the CPU."""
    import torch

    from srmeetsps_cuda_tpu_torch.config import RuntimeConfig, SolverConfig
    from srmeetsps_cuda_tpu_torch.io.synthetic import lambertian_dataset
    from srmeetsps_cuda_tpu_torch.runtime.solver import solve

    data, _ = lambertian_dataset(48, 64, 2, n=6, c=3, seed=3)
    cfg = SolverConfig()
    runs = {}
    for dev in ("cuda", "cpu"):
        _, metrics = solve(data, cfg, RuntimeConfig(fused_outer_loop=True),
                           device=torch.device(dev), verbose=False)
        runs[dev] = [r["energy"] for r in metrics if "iteration" in r]
    if len(runs["cuda"]) != len(runs["cpu"]):
        raise AssertionError(f"outer iterations differ: {runs}")
    # The energy is e_part + lam * sum B^2, a difference of two f32 numbers
    # far larger than itself, so late (small) energies are compared on the
    # scale of the first one.
    check_close("small-input energy trace", runs["cuda"], runs["cpu"],
                E_RTOL, E_RTOL * abs(runs["cpu"][0]))
    print(f"[{label}] small input 48x64: {len(runs['cuda'])} outer iterations "
          f"on the card and the CPU, energies {runs['cuda']} vs "
          f"{runs['cpu']}", flush=True)


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        return 1
    sys.path.insert(0, ROOT)
    try:
        from srmeetsps_cuda_tpu_torch import native
        from srmeetsps_cuda_tpu_torch.device import set_precision
    except ImportError as e:
        print(f"chip_smoke: the srmeetsps_cuda_tpu_torch package is missing "
              f"beside this script: {e}", file=sys.stderr)
        return 1
    set_precision()
    label = gpu_label()
    print(f"[{label}] python {sys.version.split()[0]}, torch "
          f"{torch.__version__}, CUDA {torch.version.cuda}, "
          f"{torch.cuda.get_device_name(0)}", flush=True)

    t0 = time.perf_counter()
    kernels = ["stencil_cg", "cgs_cg"]
    fresh = [k for k in kernels if not native.library_path(k).exists()]
    native.build_all(kernels)
    for k in kernels:
        native.load(k)
    print(f"[{label}] build {', '.join(k + '.cu' for k in kernels)}: "
          f"{time.perf_counter() - t0:.3f} s (compiled: {fresh or 'none'})",
          flush=True)

    grids = [(960, 1280, 2), (240, 320, 1), (480, 640, 4)]
    entry = kernel_vs_plain(label, grids)
    stencil_lanes(label, entry)
    cgs_entry = cgs_vs_plain(label, grids)

    with tempfile.TemporaryDirectory() as tmp:
        a, a_data, a_true = write_dataset(tmp, 960, 1280, seed=0)
        main = main_path(label, tmp, a, a_data, a_true)
        entry["launches"] = main["launches"]
        small_input_vs_cpu(label)

        b, b_data, b_true = write_dataset(tmp, 944, 1264, seed=1)
        c, c_data, c_true = write_dataset(tmp, 960, 1280, seed=2)
        solo = {a: main, b: main_path(label, tmp, b, b_data, b_true),
                c: main_path(label, tmp, c, c_data, c_true)}
        lanes, grid = [a, b, c, a], (960, 1280)
        stream, entry["batched"]["launches"] = batched_path(
            label, tmp, lanes, solo, b, grid)

        cgs = main_path(label, tmp, a, a_data, a_true,
                        cli_extra=("--cg-variant", "cgs"),
                        kernel="cgs_cg")
        cgs_entry["launches"] = cgs["launches"]
        trace, const = solo_trace(a)
        if trace != main["energies"]:
            raise AssertionError("the runtime API's solve differs from the "
                                 "CLI's")
        std, alt = main["energies"], cgs["energies"]
        k = min(len(std), len(alt))
        if abs(len(std) - len(alt)) > 1:
            raise AssertionError(f"cgs: {len(alt)} outer iterations, "
                                 f"standard {len(std)}")
        check_close(f"cgs vs standard energies (const {const})", alt[:k],
                    std[:k], 0, energy_bound(std[0], const))
        per_it = [1e3 * r["seconds"] / r["iterations"] for r in (cgs, main)]
        print(f"[{label}] cgs vs standard: {per_it[0]:.3f} vs "
              f"{per_it[1]:.3f} ms/outer-iter; energies within "
              f"{energy_bound(std[0], const):.3f} (max gap "
              f"{max(abs(x - y) for x, y in zip(alt, std)):.4f}): {alt} vs "
              f"{std}", flush=True)
        _, n_lock = batched_path(label, tmp, lanes, {a: cgs}, b, grid,
                                 variant="cgs")
        cgs_entry["batched"] = {"lanes": len(lanes), "launches": n_lock}

        serve_path(label, [a, b, ",".join(lanes)], [
            (main["iterations"], main["energies"][-1]),
            (solo[b]["iterations"], solo[b]["energies"][-1]),
            ([len(t) for t in stream], [t[-1] for t in stream])])

    print(json.dumps({"kernels": [entry, cgs_entry]}))
    print(label)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
