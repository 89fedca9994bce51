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
   grids of phase 3 (``cg_vs_plain``), 4 seeds, from the main path's warm
   start and from a cold start x0 = 0, at two thread-block shapes:
   iteration counts, the update x - x0 and gamma = <r, r> after 2 and 12
   iterations (bounds at UPD_BOUND and RES_BOUND), B = 4 lanes bit for bit
   their solo launches;
3d. the Jacobi forms of the stencil CG (``invd``) the same way on the grids
   of phase 3 and at 960 x 1280 sf = 4, with the reported residual in place
   of gamma, C' bit-equal, and the tracked energy from the warm start at
   phase 3's bound at every cap;
3e. 1088 x 1920, sf = 2 (the grid the TPU serves with
   ``_kernel_vmem_hybrid_stencil``): the stencil CG plain with phase 3's
   checks and Jacobi with phase 3d's;
3f. the direct mask-gated matvec CG (``direct_cg``) the same way on the
   grids of phase 3 and at 2176 x 3840, sf = 2 (bench.py's 4K grid), in its
   three forms: r0 in the kernel with the tracked energy, the same with its
   in-sweep Jacobi PCG, and given its residual, at phase 3c's two block
   shapes and at 30 x 3, which splits sf = 4 tiles; then the direct and the
   stencil operator against each other on the card (matvecs to f32
   roundoff, the two kernels' CGs within phase 3c's bounds);
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
   iterations and energies of phases 4 and 4b, and a ``--jacobi`` request
   with those of phase 4e;
4e. ``--jacobi`` through the CLI on the phase-4 file (scaled form) and on a
   960 x 1280 sf = 4 file (PCG form): every depth CG one Jacobi launch, no
   CGS launch, the phase-4 checks; the whole Jacobi solve on a small input
   against the CPU;
4f. the 4b run with ``--jacobi``, then with ``--jacobi --cg-variant cgs``:
   lockstep equals stream, one lane-batched Jacobi launch per outer
   iteration, no CGS launch;
4g. a 1088 x 1920, n = 20, c = 3, sf = 2 file (BASELINE.md configuration
   5) through the CLI with the standard CG and with ``--jacobi``;
4h. ``runtime.solver.solve`` on the phase-4 dataset with
   ``SolverConfig(cg_operator="direct")``, with ``"direct"`` and Jacobi,
   and with ``"direct_host_r0"``: every depth CG one ``direct_cg`` launch
   and no other CG kernel, the stopping rule held, the energies within
   phase 3's energy bound of the stencil CG's run (phase 4, or 4e under
   Jacobi) with at most one outer iteration more or less; then the phase-4b
   lanes through ``solve_batch`` with ``"direct"``: lockstep equals stream,
   one lane-batched launch per outer iteration;
4i. bench.py's 4K configuration (2176 x 3840, sf = 2, n = 8, c = 3) through
   ``runtime.solver.solve`` with ``"direct"`` and with ``"stencil"``, in
   turns: a finite depth, the stopping rule, outer iterations, ms per
   outer iteration and the peak of allocated device memory;
3g. the row-shard kernels (``csrc/shard_cg.cu``) on 4 shards of the card
   against their plain versions on the same shards, on phase 3's grids and
   at 1088 x 1920 sf = 2, in the standard, CGS and Jacobi forms, from the
   warm and a cold start at two thread-block shapes (``cg_vs_plain``'s
   bounds, iteration counts equal); the 4-shard CG against the unsharded
   kernel of the same recurrence (Jacobi: the direct CG's PCG) within the
   same bounds; ms per CG iteration of kernel and plain, and the device
   time of one launch of each shard wrapper;
4j. BASELINE.md configuration 5 (1088 x 1920, n = 20, c = 3, sf = 2)
   through ``parallel.sharded.solve_fused_sharded`` on 4 shards of the
   card in the three forms: the stopping rule, a repeated solve bit-equal,
   every depth CG through the shard kernels, at most one outer iteration
   from the same solve with the plain per-shard steps and every energy
   within phase 3's bound of it; the same against phase 4g's unsharded run
   for the standard and CGS forms (Jacobi: printed, as 4g takes the scaled
   form); then ``--sharded 4`` through the CLI on the phase-4 file (one
   shard per card present).

The line before the last but one is a JSON object with one entry per
kernel and mode (its times per CG iteration at the main path's shapes, and
the least time the card could take for the same work), the line before the
last the card's name and power limit; the last line is
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
# (tests/test_torch_cgs.py::test_chip_bounds_catch_faulty_recurrences).
# The same bounds hold the Jacobi forms (phase 3d, reported residual in
# place of gamma, and the warm-start energy at phase 3's bound): a float64
# run of the plain version stays inside them and x0 returned, s_i^2 for
# s_i s_i+d, r0 unscaled, x = x0 + y, beta = 0, e0 at y = 0 and (PCG) p
# built from r or the energy from <r, r> fail them on every grid
# (tests/test_torch_jacobi.py::test_chip_bounds_catch_faulty_recurrences).
# They hold the direct CG too (phase 3f): a float64 run stays inside them on
# phase 3's grids, and the energy or beta from <r, r> under Jacobi, or a
# Dx^T that reads t1 as 0 beyond a block's edge, fail them
# (tests/test_torch_direct_cg.py::test_chip_bounds_catch_faulty_recurrences).
UPD_BOUND = {"warm": {2: 0.25, 12: 0.25}, "cold": {2: 1e-5, 12: 1e-5}}
RES_BOUND = {"warm": {2: 0.1, 12: 0.1}, "cold": {2: 5e-4, 12: 1e-2}}

# The H100 SXM's published peaks (NVIDIA's data sheet, dense, 700 W).
HBM_BYTES_PER_S = 3.35e12
F32_FLOPS_PER_S = 67e12
# Flops per pixel counted from the kernels' arithmetic, each value computed
# once: the prologue (C planes ~70, rhs ~15, M x0 17, energy ~45 / w0 17 and
# two dots) and one CG iteration (stencil 17, vector updates and dots 10 or
# 12; the sf = 4 tile sum adds 2).
STENCIL_FLOPS = {"prologue": 150, "iteration": 27}
CGS_FLOPS = {"prologue": 125, "iteration": 29}
# The Jacobi forms: scaled adds C' (9 square roots, 18 multiplies) and r' to
# the prologue and the epilogue's x = x0 + s y and r'^2 / invd (6); PCG adds
# rz to the prologue (2) and z = invd r and rz to each iteration (3).
JACOBI_FLOPS = {"scaled": {"prologue": 184, "iteration": 27},
                "pcg": {"prologue": 152, "iteration": 30}}
# f32 planes each function must read once and write once: F (11), R0 (4),
# Z0U (2, stencil only) and x0 in, x out.
# Jacobi adds invd.
STENCIL_PLANES, CGS_PLANES, JACOBI_PLANES = 19, 17, 20
# f32 planes one iteration of the kernels' design streams (the bound PERF.md
# quotes per CG iteration): 9 C planes and 10 state planes read or written;
# the PCG form reads invd in both sweeps.
ITERATION_PLANES = {"plain": 19, "scaled": 19, "pcg": 21}
# The direct-matvec CG (csrc/direct_cg.cu), counted from _matvec_band: the
# matvec about 42 flops a pixel (gradients 10, t1..t3 15, the adjoints 10,
# the tile sum and the sums 7) and the p update, dots and vector updates 8
# per iteration; r0 in the kernel adds the rhs (~12), M x0 (42), the energy
# (~45) and a dot to the prologue; a given residual only the dot. Jacobi adds
# rz and z = invd r (3 per iteration, 2 in the prologue). Planes read once
# and written once: F (11), R0 (4) and Z0U (2) or b (1), x0 in, x out, and
# invd under Jacobi; the design streams F (11) and 10 state planes per
# iteration, invd twice more under Jacobi.
DIRECT_FORMS = {
    # form: (flops, planes, stream planes)
    "direct": ({"prologue": 100, "iteration": 50}, 19, 21),
    "direct jacobi": ({"prologue": 102, "iteration": 53}, 20, 23),
    "direct host_r0": ({"prologue": 2, "iteration": 50}, 14, 21),
}

# The TPU kernels each form of the direct CG stands for (file:line of the
# kernel function), the first the one it is named by.
# The row-shard CG (csrc/shard_cg.cu) per form: the prologue without the
# energy (C planes ~70, rhs ~15, M x0 17, a dot; Jacobi rz), the iteration
# as the unsharded kernel's; planes read once and written once: F (11), R0
# (4), x0 in, x out, invd under Jacobi; streamed per iteration as the
# unsharded kernels (19, Jacobi 21).
SHARD_FORMS = {
    # form: (flops, planes, stream planes)
    "std": ({"prologue": 105, "iteration": 27}, 17, 19),
    "cgs": ({"prologue": 125, "iteration": 29}, 17, 19),
    "jacobi": ({"prologue": 107, "iteration": 30}, 18, 21),
}
SHARD_REPLACES = "srmeetsps_cuda_tpu/parallel/shard_pallas.py:"
# f32 planes of (h / N, w) one launch of each shard wrapper streams (its
# combine and one-block sum aside): the prologue reads F, R0, x0 (invd) and
# writes x, r and 9 C planes; sweep A reads 9 C, r, p_old (invd; ktw at sf
# 4) and writes p, w; sweep B reads x, r, p, w (invd) and writes x, r; the
# CGS sweep reads 9 C, x, p and one (r, w, s) set and writes the others.
SHARD_LAUNCH_PLANES = {"shard_cg prologue": 27, "shard_cg sweep_a": 13,
                       "shard_cg sweep_b": 6, "shard_cg sweep_b jacobi": 7,
                       "shard_cg cgs_sweep": 19}

DIRECT_REPLACES = {
    "direct": ("pallas_cg_vmem.py:961", "pallas_cg_vmem.py:1148",
               "pallas_cg_pipe.py:80"),
    "direct jacobi": ("pallas_cg_pipe.py:80", "pallas_cg_vmem.py:961",
                      "pallas_cg_vmem.py:1148"),
    "direct host_r0": ("pallas_cg.py:163", "pallas_cg.py:237",
                       "pallas_cg_fused.py:50", "pallas_cg_pipe.py:80"),
}


def bound(hw: int, lanes: int, iters: int, planes: int, flops: dict,
          sf: int, stream_planes: int = ITERATION_PLANES["plain"],
          per: int = None):
    """``(ms, "bytes" or "operations", stream_ms)`` per CG iteration: the
    least time the card could take for the function (inputs read once,
    outputs written once; the operations of the ``iters`` iterations this
    run's data needed), spread over ``per`` iterations (the launched ones,
    by default ``iters``), and the per-iteration streaming time of the
    kernels' design."""
    t_bytes = planes * 4 * hw * lanes / HBM_BYTES_PER_S
    per_iter = flops["iteration"] + (2 if sf == 4 else 0)
    t_ops = hw * lanes * (flops["prologue"] + iters * per_iter) \
        / F32_FLOPS_PER_S
    ms = 1e3 * max(t_bytes, t_ops) / (per or iters)
    stream = 1e3 * stream_planes * 4 * hw * lanes / HBM_BYTES_PER_S
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
    """Phase 3 (and 3e). Returns the kernel's JSON entry (without
    launches) per grid ``(h, w, sf)``."""
    import torch

    from srmeetsps_cuda_tpu_torch.io.synthetic import lambertian_dataset
    from srmeetsps_cuda_tpu_torch.solve import stencil_cg as sc

    dev = torch.device("cuda")
    entries = {}
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
        b_ms, b_by, s_ms = bound(h * w, 1, int(k), STENCIL_PLANES,
                                 STENCIL_FLOPS, sf, per=cap + 1)
        print(f"[{label}] stencil_cg {h}x{w} sf={sf}: iterations {int(k)} "
              f"equal; max|dx| at 2/12/101 iterations {errs[2]:.3e} / "
              f"{errs[12]:.3e} / {errs[100]:.3e}; max|dC| {errs_c:.3e}; "
              f"kernel {ms_k:.4f} ms/CG-iter, plain {ms_p:.4f} ms/CG-iter, "
              f"bound {b_ms:.5f} ({b_by}), stream bound {s_ms:.4f}",
              flush=True)
        entries[h, w, sf] = {
            "name": "stencil_cg", "route": "cuda",
            "source": "srmeetsps_cuda_tpu_torch/csrc/stencil_cg.cu",
            "replaces": "srmeetsps_cuda_tpu/solve/pallas_cg_vmem.py:"
                        + ("708" if (h, w) == (1088, 1920) else "403"),
            "max_abs_err": errs[2], "ms": ms_k, "plain_ms": ms_p,
            "bound_ms": b_ms, "bound_by": b_by, "stream_bound_ms": s_ms,
            "library_ms": None,
            "unit": f"per CG iteration, {h}x{w} sf {sf}, {cap + 1} "
                    "iterations launched"}
    return entries


def stacked_lanes(h, w, sf, seeds, device):
    """Per-lane depth-CG inputs ``(x0, op, gm, ktw, z0t, z0u, invd)`` of
    seeded datasets, and the same stacked along a leading lane axis."""
    import torch

    from srmeetsps_cuda_tpu_torch.io.synthetic import lambertian_dataset
    from srmeetsps_cuda_tpu_torch.models import srps

    lanes = []
    for seed in seeds:
        data, _ = lambertian_dataset(h, w, sf, n=8, c=3, seed=seed)
        prob, st, op = depth_operator(data, device)
        invd = 1.0 / srps.depth_diag(op, prob, sf, 1.0)
        lanes.append((st.z, op, prob.gm, prob.ktw, prob.z0t, prob.z0u, invd))
    first = lanes[0]
    stacked = []
    for i, v in enumerate(first):
        if isinstance(v, tuple):
            stacked.append(type(v)(*(torch.stack(f) for f in
                                     zip(*[ln[i] for ln in lanes]))))
        else:
            stacked.append(torch.stack([ln[i] for ln in lanes]))
    return lanes, stacked


def stencil_lanes(label, entry, lanes, stacked):
    """Phase 3b: B = 4 lanes of the stencil CG at 960 x 1280 sf 2 in one
    launch."""
    import torch

    from srmeetsps_cuda_tpu_torch.solve import stencil_cg as sc

    h, w, sf, B = 960, 1280, 2, len(lanes)
    lanes = [ln[:6] for ln in lanes]
    stacked = stacked[:6]
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


def energy_excess(e, pe, const) -> tuple:
    """``(|dE|, |dE| over phase 3's energy bound)`` of a tracked energy
    ``e`` against the plain version's ``pe`` (``E = e_part + const``): the
    bound is E_RTOL of E plus 1e-6 of the constant it cancels, and a ratio
    above 1 fails."""
    got, want = float(e) + const, float(pe) + const
    gap = abs(got - want)
    return gap, gap / (E_RTOL * abs(want) + 1e-6 * abs(const))


def cg_vs_plain(label, grids, form: str):
    """Phase 3c (``form="cgs"``: the CGS kernel), 3d and 3e (``"jacobi"``:
    the Jacobi forms of the stencil CG, ``invd``) or 3f (a form of the
    direct CG: ``"direct"``, r0 in the kernel and the energy tracked;
    ``"direct jacobi"``, the same with its in-sweep PCG; ``"direct
    host_r0"``, given its residual b = rhs - M x0) on ``grids``: ``(h, w,
    sf) -> (lanes, stacked)``. Each lane from the main path's warm start and
    from a cold start x0 = 0, at two thread-block shapes (the direct CG at
    a third, 30 x 3, whose rows and columns split sf = 4 tiles), against
    the plain version: iteration counts, the update x - x0 and the reported residual
    after 2 and 12 iterations (UPD_BOUND, RES_BOUND); C' bit-equal for the
    stencil Jacobi forms; the tracked energy from the warm start within
    phase 3's bound at every cap. Then the stacked lanes bit for bit their
    solo launches, and ms per CG iteration. Returns each grid's JSON entry
    (without launches)."""
    import torch

    from srmeetsps_cuda_tpu_torch.solve import cgs_cg as cg
    from srmeetsps_cuda_tpu_torch.solve import direct_cg as dc
    from srmeetsps_cuda_tpu_torch.solve import stencil_cg as sc

    direct = form.startswith("direct")
    host = form == "direct host_r0"
    tracked = form in ("jacobi", "direct", "direct jacobi")
    if form == "jacobi":
        kernel, plain, counter = sc.stencil_cg, sc.stencil_cg_plain, \
            "jacobi_launches"
    elif direct:
        kernel, plain = dc.direct_cg, dc.direct_cg_plain
        counter = {"direct": "launches", "direct jacobi": "jacobi_launches",
                   "direct host_r0": "host_r0_launches"}[form]
    else:
        kernel, plain, counter = cg.cgs_cg, cg.cgs_cg_plain, "launches"
    res = "gamma" if form == "cgs" else "residual"

    def given_residual(ln, x0, sf):
        return (sc.depth_rhs_fields(ln[1], ln[2], ln[4], 1.0)
                - dc.direct_matvec(x0, ln[1], ln[2], ln[3], 1.0, sf))

    def call(fn, ln, x0=None, checks=False, b=None, **kw):
        """``(x, iterations, residual, e_part, C)`` of ``fn`` on the inputs
        ``ln`` (a lane or the stacked lanes), from ``x0`` where given;
        e_part is None without a tracked energy, C without ``checks`` and
        outside the stencil Jacobi forms. The direct form given its
        residual takes ``b``, or builds it from x0."""
        x0 = ln[0] if x0 is None else x0
        if form == "cgs":
            return tuple(fn(x0, *ln[1:5], **kw)) + (None, None)
        if form == "jacobi":
            out = tuple(fn(x0, *ln[1:6], invd=ln[6], planes=checks, **kw))
            return out if checks else out + (None,)
        if host and b is None:
            b = given_residual(ln, x0, kw["sf"])
        return tuple(fn(x0, *ln[1:6], invd=ln[6] if "jacobi" in form
                        else None, b=b, with_energy=not host, **kw)) + (None,)

    blocks = ((256, 4), (32, 16)) + (((30, 3),) if direct else ())
    entries = {}
    for (h, w, sf), (lanes, stacked) in grids.items():
        jform = sc.jacobi_form(sf) if form == "jacobi" else form
        name = {"jacobi": f"stencil_cg jacobi {jform}", "cgs": "cgs_cg"}.get(
            form, form.replace("direct", "direct_cg", 1))
        # PCG stops on <r, r> and the CGS on gamma, out of f32's reach at
        # tol 1e-9 except where sf = 1 puts all of KT^T KT on the
        # diagonal; the scaled form stops on <r', r'>, which can get there,
        # and the direct CG's PCG on <r, r> from some warm starts. Where it
        # can stop early, the kernel's count must be the plain version's.
        converges = direct or jform == "scaled" or (form == "cgs" and sf == 1)
        gaps, energy = {}, (0.0, 0.0)
        for seed, ln in enumerate(lanes):
            const = float(ln[1].const)
            for start, cap in itertools.product(("warm", "cold"),
                                                (2, 12, 100)):
                x0 = ln[0] if start == "warm" else torch.zeros_like(ln[0])
                b_res = given_residual(ln, x0, sf) if host else None
                px, pk, pr, pe, pC = call(plain, ln, x0, checks=True,
                                          b=b_res, sf=sf, lam=1.0,
                                          max_iter=cap)
                for block in blocks:
                    where = (f"{name} {h}x{w} sf={sf} seed {seed} {start} "
                             f"cap {cap} block {block}")
                    before = getattr(kernel, counter)
                    x, k, r1, e, C = call(kernel, ln, x0, checks=True,
                                          b=b_res, sf=sf, lam=1.0,
                                          max_iter=cap, block=block)
                    torch.cuda.synchronize()
                    if getattr(kernel, counter) != before + 1:
                        raise AssertionError(f"{where}: launch not counted")
                    if form == "jacobi" and not torch.equal(C, pC):
                        raise AssertionError(
                            f"{where}: C' differs from the plain version's "
                            f"by {float((C - pC).abs().max())}")
                    want = int(pk) if converges else cap + 1
                    if int(k) != int(pk) or int(k) != want:
                        raise AssertionError(
                            f"{where}: iterations kernel {int(k)}, plain "
                            f"{int(pk)}, expected {want}")
                    if not bool(torch.isfinite(x).all()):
                        raise AssertionError(f"{where}: x is not finite")
                    # From the cold start e_part begins at sum z0s^2 (~1e12
                    # at 960 x 1280), whose f32 ulp swamps the energy; the
                    # bound is phase 3's, for warm starts.
                    if tracked and start == "warm":
                        de, ratio = energy_excess(e, pe, const)
                        if ratio > 1:
                            raise AssertionError(
                                f"{where}: energy {float(e) + const} vs "
                                f"plain {float(pe) + const} (const {const}), "
                                f"{ratio:.3f} of the bound")
                        energy = (max(energy[0], de), max(energy[1], ratio))
                    if cap not in UPD_BOUND[start]:
                        continue
                    upd = rel_rms(x - x0, px - x0)
                    gap = abs(float(r1) - float(pr)) / abs(float(pr))
                    old = gaps.get((start, cap), (0.0, 0.0))
                    gaps[start, cap] = (max(old[0], upd), max(old[1], gap))
                    if (seed, start, cap, block) == (0, "warm", 2, (256, 4)):
                        max_dx = float((x - px).abs().max())
                    if upd > UPD_BOUND[start][cap] or gap > RES_BOUND[start][cap]:
                        raise AssertionError(
                            f"{where}: relative RMS of the update {upd:.3e} "
                            f"(bound {UPD_BOUND[start][cap]}), relative gap "
                            f"of {res} {gap:.3e} (bound "
                            f"{RES_BOUND[start][cap]})")
        xs, ks, rs, es, _ = call(kernel, stacked, sf=sf, lam=1.0, max_iter=12)
        for b, ln in enumerate(lanes):
            x1, k1, r1, e1, _ = call(kernel, ln, sf=sf, lam=1.0, max_iter=12)
            if not (torch.equal(xs[b], x1) and int(ks[b]) == int(k1)
                    and torch.equal(rs[b], r1)
                    and (e1 is None or torch.equal(es[b], e1))):
                raise AssertionError(f"{name} lane {b} differs from its solo "
                                     "launch")
        cap = 100
        b0 = given_residual(lanes[0], lanes[0][0], sf) if host else None
        run_k = lambda: call(kernel, lanes[0], b=b0, sf=sf,  # noqa: E731
                             lam=1.0, max_iter=cap)
        run_p = lambda: call(plain, lanes[0], b=b0, sf=sf,  # noqa: E731
                             lam=1.0, max_iter=cap)
        t_k1, t_p1, t_p2, t_k2 = (cuda_ms(run_k, 3), cuda_ms(run_p, 2),
                                  cuda_ms(run_p, 2), cuda_ms(run_k, 3))
        n_it = int(run_k()[1])
        ms_k = (t_k1 + t_k2) / 2 / (cap + 1)
        ms_p = (t_p1 + t_p2) / 2 / (cap + 1)
        if form == "jacobi":
            b_ms, b_by, s_ms = bound(h * w, 1, n_it, JACOBI_PLANES,
                                     JACOBI_FLOPS[jform], sf,
                                     ITERATION_PLANES[jform], per=cap + 1)
        elif direct:
            flops, planes, stream = DIRECT_FORMS[form]
            b_ms, b_by, s_ms = bound(h * w, 1, n_it, planes, flops, sf,
                                     stream, per=cap + 1)
        else:
            b_ms, b_by, s_ms = bound(h * w, 1, n_it, CGS_PLANES, CGS_FLOPS,
                                     sf, per=cap + 1)
        print(f"[{label}] {name} {h}x{w} sf={sf}: "
              + ("C' bit-equal, " if form == "jacobi" else "")
              + f"iterations equal ({n_it} of seed 0 at cap 100); relative "
              f"RMS of the update / relative gap of {res}, worst of "
              f"{len(lanes)} seeds and blocks "
              + ", ".join(f"{x}x{y}" for x, y in blocks) + ": "
              + "; ".join(f"{st} cap {c} {u:.2e} / {g:.2e}"
                          for (st, c), (u, g) in gaps.items())
              + (f"; warm-start energy max|dE| {energy[0]:.3e} "
                 f"({energy[1]:.3f} of its bound)" if tracked else "")
              + f"; max|dx| warm cap 2 {max_dx:.3e}; B={len(lanes)} lanes "
              f"bit-equal to solo; kernel {ms_k:.4f} ms/CG-iter, plain "
              f"{ms_p:.4f} ms/CG-iter (per launched iteration), bound "
              f"{b_ms:.5f} ({b_by}), stream bound {s_ms:.4f}", flush=True)
        if form == "jacobi":
            source, replaces = "stencil_cg.cu", "pallas_cg_vmem.py:" + (
                "708" if (h, w) == (1088, 1920) else "403")
        elif direct:
            source, replaces = "direct_cg.cu", DIRECT_REPLACES[form][0]
        else:
            source, replaces = "cgs_cg.cu", "pallas_cg_cgs.py:87"
        entries[h, w, sf] = {
            "name": name, "route": "cuda",
            "source": "srmeetsps_cuda_tpu_torch/csrc/" + source,
            "replaces": "srmeetsps_cuda_tpu/solve/" + replaces,
            "max_abs_err": max_dx, "ms": ms_k, "plain_ms": ms_p,
            "bound_ms": b_ms, "bound_by": b_by, "stream_bound_ms": s_ms,
            "library_ms": None, "update_rel_rms": gaps["warm", 2][0],
            f"{res}_rel_gap": gaps["warm", 2][1], "cg_iterations": n_it,
            "unit": f"per launched CG iteration, {h}x{w} sf {sf}, "
                    f"{cap + 1} launched, {n_it} run"}
        if direct:
            entries[h, w, sf]["also_replaces"] = [
                "srmeetsps_cuda_tpu/solve/" + r
                for r in DIRECT_REPLACES[form][1:]]
        if tracked:
            entries[h, w, sf].update(energy_abs_gap=energy[0],
                                     energy_gap_of_bound=energy[1])
    return entries


def direct_vs_stencil(label, grids):
    """Phase 3f: the direct and the stencil operator on the card. The plain
    matvecs on a seeded vector agree to f32 roundoff (2e-6 of the largest
    |M v|), and the two kernels' CGs after 2 iterations, from the warm and
    the cold start, within UPD_BOUND / RES_BOUND and the energy within
    phase 3's bound (after 12 iterations the gaps are printed)."""
    import torch

    from srmeetsps_cuda_tpu_torch.solve import direct_cg as dc
    from srmeetsps_cuda_tpu_torch.solve import stencil_cg as sc

    for (h, w, sf), (lanes, _) in grids.items():
        x0, op, gm, ktw, z0t, z0u, _ = lanes[0]
        g = torch.Generator(device=x0.device).manual_seed(sf)
        v = torch.randn(x0.shape, generator=g, device=x0.device)
        wd = dc.direct_matvec(v, op, gm, ktw, 1.0, sf)
        ws = sc.stencil_matvec(sc.build_c_planes(op, gm, ktw, 1.0, sf), v,
                               ktw, sf)
        mv_gap = float((wd - ws).abs().max() / ws.abs().max())
        if not mv_gap <= 2e-6:
            raise AssertionError(f"{h}x{w} sf={sf}: direct and stencil "
                                 f"matvecs differ by {mv_gap:.3e} of max|Mv|")
        const = float(op.const)
        out = []
        for start, cap in itertools.product(("warm", "cold"), (2, 12)):
            xs = x0 if start == "warm" else torch.zeros_like(x0)
            xd, _, rd, ed = dc.direct_cg(xs, op, gm, ktw, z0t, z0u, sf=sf,
                                         lam=1.0, max_iter=cap,
                                         with_energy=True)
            xt, _, rt, et = sc.stencil_cg(xs, op, gm, ktw, z0t, z0u, sf=sf,
                                          lam=1.0, max_iter=cap)
            upd = rel_rms(xd - xs, xt - xs)
            gap = abs(float(rd) - float(rt)) / abs(float(rt))
            ratio = energy_excess(ed, et, const)[1] if start == "warm" else 0
            out.append(f"{start} cap {cap} {upd:.2e} / {gap:.2e}"
                       + (f" / {ratio:.3f}" if start == "warm" else ""))
            if cap == 2 and (upd > UPD_BOUND[start][cap]
                             or gap > RES_BOUND[start][cap] or ratio > 1):
                raise AssertionError(
                    f"{h}x{w} sf={sf} {start}: direct vs stencil kernels "
                    f"update {upd:.3e}, residual {gap:.3e}, energy {ratio:.3f}"
                    " of its bound")
        print(f"[{label}] direct vs stencil {h}x{w} sf={sf}: matvecs within "
              f"{mv_gap:.2e} of max|Mv|; kernels' CGs, relative RMS of the "
              "update / relative gap of the residual / energy over its "
              "bound: " + "; ".join(out), flush=True)


def shard_call(form, ln, mesh, x0=None, plain=False, **kw):
    """``(x, iterations, residual)`` of the row-shard CG in ``form`` on the
    lane inputs ``ln`` = (x0, op, gm, ktw, z0t, z0u, invd) over ``mesh``:
    the shard kernels, or with ``plain`` their plain versions."""
    from srmeetsps_cuda_tpu_torch.parallel import shard_cg as scg

    x0 = ln[0] if x0 is None else x0
    args = (ln[1], ln[2], ln[3], ln[4])
    if form == "jacobi":
        return scg.cg_sharded_jacobi(mesh, x0, ln[6], *args, plain=plain,
                                     **kw)
    fn = scg.cg_sharded_cgs if form == "cgs" else scg.cg_sharded
    return fn(mesh, x0, *args, plain=plain, **kw)


def unsharded_call(form, ln, x0, **kw):
    """``(x, iterations, residual)`` of the unsharded kernel that runs the
    same recurrence: stencil_cg, cgs_cg, or for Jacobi the direct CG's
    in-sweep PCG at every sf (stencil_cg's Jacobi takes the scaled form at
    sf <= 2; the direct operator is the stencil's within 2e-6 of max|M v|,
    phase 3f)."""
    from srmeetsps_cuda_tpu_torch.solve import cgs_cg as cg
    from srmeetsps_cuda_tpu_torch.solve import direct_cg as dc
    from srmeetsps_cuda_tpu_torch.solve import stencil_cg as sc

    if form == "cgs":
        return cg.cgs_cg(x0, *ln[1:5], **kw)
    if form == "jacobi":
        return dc.direct_cg(x0, *ln[1:6], invd=ln[6], **kw)[:3]
    return sc.stencil_cg(x0, *ln[1:6], **kw)[:3]


def device_ms(fn, reps: int = 30, cycles: int = 50_000_000):
    """Device milliseconds per call of ``fn`` alone: the stream is held by
    a spin kernel while the host queues ``reps`` calls, so they run back to
    back and the events around them time the card, not the host's
    launches. None where the host outran the spin (the queue drained)."""
    import torch

    if not hasattr(torch.cuda, "_sleep"):
        return None
    fn()
    torch.cuda.synchronize()
    ev = [torch.cuda.Event(enable_timing=True) for _ in range(3)]
    ev[0].record()
    torch.cuda._sleep(cycles)
    ev[1].record()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    host_ms = 1e3 * (time.perf_counter() - t0)
    ev[2].record()
    torch.cuda.synchronize()
    if host_ms >= ev[0].elapsed_time(ev[1]):
        return None
    return ev[1].elapsed_time(ev[2]) / reps


def shard_launch_ms(form, ln, mesh, sf):
    """Device ms of one launch of each shard wrapper of ``form`` on shard 0
    of ``mesh`` (its combine, its sweep and its one-block sum), from the
    state of a solve's first iteration (cap 100: the repeats stay active),
    with the streaming time of its planes: {counter name: (ms, stream
    ms)}."""
    from srmeetsps_cuda_tpu_torch.parallel import shard_cg as scg
    from srmeetsps_cuda_tpu_torch.parallel import shard_kernels as sk

    cgs, b = form == "cgs", None
    shards = scg._shards(mesh, ln[0], ln[1], ln[2], ln[3], ln[4], sf=sf,
                         lam=1.0, tol=1e-9, max_iter=100, cgs=cgs,
                         invd=ln[6] if form == "jacobi" else None,
                         block=(256, 4))
    for s in shards:
        sk.prologue(s)
    scg.exchange_halos([(s.rws[0] if cgs else s.r) for s in shards])
    if cgs:
        for s in shards:
            sk.cgs_w0(s)
        scg.exchange_halos([s.rws[:3] for s in shards])
    scg._reduce(shards)
    s = shards[0]
    calls = {"shard_cg prologue": lambda: sk.prologue(s)}
    if cgs:
        sk.cgs_step(s, 1)
        calls["shard_cg cgs_sweep"] = lambda: sk.cgs_step(s, 2)
    else:
        sk.step_a(s, 1)
        b = "shard_cg sweep_b" + (" jacobi" if form == "jacobi" else "")
        calls.update({"shard_cg sweep_a": lambda: sk.step_a(s, 2),
                      b: lambda: sk.step_b(s, 2)})
    out = {}
    for name, fn in calls.items():
        planes = SHARD_LAUNCH_PLANES[name] + (
            1 if form == "jacobi" and name != b else 0) + (
            1 if sf == 4 and name == "shard_cg sweep_a" else 0)
        out[name] = (device_ms(fn),
                     1e3 * planes * 4 * s.h * s.w / HBM_BYTES_PER_S)
    return out


def shard_vs_plain(label, grids, timed, shards=4):
    """Phase 3g on ``grids``: ``(h, w, sf) -> (lanes, stacked)``. For each
    form of the row-shard CG on ``shards`` shards of the card and 2 seeds,
    from the warm start and a cold start x0 = 0, at two thread-block
    shapes: the kernels against their plain versions on the same shards
    (iteration counts equal, the update x - x0 and the residual after 2 and
    12 iterations within UPD_BOUND / RES_BOUND, each shard's launches
    counted), a repeated run bit-equal, and the sharded kernels against the
    unsharded kernel of the same recurrence (unsharded_call) after 2
    iterations, within the same bounds. On the grids in ``timed``, ms per
    CG iteration of kernel and plain at cap 100, of one prologue with one
    iteration, and the device time of one launch of each wrapper on one
    shard (shard_launch_ms). Returns {form: {grid: entry}}."""
    import torch

    from srmeetsps_cuda_tpu_torch.parallel import shard_cg as scg
    from srmeetsps_cuda_tpu_torch.parallel import shard_kernels as sk

    mesh = scg.make_mesh_1d(shards, "cuda")
    counters = {"std": (sk.step_a, "launches"),
                "cgs": (sk.cgs_step, "launches"),
                "jacobi": (sk.step_b, "jacobi_launches")}
    out = {form: {} for form in SHARD_FORMS}
    for (h, w, sf), (lanes, _) in grids.items():
        for form in SHARD_FORMS:
            obj, attr = counters[form]
            gaps, vs_one = {}, []
            for seed, ln in enumerate(lanes[:2]):
                for start, cap in itertools.product(("warm", "cold"),
                                                    (2, 12)):
                    x0 = ln[0] if start == "warm" else torch.zeros_like(ln[0])
                    px, pk, pr = shard_call(form, ln, mesh, x0, plain=True,
                                            sf=sf, lam=1.0, max_iter=cap)
                    for block in ((256, 4), (32, 16)):
                        where = (f"shard_cg {form} {h}x{w} sf={sf} seed "
                                 f"{seed} {start} cap {cap} block {block}")
                        before = getattr(obj, attr)
                        x, k, r = shard_call(form, ln, mesh, x0, sf=sf,
                                             lam=1.0, max_iter=cap,
                                             block=block)
                        torch.cuda.synchronize()
                        if getattr(obj, attr) != before + shards * (cap + 1):
                            raise AssertionError(f"{where}: launches not "
                                                 "counted on every shard")
                        if int(k) != int(pk):
                            raise AssertionError(
                                f"{where}: iterations kernel {int(k)}, plain "
                                f"{int(pk)}")
                        if not bool(torch.isfinite(x).all()):
                            raise AssertionError(f"{where}: x is not finite")
                        upd = rel_rms(x - x0, px - x0)
                        gap = abs(float(r) - float(pr)) / abs(float(pr))
                        old = gaps.get((start, cap), (0.0, 0.0))
                        gaps[start, cap] = (max(old[0], upd),
                                            max(old[1], gap))
                        if (seed, start, cap, block) == (0, "warm", 2,
                                                         (256, 4)):
                            max_dx = float((x - px).abs().max())
                        if (upd > UPD_BOUND[start][cap]
                                or gap > RES_BOUND[start][cap]):
                            raise AssertionError(
                                f"{where}: relative RMS of the update "
                                f"{upd:.3e}, relative gap of the residual "
                                f"{gap:.3e}")
                    if seed == 0 and cap == 2:
                        x1, _, r1 = unsharded_call(form, ln, x0, sf=sf,
                                                   lam=1.0, max_iter=cap)
                        upd = rel_rms(x - x0, x1 - x0)
                        gap = abs(float(r) - float(r1)) / abs(float(r1))
                        vs_one.append(f"{start} {upd:.2e} / {gap:.2e}")
                        if (upd > UPD_BOUND[start][cap]
                                or gap > RES_BOUND[start][cap]):
                            raise AssertionError(
                                f"{where}: against the unsharded kernel, "
                                f"update {upd:.3e}, residual {gap:.3e}")
            a = shard_call(form, lanes[0], mesh, sf=sf, lam=1.0, max_iter=12)
            b = shard_call(form, lanes[0], mesh, sf=sf, lam=1.0, max_iter=12)
            if not all(torch.equal(u, v) for u, v in zip(a, b)):
                raise AssertionError(f"shard_cg {form} {h}x{w} sf={sf}: a "
                                     "repeated run differs")
            entry = {"update_rel_rms": gaps["warm", 2][0],
                     "residual_rel_gap": gaps["warm", 2][1],
                     "max_abs_err": max_dx}
            timing = ""
            if (h, w, sf) in timed:
                ln, cap = lanes[0], 100
                run = lambda plain, c=cap: shard_call(  # noqa: E731
                    form, ln, mesh, plain=plain, sf=sf, lam=1.0, max_iter=c)
                t_k1, t_p1, t_p2, t_k2 = (
                    cuda_ms(lambda: run(False), 2), cuda_ms(lambda: run(True), 1),
                    cuda_ms(lambda: run(True), 1), cuda_ms(lambda: run(False), 2))
                n_it = int(run(False)[1])
                flops, planes, stream = SHARD_FORMS[form]
                b_ms, b_by, s_ms = bound(h * w, 1, n_it, planes, flops, sf,
                                         stream, per=cap + 1)
                entry.update(ms=(t_k1 + t_k2) / 2 / (cap + 1),
                             plain_ms=(t_p1 + t_p2) / 2 / (cap + 1),
                             bound_ms=b_ms, bound_by=b_by,
                             stream_bound_ms=s_ms, cg_iterations=n_it,
                             unit=f"per CG iteration of the {shards}-shard "
                                  f"CG, {h}x{w} sf {sf}, {cap + 1} launched")
                timing = (f"; kernel {entry['ms']:.4f} ms/CG-iter, plain "
                          f"{entry['plain_ms']:.4f}, bound {b_ms:.5f} "
                          f"({b_by}), stream bound {s_ms:.4f}")
                if form != "cgs":
                    t_k = cuda_ms(lambda: run(False, 0), 3)
                    t_p = cuda_ms(lambda: run(True, 0), 2)
                    p_ms, p_by, _ = bound(h * w, 1, 1, planes, flops, sf,
                                          stream)
                    entry["prologue"] = {
                        "ms": t_k, "plain_ms": t_p, "bound_ms": p_ms,
                        "bound_by": p_by,
                        "unit": f"one prologue and one CG iteration on "
                                f"{shards} shards, {h}x{w} sf {sf}"}
                    timing += (f"; prologue + 1 iteration {t_k:.4f} ms, "
                               f"plain {t_p:.4f}")
                launch = shard_launch_ms(form, ln, mesh, sf)
                entry["launch"] = {name: {"device_ms": ms, "stream_ms": sm}
                                   for name, (ms, sm) in launch.items()}
                timing += "; device ms per launch on one shard: " + ", ".join(
                    f"{name[9:]} "
                    + ("not measured" if ms is None else f"{ms:.4f}")
                    + f" (stream {sm:.4f})"
                    for name, (ms, sm) in launch.items())
            out[form][h, w, sf] = entry
            print(f"[{label}] shard_cg {form} {shards} shards {h}x{w} "
                  f"sf={sf}: iterations equal; relative RMS of the update / "
                  "relative gap of the residual, worst of 2 seeds and "
                  "blocks 256x4, 32x16: " + "; ".join(
                      f"{st} cap {c} {u:.2e} / {g:.2e}"
                      for (st, c), (u, g) in gaps.items())
                  + f"; max|dx| warm cap 2 {max_dx:.3e}; repeat bit-equal; "
                  "vs the unsharded kernel at cap 2: " + ", ".join(vs_one)
                  + timing, flush=True)
    return out


def shard_entries(per_form, launches, grid, others):
    """The ``kernels`` line's entries of the row-shard kernels, one per TPU
    kernel: the figures of ``grid`` (those of ``others`` under ``grids``)
    of the form that runs the kernel, and the launches of phase 4j's runs,
    ``launches[form]``. ``ms`` is the whole sharded CG's per iteration,
    host launches included; ``device_ms_per_launch`` the card's time for
    one launch of this kernel's wrapper on one shard, beside its planes'
    streaming time ``launch_stream_ms``."""
    keys = ("ms", "plain_ms", "bound_ms", "bound_by", "stream_bound_ms",
            "cg_iterations", "update_rel_rms", "residual_rel_gap")
    rows = (("shard_cg prologue", "std", 124),
            ("shard_cg cgs_sweep", "cgs", 249),
            ("shard_cg sweep_a", "std", 375),
            ("shard_cg sweep_b", "std", 440),
            ("shard_cg sweep_b jacobi", "jacobi", 495))
    out = []
    for name, form, line in rows:
        src = per_form[form][grid]
        figures = src["prologue"] if name.endswith("prologue") else src
        entry = {"name": name, "route": "cuda",
                 "source": "srmeetsps_cuda_tpu_torch/csrc/shard_cg.cu",
                 "replaces": f"{SHARD_REPLACES}{line}",
                 "launches": launches[form][name], "library_ms": None,
                 "max_abs_err": src["max_abs_err"], "form": form}
        entry.update({k: figures[k] for k in keys + ("unit",)
                      if k in figures})

        def launch(e):
            d = e["launch"][name]
            return {"device_ms_per_launch": d["device_ms"],
                    "launch_stream_ms": d["stream_ms"]}

        entry.update(launch(src))
        entry["grids"] = {}
        for (h, w, sf) in others:
            e = per_form[form][h, w, sf]
            entry["grids"][f"{h}x{w} sf {sf}"] = dict(
                {k: v for k, v in (e["prologue"] if name.endswith("prologue")
                                   else e).items() if k in keys}, **launch(e))
        out.append(entry)
    return out


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
    """The launch counts each run is read by: name -> (object, attribute).
    ``stencil_cg`` counts every run of the stencil CG kernels, ``stencil_cg
    jacobi`` those in a Jacobi form; ``direct_cg`` every run of the direct
    CG kernels, ``direct_cg jacobi`` those with invd and ``direct_cg
    host_r0`` those given their residual; ``shard_cg ...`` the launches of
    each row-shard kernel, one per shard."""
    from srmeetsps_cuda_tpu_torch.solve import cgs_cg as cg
    from srmeetsps_cuda_tpu_torch.solve import direct_cg as dc
    from srmeetsps_cuda_tpu_torch.solve import stencil_cg as sc

    from srmeetsps_cuda_tpu_torch.parallel import shard_kernels as sk

    return {"stencil_cg": (sc.stencil_cg, "launches"),
            "stencil_cg jacobi": (sc.stencil_cg, "jacobi_launches"),
            "cgs_cg": (cg.cgs_cg, "launches"),
            "direct_cg": (dc.direct_cg, "launches"),
            "direct_cg jacobi": (dc.direct_cg, "jacobi_launches"),
            "direct_cg host_r0": (dc.direct_cg, "host_r0_launches"),
            "shard_cg prologue": (sk.prologue, "launches"),
            "shard_cg sweep_a": (sk.step_a, "launches"),
            "shard_cg sweep_b": (sk.step_b, "launches"),
            "shard_cg sweep_b jacobi": (sk.step_b, "jacobi_launches"),
            "shard_cg cgs_sweep": (sk.cgs_step, "launches")}


def reset_counts():
    for obj, attr in kernel_counters().values():
        setattr(obj, attr, 0)


def read_counts() -> dict:
    return {k: getattr(obj, attr)
            for k, (obj, attr) in kernel_counters().items()}


def expected_counts(n: int, cli_extra=(), operator: str = "stencil") -> dict:
    """The counts of ``n`` depth solves of a run with ``cli_extra`` (or the
    same options of a ``SolverConfig``) and ``cg_operator``: Jacobi runs the
    stencil CG in a Jacobi form, whatever the --cg-variant, and the direct
    CG its PCG; the CGS variant without Jacobi runs the CGS kernel for the
    stencil and the direct operator (depth_cg's routing)."""
    jacobi = "--jacobi" in cli_extra
    cgs = "cgs" in cli_extra and not jacobi and operator != "direct_host_r0"
    stencil = operator == "stencil" and not cgs
    direct = operator != "stencil" and not cgs
    return {"stencil_cg": n if stencil else 0,
            "stencil_cg jacobi": n if stencil and jacobi else 0,
            "cgs_cg": n if cgs else 0,
            "direct_cg": n if direct else 0,
            "direct_cg jacobi": n if direct and jacobi else 0,
            "direct_cg host_r0": n if operator == "direct_host_r0" else 0,
            **shard_counts(0, 0, 0, "std")}


def shard_counts(n: int, shards: int, cap: int, form: str) -> dict:
    """The row-shard kernels' counts of ``n`` sharded depth solves in
    ``form`` on ``shards`` shards at ``cap``: a prologue per shard (CGS: and
    its w0 launch) and cap + 1 sweeps per shard."""
    it = n * shards * (cap + 1)
    std = form != "cgs"
    return {"shard_cg prologue": n * shards * (1 if std else 2),
            "shard_cg sweep_a": it if std else 0,
            "shard_cg sweep_b": it if std else 0,
            "shard_cg sweep_b jacobi": it if form == "jacobi" else 0,
            "shard_cg cgs_sweep": 0 if std else it}


def cli_extra_of(cfg) -> tuple:
    """The CLI options that stand for a ``SolverConfig``'s Jacobi and CG
    variant (expected_counts reads them)."""
    return (("--jacobi",) if cfg.jacobi_preconditioner else ()) + (
        ("--cg-variant", "cgs") if cfg.cg_variant == "cgs" else ())


def main_path(label, tmp, path, data, z_true, cli_extra=()):
    """Phase 4 (4c with ``--cg-variant cgs``, 4e and 4g with ``--jacobi``)
    through ``cli.main``, the launch counts set to 0 just before and read
    just after. Returns the outer iterations, energies, CG iterations,
    solve seconds and the launch counts of the run."""
    import numpy as np

    from srmeetsps_cuda_tpu_torch.ops.grid import masked_scatter_colmajor

    h, w = data.mask.shape
    n, sf = data.I.shape[0], data.sf
    dump = tempfile.mkdtemp(dir=tmp)
    reset_counts()
    recs, wall = run_cli(["--dsloc", path, "--dump", "--dump-format", "npz",
                          "--dump-dir", dump, *cli_extra], tmp)
    launches = read_counts()
    final = np.load(os.path.join(dump, "state_final.npz"))
    z = masked_scatter_colmajor(final["z"], data.mask)
    iters = [r for r in recs if "iteration" in r]
    summary = recs[-1]
    energies = [r["energy"] for r in iters]
    cg_iters = [r["cg_iterations"] for r in iters]
    n_it = summary["iterations"]
    if len(iters) != n_it or not all(map(math.isfinite, energies)):
        raise AssertionError(f"energies not finite or incomplete: {iters}")
    if not stop_rule_held(energies, 5e-3, 10):
        raise AssertionError(f"stopping rule violated: {energies}")
    m = data.mask != 0
    if final["z"].shape != (int(m.sum()),) or not np.all(np.isfinite(z)):
        raise AssertionError("final depth is not finite / of the mask's size")
    if launches != expected_counts(n_it, cli_extra):
        raise AssertionError(f"kernel runs {launches} for {n_it} outer "
                             f"iterations with {cli_extra}")
    # The scaled Jacobi form stops on <r', r'>, which f32 can bring under
    # tol^2 = 1e-18; every other form runs to the cap.
    scaled = "--jacobi" in cli_extra and sf <= 2
    if not all(c == 101 or (scaled and 0 < c < 101) for c in cg_iters):
        raise AssertionError(f"CG iterations {cg_iters} off the cap")
    rmse = float(np.sqrt(np.mean((z[m] - z_true[m]) ** 2)))
    dt = summary["total_seconds"]
    print(f"[{label}] main path {' '.join(cli_extra)} {h}x{w} n={n} sf={sf}: "
          f"{n_it} outer iterations, final energy {energies[-1]:.4f}, solve "
          f"{dt:.4f} s ({1e3 * dt / n_it:.3f} ms/outer-iter), CLI wall "
          f"{wall:.3f} s, launches {launches}, CG iterations {cg_iters}, "
          f"depth RMSE vs truth {rmse:.4f}", flush=True)
    print(f"[{label}] energy trace {energies}", flush=True)
    return {"iterations": n_it, "energies": energies, "seconds": dt,
            "launches": launches, "rmse": rmse}


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


def batched_path(label, tmp, paths, solo, padded, grid, cli_extra=()):
    """Phase 4b (4c, 4f): the comma --dsloc in both modes with
    ``cli_extra``. ``solo[path]`` is the single CLI run of a file with the
    same options, where there is one; ``padded`` is the file that is padded
    to ``grid``. Returns the stream lanes and the lockstep launch counts."""
    lst = ",".join(paths)
    runs = {}
    for mode in ("stream", "lockstep"):
        reset_counts()
        recs, wall = run_cli(["--dsloc", lst, "--batch-mode", mode,
                              *cli_extra], tmp)
        launches = read_counts()
        lanes = lane_traces(recs)
        runs[mode] = (lanes, recs[-1]["solve_seconds"], launches, wall)
        if len(lanes) != len(paths) or recs[-1]["mode"] != mode:
            raise AssertionError(f"{mode}: {len(lanes)} lanes in {recs[-1]}")
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
    if n_stream != expected_counts(sum(map(len, stream)), cli_extra):
        raise AssertionError(f"stream: launches {n_stream} for "
                             f"{list(map(len, stream))} iterations")
    if lock != stream:
        raise AssertionError(f"lockstep lanes {lock} differ from stream "
                             f"lanes {stream}")
    if n_lock != expected_counts(max(map(len, lock)), cli_extra):
        raise AssertionError(f"lockstep: launches {n_lock} for "
                             f"{max(map(len, lock))} outer iterations")
    B = len(paths)
    print(f"[{label}] batched CLI {' '.join(cli_extra) or '(standard CG)'}, "
          f"{B} lanes (one padded to {grid[0]}x{grid[1]}): stream lanes "
          f"equal their solo solves, lockstep equals stream; stream "
          f"{t_stream:.4f} s ({B / t_stream:.2f} solves/s, launches "
          f"{n_stream}), lockstep {t_lock:.4f} s ({B / t_lock:.2f} solves/s, "
          f"lane-batched launches {n_lock} for {max(map(len, lock))} outer "
          f"iterations); CLI wall {w_stream:.3f} / {w_lock:.3f} s",
          flush=True)
    return stream, n_lock


def serve_path(label, requests, answers, cli_extra=()):
    """Phase 4d: ``--serve`` with ``cli_extra`` and ``requests`` on stdin;
    each JSON answer must carry the iterations and final energy in
    ``answers``."""
    from srmeetsps_cuda_tpu_torch import cli

    buf = io.StringIO()
    stdin = sys.stdin
    sys.stdin = io.StringIO("".join(f"{r}\n" for r in requests) + "quit\n")
    try:
        with contextlib.redirect_stdout(buf):
            rc = cli.main(["--dstype", "matlab", "--serve", *cli_extra])
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
    print(f"[{label}] serve {' '.join(cli_extra)}: {len(requests)} requests "
          "answered as the CLI solved them; solve s " + ", ".join(
              f"{a['solve_seconds']}" for a in lines[1:]), flush=True)


def small_input_vs_cpu(label, jacobi=False):
    """The whole solve on a small input, on the card and on the CPU."""
    import torch

    from srmeetsps_cuda_tpu_torch.config import RuntimeConfig, SolverConfig
    from srmeetsps_cuda_tpu_torch.io.synthetic import lambertian_dataset
    from srmeetsps_cuda_tpu_torch.runtime.solver import solve

    data, _ = lambertian_dataset(48, 64, 2, n=6, c=3, seed=3)
    cfg = SolverConfig(jacobi_preconditioner=jacobi)
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
    print(f"[{label}] small input 48x64{' --jacobi' if jacobi else ''}: "
          f"{len(runs['cuda'])} outer iterations "
          f"on the card and the CPU, energies {runs['cuda']} vs "
          f"{runs['cpu']}", flush=True)


def api_solve(label, data, z_true, cfg, ref=None, const=None, hold=True):
    """Phase 4h (and 4i): one solve of ``data`` through
    ``runtime.solver.solve`` with ``cfg``, the launch counts set to 0 just
    before and read just after, and the peak of allocated device memory.
    Checks what main_path checks; with ``ref`` (the energies of another
    operator's run of the same data) also at most one outer iteration more
    or less and the energies within ``energy_bound(ref[0], const)``, or
    with ``hold=False`` only prints how far they lie. Returns the run as
    main_path does, with ``peak_bytes``."""
    import torch

    from srmeetsps_cuda_tpu_torch.config import RuntimeConfig
    from srmeetsps_cuda_tpu_torch.runtime.solver import solve

    h, w = data.mask.shape
    what = (f"cg_operator={cfg.cg_operator}"
            + (" jacobi" if cfg.jacobi_preconditioner else "")
            + f" {h}x{w} n={data.I.shape[0]} sf={data.sf}")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    final, metrics = solve(data, cfg, RuntimeConfig(fused_outer_loop=True),
                           device=torch.device("cuda"), verbose=False)
    launches = read_counts()
    peak = torch.cuda.max_memory_allocated()
    iters = [r for r in metrics if "iteration" in r]
    energies = [r["energy"] for r in iters]
    cg_iters = [r["cg_iterations"] for r in iters]
    n_it, dt = metrics[-1]["iterations"], metrics[-1]["total_seconds"]
    if len(iters) != n_it or not all(map(math.isfinite, energies)):
        raise AssertionError(f"{what}: energies not finite or incomplete: "
                             f"{iters}")
    if not stop_rule_held(energies, cfg.tolerance, cfg.max_iterations):
        raise AssertionError(f"{what}: stopping rule violated: {energies}")
    if launches != expected_counts(n_it, cli_extra_of(cfg), cfg.cg_operator):
        raise AssertionError(f"{what}: kernel runs {launches} for {n_it} "
                             "outer iterations")
    # Only a Jacobi form's stop test can come under tol^2 = 1e-18 in f32.
    cap = cfg.cg_max_iter + 1
    if not all(c == cap or (cfg.jacobi_preconditioner and 0 < c < cap)
               for c in cg_iters):
        raise AssertionError(f"{what}: CG iterations {cg_iters} off the cap")
    m = torch.as_tensor(data.mask) != 0
    z = final.z.cpu()
    if not bool(torch.isfinite(z).all()):
        raise AssertionError(f"{what}: final depth is not finite")
    rmse = float((z[m] - torch.as_tensor(z_true)[m]).double().square()
                 .mean().sqrt())
    gap = ""
    if ref is not None:
        k = min(len(ref), n_it)
        bnd = energy_bound(ref[0], const)
        if hold:
            if abs(len(ref) - n_it) > 1:
                raise AssertionError(f"{what}: {n_it} outer iterations, "
                                     f"the other run {len(ref)}")
            check_close(f"{what} energies vs the other run's (const "
                        f"{const})", energies[:k], ref[:k], 0, bnd)
        gap = (f"; the other run: {len(ref)} outer iterations, energies "
               f"max gap {max(abs(x - y) for x, y in zip(energies, ref)):.4f}"
               f" (phase 3's bound {bnd:.3f})")
    print(f"[{label}] solve {what}: {n_it} outer iterations, final energy "
          f"{energies[-1]:.4f}, solve {dt:.4f} s ({1e3 * dt / n_it:.3f} "
          f"ms/outer-iter), peak allocated {peak / 2**30:.3f} GiB, launches "
          f"{launches}, CG iterations {cg_iters}, depth RMSE vs truth "
          f"{rmse:.4f}{gap}", flush=True)
    print(f"[{label}] energy trace {energies}", flush=True)
    return {"iterations": n_it, "energies": energies, "seconds": dt,
            "launches": launches, "rmse": rmse, "peak_bytes": peak}


def shard_form(cfg) -> str:
    """The row-shard CG form a ``SolverConfig`` runs (estimate_depth_sharded):
    Jacobi whatever the variant, else CGS or the standard CG."""
    if cfg.jacobi_preconditioner:
        return "jacobi"
    return "cgs" if cfg.cg_variant == "cgs" else "std"


@contextlib.contextmanager
def plain_shard_steps():
    """The row-shard loops run the plain per-shard steps on every device
    while this holds (the loops read ``shard_kernels.KERNELS`` per solve)."""
    from srmeetsps_cuda_tpu_torch.parallel import shard_kernels as sk

    kernels = sk.KERNELS
    sk.KERNELS = sk.PLAIN
    try:
        yield
    finally:
        sk.KERNELS = kernels


def sharded_solve(label, data, z_true, cfg, ref, const, shards=4):
    """Phase 4j: ``data`` through ``parallel.sharded.solve_fused_sharded``
    on ``shards`` shards of the card with ``cfg``, twice with the kernels
    and once with their plain versions (plain_shard_steps), the launch
    counts set to 0 just before each solve and read just after. Checks a
    finite depth, the stopping rule, the repeat bit for bit, the launches
    (every depth CG through the shard kernels, no other CG kernel; none in
    the plain run) and, against the plain run (the same recurrence), at
    most one outer iteration more or less and every energy within
    ``energy_bound(plain[0], const)``. Against the unsharded run ``ref``
    (energies) of the same file: the standard and CGS runs held as
    against the plain run; the Jacobi run's gap printed, since the
    unsharded solve runs the scaled form at sf <= 2. Returns the run as
    main_path does."""
    import torch

    from srmeetsps_cuda_tpu_torch.parallel import shard_cg as scg
    from srmeetsps_cuda_tpu_torch.parallel import sharded
    from srmeetsps_cuda_tpu_torch.runtime.solver import prepare

    dev = torch.device("cuda")
    mesh = scg.make_mesh_1d(shards, dev)
    form = shard_form(cfg)
    h, w = data.mask.shape
    what = f"sharded {form} {shards} shards {h}x{w} n={data.I.shape[0]}"
    runs = []
    for plain in (False, False, True):
        prob, st = prepare(data, cfg, dev)
        cg_iters = []
        torch.cuda.synchronize()
        reset_counts()
        t0 = time.perf_counter()
        with plain_shard_steps() if plain else contextlib.nullcontext():
            final, trace = sharded.solve_fused_sharded(
                st, prob, int(data.sf), cfg, mesh,
                on_iteration=lambda s: cg_iters.append(s.cg_iters))
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        runs.append((trace[:final.iteration].tolist(), dt, read_counts(),
                     [int(c) for c in cg_iters], final.z))
    energies, dt, launches, cg_iters, z = runs[0]
    plain_e, plain_dt, plain_launches, plain_cg, _ = runs[2]
    n_it = len(energies)
    if runs[1][0] != energies or not torch.equal(runs[1][4], z):
        raise AssertionError(f"{what}: a repeated solve gave {runs[1][0]}, "
                             f"the first {energies}")
    if not all(map(math.isfinite, energies + plain_e)):
        raise AssertionError(f"{what}: energies not finite: {energies}, "
                             f"plain {plain_e}")
    for e in (energies, plain_e):
        if not stop_rule_held(e, cfg.tolerance, cfg.max_iterations):
            raise AssertionError(f"{what}: stopping rule violated: {e}")
    want = dict(expected_counts(0),
                **shard_counts(n_it, shards, cfg.cg_max_iter, form))
    if launches != want or any(plain_launches.values()):
        raise AssertionError(f"{what}: kernel runs {launches}, expected "
                             f"{want}; in the plain run {plain_launches}")
    cap = cfg.cg_max_iter + 1
    if not all(c == cap or (form == "jacobi" and 0 < c < cap)
               for c in cg_iters + plain_cg):
        raise AssertionError(f"{what}: CG iterations {cg_iters} (plain "
                             f"{plain_cg}) off the cap")
    m = torch.as_tensor(data.mask) != 0
    z = z.cpu()
    if not bool(torch.isfinite(z).all()):
        raise AssertionError(f"{what}: final depth is not finite")
    rmse = float((z[m] - torch.as_tensor(z_true)[m]).double().square()
                 .mean().sqrt())
    held = []
    for other, e_ref, hold in (("plain", plain_e, True),
                               ("unsharded", ref, form != "jacobi")):
        gap = max(abs(x - y) for x, y in zip(energies, e_ref))
        bnd = energy_bound(e_ref[0], const)
        held.append(f"the {other} run: {len(e_ref)} outer iterations, "
                    f"energies max gap {gap:.4f} "
                    + ("within" if hold else "printed against")
                    + f" phase 3's bound {bnd:.3f}")
        if not hold:
            continue
        if abs(len(e_ref) - n_it) > 1:
            raise AssertionError(f"{what}: {n_it} outer iterations, the "
                                 f"{other} run {len(e_ref)}")
        k = min(len(e_ref), n_it)
        check_close(f"{what} energies vs the {other} run's (const {const})",
                    energies[:k], e_ref[:k], 0, bnd)
    print(f"[{label}] {what}: {n_it} outer iterations, final energy "
          f"{energies[-1]:.4f}, solve {dt:.4f} s ({1e3 * dt / n_it:.3f} "
          f"ms/outer-iter; repeat {1e3 * runs[1][1] / n_it:.3f}; plain "
          f"{1e3 * plain_dt / len(plain_e):.3f}), launches "
          f"{ {k_: v for k_, v in launches.items() if v} }, CG iterations "
          f"{cg_iters}, depth RMSE vs truth {rmse:.4f}; repeated solve "
          f"bit-equal; " + "; ".join(held), flush=True)
    print(f"[{label}] energy trace {energies}; plain {plain_e}", flush=True)
    return {"iterations": n_it, "energies": energies, "seconds": dt,
            "launches": launches, "rmse": rmse}


def cli_sharded(label, tmp, path, ref, const):
    """Phase 4j: ``--sharded 4`` through the CLI on ``path``, one shard per
    card present (at most 4): the metrics name the shard count, the
    stopping rule and every depth CG through the shard kernels, energies
    within phase 3's bound of the unsharded run ``ref``."""
    import torch

    shards = min(4, torch.cuda.device_count())
    reset_counts()
    recs, wall = run_cli(["--dsloc", path, "--sharded", "4"], tmp)
    launches = read_counts()
    summary = recs[-1]
    energies = [r["energy"] for r in recs if "iteration" in r]
    n_it = summary["iterations"]
    if summary.get("devices") != shards or len(energies) != n_it:
        raise AssertionError(f"--sharded 4: summary {summary}")
    if not stop_rule_held(energies, 5e-3, 10):
        raise AssertionError(f"--sharded 4: stopping rule violated: "
                             f"{energies}")
    want = dict(expected_counts(0), **shard_counts(n_it, shards, 100, "std"))
    if launches != want:
        raise AssertionError(f"--sharded 4: kernel runs {launches}, "
                             f"expected {want}")
    if abs(len(ref) - n_it) > 1:
        raise AssertionError(f"--sharded 4: {n_it} outer iterations, "
                             f"unsharded {len(ref)}")
    k = min(len(ref), n_it)
    check_close(f"--sharded 4 energies (const {const})", energies[:k],
                ref[:k], 0, energy_bound(ref[0], const))
    dt = summary["total_seconds"]
    print(f"[{label}] CLI --sharded 4 on {shards} card(s): {n_it} outer "
          f"iterations, solve {dt:.4f} s ({1e3 * dt / n_it:.3f} "
          f"ms/outer-iter), CLI wall {wall:.3f} s, energies within phase "
          f"3's bound of phase 4's (max gap "
          f"{max(abs(x - y) for x, y in zip(energies, ref)):.4f})",
          flush=True)


def api_lanes(label, datas, cfg):
    """Phase 4h: ``datas`` (zero-padded to their common grid) through
    ``parallel.batched.solve_batch`` in both modes with ``cfg``: lockstep
    lanes equal stream lanes, and lockstep makes one lane-batched launch
    per outer iteration. Returns the lockstep launch counts."""
    import torch

    from srmeetsps_cuda_tpu_torch.parallel import batched
    from srmeetsps_cuda_tpu_torch.runtime.solver import prepare

    dev = torch.device("cuda")
    H = max(d.mask.shape[0] for d in datas)
    W = max(d.mask.shape[1] for d in datas)
    runs = {}
    for mode in ("stream", "lockstep"):
        pairs = [prepare(d, cfg, dev, pad_to=(H, W)) for d in datas]
        torch.cuda.synchronize()
        reset_counts()
        t0 = time.perf_counter()
        finals, traces = batched.solve_batch([s for _, s in pairs],
                                             [p for p, _ in pairs], 2, cfg,
                                             mode=mode)
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        lanes = [t[:int(f.iteration)].tolist() for f, t in zip(finals, traces)]
        runs[mode] = (lanes, dt, read_counts())
    (stream, t_s, n_s), (lock, t_l, n_l) = runs["stream"], runs["lockstep"]
    extra = cli_extra_of(cfg)
    if lock != stream:
        raise AssertionError(f"lockstep lanes {lock} differ from stream "
                             f"lanes {stream}")
    if n_s != expected_counts(sum(map(len, stream)), extra, cfg.cg_operator):
        raise AssertionError(f"stream: launches {n_s} for "
                             f"{list(map(len, stream))} iterations")
    if n_l != expected_counts(max(map(len, lock)), extra, cfg.cg_operator):
        raise AssertionError(f"lockstep: launches {n_l} for "
                             f"{max(map(len, lock))} outer iterations")
    B = len(datas)
    print(f"[{label}] solve_batch cg_operator={cfg.cg_operator}, {B} lanes "
          f"padded to {H}x{W}: lockstep equals stream; stream {t_s:.4f} s "
          f"({B / t_s:.2f} solves/s), lockstep {t_l:.4f} s ({B / t_l:.2f} "
          f"solves/s, lane-batched launches {n_l} for "
          f"{max(map(len, lock))} outer iterations); outer iterations "
          f"{[len(t) for t in lock]}", flush=True)
    return n_l


def direct_entries(per_form, launches):
    """The ``kernels`` line's entries of the direct CG, one per form: the
    960 x 1280 sf = 2 figures, those of the other grids under ``grids``,
    and the launches of the main-path runs ``launches[form]``."""
    keys = ("ms", "plain_ms", "bound_ms", "bound_by", "stream_bound_ms",
            "cg_iterations", "update_rel_rms", "residual_rel_gap",
            "energy_gap_of_bound")
    out = []
    for form, grids in per_form.items():
        entry = dict(grids[960, 1280, 2])
        entry["grids"] = {f"{h}x{w} sf {sf}": {k: e[k] for k in keys if k in e}
                          for (h, w, sf), e in grids.items()}
        entry.update(launches[form])
        out.append(entry)
    return out


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        return 1
    sys.path.insert(0, ROOT)
    try:
        from srmeetsps_cuda_tpu_torch import native
        from srmeetsps_cuda_tpu_torch.config import SolverConfig
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
    kernels = ["stencil_cg", "cgs_cg", "direct_cg", "shard_cg"]
    fresh = [k for k in kernels if not native.library_path(k).exists()]
    native.build_all(kernels)
    for k in kernels:
        native.load(k)
    print(f"[{label}] build {', '.join(k + '.cu' for k in kernels)}: "
          f"{time.perf_counter() - t0:.3f} s (compiled: {fresh or 'none'})",
          flush=True)

    dev = torch.device("cuda")
    grids = [(960, 1280, 2), (240, 320, 1), (480, 640, 4)]
    shared = {g: stacked_lanes(*g, range(4), dev)
              for g in grids + [(960, 1280, 4)]}
    entry = kernel_vs_plain(label, grids)[960, 1280, 2]
    stencil_lanes(label, entry, *shared[960, 1280, 2])
    cgs_entry = cg_vs_plain(label, {g: shared[g] for g in grids},
                            "cgs")[960, 1280, 2]
    jac = cg_vs_plain(label, shared, "jacobi")
    scaled_entry, pcg_entry = jac[960, 1280, 2], jac[960, 1280, 4]
    # 3f on phase 3's grids.
    phase3 = {g: shared[g] for g in grids}
    direct = {form: cg_vs_plain(label, phase3, form) for form in DIRECT_FORMS}
    direct_vs_stencil(label, phase3)
    big = (1088, 1920, 2)
    big_lanes = {big: stacked_lanes(*big, range(2), dev)}
    # 3g: the row-shard kernels on phase 3's grids and at 1088 x 1920.
    shard = shard_vs_plain(label, {**phase3, **big_lanes},
                           timed={big, (480, 640, 4)})
    del shared, phase3
    big_entry = kernel_vs_plain(label, [big])[big]
    big_entry["name"] = "stencil_cg 1088x1920"
    big_jac = cg_vs_plain(label, big_lanes, "jacobi")[big]
    del big_lanes
    big_entry["jacobi"] = {k: big_jac[k] for k in (
        "ms", "plain_ms", "bound_ms", "bound_by", "cg_iterations",
        "energy_abs_gap", "energy_gap_of_bound")}
    # 3f at bench.py's 4K grid.
    k4 = (2176, 3840, 2)
    k4_lanes = {k4: stacked_lanes(*k4, range(4), dev)}
    for form in DIRECT_FORMS:
        direct[form].update(cg_vs_plain(label, k4_lanes, form))
    direct_vs_stencil(label, k4_lanes)
    del k4_lanes
    direct_launches = {form: {} for form in DIRECT_FORMS}

    with tempfile.TemporaryDirectory() as tmp:
        a, a_data, a_true = write_dataset(tmp, 960, 1280, seed=0)
        main = main_path(label, tmp, a, a_data, a_true)
        entry["launches"] = main["launches"]["stencil_cg"]
        small_input_vs_cpu(label)

        b, b_data, b_true = write_dataset(tmp, 944, 1264, seed=1)
        c, c_data, c_true = write_dataset(tmp, 960, 1280, seed=2)
        solo = {a: main, b: main_path(label, tmp, b, b_data, b_true),
                c: main_path(label, tmp, c, c_data, c_true)}
        lanes, grid = [a, b, c, a], (960, 1280)
        stream, n_lock = batched_path(label, tmp, lanes, solo, b, grid)
        entry["batched"]["launches"] = n_lock["stencil_cg"]

        cgs = main_path(label, tmp, a, a_data, a_true,
                        cli_extra=("--cg-variant", "cgs"))
        cgs_entry["launches"] = cgs["launches"]["cgs_cg"]
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
                                 cli_extra=("--cg-variant", "cgs"))
        cgs_entry["batched"] = {"lanes": len(lanes),
                                "launches": n_lock["cgs_cg"]}

        # 4e: --jacobi, scaled at sf 2 and PCG at sf 4.
        jac_a = main_path(label, tmp, a, a_data, a_true,
                          cli_extra=("--jacobi",))
        scaled_entry["launches"] = jac_a["launches"]["stencil_cg jacobi"]
        d, d_data, d_true = write_dataset(tmp, 960, 1280, seed=4, sf=4)
        jac_d = main_path(label, tmp, d, d_data, d_true,
                          cli_extra=("--jacobi",))
        pcg_entry["launches"] = jac_d["launches"]["stencil_cg jacobi"]
        os.remove(d)
        per_it = [1e3 * r["seconds"] / r["iterations"] for r in (jac_a, main)]
        print(f"[{label}] --jacobi vs standard at 960x1280 sf=2: "
              f"{per_it[0]:.3f} vs {per_it[1]:.3f} ms/outer-iter, "
              f"{jac_a['iterations']} vs {main['iterations']} outer "
              f"iterations, depth RMSE vs truth {jac_a['rmse']:.4f} vs "
              f"{main['rmse']:.4f}", flush=True)
        small_input_vs_cpu(label, jacobi=True)

        # 4h: the direct CG's operators through the runtime API, held to
        # the stencil CG's runs of the same file (phase 4, and 4e under
        # Jacobi).
        for form, cfg, ref in (
                ("direct", SolverConfig(cg_operator="direct"), main),
                ("direct jacobi", SolverConfig(cg_operator="direct",
                                               jacobi_preconditioner=True),
                 jac_a),
                ("direct host_r0", SolverConfig(cg_operator="direct_host_r0"),
                 main)):
            run = api_solve(label, a_data, a_true, cfg, ref["energies"], const)
            counter = form.replace("direct", "direct_cg", 1)
            direct_launches[form]["launches"] = run["launches"][counter]
        n_lock = api_lanes(label, [a_data, b_data, c_data, a_data],
                           SolverConfig(cg_operator="direct"))
        direct_launches["direct"]["batched"] = {
            "lanes": 4, "launches": n_lock["direct_cg"]}

        # 4f: the batched run with --jacobi, and with --cg-variant cgs too.
        _, n_lock = batched_path(label, tmp, lanes, {a: jac_a}, b, grid,
                                 cli_extra=("--jacobi",))
        scaled_entry["batched"] = {"lanes": len(lanes),
                                   "launches": n_lock["stencil_cg jacobi"]}
        batched_path(label, tmp, lanes, {}, b, grid,
                     cli_extra=("--jacobi", "--cg-variant", "cgs"))

        serve_path(label, [a, b, ",".join(lanes)], [
            (main["iterations"], main["energies"][-1]),
            (solo[b]["iterations"], solo[b]["energies"][-1]),
            ([len(t) for t in stream], [t[-1] for t in stream])])
        serve_path(label, [a], [(jac_a["iterations"], jac_a["energies"][-1])],
                   cli_extra=("--jacobi",))

        # 4j (CLI): --sharded 4 on the phase-4 file.
        cli_sharded(label, tmp, a, main["energies"], const)

        # 4g: BASELINE.md configuration 5, 1088 x 1920, n = 20, c = 3.
        for path in (a, b, c):
            os.remove(path)
        e, e_data, e_true = write_dataset(tmp, 1088, 1920, seed=5)
        big_std = main_path(label, tmp, e, e_data, e_true)
        big_entry["launches"] = big_std["launches"]["stencil_cg"]
        big_jac_run = main_path(label, tmp, e, e_data, e_true,
                                cli_extra=("--jacobi",))
        big_entry["jacobi"]["launches"] = \
            big_jac_run["launches"]["stencil_cg jacobi"]
        per_it = [1e3 * r["seconds"] / r["iterations"]
                  for r in (big_std, big_jac_run, main)]
        print(f"[{label}] 1088x1920 n=20: {per_it[0]:.3f} ms/outer-iter "
              f"standard, {per_it[1]:.3f} --jacobi, against "
              f"{per_it[2]:.3f} standard at 960x1280", flush=True)

        # 4j: the same configuration on 4 row shards of the card, against
        # 4g's unsharded runs.
        _, e_const = solo_trace(e)
        shard_runs = {}
        for cfg, ref in ((SolverConfig(), big_std),
                         (SolverConfig(cg_variant="cgs"), big_std),
                         (SolverConfig(jacobi_preconditioner=True),
                          big_jac_run)):
            run = sharded_solve(label, e_data, e_true, cfg, ref["energies"],
                                e_const)
            shard_runs[shard_form(cfg)] = run
        print(f"[{label}] 1088x1920 n=20 on 4 row shards: " + ", ".join(
            f"{form} {1e3 * r['seconds'] / r['iterations']:.3f}"
            for form, r in shard_runs.items())
            + f" ms/outer-iter, against {per_it[0]:.3f} (standard) and "
            f"{per_it[1]:.3f} (--jacobi) unsharded (4g)", flush=True)
        os.remove(e)

    # 4i: bench.py's 4K configuration, built in memory, in turns.
    from srmeetsps_cuda_tpu_torch.io.synthetic import lambertian_dataset

    data4k, true4k = lambertian_dataset(*k4[:2], 2, n=8, c=3, seed=0)
    # The constant E cancels, that of the first depth operator.
    const4k = float(depth_operator(data4k, dev)[2].const)
    runs4k = {"direct": [], "stencil": []}
    for op in ("direct", "stencil", "stencil", "direct"):
        ref = runs4k["stencil" if op == "direct" else "direct"]
        # At 4K E (~120-330) is e_part + const with const ~6e6, rounded to
        # its ulp (0.5) at each of 101 CG steps: as large as the steps the
        # stopping rule compares, so the two operators' traces are printed
        # against each other, not held.
        runs4k[op].append(api_solve(
            label, data4k, true4k, SolverConfig(cg_operator=op),
            ref[0]["energies"] if ref else None, const4k, hold=False))

    def summary(runs, counter):
        if runs[0]["energies"] != runs[1]["energies"]:
            raise AssertionError(f"4K {counter}: a repeated solve gave "
                                 f"{runs[1]['energies']}, the first "
                                 f"{runs[0]['energies']}")
        return {"launches": runs[0]["launches"][counter],
                "outer_iterations": runs[0]["iterations"],
                "ms_per_outer_iteration": [1e3 * r["seconds"] / r["iterations"]
                                           for r in runs],
                "peak_allocated_bytes": max(r["peak_bytes"] for r in runs)}

    k4_direct = summary(runs4k["direct"], "direct_cg")
    k4_stencil = summary(runs4k["stencil"], "stencil_cg")
    print(f"[{label}] 4K 2176x3840 n=8 sf=2, each solve twice with equal "
          "energies: " + "; ".join(
              f"{op} {s['outer_iterations']} outer iterations, "
              + " / ".join(f"{t:.3f}" for t in s["ms_per_outer_iteration"])
              + f" ms/outer-iter, peak allocated "
              f"{s['peak_allocated_bytes'] / 2**30:.3f} GiB"
              for op, s in (("direct", k4_direct), ("stencil", k4_stencil))),
          flush=True)
    direct_launches["direct"]["4k"] = dict(k4_direct, stencil=k4_stencil)

    print(json.dumps({"kernels": [entry, cgs_entry, scaled_entry, pcg_entry,
                                  big_entry]
                      + direct_entries(direct, direct_launches)
                      + shard_entries(
                          shard, {f: r["launches"]
                                  for f, r in shard_runs.items()},
                          big, [(480, 640, 4)])}))
    print(label)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
