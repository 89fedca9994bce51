#!/usr/bin/env python3
"""Smoke test of the PyTorch + CUDA port on one CUDA card.

    python3 chip_smoke.py

Phases (any failed check raises and the script exits non-zero; nothing
falls back to the CPU or to a plain version):

1. environment: the card's name and power limit, torch and CUDA versions;
2. build: the CUDA kernels from ``srmeetsps_cuda_tpu_torch/csrc``, one
   ``nvcc`` per source, all at once;
2b. the inpaint's Jacobi kernel (``csrc/inpaint.cu``) against its plain
   PyTorch loop on the card at the LR grids 480 x 640 and 544 x 960, 512
   sweeps, with 5% of the pixels holes and with the benchmark's one 4 x 6
   hole: bit for bit, ms per 512 sweeps of the kernel and of the loop in
   turns, the launches of one relaxation (ceil(512 / K), K as the library
   reports it) and of the whole inpaint (pyramid seed and passes, from the
   profiler), and ptxas's registers and spills of ``jacobi_pass``; the
   later phases count its launches beside the CG kernels' (``inpaint``,
   ceil(sweeps / K) a capture prepared);
2c. a capture's upload (I, z0 and the mask of ``mitten_sf2`` and of
   ``hd_sf2``, 324 and 551 MB, as one float32 array) in turns: today's
   pageable ``torch.as_tensor``, the pinned staging ring
   (``device.StagingRing``) at each chunk size and slot count of
   UPLOAD_CHUNKS_MB x UPLOAD_SLOTS, ``cudaHostRegister`` of the array +
   copy + unregister (the control), the bare host copy into pinned memory
   on one thread and on ATen's threads (and ``np.copyto``), and the DMA
   from pinned memory alone: GB/s of each (median of the turns), the
   ring's host-blocked ms, each ring's result bit for bit the pageable
   copy's, and the ring's one-off allocation at the program's constants;
3. each kernel against its plain PyTorch version on the card, on depth
   operators built by the port from a seeded Lambertian dataset: the C
   planes, iteration counts, x after 2 and 12 iterations and the tracked
   energy, with the tolerances of tests/test_torch_stencil_cg.py, and the
   time per CG iteration of both; on phase 3's grids and on 242 x 322
   (partial tiles on both edges at each block shape), at the thread blocks
   256 x 4, 32 x 16 and 30 x 3 (BLOCKS). The stencil and CGS kernels are
   persistent (one cooperative launch per CG solve, its CTA count and
   layout chosen by the C entry from the card's occupancy): phases 3 to 3e
   check that every solve made one device launch (as the C entry reports
   it), that a repeated run is bit-equal at each block shape, that 960 x
   1280 at B = 1 runs on chip and B = 4 and 2176 x 3840 in device memory,
   and print per grid the layout taken, the CTAs, the barriers per
   iteration, the shared bytes and the registers and spills (the launch's
   attributes and nvcc's ``-Xptxas -v`` report); at 960 x 1280 both
   kernels in the device layout too, forced, bit for bit their on-chip
   runs, timed against them in turns (``layouts_bit_equal``);
3b. the lane-batched stencil CG (B = 4 seeds at 960 x 1280, sf = 2, the
   device layout): each lane bit for bit its B = 1 launch (the on-chip
   layout), the batch against the plain version, ms per CG iteration of
   the batch and of four solo launches;
3c. the Chronopoulos-Gear CG kernel against its plain version on the grids
   of phase 3 (``cg_vs_plain``), 4 seeds, from the main path's warm
   start and from a cold start x0 = 0, at the thread blocks of BLOCKS:
   iteration counts, the update x - x0 and gamma = <r, r> after 2 and 12
   iterations (bounds at UPD_BOUND and RES_BOUND), B = 4 lanes bit for bit
   their solo launches;
3d. the Jacobi forms of the stencil CG (``invd``) the same way on the grids
   of phase 3 and at 960 x 1280 sf = 4, with the reported residual in place
   of gamma, C' bit-equal, and the tracked energy from the warm start at
   phase 3's bound at every cap;
3e. 1088 x 1920, sf = 2 (the grid the TPU serves with
   ``_kernel_vmem_hybrid_stencil``): the stencil CG plain with phase 3's
   checks and Jacobi with phase 3d's; the CGS kernel there, and both
   kernels at 2176 x 3840 (after 3f's 4K part), timed with the update and
   residual held at UPD_BOUND / RES_BOUND (``time_large``);
3f. the direct mask-gated matvec CG (``direct_cg``, persistent like the
   stencil and CGS kernels) the same way on the grids of phase 3 and at
   2176 x 3840, sf = 2 (bench.py's 4K grid), in its three forms: r0 in the
   kernel with the tracked energy, the same with its in-sweep Jacobi PCG,
   and given its residual, at phase 3c's block shapes (30 x 3 splits sf =
   4 tiles): one device launch per CG solve, a repeat bit-equal at each
   block, the device layout (its only one: ``EXPECT_LAYOUT``), the
   registers and spills of each instance; then the direct and the stencil
   operator against each other on the card (matvecs to f32 roundoff, the
   two kernels' CGs within phase 3c's bounds);
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
4m. the outer iteration's glue from CUDA graphs (``models/glue.py``): the
   phase-4 file's fused solve through ``runtime.solver.solve`` and the
   phase-4b lanes' lockstep solve, each with the graphs and with the
   engagement rule forced false, bit for bit equal, with the launches of
   the CG and inpaint kernels counted as expected, the ``glue_replays``
   counter at every iteration but each solve's first two (the eager and the
   capture one; B lanes each in lockstep), a second fused solve of the
   same key replaying every iteration from the graphs the first kept, and
   ms per outer iteration of both in turns;
4i. bench.py's 4K configuration (2176 x 3840, sf = 2, n = 8, c = 3) through
   ``runtime.solver.solve`` with ``"direct"`` and with ``"stencil"``, in
   turns: a finite depth, the stopping rule, outer iterations, ms per
   outer iteration and the peak of allocated device memory; then the
   ``"stencil"`` and the ``"direct"`` solve once more each with its CG's
   plain version on the card, their outer iterations and energies printed
   beside the kernels';
3g. the row-shard kernels (``csrc/shard_cg.cu``) on 4 shards of the card
   against their plain versions on the same shards, on phase 3's grids, on
   248 x 322 sf = 2 (a width of no whole number of 16-byte pieces) and at
   1088 x 1920 sf = 2, in the standard, CGS and Jacobi forms, from the
   warm and a cold start (``cg_vs_plain``'s bounds, iteration counts
   equal): the persistent kernels (the route of a one-device mesh: one
   cooperative launch per solve over every shard) at the thread blocks of
   BLOCKS, one device launch per solve, a repeat bit-equal at each block,
   and the per-step kernels (``route="steps"``, the route of shards on
   distinct cards) at 256 x 4 and 32 x 16, each held to plain and the two
   routes to each other; the 4-shard CG against the unsharded kernel of
   the same recurrence (Jacobi: the direct CG's PCG) within the same
   bounds; ms per CG iteration of both routes and of plain, in turns, the
   persistent launches' layout, CTAs, shared bytes, registers and spills,
   and the device time of one launch of each per-step wrapper;
4j. BASELINE.md configuration 5 (1088 x 1920, n = 20, c = 3, sf = 2)
   through ``parallel.sharded.solve_fused_sharded`` on 4 shards of the
   card in the three forms: the problem and state placed in row bands
   (every phase on the bands) and the whole-grid glue (``glue="grid"``)
   in turns, banded, grid, grid, banded, on the persistent route (the
   banded repeat bit-equal), then the banded route once on the per-step
   route and once with the plain per-shard steps, each run's launch
   counts read (every depth CG one persistent launch; on the per-step
   route its kernels' launches); the stopping rule, and each kernel route
   and the banded against the whole-grid glue at most one outer iteration
   from the plain run with every energy within phase 3's bound of it; the
   persistent run the same against phase 4g's unsharded run for the
   standard and CGS forms (Jacobi: printed, as 4g takes the scaled form);
   ms per outer iteration and the peak allocated of both glues, and the
   bytes each shard holds of the placed problem and state; then
   ``--sharded 4`` through the CLI on the phase-4 file (one shard per card
   present: on one card the persistent kernel);
4l. the ``('data', 'x', 'y')`` mesh: ``make_mesh(4, data=2)`` over the
   card, two 960 x 1280 n = 20 lanes (the phase-4 dataset and seed 2's),
   each on 2 row bands (``shard_pytree(..., batched=True)``): one
   ``step_sharded`` of the batch (one persistent launch per lane), each
   lane's energy within phase 3's bound of its solo solve's first; then
   each lane's ``solve_sharded`` held to its solo solve as 4j's runs are
   to the plain run, every depth CG one persistent launch; ms per outer
   iteration of each lane and of its solo solve.

4k. the options the JAX CLI has beyond the kernels, on the phase-4 file:
   ``--image-dtype bfloat16`` through the CLI (every depth CG one stencil
   launch, the phase-4 checks), the same bf16 problem with the stencil
   CG's plain version on the card (at most one outer iteration more or
   less, every energy within phase 3's bound), iteration 1's s and energy
   within tests/test_config_modes.py::TestBF16Images's bound of the f32
   run's, ms per outer iteration and peak memory of f32 and bf16 solves in
   turns; ``--profile-dir`` (one trace, its CUDA kernel events the stencil
   kernel's launches); ``--nan-check`` (a clean solve's outputs bit for bit
   those without it; a NaN written into I inside the mask raises
   FloatingPointError naming a phase); ``--dump-operators`` (the four
   files equal what ``io/sparse_dump`` computes on the host for the same
   mask); ``--show`` without a display (a warning, the same outputs); and
   in 4i one bf16 ``"stencil"`` solve of the 4K configuration, its peak
   memory printed beside the f32 run's.

5. the port's bench, ``python -m srmeetsps_cuda_tpu_torch.bench`` (bench.py's
   sections on bench.py's inputs), as subprocesses: first ``torch.profiler``
   over a chain of two ``srps_iteration`` calls on the bench's 960 x 1280
   input (no synchronise and no host read inside it, so the CUDA events of
   the bench's chains time device work alone), and that input solved on
   the card with the stencil CG's plain version; then the default mode,
   ``4k`` and ``batched-mixed``. Each exits 0, every line it prints is
   JSON, its last line holds every key of ``bench.KEYS`` for the mode and
   no ``*_error`` key, and each section's stderr note counts stencil CG
   launches (the device metrics' direct CG launches too). The default
   mode's ``accuracy_ok``, ``bf16_accuracy_ok`` and
   ``matpath_energy_matches`` are true, its ``iterations`` within one of
   the plain solve's and its ``final_energy`` within phase 3's energy bound
   of the plain trace at that iteration, its ``ms_per_cg_iter`` within a
   factor 2 of phase 3's time of the stencil kernel at 960 x 1280;
   ``bf16_energy_ok`` is printed, not held (the bf16 energy's constant is
   the reference's).

The line before the last but one is a JSON object with one entry per
kernel and mode (its times per CG iteration at the main path's shapes, and
the least time the card could take for the same work), the line before the
last the card's name and power limit; the last line is
``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import contextlib
import dataclasses
import glob
import io
import itertools
import json
import math
import os
import re
import shutil
import statistics
import subprocess
import sys
import tempfile
import time
import warnings

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
# The direct-matvec CG (csrc/direct_cg.cu), counted from _matvec_band: the
# matvec about 42 flops a pixel (gradients 10, t1..t3 15, the adjoints 10,
# the tile sum and the sums 7) and the p update, dots and vector updates 8
# per iteration; r0 in the kernel adds the rhs (~12), M x0 (42), the energy
# (~45) and a dot to the prologue; a given residual only the dot. Jacobi adds
# rz and z = invd r (3 per iteration, 2 in the prologue). Planes read once
# and written once: F (11), R0 (4) and Z0U (2) or b (1), x0 in, x out, and
# invd under Jacobi (what the design streams: persistent_planes).
DIRECT_FORMS = {
    # form: (flops, planes)
    "direct": ({"prologue": 100, "iteration": 50}, 19),
    "direct jacobi": ({"prologue": 102, "iteration": 53}, 20),
    "direct host_r0": ({"prologue": 2, "iteration": 50}, 14),
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
          sf: int, stream_planes: int, per: int = None):
    """``(ms, "bytes" or "operations", stream_ms)`` per CG iteration: the
    least time the card could take for the function (inputs read once,
    outputs written once; the operations of the ``iters`` iterations this
    run's data needed), spread over ``per`` iterations (the launched ones,
    by default ``iters``), and the per-iteration streaming time of the
    kernel's design, ``stream_planes`` f32 planes."""
    t_bytes = planes * 4 * hw * lanes / HBM_BYTES_PER_S
    per_iter = flops["iteration"] + (2 if sf == 4 else 0)
    t_ops = hw * lanes * (flops["prologue"] + iters * per_iter) \
        / F32_FLOPS_PER_S
    ms = 1e3 * max(t_bytes, t_ops) / (per or iters)
    stream = 1e3 * stream_planes * 4 * hw * lanes / HBM_BYTES_PER_S
    return ms, "bytes" if t_bytes >= t_ops else "operations", stream


# f32 planes one CG iteration of the persistent kernels (csrc/stencil_cg.cu,
# csrc/cgs_cg.cu, csrc/direct_cg.cu) streams, by layout: the stencil CG's
# phase A reads 9 C, r and p_old (PCG invd) and writes p, phase B reads p
# and r (PCG invd) and writes r; in device memory w is written and read and
# x read and written too. The CGS reads 9 C and one (r, w, s) set and
# writes the other; in device memory x and p are read and written too. sf =
# 4 reads ktw. The direct CG (device layout only) reads F's 11 planes (ktw
# at every sf) where the stencil's reads 9 C, and PCG invd in both phases.
# The row-shard CG (device layout only) streams as the stencil and CGS
# kernels in device memory, its Jacobi form as the stencil's PCG.
def persistent_planes(kernel: str, form, onchip: bool, sf: int) -> int:
    planes = 15 if onchip else 19
    if kernel == "direct_cg":
        return planes + 2 + (2 if "jacobi" in form else 0)
    if form in ("pcg", "jacobi"):
        planes += 2
    return planes + (1 if sf == 4 else 0)


def ptxas_report(name: str) -> dict:
    """Registers and spill bytes of each persistent kernel instance of
    ``csrc/<name>.cu`` from nvcc's ``-Xptxas -v`` report: {"cg_kernel<mode,
    onchip,bx,by>", "cgs_kernel<onchip,bx,by>", "direct_kernel<jacobi,
    bx,by>", "shard_std_kernel<jacobi,bx,by>" or "shard_cgs_kernel<bx,
    by>": {"registers", "spill_stores", "spill_loads"}} (bx, by: the block
    compiled in, or 0, 0)."""
    import re

    from srmeetsps_cuda_tpu_torch import native

    out, cur = {}, None
    for line in native.build_log(name).splitlines():
        m = re.search(r"(?:Compiling entry function|Function properties "
                      r"for) '?(\S+?)'?(?: for |$)", line)
        if m:
            k = re.search(r"(shard_std_kernel|shard_cgs_kernel|cgs_kernel|"
                          r"cg_kernel|direct_kernel)I(?:Li(\d)E)?"
                          r"(?:Lb([01])E)?Li(\d+)ELi(\d+)EE", m.group(1))
            cur = None if k is None else (
                k.group(1) + "<" + ",".join(
                    g for g in k.groups()[1:] if g is not None) + ">")
            continue
        if cur is None:
            continue
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                      line)
        if m:
            out.setdefault(cur, {}).update(spill_stores=int(m.group(1)),
                                           spill_loads=int(m.group(2)))
        m = re.search(r"Used (\d+) registers", line)
        if m:
            out.setdefault(cur, {})["registers"] = int(m.group(1))
    return out


# The thread blocks the kernels are held at: the CLI's default, another
# whole number of warps, and 30 x 3 (90 threads, no whole number of warps,
# whose rows and columns split sf = 4 tiles).
BLOCKS = ((256, 4), (32, 16), (30, 3))
# The layout the C entry must choose at 960 x 1280, B = 1, at both standard
# blocks, per cg_vs_plain form: the CGS keeps x and p on chip; the direct
# CG has the device layout alone (its staged F fields fill the shared
# memory).
EXPECT_LAYOUT = {"cgs": "on-chip", "direct": "device",
                 "direct jacobi": "device", "direct host_r0": "device"}


def expect_layout(infos: dict, want: str, where: str) -> None:
    """Raise unless the persistent launches of the two standard blocks in
    ``infos`` (block -> last_launch) took layout ``want``."""
    for block in BLOCKS[:2]:
        if infos[block]["layout"] != want:
            raise AssertionError(f"{where} block {block}: "
                                 f"{infos[block]['layout']} layout, expected "
                                 f"{want}")


def one_launch(wrapper, where: str) -> dict:
    """The last launch of a persistent kernel's ``wrapper``, which must
    have been one device launch for the CG solve."""
    info = wrapper.last_launch
    if info is None or info["device_launches"] != 1:
        raise AssertionError(f"{where}: {info and info['device_launches']} "
                             "device launches for one CG solve")
    return info


def launch_summary(kernel: str, form, infos: dict, sf: int) -> tuple:
    """``(text, JSON fields)`` of the launches of one grid, per block
    shape: the layout, the CTAs, barriers per iteration, shared bytes,
    registers and local bytes at run time, and ptxas's registers and
    spills for the kernel instance that ran."""
    mode = {None: 0, "scaled": 1, "pcg": 2}.get(form, 0)
    report = ptxas_report(kernel)
    texts, fields = [], {}
    for (bx, by), info in infos.items():
        shape = f"{bx},{by}" if (bx, by) in ((256, 4), (32, 16)) else "0,0"
        onchip = int(info["onchip"])
        if kernel == "cgs_cg":
            inst = f"cgs_kernel<{onchip},{shape}>"
        elif kernel == "shard_cg":
            inst = (f"shard_cgs_kernel<{shape}>" if form == "cgs" else
                    f"shard_std_kernel<{int(form == 'jacobi')},{shape}>")
        elif kernel == "direct_cg":
            inst = f"direct_kernel<{int('jacobi' in form)},{shape}>"
        else:
            inst = f"cg_kernel<{mode},{onchip},{shape}>"
        px = report.get(inst, {})
        planes = persistent_planes(kernel, form, info["onchip"], sf)
        texts.append(
            f"block {bx}x{by}: {info['layout']} layout, G {info['ctas']} "
            f"({info['resident_ctas_per_sm']} resident per SM x "
            f"{info['sms']} SMs), {info['barriers_per_iteration']} "
            f"barrier(s) per iteration, {info['shared_bytes']} B shared, "
            f"{info['registers']} registers / {info['local_bytes']} B local;"
            f" ptxas {inst}: {px.get('registers')} registers, "
            f"{px.get('spill_stores')} / {px.get('spill_loads')} B spill "
            f"stores / loads; stream {planes} planes")
        fields[f"{bx}x{by}"] = {
            "layout": info["layout"], "ctas": info["ctas"],
            "barriers_per_iteration": info["barriers_per_iteration"],
            "shared_bytes": info["shared_bytes"],
            "registers": info["registers"],
            "local_bytes": info["local_bytes"], "ptxas": px,
            "stream_planes": planes}
    return "; ".join(texts), fields


INPAINT_GRIDS = ((480, 640), (544, 960))
INPAINT_SWEEPS = 512


def inpaint_ptxas() -> dict:
    """Registers, spill bytes and static shared memory of ``jacobi_pass``
    (``csrc/inpaint.cu``) from nvcc's ``-Xptxas -v`` report."""
    from srmeetsps_cuda_tpu_torch import native

    out, cur = {}, None
    for line in native.build_log("inpaint").splitlines():
        m = re.search(r"(?:Compiling entry function|Function properties "
                      r"for) '?(\S+?)'?(?: for |$)", line)
        if m:
            cur = "jacobi_pass" if "jacobi_pass" in m.group(1) else None
            continue
        if cur is None:
            continue
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                      line)
        if m:
            out.setdefault(cur, {}).update(spill_stores=int(m.group(1)),
                                           spill_loads=int(m.group(2)))
        m = re.search(r"Used (\d+) registers", line)
        if m:
            out.setdefault(cur, {})["registers"] = int(m.group(1))
        m = re.search(r"(\d+) bytes smem", line)
        if m:
            out.setdefault(cur, {})["shared_bytes"] = int(m.group(1))
    return out


def inpaint_inputs(h: int, w: int, pattern: str, device):
    """(u0, img, known_b) of the inpaint on a seeded depth of ``h`` x ``w``:
    ``dense`` holes at 5% of the pixels, or the ``bench``mark's one 4 x 6
    hole (``bench_torch/data.py``'s frame 0)."""
    import torch

    from srmeetsps_cuda_tpu_torch.pre import inpaint as ik

    gen = torch.Generator(device=device)
    gen.manual_seed(h * w)
    img = 800.0 + 50.0 * torch.rand(h, w, generator=gen, device=device)
    if pattern == "dense":
        holes = torch.rand(h, w, generator=gen, device=device) < 0.05
    else:
        holes = torch.zeros(h, w, dtype=torch.bool, device=device)
        holes[10:14, 20:26] = True
    known = 1.0 - holes.to(torch.float32)
    known_b = known > 0
    return torch.where(known_b, img, ik.pyramid_fill(img, known)), img, known_b


def inpaint_vs_plain(label, dev) -> dict:
    """Phase 2b on ``dev``. Returns the kernel's JSON entry."""
    import torch

    from srmeetsps_cuda_tpu_torch.pre import inpaint as ik

    n = INPAINT_SWEEPS
    k = ik.sweeps_per_pass()
    passes = inpaint_passes(1, n)
    entry = {"name": "inpaint", "sweeps": n, "k": k, "grids": {}}
    for h, w in INPAINT_GRIDS:
        for pattern in ("dense", "bench"):
            u, img, known_b = inpaint_inputs(h, w, pattern, dev)
            want = ik.relax_plain(u, img, known_b, n)
            before = launch_count("inpaint")
            got = ik.relax_cuda(u.clone(), known_b, n)
            torch.cuda.synchronize()
            if not torch.equal(got, want):
                raise AssertionError(
                    f"inpaint {h}x{w} {pattern}: {int((got != want).sum())} "
                    "pixels differ from the plain loop")
            launched = launch_count("inpaint") - before
            if launched != passes:
                raise AssertionError(f"inpaint: {launched} launches for {n} "
                                     "sweeps")
            plain = lambda: ik.relax_plain(u, img, known_b, n)  # noqa: E731
            kernel = lambda: ik.relax_cuda(u.clone(), known_b, n)  # noqa: E731
            ms = {"plain": [cuda_ms(plain, 2)], "kernel": []}
            ms["kernel"] += [cuda_ms(kernel, 20), cuda_ms(kernel, 20)]
            ms["plain"].append(cuda_ms(plain, 2))
            holes = ~known_b
            with torch.profiler.profile(activities=[
                    torch.profiler.ProfilerActivity.CPU,
                    torch.profiler.ProfilerActivity.CUDA]) as prof:
                ik.inpaint_diffusion(img, holes, iters=n)
                torch.cuda.synchronize()
            kernels = sum(1 for e in prof.events()
                          if e.device_type == torch.autograd.DeviceType.CUDA
                          and "memcpy" not in e.name.lower()
                          and "memset" not in e.name.lower())
            n_holes = int(holes.sum())
            # 9 operations a hole a sweep (7 adds, 2 products); u, the mask
            # and the result once each.
            t_ops = 9 * n * n_holes / F32_FLOPS_PER_S
            t_bytes = 9 * h * w / HBM_BYTES_PER_S
            bound_ms = 1e3 * max(t_ops, t_bytes)
            by = "operations" if t_ops >= t_bytes else "bytes"
            speedup = statistics.median(ms["plain"]) / statistics.median(
                ms["kernel"])
            print(f"[{label}] inpaint {h}x{w} {pattern} ({n_holes} holes): "
                  f"{n} sweeps bit-equal to the plain loop; ms per {n} "
                  f"sweeps in turns plain {ms['plain'][0]:.3f}, kernel "
                  f"{ms['kernel'][0]:.4f} / {ms['kernel'][1]:.4f}, plain "
                  f"{ms['plain'][1]:.3f} ({speedup:.0f}x); bound "
                  f"{bound_ms:.5f} ms ({by}); "
                  f"{passes} launches per relaxation, {kernels} kernels in "
                  "the whole inpaint", flush=True)
            entry["grids"][f"{h}x{w} {pattern}"] = {
                "holes": n_holes, "ms": ms,
                "bound_ms": bound_ms, "kernels_in_inpaint": kernels}
    entry["ptxas"] = report = inpaint_ptxas()
    print(f"[{label}] inpaint ptxas: " + "; ".join(
        f"{inst}: {r.get('registers')} registers, {r.get('spill_stores')} / "
        f"{r.get('spill_loads')} B spill stores / loads, "
        f"{r.get('shared_bytes')} B static shared" for inst, r in
        sorted(report.items())), flush=True)
    return entry


UPLOAD_BYTES = {"mitten_sf2": 324_403_200, "hd_sf2": 551_485_440}
UPLOAD_CHUNKS_MB = (8, 16, 32, 64)
UPLOAD_SLOTS = (2, 3)


def upload_phase(label, reps: int = 9) -> dict:
    """Phase 2c: the ways a capture's host bytes can cross to the card,
    timed in turns on one float32 array of each size of UPLOAD_BYTES (a
    capture's I, z0 and mask), each ring's result held bit for bit to the
    pageable copy's. Prints and returns GB/s (median of ``reps`` turns) by
    way, and the ring's host-blocked ms."""
    import numpy as np
    import torch

    from srmeetsps_cuda_tpu_torch import device as devices

    dev = torch.device("cuda")
    cudart = torch.cuda.cudart()
    threads = torch.get_num_threads()
    t0 = time.perf_counter()
    devices.StagingRing()
    alloc_s = time.perf_counter() - t0
    rings = {f"ring {mb} MB x {s}": devices.StagingRing(mb << 20, s)
             for mb in UPLOAD_CHUNKS_MB for s in UPLOAD_SLOTS}
    out = {"aten_threads": threads, "cpus": os.cpu_count(),
           "ring_alloc_s": alloc_s,
           "constants": {"chunk_mb": devices.STAGE_CHUNK >> 20,
                         "slots": devices.STAGE_SLOTS}, "sizes": {}}
    for name, nbytes in UPLOAD_BYTES.items():
        n = nbytes // 4
        a = np.random.default_rng(0).standard_normal(n, np.float32)
        src = torch.from_numpy(a)
        want = torch.as_tensor(a, device=dev)
        pinned = torch.empty(n, dtype=torch.float32, pin_memory=True)
        dst = torch.empty(n, dtype=torch.float32, device=dev)

        def registered():
            ptr = src.data_ptr()
            torch.cuda.check_error(cudart.cudaHostRegister(ptr, nbytes, 0))
            try:
                dst.copy_(src)
            finally:
                torch.cuda.check_error(cudart.cudaHostUnregister(ptr))

        def host_copy(k):
            def go():
                torch.set_num_threads(k)
                try:
                    pinned.copy_(src)
                finally:
                    torch.set_num_threads(threads)
            return go

        ways = {"pageable": lambda: torch.as_tensor(a, device=dev),
                "registered": registered,
                "host copy 1 thread": host_copy(1),
                f"host copy {threads} threads": host_copy(threads),
                "np.copyto": lambda: np.copyto(pinned.numpy(), a),
                "dma from pinned": lambda: dst.copy_(pinned,
                                                     non_blocking=True)}
        ways.update({k: (lambda r=r: r.copy(src, dst))
                     for k, r in rings.items()})
        done = {k: [] for k in ways}
        back = {k: [] for k in ways}
        for rep in range(reps):
            order = list(ways) if rep % 2 == 0 else list(ways)[::-1]
            for k in order:
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                ways[k]()
                back[k].append(time.perf_counter() - t0)
                torch.cuda.synchronize()
                done[k].append(time.perf_counter() - t0)
                if k.startswith(("ring", "registered")) and \
                        not torch.equal(dst, want):
                    raise AssertionError(f"upload {name}: {k} differs from "
                                         "the pageable copy")
                dst.zero_()
        gbps = {k: nbytes / statistics.median(v) / 1e9
                for k, v in done.items()}
        blocked = {k: 1e3 * statistics.median(back[k]) for k in rings}
        best = max(rings, key=gbps.get)
        out["sizes"][name] = {"bytes": nbytes, "gbps": gbps,
                              "ring_host_ms": blocked, "best_ring": best}
        print(f"[{label}] upload {nbytes} B ({name}), ATen threads "
              f"{threads} of {os.cpu_count()} CPUs, median of {reps} in "
              "turns, GB/s: " + ", ".join(
                  f"{k} {v:.2f}" for k, v in gbps.items() if k not in rings)
              + "; rings (GB/s, host ms): " + ", ".join(
                  f"{k[5:]} {gbps[k]:.2f} / {blocked[k]:.1f}"
                  for k in rings)
              + f"; fastest ring {best[5:]}; every ring bit-equal to the "
              "pageable copy", flush=True)
        del want, pinned, dst
        torch.cuda.empty_cache()
    print(f"[{label}] upload: the program's ring "
          f"{devices.STAGE_CHUNK >> 20} MB x {devices.STAGE_SLOTS}, "
          f"allocated in {1e3 * alloc_s:.1f} ms", flush=True)
    print(json.dumps({"upload": out}), flush=True)
    return out


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
        errs, infos = {}, {}
        for cap in (2, 12, 100):
            before = launch_count("stencil_cg")
            x, k, _, e, C = sc.stencil_cg(*args, sf=sf, lam=1.0,
                                          max_iter=cap, planes=True)
            torch.cuda.synchronize()
            if launch_count("stencil_cg") != before + 1:
                raise AssertionError("stencil_cg did not count its launch")
            infos[256, 4] = one_launch(sc.stencil_cg, f"{h}x{w} cap {cap}")
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
        # Other thread-block shapes (--blockx/--blocky): other partial sums,
        # the same bounds; 30 x 3 is no whole number of warps.
        px, pk, _, _ = sc.stencil_cg_plain(*args, sf=sf, lam=1.0,
                                           max_iter=12)
        for block in BLOCKS[1:]:
            xb, kb, _, _ = sc.stencil_cg(*args, sf=sf, lam=1.0, max_iter=12,
                                         block=block)
            infos[block] = one_launch(sc.stencil_cg,
                                      f"{h}x{w} block {block}")
            if int(kb) != int(pk):
                raise AssertionError(f"block {block}: iterations {int(kb)} "
                                     f"vs {int(pk)}")
            check_close(f"x {h}x{w} sf={sf} block {block}", xb.cpu(),
                        px.cpu(), X_TOL[12], X_TOL[12])
        if (h, w) == (960, 1280):
            expect_layout(infos, "on-chip", f"stencil_cg {h}x{w} B=1")
        repeat_bit_equal(lambda blk: sc.stencil_cg(*args, sf=sf, lam=1.0,
                                                   max_iter=12, block=blk),
                         f"stencil_cg {h}x{w} sf={sf}")
        launches, fields = launch_summary("stencil_cg", None, infos, sf)
        cap = 100
        run_k = lambda: sc.stencil_cg(*args, sf=sf, lam=1.0, max_iter=cap)  # noqa: E731
        run_p = lambda: sc.stencil_cg_plain(*args, sf=sf, lam=1.0,  # noqa: E731
                                            max_iter=cap)
        t_k1, t_p1, t_p2, t_k2 = (cuda_ms(run_k, 3), cuda_ms(run_p, 2),
                                  cuda_ms(run_p, 2), cuda_ms(run_k, 3))
        ms_k = (t_k1 + t_k2) / 2 / (cap + 1)
        ms_p = (t_p1 + t_p2) / 2 / (cap + 1)
        main = fields["256x4"]
        b_ms, b_by, s_ms = bound(h * w, 1, int(k), STENCIL_PLANES,
                                 STENCIL_FLOPS, sf, main["stream_planes"],
                                 per=cap + 1)
        print(f"[{label}] stencil_cg {h}x{w} sf={sf}: iterations {int(k)} "
              f"equal; max|dx| at 2/12/101 iterations {errs[2]:.3e} / "
              f"{errs[12]:.3e} / {errs[100]:.3e}; max|dC| {errs_c:.3e}; "
              f"one device launch per CG solve, repeat bit-equal at "
              f"{len(BLOCKS)} blocks; kernel {ms_k:.4f} ms/CG-iter, plain "
              f"{ms_p:.4f} ms/CG-iter, bound {b_ms:.5f} ({b_by}), stream "
              f"bound {s_ms:.4f}; {launches}", flush=True)
        entries[h, w, sf] = {
            "name": "stencil_cg", "route": "cuda",
            "source": "srmeetsps_cuda_tpu_torch/csrc/stencil_cg.cu",
            "replaces": "srmeetsps_cuda_tpu/solve/pallas_cg_vmem.py:"
                        + ("708" if (h, w) == (1088, 1920) else "403"),
            "max_abs_err": errs[2], "ms": ms_k, "plain_ms": ms_p,
            "bound_ms": b_ms, "bound_by": b_by, "stream_bound_ms": s_ms,
            "library_ms": None, "design": "persistent",
            "layout": main["layout"], "stream_planes": main["stream_planes"],
            "launch": fields,
            "unit": f"per CG iteration, {h}x{w} sf {sf}, {cap + 1} "
                    "iterations launched"}
    return entries


def repeat_bit_equal(run, what):
    """``run(block)`` twice at each of BLOCKS: every output bit for bit
    the same."""
    import torch

    for block in BLOCKS:
        a, b = run(block), run(block)
        if not all(torch.equal(u, v) for u, v in zip(a, b)):
            raise AssertionError(f"{what} block {block}: a repeated run "
                                 "differs")


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
        batch = one_launch(sc.stencil_cg, f"B={B} cap {cap}")
        for b, ln in enumerate(lanes):
            x1, k1, _, e1 = sc.stencil_cg(*ln, sf=sf, lam=1.0, max_iter=cap)
            solo = one_launch(sc.stencil_cg, f"lane {b} cap {cap}")
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
    for info, want in ((batch, "device"), (solo, "on-chip")):
        if info["layout"] != want:
            raise AssertionError(f"B={B}: {info['layout']} layout, expected "
                                 f"{want}")
    n_it = int(kb[0])
    ms_b = (t_b1 + t_b2) / 2 / n_it
    ms_s = (t_s1 + t_s2) / 2 / n_it
    planes = persistent_planes("stencil_cg", None, batch["onchip"], sf)
    b_ms, b_by, s_ms = bound(h * w, B, n_it, STENCIL_PLANES, STENCIL_FLOPS,
                             sf, planes)
    entry["batched"] = {"lanes": B, "ms": ms_b, "solo_ms": ms_s,
                        "plain_ms": t_p / n_it, "bound_ms": b_ms,
                        "bound_by": b_by, "stream_bound_ms": s_ms,
                        "layout": batch["layout"], "stream_planes": planes,
                        "solo_layout": solo["layout"]}
    print(f"[{label}] stencil_cg B={B} lanes {h}x{w} sf={sf}: every lane "
          f"({solo['layout']} layout) bit-equal to its lane in the batch "
          f"({batch['layout']} layout, G {batch['ctas']}, one device launch)"
          f" at caps 2/12/100, batch vs plain within X_TOL/E_RTOL; batch "
          f"{ms_b:.4f} ms/CG-iter vs 4 solo launches {ms_s:.4f} ms/CG-iter, "
          f"plain {t_p / n_it:.4f}, stream bound {s_ms:.4f}", flush=True)


def layouts_bit_equal(label, lanes, entries):
    """Phase 3: the persistent kernels at 960 x 1280 sf 2, B = 1, where the
    C entry takes the on-chip layout, with the device layout forced too:
    the standard CG, its scaled Jacobi form and the CGS CG, each at the two
    standard blocks and caps 12 and 100, bit for bit the on-chip run; then
    ms per CG iteration of both layouts in turns (on chip, device, device,
    on chip) at the default block, added to ``entries[name]`` as
    ``device_layout_ms``."""
    import torch

    from srmeetsps_cuda_tpu_torch.solve import cgs_cg as cg
    from srmeetsps_cuda_tpu_torch.solve import stencil_cg as sc

    sf, ln = 2, lanes[0]
    runs = {"stencil_cg": (sc.stencil_cg, ln[:6], {}),
            "stencil_cg jacobi scaled": (sc.stencil_cg, ln[:6],
                                         {"invd": ln[6]}),
            "cgs_cg": (cg.cgs_cg, ln[:5], {})}
    texts = []
    for name, (kernel, args, kw) in runs.items():
        for block, cap in itertools.product(BLOCKS[:2], (12, 100)):
            out = {}
            for layout, want in ((None, "on-chip"), ("device", "device")):
                out[want] = kernel(*args, sf=sf, lam=1.0, max_iter=cap,
                                   block=block, layout=layout, **kw)
                info = one_launch(kernel, f"{name} layout {want}")
                if info["layout"] != want:
                    raise AssertionError(f"{name} block {block}: "
                                         f"{info['layout']} layout, "
                                         f"expected {want}")
            if not all(torch.equal(a, b) for a, b in zip(out["on-chip"],
                                                         out["device"])):
                raise AssertionError(f"{name} block {block} cap {cap}: the "
                                     "device layout differs from on chip")
        def on():
            return kernel(*args, sf=sf, lam=1.0, max_iter=100, **kw)

        def dev():
            return kernel(*args, sf=sf, lam=1.0, max_iter=100,
                          layout="device", **kw)

        t_o1, t_d1, t_d2, t_o2 = (cuda_ms(on, 3), cuda_ms(dev, 3),
                                  cuda_ms(dev, 3), cuda_ms(on, 3))
        n_it = 101  # launched
        ms_on, ms_dev = (t_o1 + t_o2) / 2 / n_it, (t_d1 + t_d2) / 2 / n_it
        entries[name]["device_layout_ms"] = ms_dev
        entries[name]["onchip_layout_ms"] = ms_on
        texts.append(f"{name} {ms_on:.4f} on chip / {ms_dev:.4f} device "
                     f"(turns {t_o1 / n_it:.4f} {t_d1 / n_it:.4f} "
                     f"{t_d2 / n_it:.4f} {t_o2 / n_it:.4f})")
    print(f"[{label}] layouts at 960x1280 sf=2 B=1: device layout bit-equal "
          f"to on chip at blocks 256x4 and 32x16, caps 12 and 100; ms per "
          f"launched CG iteration " + "; ".join(texts), flush=True)


def time_large(label, grid, lanes):
    """The persistent kernels at a grid timed once (4K, and CGS at 1088 x
    1920): on seed 0's warm start, iteration counts equal to the plain
    version's, the update and the residual after 2 and 12 iterations
    within UPD_BOUND / RES_BOUND, one device launch per solve, a repeat
    bit-equal at each block, the device layout at 4K, and ms per CG
    iteration of kernel and plain in turns; the energy gap is printed.
    Returns {name: entry}."""
    import torch

    from srmeetsps_cuda_tpu_torch.solve import cgs_cg as cg
    from srmeetsps_cuda_tpu_torch.solve import stencil_cg as sc

    h, w, sf = grid
    ln = lanes[0]
    x0, const = ln[0], float(ln[1].const)
    runs = {"stencil_cg": (sc.stencil_cg, sc.stencil_cg_plain, ln[:6]),
            "cgs_cg": (cg.cgs_cg, cg.cgs_cg_plain, ln[:5])}
    out = {}
    for name, (kernel, plain, args) in runs.items():
        if name == "stencil_cg" and grid != (2176, 3840, 2):
            continue
        for cap in (2, 12):
            got = kernel(*args, sf=sf, lam=1.0, max_iter=cap)
            info = one_launch(kernel, f"{name} {h}x{w} cap {cap}")
            want = plain(*args, sf=sf, lam=1.0, max_iter=cap)
            if int(got[1]) != int(want[1]):
                raise AssertionError(f"{name} {h}x{w} cap {cap}: iterations "
                                     f"{int(got[1])} vs {int(want[1])}")
            upd = rel_rms(got[0] - x0, want[0] - x0)
            gap = abs(float(got[2]) - float(want[2])) / abs(float(want[2]))
            if upd > UPD_BOUND["warm"][cap] or gap > RES_BOUND["warm"][cap]:
                raise AssertionError(f"{name} {h}x{w} cap {cap}: update "
                                     f"{upd:.3e}, residual {gap:.3e}")
            if cap == 2:
                max_dx = float((got[0] - want[0]).abs().max())
        if grid == (2176, 3840, 2) and info["layout"] != "device":
            raise AssertionError(f"{name} {h}x{w}: {info['layout']} layout, "
                                 "expected device")
        energy = (energy_excess(got[3], want[3], const)
                  if name == "stencil_cg" else None)
        repeat_bit_equal(lambda blk: kernel(*args, sf=sf, lam=1.0,
                                            max_iter=12, block=blk),
                         f"{name} {h}x{w}")
        cap = 100
        run_k = lambda: kernel(*args, sf=sf, lam=1.0, max_iter=cap)  # noqa: E731
        run_p = lambda: plain(*args, sf=sf, lam=1.0, max_iter=cap)  # noqa: E731
        t_k1, t_p1, t_p2, t_k2 = (cuda_ms(run_k, 3), cuda_ms(run_p, 1),
                                  cuda_ms(run_p, 1), cuda_ms(run_k, 3))
        ms_k = (t_k1 + t_k2) / 2 / (cap + 1)
        ms_p = (t_p1 + t_p2) / 2 / (cap + 1)
        n_it = int(run_k()[1])
        planes, flops = ((STENCIL_PLANES, STENCIL_FLOPS) if name == "stencil_cg"
                         else (CGS_PLANES, CGS_FLOPS))
        stream = persistent_planes(name, None, info["onchip"], sf)
        b_ms, b_by, s_ms = bound(h * w, 1, n_it, planes, flops, sf, stream,
                                 per=cap + 1)
        launches, fields = launch_summary(name, None, {(256, 4): info}, sf)
        print(f"[{label}] {name} {h}x{w} sf={sf}: iterations equal; update "
              f"/ residual gap at caps 2 and 12 within UPD_BOUND / RES_BOUND "
              f"(cap 12: {upd:.2e} / {gap:.2e})"
              + ("" if energy is None else
                 f"; energy gap at cap 12 {energy[0]:.3f} ({energy[1]:.3f} "
                 "of phase 3's bound, printed)")
              + f"; repeat bit-equal at {len(BLOCKS)} blocks; kernel "
              f"{ms_k:.4f} "
              f"ms/CG-iter, plain {ms_p:.4f}, bound {b_ms:.5f} ({b_by}), "
              f"stream bound {s_ms:.4f}; {launches}", flush=True)
        out[name] = {"ms": ms_k, "plain_ms": ms_p, "bound_ms": b_ms,
                     "bound_by": b_by, "stream_bound_ms": s_ms,
                     "max_abs_err": max_dx, "cg_iterations": n_it,
                     "layout": info["layout"], "stream_planes": stream,
                     "launch": fields,
                     "unit": f"per CG iteration, {h}x{w} sf {sf}, {cap + 1} "
                             "iterations launched"}
    return out


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
    from a cold start x0 = 0, at the thread blocks of BLOCKS, against the
    plain version: iteration counts, the update x - x0 and the reported
    residual after 2 and 12 iterations (UPD_BOUND, RES_BOUND); C'
    bit-equal for the stencil Jacobi forms; the tracked energy from the
    warm start within phase 3's bound at every cap. Then the stacked lanes
    bit for bit their solo launches, and ms per CG iteration. Returns each
    grid's JSON entry (without launches)."""
    import torch

    from srmeetsps_cuda_tpu_torch.solve import cgs_cg as cg
    from srmeetsps_cuda_tpu_torch.solve import direct_cg as dc
    from srmeetsps_cuda_tpu_torch.solve import stencil_cg as sc

    direct = form.startswith("direct")
    host = form == "direct host_r0"
    tracked = form in ("jacobi", "direct", "direct jacobi")
    if form == "jacobi":
        kernel, plain, counter = sc.stencil_cg, sc.stencil_cg_plain, \
            "stencil_cg jacobi"
    elif direct:
        kernel, plain = dc.direct_cg, dc.direct_cg_plain
        counter = form.replace("direct", "direct_cg", 1)
    else:
        kernel, plain, counter = cg.cgs_cg, cg.cgs_cg_plain, "cgs_cg"
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

    blocks = BLOCKS
    entries = {}
    for (h, w, sf), (lanes, stacked) in grids.items():
        jform = sc.jacobi_form(sf) if form == "jacobi" else form
        infos = {}
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
                    before = launch_count(counter)
                    x, k, r1, e, C = call(kernel, ln, x0, checks=True,
                                          b=b_res, sf=sf, lam=1.0,
                                          max_iter=cap, block=block)
                    torch.cuda.synchronize()
                    if launch_count(counter) != before + 1:
                        raise AssertionError(f"{where}: launch not counted")
                    infos[block] = one_launch(kernel, where)
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
        pname = ("cgs_cg" if form == "cgs" else "direct_cg" if direct
                 else "stencil_cg")
        b0 = given_residual(lanes[0], lanes[0][0], sf) if host else None
        repeat_bit_equal(lambda blk: tuple(
            t for t in call(kernel, lanes[0], b=b0, sf=sf, lam=1.0,
                            max_iter=12, block=blk) if t is not None),
            f"{name} {h}x{w} sf={sf}")
        launches, fields = launch_summary(
            pname, None if form == "cgs" else jform, infos, sf)
        if (h, w) == (960, 1280) and form in EXPECT_LAYOUT:
            expect_layout(infos, EXPECT_LAYOUT[form], f"{name} {h}x{w} B=1")
        launches = ("; one device launch per CG solve, repeat bit-equal "
                    f"at {len(BLOCKS)} blocks; " + launches)
        xs, ks, rs, es, _ = call(kernel, stacked, sf=sf, lam=1.0, max_iter=12)
        one_launch(kernel, f"{name} {h}x{w} B={len(lanes)}")
        for b, ln in enumerate(lanes):
            x1, k1, r1, e1, _ = call(kernel, ln, sf=sf, lam=1.0, max_iter=12)
            if not (torch.equal(xs[b], x1) and int(ks[b]) == int(k1)
                    and torch.equal(rs[b], r1)
                    and (e1 is None or torch.equal(es[b], e1))):
                raise AssertionError(f"{name} lane {b} differs from its solo "
                                     "launch")
        cap = 100
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
            planes, flops = JACOBI_PLANES, JACOBI_FLOPS[jform]
        elif direct:
            flops, planes = DIRECT_FORMS[form]
        else:
            planes, flops = CGS_PLANES, CGS_FLOPS
        b_ms, b_by, s_ms = bound(h * w, 1, n_it, planes, flops, sf,
                                 fields["256x4"]["stream_planes"],
                                 per=cap + 1)
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
              f"{b_ms:.5f} ({b_by}), stream bound {s_ms:.4f}{launches}",
              flush=True)
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
        entries[h, w, sf].update(
            design="persistent", layout=fields["256x4"]["layout"],
            stream_planes=fields["256x4"]["stream_planes"], launch=fields)
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
    the shard kernels of the mesh's route (``route="steps"`` in ``kw``: the
    per-step kernels), or with ``plain`` their plain versions."""
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


def held(where, got, want, x0, start, cap):
    """``(update, residual gap)`` of a row-shard CG result ``got`` = (x,
    iterations, residual) against ``want``: equal iterations, a finite x,
    and both gaps within UPD_BOUND / RES_BOUND, or it raises."""
    import torch

    (x, k, r), (px, pk, pr) = got, want
    if int(k) != int(pk):
        raise AssertionError(f"{where}: iterations {int(k)}, against "
                             f"{int(pk)}")
    if not bool(torch.isfinite(x).all()):
        raise AssertionError(f"{where}: x is not finite")
    upd = rel_rms(x - x0, px - x0)
    gap = abs(float(r) - float(pr)) / abs(float(pr))
    if upd > UPD_BOUND[start][cap] or gap > RES_BOUND[start][cap]:
        raise AssertionError(f"{where}: relative RMS of the update "
                             f"{upd:.3e}, relative gap of the residual "
                             f"{gap:.3e}")
    return upd, gap


def shard_vs_plain(label, grids, timed, shards=4):
    """Phase 3g on ``grids``: ``(h, w, sf) -> (lanes, stacked)``. For each
    form of the row-shard CG on ``shards`` shards of the card and 2 seeds,
    from the warm start and a cold start x0 = 0, after 2 and 12 iterations
    (``held``): the persistent kernels (the mesh's route) at the blocks of
    BLOCKS and the per-step kernels (``route="steps"``) at 256 x 4 and 32 x
    16 against the plain per-shard steps on the same shards, and the two
    routes against each other at those blocks; each persistent solve one
    launch counted and one device launch, each per-step run's launches
    counted on every shard; a repeated run bit-equal on both routes (the
    persistent one at every block); the persistent CG against the
    unsharded kernel of the same recurrence (unsharded_call) after 2
    iterations. On the grids in ``timed``, ms per CG iteration of the
    persistent route, the per-step route and plain at cap 100, in turns,
    the per-step route's prologue with one iteration and the device time
    of one launch of each per-step wrapper on one shard (shard_launch_ms).
    Returns {form: {grid: entry}}: the per-step route's figures, those of
    the persistent kernels under ``persistent``."""
    import torch

    from srmeetsps_cuda_tpu_torch.parallel import shard_cg as scg

    mesh = scg.make_mesh_1d(shards, "cuda")
    counters = {"std": "shard_cg sweep_a", "cgs": "shard_cg cgs_sweep",
                "jacobi": "shard_cg sweep_b jacobi"}
    routes = (("persistent", BLOCKS), ("steps", BLOCKS[:2]))
    out = {form: {} for form in SHARD_FORMS}
    for (h, w, sf), (lanes, _) in grids.items():
        for form in SHARD_FORMS:
            counter = counters[form]
            gaps = {route: {} for route in ("persistent", "steps", "routes")}
            infos, vs_one, max_dx = {}, [], {}
            for seed, ln in enumerate(lanes[:2]):
                for start, cap in itertools.product(("warm", "cold"),
                                                    (2, 12)):
                    x0 = ln[0] if start == "warm" else torch.zeros_like(ln[0])
                    kw = dict(sf=sf, lam=1.0, max_iter=cap)
                    plain = shard_call(form, ln, mesh, x0, plain=True, **kw)
                    runs = {}
                    for route, blocks in routes:
                        for block in blocks:
                            where = (f"shard_cg {form} {route} {h}x{w} sf={sf}"
                                     f" seed {seed} {start} cap {cap} block "
                                     f"{block}")
                            before = (launch_count("shard_cg persistent"),
                                      launch_count(counter))
                            got = shard_call(
                                form, ln, mesh, x0, block=block,
                                route=None if route == "persistent"
                                else route, **kw)
                            torch.cuda.synchronize()
                            after = (launch_count("shard_cg persistent"),
                                     launch_count(counter))
                            want = ((before[0] + 1, before[1])
                                    if route == "persistent" else
                                    (before[0],
                                     before[1] + shards * (cap + 1)))
                            if after != want:
                                raise AssertionError(
                                    f"{where}: launches {after}, expected "
                                    f"{want} (persistent, per-step)")
                            if route == "persistent":
                                infos[block] = one_launch(scg.persistent,
                                                          where)
                            runs[route, block] = got
                            g = gaps[route].get((start, cap), (0.0, 0.0))
                            gaps[route][start, cap] = tuple(map(max, g, held(
                                where, got, plain, x0, start, cap)))
                            if (seed, start, cap, block) == (0, "warm", 2,
                                                             (256, 4)):
                                max_dx[route] = float(
                                    (got[0] - plain[0]).abs().max())
                    for block in BLOCKS[:2]:
                        g = gaps["routes"].get((start, cap), (0.0, 0.0))
                        gaps["routes"][start, cap] = tuple(map(max, g, held(
                            f"shard_cg {form} {h}x{w} sf={sf} seed {seed} "
                            f"{start} cap {cap} block {block}: persistent "
                            "vs per-step route", runs["persistent", block],
                            runs["steps", block], x0, start, cap)))
                    if seed == 0 and cap == 2:
                        one = unsharded_call(form, ln, x0, **kw)
                        u, g = held(f"shard_cg {form} {h}x{w} sf={sf} "
                                    f"{start}: against the unsharded kernel",
                                    runs["persistent", (256, 4)], one, x0,
                                    start, cap)
                        vs_one.append(f"{start} {u:.2e} / {g:.2e}")
            for route, blocks in routes:
                for block in blocks:
                    kw = dict(sf=sf, lam=1.0, max_iter=12, block=block,
                              route=None if route == "persistent" else route)
                    a = shard_call(form, lanes[0], mesh, **kw)
                    b = shard_call(form, lanes[0], mesh, **kw)
                    if not all(torch.equal(u, v) for u, v in zip(a, b)):
                        raise AssertionError(
                            f"shard_cg {form} {route} {h}x{w} sf={sf} block "
                            f"{block}: a repeated run differs")
            summary, fields = launch_summary("shard_cg", form, infos, sf)
            entry = {"update_rel_rms": gaps["steps"]["warm", 2][0],
                     "residual_rel_gap": gaps["steps"]["warm", 2][1],
                     "max_abs_err": max_dx["steps"],
                     "persistent": {
                         "update_rel_rms": gaps["persistent"]["warm", 2][0],
                         "residual_rel_gap":
                             gaps["persistent"]["warm", 2][1],
                         "max_abs_err": max_dx["persistent"],
                         "launch": fields}}
            timing = ""
            if (h, w, sf) in timed:
                ln, cap = lanes[0], 100
                run = lambda route, c=cap: shard_call(  # noqa: E731
                    form, ln, mesh, plain=route == "plain", sf=sf, lam=1.0,
                    max_iter=c, route="steps" if route == "steps" else None)
                reps = {"persistent": 5, "steps": 2, "plain": 1}
                t = {r: [] for r in reps}
                for r in ("persistent", "steps", "plain", "plain", "steps",
                          "persistent"):
                    t[r].append(cuda_ms(lambda: run(r), reps[r]) / (cap + 1))
                ms = {r: sum(v) / len(v) for r, v in t.items()}
                n_it = int(run("persistent")[1])
                n_steps = int(run("steps")[1])
                flops, planes, _ = SHARD_FORMS[form]
                p_stream = persistent_planes("shard_cg", form, False, sf)
                b_ms, b_by, s_ms = bound(h * w, 1, n_it, planes, flops, sf,
                                         p_stream, per=cap + 1)
                entry["persistent"].update(
                    ms=ms["persistent"], plain_ms=ms["plain"],
                    steps_ms=ms["steps"], bound_ms=b_ms, bound_by=b_by,
                    stream_bound_ms=s_ms, cg_iterations=n_it,
                    ms_in_turns=t,
                    unit=f"per CG iteration of the {shards}-shard CG, one "
                         f"launch per solve, {h}x{w} sf {sf}, {cap + 1} "
                         "launched")
                b_ms, b_by, s_ms = bound(h * w, 1, n_steps, planes, flops,
                                         sf, SHARD_FORMS[form][2],
                                         per=cap + 1)
                entry.update(ms=ms["steps"], plain_ms=ms["plain"],
                             bound_ms=b_ms, bound_by=b_by,
                             stream_bound_ms=s_ms, cg_iterations=n_steps,
                             unit=f"per CG iteration of the {shards}-shard "
                                  f"CG on the per-step route, {h}x{w} sf "
                                  f"{sf}, {cap + 1} launched")
                timing = (f"; ms/CG-iter persistent {ms['persistent']:.4f}, "
                          f"per-step {ms['steps']:.4f}, plain "
                          f"{ms['plain']:.4f} (in turns: "
                          + ", ".join(f"{r} " + " / ".join(
                              f"{v:.4f}" for v in t[r]) for r in t)
                          + f"), bound {b_ms:.5f} ({b_by}), stream "
                          f"{entry['persistent']['stream_bound_ms']:.4f} "
                          f"(per-step {s_ms:.4f}), CG iterations {n_it} "
                          f"(per-step {n_steps})")
                if form != "cgs":
                    steps0 = lambda: shard_call(  # noqa: E731
                        form, ln, mesh, sf=sf, lam=1.0, max_iter=0,
                        route="steps")
                    t_k = cuda_ms(steps0, 3)
                    t_p = cuda_ms(lambda: shard_call(
                        form, ln, mesh, plain=True, sf=sf, lam=1.0,
                        max_iter=0), 2)
                    p_ms, p_by, _ = bound(h * w, 1, 1, planes, flops, sf,
                                          SHARD_FORMS[form][2])
                    entry["prologue"] = {
                        "ms": t_k, "plain_ms": t_p, "bound_ms": p_ms,
                        "bound_by": p_by,
                        "unit": f"one prologue and one CG iteration on "
                                f"{shards} shards, per-step route, {h}x{w} "
                                f"sf {sf}"}
                    timing += (f"; per-step prologue + 1 iteration "
                               f"{t_k:.4f} ms, plain {t_p:.4f}")
                launch = shard_launch_ms(form, ln, mesh, sf)
                entry["launch"] = {name: {"device_ms": ms_, "stream_ms": sm}
                                   for name, (ms_, sm) in launch.items()}
                timing += "; device ms per launch on one shard: " + ", ".join(
                    f"{name[9:]} "
                    + ("not measured" if ms_ is None else f"{ms_:.4f}")
                    + f" (stream {sm:.4f})"
                    for name, (ms_, sm) in launch.items())
            out[form][h, w, sf] = entry
            worst = "; ".join(
                f"{route}: " + ", ".join(f"{st} cap {c} {u:.2e} / {g:.2e}"
                                         for (st, c), (u, g) in v.items())
                for route, v in gaps.items())
            print(f"[{label}] shard_cg {form} {shards} shards {h}x{w} "
                  f"sf={sf}: iterations equal; relative RMS of the update / "
                  "relative gap of the residual, worst of 2 seeds and the "
                  "blocks, against plain (persistent at 256x4, 32x16, 30x3; "
                  "per-step at 256x4, 32x16) and between the routes: "
                  + worst + f"; max|dx| warm cap 2 persistent "
                  f"{max_dx['persistent']:.3e}, per-step "
                  f"{max_dx['steps']:.3e}; one device launch per persistent"
                  " solve, repeats bit-equal on both routes; persistent vs "
                  "the unsharded kernel at cap 2: " + ", ".join(vs_one)
                  + timing + "; persistent launches: " + summary, flush=True)
    return out


def shard_entries(per_form, launches, steps_launches, grid, others):
    """The ``kernels`` line's entries of the row-shard kernels: the two
    persistent kernels (the standard one with its Jacobi form under
    ``jacobi``), then one per-step kernel per TPU kernel, each with the
    figures of ``grid`` (those of ``others`` under ``grids``) of the form
    that runs the kernel, and the launches of phase 4j's runs,
    ``launches[form]`` (persistent route) and ``steps_launches[form]``
    (per-step route). ``ms`` is the whole sharded CG's per iteration, host
    launches included; ``device_ms_per_launch`` the card's time for one
    launch of a per-step wrapper on one shard, beside its planes'
    streaming time ``launch_stream_ms``."""
    keys = ("ms", "plain_ms", "bound_ms", "bound_by", "stream_bound_ms",
            "cg_iterations", "update_rel_rms", "residual_rel_gap")
    src_file = "srmeetsps_cuda_tpu_torch/csrc/shard_cg.cu"

    def persistent(form, name, lines, counter):
        e = per_form[form][grid]["persistent"]
        entry = {"name": name, "route": "cuda", "source": src_file,
                 "replaces": f"{SHARD_REPLACES}{lines[0]}",
                 "also_replaces": [f"{SHARD_REPLACES}{n}" for n in lines[1:]],
                 "launches": launches[form][counter], "library_ms": None,
                 "form": form}
        entry.update({k: v for k, v in e.items() if k != "ms_in_turns"})
        entry["grids"] = {grid_key(g): {k: v for k, v in
                                        per_form[form][g]["persistent"].items()
                                        if k in keys + ("launch",)}
                          for g in others}
        return entry

    std = persistent("std", "shard_cg persistent std", (375, 124, 440),
                     "shard_cg persistent")
    std["jacobi"] = persistent("jacobi", "shard_cg persistent std jacobi",
                               (495, 124, 375), "shard_cg persistent jacobi")
    out = [std, persistent("cgs", "shard_cg persistent cgs", (249, 124),
                           "shard_cg persistent cgs")]
    rows = (("shard_cg prologue", "std", 124),
            ("shard_cg cgs_sweep", "cgs", 249),
            ("shard_cg sweep_a", "std", 375),
            ("shard_cg sweep_b", "std", 440),
            ("shard_cg sweep_b jacobi", "jacobi", 495))
    for name, form, line in rows:
        src = per_form[form][grid]
        figures = src["prologue"] if name.endswith("prologue") else src
        entry = {"name": name, "route": "cuda", "source": src_file,
                 "replaces": f"{SHARD_REPLACES}{line}",
                 "launches": steps_launches[form][name], "library_ms": None,
                 "max_abs_err": src["max_abs_err"], "form": form,
                 "shard_route": "steps"}
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


# The kernels whose launches each run is read by, by their names in the
# launch registry (``srmeetsps_cuda_tpu_torch/trace.py`` says what each
# counts).
COUNTED = ("stencil_cg", "stencil_cg jacobi", "cgs_cg", "direct_cg",
           "direct_cg jacobi", "direct_cg host_r0", "shard_cg persistent",
           "shard_cg persistent jacobi", "shard_cg persistent cgs",
           "shard_cg prologue", "shard_cg sweep_a", "shard_cg sweep_b",
           "shard_cg sweep_b jacobi", "shard_cg cgs_sweep", "inpaint")
_counted_from = {}  # the registry's counts at the last reset_counts()


def launch_count(name: str) -> int:
    """The launches of the kernel ``name`` in this process so far."""
    from srmeetsps_cuda_tpu_torch import trace as tracing

    return tracing.launch_counts().get(name, 0)


def reset_counts():
    _counted_from.clear()
    _counted_from.update({k: launch_count(k) for k in COUNTED})


def read_counts() -> dict:
    """The launches of each of COUNTED since the last reset_counts()."""
    return {k: launch_count(k) - _counted_from.get(k, 0) for k in COUNTED}


def inpaint_passes(captures: int, sweeps: int = 512) -> int:
    """The inpaint kernel's launches for ``captures`` captures prepared
    with ``sweeps`` sweeps each (512, ``SolverConfig``'s default)."""
    from srmeetsps_cuda_tpu_torch.pre import inpaint as ik

    return captures * -(-sweeps // ik.sweeps_per_pass())


def expected_counts(n: int, cli_extra=(), operator: str = "stencil",
                    captures: int = 0) -> dict:
    """The counts of ``n`` depth solves of a run with ``cli_extra`` (or the
    same options of a ``SolverConfig``) and ``cg_operator``, which prepared
    ``captures`` captures at 512 sweeps: Jacobi runs the stencil CG in a
    Jacobi form, whatever the --cg-variant, and the direct CG its PCG; the
    CGS variant without Jacobi runs the CGS kernel for the stencil and the
    direct operator (depth_cg's routing)."""
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
            **shard_counts(0, 0, 0, "std"),
            "inpaint": inpaint_passes(captures)}


def shard_counts(n: int, shards: int, cap: int, form: str,
                 route: str = "persistent") -> dict:
    """The row-shard kernels' counts of ``n`` sharded depth solves in
    ``form`` on ``shards`` shards at ``cap``: on the persistent route one
    launch per solve; on the per-step route (``"steps"``) a prologue per
    shard (CGS: and its w0 launch) and cap + 1 sweeps per shard."""
    per, n = (n, 0) if route == "persistent" else (0, n)
    it = n * shards * (cap + 1)
    std = form != "cgs"
    return {"shard_cg persistent": per,
            "shard_cg persistent jacobi": per if form == "jacobi" else 0,
            "shard_cg persistent cgs": 0 if std else per,
            "shard_cg prologue": n * shards * (1 if std else 2),
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
    if launches != expected_counts(n_it, cli_extra, captures=1):
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


def solo_trace(path, pad_to=None, cfg=None):
    """The single fused solve of ``path`` (zero-padded to ``pad_to``)
    through the runtime API with ``cfg`` (the default ``SolverConfig``):
    its energy trace and the largest ``sum B^2`` constant of its depth
    operators."""
    from srmeetsps_cuda_tpu_torch.io.mat_loader import load_mat_dataset

    run = solo_run(load_mat_dataset(path), pad_to, cfg)
    return run["energies"], run["const"]


def solo_run(data, pad_to=None, cfg=None) -> dict:
    """:func:`solo_trace` of a dataset in memory: its ``energies``, the
    largest constant (``const``) and the solve's ``seconds`` (the constant
    is read after each outer iteration, inside the timed solve)."""
    import torch

    from srmeetsps_cuda_tpu_torch.config import SolverConfig
    from srmeetsps_cuda_tpu_torch.models import srps
    from srmeetsps_cuda_tpu_torch.runtime.solver import prepare

    cfg = cfg or SolverConfig()
    prob, st = prepare(data, cfg, torch.device("cuda"), pad_to=pad_to)
    consts = []

    def record(s):
        mom = srps.s_moments(prob, s.s)
        consts.append(float(srps.build_depth_operator(
            prob, mom, s.rho, s.dz, cfg.lam).const))

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    final, trace = srps.solve_fused(st, prob, 2, cfg, on_iteration=record)
    torch.cuda.synchronize()
    return {"energies": trace[:final.iteration].tolist(),
            "const": max(consts, key=abs),
            "seconds": time.perf_counter() - t0}


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
    if n_stream != expected_counts(sum(map(len, stream)), cli_extra,
                                   captures=len(paths)):
        raise AssertionError(f"stream: launches {n_stream} for "
                             f"{list(map(len, stream))} iterations")
    if lock != stream:
        raise AssertionError(f"lockstep lanes {lock} differ from stream "
                             f"lanes {stream}")
    if n_lock != expected_counts(max(map(len, lock)), cli_extra,
                                 captures=len(paths)):
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


@contextlib.contextmanager
def plain_depth_cg(operator: str):
    """The main path's depth CG of ``operator`` (a ``cg_operator``: the
    stencil or the direct CG) runs its plain version on the card while
    this holds (``models.srps.depth_cg`` reads ``stencil_cg`` and
    ``direct_cg`` per call)."""
    from srmeetsps_cuda_tpu_torch.models import srps
    from srmeetsps_cuda_tpu_torch.solve import direct_cg as dc
    from srmeetsps_cuda_tpu_torch.solve import stencil_cg as sc

    name, plain = (("direct_cg", dc.direct_cg_plain)
                   if operator.startswith("direct")
                   else ("stencil_cg", sc.stencil_cg_plain))
    kernel = getattr(srps, name)
    setattr(srps, name, lambda *a, block=None, **k: plain(*a, **k))
    try:
        yield
    finally:
        setattr(srps, name, kernel)


def api_solve(label, data, z_true, cfg, ref=None, const=None, hold=True,
              plain=False):
    """Phase 4h (and 4i): one solve of ``data`` through
    ``runtime.solver.solve`` with ``cfg``, the launch counts set to 0 just
    before and read just after, and the peak of allocated device memory.
    Checks what main_path checks; with ``ref`` (the energies of another
    operator's run of the same data) also at most one outer iteration more
    or less and the energies within ``energy_bound(ref[0], const)``, or
    with ``hold=False`` only prints how far they lie. With ``plain`` the
    depth CG of ``cfg.cg_operator`` runs its plain version
    (``plain_depth_cg``) and no kernel may run. Returns the run as main_path does, with ``peak_bytes``."""
    import torch

    from srmeetsps_cuda_tpu_torch.config import RuntimeConfig
    from srmeetsps_cuda_tpu_torch.runtime.solver import solve

    h, w = data.mask.shape
    what = (f"cg_operator={cfg.cg_operator}"
            + (" jacobi" if cfg.jacobi_preconditioner else "")
            + (" bf16" if cfg.image_dtype == "bfloat16" else "")
            + f" {h}x{w} n={data.I.shape[0]} sf={data.sf}"
            + (" (plain version)" if plain else ""))
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    with (plain_depth_cg(cfg.cg_operator) if plain
          else contextlib.nullcontext()):
        final, metrics = solve(data, cfg,
                               RuntimeConfig(fused_outer_loop=True),
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
    if launches != expected_counts(0 if plain else n_it, cli_extra_of(cfg),
                                   cfg.cg_operator, captures=1):
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


def cli_outputs(tmp, path, extra=()):
    """One ``cli.main`` solve of ``path`` with ``extra``, its states dumped
    as npz: ``(energies, final state arrays, launch counts)``, the counts
    set to 0 just before and read just after."""
    import numpy as np

    dump = tempfile.mkdtemp(dir=tmp)
    reset_counts()
    recs, _ = run_cli(["--dsloc", path, "--dump", "--dump-format", "npz",
                       "--dump-dir", dump, *extra], tmp)
    launches = read_counts()
    with np.load(os.path.join(dump, "state_final.npz")) as f:
        final = {k: f[k] for k in f.files}
    shutil.rmtree(dump)
    return [r["energy"] for r in recs if "iteration" in r], final, launches


def same_outputs(what, got, want):
    """``got`` and ``want`` (``cli_outputs``) bit for bit: the energies,
    the final state and the kernel launches."""
    import numpy as np

    if (got[0] != want[0] or got[2] != want[2]
            or any(not np.array_equal(got[1][k], want[1][k])
                   for k in want[1])):
        raise AssertionError(f"{what}: outputs differ from the same solve "
                             f"without it: energies {got[0]} vs {want[0]}, "
                             f"launches {got[2]} vs {want[2]}")


def stencil_kernel_events(prof_dir) -> list:
    """The CUDA kernel events of the one torch.profiler trace in
    ``prof_dir`` that name the stencil CG kernel (``cg_kernel<...>`` of
    csrc/stencil_cg.cu)."""
    import re

    files = glob.glob(os.path.join(prof_dir, "*.pt.trace.json"))
    if len(files) != 1:
        raise AssertionError(f"--profile-dir: {len(files)} trace files in "
                             f"{prof_dir}")
    with open(files[0]) as f:
        events = json.load(f)["traceEvents"]
    kernels = [e for e in events if e.get("cat") == "kernel"]
    if not kernels:
        raise AssertionError("--profile-dir: the trace holds no CUDA kernel "
                             "event")
    return [e for e in kernels
            if re.search(r"(?<![A-Za-z_])cg_kernel", e.get("name", ""))]


def phase_4k(label, tmp, path, data, z_true, main, const):
    """Phase 4k on the phase-4 file ``path`` (``data``; ``main`` its phase-4
    run, ``const`` the constant E of its solve): bf16 images, then
    ``--profile-dir``, ``--nan-check``, ``--dump-operators`` and ``--show``.
    Returns the figures of the kernels line's ``bf16`` entry."""
    import numpy as np
    import scipy.io as sio
    import torch

    from srmeetsps_cuda_tpu_torch.config import RuntimeConfig, SolverConfig
    from srmeetsps_cuda_tpu_torch.io import sparse_dump
    from srmeetsps_cuda_tpu_torch.models import srps
    from srmeetsps_cuda_tpu_torch.ops.gradients import GradientMasks
    from srmeetsps_cuda_tpu_torch.ops.grid import lr_mask
    from srmeetsps_cuda_tpu_torch.runtime.solver import prepare, solve

    dev = torch.device("cuda")
    sf = int(data.sf)
    cfgs = {dt: SolverConfig(image_dtype=dt)
            for dt in ("float32", "bfloat16")}
    # bf16 through the CLI, then the runtime API's solve of the same
    # problem, and that with the stencil CG's plain version on the card.
    bf = main_path(label, tmp, path, data, z_true,
                   cli_extra=("--image-dtype", "bfloat16"))
    trace16, const16 = solo_trace(path, cfg=cfgs["bfloat16"])
    if trace16 != bf["energies"]:
        raise AssertionError("bf16: the runtime API's solve differs from the "
                             "CLI's")
    plain = api_solve(label, data, z_true, cfgs["bfloat16"], bf["energies"],
                      const16, plain=True)
    # Iteration 1: s against the f32 run at TestBF16Images's bound. The
    # energy's constant holds sum SI2, the bf16-rounded products I * I (JAX
    # srps.py:145-146), whose rounding lifts it by ~1e-5 of sum I^2, and the
    # bf16 images carry their own rounding noise: on this noiseless render
    # both exceed that bound (tests/test_torch_bf16.py::
    # test_bf16_energy_gap_is_the_reference_si2). So the energy, SI2's
    # rounding taken out, is held at phase 3's bound to the f32 iteration on
    # the same images rounded to bf16, and its gaps to the f32 run printed.
    rounded = dataclasses.replace(data, I=torch.from_numpy(
        np.ascontiguousarray(data.I, np.float32)).bfloat16().float().numpy())
    first = {}
    for name, d, cfg in (("float32", data, cfgs["float32"]),
                         ("bfloat16", data, cfgs["bfloat16"]),
                         ("rounded", rounded, cfgs["float32"])):
        prob, st = prepare(d, cfg, dev)
        first[name] = srps.srps_iteration(st, prob, sf, cfg)
        if name == "bfloat16":
            si2_bias = cfg.lam * float(prob.SI2.double().sum()
                                       - prob.I.double().square().sum())
        del prob, st
    del rounded
    s16, s32 = (first[k].s.cpu().numpy() for k in ("bfloat16", "float32"))
    e16, e32, e_rnd = (float(first[k].energy)
                       for k in ("bfloat16", "float32", "rounded"))
    check_close("bf16 iteration 1 s vs f32", s16, s32, 3e-2, 3e-3)
    check_close("bf16 iteration 1 energy, SI2's rounding taken out, vs f32 "
                "on the bf16-rounded images", e16 - si2_bias, e_rnd, 0,
                energy_bound(e_rnd, const16))
    if e16 != bf["energies"][0] or e32 != main["energies"][0]:
        raise AssertionError("iteration 1 differs from the CLI's")
    del first
    # f32 and bf16 in turns: ms per outer iteration and peak memory.
    turns = {"float32": [], "bfloat16": []}
    refs = {"float32": (main["energies"], const),
            "bfloat16": (bf["energies"], const16)}
    for dt in ("float32", "bfloat16", "bfloat16", "float32"):
        turns[dt].append(api_solve(label, data, z_true, cfgs[dt], *refs[dt]))
    ms = {dt: [1e3 * r["seconds"] / r["iterations"] for r in runs]
          for dt, runs in turns.items()}
    peak = {dt: max(r["peak_bytes"] for r in runs)
            for dt, runs in turns.items()}
    h, w = data.mask.shape
    print(f"[{label}] bf16 vs f32 {h}x{w} n={data.I.shape[0]} sf={sf}: "
          f"{bf['iterations']} vs "
          f"{main['iterations']} outer iterations (plain CG bf16 "
          f"{plain['iterations']}); iteration 1 max |ds| "
          f"{float(np.abs(s16 - s32).max()):.3e}, energy {e16} vs f32 {e32} "
          f"({(e16 - e32) / e32:+.4f}): SI2's bf16 products "
          f"{si2_bias:+.3f}, the rest {e16 - si2_bias - e_rnd:+.4f} from f32 "
          f"on the bf16-rounded images ({e_rnd}, "
          f"{(e_rnd - e32) / e32:+.4f} from f32); "
          "ms/outer-iter in turns f32 "
          + " / ".join(f"{t:.3f}" for t in ms["float32"]) + ", bf16 "
          + " / ".join(f"{t:.3f}" for t in ms["bfloat16"])
          + f"; peak allocated f32 {peak['float32'] / 2**30:.3f} GiB, bf16 "
          f"{peak['bfloat16'] / 2**30:.3f} GiB", flush=True)

    plain_out = cli_outputs(tmp, path)
    if plain_out[0] != main["energies"]:
        raise AssertionError("a repeated CLI solve differs from phase 4's")
    # --profile-dir: a trace whose CUDA kernel events are the stencil
    # kernel's launches.
    prof = tempfile.mkdtemp(dir=tmp)
    profiled = cli_outputs(tmp, path, ("--profile-dir", prof))
    same_outputs("--profile-dir", profiled, plain_out)
    named = stencil_kernel_events(prof)
    n_launch = profiled[2]["stencil_cg"]
    if len(named) != n_launch:
        raise AssertionError(f"--profile-dir: {len(named)} stencil kernel "
                             f"events for {n_launch} launches")
    kernel_ms = sum(e.get("dur", 0) for e in named) / 1e3
    print(f"[{label}] --profile-dir: {len(named)} CUDA events of "
          f"{named[0]['name']!r} for {n_launch} stencil_cg launches, "
          f"{kernel_ms:.3f} ms of kernel time", flush=True)
    shutil.rmtree(prof)
    # --nan-check: bit for bit on a clean solve; a NaN inside the mask
    # raises, naming its phase.
    same_outputs("--nan-check", cli_outputs(tmp, path, ("--nan-check",)),
                 plain_out)
    I = data.I.copy()
    r, c = np.argwhere(data.mask != 0)[len(np.argwhere(data.mask != 0)) // 2]
    I[0, 0, r, c] = np.nan
    try:
        solve(dataclasses.replace(data, I=I), cfgs["float32"],
              RuntimeConfig(fused_outer_loop=True, nan_check=True),
              device=dev, verbose=False)
    except FloatingPointError as e:
        raised = str(e)
    else:
        raise AssertionError("--nan-check: a NaN in I inside the mask did "
                             "not raise")
    del I
    print(f"[{label}] --nan-check: a clean solve bit for bit the unchecked "
          f"one; a NaN in I at ({r}, {c}) raised FloatingPointError: "
          f"{raised}", flush=True)
    # --dump-operators: the four files against the host's triplets.
    ops_dir = tempfile.mkdtemp(dir=tmp)
    run_cli(["--dsloc", path, "--dump-operators", "--dump-format", "mat5",
             "--dump-dir", ops_dir], tmp)
    mask = (torch.as_tensor(np.asarray(data.mask)) != 0).float()
    dx, dy, npix = sparse_dump.gradient_coo(GradientMasks.from_mask(mask),
                                            mask)
    h, w = mask.shape
    want = {"Dx": dx + (npix, npix), "Dy": dy + (npix, npix),
            "D": sparse_dump.downsample_coo(h, w, sf),
            "KT": sparse_dump.kt_coo(mask, lr_mask(mask, sf), sf)}
    shapes = {}
    for name, (ii, jj, kk, rows, cols) in want.items():
        got = sio.loadmat(os.path.join(ops_dir, f"{name}.mat"))
        dims = (int(got["rows"].ravel()[0]), int(got["cols"].ravel()[0]))
        if dims != (rows, cols) or got["ii"].size != ii.size or not all(
                np.array_equal(got[k].ravel(), v)
                for k, v in (("ii", ii), ("jj", jj), ("kk", kk))):
            raise AssertionError(f"--dump-operators {name}: {dims}, nnz "
                                 f"{got['ii'].size}; the host's "
                                 f"{(rows, cols)}, nnz {ii.size}")
        shapes[name] = f"{rows}x{cols} nnz {ii.size}"
    shutil.rmtree(ops_dir)
    print(f"[{label}] --dump-operators: {shapes}, each equal to "
          "io/sparse_dump's triplets of the same mask", flush=True)
    # --show without a display: a warning and the same outputs.
    hidden = {k: os.environ.pop(k) for k in ("DISPLAY", "WAYLAND_DISPLAY")
              if k in os.environ}
    try:
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            shown = cli_outputs(tmp, path, ("--show",))
    finally:
        os.environ.update(hidden)
    said = [str(m.message) for m in caught
            if "--show disabled" in str(m.message)]
    if not said:
        raise AssertionError(f"--show: no warning, {caught}")
    same_outputs("--show", shown, plain_out)
    print(f"[{label}] --show without a display: warned {said[0]!r}, the "
          "same outputs as the solve without it", flush=True)
    return {"launches": bf["launches"]["stencil_cg"],
            "outer_iterations": bf["iterations"],
            "iteration_1_energy": {"float32": e32, "bfloat16": e16,
                                   "si2_bias": si2_bias,
                                   "float32_rounded_images": e_rnd},
            "plain_outer_iterations": plain["iterations"],
            "ms_per_outer_iteration": ms, "peak_allocated_bytes": peak}


def shard_form(cfg) -> str:
    """The row-shard CG form a ``SolverConfig`` runs
    (``srps_iteration_sharded``): Jacobi whatever the variant, else CGS or
    the standard CG."""
    if cfg.jacobi_preconditioner:
        return "jacobi"
    return "cgs" if cfg.cg_variant == "cgs" else "std"


@contextlib.contextmanager
def shard_route(route: str):
    """Every row-shard solve takes ``route`` ("steps" or "plain", see
    ``shard_cg.choose_route``) while this holds, whatever its mesh (the
    solves ask ``choose_route`` per solve)."""
    from srmeetsps_cuda_tpu_torch.parallel import shard_cg as scg

    choose = scg.choose_route
    scg.choose_route = lambda *args, **kw: route
    try:
        yield
    finally:
        scg.choose_route = choose


def plain_shard_steps():
    """The row-shard solves run the plain per-shard steps on every device
    while this holds."""
    return shard_route("plain")


def sharded_solve(label, data, z_true, cfg, ref, const, shards=4):
    """Phase 4j: ``data`` through ``parallel.sharded.solve_fused_sharded``
    on ``shards`` shards of the card with ``cfg``. The banded route (the
    problem and state placed in row bands first, ``shard_problem_rows`` /
    ``shard_state_rows``, every phase on the bands) and the whole-grid glue
    (``glue="grid"``: the glue on the whole grid, the CG's operands banded
    per solve) in turns, banded, grid, grid, banded, each on the mesh's
    route (persistent); then the banded route on the per-step route and
    with the plain per-shard steps (``shard_route``). The launch counts
    are set to 0 just before each solve and read just after, the peak of
    allocated device memory reset just before. Checks a finite depth, the
    stopping rule, the banded repeat bit for bit, the launches (every
    depth CG one persistent launch, or on the per-step route its kernels'
    launches; no other CG kernel; none in the plain run) and, for each
    kernel route against the plain run (the same recurrence) and the
    banded against the whole-grid glue, at most one outer iteration more
    or less and every energy within ``energy_bound(plain[0], const)``.
    Against the unsharded run ``ref`` (energies) of the same file: the
    standard and CGS persistent runs held as against the plain run; the
    Jacobi run's gap printed, since the unsharded solve runs the scaled
    form at sf <= 2. Prints ms per outer iteration, the peak allocated and
    the bytes each shard holds of the placed problem and state. Returns
    the banded persistent run as main_path does, with the per-step run
    under ``steps``."""
    import torch

    from srmeetsps_cuda_tpu_torch.parallel import shard_cg as scg
    from srmeetsps_cuda_tpu_torch.parallel import sharded
    from srmeetsps_cuda_tpu_torch.runtime.solver import prepare

    dev = torch.device("cuda")
    mesh = scg.make_mesh_1d(shards, dev)
    form = shard_form(cfg)
    h, w = data.mask.shape
    what = f"sharded {form} {shards} shards {h}x{w} n={data.I.shape[0]}"
    runs = {}
    for glue, route in (("bands", "persistent"), ("grid", "persistent"),
                        ("grid", "persistent"), ("bands", "persistent"),
                        ("bands", "steps"), ("bands", "plain")):
        prob, st = prepare(data, cfg, dev)
        whole = sum(t.nbytes for tree in (prob, st) for v in tree
                    for t in (v if isinstance(v, tuple) else (v,))
                    if isinstance(t, torch.Tensor))
        per_shard = None
        if glue == "bands":
            prob = sharded.shard_problem_rows(prob, mesh)
            st = sharded.shard_state_rows(st, mesh)
            per_shard = sharded.shard_bytes(prob, st)
        cg_iters = []
        torch.cuda.synchronize()
        resident = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        reset_counts()
        t0 = time.perf_counter()
        with (contextlib.nullcontext() if route == "persistent"
              else shard_route(route)):
            final, trace = sharded.solve_fused_sharded(
                st, prob, int(data.sf), cfg, mesh, glue=glue,
                on_iteration=lambda s: cg_iters.append(s.cg_iters))
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        n_it = (final.parts[0] if glue == "bands" else final).iteration
        runs.setdefault((glue, route), []).append(dict(
            energies=trace[:n_it].tolist(), seconds=dt,
            launches=read_counts(), cg_iters=[int(c) for c in cg_iters],
            z=(sharded.gather_field(final, "z") if glue == "bands"
               else final.z),
            peak_bytes=torch.cuda.max_memory_allocated(),
            resident_bytes=resident, whole_bytes=whole,
            shard_bytes=per_shard))
        del prob, st, final, trace
    (first, again), grid, (steps,), (plain,) = (runs[k] for k in (
        ("bands", "persistent"), ("grid", "persistent"), ("bands", "steps"),
        ("bands", "plain")))
    energies = first["energies"]
    n_it = len(energies)
    if again["energies"] != energies or not torch.equal(again["z"],
                                                        first["z"]):
        raise AssertionError(f"{what}: a repeated solve gave "
                             f"{again['energies']}, the first {energies}")
    cap = cfg.cg_max_iter + 1
    for name, r in (("persistent", first), ("per-step", steps),
                    ("plain", plain), ("whole-grid glue", grid[0])):
        e = r["energies"]
        if not all(map(math.isfinite, e)):
            raise AssertionError(f"{what}: {name} energies not finite: {e}")
        if not stop_rule_held(e, cfg.tolerance, cfg.max_iterations):
            raise AssertionError(f"{what}: {name} stopping rule violated: "
                                 f"{e}")
        if not all(c == cap or (form == "jacobi" and 0 < c < cap)
                   for c in r["cg_iters"]):
            raise AssertionError(f"{what}: {name} CG iterations "
                                 f"{r['cg_iters']} off the cap")
    for name, r, route in (("persistent", first, "persistent"),
                           ("repeated", again, "persistent"),
                           ("whole-grid glue", grid[0], "persistent"),
                           ("whole-grid glue again", grid[1], "persistent"),
                           ("per-step", steps, "steps")):
        want = dict(expected_counts(0), **shard_counts(
            len(r["energies"]), shards, cfg.cg_max_iter, form, route))
        if r["launches"] != want:
            raise AssertionError(f"{what}: {name} run's kernel runs "
                                 f"{r['launches']}, expected {want}")
    if any(plain["launches"].values()):
        raise AssertionError(f"{what}: kernels ran in the plain run: "
                             f"{plain['launches']}")
    m = torch.as_tensor(data.mask) != 0
    z = first["z"].cpu()
    if not bool(torch.isfinite(z).all()):
        raise AssertionError(f"{what}: final depth is not finite")
    rmse = float((z[m] - torch.as_tensor(z_true)[m]).double().square()
                 .mean().sqrt())
    out = []
    for name, e, e_ref, other, hold in (
            ("persistent", energies, plain["energies"], "plain", True),
            ("per-step", steps["energies"], plain["energies"], "plain",
             True),
            ("persistent", energies, steps["energies"], "per-step", True),
            ("banded", energies, grid[0]["energies"], "whole-grid glue",
             True),
            ("persistent", energies, ref, "unsharded", form != "jacobi")):
        gap = max(abs(x - y) for x, y in zip(e, e_ref))
        bnd = energy_bound(e_ref[0], const)
        out.append(f"{name} vs the {other} run ({len(e_ref)} outer "
                   f"iterations): energies max gap {gap:.4f} "
                   + ("within" if hold else "printed against")
                   + f" phase 3's bound {bnd:.3f}")
        if not hold:
            continue
        if abs(len(e_ref) - len(e)) > 1:
            raise AssertionError(f"{what}: {name} {len(e)} outer "
                                 f"iterations, the {other} run {len(e_ref)}")
        k = min(len(e_ref), len(e))
        check_close(f"{what} {name} energies vs the {other} run's (const "
                    f"{const})", e[:k], e_ref[:k], 0, bnd)
    per = {name: 1e3 * r["seconds"] / len(r["energies"]) for name, r in (
        ("persistent", first), ("grid", grid[0]), ("grid again", grid[1]),
        ("repeat", again), ("per-step", steps), ("plain", plain))}
    mem = {name: {"peak_allocated_bytes": r["peak_bytes"],
                  "resident_bytes": r["resident_bytes"]}
           for name, r in (("bands", first), ("bands again", again),
                           ("grid", grid[0]), ("grid again", grid[1]))}
    gib = lambda b: f"{b / 2**30:.4f} GiB"  # noqa: E731
    print(f"[{label}] {what}: {n_it} outer iterations, final energy "
          f"{energies[-1]:.4f}, solve {first['seconds']:.4f} s; ms/outer-"
          "iter in turns banded " + f"{per['persistent']:.3f}, whole-grid "
          f"glue {per['grid']:.3f}, {per['grid again']:.3f}, banded "
          f"{per['repeat']:.3f}; per-step {per['per-step']:.3f}, plain "
          f"{per['plain']:.3f}; peak allocated banded "
          f"{gib(first['peak_bytes'])} / {gib(again['peak_bytes'])}, "
          f"whole-grid glue {gib(grid[0]['peak_bytes'])} / "
          f"{gib(grid[1]['peak_bytes'])} (allocated at the start "
          f"{gib(first['resident_bytes'])} / "
          f"{gib(grid[0]['resident_bytes'])}); bytes per shard of the "
          f"placed problem and state {first['shard_bytes']} against "
          f"{first['whole_bytes']} whole "
          f"({max(first['shard_bytes']) / first['whole_bytes']:.4f}); "
          f"launches {({k: v for k, v in first['launches'].items() if v})}"
          f", per-step run {len(steps['energies'])} outer iterations, "
          f"launches {({k: v for k, v in steps['launches'].items() if v})};"
          f" CG iterations {first['cg_iters']}, depth RMSE vs truth "
          f"{rmse:.4f}; repeated solve bit-equal; " + "; ".join(out),
          flush=True)
    print(f"[{label}] energy trace {energies}; whole-grid glue "
          f"{grid[0]['energies']}; per-step {steps['energies']}; plain "
          f"{plain['energies']}", flush=True)
    return {"iterations": n_it, "energies": energies,
            "seconds": first["seconds"], "launches": first["launches"],
            "rmse": rmse, "ms_per_outer_iteration": per, "memory": mem,
            "shard_bytes": first["shard_bytes"],
            "whole_bytes": first["whole_bytes"],
            "steps": {"iterations": len(steps["energies"]),
                      "launches": steps["launches"]}}


def data_axis(label, datas, shards=4, data=2):
    """Phase 4l: ``datas`` (one lane per data group) on ``make_mesh(shards,
    data=data)`` over the card, each lane in shards / data row bands
    (``shard_pytree(..., batched=True)``): one ``step_sharded`` of the
    batch, each lane's energy within phase 3's bound of its solo solve's
    first (one persistent launch per lane), then each lane's
    ``solve_sharded``: a finite trace, the stopping rule, at most one outer
    iteration from its solo solve (``srps.solve_fused``, the stencil CG
    kernel, run here) and every energy within phase 3's bound of it, every
    depth CG one persistent shard launch. Prints ms per outer iteration of
    each lane and of its solo solve."""
    import torch

    from srmeetsps_cuda_tpu_torch.config import SolverConfig
    from srmeetsps_cuda_tpu_torch.parallel import sharded
    from srmeetsps_cuda_tpu_torch.parallel.batched import (stack_problems,
                                                           stack_states)
    from srmeetsps_cuda_tpu_torch.runtime.solver import prepare

    dev = torch.device("cuda")
    cfg = SolverConfig()
    mesh = sharded.make_mesh(shards, data=data, devices=dev)
    what = (f"data axis {mesh.shape} "
            + " and ".join(f"{d.mask.shape[0]}x{d.mask.shape[1]}"
                           for d in datas) + f" n={datas[0].I.shape[0]}")
    solos = [solo_run(d, cfg=cfg) for d in datas]
    pairs = [prepare(d, cfg, dev) for d in datas]
    probs = sharded.shard_pytree(stack_problems([p for p, _ in pairs]),
                                 mesh, batched=True)
    states = sharded.shard_pytree(stack_states([s for _, s in pairs]), mesh,
                                  batched=True)
    del pairs
    reset_counts()
    out = sharded.step_sharded(states, probs, 2, cfg, mesh)
    firsts = [float(t.parts[0].energy) for t in out.trees]
    if read_counts()["shard_cg persistent"] != len(datas):
        raise AssertionError(f"{what}: step_sharded launches "
                             f"{read_counts()}")
    lines = []
    for b, (solo, pb, st) in enumerate(zip(solos, probs.trees,
                                           states.trees)):
        if not isinstance(pb, sharded.Bands) or \
                pb.mesh.size != shards // data:
            raise AssertionError(f"{what}: lane {b} placed as {type(pb)}")
        ref, const = solo["energies"], solo["const"]
        bnd = energy_bound(ref[0], const)
        check_close(f"{what} lane {b} step_sharded energy", [firsts[b]],
                    ref[:1], 0, bnd)
        torch.cuda.synchronize()
        reset_counts()
        t0 = time.perf_counter()
        final, trace = sharded.solve_sharded(st, pb, 2, cfg, mesh)
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        n_it = final.parts[0].iteration
        e = trace[:n_it].tolist()
        want = dict(expected_counts(0), **shard_counts(
            n_it, shards // data, cfg.cg_max_iter, "std"))
        if read_counts() != want:
            raise AssertionError(f"{what}: lane {b} kernel runs "
                                 f"{read_counts()}, expected {want}")
        if not all(map(math.isfinite, e)) or not stop_rule_held(
                e, cfg.tolerance, cfg.max_iterations):
            raise AssertionError(f"{what}: lane {b} energies {e}")
        if abs(len(ref) - n_it) > 1:
            raise AssertionError(f"{what}: lane {b} {n_it} outer "
                                 f"iterations, its solo solve {len(ref)}")
        k = min(len(ref), n_it)
        check_close(f"{what} lane {b} energies vs its solo solve's (const "
                    f"{const})", e[:k], ref[:k], 0, bnd)
        lines.append(f"lane {b}: {n_it} outer iterations (solo "
                     f"{len(ref)}), {1e3 * dt / n_it:.3f} ms/outer-iter "
                     f"(solo {1e3 * solo['seconds'] / len(ref):.3f}), "
                     f"energies max gap "
                     f"{max(abs(x - y) for x, y in zip(e, ref)):.4f} within "
                     f"{bnd:.3f}")
    print(f"[{label}] {what}, {shards // data} row bands per lane: "
          f"step_sharded energies {firsts} within phase 3's bound of the "
          f"solo solves' first; " + "; ".join(lines), flush=True)


def cli_sharded(label, tmp, path, ref, const):
    """Phase 4j: ``--sharded 4`` through the CLI on ``path``, one shard per
    card present (at most 4): the metrics name the shard count, the
    stopping rule and every depth CG through the shard kernels (one card:
    the persistent kernel, a one-device mesh; several: the per-step
    kernels), energies within phase 3's bound of the unsharded run
    ``ref``."""
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
    want = dict(expected_counts(0, captures=1), **shard_counts(
        n_it, shards, 100, "std", "persistent" if shards == 1 else "steps"))
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
          f"iterations, launches "
          f"{({k: v for k, v in launches.items() if v})}, solve {dt:.4f} s "
          f"({1e3 * dt / n_it:.3f} "
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


def glue_graphs_phase(label, datas) -> dict:
    """Phase 4m: the outer iteration's glue replayed from CUDA graphs
    (``models/glue.py``). The fused solve of ``datas[0]`` through
    ``runtime.solver.solve`` and the lockstep solve of all of ``datas``
    (zero-padded to their common grid), each with the graphs and with the
    engagement rule forced false, under a profiler: bit for bit the same z,
    rho, s, N, dz and energies; the kernel launches of ``expected_counts``
    both ways; ``glue_replays`` every iteration but each solve's first two
    (B lanes each in lockstep) and none eager, the ``srps.iteration``
    spans' ``glue`` attribute ``"eager"``, ``"capture"``, then
    ``"replay"``; a second fused solve with the graphs, which the first
    kept (``glue.Kept``), bit for bit again and ``"replay"`` from its
    first iteration. Then ms per outer iteration of each route with and
    without the graphs, untraced, in turns (graphs, eager, eager,
    graphs)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from srmeetsps_cuda_tpu_torch import trace as tracing
    from srmeetsps_cuda_tpu_torch.config import RuntimeConfig, SolverConfig
    from srmeetsps_cuda_tpu_torch.models import glue
    from srmeetsps_cuda_tpu_torch.parallel import batched
    from srmeetsps_cuda_tpu_torch.runtime import solver

    dev = torch.device("cuda")
    cfg = SolverConfig()
    H = max(d.mask.shape[0] for d in datas)
    W = max(d.mask.shape[1] for d in datas)
    rule = glue.engages

    def fused():
        final, metrics = solver.solve(datas[0], cfg, RuntimeConfig(
            fused_outer_loop=True), device=dev, verbose=False)
        return [final], [[m["energy"] for m in metrics if "energy" in m]]

    def lockstep():
        pairs = [solver.prepare(d, cfg, dev, pad_to=(H, W)) for d in datas]
        finals, traces = batched.solve_batch(
            [s for _, s in pairs], [p for p, _ in pairs], 2, cfg,
            mode="lockstep")
        return finals, [t[:int(f.iteration)].tolist()
                        for f, t in zip(finals, traces)]

    def run(fn, graphs: bool, traced: bool):
        glue.engages = rule if graphs else (lambda device, check: False)
        try:
            torch.cuda.synchronize()
            reset_counts()
            t0 = time.perf_counter()
            with (profile(activities=[ProfilerActivity.CPU]) if traced
                  else contextlib.nullcontext()):
                finals, energies = fn()
                torch.cuda.synchronize()
            dt = time.perf_counter() - t0
        finally:
            glue.engages = rule
        its = [r for r in tracing.records() if r["name"] == "srps.iteration"]
        return {"fields": [[getattr(f, k).cpu() for k in (
                    "z", "rho", "s", "N", "dz")] for f in finals],
                "energies": energies, "seconds": dt,
                "launches": read_counts(),
                "glue": [r["attrs"]["glue"] for r in its] if traced else None,
                "replays": sum(r["counts"]["glue_replays"] for r in its)
                if traced else None}

    out = {}
    for name, fn in (("fused", fused), ("lockstep", lockstep)):
        lanes = 1 if name == "fused" else len(datas)
        glue.drop(dev)  # the fused solve is its key's first: it captures
        on, off = run(fn, True, True), run(fn, False, True)
        kept = [run(fn, True, True)] if name == "fused" else []
        n = max(map(len, on["energies"]))
        for got in [on] + kept:
            for k in ("energies", "fields"):
                same = (got[k] == off[k] if k == "energies" else all(
                    torch.equal(a, b) for fa, fb in zip(got[k], off[k])
                    for a, b in zip(fa, fb)))
                if not same:
                    raise AssertionError(f"{name}: {k} with the glue's "
                                         "graphs differ from the eager "
                                         "glue's")
        want = expected_counts(n, captures=lanes)
        for got in [on, off] + kept:
            if got["launches"] != want:
                raise AssertionError(f"{name}: launches {got['launches']} "
                                     f"for {n} outer iterations")
        modes = ["eager", "capture"] + ["replay"] * (n - 2)
        if on["glue"] != modes or on["replays"] != lanes * (n - 2):
            raise AssertionError(f"{name}: glue {on['glue']}, replays "
                                 f"{on['replays']} for {n} iterations of "
                                 f"{lanes} lane(s)")
        if any(g["glue"] != ["replay"] * n or g["replays"] != n
               for g in kept):
            raise AssertionError(f"{name}: a second solve of the key ran "
                                 f"glue {kept[0]['glue']}")
        if set(off["glue"]) != {"eager"} or off["replays"] != 0:
            raise AssertionError(f"{name}: the eager run counted "
                                 f"{off['replays']} replays ({off['glue']})")
        turns = [run(fn, graphs, False)["seconds"]
                 for graphs in (True, False, False, True)]
        ms = [1e3 * t / n for t in turns]
        out[name] = {"outer_iterations": n, "lanes": lanes,
                     "glue_replays": on["replays"],
                     "ms_per_outer_iter": {"graphs": [ms[0], ms[3]],
                                           "eager": [ms[1], ms[2]]}}
        print(f"[{label}] glue graphs, {name} solve of {lanes} lane(s) at "
              f"{H}x{W}: bit-equal to the eager glue over {n} outer "
              f"iterations, glue {on['glue']}, glue_replays {on['replays']}"
              + (f" (a second solve of the key {kept[0]['replays']})"
                 if kept else "") + ", "
              f"launches {on['launches']}; ms/outer-iter in turns graphs "
              f"{ms[0]:.3f}, eager {ms[1]:.3f}, eager {ms[2]:.3f}, graphs "
              f"{ms[3]:.3f}", flush=True)
    return out


BENCH = [sys.executable, "-m", "srmeetsps_cuda_tpu_torch.bench"]
BENCH_NOTE = re.compile(r"^\[bench \+\s*[\d.]+s\] (\S+) done; launches "
                        r"(\{.*\})$", re.M)


def bench_run(label, mode: str, timeout: int) -> tuple:
    """Phase 5: ``mode`` of the port's bench (``""`` the default) as a
    subprocess. Returns its last line and the launches of each section
    (its stderr notes); raises unless it exits 0, prints only JSON lines,
    the last with every key of the mode and no ``*_error`` key, and every
    section launched the stencil CG."""
    from srmeetsps_cuda_tpu_torch import bench

    name = mode or "main"
    t0 = time.perf_counter()
    proc = subprocess.run(BENCH + ([mode] if mode else []), cwd=ROOT,
                          capture_output=True, text=True, timeout=timeout)
    wall = time.perf_counter() - t0
    if proc.returncode != 0:
        raise AssertionError(f"bench {name} exited {proc.returncode}: "
                             f"{proc.stdout[-2000:]}{proc.stderr[-4000:]}")
    lines = [json.loads(s) for s in proc.stdout.splitlines()]
    last = lines[-1]
    missing = [k for k in bench.KEYS[name] if k not in last]
    errors = [k for k in last if k.endswith("_error")]
    if missing or errors:
        raise AssertionError(f"bench {name}: keys missing {missing}, errors "
                             f"{ {k: last[k] for k in errors} }")
    launches = {m.group(1): json.loads(m.group(2))
                for m in BENCH_NOTE.finditer(proc.stderr)}
    if not launches or any(n["stencil_cg"] < 1 for n in launches.values()):
        raise AssertionError(f"bench {name}: stencil_cg launches per "
                             f"section {launches}")
    # Every capture prepared launches the inpaint kernel: the device
    # metrics prepare one at 512 sweeps, the accuracy section three at 64;
    # the other sections prepare at 512 sweeps, one mode's at least once.
    inpaint = {s: n["inpaint"] for s, n in launches.items()}
    want = {"device_metrics": inpaint_passes(1),
            "accuracy": inpaint_passes(3, 64)}
    if (any(inpaint[s] != n for s, n in want.items() if s in inpaint)
            or any(n % inpaint_passes(1) for s, n in inpaint.items()
                   if s not in want)
            or not sum(inpaint.values())):
        raise AssertionError(f"bench {name}: inpaint launches per section "
                             f"{inpaint}")
    if name == "main" and launches["device_metrics"]["direct_cg"] < 1:
        raise AssertionError(f"bench: the device metrics launched no "
                             f"direct_cg: {launches}")
    print(f"[{label}] bench {name}: exit 0 in {wall:.1f} s, {len(lines)} "
          f"JSON lines, launches per section {launches}", flush=True)
    print(f"[{label}] bench {name} last line: {json.dumps(last)}",
          flush=True)
    return last, launches, wall


def chain_host_waits(data) -> dict:
    """Phase 5: the synchronise calls and host reads ``torch.profiler``
    sees in a chain of two ``srps_iteration`` calls on ``data`` (after a
    warm one) beyond those of an empty block (the profiler's own
    ``cudaDeviceSynchronize`` as it stops), with the runtime's kernel
    launch calls, which show that it sees runtime calls at all."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from srmeetsps_cuda_tpu_torch.config import SolverConfig
    from srmeetsps_cuda_tpu_torch.models import srps
    from srmeetsps_cuda_tpu_torch.runtime.solver import prepare

    cfg = SolverConfig()
    prob, st = prepare(data, cfg, torch.device("cuda"))
    st = srps.srps_iteration(st, prob, 2, cfg)
    torch.cuda.synchronize()
    seen = {}
    for n in (0, 2):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(n):
                st = srps.srps_iteration(st, prob, 2, cfg)
        torch.cuda.synchronize()
        names = [e.name for e in prof.events()]
        seen[n] = {"synchronize": sum("Synchronize" in s for s in names),
                   "host_reads": names.count("aten::_local_scalar_dense"),
                   "launch_calls": sum(s.startswith("cudaLaunch")
                                       for s in names)}
    return {k: seen[2][k] - seen[0][k] for k in seen[2]}


def bench_phase(label, stencil_entry: dict) -> dict:
    """Phase 5 (see the module docstring). Returns the figures the
    ``kernels`` line keeps: under the stencil CG's entry and the direct
    CG's."""
    from srmeetsps_cuda_tpu_torch import bench

    t0 = time.perf_counter()
    data = bench.synthetic_dataset()
    waits = chain_host_waits(data)
    if waits["launch_calls"] and (waits["synchronize"]
                                  or waits["host_reads"]):
        raise AssertionError(f"a chain of srps_iteration waits for the "
                             f"card: {waits}")
    print(f"[{label}] bench: a chain of 2 srps_iteration calls on the "
          f"bench's 960x1280 input: {waits['synchronize']} synchronise "
          f"calls, {waits['host_reads']} host reads among "
          f"{waits['launch_calls']} launch calls"
          + ("" if waits["launch_calls"] else
             " (the profiler saw no runtime call: not measured)"),
          flush=True)
    with plain_depth_cg("stencil"):
        plain = solo_run(data)
    del data
    last, notes, wall = bench_run(label, "", 900)
    for key in ("accuracy_ok", "bf16_accuracy_ok", "matpath_energy_matches"):
        if last[key] is not True:
            raise AssertionError(f"bench: {key} is {last[key]}")
    ref, n = plain["energies"], last["iterations"]
    bnd = energy_bound(ref[0], plain["const"])
    at = ref[min(n, len(ref)) - 1]
    if abs(n - len(ref)) > 1 or not abs(last["final_energy"] - at) <= bnd:
        raise AssertionError(
            f"bench headline: {n} outer iterations, final energy "
            f"{last['final_energy']}; plain depth CG {len(ref)}, {ref} "
            f"(bound {bnd:.3f})")
    ratio = last["ms_per_cg_iter"] / stencil_entry["ms"]
    if not 0.5 <= ratio <= 2.0:
        raise AssertionError(
            f"bench ms_per_cg_iter {last['ms_per_cg_iter']:.4f} against "
            f"phase 3's {stencil_entry['ms']:.4f}")
    print(f"[{label}] bench headline: {n} outer iterations (plain depth CG "
          f"{len(ref)}), final energy {last['final_energy']:.4f} (plain "
          f"{at:.4f}, phase 3's bound {bnd:.3f}); ms_per_cg_iter "
          f"{last['ms_per_cg_iter']:.4f} = {ratio:.3f} x phase 3's "
          f"{stencil_entry['ms']:.4f}; accuracy rmse {last['rmse']:.5f}, "
          f"normals {last['normals_err_deg']:.3f} deg; bf16_energy_ok "
          f"{last['bf16_energy_ok']} (printed, not held)", flush=True)
    runs = {"main": (last, notes, wall)}
    for mode, timeout in (("4k", 600), ("batched-mixed", 600)):
        runs[mode] = bench_run(label, mode, timeout)
    total = lambda k: sum(n[k] for _, ns, _ in runs.values()  # noqa: E731
                          for n in ns.values())
    print(f"[{label}] phase 5 (bench): {time.perf_counter() - t0:.1f} s",
          flush=True)
    keep = ("ms_per_outer_iter", "ms_per_cg_iter", "pcg_matvec_gflops",
            "1080p_ms_per_cg_iter", "seconds_per_solve", "iterations")
    return {
        "stencil_cg": {"launches": total("stencil_cg"),
                       **{k: last[k] for k in keep}},
        "direct_cg": {"launches": total("direct_cg"),
                      **{k: last[k] for k in ("ms_per_cg_iter_streaming",
                                              "cg_bytes_per_iter_mb",
                                              "gbps")}},
    }


def grid_key(grid) -> str:
    h, w, sf = grid
    return f"{h}x{w} sf {sf}"


def grid_fields(e) -> dict:
    """The figures of one grid's entry that the ``kernels`` line keeps
    under ``grids``."""
    keys = ("ms", "plain_ms", "bound_ms", "bound_by", "stream_bound_ms",
            "cg_iterations", "update_rel_rms", "residual_rel_gap",
            "gamma_rel_gap", "energy_gap_of_bound", "layout",
            "stream_planes", "max_abs_err")
    return {k: e[k] for k in keys if k in e}


def direct_entries(per_form, launches):
    """The ``kernels`` line's entries of the direct CG, one per form: the
    960 x 1280 sf = 2 figures, those of the other grids under ``grids``,
    and the launches of the main-path runs ``launches[form]``."""
    out = []
    for form, grids in per_form.items():
        entry = dict(grids[960, 1280, 2])
        entry["grids"] = {grid_key(g): grid_fields(e)
                          for g, e in grids.items()}
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
    kernels = ["stencil_cg", "cgs_cg", "direct_cg", "shard_cg", "inpaint"]
    fresh = [k for k in kernels if not native.library_path(k).exists()]
    native.build_all(kernels)
    for k in kernels:
        native.load(k)
    print(f"[{label}] build {', '.join(k + '.cu' for k in kernels)}: "
          f"{time.perf_counter() - t0:.3f} s (compiled: {fresh or 'none'})",
          flush=True)

    dev = torch.device("cuda")
    inpaint_entry = inpaint_vs_plain(label, dev)
    upload_phase(label)
    grids = [(960, 1280, 2), (240, 320, 1), (480, 640, 4)]
    # h and w multiples of neither block's tile (4 x 256, 16 x 32): partial
    # tiles on both edges.
    odd = (242, 322, 2)
    shared = {g: stacked_lanes(*g, range(4), dev)
              for g in grids + [(960, 1280, 4), odd]}
    stencil_grids = kernel_vs_plain(label, grids + [odd])
    entry = stencil_grids.pop((960, 1280, 2))
    stencil_lanes(label, entry, *shared[960, 1280, 2])
    cgs_grids = cg_vs_plain(label, {g: shared[g] for g in grids + [odd]},
                            "cgs")
    cgs_entry = cgs_grids.pop((960, 1280, 2))
    jac = cg_vs_plain(label, shared, "jacobi")
    scaled_entry, pcg_entry = jac[960, 1280, 2], jac[960, 1280, 4]
    layouts_bit_equal(label, shared[960, 1280, 2][0], {
        "stencil_cg": entry, "stencil_cg jacobi scaled": scaled_entry,
        "cgs_cg": cgs_entry})
    entry["grids"] = {grid_key(g): grid_fields(e)
                      for g, e in stencil_grids.items()}
    cgs_entry["grids"] = {grid_key(g): grid_fields(e)
                          for g, e in cgs_grids.items()}
    for form_entry, want_sf4 in ((scaled_entry, False), (pcg_entry, True)):
        form_entry["grids"] = {
            grid_key(g): grid_fields(e) for g, e in jac.items()
            if g not in ((960, 1280, 2), (960, 1280, 4))
            and (g[2] == 4) == want_sf4}
    # 3f on phase 3's grids.
    phase3 = {g: shared[g] for g in grids}
    direct = {form: cg_vs_plain(label, phase3, form) for form in DIRECT_FORMS}
    direct_vs_stencil(label, phase3)
    big = (1088, 1920, 2)
    big_lanes = {big: stacked_lanes(*big, range(2), dev)}
    # 3g: the row-shard kernels on phase 3's grids, on 248 x 322 (rows of
    # 322 floats: the 4-byte staging copies, halo rows included) and at
    # 1088 x 1920.
    narrow = (248, 322, 2)
    shard = shard_vs_plain(
        label, {**phase3, narrow: stacked_lanes(*narrow, range(2), dev),
                **big_lanes}, timed={big, (480, 640, 4)})
    del shared, phase3
    big_entry = kernel_vs_plain(label, [big])[big]
    big_entry["name"] = "stencil_cg 1088x1920"
    big_jac = cg_vs_plain(label, big_lanes, "jacobi")[big]
    big_entry["jacobi"] = {k: big_jac[k] for k in (
        "ms", "plain_ms", "bound_ms", "bound_by", "cg_iterations",
        "energy_abs_gap", "energy_gap_of_bound", "layout", "stream_planes",
        "stream_bound_ms")}
    cgs_entry["grids"][grid_key(big)] = time_large(
        label, big, big_lanes[big][0])["cgs_cg"]
    del big_lanes
    # 3f at bench.py's 4K grid, and the persistent kernels timed there.
    k4 = (2176, 3840, 2)
    k4_lanes = {k4: stacked_lanes(*k4, range(4), dev)}
    for form in DIRECT_FORMS:
        direct[form].update(cg_vs_plain(label, k4_lanes, form))
    direct_vs_stencil(label, k4_lanes)
    for name, e in time_large(label, k4, k4_lanes[k4][0]).items():
        (entry if name == "stencil_cg" else cgs_entry)["grids"][
            grid_key(k4)] = e
    del k4_lanes
    direct_launches = {form: {} for form in DIRECT_FORMS}

    with tempfile.TemporaryDirectory() as tmp:
        a, a_data, a_true = write_dataset(tmp, 960, 1280, seed=0)
        main = main_path(label, tmp, a, a_data, a_true)
        entry["launches"] = main["launches"]["stencil_cg"]
        inpaint_entry["launches"] = main["launches"]["inpaint"]
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
        # 4m: the glue's CUDA graphs against the eager glue.
        glue_graphs_phase(label, [a_data, b_data, c_data, a_data])

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
        # 4k: bf16 images and the CLI's runtime options on the same file.
        entry["bf16"] = phase_4k(label, tmp, a, a_data, a_true, main, const)

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
        print(f"[{label}] 1088x1920 n=20 on 4 row shards, ms/outer-iter "
              "banded persistent / whole-grid glue persistent / banded "
              "per-step route: " + ", ".join(
                  f"{form} {r['ms_per_outer_iteration']['persistent']:.3f} / "
                  f"{r['ms_per_outer_iteration']['grid']:.3f} / "
                  f"{r['ms_per_outer_iteration']['per-step']:.3f}"
                  for form, r in shard_runs.items())
              + f", against {per_it[0]:.3f} (standard) and "
              f"{per_it[1]:.3f} (--jacobi) unsharded (4g)", flush=True)
        os.remove(e)
        # 4l: the data axis, two 960 x 1280 lanes on 2 row bands each.
        data_axis(label, [a_data, c_data])

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
    # Where each CG's plain version stops the same solve: the kernels' f32
    # energy steps round otherwise (printed, not held).
    plain4k = {}
    for op, s in (("stencil", k4_stencil), ("direct", k4_direct)):
        plain4k[op] = api_solve(label, data4k, true4k,
                                SolverConfig(cg_operator=op),
                                runs4k[op][0]["energies"], const4k,
                                hold=False, plain=True)
        s["plain"] = {"outer_iterations": plain4k[op]["iterations"],
                      "energies": plain4k[op]["energies"],
                      "kernel_energies": runs4k[op][0]["energies"]}
    print(f"[{label}] 4K 2176x3840 n=8 sf=2, each solve twice with equal "
          "energies: " + "; ".join(
              f"{op} {s['outer_iterations']} outer iterations, "
              + " / ".join(f"{t:.3f}" for t in s["ms_per_outer_iteration"])
              + f" ms/outer-iter, peak allocated "
              f"{s['peak_allocated_bytes'] / 2**30:.3f} GiB"
              for op, s in (("direct", k4_direct), ("stencil", k4_stencil)))
          + "; plain versions: " + ", ".join(
              f"{op} {r['iterations']} outer iterations"
              for op, r in plain4k.items()), flush=True)
    direct_launches["direct"]["4k"] = dict(k4_direct, stencil=k4_stencil)
    # 4k at 4K: one bf16 "stencil" solve, its peak beside the f32 runs'.
    k4_bf16 = api_solve(label, data4k, true4k,
                        SolverConfig(image_dtype="bfloat16"),
                        runs4k["stencil"][0]["energies"], const4k,
                        hold=False)
    entry["bf16"]["4k"] = {
        "outer_iterations": k4_bf16["iterations"],
        "ms_per_outer_iteration": 1e3 * k4_bf16["seconds"]
        / k4_bf16["iterations"],
        "peak_allocated_bytes": k4_bf16["peak_bytes"],
        "f32_peak_allocated_bytes": k4_stencil["peak_allocated_bytes"]}
    print(f"[{label}] 4K bf16 \"stencil\": {k4_bf16['iterations']} outer "
          f"iterations, peak allocated {k4_bf16['peak_bytes'] / 2**30:.3f} "
          f"GiB against f32 "
          f"{k4_stencil['peak_allocated_bytes'] / 2**30:.3f} GiB", flush=True)

    # 5: the port's bench on the card.
    del data4k, true4k
    torch.cuda.empty_cache()
    figures = bench_phase(label, entry)
    entry["bench"] = figures["stencil_cg"]
    direct_launches["direct"]["bench"] = figures["direct_cg"]

    print(json.dumps({"kernels": [entry, cgs_entry, scaled_entry, pcg_entry,
                                  big_entry]
                      + direct_entries(direct, direct_launches)
                      + shard_entries(
                          shard, {f: r["launches"]
                                  for f, r in shard_runs.items()},
                          {f: r["steps"]["launches"]
                           for f, r in shard_runs.items()},
                          big, [(480, 640, 4)])
                      + [inpaint_entry]}))
    print(label)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
