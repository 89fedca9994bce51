"""The port's benchmark: ``bench.py``'s sections, on the CUDA card.

    python -m srmeetsps_cuda_tpu_torch.bench [mode] [B] [--cpu]

The modes are ``bench.py``'s own. With none, every section runs in
``bench.py``'s order (the headline solve with its fast and bf16 presets, the
device metrics, the MAT path, sf 4, B = 4 objects, the 1088 x 1920 grid,
the accuracy gates) and one cumulative JSON line is printed after each, so
that a run cut short still leaves a whole last line. ``batched [B]``,
``batched-mixed [B]``, ``batched-bf16 [B]``, ``sf4``, ``1080p``, ``4k`` and
``matpath`` run one section and print one line. A section that raises
records ``<section>_error`` in the line, the run goes on, and the process
exits 1. Progress notes go to stderr, each with the kernel launches its
section made.

It runs on CUDA device 0, through the port's entry points
(``runtime.solver.prepare``, ``models.srps.solve_fused`` and
``srps_iteration``, ``parallel.batched``, ``io.mat_loader``,
``runtime.solver.solve``), so every solve runs the hand-written kernels.
``--cpu`` runs the same sections on the CPU with the kernels' plain
versions; without it a machine with no CUDA device exits 1 and prints no
result. The ``device`` key names what ran: the card's name and power limit
as ``nvidia-smi`` prints them, or ``cpu``, where every time is the CPU's.

Inputs: the Mitten image folder where ``SRPS_MITTEN`` names it or it lies
at ``dataset/Mitten`` beside the package, else :func:`synthetic_dataset`,
which draws from ``np.random.default_rng(0)`` in ``bench.py``'s order, so
its arrays are bit for bit ``bench.py``'s (uniform noise images, z0 in
[4000, 8000)).

How the times are taken:

* A whole solve: ``prepare`` once, outside the timed window; one warm
  solve, which also builds the kernels; then each timed solve is
  ``srps.solve_fused`` and a device synchronise under a host clock. The
  clock stays a host clock because the outer loop reads its stop test on
  the host every iteration, so a whole solve includes host work.
* "Sustained" runs keep ``bench.py``'s form: n solves back to back and one
  synchronise at the end. There XLA dispatched ahead of the device; the
  port's loop waits for each stop test either way, so no solve's work
  overlaps the next one's here.
* Device metrics (:func:`device_metrics`): marginal times between two chain
  lengths, which cancel the prologue and the first launch; CUDA events
  around each chain, the lengths in turns within each repetition, the best
  time of each. A marginal that comes out <= 0 is measured once more; if
  it is still <= 0 its key is left out and ``<metric>_measure_error`` set.

What ``bench.py`` has that this module leaves out: ``vs_baseline`` (its
baseline is a TPU time), ``use_pallas`` (on the card the kernels always
run) and the TPU's band model of the streaming kernel's bytes. The MAT path
writes MAT 7.3 where ``h5py`` imports and MAT v5 otherwise, into a
temporary directory, never a fixed cache file that could outlive the data.
"""

from __future__ import annotations

import argparse
import dataclasses
import importlib.util
import json
import math
import os
import subprocess
import sys
import tempfile
import time
import traceback

import numpy as np
import torch

from .config import RuntimeConfig, SolverConfig
from .device import resolve_device, synchronize
from .io.image_loader import ProblemData, load_image_dataset
from .io.mat_loader import load_mat_dataset, save_mat_dataset
from .models import srps
from .ops import gradients as gradops
from .ops.grid import meshgrid_camera
from .ops.normals import normals_from_depth
from .parallel import batched
from .runtime.solver import prepare, solve
from .solve import direct_cg as dc
from .solve import stencil_cg as sc

MITTEN_ENV = "SRPS_MITTEN"
MIXED_SIZES = ((960, 1280), (912, 1216), (896, 1152), (864, 1088))
# f32 planes per pixel that one iteration of the direct CG moves through
# device memory (csrc/direct_cg.cu: phase A reads 9 F fields, r, p_old and
# writes p, w; phase B reads x, r, p, w and writes x, r; PERF.md "Stream").
DIRECT_STREAM_PLANES = 21

# The keys of each mode's line: bench.py's, less ``vs_baseline``.
KEYS = {
    "main": (
        "metric", "value", "unit", "seconds_per_solve",
        "seconds_per_solve_mean", "sustained_solves_per_sec", "iterations",
        "final_energy", "device", "dataset",
        "fast_sustained_solves_per_sec", "fast_device_time_ratio",
        "fast_final_energy",
        "bf16_sustained_solves_per_sec", "bf16_device_time_ratio",
        "bf16_final_energy", "bf16_energy_delta_rel", "bf16_energy_ok",
        "ms_per_outer_iter", "ms_per_cg_iter_streaming",
        "cg_bytes_per_iter_mb", "gbps", "ms_per_cg_iter",
        "pcg_matvec_gflops",
        "matpath_solves_per_sec", "matpath_seconds_per_solve",
        "matpath_load_seconds", "matpath_final_energy",
        "matpath_energy_matches",
        "sf4_solves_per_sec", "sf4_seconds_per_solve", "sf4_iterations",
        "sf4_final_energy",
        "batched4_solves_per_sec", "batched4_seconds_per_batch",
        "batched4_iterations", "batched4_lockstep_solves_per_sec",
        "1080p_solves_per_sec", "1080p_seconds_per_solve",
        "1080p_iterations", "1080p_ms_per_outer_iter", "1080p_ms_per_cg_iter",
        "1080p_pcg_matvec_gflops",
        "rmse", "rmse_init", "rmse_golden", "normals_err_deg", "accuracy_ok",
        "bf16_rmse", "bf16_normals_err_deg", "bf16_accuracy_ok"),
    "4k": ("metric", "value", "unit", "seconds_per_solve", "iterations",
           "final_energy"),
    "batched-mixed": ("metric", "value", "unit", "seconds_per_batch",
                      "sizes", "iterations"),
}

_T0 = time.time()


def _note(msg: str) -> None:
    """A progress note on stderr (stdout holds only the JSON lines)."""
    print(f"[bench +{time.time() - _T0:7.1f}s] {msg}", file=sys.stderr,
          flush=True)


def launch_counts() -> dict:
    """The launches each kernel of the bench's path has made so far."""
    return {"stencil_cg": sc.stencil_cg.launches,
            "direct_cg": dc.direct_cg.launches}


def device_label(device: torch.device) -> str:
    """``cpu``, or the card's name and power limit as ``nvidia-smi
    --query-gpu=name,power.limit --format=csv,noheader`` prints them."""
    if device.type != "cuda":
        return "cpu"
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader", f"--id={device.index or 0}"],
            capture_output=True, text=True, check=True, timeout=60)
        return out.stdout.strip().splitlines()[0]
    except (OSError, subprocess.SubprocessError, IndexError):
        return f"{torch.cuda.get_device_name(device)}, power limit not read"


# ---------------------------------------------------------------------------
# Inputs (bench.py:54-89, 220-229, 280-289)
# ---------------------------------------------------------------------------


def find_dataset():
    """The Mitten image folder: ``$SRPS_MITTEN``, else ``dataset/Mitten``
    beside the package, where either exists; else None."""
    here = os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), "dataset", "Mitten")
    for path in (os.environ.get(MITTEN_ENV), here):
        if path and os.path.isdir(path):
            return path
    return None


def synthetic_dataset(h=960, w=1280, sf=2, n=20, c=3) -> ProblemData:
    """The workload with the Mitten geometry when the fixture is absent:
    bench.py's arrays, bit for bit."""
    rng = np.random.default_rng(0)
    yy, xx = np.mgrid[0:h, 0:w]
    mask = (((yy - h / 2) ** 2 + (xx - w / 2) ** 2) < (0.4 * min(h, w)) ** 2
            ).astype(np.float32)
    I = rng.random((n, c, h, w)).astype(np.float32)
    z0 = (rng.random((n, h // sf, w // sf)).astype(np.float32) + 1.0) * 4000.0
    K = np.array([[1216.73, 0, w / 2 - 0.5], [0, 1216.73, h / 2 - 0.5],
                  [0, 0, 1]], np.float32)
    return ProblemData(I=I, K=K, mask=mask, sf=sf, z0=z0)


def _load_mitten():
    """``(data, source)``: the Mitten folder's dataset and its path, or
    the synthetic one and None."""
    ds = find_dataset()
    if ds:
        return load_image_dataset(ds), ds
    return synthetic_dataset(), None


def _crop_data(data, h, w) -> ProblemData:
    sf = int(data.sf)
    return ProblemData(
        I=np.asarray(data.I)[:, :, :h, :w], K=data.K,
        mask=np.asarray(data.mask)[:h, :w], sf=data.sf,
        z0=np.asarray(data.z0)[:, :h // sf, :w // sf])


def _sf4_data(base=None) -> ProblemData:
    if base is None:
        base, _ = _load_mitten()
    if base.z0.shape[1] * 4 == base.mask.shape[0]:
        return ProblemData(I=base.I, K=base.K, mask=base.mask, sf=4,
                           z0=base.z0)
    return ProblemData(I=base.I, K=base.K, mask=base.mask, sf=4,
                       z0=base.z0[:, ::2, ::2])


# ---------------------------------------------------------------------------
# Whole-solve timing (bench.py:164-217)
# ---------------------------------------------------------------------------


def _solve(st, prob, sf, cfg, device):
    """One fused solve, waited for."""
    final, _ = srps.solve_fused(st, prob, sf, cfg)
    synchronize(device)
    return final


def _fused_best(data, cfg, device, runs=3):
    """``(times, final)``: ``runs`` timed fused solves after a warm one,
    the problem prepared once before them."""
    sf = int(data.sf)
    prob, st = prepare(data, cfg, device)
    final = _solve(st, prob, sf, cfg, device)
    times = []
    for _ in range(runs):
        t0 = time.perf_counter()
        final = _solve(st, prob, sf, cfg, device)
        times.append(time.perf_counter() - t0)
    return times, final


def _sustained(data, cfg, device, n=8):
    """``(seconds per solve, last final)`` of n solves back to back with
    one synchronise at the end, after a warm solve."""
    sf = int(data.sf)
    prob, st = prepare(data, cfg, device)
    _solve(st, prob, sf, cfg, device)
    t0 = time.perf_counter()
    last = None
    for _ in range(n):
        last, _ = srps.solve_fused(st, prob, sf, cfg)
    synchronize(device)
    return (time.perf_counter() - t0) / n, last


def _timed_solve(data, cfg, metric, device, runs=3) -> dict:
    times, final = _fused_best(data, cfg, device, runs)
    dt = min(times)
    return {"metric": metric, "value": 1.0 / dt, "unit": "solves/sec",
            "seconds_per_solve": dt, "iterations": int(final.iteration),
            "final_energy": float(final.energy)}


# ---------------------------------------------------------------------------
# BASELINE.md's configurations 2-5 and bench.py's extra grids
# ---------------------------------------------------------------------------


def batched_metrics(device, B: int = 4, image_dtype: str = "float32",
                    data=None, cfg=None, rounds=2, reps=3) -> dict:
    """BASELINE configuration 4: B objects in both execution forms, each
    timed as reps x (rounds batches back to back, one synchronise), the
    best seconds per batch: stream (each lane through the single fused
    solve) and lockstep (one lane-batched CG launch per outer iteration)."""
    if data is None:
        data, _ = _load_mitten()
    cfg = dataclasses.replace(cfg or SolverConfig(), image_dtype=image_dtype)
    prob, st = prepare(data, cfg, device)
    probs_l, states_l = [prob] * B, [st] * B
    prob_b = batched.stack_problems(probs_l)
    st_b = batched.stack_states(states_l)
    sf = int(data.sf)

    def sustained(run):
        run()
        synchronize(device)
        best = math.inf
        for _ in range(reps):
            t0 = time.perf_counter()
            for _ in range(rounds):
                run()
            synchronize(device)
            best = min(best, (time.perf_counter() - t0) / rounds)
        return best

    dt = sustained(lambda: batched.solve_batched_streaming(
        states_l, probs_l, sf, cfg))
    dt_lk = sustained(lambda: batched.solve_batched(st_b, prob_b, sf, cfg))
    finals, _ = batched.solve_batched_streaming(states_l, probs_l, sf, cfg)
    sfx = "_bf16" if image_dtype == "bfloat16" else ""
    return {
        f"batched{B}{sfx}_solves_per_sec": B / dt,
        f"batched{B}{sfx}_seconds_per_batch": dt,
        f"batched{B}{sfx}_iterations": [int(f.iteration) for f in finals],
        f"batched{B}{sfx}_lockstep_solves_per_sec": B / dt_lk,
    }


def bench_batched_mixed(device, B: int = 4, base=None, sizes=MIXED_SIZES,
                        cfg=None, runs=3) -> dict:
    """Mixed-geometry batching: B crops of different sizes, each prepared
    at its own size and zero-padded to the largest, solved in lockstep."""
    if base is None:
        base, _ = _load_mitten()
    cfg = cfg or SolverConfig()
    datas = [_crop_data(base, *sizes[b % len(sizes)]) for b in range(B)]
    H = max(h for h, _ in sizes[:B])
    W = max(w for _, w in sizes[:B])
    pairs = [prepare(d, cfg, device, pad_to=(H, W)) for d in datas]
    prob_b = batched.stack_problems([p for p, _ in pairs])
    st_b = batched.stack_states([s for _, s in pairs])
    sf = int(base.sf)
    batched.solve_batched(st_b, prob_b, sf, cfg)
    synchronize(device)
    times = []
    for _ in range(runs):
        t0 = time.perf_counter()
        final, _ = batched.solve_batched(st_b, prob_b, sf, cfg)
        synchronize(device)
        times.append(time.perf_counter() - t0)
    dt = min(times)
    return {"metric": f"mitten_sf2_batched{B}_mixed_geometry",
            "value": B / dt, "unit": "solves/sec", "seconds_per_batch": dt,
            "sizes": [list(s) for s in sizes[:B]],
            "iterations": final.iteration.tolist()}


def sf4_metrics(device, data=None, cfg=None, runs=3) -> dict:
    """BASELINE configuration 3: sf 4 (the depth decimated once more)."""
    times, final = _fused_best(_sf4_data(data), cfg or SolverConfig(),
                               device, runs)
    dt = min(times)
    return {"sf4_solves_per_sec": 1.0 / dt, "sf4_seconds_per_solve": dt,
            "sf4_iterations": int(final.iteration),
            "sf4_final_energy": float(final.energy)}


def metrics_1080p(device, h=1088, w=1920, n=12, cfg=None, runs=3,
                  dm=None) -> dict:
    """BASELINE configuration 5's problem size on one card, with the light
    device metrics (prefix ``1080p_``)."""
    cfg = cfg or SolverConfig()
    data = synthetic_dataset(h=h, w=w, sf=2, n=n)
    times, final = _fused_best(data, cfg, device, runs)
    dt = min(times)
    out = {"1080p_solves_per_sec": 1.0 / dt, "1080p_seconds_per_solve": dt,
           "1080p_iterations": int(final.iteration)}
    del final
    try:
        prob, state0 = prepare(data, cfg, device)
        out.update(device_metrics(prob, state0, 2, cfg, device,
                                  prefix="1080p_", light=True, **(dm or {})))
    except Exception as e:  # the wall keys above stay in the line
        traceback.print_exc()
        out["1080p_device_metrics_error"] = f"{type(e).__name__}: {e}"[:200]
    return out


def matpath_metrics(device, data=None, headline_energy=None, cfg=None,
                    runs=3) -> dict:
    """BASELINE configuration 2, the MATLAB-container input: the dataset
    written as a MAT file (7.3 where h5py imports, else v5) in a temporary
    directory, loaded back through ``io.mat_loader`` and solved. The
    inputs are bit for bit the same, so the final energy must equal the
    headline's."""
    if data is None:
        data, _ = _load_mitten()
    fmt = "mat73" if importlib.util.find_spec("h5py") else "mat5"
    _note(f"matpath: writing MAT {'7.3' if fmt == 'mat73' else 'v5'}"
          + ("" if fmt == "mat73" else " (h5py is not installed)"))
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "converted.mat")
        save_mat_dataset(path, data, fmt=fmt)
        t0 = time.perf_counter()
        data_m = load_mat_dataset(path)
        load_s = time.perf_counter() - t0
    times, final = _fused_best(data_m, cfg or SolverConfig(), device, runs)
    dt = min(times)
    out = {"matpath_solves_per_sec": 1.0 / dt,
           "matpath_seconds_per_solve": dt, "matpath_load_seconds": load_s,
           "matpath_final_energy": float(final.energy)}
    if headline_energy is not None:
        out["matpath_energy_matches"] = bool(
            float(final.energy) == float(headline_energy))
    return out


def bench_4k(device, h=2176, w=3840, n=8, cfg=None, runs=3) -> dict:
    """bench.py's 4K-class grid on one card."""
    data = synthetic_dataset(h=h, w=w, sf=2, n=n)
    return _timed_solve(data, cfg or SolverConfig(), "4k_sf2_e2e_solve",
                        device, runs)


# ---------------------------------------------------------------------------
# The accuracy gates (bench.py:397-487)
# ---------------------------------------------------------------------------


def accuracy_fixture():
    """bench.py's exactly consistent 48 x 32 fixture: images rendered with
    the solver's own masked-stencil normals of a known surface whose
    high-frequency detail the bicubic start cannot see. Returns
    ``(data, z_true, N_true)``; the normals are built on the CPU."""
    rng = np.random.default_rng(42)
    h, w, sf, n, c = 48, 32, 2, 6, 3
    yy0, xx0 = np.mgrid[0:h, 0:w]
    z_true = (80 + 6 * np.sin(xx0 / 5.0) + 5 * np.cos(yy0 / 6.0)
              + 1.5 * np.sin(2.4 * xx0) * np.cos(2.2 * yy0)
              ).astype(np.float32)
    mask = (((yy0 - h / 2) ** 2 + (xx0 - w / 2) ** 2)
            < (0.45 * min(h, w)) ** 2).astype(np.float32)
    fx = fy = 400.0
    cx, cy = w / 2 - 0.5, h / 2 - 0.5
    m = torch.as_tensor(mask)
    gm = gradops.GradientMasks.from_mask(m)
    zt = torch.as_tensor(z_true * mask)
    zx, zy = gradops.grad_x(zt, gm), gradops.grad_y(zt, gm)
    xx, yy = meshgrid_camera(h, w, cx, cy)
    N_true = normals_from_depth(zt, zx, zy, xx * m, yy * m, m, fx, fy)[0]
    N_true = N_true.numpy()
    rho_true = (0.4 + 0.3 * rng.random((c, 1, 1))).astype(np.float32)
    I = np.empty((n, c, h, w), np.float32)
    for i in range(n):
        s = np.array([0.2, 0.2, -0.9, 0.3]) + 0.2 * rng.standard_normal(4)
        shade = np.einsum("k,khw->hw", s.astype(np.float32), N_true)
        I[i] = (rho_true * shade[None]) * mask
    z0 = np.stack([
        z_true[::sf, ::sf] + 1.0 * rng.standard_normal((h // sf, w // sf))
        for _ in range(n)]).astype(np.float32)
    K = np.array([[fx, 0, cx], [0, fy, cy], [0, 0, 1]], np.float32)
    return ProblemData(I=I, K=K, mask=mask, sf=sf, z0=z0), z_true, N_true


def accuracy_metrics(device) -> dict:
    """Depth RMSE and mean normal angle against the truth of
    :func:`accuracy_fixture`, solved in f32 and with bf16 images, each held
    to bench.py's gates: normals under 15 degrees and the RMSE within 0.15
    (bf16: 0.25) of the golden 1.009."""
    data, z_true, N_true = accuracy_fixture()
    m = data.mask != 0

    def scores(final):
        rmse = float(np.sqrt(np.mean(
            (final.z.cpu().numpy() - z_true)[m] ** 2)))
        dot = np.clip((final.N.cpu().numpy()[:3] * N_true[:3]).sum(0), -1, 1)
        return rmse, float(np.degrees(np.arccos(dot[m])).mean())

    cfg = SolverConfig(inpaint_iters=64)
    _, state0 = prepare(data, cfg, device)
    rmse0 = float(np.sqrt(np.mean((state0.z.cpu().numpy() - z_true)[m]
                                  ** 2)))
    rmse, err_deg = scores(solve(data, cfg, RuntimeConfig(), device=device,
                                 verbose=False)[0])
    # The frozen golden of this fixed fixture (bench.py:455-462): z-RMSE
    # against z_true is no invariant of the minimised energy, only its
    # stability on this fixture is.
    rmse_golden = 1.009
    cfg_b = SolverConfig(inpaint_iters=64, image_dtype="bfloat16")
    rmse_b, err_deg_b = scores(solve(data, cfg_b, RuntimeConfig(),
                                     device=device, verbose=False)[0])
    return {
        "rmse": rmse,
        "rmse_init": rmse0,
        "rmse_golden": rmse_golden,
        "normals_err_deg": err_deg,
        "accuracy_ok": bool(err_deg < 15.0
                            and abs(rmse - rmse_golden) < 0.15),
        "bf16_rmse": rmse_b,
        "bf16_normals_err_deg": err_deg_b,
        "bf16_accuracy_ok": bool(err_deg_b < 15.0
                                 and abs(rmse_b - rmse_golden) < 0.25),
    }


# ---------------------------------------------------------------------------
# Device metrics (bench.py:490-676)
# ---------------------------------------------------------------------------


def event_timer(device: torch.device):
    """``timer(fn) -> (seconds, fn())``: CUDA events around ``fn`` on a
    CUDA device, a host clock on the CPU (where every call is
    synchronous)."""
    if device.type != "cuda":
        def host(fn):
            t0 = time.perf_counter()
            out = fn()
            return time.perf_counter() - t0, out
        return host

    def events(fn):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        out = fn()
        b.record()
        b.synchronize()
        return a.elapsed_time(b) / 1e3, out
    return events


def marginal(run, lengths, reps, timer) -> float:
    """Seconds per unit of work between two chain lengths. ``run(n)`` runs
    a chain of length n and returns its work (a count, or a tensor the
    count is read from after the timer has waited for it). Each length is
    run once to warm up, then the lengths in turns, ``reps`` times; the
    best time of each length counts. NaN where the two works are equal."""
    for n in lengths:
        timer(lambda: run(n))
    best, work = {}, {}
    for _ in range(reps):
        for n in lengths:
            t, wk = timer(lambda: run(n))
            best[n] = min(best.get(n, math.inf), t)
            work[n] = int(wk)
    a, b = lengths
    if work[a] == work[b]:
        return math.nan
    return (best[a] - best[b]) / (work[a] - work[b])


def _retry_then_omit(measure):
    """``measure()``, measured once more where it is not > 0; None where it
    still is not (host or device drift swamped the difference)."""
    s = measure()
    if not s > 0:
        s = measure()
    return s if s > 0 else None


def device_metrics(prob, state, sf, cfg, device, prefix="", light=False, *,
                   outer=None, caps=None, calls=None, reps=None,
                   timer=None) -> dict:
    """Marginal device times from one warm state (one outer iteration past
    ``state``): ms per outer iteration (chains of ``srps_iteration`` of
    ``outer`` lengths, 4/24, light 2/8); ms per CG iteration of the
    production kernel (``stencil_cg``, ``calls`` launches per chain at the
    ``caps`` 100/25, light 4 launches at 50/15) over the iterations the
    kernel reports; with ``light`` off the same of the direct CG in its
    ``"direct"`` form (``ms_per_cg_iter_streaming``) with its bytes at
    ``DIRECT_STREAM_PLANES`` planes per pixel and their rate; and the
    matvec GFLOP/s, (18 + 4 [sf = 4]) flops per pixel over the production
    time. Every marginal goes through :func:`_retry_then_omit`; an omitted
    one leaves ``<metric>_measure_error`` in its place. ``timer`` is
    :func:`event_timer`'s by default."""
    timer = timer or event_timer(device)
    reps = reps or (3 if light else 5)
    outer = outer or ((2, 8) if light else (4, 24))
    caps = caps or ((50, 15) if light else (100, 25))
    calls = calls or (4 if light else 8)
    lam = cfg.lam
    st = srps.srps_iteration(state, prob, sf, cfg)
    h, w = st.z.shape
    out, errors = {}, {}

    def outer_chain(n):
        s = st
        for _ in range(n):
            s = srps.srps_iteration(s, prob, sf, cfg)
        return n

    s_outer = _retry_then_omit(lambda: marginal(outer_chain, outer, reps,
                                                timer))
    if s_outer is None:
        errors["outer_iter"] = True
    else:
        out[f"{prefix}ms_per_outer_iter"] = s_outer * 1e3

    mom = srps.s_moments(prob, st.s)
    op = srps.build_depth_operator(prob, mom, st.rho, st.dz, lam)
    args = (st.z, op, prob.gm, prob.ktw, prob.z0t, prob.z0u)

    def cg_chain(kernel, **kw):
        # tol 1e-30 squares to 0 in f32: every launch runs to its cap.
        def run(cap):
            return torch.stack([kernel(*args, sf=sf, lam=lam, tol=1e-30,
                                       max_iter=cap, **kw)[1]
                                for _ in range(calls)]).sum()
        return lambda: marginal(run, caps, reps, timer)

    s_stream = None
    if not light:
        s_stream = _retry_then_omit(cg_chain(dc.direct_cg, with_energy=True))
        if s_stream is None:
            errors["cg_iter_streaming"] = True
    s_prod = _retry_then_omit(cg_chain(sc.stencil_cg))
    if s_prod is None:
        errors["cg_iter"] = True
    if s_stream is not None:
        bytes_iter = DIRECT_STREAM_PLANES * 4 * h * w
        out.update({f"{prefix}ms_per_cg_iter_streaming": s_stream * 1e3,
                    f"{prefix}cg_bytes_per_iter_mb": bytes_iter / 1e6,
                    f"{prefix}gbps": bytes_iter / s_stream / 1e9})
    if s_prod is None:
        s_prod = s_stream
    if s_prod is not None:
        out[f"{prefix}ms_per_cg_iter"] = s_prod * 1e3
        matvec_flops = (18 + (4 if sf == 4 else 0)) * h * w
        out[f"{prefix}pcg_matvec_gflops"] = matvec_flops / s_prod / 1e9
    for name in errors:
        out[f"{prefix}{name}_measure_error"] = \
            "drift-inverted marginal after retry"
    return out


# ---------------------------------------------------------------------------
# Running the sections
# ---------------------------------------------------------------------------


def run_section(name: str, fn, result: dict) -> None:
    """``result.update(fn())``; where ``fn`` raises, ``<name>_error`` and
    the traceback on stderr instead. A note on stderr gives the launches
    the section made."""
    before = launch_counts()
    try:
        result.update(fn())
    except Exception as e:
        traceback.print_exc()
        result[f"{name}_error"] = f"{type(e).__name__}: {e}"[:200]
        _note(f"{name} FAILED: {e!s:.120}")
        return
    after = launch_counts()
    _note(f"{name} done; launches "
          + json.dumps({k: after[k] - before[k] for k in after}))


def failed(result: dict) -> bool:
    """Whether a section (or the 1080p device metrics) raised; a marginal
    left out for drift (``*_measure_error``) is no failure."""
    return any(k.endswith("_error") and not k.endswith("_measure_error")
               for k in result)


def run_all(device, *, data=None, cfg=None, runs=5, sustained=8, B=4,
            big=None, dm=None, emit=None) -> bool:
    """Every section in bench.py's order on ``data`` (the Mitten folder's,
    or :func:`synthetic_dataset`) with ``cfg``; the cumulative line goes to
    ``emit`` (a printed JSON line) after each. ``big`` and ``dm`` are the
    sizes of :func:`metrics_1080p` and :func:`device_metrics`. Returns
    whether every section succeeded."""
    emit = emit or (lambda r: print(json.dumps(r), flush=True))
    cfg = cfg or SolverConfig()
    ds = None
    if data is None:
        data, ds = _load_mitten()
    _note("dataset loaded")
    sf = int(data.sf)
    result, head = {}, {}

    def headline():
        times, final = _fused_best(data, cfg, device, runs)
        dt = min(times)
        _note(f"headline timed ({dt:.3f}s best)")
        head["energy"] = float(final.energy)
        out = {"metric": "mitten_sf2_e2e_solve", "value": 1.0 / dt,
               "unit": "solves/sec", "seconds_per_solve": dt,
               "seconds_per_solve_mean": sum(times) / len(times),
               "iterations": int(final.iteration),
               "final_energy": head["energy"]}
        del final
        head["sustained"], _ = _sustained(data, cfg, device, sustained)
        out.update({"sustained_solves_per_sec": 1.0 / head["sustained"],
                    "device": device_label(device),
                    "dataset": ds or "synthetic"})
        return out

    def fast():
        dt, fin = _sustained(data, dataclasses.replace(cfg, cg_max_iter=40),
                             device, sustained)
        return {"fast_sustained_solves_per_sec": 1.0 / dt,
                "fast_device_time_ratio": dt / head["sustained"],
                "fast_final_energy": float(fin.energy)}

    def bf16():
        dt, fin = _sustained(
            data, dataclasses.replace(cfg, image_dtype="bfloat16"), device,
            sustained)
        e_rel = abs(float(fin.energy) - head["energy"]) / abs(head["energy"])
        return {"bf16_sustained_solves_per_sec": 1.0 / dt,
                "bf16_device_time_ratio": dt / head["sustained"],
                "bf16_final_energy": float(fin.energy),
                "bf16_energy_delta_rel": e_rel,
                "bf16_energy_ok": bool(e_rel < 0.05)}

    def metrics():
        prob, state0 = prepare(data, cfg, device)
        return device_metrics(prob, state0, sf, cfg, device, **(dm or {}))

    sections = (
        ("headline", headline),
        ("fast", fast),
        ("bf16", bf16),
        ("device_metrics", metrics),
        ("matpath", lambda: matpath_metrics(device, data, head.get("energy"),
                                            cfg)),
        ("sf4", lambda: sf4_metrics(device, data, cfg)),
        ("batched", lambda: batched_metrics(device, B, data=data, cfg=cfg)),
        ("1080p", lambda: metrics_1080p(device, cfg=cfg, dm=dm,
                                        **(big or {}))),
        ("accuracy", lambda: accuracy_metrics(device)),
    )
    for name, fn in sections:
        run_section(name, fn, result)
        emit(result)
    return not failed(result)


MODES = ("", "batched", "batched-mixed", "batched-bf16", "sf4", "1080p",
         "4k", "matpath")


def main(argv=None, **sizes) -> int:
    """The command line. ``sizes`` go to the mode's function (the tests
    run the sections small; the command line sets no sizes)."""
    p = argparse.ArgumentParser(
        prog="python -m srmeetsps_cuda_tpu_torch.bench",
        description="bench.py's sections through the PyTorch + CUDA port")
    p.add_argument("mode", nargs="?", default="", choices=MODES)
    p.add_argument("B", nargs="?", type=int, default=4,
                   help="objects per batch (the batched modes)")
    p.add_argument("--cpu", action="store_true",
                   help="run on the CPU with the kernels' plain versions")
    args = p.parse_args(argv)
    try:
        device = resolve_device(cpu=args.cpu)
    except RuntimeError as e:
        print(f"bench: {e}", file=sys.stderr)
        return 1
    if args.mode == "":
        return 0 if run_all(device, **sizes) else 1
    fns = {
        "batched": lambda: batched_metrics(device, args.B, **sizes),
        "batched-bf16": lambda: batched_metrics(
            device, args.B, image_dtype="bfloat16", **sizes),
        "batched-mixed": lambda: bench_batched_mixed(device, args.B, **sizes),
        "sf4": lambda: sf4_metrics(device, **sizes),
        "1080p": lambda: metrics_1080p(device, **sizes),
        "4k": lambda: bench_4k(device, **sizes),
        "matpath": lambda: matpath_metrics(device, **sizes),
    }
    result = {}
    run_section(args.mode.replace("-", "_"), fns[args.mode], result)
    print(json.dumps(result), flush=True)
    return 1 if failed(result) else 0


if __name__ == "__main__":
    sys.exit(main())
