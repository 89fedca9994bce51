"""The outer loop: alternation, stopping rule, metrics, dumps, resume.

Port of ``srmeetsps_cuda_tpu/runtime/solver.py`` (the control flow of
``SRPS::execute``, SRPS.cu:84-370), with two modes:

* **stepwise**: per-phase timings (each phase ends on a device
  synchronise) and the reference's print format; the CPU default.
* **fused**: no per-phase synchronisation, one host read per outer
  iteration (the stop test); the energy trace is reported at the end. The
  CUDA default.
"""

from __future__ import annotations

import json
import os
import time

import numpy as np
import torch

from ..config import Preferences, RuntimeConfig, SolverConfig
from ..device import synchronize
from ..io import writers
from ..models import srps
from ..pre import preprocess_depth


class Timer:
    """Wall-clock phase timer (reference Timer, Utilities.h:194-222):
    ``end`` waits for the device before reading the clock."""

    def __init__(self, device: torch.device):
        self.device = device
        self.t0 = 0.0
        self.elapsed = 0.0

    def start(self) -> "Timer":
        self.t0 = time.perf_counter()
        return self

    def end(self) -> float:
        synchronize(self.device)
        self.elapsed = time.perf_counter() - self.t0
        return self.elapsed


def prepare(data, cfg: SolverConfig, device: torch.device,
            return_zs: bool = False):
    """Preprocessing and problem/state construction on ``device``
    (SRPS.cu:100-270). ``data`` has the ``ProblemData`` fields."""
    h, w = np.asarray(data.mask).shape
    z0 = torch.as_tensor(np.ascontiguousarray(data.z0, np.float32),
                         device=device)
    zs, z_init = preprocess_depth(z0, h, w, cfg)
    prob = srps.build_problem(data.I, data.mask, data.K, int(data.sf), zs,
                              device)
    state = srps.init_state(prob, z_init)
    if return_zs:
        return prob, state, zs
    return prob, state


def state_from_checkpoint(ck: dict, device: torch.device) -> srps.SRPSState:
    """The state a checkpoint written by either package's
    ``save_checkpoint`` holds."""
    t = lambda k: torch.as_tensor(np.asarray(ck[k], np.float32), device=device)  # noqa: E731
    return srps.SRPSState(
        z=t("z"), rho=t("rho"), s=t("s"), N=t("N"), dz=t("dz"),
        energy=t("energy"), last_energy=t("last_energy"),
        iteration=int(ck["iteration"]),
        cg_iters=torch.zeros((), dtype=torch.int32, device=device))


def solve(data, cfg: SolverConfig = SolverConfig(),
          rt: RuntimeConfig = RuntimeConfig(), *, device: torch.device,
          prefs: Preferences = Preferences(), verbose: bool = True):
    """End-to-end solve on ``device``. Returns (final_state, metrics)."""
    prob, state, zs = prepare(data, cfg, device, return_zs=True)
    sf = int(data.sf)
    block = (prefs.block_x, prefs.block_y)

    if rt.dump_iterations and rt.dump_format in ("mat", "mat5"):
        writers.dump_preprocessing(rt.dump_dir, zs, state.z, prob.mask,
                                   fmt=rt.dump_format)
    if rt.resume_from:
        state = state_from_checkpoint(writers.load_checkpoint(rt.resume_from),
                                      device)
    if rt.save_visualizations:
        # The initial normals, shown beside every iteration by the
        # reference ("Normals-Initial", SRPS.cu:270,321).
        writers.save_visualizations(rt.dump_dir, state, prob.mask, tag="_init")

    if rt.fused_outer_loop:
        final, metrics = _solve_fused(state, prob, sf, cfg, rt, block, verbose)
    else:
        final, metrics = _solve_stepwise(state, prob, sf, cfg, rt, block,
                                         verbose)
    _write_outputs(final, prob, rt, metrics)
    return final, metrics


def _solve_fused(state, prob, sf, cfg, rt, block, verbose):
    keep_states = rt.dump_iterations or rt.save_visualizations
    records, states = [], []

    def record(st):
        # Device tensors only: nothing here waits for the device.
        records.append((st.iteration, st.energy, st.cg_iters))
        if keep_states:
            states.append(st)

    t = Timer(prob.mask.device).start()
    final, _ = srps.solve_fused(state, prob, sf, cfg, block,
                                on_iteration=record)
    dt = t.end()
    metrics = [{"iteration": k, "energy": float(e), "cg_iterations": int(c)}
               for k, e, c in records]
    n_it = final.iteration
    metrics.append({"total_seconds": dt, "iterations": n_it})
    if verbose:
        print(f"fused solve: {n_it} iterations in {dt:.3f}s, "
              f"final energy {float(final.energy):.3f}")
    for st in states:
        _dump_iteration(st, prob, rt)
    return final, metrics


def _dump_iteration(st, prob, rt: RuntimeConfig):
    if rt.dump_iterations:
        # Untagged names each iteration (the reference overwrites) and a
        # resumable checkpoint.
        writers.dump_state(rt.dump_dir, st, prob.mask, fmt=rt.dump_format)
        writers.save_checkpoint(os.path.join(rt.dump_dir, "checkpoint.npz"),
                                st, st.iteration)
    if rt.save_visualizations:
        writers.save_visualizations(rt.dump_dir, st, prob.mask,
                                    tag=f"_{st.iteration:02d}")


def _solve_stepwise(state, prob, sf, cfg, rt, block, verbose):
    dev = prob.mask.device
    metrics = []
    last_error = float(state.energy) if rt.resume_from else float("nan")
    iteration = state.iteration + 1
    while True:
        # Per-phase timing with the reference's print format
        # (SRPS.cu:277-295); the normals after the summary are untimed.
        t = Timer(dev).start()
        s = srps.estimate_lighting(prob, state.rho, state.N, state.s)
        t_light = t.end()
        if verbose:
            print(f"\n{'Lightning Estimation':<25}: {t_light:<6.6f}s")
        t = Timer(dev).start()
        mom = srps.s_moments(prob, s)
        rho = srps.estimate_albedo(prob, mom, state.N, state.rho)
        t_albedo = t.end()
        if verbose:
            print(f"{'Albedo Estimation':<25}: {t_albedo:<6.6f}s")
        t = Timer(dev).start()
        z, energy, cg_iters = srps.estimate_depth(
            prob, mom, rho, state.dz, state.z, sf, cfg, block)
        t_depth = t.end()
        if verbose:
            print(f"{'Depth Estimation':<25}: {t_depth:<6.6f}s")

        error = float(energy)
        rel_err = abs(last_error - error) / abs(error)
        metrics.append({
            "iteration": iteration,
            "energy": error,
            "relative_error": rel_err,
            "cg_iterations": int(cg_iters),
            "lighting_seconds": t_light,
            "albedo_seconds": t_albedo,
            "depth_seconds": t_depth,
            "seconds": t_light + t_albedo + t_depth,
        })
        if verbose:
            print(f"\nIteration {iteration:02d} summary")
            print(f"{'Error':<25}: {error:<6.3f}")
            print(f"{'Relative Error':<25}: {rel_err:<6.3f}")

        N, dz = srps.depth_normals(z, prob)
        state = srps.SRPSState(
            z=z, rho=rho, s=s, N=N, dz=dz, energy=energy,
            last_energy=state.energy, iteration=state.iteration + 1,
            cg_iters=cg_iters)
        _dump_iteration(state, prob, rt)
        # The reference's stopping rule (SRPS.cu:297-301).
        stop = (error > last_error) or (rel_err < cfg.tolerance) or (
            iteration > cfg.max_iterations)
        last_error = error
        iteration += 1
        if stop:
            return state, metrics


def _write_outputs(state, prob, rt: RuntimeConfig, metrics):
    if rt.metrics_jsonl:
        parent = os.path.dirname(rt.metrics_jsonl)
        if parent:
            os.makedirs(parent, exist_ok=True)
        with open(rt.metrics_jsonl, "w") as f:
            for rec in metrics:
                f.write(json.dumps(rec) + "\n")
    if rt.dump_iterations:
        writers.dump_state(rt.dump_dir, state, prob.mask, fmt=rt.dump_format,
                           tag="_final")
    if rt.save_visualizations:
        writers.save_visualizations(rt.dump_dir, state, prob.mask,
                                    tag="_final")
