"""The outer loop: alternation, stopping rule, metrics, dumps, resume.

Port of ``srmeetsps_cuda_tpu/runtime/solver.py`` (the control flow of
``SRPS::execute``, SRPS.cu:84-370), with two modes:

* **stepwise**: per-phase timings (each phase ends on a device
  synchronise) and the reference's print format; the CPU default.
* **fused**: no per-phase synchronisation, one host read per outer
  iteration (the stop test); the energy trace is reported at the end. The
  CUDA default.

Both run the run-level options of ``RuntimeConfig``: dumps, checkpoints,
visualizations, the live view, the operator dump, the finiteness check of
each phase (``nan_check``) and a ``torch.profiler`` trace
(``profile_dir``), which holds the phases' ``srps.*`` ranges (``trace.py``)
and has their spans and counters written beside it.
"""

from __future__ import annotations

import contextlib
import json
import os
import socket
import time

import numpy as np
import torch

from .. import trace as tracing
from ..config import Preferences, RuntimeConfig, SolverConfig
from ..device import synchronize
from ..io import writers
from ..models import glue, srps
from ..ops.grid import pad_to_multiple
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
            return_zs: bool = False, pad_to=None, into=None):
    """Preprocessing and problem/state construction on ``device``
    (SRPS.cu:100-270). ``data`` has the ``ProblemData`` fields.

    ``pad_to=(H, W)`` zero-pads the grid at its far ends after the
    native-size preprocessing, so that objects of several sizes share one
    lane-batched solve: the smoothing and inpainting never see the pad, and
    every padded pixel lies outside the mask, where the masked operators
    are exactly zero.

    ``into``: a problem whose tensors the problem is built into
    (``srps.build_problem``), the kept single solve's; the state returned
    has tensors of its own either way."""
    h, w = np.asarray(data.mask).shape
    sf = int(data.sf)
    if pad_to is not None:
        H, W = pad_to
        if H % sf or W % sf or H < h or W < w:
            raise ValueError(f"bad pad_to {pad_to} for ({h},{w}), sf={sf}")
    with tracing.span("srps.prepare"):
        z0 = srps.to_f32(data.z0, device)
        zs, z_init = preprocess_depth(z0, h, w, cfg)
        mask, I = data.mask, data.I
        if pad_to is not None:
            mask, I = (srps.to_f32(a, device) for a in (mask, I))
            with tracing.span("srps.prepare.pad"):
                # 0 < h <= H: the next multiple of H is H itself.
                mask, I, z_init = (pad_to_multiple(a, H, W)[0]
                                   for a in (mask, I, z_init))
                zs = pad_to_multiple(zs, H // sf, W // sf)[0]
        with tracing.span("srps.prepare.problem"):
            prob = srps.build_problem(I, mask, data.K, sf, zs, device,
                                      image_dtype=cfg.image_dtype,
                                      into=into)
        tracing.bind(prob)
        with tracing.span("srps.prepare.state"):
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


@contextlib.contextmanager
def profiling(profile_dir, device: torch.device):
    """A ``torch.profiler`` trace of the block, CUDA activity included on
    a CUDA device, written as a Chrome trace (``<stem>.pt.trace.json``)
    into ``profile_dir`` (JAX runtime/solver.py:148-160 takes a
    ``jax.profiler`` trace), with the block's spans and counters beside it
    (``<stem>.spans.jsonl``, ``trace.dump``); nothing when
    ``profile_dir`` is None."""
    if not profile_dir:
        yield
        return
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if device.type == "cuda":
        activities.append(ProfilerActivity.CUDA)
    prof = profile(activities=activities)
    try:
        with prof:
            yield
    finally:
        os.makedirs(profile_dir, exist_ok=True)
        stem = os.path.join(profile_dir, f"{socket.gethostname()}_"
                            f"{os.getpid()}.{time.time_ns()}")
        prof.export_chrome_trace(stem + ".pt.trace.json")
        tracing.dump(stem + ".spans.jsonl")


def solve(data, cfg: SolverConfig = SolverConfig(),
          rt: RuntimeConfig = RuntimeConfig(), *, device: torch.device,
          prefs: Preferences = Preferences(), verbose: bool = True):
    """End-to-end solve on ``device``. Returns (final_state, metrics)."""
    with profiling(rt.profile_dir, device):
        return _solve(data, cfg, rt, device, prefs, verbose)


def _solve(data, cfg, rt, device, prefs, verbose):
    block = (prefs.block_x, prefs.block_y)
    check = srps.check_finite if rt.nan_check else None
    # The single solve's graphs, and the tensors they read, kept for the
    # next solve of the same key (models/glue.py).
    kept = None
    if rt.fused_outer_loop and glue.engages(device, check):
        kept = glue.kept(device, srps.capture_key(np.shape(data.I), data.K,
                                                  data.sf, cfg))
    try:
        return _solve_with(kept, data, cfg, rt, device, block, check,
                           verbose)
    except BaseException:
        if kept is not None:
            # A solve that failed leaves the kept tensors half written.
            glue.drop(device)
        raise


def _solve_with(kept, data, cfg, rt, device, block, check, verbose):
    """The solve, through the :class:`glue.Kept` solve ``kept`` unless it
    is None: the problem built into its tensors, the state copied into
    them, and a copy of the final state returned (the next solve
    overwrites the kept one)."""
    prob, state, zs = prepare(data, cfg, device, return_zs=True,
                              into=kept.prob if kept else None)
    sf = int(data.sf)

    if rt.dump_iterations and rt.dump_format in ("mat", "mat5"):
        writers.dump_preprocessing(rt.dump_dir, zs, state.z, prob.mask,
                                   fmt=rt.dump_format)
    if rt.dump_operators:
        from ..io.sparse_dump import dump_operators

        dump_operators(rt.dump_dir, prob, sf, fmt=rt.dump_format)
    if rt.resume_from:
        state = state_from_checkpoint(writers.load_checkpoint(rt.resume_from),
                                      device)
    if rt.save_visualizations:
        # The initial normals, shown beside every iteration by the
        # reference ("Normals-Initial", SRPS.cu:270,321).
        writers.save_visualizations(rt.dump_dir, state, prob.mask, tag="_init")
    viewer = None
    if rt.live_view:
        from ..io.liveview import LiveView

        viewer = LiveView()
        viewer.set_initial(state, prob.mask)
    if kept is None:
        loop = _solve_fused if rt.fused_outer_loop else _solve_stepwise
        final, metrics = loop(state, prob, sf, cfg, rt, block, verbose,
                              viewer, check)
    else:
        # Rebound: prepare's own tensors go, but for what a caller keeps.
        state = kept.load(state)
        final, metrics = _solve_fused(state, prob, sf, cfg, rt, block,
                                      verbose, viewer, check,
                                      graphs=kept.glue)
        kept.prob, kept.state = prob, final
        final = srps.snapshot(final)
    _write_outputs(final, prob.mask, rt, metrics)
    if viewer is not None:
        viewer.finish()
    return final, metrics


def _solve_fused(state, prob, sf, cfg, rt, block, verbose, viewer, check,
                 graphs=None):
    # A viewer that has disabled itself keeps no iterates (the JAX package
    # takes its trace-carrying solve for any viewer, runtime/solver.py:209).
    keep_states = (rt.dump_iterations or rt.save_visualizations
                   or (viewer is not None and viewer.enabled))
    records, states = [], []

    def record(st):
        # Device tensors only: nothing here waits for the device.
        records.append((st.iteration, st.energy, st.cg_iters))
        if keep_states:
            states.append(srps.snapshot(st))

    t = Timer(prob.mask.device).start()
    final, _ = srps.solve_fused(state, prob, sf, cfg, block,
                                on_iteration=record, check=check,
                                graphs=graphs)
    with tracing.span("srps.results"):
        dt = t.end()
        metrics = [{"iteration": k, "energy": tracing.read(float, e),
                    "cg_iterations": tracing.read(int, c)}
                   for k, e, c in records]
        n_it = final.iteration
        metrics.append({"total_seconds": dt, "iterations": n_it})
        if verbose:
            print(f"fused solve: {n_it} iterations in {dt:.3f}s, final "
                  f"energy {tracing.read(float, final.energy):.3f}")
    for st in states:
        _iteration_outputs(st, prob, rt, viewer)
    return final, metrics


def _iteration_outputs(st, prob, rt: RuntimeConfig, viewer):
    """The per-iteration dump, checkpoint, PNGs and live windows."""
    if rt.dump_iterations:
        # Untagged names each iteration (the reference overwrites) and a
        # resumable checkpoint.
        writers.dump_state(rt.dump_dir, st, prob.mask, fmt=rt.dump_format)
        writers.save_checkpoint(os.path.join(rt.dump_dir, "checkpoint.npz"),
                                st, st.iteration)
    if rt.save_visualizations:
        writers.save_visualizations(rt.dump_dir, st, prob.mask,
                                    tag=f"_{st.iteration:02d}")
    if viewer is not None:
        viewer.show(st, prob.mask)


def _solve_stepwise(state, prob, sf, cfg, rt, block, verbose, viewer,
                    check):
    dev = prob.mask.device
    metrics = []
    last_error = (tracing.read(float, state.energy) if rt.resume_from
                  else float("nan"))
    iteration = state.iteration + 1
    while True:
        # Per-phase timing with the reference's print format
        # (SRPS.cu:277-295); the normals after the summary are untimed.
        with tracing.span("srps.iteration"):
            with tracing.span("srps.lighting"):
                t = Timer(dev).start()
                s = srps.estimate_lighting(prob, state.rho, state.N, state.s)
                t_light = t.end()
                if check:
                    check("lighting", s)
            if verbose:
                print(f"\n{'Lightning Estimation':<25}: {t_light:<6.6f}s")
            with tracing.span("srps.albedo"):
                t = Timer(dev).start()
                mom = srps.s_moments(prob, s)
                rho = srps.estimate_albedo(prob, mom, state.N, state.rho)
                t_albedo = t.end()
                if check:
                    check("s-moments and albedo", mom.G, mom.J, rho)
            if verbose:
                print(f"{'Albedo Estimation':<25}: {t_albedo:<6.6f}s")
            t = Timer(dev).start()
            z, energy, cg_iters = srps.estimate_depth(
                prob, mom, rho, state.dz, state.z, sf, cfg, block)
            t_depth = t.end()
            if check:
                check("depth", z, energy)
            if verbose:
                print(f"{'Depth Estimation':<25}: {t_depth:<6.6f}s")

            with tracing.span("srps.stop"):
                error = tracing.read(float, energy)
                cg = tracing.read(int, cg_iters)
            rel_err = abs(last_error - error) / abs(error)
            metrics.append({
                "iteration": iteration,
                "energy": error,
                "relative_error": rel_err,
                "cg_iterations": cg,
                "lighting_seconds": t_light,
                "albedo_seconds": t_albedo,
                "depth_seconds": t_depth,
                "seconds": t_light + t_albedo + t_depth,
            })
            if verbose:
                print(f"\nIteration {iteration:02d} summary")
                print(f"{'Error':<25}: {error:<6.3f}")
                print(f"{'Relative Error':<25}: {rel_err:<6.3f}")

            with tracing.span("srps.normals"):
                N, dz = srps.depth_normals(z, prob)
                if check:
                    check("normals", N, dz)
        state = srps.SRPSState(
            z=z, rho=rho, s=s, N=N, dz=dz, energy=energy,
            last_energy=state.energy, iteration=state.iteration + 1,
            cg_iters=cg_iters)
        _iteration_outputs(state, prob, rt, viewer)
        # The reference's stopping rule (SRPS.cu:297-301).
        stop = (error > last_error) or (rel_err < cfg.tolerance) or (
            iteration > cfg.max_iterations)
        last_error = error
        iteration += 1
        if stop:
            return state, metrics


def _write_outputs(state, mask, rt: RuntimeConfig, metrics):
    if rt.metrics_jsonl:
        parent = os.path.dirname(rt.metrics_jsonl)
        if parent:
            os.makedirs(parent, exist_ok=True)
        with open(rt.metrics_jsonl, "w") as f:
            for rec in metrics:
                f.write(json.dumps(rec) + "\n")
    if rt.dump_iterations:
        writers.dump_state(rt.dump_dir, state, mask, fmt=rt.dump_format,
                           tag="_final")
    if rt.save_visualizations:
        writers.save_visualizations(rt.dump_dir, state, mask, tag="_final")
