"""Command-line interface of the PyTorch port, on the reference binary's
surface (Main.cpp:9-44):

  --dstype {matlab,images}   dataset type (default: matlab)
  --dsloc PATH[,PATH...]     .mat file or image folder; several, separated
                             by commas, run a multi-object solve
  --device N                 CUDA device ordinal
  --blockx N / --blocky N    thread-block shape of the stencil CG kernels
                             (Preferences 256 x 4, at most 1024 threads)

plus the solver constants, ``--fast``, ``--fused``/``--stepwise``,
``--cg-variant``, ``--image-dtype``, ``--batch-mode``, ``--serve``,
``--sharded``, dumps, ``--dump-operators``, ``--viz``, ``--show``,
``--metrics-jsonl``, ``--resume-from``, ``--nan-check`` and
``--profile-dir``: every option of the JAX CLI but ``--pallas`` /
``--no-pallas`` (on a CUDA device the kernels always run). Without
``--cpu`` a CUDA device is required; ``--cpu`` runs the plain PyTorch
versions of the kernels on the CPU.

Each path honours the options the JAX CLI's does: the single solve all;
a multi-object solve (comma ``--dsloc``) the solver options, dumps,
``--viz``, ``--metrics-jsonl`` and ``--profile-dir``; ``--sharded`` the
solver options, dumps, ``--viz`` and ``--metrics-jsonl``; ``--serve`` the
solver options and ``--batch-mode``. Elsewhere an option has no effect.
"""

from __future__ import annotations

import argparse
import sys

from .config import Preferences, RuntimeConfig, SolverConfig

PROG = "srmeetsps-torch"


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog=PROG,
        description="Depth Super-Resolution Meets Uncalibrated Photometric "
        "Stereo — PyTorch + CUDA solver")
    p.add_argument("--dstype", "-t", choices=["matlab", "images"],
                   default="matlab")
    p.add_argument("--dsloc", "-d", help="path to dataset mat file or image "
                   "folder; a comma-separated list runs a multi-object "
                   "solve (see --batch-mode)")
    p.add_argument("--device", "-g", type=int, default=0,
                   help="CUDA device ordinal")
    p.add_argument("--blockx", "-x", type=int, default=Preferences.block_x,
                   help="thread-block x size of the stencil CG kernels")
    p.add_argument("--blocky", "-y", type=int, default=Preferences.block_y,
                   help="thread-block y size of the stencil CG kernels")
    p.add_argument("--cpu", action="store_true",
                   help="run on the CPU with the kernels' plain PyTorch "
                        "versions (without it a CUDA device is required)")
    p.add_argument("--tolerance", type=float, default=5e-3)
    p.add_argument("--max-iterations", type=int, default=10)
    p.add_argument("--cg-tol", type=float, default=1e-9)
    p.add_argument("--cg-max-iter", type=int, default=100)
    p.add_argument("--lambda", dest="lam", type=float, default=1.0)
    p.add_argument("--jacobi", action="store_true",
                   help="Jacobi-preconditioned depth CG, faster: plain CG "
                        "on the diagonally scaled system at sf <= 2, "
                        "in-sweep PCG at sf = 4, through the stencil CG "
                        "kernel; with --cg-variant cgs the same kernel runs "
                        "(CGS has no Jacobi form) and the energy is "
                        "evaluated at its result")
    p.add_argument("--fast", action="store_true",
                   help="fast preset: plain CG at cap 40 (the reference's "
                        "recurrence, a lower cap); an explicit "
                        "--cg-max-iter overrides it")
    p.add_argument("--fused", action="store_true", default=None,
                   help="no per-phase synchronisation (default on CUDA)")
    p.add_argument("--stepwise", dest="fused", action="store_false",
                   help="per-phase timings with one synchronise per phase "
                        "(default on the CPU)")
    p.add_argument("--dump", action="store_true",
                   help="dump s/rho/z/N each iteration (reference behaviour)")
    p.add_argument("--dump-dir", default=".")
    p.add_argument("--dump-format", choices=["mat", "mat5", "npz"],
                   default="mat",
                   help="mat = MAT 7.3 (needs h5py); mat5 = scipy v5")
    p.add_argument("--viz", action="store_true",
                   help="save PNG visualizations (needs Pillow)")
    p.add_argument("--metrics-jsonl", default=None)
    p.add_argument("--resume-from", default=None)
    p.add_argument("--batch-mode", choices=["auto", "stream", "lockstep"],
                   default="auto",
                   help="multi-object (comma --dsloc) form: stream = each "
                        "object through the single solve in turn (bit for "
                        "bit its solo solve); lockstep = all objects' depth "
                        "CGs in one lane-batched kernel launch per outer "
                        "iteration; auto = stream on one device")
    p.add_argument("--cg-variant", choices=["pipe", "cgs"], default="pipe",
                   help="depth CG: pipe = standard CG (default); cgs = "
                        "Chronopoulos-Gear CG, one sweep and one reduction "
                        "per iteration (reorders rounding)")
    p.add_argument("--serve", action="store_true",
                   help="serving loop: one dataset location per stdin line "
                        "(a comma-separated line is a multi-object solve), "
                        "one JSON result line each; 'quit' or EOF stops")
    p.add_argument("--sharded", type=int, default=0, metavar="N",
                   help="row-sharded solve: the problem in N row bands, "
                        "one per device (at most the CUDA devices present; "
                        "with --cpu, N CPU shards); "
                        "the image height and its LR height must divide "
                        "by N")
    p.add_argument("--show", action="store_true",
                   help="live preview windows per outer iteration (the "
                        "reference's cv::imshow: Normals-Initial, Normals-"
                        "Current-Iteration, Albedo); needs a GUI cv2 and a "
                        "display, else it disables itself with a warning")
    p.add_argument("--dump-operators", action="store_true",
                   help="dump D/Dx/Dy/KT as ii/jj/kk triplet MAT files into "
                        "--dump-dir (MAT v5 with --dump-format mat5, else "
                        "MAT 7.3)")
    p.add_argument("--image-dtype", choices=["float32", "bfloat16"],
                   default="float32",
                   help="image stack dtype; bfloat16 halves the bytes of "
                        "the per-iteration passes over the images, which "
                        "still accumulate in float32")
    p.add_argument("--nan-check", action="store_true",
                   help="check after each phase of every outer iteration "
                        "that its output is finite; raise FloatingPointError "
                        "naming the first phase that is not")
    p.add_argument("--profile-dir", default=None,
                   help="write a torch.profiler trace of the solve (CUDA "
                        "kernels included on the card) into this directory")
    return p


def _loader(dstype: str):
    if dstype == "matlab":
        from .io.mat_loader import load_mat_dataset

        return load_mat_dataset
    from .io.image_loader import load_image_dataset

    return load_image_dataset


def main(argv=None) -> int:
    parser = build_parser()
    args = parser.parse_args(argv)
    if not args.dsloc and not args.serve:
        parser.print_help()
        return 0
    if not (args.blockx > 0 and args.blocky > 0
            and args.blockx * args.blocky <= 1024):
        raise SystemExit(f"{PROG}: --blockx x --blocky must be 1..1024 "
                         f"threads, got {args.blockx} x {args.blocky}")

    from .device import resolve_device

    try:
        device = resolve_device(cpu=args.cpu, ordinal=args.device)
    except RuntimeError as e:
        raise SystemExit(f"{PROG}: {e}") from e
    if args.fused is None:
        args.fused = device.type == "cuda"
    if args.fast and args.cg_max_iter == 100:
        args.cg_max_iter = 40

    cfg = SolverConfig(
        tolerance=args.tolerance,
        max_iterations=args.max_iterations,
        cg_tol=args.cg_tol,
        cg_max_iter=args.cg_max_iter,
        lam=args.lam,
        jacobi_preconditioner=args.jacobi,
        cg_variant=args.cg_variant,
        image_dtype=args.image_dtype,
    )
    rt = RuntimeConfig(
        dump_iterations=args.dump,
        dump_dir=args.dump_dir,
        dump_format=args.dump_format,
        save_visualizations=args.viz,
        live_view=args.show,
        metrics_jsonl=args.metrics_jsonl,
        resume_from=args.resume_from,
        dump_operators=args.dump_operators,
        nan_check=args.nan_check,
        profile_dir=args.profile_dir,
        fused_outer_loop=args.fused,
        batch_mode=args.batch_mode,
    )
    prefs = Preferences(block_x=args.blockx, block_y=args.blocky)
    load = _loader(args.dstype)
    if args.serve:
        return _run_serve(load, cfg, rt, device, prefs)

    locs = [s for s in args.dsloc.split(",") if s]
    datas = [load(loc) for loc in locs]
    if len(datas) > 1:
        _run_batched(datas, locs, cfg, rt, device, prefs)
    elif args.sharded:
        _run_sharded(datas[0], cfg, args.sharded, rt, device, prefs)
    else:
        from .runtime.solver import solve

        solve(datas[0], cfg, rt, device=device, prefs=prefs, verbose=True)
    print("Done!")
    return 0


def _common_grid(datas, sf: int):
    """``None`` when every object has the same grid, else the smallest
    multiple of sf that holds them all, to zero-pad every lane to."""
    shapes = {tuple(d.mask.shape) for d in datas}
    if len(shapes) == 1:
        return None
    H = max(h for h, _ in shapes)
    W = max(w for _, w in shapes)
    return H + (-H) % sf, W + (-W) % sf


def _solve_lanes(datas, cfg, device, mode, block, profile_dir=None):
    """The multi-object solve of ``datas`` in ``mode``, timed from the
    first launch to the device's end, under a profiler trace into
    ``profile_dir`` if one is given: ``(probs, finals, traces, seconds,
    pad_to)``."""
    from .parallel import batched
    from .runtime.solver import Timer, prepare, profiling

    sf = int(datas[0].sf)
    pad_to = _common_grid(datas, sf)
    pairs = [prepare(d, cfg, device, pad_to=pad_to) for d in datas]
    probs = [p for p, _ in pairs]
    with profiling(profile_dir, device):
        t = Timer(device).start()
        finals, traces = batched.solve_batch([s for _, s in pairs], probs,
                                             sf, cfg, mode=mode, block=block)
        dt = t.end()
    return probs, finals, traces, dt, pad_to


def _trace_iterations(trace) -> int:
    """Outer iterations of a lane: the finite entries of its trace."""
    import torch

    return int(torch.isfinite(trace).sum())


def _run_serve(load_fn, cfg, rt, device, prefs) -> int:
    """Serving loop (JAX cli.py:222-290): one dataset location per stdin
    line, one JSON line per request. A comma-separated line runs a
    multi-object solve in ``rt.batch_mode`` (mixed grids are zero-padded
    to a common one). A bad request answers with an ``error`` line and
    the loop goes on; 'quit', 'exit' or EOF stops. The header's
    ``pallas`` is true exactly when the hand-written kernels run (CUDA)."""
    import json
    import time

    from .config import RuntimeConfig
    from .runtime.solver import solve

    block = (prefs.block_x, prefs.block_y)
    print(json.dumps({"serving": True, "pallas": device.type == "cuda"}),
          flush=True)
    for line in sys.stdin:
        req = line.strip()
        if not req:
            continue
        if req in ("quit", "exit"):
            break
        try:
            t0 = time.perf_counter()
            datas = [load_fn(loc) for loc in req.split(",") if loc]
            if len(datas) == 1:
                # The CLI's single solve, fused, with no outputs written.
                final, metrics = solve(
                    datas[0], cfg, RuntimeConfig(fused_outer_loop=True),
                    device=device, prefs=prefs, verbose=False)
                dt_solve = metrics[-1]["total_seconds"]
                out = {"dsloc": req, "iterations": int(final.iteration),
                       "final_energy": float(final.energy)}
            else:
                _, finals, traces, dt_solve, _ = _solve_lanes(
                    datas, cfg, device, rt.batch_mode, block)
                out = {"dsloc": req, "batch": len(datas),
                       "iterations": [_trace_iterations(tr) for tr in traces],
                       "final_energy": [float(f.energy) for f in finals]}
            out["solve_seconds"] = round(dt_solve, 4)
            out["total_seconds"] = round(time.perf_counter() - t0, 4)
            print(json.dumps(out), flush=True)
        except Exception as e:  # keep serving on bad requests
            print(json.dumps({"dsloc": req, "error": str(e)[:300]}),
                  flush=True)
    return 0


def _run_batched(datas, locs, cfg, rt, device, prefs):
    """Multi-object solve of the comma-separated --dsloc entries (JAX
    cli.py:293-398): outputs land in per-object subdirectories named by
    the dataset, with the lane index added where two names collide."""
    import json
    import os

    from .io import writers
    from .parallel import batched

    sfs = {int(d.sf) for d in datas}
    stacks = {tuple(d.I.shape[:2]) for d in datas}  # (n images, c channels)
    if len(sfs) != 1 or len(stacks) != 1:
        raise SystemExit(
            f"{PROG}: a multi-object solve needs matching sf and image "
            f"counts: sf={sorted(sfs)}, (n,c)={sorted(stacks)}")
    if rt.resume_from:
        raise SystemExit(f"{PROG}: --resume-from is not supported in a "
                         "multi-object (comma --dsloc) solve; run the objects "
                         "separately")
    shapes = [tuple(d.mask.shape) for d in datas]
    mode = batched.resolve_batch_mode(rt.batch_mode)
    probs, finals, traces, dt, pad_to = _solve_lanes(
        datas, cfg, device, mode, (prefs.block_x, prefs.block_y),
        rt.profile_dir)
    if pad_to is not None:
        print(f"mixed geometry {sorted(set(shapes))}: padding all lanes to "
              f"{pad_to}")
    names = [os.path.basename(os.path.normpath(loc)) or f"obj{b}"
             for b, loc in enumerate(locs)]
    names = [n if names.count(n) == 1 else f"{n}_{b}"
             for b, n in enumerate(names)]
    metrics = []
    for b, name in enumerate(names):
        trace = traces[b].tolist()
        n_it = _trace_iterations(traces[b])
        final_energy = float(finals[b].energy)
        print(f"[{name}] {n_it} iterations, final energy {final_energy:.3f}")
        metrics += [{"object": name, "iteration": i + 1, "energy": trace[i]}
                    for i in range(n_it)]
        metrics.append({"object": name, "iterations": n_it,
                        "final_energy": final_energy})
        if rt.dump_iterations or rt.save_visualizations:
            sub = os.path.join(rt.dump_dir, name)
            st, mask = finals[b], probs[b].mask
            if pad_to is not None:
                # Crop the grids back to the object's own extent.
                h0, w0 = shapes[b]
                st = st._replace(z=st.z[..., :h0, :w0],
                                 rho=st.rho[..., :h0, :w0],
                                 N=st.N[..., :h0, :w0],
                                 dz=st.dz[..., :h0, :w0])
                mask = mask[:h0, :w0]
            if rt.dump_iterations:
                writers.dump_state(sub, st, mask, fmt=rt.dump_format,
                                   tag="_final")
            if rt.save_visualizations:
                writers.save_visualizations(sub, st, mask, tag="_final")
    metrics.append({"batch": len(datas), "mode": mode, "solve_seconds": dt})
    print(f"{mode} solve of {len(datas)} objects in {dt:.3f}s "
          f"({len(datas) / dt:.2f} solves/s)")
    if rt.metrics_jsonl:
        parent = os.path.dirname(rt.metrics_jsonl)
        if parent:
            os.makedirs(parent, exist_ok=True)
        with open(rt.metrics_jsonl, "w") as f:
            for rec in metrics:
                f.write(json.dumps(rec) + "\n")


def _run_sharded(data, cfg, n_devices: int, rt, device, prefs):
    """The fused solve on a row mesh (JAX cli.py:401-445): N = min(N, CUDA
    devices) distinct cards, or N CPU shards with --cpu. The problem and
    the state are placed in row bands, each on its shard's device, and
    every phase runs on the bands (``parallel/sharded.py``); the final
    state is gathered onto the first device for the outputs."""
    import torch

    from .parallel.sharded import (gather, gather_field, make_mesh_1d,
                                   shard_problem_rows, shard_state_rows,
                                   solve_fused_sharded)
    from .runtime.solver import Timer, _write_outputs, prepare

    if device.type == "cuda":
        n_devices = min(n_devices, torch.cuda.device_count())
        devices = [torch.device("cuda", i) for i in range(n_devices)]
    else:
        devices = [device] * n_devices
    mesh = make_mesh_1d(n_devices, devices)
    prob, state = prepare(data, cfg, devices[0])
    h = prob.mask.shape[0]
    sf = int(data.sf)
    if h % n_devices or (h // sf) % n_devices:
        raise SystemExit(
            f"--sharded: image height {h} and LR height {h // sf} must "
            f"both be divisible by {n_devices}")
    prob = shard_problem_rows(prob, mesh)
    state = shard_state_rows(state, mesh)
    t = Timer(devices[0]).start()
    final, trace = solve_fused_sharded(state, prob, sf, cfg, mesh,
                                       (prefs.block_x, prefs.block_y))
    dt = t.end()
    final = gather(final)
    trace = trace.tolist()
    n_it = final.iteration
    metrics = []
    for i in range(n_it):
        print(f"Iteration {i + 1:02d}  Error: {trace[i]:.3f}")
        metrics.append({"iteration": i + 1, "energy": trace[i]})
    metrics.append({"total_seconds": dt, "iterations": n_it,
                    "devices": n_devices})
    print(f"sharded solve ({n_devices} devices): {n_it} iterations "
          f"in {dt:.3f}s, final energy {float(final.energy):.3f}")
    _write_outputs(final, gather_field(prob, "mask"), rt, metrics)


if __name__ == "__main__":
    sys.exit(main())
