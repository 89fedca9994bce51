"""Command-line interface of the PyTorch port, on the reference binary's
surface (Main.cpp:9-44):

  --dstype {matlab,images}   dataset type (default: matlab)
  --dsloc PATH               .mat file or image folder
  --device N                 CUDA device ordinal
  --blockx N / --blocky N    thread-block shape of the stencil CG kernels
                             (Preferences 256 x 4, at most 1024 threads)

plus the solver constants, ``--fast``, ``--fused``/``--stepwise``, dumps,
``--viz``, ``--metrics-jsonl`` and ``--resume-from``. Without ``--cpu`` a
CUDA device is required; ``--cpu`` runs the plain PyTorch versions of the
kernels on the CPU. Options of the JAX CLI that are not ported yet exit
with a message that names ROADMAP.md.
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
                   "folder")
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
                   help="Jacobi-preconditioned depth CG (CPU only so far)")
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
    # Surface of the JAX CLI that the port does not implement yet.
    p.add_argument("--show", action="store_true", help="not yet ported")
    p.add_argument("--dump-operators", action="store_true",
                   help="not yet ported")
    p.add_argument("--sharded", type=int, default=0, metavar="N",
                   help="not yet ported")
    p.add_argument("--serve", action="store_true", help="not yet ported")
    p.add_argument("--image-dtype", choices=["float32", "bfloat16"],
                   default="float32", help="bfloat16 is not yet ported")
    p.add_argument("--cg-variant", choices=["pipe", "cgs"], default="pipe",
                   help="cgs is not yet ported")
    return p


def _not_ported(what: str) -> SystemExit:
    return SystemExit(f"{PROG}: {what} is not yet ported to the PyTorch "
                      "package; see ROADMAP.md")


def main(argv=None) -> int:
    parser = build_parser()
    args = parser.parse_args(argv)
    if not args.dsloc and not args.serve:
        parser.print_help()
        return 0
    unported = [
        ("a comma-separated --dsloc (batched solve)",
         args.dsloc and "," in args.dsloc),
        ("--sharded", args.sharded),
        ("--serve", args.serve),
        ("--show", args.show),
        ("--dump-operators", args.dump_operators),
        ("--image-dtype bfloat16", args.image_dtype != "float32"),
        ("--cg-variant cgs", args.cg_variant != "pipe"),
        ("--jacobi on CUDA", args.jacobi and not args.cpu),
    ]
    for what, asked in unported:
        if asked:
            raise _not_ported(what)
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

    if args.dstype == "matlab":
        from .io.mat_loader import load_mat_dataset as load
    else:
        from .io.image_loader import load_image_dataset as load
    data = load(args.dsloc)

    cfg = SolverConfig(
        tolerance=args.tolerance,
        max_iterations=args.max_iterations,
        cg_tol=args.cg_tol,
        cg_max_iter=args.cg_max_iter,
        lam=args.lam,
        jacobi_preconditioner=args.jacobi,
        cg_variant=args.cg_variant,
    )
    rt = RuntimeConfig(
        dump_iterations=args.dump,
        dump_dir=args.dump_dir,
        dump_format=args.dump_format,
        save_visualizations=args.viz,
        metrics_jsonl=args.metrics_jsonl,
        resume_from=args.resume_from,
        fused_outer_loop=args.fused,
    )
    prefs = Preferences(block_x=args.blockx, block_y=args.blocky)
    from .runtime.solver import solve

    solve(data, cfg, rt, device=device, prefs=prefs, verbose=True)
    print("Done!")
    return 0


if __name__ == "__main__":
    sys.exit(main())
