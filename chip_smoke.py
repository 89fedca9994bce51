#!/usr/bin/env python3
"""Smoke test of the PyTorch + CUDA port on one CUDA card.

    python3 chip_smoke.py

Phases (any failed check raises and the script exits non-zero; nothing
falls back to the CPU or to a plain version):

1. environment: the card's name and power limit, torch and CUDA versions;
2. build: the CUDA kernels from ``srmeetsps_cuda_tpu_torch/csrc``;
3. each kernel against its plain PyTorch version on the card, on depth
   operators built by the port from a seeded Lambertian dataset: the C
   planes, iteration counts, x after 2 and 12 iterations and the tracked
   energy, with the tolerances of tests/test_torch_stencil_cg.py, and the
   time per CG iteration of both;
4. the main path through the CLI entry point on a 960 x 1280, n = 20, c = 3,
   sf = 2 dataset written as a MAT v5 file: finite energies, the reference's
   stopping rule, a finite depth, every depth CG through the kernel; and the
   whole solve on a small input against the same solve on the CPU.

The line before the last is a JSON object with one entry per kernel; the
last line is ``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

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
            entry = {"name": "stencil_cg", "route": "cuda",
                     "source": "srmeetsps_cuda_tpu_torch/csrc/stencil_cg.cu",
                     "replaces": "srmeetsps_cuda_tpu/solve/pallas_cg_vmem.py:403",
                     "max_abs_err": errs[2], "ms": ms_k, "plain_ms": ms_p}
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


def main_path(label, h=960, w=1280, n=20, cli_extra=()):
    """Phase 4 through ``cli.main``. Returns the kernel launches counted."""
    import numpy as np

    from srmeetsps_cuda_tpu_torch import cli
    from srmeetsps_cuda_tpu_torch.io.mat_loader import save_mat_dataset
    from srmeetsps_cuda_tpu_torch.io.synthetic import lambertian_dataset
    from srmeetsps_cuda_tpu_torch.ops.grid import masked_scatter_colmajor
    from srmeetsps_cuda_tpu_torch.solve import stencil_cg as sc

    sf, c = 2, 3
    data, z_true = lambertian_dataset(h, w, sf, n, c, seed=0)
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, f"synthetic_{h}x{w}_sf{sf}.mat")
        save_mat_dataset(path, data, fmt="mat5")
        metrics_path = os.path.join(tmp, "metrics.jsonl")
        sc.stencil_cg.launches = 0
        t0 = time.perf_counter()
        rc = cli.main(["--dstype", "matlab", "--dsloc", path, "--dump",
                       "--dump-format", "npz", "--dump-dir", tmp,
                       "--metrics-jsonl", metrics_path, *cli_extra])
        wall = time.perf_counter() - t0
        launches = sc.stencil_cg.launches
        if rc != 0:
            raise AssertionError(f"cli.main returned {rc}")
        with open(metrics_path) as f:
            recs = [json.loads(line) for line in f]
        final = np.load(os.path.join(tmp, "state_final.npz"))
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
    if launches != n_it:
        raise AssertionError(f"{launches} stencil CG kernel runs for {n_it} "
                             "outer iterations")
    if any(r["cg_iterations"] != 101 for r in iters):
        raise AssertionError(f"CG iterations not at the cap: {iters}")
    rmse = float(np.sqrt(np.mean((z[m] - z_true[m]) ** 2)))
    dt = summary["total_seconds"]
    print(f"[{label}] main path {h}x{w} n={n} sf={sf}: {n_it} outer iterations, "
          f"final energy {energies[-1]:.4f}, solve {dt:.4f} s "
          f"({1e3 * dt / n_it:.3f} ms/outer-iter), CLI wall {wall:.3f} s, "
          f"stencil_cg launches {launches}, depth RMSE vs truth {rmse:.4f}",
          flush=True)
    print(f"[{label}] energy trace {energies}", flush=True)
    return launches


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
    fresh = not native.library_path("stencil_cg").exists()
    native.load("stencil_cg")
    print(f"[{label}] build stencil_cg.cu: {time.perf_counter() - t0:.3f} s "
          f"({'compiled' if fresh else 'already built'})", flush=True)

    entry = kernel_vs_plain(label, [(960, 1280, 2), (240, 320, 1),
                                    (480, 640, 4)])
    entry["launches"] = main_path(label)
    small_input_vs_cpu(label)

    print(json.dumps({"kernels": [entry]}))
    print(label)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
