"""Run one cell of the benchmark of the PyTorch and CUDA port once.

    python3 -m bench_torch.run --workload <config>.<mix> --seed <n> \
        --seconds <s> --trace <0|1>

from the root of a checkout. The cell is an entry of ``workloads`` in
``BENCHMARK.json``; its configuration is ``bench_torch/configs/<config>.json``
(the deployment: grid, images, scale factor, camera, the solver's
constants, the pool of captures and the limits of the check), its traffic
``bench_torch/traffic/<mix>.json`` (read by ``drive.py``), and each
per-layer metric ``bench_torch/metrics/<metric>.py`` (a ``read(ctx)``
that returns a number, or None where it finds nothing to read).

Set-up builds the kernels (or finds them in the package's ``_build/``),
draws the pool of captures on the card from the seed, moves it to host
memory and solves one request of every shape the traffic sends. With
``--trace 0`` it then runs the traffic for ``--seconds`` and reports the
cell's end-to-end metrics; with ``--trace 1`` it runs one round of four
captures twice, first with spans around the port's layers synchronised
at both ends, then under ``torch.profiler`` with unsynchronised ranges
(the device runs as untraced), and reports the per-layer metrics. Either
way the answers are then held against the plain reference
(``check.py``). The last line of standard output is one JSON object; the
numbers compared, each beside its limit, end standard error.

With no CUDA card, or fewer than the cell asks for, it exits 2 and
prints no result; where the process holds JAX or the JAX package once the
run is over, it exits 1, names them on standard error and prints no
result.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import gc  # noqa: E402
import importlib.util  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import statistics  # noqa: E402
import sys  # noqa: E402
import tempfile  # noqa: E402
import traceback  # noqa: E402
from pathlib import Path  # noqa: E402
from types import SimpleNamespace  # noqa: E402

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
TRACE_CAPTURES = 4  # captures of each traced pass (one batch at batch 4)
# Top-level modules that the port must not load: JAX and the JAX package.
FORBIDDEN = {"jax", "jaxlib", "flax", "srmeetsps_cuda_tpu"}


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def find_cell(bench: dict, name: str) -> dict:
    for cell in bench["workloads"]:
        if cell["name"] == name:
            return cell
    raise SystemExit(f"unknown workload {name!r}")


def cell_metrics(bench: dict, cell: str, group: str) -> list:
    """The metrics of ``group`` (``end_to_end`` or ``per_layer``) that the
    cell reports: those that list it, or list no cells."""
    return [m for m in bench[group] if cell in m.get("workloads", [cell])]


def metric_reader(name: str):
    spec = importlib.util.spec_from_file_location(
        f"bench_torch.metrics.{name}", HERE / "metrics" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def solver_config(conf: dict):
    from srmeetsps_cuda_tpu_torch.config import SolverConfig

    return SolverConfig(**conf["solver"])


# -- end-to-end metrics (taken by the benchmark from the host's clock) -------


def window_seconds(records) -> float:
    return records[-1].end - records[0].start


def captures_per_s(records) -> float:
    return sum(len(r.items) for r in records) / window_seconds(records)


def capture_p90_ms(records) -> float:
    lat = [1e3 * (r.end - r.start) for r in records for _ in r.items]
    if len(lat) == 1:
        return lat[0]
    return statistics.quantiles(lat, n=10, method="inclusive")[-1]


def outer_iter_ms(records) -> float:
    iters = sum(sum(r.iterations) for r in records)
    return 1e3 * window_seconds(records) / iters


END_TO_END = {"captures_per_s": captures_per_s,
              "capture_p90_ms": capture_p90_ms,
              "outer_iter_ms": outer_iter_ms}


# -- the run -----------------------------------------------------------------


def run_cell(bench: dict, cell: dict, seed: int, seconds: float, trace: bool,
             device, conf: dict = None, mix: dict = None, log=None) -> dict:
    """One run of ``cell`` on ``device``; returns the result line's object.
    ``conf`` and ``mix`` replace the configuration's and the traffic's
    files (smaller grids, for a rehearsal on the CPU)."""
    import torch

    from srmeetsps_cuda_tpu_torch.device import set_precision

    from . import check
    from . import data as bdata
    from .drive import Client
    from .reference import Reference
    from .trace import Tracer

    log = log or (lambda msg: print(
        f"[{time.perf_counter() - T_START:8.2f}s] {msg}", file=sys.stderr,
        flush=True))
    conf = conf or load_json(HERE / "configs" / f"{cell['config']}.json")
    mix = mix or load_json(HERE / "traffic" / f"{cell['traffic']}.json")
    cuda = device.type == "cuda"
    set_precision()

    def sync():
        if cuda:
            torch.cuda.synchronize(device)

    def peak_bytes():
        return torch.cuda.max_memory_allocated(device) if cuda else 0

    # Set-up: kernels, the pool, one request of every shape.
    if cuda:
        from srmeetsps_cuda_tpu_torch import native

        native.build_all(conf["kernels"])
    h, w = conf["grid"]
    pool = bdata.make_pool(conf["content_seed"], conf["pool"], h, w,
                           conf["sf"], conf["n"], conf["c"], conf["fx"],
                           conf["fy"], device)
    client = Client(mix, pool, solver_config(conf), device, seed,
                    content_seed=conf["content_seed"])
    decoder = None
    if client.folders is not None:
        f = client.folders
        decoder = f.decoder
        log(f"wrote {f.files} PNG files, {f.png_bytes} bytes "
            f"({f.png_bytes / len(pool):.0f} a capture) in {f.write_s:.3f} s; "
            f"decoder {f.decoder} (its build {f.build_s:.3f} s)")
    solver_mod, orig_prepare = client.probe_prepare()
    try:
        rounds = -(-len({tuple(c.mask.shape) for c in client.captures})
                   // client.batch)
        client.run(requests=rounds)
        client.kept.clear()
        client.seen.clear()
        client.order.clear()
        sync()
        setup_peak = peak_bytes()
        if cuda:
            torch.cuda.reset_peak_memory_stats(device)
        setup_s = time.perf_counter() - T_START
        log(f"set-up {setup_s:.3f} s; pool of {len(pool)} at {h}x{w}")

        out_metrics, dev_extra, breakdown = {}, {}, None
        if not trace:
            records = client.run(seconds=seconds)
            sync()
            peak = peak_bytes()
            lat = sorted(1e3 * (r.end - r.start) for r in records)
            log(f"window: {len(records)} requests, latency ms min "
                f"{lat[0]:.1f} median {lat[len(lat) // 2]:.1f} max "
                f"{lat[-1]:.1f}; outer iterations "
                f"{[r.iterations for r in records]}")
            for m in cell_metrics(bench, cell["name"], "end_to_end"):
                name = m["name"]
                if name == "setup_s":
                    val = setup_s
                elif name == "peak_mem_gib":
                    val = peak / 2 ** 30
                else:
                    val = END_TO_END[name](records)
                out_metrics[name] = {"value": val, "unit": m["unit"]}
            attempted = sum(len(r.items) for r in records)
        else:
            n_req = max(1, TRACE_CAPTURES // client.batch)
            client.rng.seed(seed)
            spans = Tracer(device)
            client.tracer = spans
            with spans.installed():
                records = client.run(requests=n_req)
            log(f"spans pass: outer iterations {[r.iterations for r in records]}")
            client.order.clear()
            client.rng.seed(seed)
            prof_tr = Tracer(device, sync=False)
            client.tracer = prof_tr
            timeline, window = _profiled(client, prof_tr, n_req, device)
            client.tracer = None
            log(f"profiled pass: {len(timeline.device)} device and "
                f"{len(timeline.host)} host events, "
                f"{timeline.unlaunched} device events with no launch found; "
                f"captures {[r.items for r in records]}; kernels launched "
                "in each iteration range "
                f"{[len(timeline.kernels_in(*r)) for r in timeline.ranges('iteration')]}"
                ", in each depth_cg range "
                f"{[len(timeline.kernels_in(*r)) for r in timeline.ranges('depth_cg')]}")
            sync()
            peak = peak_bytes()
            for span in prof_tr.spans:
                if "iters" in span.info:
                    span.info["iters"] = span.info["iters"].reshape(-1).tolist()
            ctx = SimpleNamespace(spans=spans, prof=prof_tr, timeline=timeline,
                                  window=window, records=records, cell=cell,
                                  mix=mix, conf=conf)
            for m in cell_metrics(bench, cell["name"], "per_layer"):
                val = metric_reader(m["name"])(ctx)
                if val is not None:
                    out_metrics[m["name"]] = {"value": val, "unit": m["unit"]}
            busy = timeline.busy(*window)
            dev_extra = {"busy_s": busy, "window_s": window[1] - window[0]}
            gaps = {}
            idle = timeline.gaps(*window)
            labels = timeline.host_at([0.5 * (a + b) for a, b in idle],
                                      timeline.tid_of("bench.window"))
            for (a, b), lab in zip(idle, labels):
                gaps[lab] = gaps.get(lab, 0.0) + (b - a)
            breakdown = {
                "device_ops": [[n, s] for n, s in timeline.top_ops(*window)],
                "idle_gaps": sorted(([n, s] for n, s in gaps.items()),
                                    key=lambda g: -g[1])[:10]}
            attempted = sum(len(r.items) for r in records)
    finally:
        solver_mod.prepare = orig_prepare

    # The check, after the program's state is freed.
    answers = client.answers(conf["check_items"])
    captures = client.captures
    del client
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
    ref = Reference(device)
    readings = []
    for a in answers:
        r = ref.solve(captures[a["item"]], conf["solver"],
                      iterations=a["iterations"],
                      pad_to=a["pad_to"])
        readings.append(check.compare(a, r, conf["solver"]))
        log(f"check item {a['item']}: {a['iterations']} outer iterations, "
            + ", ".join(f"{k} {v:.3g}" for k, v in readings[-1].items()))
    numbers = check.worst(readings)
    correct, table = check.verdict(numbers, conf.get("limits", {}))

    device_info = {
        "platform": "gpu" if cuda else "cpu",
        "kind": torch.cuda.get_device_name(device) if cuda else "cpu",
        "count": 1,
        "memory_peak_bytes": int(max(setup_peak, peak)),
        **dev_extra}
    for k, (v, lim) in table.items():
        log(f"check {k}: {v!r} limit {lim!r}")
    result = {"correct": bool(correct), "attempted": attempted, "failed": 0,
              "metrics": out_metrics, "device": device_info}
    if breakdown is not None:
        result["breakdown"] = breakdown
    if decoder:
        result["decoder"] = decoder  # the loader's PNG decoder
    result["checks"] = table
    return result


def _profiled(client, tracer, n_req, device):
    """The traced pass under ``torch.profiler``: ``(Timeline, (start,
    end))`` of the pass's range."""
    from torch.profiler import ProfilerActivity, profile, record_function

    from .trace import Timeline

    acts = [ProfilerActivity.CPU]
    if device.type == "cuda":
        acts.append(ProfilerActivity.CUDA)
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "trace.json")
        with profile(activities=acts) as prof:
            with tracer.installed():
                tracer.sync()
                with record_function("bench.window"):
                    client.run(requests=n_req)
                    tracer.sync()
        prof.export_chrome_trace(path)
        del prof
        timeline = Timeline.load(path)
    (window,) = timeline.ranges("bench.window")
    return timeline, window


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    bench = load_json(ROOT / "BENCHMARK.json")
    cell = find_cell(bench, args.workload)

    import torch

    if not torch.cuda.is_available() or \
            torch.cuda.device_count() < int(cell["chips"]):
        print(f"{args.workload} needs {cell['chips']} CUDA device(s); "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}"
              " present", file=sys.stderr)
        return 2
    torch.cuda.set_device(0)
    try:
        result = run_cell(bench, cell, args.seed, args.seconds,
                          bool(args.trace), torch.device("cuda", 0))
    except Exception:
        traceback.print_exc()
        return 1
    loaded = sorted({m.split(".")[0] for m in sys.modules} & FORBIDDEN)
    if loaded:
        print(f"the run loaded {loaded}", file=sys.stderr)
        return 1
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
