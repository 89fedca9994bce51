"""Where a cell's time goes, phase by phase: the port's ``srps.*`` spans
over one profiled round of four captures.

    python3 -m bench_torch.phases --workload <cell> --seed <n> [--out FILE]

Set-up is a run's (kernels, the pool, one request of every shape); then
one round of four captures runs under ``torch.profiler`` as in a traced
run's profiled pass. For each phase it prints the device events (kernels,
copies, sets) launched in the phase's own host time (its ranges less the
``srps.*`` ranges inside them), their device time, that host time, and the
idle device time within it: per lane-iteration for the outer iteration's
phases, per capture for preprocessing's; where the mix loads dataset
folders, the loader's mean host time a capture too. ``--out`` writes the rows as
JSON. With no CUDA card it exits 2.
"""

from __future__ import annotations

import argparse
import json
import sys
from collections import defaultdict

from . import spans
from .run import HERE, ROOT, TRACE_CAPTURES, find_cell, load_json

ORDER = ["srps.prepare", "srps.prepare.upload", "srps.prepare.mean",
         "srps.prepare.inpaint", "srps.prepare.bilateral",
         "srps.prepare.bicubic", "srps.prepare.pad", "srps.prepare.problem",
         "srps.prepare.state", "srps.iteration", "srps.lighting",
         "srps.albedo", "srps.depth_operator", "srps.depth_cg",
         "srps.normals", "srps.stop", "srps.results"]
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")


def table(tl, recs) -> list:
    """One row a phase: ``[name, per, launches, device ms, host ms, idle
    ms]``, each over ``per`` (``capture`` or ``lane-iteration``), from
    the records joined to ``tl`` (:func:`spans.joined`)."""
    inner = defaultdict(list)
    for r in recs:
        if r["parent"]:
            inner[tuple(r["parent"])].append(r["range"])
    sums = defaultdict(lambda: [0, 0.0, 0.0, 0.0])
    for r in recs:
        own = spans.less(r["range"], inner[(r["name"], r["ordinal"])])
        events = [d for cat in DEVICE_CATS
                  for d in spans.launched(tl, own, cat)]
        idle, host = spans.idle(tl, own)
        row = sums[r["name"]]
        row[0] += len(events)
        row[1] += sum(b - a for a, b, *_ in events)
        row[2] += host
        row[3] += idle
    captures = len(spans.of(recs, "srps.prepare"))
    lane_iters = sum(r["attrs"].get("lanes", 1)
                     for r in spans.of(recs, "srps.iteration"))
    out = []
    for name in sorted(sums, key=lambda n: (ORDER + [n]).index(n)):
        pre = name.startswith("srps.prepare")
        per = captures if pre else lane_iters
        n, dev, host, idle = sums[name]
        out.append([name, "capture" if pre else "lane-iteration", n / per,
                    1e3 * dev / per, 1e3 * host / per, 1e3 * idle / per])
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--out")
    args = ap.parse_args(argv)

    import torch

    from srmeetsps_cuda_tpu_torch import native
    from srmeetsps_cuda_tpu_torch.device import set_precision

    from . import data as bdata
    from .drive import Client
    from .run import _profiled, solver_config
    from .trace import Tracer

    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 2
    cell = find_cell(load_json(ROOT / "BENCHMARK.json"), args.workload)
    conf = load_json(HERE / "configs" / f"{cell['config']}.json")
    mix = load_json(HERE / "traffic" / f"{cell['traffic']}.json")
    device = torch.device("cuda", 0)
    set_precision()
    native.build_all(conf["kernels"])
    h, w = conf["grid"]
    pool = bdata.make_pool(conf["content_seed"], conf["pool"], h, w,
                           conf["sf"], conf["n"], conf["c"], conf["fx"],
                           conf["fy"], device)
    client = Client(mix, pool, solver_config(conf), device, args.seed,
                    content_seed=conf["content_seed"])
    solver_mod, orig_prepare = client.probe_prepare()
    try:
        shapes = len({tuple(c.mask.shape) for c in client.captures})
        client.run(requests=-(-shapes // client.batch))
        n_req = max(1, TRACE_CAPTURES // client.batch)
        tl, _ = _profiled(client, Tracer(device, sync=False), n_req, device)
    finally:
        solver_mod.prepare = orig_prepare
    got = spans.joined(tl)
    if got is None:
        print("the program's spans do not join the trace", file=sys.stderr)
        return 1
    rows = table(tl, got[0])
    print(f"| {args.workload} | per | launches | device ms | host ms "
          "| idle ms |")
    for name, per, *vals in rows:
        print(f"| `{name}` | {per} | "
              + " | ".join(f"{v:.3f}" for v in vals) + " |")
    loads = tl.ranges("load")
    if loads:
        print(f"load (the loader's range, on the host): "
              f"{1e3 * sum(b - a for a, b in loads) / len(loads):.3f} ms "
              f"a capture over {len(loads)}")
    print("totals:", json.dumps(got[1]))
    if args.out:
        with open(args.out, "w") as f:
            json.dump({"workload": args.workload, "seed": args.seed,
                       "rows": rows, "totals": got[1]}, f)
    return 0


if __name__ == "__main__":
    sys.exit(main())
