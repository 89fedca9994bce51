"""The control of the check: the plain reference in TF32, in the program's
place, has to come out as not correct.

    python3 -m bench_torch.control --workload <cell> --seeds 1,2,3

For each seed it makes the cell's pool as a run does, solves as many
captures as a run's check compares (pool items drawn from the seed,
cropped and padded as the traffic sends them) with the reference in TF32
and its own stopping rule, holds each answer against the float32
reference run for as many outer iterations, and prints for each seed the
worst of each number beside the configuration's limit and the verdict of
``check.verdict`` (``correct`` has to read false), then the smallest of
each number over the seeds (the upper reading each limit has to stay
under). It needs no window: the answers do not depend on the load. It
exits 1 where the control comes out correct on any seed.
"""

from __future__ import annotations

import argparse
import json
import random
import sys

from .run import HERE, ROOT, find_cell, load_json


def control_readings(cell: dict, seed: int, device, conf: dict = None,
                     mix: dict = None) -> dict:
    """The worst of each number over the pool of one seed."""
    from . import check
    from . import data as bdata
    from .drive import Client
    from .reference import Reference

    conf = conf or load_json(HERE / "configs" / f"{cell['config']}.json")
    mix = mix or load_json(HERE / "traffic" / f"{cell['traffic']}.json")
    h, w = conf["grid"]
    pool = bdata.make_pool(conf["content_seed"], conf["pool"], h, w,
                           conf["sf"], conf["n"], conf["c"], conf["fx"],
                           conf["fy"], device)
    client = Client(mix, pool, None, device, seed,
                    content_seed=conf["content_seed"])
    readings = []
    items = random.Random(seed).sample(range(len(pool)),
                                       min(conf["check_items"], len(pool)))
    for i in sorted(items):
        cap, pad = client.captures[i], client.pad_to(client.group(i))
        ctl = Reference(device, tf32=True).solve(cap, conf["solver"],
                                                 pad_to=pad)
        ref = Reference(device).solve(cap, conf["solver"],
                                      iterations=len(ctl["energies"]),
                                      pad_to=pad)
        readings.append(check.compare(ctl, ref, conf["solver"]))
    return check.worst(readings)


def main(argv=None) -> int:
    import torch

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    args = ap.parse_args(argv)
    bench = load_json(ROOT / "BENCHMARK.json")
    cell = find_cell(bench, args.workload)
    conf = load_json(HERE / "configs" / f"{cell['config']}.json")
    if not torch.cuda.is_available():
        print("the control runs on a CUDA device", file=sys.stderr)
        return 2
    dev = torch.device("cuda", 0)
    from . import check

    per_seed, verdicts = {}, []
    for s in args.seeds.split(","):
        per_seed[s] = control_readings(cell, int(s), dev, conf)
        ok, table = check.verdict(per_seed[s], conf["limits"])
        verdicts.append(ok)
        print(json.dumps({"seed": int(s), "correct": ok, "checks": table}),
              flush=True)
    least = {k: min(r[k] for r in per_seed.values()) for k in conf["limits"]
             or next(iter(per_seed.values()))}
    print(json.dumps({"workload": args.workload, "control_least": least,
                      "limits": conf["limits"], "correct_on": verdicts.count(True),
                      "device": torch.cuda.get_device_name(dev)}), flush=True)
    return 1 if any(verdicts) else 0


if __name__ == "__main__":
    sys.exit(main())
