"""Each traffic mix end to end on the CPU at a small size, and the
command's refusal without a card."""

import json
import os
import subprocess
import sys

import pytest

from bench_torch import check, run
from bench_torch.tests.conftest import BENCH, run_small

CELLS = [w["name"] for w in BENCH["workloads"]]


@pytest.mark.parametrize("cell", CELLS)
def test_untraced_run(cell):
    res = run_small(cell)
    assert list(res)[:5] == ["correct", "attempted", "failed", "metrics",
                             "device"]
    assert list(res)[-1] == "checks"
    assert res["correct"] is True, res["checks"]
    assert res["attempted"] >= 1 and res["failed"] == 0
    want = {m["name"] for m in run.cell_metrics(BENCH, cell, "end_to_end")}
    assert set(res["metrics"]) == want
    assert all(v["value"] > 0 or k == "peak_mem_gib"
               for k, v in res["metrics"].items())
    assert res["device"]["platform"] == "cpu"
    assert set(res["checks"]) == set(check.NUMBERS)
    json.dumps(res)


@pytest.mark.parametrize("cell", ["mitten_sf2.interactive",
                                  "mitten_sf2.mixed4", "mitten_sf2.serve"])
def test_traced_run(cell):
    res = run_small(cell, trace=True)
    assert res["correct"] is True, res["checks"]
    # The CPU has no device timeline: the span metrics and the counter
    # are read, the device's are 0 or absent, never a roofline share.
    m = res["metrics"]
    assert m["prepare_ms"]["value"] > 0 and m["glue_ms_per_iter"]["value"] > 0
    assert "depth_cg_roofline" not in m
    if cell.endswith("mixed4"):
        assert 0 < m["lockstep_useful_pct"]["value"] <= 100
    else:
        assert "lockstep_useful_pct" not in m
    if cell.endswith("serve"):
        assert m["load_ms"]["value"] > 0
        assert res["decoder"] in ("pillow", "native")
    else:
        assert "load_ms" not in m and "decoder" not in res
    assert res["device"]["window_s"] > 0
    assert set(res["breakdown"]) == {"device_ops", "idle_gaps"}


def test_command_refuses_without_a_card():
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    p = subprocess.run([sys.executable, "-m", "bench_torch.run",
                        "--workload", CELLS[0], "--seed", str(2 ** 32 + 5),
                        "--seconds", "1", "--trace", "0"],
                       cwd=run.ROOT, env=env, capture_output=True, text=True,
                       timeout=300)
    assert p.returncode != 0 and p.stdout == ""


def test_each_pass_serves_every_group_in_an_order_from_the_seed():
    import torch

    from bench_torch import data
    from bench_torch.drive import Client
    from bench_torch.tests.conftest import small

    cell, conf, mix = small("mitten_sf2.interactive", pool=4)
    pool = data.make_pool(conf["content_seed"], 4, 48, 64, 2, 4, 3, 1216.73,
                          1216.73, torch.device("cpu"))
    orders = []
    for seed in (1, 2, 3):
        client = Client(mix, pool, run.solver_config(conf), torch.device("cpu"),
                        seed, content_seed=conf["content_seed"])
        mod, orig = client.probe_prepare()
        try:
            recs = client.run(requests=8)
        finally:
            mod.prepare = orig
        items = [r.items[0] for r in recs]
        assert sorted(items[:4]) == sorted(items[4:]) == [0, 1, 2, 3]
        orders.append(items)
    assert len({tuple(o) for o in orders}) > 1
