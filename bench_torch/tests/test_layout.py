"""BENCHMARK.json against the characters its format allows, and the
files the harness finds by the names in it."""

import json
import re

import pytest

from bench_torch import check, run

BENCH = run.load_json(run.ROOT / "BENCHMARK.json")
NAME = re.compile(r"[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}\Z")
UNIT = re.compile(r"[A-Za-z0-9_/%.\-]{1,16}\Z")
LINE = re.compile(r"[^\t\n\r]{1,200}\Z")
SOURCES = {"device_trace", "program_span", "program_counter", "host_clock"}


def test_top_level_keys_and_command():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert 1 <= BENCH["run_seconds"] <= 51
    assert len(BENCH["command"]) <= 32
    assert all(LINE.match(w) for w in BENCH["command"])
    for p in BENCH["paths"]:
        assert re.fullmatch(r"[A-Za-z0-9_.\-/]{1,200}", p)
        assert not p.startswith("/") and ".." not in p.split("/")
    assert len((run.ROOT / "BENCHMARK.json").read_bytes()) <= 64 * 1024


def test_names_units_and_lines():
    names = []
    for c in BENCH["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert NAME.match(c["name"]) and LINE.match(c["source"])
        assert LINE.match(c["why"]) and len(c["reduced"]) <= 16
        assert all(NAME.match(k) for k in c["reduced"])
        names.append(c["name"])
    cells = []
    for w in BENCH["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert NAME.match(w["name"]) and NAME.match(w["traffic"])
        assert w["config"] in names and w["chips"] in (1, 4)
        assert LINE.match(w["why"])
        cells.append(w["name"])
    assert len(set(cells)) == len(cells)
    assert len({(w["config"], w["traffic"]) for w in BENCH["workloads"]}) \
        == len(cells)
    metrics = []
    for group in ("end_to_end", "per_layer"):
        for m in BENCH[group]:
            assert NAME.match(m["name"]) and UNIT.match(m["unit"])
            assert m["better"] in ("lower", "higher")
            assert m["source"] in SOURCES
            assert set(m.get("workloads", cells)) <= set(cells)
            metrics.append(m["name"])
    assert len(set(metrics)) == len(metrics)


def test_end_to_end_and_per_layer_rules():
    e2e = {m["name"]: m for m in BENCH["end_to_end"]}
    assert "setup_s" in e2e and e2e["setup_s"]["bound"] <= 0.25
    for m in e2e.values():
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
        assert set(m) <= {"name", "unit", "better", "bound", "source",
                          "workloads"}
    layers = set()
    for m in BENCH["per_layer"]:
        assert set(m) <= {"name", "unit", "better", "source", "layer",
                          "moves", "workloads"}
        assert m["moves"] in e2e and LINE.match(m["layer"])
        layers.add(m["layer"])
        # Every cell it lists reports the metric it moves.
        moved = e2e[m["moves"]].get("workloads")
        if moved is not None:
            assert set(m.get("workloads", [])) <= set(moved)
        if m["name"].endswith("_roofline"):
            assert m["unit"] == "%"
    for w in BENCH["workloads"]:
        got = [m["name"] for m in run.cell_metrics(BENCH, w["name"],
                                                   "end_to_end")]
        assert "setup_s" in got and len(got) >= 2
        assert run.cell_metrics(BENCH, w["name"], "per_layer")


@pytest.mark.parametrize("cell", [w["name"] for w in BENCH["workloads"]])
def test_cell_files_found_by_name(cell):
    w = run.find_cell(BENCH, cell)
    conf = run.load_json(run.HERE / "configs" / f"{w['config']}.json")
    entry = next(c for c in BENCH["configs"] if c["name"] == w["config"])
    assert entry["file"] == f"bench_torch/configs/{w['config']}.json"
    assert conf["name"] == w["config"] and conf["reduced"] == entry["reduced"]
    assert conf["source"] and conf["assumed"]
    assert set(conf["limits"]) <= set(check.NUMBERS) and conf["limits"]
    run.solver_config(conf)  # every solver key is the port's
    mix = run.load_json(run.HERE / "traffic" / f"{w['traffic']}.json")
    assert mix["entry"] in ("solve", "serve", "lockstep")
    for m in run.cell_metrics(BENCH, cell, "per_layer"):
        assert callable(run.metric_reader(m["name"]))


def test_metric_files_have_entries():
    on_disk = {p.stem for p in (run.HERE / "metrics").glob("*.py")
               if p.stem != "__init__"}
    assert on_disk == {m["name"] for m in BENCH["per_layer"]}


def test_result_line_is_json():
    # The check's table comes last in the result line.
    table = check.verdict({k: 0.0 for k in check.NUMBERS},
                          {k: 1.0 for k in check.NUMBERS})
    line = json.dumps({"correct": table[0], "checks": table[1]})
    assert list(json.loads(line))[-1] == "checks"
