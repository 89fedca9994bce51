"""The six metrics that read the port's own spans and counters, on made-up
timelines and stores, and in a traced rehearsal on the CPU."""

import sys

import pytest

from bench_torch import run, spans
from bench_torch.tests.conftest import run_small
from bench_torch.trace import Timeline
from srmeetsps_cuda_tpu_torch import trace

READERS = ["upload_ms", "inpaint_launches", "prepare_idle_pct",
           "glue_idle_pct", "host_reads_per_iter", "cg_iters_per_solve"]
DEVICE = READERS[:4]
COUNTERS = READERS[4:]


def ev(cat, name, t0, t1, corr=None):
    e = {"ph": "X", "cat": cat, "name": name, "ts": t0 * 1e6,
         "dur": (t1 - t0) * 1e6}
    if corr is not None:
        e["args"] = {"correlation": corr}
    return e


def launch(cat, name, at, start, end, corr):
    """A device event that ran over [start, end], launched at ``at``."""
    api = "cudaMemcpyAsync" if cat == "gpu_memcpy" else "cudaLaunchKernel"
    return [ev("cuda_runtime", api, at, at + 0.001, corr),
            ev(cat, name, start, end, corr)]


def rec(name, ordinal, parent=None, attrs=None, counts=None):
    return {"name": name, "ordinal": ordinal, "parent": parent,
            "request": 0, "attrs": attrs or {}, "counts": counts or {}}


def ctx_of(events, recs, monkeypatch, totals=None):
    monkeypatch.setattr(trace, "records", lambda: [dict(r) for r in recs])
    monkeypatch.setattr(trace, "totals", lambda: dict(totals or {}))
    return type("Ctx", (), {"timeline": Timeline(events)})()


def read(name, ctx):
    return run.metric_reader(name)(ctx)


def prepare_pass():
    """Two captures. Capture 0: an upload range [0, 1] that launches a
    copy running [0.5, 1.5] and a kernel (no copy), an inpaint range [1, 3]
    launching 3 kernels, the last of which runs after the range closed.
    Capture 1: an upload [10, 11] whose copy runs [12, 14] (launched in
    the range, run outside it), an inpaint [11, 12] with 1 kernel. A copy
    launched outside any upload range does not count."""
    events = [ev("user_annotation", "srps.prepare", 0.0, 4.0),
              ev("user_annotation", "srps.prepare.upload", 0.0, 1.0),
              ev("user_annotation", "srps.prepare.inpaint", 1.0, 3.0),
              ev("user_annotation", "srps.prepare", 10.0, 13.0),
              ev("user_annotation", "srps.prepare.upload", 10.0, 11.0),
              ev("user_annotation", "srps.prepare.inpaint", 11.0, 12.0)]
    events += launch("gpu_memcpy", "HtoD", 0.1, 0.5, 1.5, 1)
    events += launch("kernel", "cast", 0.2, 1.5, 1.6, 2)
    events += launch("kernel", "k", 1.1, 1.6, 1.8, 3)
    events += launch("kernel", "k", 1.5, 1.8, 2.0, 4)
    events += launch("kernel", "k", 2.9, 3.5, 3.7, 5)
    events += launch("gpu_memcpy", "HtoD", 10.1, 12.0, 14.0, 6)
    events += launch("kernel", "k", 11.5, 14.0, 14.5, 7)
    events += launch("gpu_memcpy", "DtoH", 3.9, 3.9, 4.0, 8)
    recs = [rec("srps.prepare", 0), rec("srps.prepare.upload", 0,
                                        ["srps.prepare", 0]),
            rec("srps.prepare.inpaint", 0, ["srps.prepare", 0]),
            rec("srps.prepare", 1), rec("srps.prepare.upload", 1,
                                        ["srps.prepare", 1]),
            rec("srps.prepare.inpaint", 1, ["srps.prepare", 1])]
    return events, recs


def test_upload_counts_the_copies_launched_in_its_ranges(monkeypatch):
    ctx = ctx_of(*prepare_pass(), monkeypatch)
    # Copies of 1.0 s and 2.0 s over two captures; the kernel launched in
    # an upload range and the copy launched outside both are not counted.
    assert read("upload_ms", ctx) == pytest.approx(1e3 * 3.0 / 2)


def test_inpaint_counts_kernels_by_launch(monkeypatch):
    ctx = ctx_of(*prepare_pass(), monkeypatch)
    assert read("inpaint_launches", ctx) == pytest.approx(4 / 2)


def test_prepare_idle_share_with_overlaps(monkeypatch):
    events, recs = prepare_pass()
    events += launch("kernel", "overlap", 0.3, 0.8, 1.2, 9)  # in the copy
    ctx = ctx_of(events, recs, monkeypatch)
    # Capture 0 [0, 4]: busy [0.5, 2.0] + [3.5, 3.7] + [3.9, 4.0] = 1.8 s.
    # Capture 1 [10, 13]: busy [12, 13] = 1 s. Idle 2.2 + 2 of 7 s.
    assert read("prepare_idle_pct", ctx) == pytest.approx(100 * 4.2 / 7)


def test_glue_idle_share_leaves_out_the_cg(monkeypatch):
    events = [ev("user_annotation", "srps.iteration", 0.0, 4.0),
              ev("user_annotation", "srps.depth_cg", 1.0, 2.0),
              ev("user_annotation", "srps.iteration", 5.0, 6.0),
              ev("user_annotation", "srps.depth_cg", 5.5, 5.6)]
    events += launch("kernel", "glue", 0.1, 0.5, 1.5, 1)
    events += launch("kernel", "cg", 1.2, 1.5, 3.0, 2)
    events += launch("kernel", "glue", 5.1, 5.2, 5.3, 3)
    recs = [rec("srps.iteration", 0),
            rec("srps.depth_cg", 0, ["srps.iteration", 0], {"lanes": 1}),
            rec("srps.iteration", 1),
            rec("srps.depth_cg", 1, ["srps.iteration", 1], {"lanes": 1})]
    ctx = ctx_of(events, recs, monkeypatch)
    # Glue [0, 1] + [2, 4] + [5, 5.5] + [5.6, 6]: 3.9 s, busy [0.5, 1],
    # [2, 3] and [5.2, 5.3]: 1.6 s.
    assert read("glue_idle_pct", ctx) == pytest.approx(100 * 2.3 / 3.9)


def test_counters_per_iteration_and_per_lane_solve(monkeypatch):
    events = [ev("user_annotation", "srps.iteration", 0.0, 1.0),
              ev("user_annotation", "srps.depth_cg", 0.2, 0.3),
              ev("user_annotation", "srps.iteration", 2.0, 3.0),
              ev("user_annotation", "srps.depth_cg", 2.2, 2.3)]
    recs = [rec("srps.iteration", 0, attrs={"lanes": 4}),
            rec("srps.depth_cg", 0, ["srps.iteration", 0], {"lanes": 4},
                {"cg_iters": 400}),
            rec("srps.iteration", 1, attrs={"lanes": 4}),
            rec("srps.depth_cg", 1, ["srps.iteration", 1], {"lanes": 4},
                {"cg_iters": 380})]
    ctx = ctx_of(events, recs, monkeypatch, {"host_reads": 7})
    assert read("host_reads_per_iter", ctx) == pytest.approx(3.5)
    assert read("cg_iters_per_solve", ctx) == pytest.approx(780 / 8)
    # The counters need no device events; the device shares do.
    assert read("glue_idle_pct", ctx) is None


@pytest.mark.parametrize("fault", ["extra range", "missing range",
                                   "no store", "empty store"])
def test_no_number_without_a_one_to_one_join(monkeypatch, fault):
    events, recs = prepare_pass()
    if fault == "extra range":
        events.append(ev("user_annotation", "srps.prepare.inpaint", 5, 6))
    elif fault == "missing range":
        events = [e for e in events if not (
            e["name"] == "srps.prepare.upload" and e["ts"] == 10e6)]
    elif fault == "empty store":
        recs = []
    ctx = ctx_of(events, recs, monkeypatch, {"host_reads": 3})
    if fault == "no store":
        # A program without the store (an older one): nothing to read.
        import srmeetsps_cuda_tpu_torch as port

        monkeypatch.delattr(port, "trace")
        monkeypatch.setitem(sys.modules, "srmeetsps_cuda_tpu_torch.trace",
                            None)
    assert spans.joined(ctx.timeline) is None
    assert [read(m, ctx) for m in READERS] == [None] * len(READERS)


@pytest.mark.parametrize("cell", ["mitten_sf2.interactive",
                                  "mitten_sf2.mixed4"])
def test_traced_run_reads_the_program_counters(cell):
    res = run_small(cell, trace=True)
    assert res["correct"] is True, res["checks"]
    m = res["metrics"]
    # The CPU has no device timeline: the counters are read, the device
    # shares absent.
    assert set(COUNTERS) <= set(m) and not set(DEVICE) & set(m)
    cap = run.load_json(run.HERE / "configs" / "mitten_sf2.json")[
        "solver"]["cg_max_iter"]
    assert 0 < m["cg_iters_per_solve"]["value"] <= cap + 1
    reads = m["host_reads_per_iter"]["value"]
    if cell.endswith("mixed4"):
        # Per batch of 4 and n outer iterations: n + 1 stop tests and the 4
        # lanes' iteration counts read after the loop.
        assert 1 < reads <= 1 + 5 / 2
    else:
        # Per capture: n stop tests, 2n scalar reads, 1 synchronise.
        assert 3 < reads <= 3 + 1 / 2
