"""``metrics/ring_fill_gbps.py`` on a hand-made timeline and store: the
bytes moved through the staging ring over the host's time filling its
slots, and nothing from a program that does not count that time."""

import pytest

from bench_torch import run
from bench_torch.trace import Timeline
from srmeetsps_cuda_tpu_torch import trace


def fill_gbps(totals, monkeypatch, uploads=2):
    recs = [{"name": "srps.prepare.upload", "ordinal": k, "parent": None,
             "request": 0, "attrs": {"pinned": True}, "counts": {}}
            for k in range(uploads)]
    monkeypatch.setattr(trace, "records", lambda: [dict(r) for r in recs])
    monkeypatch.setattr(trace, "totals", lambda: dict(totals))
    events = [{"ph": "X", "cat": "user_annotation",
               "name": "srps.prepare.upload", "ts": 10.0 * k, "dur": 5.0}
              for k in range(uploads)]
    ctx = type("Ctx", (), {"timeline": Timeline(events)})()
    return run.metric_reader("ring_fill_gbps")(ctx)


def test_bytes_over_fill_time(monkeypatch):
    # 2.19 GB filled in 125 ms: 17.52 GB/s.
    got = fill_gbps({"h2d_bytes": 2_190_000_000,
                     "h2d_pinned_bytes": 2_190_000_000,
                     "h2d_fill_ns": 125_000_000}, monkeypatch)
    assert got == pytest.approx(17.52)
    # Pageable bytes are not the ring's: only the pinned ones count.
    got = fill_gbps({"h2d_bytes": 3000, "h2d_pinned_bytes": 1000,
                     "h2d_fill_ns": 500}, monkeypatch)
    assert got == pytest.approx(2.0)


@pytest.mark.parametrize("totals", [
    {"h2d_bytes": 8, "h2d_pinned_bytes": 8},  # no fill counter: the parent
    {"h2d_bytes": 8, "h2d_pinned_bytes": 8, "h2d_fill_ns": 0},
    {"h2d_bytes": 8, "h2d_pinned_bytes": 0, "h2d_fill_ns": 5},
    {}])
def test_nothing_without_the_counter(totals, monkeypatch):
    assert fill_gbps(totals, monkeypatch) is None


def test_nothing_when_the_ranges_do_not_pair(monkeypatch):
    # Two records against one range: the store and the trace disagree.
    monkeypatch.setattr(trace, "records", lambda: [
        {"name": "srps.prepare.upload", "ordinal": k, "parent": None,
         "request": 0, "attrs": {}, "counts": {}} for k in range(2)])
    monkeypatch.setattr(trace, "totals", lambda: {
        "h2d_pinned_bytes": 8, "h2d_fill_ns": 4})
    events = [{"ph": "X", "cat": "user_annotation",
               "name": "srps.prepare.upload", "ts": 0.0, "dur": 5.0}]
    ctx = type("Ctx", (), {"timeline": Timeline(events)})()
    assert run.metric_reader("ring_fill_gbps")(ctx) is None
