"""The harness's arithmetic on made-up records, timelines and shapes."""

import math

import pytest

from bench_torch import roofline, run
from bench_torch.drive import Record
from bench_torch.trace import Timeline


def records():
    # Four requests back to back from t = 10 s: 1, 2, 3, 4 captures of
    # 0.1, 0.2, 0.3 and 0.4 s, with 11, 10 / 9, ... outer iterations.
    out, t = [], 10.0
    for k in range(1, 5):
        out.append(Record(t, t + 0.1 * k, [11 - j for j in range(k)],
                          list(range(k))))
        t += 0.1 * k
    return out


def test_rate_and_outer_iteration():
    r = records()
    assert run.window_seconds(r) == pytest.approx(1.0)
    assert run.captures_per_s(r) == pytest.approx(10.0)
    iters = 11 + (11 + 10) + (11 + 10 + 9) + (11 + 10 + 9 + 8)
    assert run.outer_iter_ms(r) == pytest.approx(1e3 / iters)


def test_p90_counts_every_capture():
    # Latencies 1..100 ms, one capture each: the inclusive 90th
    # percentile of 1..100 is 90.1.
    r = [Record(float(k), k + k / 1e3, [11], [0]) for k in range(1, 101)]
    assert run.capture_p90_ms(r) == pytest.approx(90.1)
    # A batch of 4 counts four captures of the batch's latency.
    r = [Record(0.0, 0.5, [11] * 4, [0, 1, 2, 3])] + [
        Record(1.0, 1.1, [11], [0])] * 4
    assert run.capture_p90_ms(r) == pytest.approx(500.0)


def ev(cat, name, t0, t1):
    return {"ph": "X", "cat": cat, "name": name, "ts": t0 * 1e6,
            "dur": (t1 - t0) * 1e6}


def test_idle_share_with_overlaps_and_gaps():
    tl = Timeline([
        ev("kernel", "a", 1.0, 2.0), ev("kernel", "b", 1.5, 2.5),  # overlap
        ev("gpu_memcpy", "c", 2.4, 3.0), ev("kernel", "d", 4.0, 4.5),
        ev("kernel", "e", 4.1, 4.2),  # inside d
        ev("kernel", "f", 9.0, 12.0),  # runs past the window's end
        ev("user_annotation", "w", 0.0, 10.0),
        ev("cpu_op", "aten::item", 3.1, 3.9),
        ev("cuda_runtime", "cudaLaunchKernel", 3.0, 3.1),
    ])
    assert tl.ranges("w") == [(0.0, 10.0)]
    # Busy: [1, 3] + [4, 4.5] + [9, 10].
    assert tl.busy(0.0, 10.0) == pytest.approx(3.5)
    gaps = tl.gaps(0.0, 10.0)
    assert [(pytest.approx(a), pytest.approx(b)) for a, b in gaps] == [
        (4.5, 9.0), (0.0, 1.0), (3.0, 4.0)]
    assert tl.host_at([3.5, 5.0, 0.5]) == ["aten::item", "w", "w"]
    assert tl.host_at([3.5], tid=99) == ["none"]
    assert [k[2] for k in tl.kernels_in(1.0, 4.1)] == ["a", "b", "d", "e"]
    assert tl.top_ops(0.0, 10.0)[0] == ("f", pytest.approx(3.0))
    assert tl.unlaunched == 6


def test_a_kernel_belongs_to_the_range_that_launched_it():
    # Two unsynchronised ranges: "k2" is launched in r1 but runs during
    # r2 (the queue is ahead of the host); "k3", launched in r2, runs
    # after both have closed. The memcpy is no kernel.
    def corr(e, c):
        e["args"] = {"correlation": c}
        return e
    tl = Timeline([
        ev("user_annotation", "r1", 0.0, 1.0),
        ev("user_annotation", "r2", 1.0, 2.0),
        corr(ev("cuda_runtime", "cudaLaunchKernel", 0.1, 0.11), 1),
        corr(ev("cuda_runtime", "cudaLaunchKernel", 0.9, 0.91), 2),
        corr(ev("cuda_driver", "cuLaunchKernel", 1.5, 1.51), 3),
        corr(ev("cuda_runtime", "cudaMemcpyAsync", 1.6, 1.61), 4),
        corr(ev("kernel", "k1", 0.2, 0.5), 1),
        corr(ev("kernel", "k2", 1.2, 1.4), 2),
        corr(ev("kernel", "k3", 2.5, 2.8), 3),
        corr(ev("gpu_memcpy", "m", 2.8, 2.9), 4),
        corr(ev("kernel", "lost", 1.1, 1.15), 9),  # no launch in the trace
    ])
    (r1,), (r2,) = tl.ranges("r1"), tl.ranges("r2")
    assert [k[2] for k in tl.kernels_in(*r1)] == ["k1", "k2"]
    # "lost" falls back to its own start, 1.1 s.
    assert [k[2] for k in tl.kernels_in(*r2)] == ["lost", "k3"]
    assert tl.unlaunched == 1
    assert sum(b - a for a, b, *_ in tl.kernels_in(*r1)) == \
        pytest.approx(0.5)


@pytest.mark.parametrize("sync,calls", [(True, 2), (False, 0)])
def test_spans_synchronise_only_in_the_spans_pass(sync, calls):
    import torch

    from bench_torch.trace import Tracer

    tr = Tracer(torch.device("cpu"), sync=sync)
    n = []
    tr.sync = lambda: n.append(1)
    assert tr.wrap("x", lambda v: v + 1)(1) == 2
    assert len(n) == calls and [s.name for s in tr.spans] == ["x"]


def test_roofline_counts_match_the_kernel_table():
    # PERF.md's kernel table: the stencil CG's bound at 960 x 1280 sf 2
    # over the whole grid is 0.00052 ms per CG iteration (ops), the stream
    # of 19 planes 93.4 MB.
    px = 960 * 1280
    t, by = roofline.least_seconds(px, 101)
    assert by == "ops"
    assert t / 101 * 1e3 == pytest.approx(0.00052, abs=5e-6)
    assert roofline.cg_bytes(px) == pytest.approx(19 * 4 * px)
    assert roofline.cg_ops(px, 0) == 150 * px
    # Too few iterations to outweigh reading the planes: bytes bound it.
    assert roofline.least_seconds(px, 0)[1] == "bytes"
    assert math.isclose(roofline.least_seconds(px, 0)[0],
                        19 * 4 * px / 3.35e12)
