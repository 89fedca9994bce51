"""A host array's move to the device (``models/srps.py::to_f32``): on a
CUDA card through the card's pinned staging ring (``device.upload``,
``device.StagingRing``), elsewhere as before.

On the CPU: ``to_f32`` of float64, column-major, strided and empty arrays
and of a tensor is what ``torch.as_tensor`` of the float32 row-major array
gave (the span's attr ``pinned`` False, ``h2d_pinned_bytes`` 0), and no
ring is made; the ring's loop rehearsed with unpinned slots and stand-in
events (chunk edges, the wait before a slot is filled again), the host's
fill of the slots counted once an upload as ``h2d_fill_ns`` while a
profiler records and not timed otherwise; and
``bench_torch/metrics/upload_pinned_pct.py`` on made-up counters.

On a CUDA card (marked ``cuda``, skipped without one): the ring's copy bit
for bit ``torch.as_tensor(a, device="cuda")`` at 1 element, one chunk less
one, one chunk, one more, 3.5 chunks and 551 MB, its fill time counted
once and positive; the caller's array
overwritten at once; two arrays larger than the ring back to back, read by
one kernel; a fused and a lockstep solve (the glue's graphs on) bit for
bit the same solves through ``torch.as_tensor``; ``h2d_pinned_bytes``
equal to ``h2d_bytes`` in every solve.

This file imports no JAX, so it runs on a card's machine too: ``python -m
pytest --noconftest tests/test_torch_staged_upload.py``.
"""

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from bench_torch import run
from bench_torch.trace import Timeline
from srmeetsps_cuda_tpu_torch import device as devices
from srmeetsps_cuda_tpu_torch import trace as tracing
from srmeetsps_cuda_tpu_torch.config import RuntimeConfig, SolverConfig
from srmeetsps_cuda_tpu_torch.io.synthetic import lambertian_dataset
from srmeetsps_cuda_tpu_torch.models import srps
from srmeetsps_cuda_tpu_torch.parallel import batched
from srmeetsps_cuda_tpu_torch.runtime import solver

CPU = torch.device("cpu")
CHUNK = devices.STAGE_CHUNK // 4  # float32 elements of a slot
FIELDS = ("z", "rho", "s", "N", "dz")


@pytest.fixture
def card() -> torch.device:
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def uploads(fn):
    """``fn()``'s result and its ``srps.prepare.upload`` records, under the
    profiler."""
    with profile(activities=[ProfilerActivity.CPU]):
        out = fn()
    return out, [r for r in tracing.records()
                 if r["name"] == "srps.prepare.upload"]


# -- the CPU path: as before ----------------------------------------------------


def host_inputs():
    rng = np.random.default_rng(0)
    a = rng.standard_normal((6, 10))
    return {"float64": a,
            "column-major": np.asfortranarray(a.astype(np.float32)),
            "strided": a.astype(np.float32)[::2, 1::3],
            "empty": np.zeros((0, 5), np.float32),
            "tensor": torch.from_numpy(a)}


@pytest.mark.parametrize("kind", list(host_inputs()))
def test_cpu_to_f32_is_unchanged(kind):
    a = host_inputs()[kind]
    got, recs = uploads(lambda: srps.to_f32(a, CPU))
    if kind == "tensor":
        want = a.to(device=CPU, dtype=torch.float32).contiguous()
        assert recs == []
    else:
        want = torch.as_tensor(np.ascontiguousarray(a, np.float32),
                               device=CPU)
        nbytes = np.ascontiguousarray(a, np.float32).nbytes
        assert [(r["attrs"], r["counts"]) for r in recs] == [
            ({"pinned": False}, {"h2d_bytes": nbytes,
                                 "h2d_pinned_bytes": 0})]
    assert got.dtype == torch.float32 and got.device == CPU
    assert got.is_contiguous() and got.shape == want.shape
    assert torch.equal(got, want)


def test_the_cpu_path_makes_no_ring(monkeypatch):
    def refused(*args, **kw):
        raise AssertionError("a staging ring made for the CPU")

    monkeypatch.setattr(devices, "StagingRing", refused)
    monkeypatch.setattr(devices, "_rings", {})
    data = lambertian_dataset(48, 64, 2, n=2, c=3)[0]
    for a in host_inputs().values():
        srps.to_f32(a, "cpu")
    solver.prepare(data, SolverConfig(), CPU)
    solver.prepare(data, SolverConfig(), CPU, pad_to=(52, 68))
    assert devices._rings == {}


# -- the ring's loop, rehearsed on the CPU ----------------------------------------


class Event:
    """A stand-in for ``torch.cuda.Event`` that logs its calls."""

    made = 0
    log = []

    def __init__(self):
        self.id = Event.made
        Event.made += 1

    def synchronize(self):
        Event.log.append(("wait", self.id))

    def record(self, stream=None):
        Event.log.append(("record", self.id))


def rehearsed_ring(monkeypatch, chunk_bytes, slots):
    """A ring of unpinned slots and logging events (the CPU has neither
    pinned memory nor events)."""
    empty = torch.empty
    monkeypatch.setattr(torch, "empty",
                        lambda *a, pin_memory=False, **kw: empty(*a, **kw))
    monkeypatch.setattr(torch.cuda, "Event", Event)
    monkeypatch.setattr(torch.cuda, "current_stream", lambda device: None)
    Event.made = 0
    return devices.StagingRing(chunk_bytes, slots)


@pytest.mark.parametrize("slots", [2, 3])
@pytest.mark.parametrize("n", [1, 15, 16, 17, 56])
def test_ring_chunks_rehearsed(monkeypatch, n, slots):
    """Chunks of 16 elements: every element lands once, and chunk k waits
    for slot k mod S's last copy before filling it, then records it; a
    second array carries on round the ring."""
    ring = rehearsed_ring(monkeypatch, 64, slots)
    src = torch.arange(n, dtype=torch.float32) + 0.5
    chunks = -(-n // 16)
    for first in (0, chunks % slots):
        dst = torch.full((n,), float("nan"))
        Event.log = []
        ring.copy(src, dst)
        assert torch.equal(dst, src)
        assert Event.log == [(what, (first + k) % slots)
                             for k in range(chunks)
                             for what in ("wait", "record")]


def test_fill_time_counted_once_an_upload_rehearsed(monkeypatch):
    """Under the profiler, one ``h2d_fill_ns`` count an upload, positive,
    in the upload's span; the array lands bit for bit."""
    ring = rehearsed_ring(monkeypatch, 64, 2)
    src = torch.arange(56, dtype=torch.float32) - 7.25
    dst = torch.full((56,), float("nan"))

    def go():
        with tracing.span("srps.prepare.upload", pinned=True):
            ring.copy(src, dst)
    uploads(go)
    (rec,) = [r for r in tracing.STORE.spans
              if r["name"] == "srps.prepare.upload"]
    (fill,) = rec["counts"]["h2d_fill_ns"]
    assert isinstance(fill, int) and fill > 0
    assert torch.equal(dst, torch.as_tensor(src.numpy()))


def test_fill_not_timed_without_a_profiler(monkeypatch):
    """With tracing off the ring reads no clock: one flag check."""
    ring = rehearsed_ring(monkeypatch, 64, 2)

    def clock():
        raise AssertionError("the fill was timed with tracing off")
    monkeypatch.setattr(devices.time, "perf_counter_ns", clock)
    src = torch.arange(40, dtype=torch.float32)
    dst = torch.empty(40)
    ring.copy(src, dst)
    assert torch.equal(dst, src)


# -- bench_torch/metrics/upload_pinned_pct.py ------------------------------------


def pinned_pct(totals, monkeypatch):
    recs = [{"name": "srps.prepare.upload", "ordinal": 0, "parent": None,
             "request": 0, "attrs": {}, "counts": {}}]
    monkeypatch.setattr(tracing, "records", lambda: [dict(r) for r in recs])
    monkeypatch.setattr(tracing, "totals", lambda: dict(totals))
    events = [{"ph": "X", "cat": "user_annotation",
               "name": "srps.prepare.upload", "ts": 0.0, "dur": 1e6}]
    ctx = type("Ctx", (), {"timeline": Timeline(events)})()
    return run.metric_reader("upload_pinned_pct")(ctx)


def test_pinned_share_of_the_uploaded_bytes(monkeypatch):
    assert pinned_pct({"h2d_bytes": 8, "h2d_pinned_bytes": 8},
                      monkeypatch) == pytest.approx(100.0)
    assert pinned_pct({"h2d_bytes": 8, "h2d_pinned_bytes": 2},
                      monkeypatch) == pytest.approx(25.0)
    assert pinned_pct({"h2d_bytes": 8, "h2d_pinned_bytes": 0},
                      monkeypatch) == 0.0
    # A program that counts no pinned bytes, or moved nothing: no reading.
    assert pinned_pct({"h2d_bytes": 8}, monkeypatch) is None
    assert pinned_pct({"h2d_pinned_bytes": 0}, monkeypatch) is None


# -- on the card --------------------------------------------------------------------


def parent_path(a, device):
    return torch.as_tensor(a, device=device)


@pytest.mark.cuda
@pytest.mark.parametrize("n", [1, CHUNK - 1, CHUNK, CHUNK + 1,
                               7 * CHUNK // 2, 551_000_000 // 4])
def test_ring_bit_equal_to_the_pageable_copy(card, n):
    a = np.random.default_rng(n).standard_normal(n, np.float32)
    got, recs = uploads(lambda: srps.to_f32(a, card))
    (raw,) = [r["counts"]["h2d_fill_ns"] for r in tracing.STORE.spans
              if r["name"] == "srps.prepare.upload"]
    assert len(raw) == 1 and raw[0] > 0  # counted once an upload
    for r in recs:
        r["counts"].pop("h2d_fill_ns")
    assert [(r["attrs"], r["counts"]) for r in recs] == [
        ({"pinned": True}, {"h2d_bytes": a.nbytes,
                            "h2d_pinned_bytes": a.nbytes})]
    assert got.device.type == "cuda" and got.dtype == torch.float32
    assert torch.equal(got, torch.as_tensor(a, device=card))


@pytest.mark.cuda
def test_the_caller_may_overwrite_its_array_at_once(card):
    a = np.random.default_rng(1).standard_normal((5, CHUNK // 2), np.float32)
    keep = a.copy()
    got = srps.to_f32(a, card)
    a[...] = -1.0
    torch.cuda.synchronize()
    np.testing.assert_array_equal(got.cpu().numpy(), keep)


@pytest.mark.cuda
def test_arrays_larger_than_the_ring_back_to_back(card):
    n = devices.STAGE_SLOTS * CHUNK + CHUNK // 3
    rng = np.random.default_rng(2)
    a, b = (rng.standard_normal(n, np.float32) for _ in range(2))
    x, y = srps.to_f32(a, card), srps.to_f32(b, card)
    got = (x - 2 * y).cpu().numpy()
    np.testing.assert_array_equal(got, (torch.from_numpy(a) - 2
                                        * torch.from_numpy(b)).numpy())


def solve_both(route, card):
    """The final fields and traces of ``route`` at 480 x 640, and each
    capture's upload records."""
    cfg = SolverConfig()
    datas = [lambertian_dataset(480, 640, 2, n=20, c=3, seed=k)[0]
             for k in range(1 if route == "fused" else 2)]

    def go():
        if route == "fused":
            final, metrics = solver.solve(
                datas[0], cfg, RuntimeConfig(fused_outer_loop=True),
                device=card, verbose=False)
            return [final], [[m["energy"] for m in metrics
                              if "energy" in m]]
        pairs = [solver.prepare(d, cfg, card, pad_to=(480, 640))
                 for d in datas]
        finals, traces = batched.solve_batch(
            [s for _, s in pairs], [p for p, _ in pairs], 2, cfg,
            mode="lockstep")
        return finals, [t.cpu().numpy() for t in traces]

    (finals, traces), recs = uploads(go)
    fields = [[getattr(f, k).cpu().numpy() for k in FIELDS] + [
        int(f.iteration), int(f.cg_iters)] for f in finals]
    return fields, traces, recs


@pytest.mark.cuda
@pytest.mark.parametrize("route", ["fused", "lockstep"])
def test_solves_bit_equal_to_the_pageable_upload(card, route, monkeypatch):
    fields, traces, recs = solve_both(route, card)
    assert recs and all(
        r["attrs"] == {"pinned": True}
        and r["counts"]["h2d_pinned_bytes"] == r["counts"]["h2d_bytes"] > 0
        for r in recs)
    monkeypatch.setattr(srps, "upload", parent_path)
    want_fields, want_traces, _ = solve_both(route, card)
    np.testing.assert_equal(fields, want_fields)
    np.testing.assert_equal(traces, want_traces)
