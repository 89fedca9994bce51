"""The port's multi-object solves (parallel/batched.py, prepare(pad_to=...),
the comma --dsloc and --serve CLI paths) against the JAX package.

Lockstep lanes are held to the JAX lockstep solve (Pallas stencil CG in
interpret mode) at the JAX suite's own bound for lockstep against another
CG path (tests/test_pallas_cg.py:356-361): outer-iteration counts within
1 and energy traces within rtol 1e-2. Streaming lanes run the single
solve, so they equal the port's solo solves bit for bit. A padded lane
tracks its native solve as in tests/test_parallel.py:174.
"""

import io
import json
import os
import sys

import numpy as np
import pytest
import torch

from conftest import random_mask
from test_e2e import synthetic_data
from srmeetsps_cuda_tpu import cli as jcli
from srmeetsps_cuda_tpu.config import SolverConfig as JConfig
from srmeetsps_cuda_tpu.models import srps as jsrps
from srmeetsps_cuda_tpu.ops import grid as jgrid
from srmeetsps_cuda_tpu.parallel import batched as jbatched
from srmeetsps_cuda_tpu.runtime import solver as jsolver
from srmeetsps_cuda_tpu.solve import pallas_cg
from srmeetsps_cuda_tpu.solve import pallas_cg_vmem as pvm
from srmeetsps_cuda_tpu_torch import cli, interop
from srmeetsps_cuda_tpu_torch.config import SolverConfig
from srmeetsps_cuda_tpu_torch.io.image_loader import ProblemData
from srmeetsps_cuda_tpu_torch.io.mat_loader import save_mat_dataset
from srmeetsps_cuda_tpu_torch.models import srps as tsrps
from srmeetsps_cuda_tpu_torch.ops import grid as tgrid
from srmeetsps_cuda_tpu_torch.parallel import batched
from srmeetsps_cuda_tpu_torch.runtime import solver as tsolver
from srmeetsps_cuda_tpu_torch.solve import stencil_cg as sc

CPU = torch.device("cpu")
SMALL = dict(cg_max_iter=10, inpaint_iters=32, max_iterations=3)


@pytest.fixture
def interpret_full_stencil(monkeypatch):
    monkeypatch.setattr(pallas_cg, "INTERPRET", True)
    monkeypatch.setattr(pvm, "vmem_mode", lambda *a, **k: "full_stencil")


def _jax_lanes(B, h=32, w=32, sf=2):
    """B seeded JAX problems and states, as tests/test_pallas_cg.py:333."""
    probs, states = [], []
    for b in range(B):
        r = np.random.default_rng(b + 10)
        mask = random_mask(r, h, w)
        I = r.random((3, 3, h, w)).astype(np.float32)
        K = [[300.0, 0, w / 2 - 0.5], [0, 300.0, h / 2 - 0.5], [0, 0, 1]]
        z0s = r.random((h // sf, w // sf)).astype(np.float32) + 0.5
        pb = jsrps.build_problem(I, mask, K, sf, z0s)
        probs.append(pb)
        states.append(jsrps.init_state(
            pb, (r.random((h, w)).astype(np.float32) + 0.5) * mask))
    return probs, states


def _port_lanes(rng, B, shapes=None, sf=2, cfg=SolverConfig(**SMALL),
                pad_to=None):
    datas = [synthetic_data(rng, h=h, w=w, sf=sf)[0]
             for h, w in (shapes or [(32, 32)] * B)]
    pairs = [tsolver.prepare(d, cfg, CPU, pad_to=pad_to) for d in datas]
    return datas, [p for p, _ in pairs], [s for _, s in pairs]


@pytest.mark.parametrize("shape,mh,mw", [((3, 30, 17), 8, 128),
                                         ((32, 256), 8, 128),
                                         ((2, 5, 9, 7), 4, 4)])
def test_pad_to_multiple_matches_jax(shape, mh, mw):
    a = np.random.default_rng(0).standard_normal(shape).astype(np.float32)
    want, want_hw = jgrid.pad_to_multiple(a, mh, mw, value=-1.0)
    got, got_hw = tgrid.pad_to_multiple(torch.from_numpy(a), mh, mw,
                                        value=-1.0)
    assert got_hw == want_hw == shape[-2:]
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_prepare_pad_to_matches_jax(rng):
    data, _ = synthetic_data(rng, h=24, w=16, sf=2)
    jcfg, tcfg = JConfig(**SMALL), SolverConfig(**SMALL)
    jp, js = jsolver.prepare(data, jcfg, pad_to=(40, 32))
    tp, ts = tsolver.prepare(data, tcfg, CPU, pad_to=(40, 32))
    assert tp.mask.shape == (40, 32) and tp.masks.shape == (20, 16)
    for name in ("mask", "masks", "z0s", "z0t", "ktw", "xx", "yy", "SI2"):
        np.testing.assert_allclose(getattr(tp, name).numpy(),
                                   np.asarray(getattr(jp, name)), rtol=1e-5,
                                   atol=1e-5, err_msg=name)
    np.testing.assert_allclose(ts.z.numpy(), np.asarray(js.z), rtol=1e-5,
                               atol=1e-4)
    assert float(ts.z[24:].abs().max()) == 0.0
    for bad in [(41, 32), (40, 33), (20, 16)]:
        with pytest.raises(ValueError, match="pad_to"):
            tsolver.prepare(data, tcfg, CPU, pad_to=bad)


def test_stencil_cg_batched_plain_lanes_match_solo():
    lanes = []
    probs, states = _jax_lanes(3, h=24, w=32)
    tps = [interop.problem_from_numpy(p, CPU) for p in probs]
    tss = [interop.state_from_numpy(s, CPU) for s in states]
    for tp, ts in zip(tps, tss):
        op = tsrps.build_depth_operator(tp, tsrps.s_moments(tp, ts.s), ts.rho,
                                        ts.dz, 1.0)
        lanes.append((ts.z, op, tp.gm, tp.ktw, tp.z0t, tp.z0u))
    stack = lambda i: torch.stack([ln[i] for ln in lanes])  # noqa: E731
    op = type(lanes[0][1])(*(torch.stack(f) for f in
                             zip(*[ln[1] for ln in lanes])))
    gm = type(lanes[0][2])(*(torch.stack(f) for f in
                             zip(*[ln[2] for ln in lanes])))
    before = sc.stencil_cg.launches
    xb, kb, rb, eb = sc.stencil_cg(stack(0), op, gm, stack(3), stack(4),
                                   stack(5), sf=2, lam=1.0, tol=1e-4,
                                   max_iter=12)
    assert sc.stencil_cg.launches == before
    assert xb.shape == (3, 24, 32) and kb.shape == eb.shape == (3,)
    for b, ln in enumerate(lanes):
        x1, k1, r1, e1 = sc.stencil_cg_plain(*ln, sf=2, lam=1.0, tol=1e-4,
                                             max_iter=12)
        assert int(kb[b]) == int(k1)
        np.testing.assert_allclose(xb[b].numpy(), x1.numpy(), rtol=1e-6,
                                   atol=1e-6)
        np.testing.assert_allclose(float(eb[b]), float(e1), rtol=1e-6)


def test_lockstep_matches_jax_solve_batched(interpret_full_stencil):
    """At the JAX suite's own setting (2 outer iterations, the default CG
    cap): on these random, photometrically inconsistent lanes a cap of 10
    leaves the JAX package's own Pallas and jnp paths 1.2% apart, more
    than the bound; at cap 100 the port is within 3e-4 of JAX."""
    probs, states = _jax_lanes(2)
    pb, st = jbatched.stack_problems(probs), jbatched.stack_states(states)
    jcfg = JConfig(max_iterations=2, use_pallas=True)
    _, jtrace = jbatched.solve_batched(st, pb, 2, jcfg)
    tpb = interop.problem_from_numpy(jax_to_numpy(pb), CPU)
    tst = interop.state_from_numpy(jax_to_numpy(st), CPU)
    assert tpb.fx.shape == (2,) and tst.iteration.shape == (2,)
    before = sc.stencil_cg.launches
    final, ttrace = batched.solve_batched(tst, tpb, 2,
                                          SolverConfig(max_iterations=2))
    assert ttrace.shape == (2, 4) and final.z.shape == (2, 32, 32)
    assert sc.stencil_cg.launches == before  # the CPU runs the plain version
    jtrace, ttrace = np.asarray(jtrace), ttrace.numpy()
    for b in range(2):
        nj = int(np.isfinite(jtrace[b]).sum())
        nt = int(np.isfinite(ttrace[b]).sum())
        assert abs(nj - nt) <= 1 and int(final.iteration[b]) == nt
        m = min(nj, nt)
        np.testing.assert_allclose(ttrace[b, :m], jtrace[b, :m], rtol=1e-2)


def jax_to_numpy(tree):
    """A JAX NamedTuple of arrays as a dict of numpy arrays (``gm`` as a
    list), the form interop reads."""
    out = {}
    for k, v in tree._asdict().items():
        out[k] = ([np.asarray(m) for m in v] if isinstance(v, tuple)
                  else np.asarray(v))
    return out


@pytest.mark.parametrize("variant", ["pipe", "cgs", "jacobi"])
def test_lockstep_lanes_track_stream_lanes(rng, variant):
    """Lockstep and stream run the same per-lane functions; on the CPU the
    lane-batched plain CG sums each lane in its own order, so lanes agree
    to f32 roundoff (on the card, bit for bit: chip_smoke.py phases 4b and
    4f). Jacobi stacks each lane's invd into the lane-batched call."""
    cfg = SolverConfig(**SMALL, cg_variant="cgs" if variant == "cgs" else
                       "pipe", jacobi_preconditioner=variant == "jacobi")
    _, probs, states = _port_lanes(rng, 3, cfg=cfg)
    fs, ts_ = batched.solve_batch(states, probs, 2, cfg, mode="stream")
    fl, tl = batched.solve_batch(states, probs, 2, cfg, mode="lockstep")
    for b in range(3):
        assert int(fl[b].iteration) == int(fs[b].iteration)
        np.testing.assert_allclose(tl[b].numpy(), ts_[b].numpy(), rtol=1e-5)
        np.testing.assert_allclose(fl[b].z.numpy(), fs[b].z.numpy(),
                                   rtol=1e-4, atol=1e-4)


def test_streaming_lanes_equal_solo_solves(rng):
    cfg = SolverConfig(**SMALL)
    _, probs, states = _port_lanes(rng, 2)
    finals, traces = batched.solve_batched_streaming(
        batched.stack_states(states), batched.stack_problems(probs), 2, cfg)
    for b in range(2):
        solo, solo_trace = tsrps.solve_fused(states[b], probs[b], 2, cfg)
        assert finals[b].iteration == solo.iteration
        np.testing.assert_array_equal(traces[b].numpy(), solo_trace.numpy())
        assert torch.equal(finals[b].z, solo.z)


def test_stack_and_lane_roundtrip(rng):
    _, probs, states = _port_lanes(rng, 2)
    sp, ss = batched.stack_problems(probs), batched.stack_states(states)
    assert sp.I.shape[0] == 2 and sp.fx.shape == (2,)
    assert ss.iteration.dtype == torch.int32
    for b in range(2):
        p, s = batched.lane(sp, b), batched.lane(ss, b)
        assert p.fx == probs[b].fx and s.iteration == states[b].iteration
        assert torch.equal(p.gm.fwd_x, probs[b].gm.fwd_x)
        assert torch.equal(p.z0u, probs[b].z0u) and torch.equal(s.N, states[b].N)


def test_padded_lane_matches_native_solve(rng):
    """prepare(pad_to=...) pads outside the mask after preprocessing, so the
    padded solve tracks the native one (tests/test_parallel.py:174)."""
    h, w, sf, n, c = 24, 16, 2, 3, 3
    mask = random_mask(rng, h, w)
    I = rng.random((n, c, h, w)).astype(np.float32)
    K = np.array([[200.0, 0, w / 2 - 0.5], [0, 200.0, h / 2 - 0.5],
                  [0, 0, 1]], np.float32)
    z0 = np.stack([(rng.random((h // sf, w // sf)) + 1.0).astype(np.float32)
                   * 50 for _ in range(n)])
    data = ProblemData(I=I, K=K, mask=mask, sf=sf, z0=z0)
    cfg = SolverConfig(inpaint_iters=32, cg_max_iter=10, max_iterations=2)
    pa, sa = tsolver.prepare(data, cfg, CPU)
    pb, sb = tsolver.prepare(data, cfg, CPU, pad_to=(40, 32))
    fa, tra = tsrps.solve_fused(sa, pa, sf, cfg)
    fb, trb = tsrps.solve_fused(sb, pb, sf, cfg)
    n_it = fa.iteration
    assert fb.iteration == n_it
    np.testing.assert_allclose(trb[:n_it].numpy(), tra[:n_it].numpy(),
                               rtol=1e-4)
    np.testing.assert_allclose(fb.z[:h, :w].numpy(), fa.z.numpy(), rtol=1e-3,
                               atol=1e-3)
    assert float(fb.z[h:].abs().max()) == 0.0


def test_resolve_batch_mode():
    assert batched.resolve_batch_mode("stream") == "stream"
    assert batched.resolve_batch_mode("lockstep") == "lockstep"
    want = "stream" if torch.cuda.device_count() <= 1 else "lockstep"
    assert batched.resolve_batch_mode("auto") == want
    with pytest.raises(ValueError, match="batch mode"):
        batched.resolve_batch_mode("sideways")


def _mat(rng, tmp_path, name, h=32, w=32, sf=2):
    data, _ = synthetic_data(rng, h=h, w=w, sf=sf)
    path = str(tmp_path / name)
    save_mat_dataset(path, data, fmt="mat5")
    return path


def test_cli_batched_mixed_geometry_writes_per_object_outputs(rng, tmp_path,
                                                             capsys):
    a = _mat(rng, tmp_path, "a.mat")
    b = _mat(rng, tmp_path, "b.mat", h=28, w=32)
    out, metrics = tmp_path / "out", tmp_path / "m.jsonl"
    rc = cli.main(["--dsloc", f"{a},{b},{a}", "--cpu", "--batch-mode",
                   "lockstep", "--cg-max-iter", "10", "--max-iterations", "3",
                   "--dump", "--dump-format", "npz", "--dump-dir", str(out),
                   "--metrics-jsonl", str(metrics)])
    assert rc == 0
    text = capsys.readouterr().out
    assert "padding all lanes to (32, 32)" in text and "Done!" in text
    recs = [json.loads(line) for line in metrics.read_text().splitlines()]
    summary = [r for r in recs if "final_energy" in r]
    assert [r["object"] for r in summary] == ["a.mat_0", "b.mat", "a.mat_2"]
    assert summary[0]["final_energy"] == summary[2]["final_energy"]
    assert recs[-1]["batch"] == 3 and recs[-1]["mode"] == "lockstep"
    for name, h in [("a.mat_0", 32), ("b.mat", 28)]:
        st = np.load(out / name / "state_final.npz")
        mask = np.asarray(cli._loader("matlab")(a if h == 32 else b).mask)
        assert st["z"].shape == (int((mask != 0).sum()),)
        assert np.all(np.isfinite(st["z"]))


def test_cli_batched_refusals(rng, tmp_path):
    a = _mat(rng, tmp_path, "a.mat")
    b = _mat(rng, tmp_path, "b.mat", sf=4)
    with pytest.raises(SystemExit, match="matching sf"):
        cli.main(["--dsloc", f"{a},{b}", "--cpu"])
    with pytest.raises(SystemExit, match="resume-from"):
        cli.main(["--dsloc", f"{a},{a}", "--cpu", "--resume-from", "x.npz"])


def _serve_lines(main, argv, stdin, monkeypatch, capsys):
    monkeypatch.setattr(sys, "stdin", io.StringIO(stdin))
    assert main(argv) == 0
    return [json.loads(line) for line in
            capsys.readouterr().out.strip().splitlines()
            if line.startswith("{")]


def test_serve_matches_jax_serve(rng, tmp_path, monkeypatch, capsys,
                                 interpret_full_stencil):
    """One JSON line per request with the JAX keys; a single request gives
    the iterations and final energy of the JAX serve loop (Pallas stencil
    CG in interpret mode) at the bounds of test_torch_e2e.py, and a comma
    request gives each lane's single answer."""
    path = _mat(rng, tmp_path, "a.mat")
    argv = ["--serve", "--cg-max-iter", "10", "--max-iterations", "4"]
    mine = _serve_lines(cli.main, argv + ["--cpu"],
                        f"{path}\n\n{path},{path}\nmissing.mat\nquit\n",
                        monkeypatch, capsys)
    theirs = _serve_lines(jcli.main, argv + ["--pallas"], f"{path}\nquit\n",
                          monkeypatch, capsys)
    assert mine[0] == {"serving": True, "pallas": False}
    assert theirs[0]["serving"] is True
    single, multi, bad = mine[1:]
    assert set(single) == {"dsloc", "iterations", "final_energy",
                           "solve_seconds", "total_seconds"}
    assert single["iterations"] == theirs[1]["iterations"]
    np.testing.assert_allclose(single["final_energy"],
                               theirs[1]["final_energy"], rtol=5e-4)
    assert multi["batch"] == 2
    assert multi["iterations"] == [single["iterations"]] * 2
    assert multi["final_energy"] == [single["final_energy"]] * 2
    assert bad["dsloc"] == "missing.mat" and "error" in bad
