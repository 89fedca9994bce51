"""The port's live viewer (io/liveview.py, ``--show``): port copies of
tests/test_liveview.py's cases with its fake cv2, and the solve's use of
the viewer in the fused and the stepwise loop."""

import numpy as np
import pytest
import torch

from conftest import random_mask
from test_e2e import synthetic_data
from test_liveview import FakeCV2
from srmeetsps_cuda_tpu.io import liveview as jliveview
from srmeetsps_cuda_tpu_torch.config import RuntimeConfig, SolverConfig
from srmeetsps_cuda_tpu_torch.io import liveview, writers
from srmeetsps_cuda_tpu_torch.runtime import solver as tsolver

CPU = torch.device("cpu")


@pytest.fixture
def tiny_state(rng):
    class S:
        N = torch.from_numpy(rng.standard_normal((4, 12, 16)).astype(np.float32))
        rho = torch.from_numpy(rng.random((3, 12, 16)).astype(np.float32))
    return S(), torch.from_numpy(random_mask(rng, 12, 16))


@pytest.fixture
def fake_display(monkeypatch):
    """The LiveView a solve builds gets a fake cv2 and a display."""
    cv2 = FakeCV2()
    monkeypatch.setattr(liveview.LiveView, "_default_cv2",
                        staticmethod(lambda: cv2))
    monkeypatch.setenv("DISPLAY", ":0")
    return cv2


def test_window_protocol_equals_jax(tiny_state):
    """The reference's protocol (SRPS.cu:319-338), call for call the JAX
    viewer's: three titled windows at the same offsets, then waitKey(5);
    waitKey(0) at the end; the same pixels."""
    st, mask = tiny_state
    calls = {}
    for name, mod, s, m in (
            ("port", liveview, st, mask),
            ("jax", jliveview, type("S", (), {"N": st.N.numpy(),
                                              "rho": st.rho.numpy()})(),
             mask.numpy())):
        cv2 = FakeCV2()
        v = mod.LiveView(cv2_module=cv2)
        v.set_initial(s, m)
        v.show(s, m)
        v.show(s, m)
        v.finish()
        calls[name] = cv2
    port, jax = calls["port"], calls["jax"]
    assert [t for t, _ in port.shown] == [
        "Normals-Initial", "Normals-Current-Iteration", "Albedo"] * 2
    assert [t for t, _ in port.shown] == [t for t, _ in jax.shown]
    for (_, a), (_, b) in zip(port.shown, jax.shown):
        np.testing.assert_array_equal(a, b)
    assert port.moved == jax.moved
    step = int(30 + mask.shape[0] * liveview.REFERENCE_SCALE)
    assert port.moved[:3] == [
        ("Normals-Initial", 10, 10),
        ("Normals-Current-Iteration", step, 10),
        ("Albedo", int(30 + 2 * mask.shape[0] * liveview.REFERENCE_SCALE),
         10)]
    assert port.waits == jax.waits == [5, 5, 0]


def test_bgr_of_the_encoders(tiny_state):
    st, mask = tiny_state
    cv2 = FakeCV2()
    v = liveview.LiveView(scale=1.0, cv2_module=cv2)
    v.show(st, mask)
    by_title = dict(cv2.shown)
    np.testing.assert_array_equal(
        by_title["Normals-Current-Iteration"],
        writers.normals_image(st.N, mask)[..., ::-1])
    np.testing.assert_array_equal(
        by_title["Albedo"], writers.albedo_image(st.rho, mask)[..., ::-1])


def test_headless_auto_disable(tiny_state):
    st, mask = tiny_state
    cv2 = FakeCV2(fail=True)
    v = liveview.LiveView(cv2_module=cv2)
    with pytest.warns(UserWarning, match="live view disabled"):
        v.show(st, mask)
    assert not v.enabled
    v.show(st, mask)
    v.finish()
    assert cv2.waits == []


def test_no_display_pre_check(monkeypatch, tiny_state):
    st, mask = tiny_state
    cv2 = FakeCV2()
    monkeypatch.setattr(liveview.LiveView, "_default_cv2",
                        staticmethod(lambda: cv2))
    monkeypatch.delenv("DISPLAY", raising=False)
    monkeypatch.delenv("WAYLAND_DISPLAY", raising=False)
    with pytest.warns(UserWarning, match="no display"):
        v = liveview.LiveView()
    assert not v.enabled
    v.show(st, mask)
    v.finish()
    assert cv2.shown == [] and cv2.waits == []


def test_no_cv2_disables(monkeypatch):
    monkeypatch.setattr(liveview.LiveView, "_default_cv2",
                        staticmethod(lambda: None))
    with pytest.warns(UserWarning, match="cv2 not available"):
        assert not liveview.LiveView().enabled


def test_no_show_no_block():
    cv2 = FakeCV2()
    liveview.LiveView(cv2_module=cv2).finish()
    assert cv2.waits == []


@pytest.mark.parametrize("fused", [False, True])
def test_solve_drives_the_viewer(rng, fake_display, fused):
    """``live_view=True`` shows the three windows once per outer iteration
    in both loops, with the initial normals captured first (SRPS.cu:270,
    321), and the solve's result is that of the same solve without it."""
    cv2 = fake_display
    data, _ = synthetic_data(rng, h=32, w=32, sf=2)
    cfg = SolverConfig(inpaint_iters=32, max_iterations=2, cg_max_iter=10)
    final, _ = tsolver.solve(data, cfg, RuntimeConfig(
        fused_outer_loop=fused, live_view=True), device=CPU, verbose=False)
    plain, _ = tsolver.solve(data, cfg, RuntimeConfig(
        fused_outer_loop=fused), device=CPU, verbose=False)
    n_it = final.iteration
    assert n_it >= 1 and n_it == plain.iteration
    assert torch.equal(final.z, plain.z)
    assert [t for t, _ in cv2.shown] == [
        "Normals-Initial", "Normals-Current-Iteration", "Albedo"] * n_it
    assert cv2.waits == [5] * n_it + [0]


def test_disabled_viewer_keeps_the_plain_fused_route(rng, monkeypatch):
    """A viewer that disabled itself (no display) keeps no iterates and
    runs no per-iteration output: the fused solve of a run without
    ``--show`` (the JAX package gates this on ``viewer is not None``)."""
    monkeypatch.setattr(liveview.LiveView, "_default_cv2",
                        staticmethod(FakeCV2))
    monkeypatch.delenv("DISPLAY", raising=False)
    monkeypatch.delenv("WAYLAND_DISPLAY", raising=False)
    outputs = []
    monkeypatch.setattr(tsolver, "_iteration_outputs",
                        lambda *a: outputs.append(a))
    data, _ = synthetic_data(rng, h=32, w=32, sf=2)
    cfg = SolverConfig(inpaint_iters=32, max_iterations=2, cg_max_iter=10)
    with pytest.warns(UserWarning, match="no display"):
        final, _ = tsolver.solve(data, cfg, RuntimeConfig(
            fused_outer_loop=True, live_view=True), device=CPU,
            verbose=False)
    assert final.iteration >= 1 and outputs == []
