"""The port CLI's ``--image-dtype``, ``--nan-check``, ``--profile-dir``,
``--show`` and ``--dump-operators`` on each path, against the JAX CLI.

The single solve honours them all. On the other paths each option does
what the JAX CLI does there (JAX cli.py): a multi-object solve
(``_run_batched``) takes the image dtype and ``--profile-dir`` and ignores
``--show``, ``--dump-operators`` and ``--nan-check``; ``--sharded``
(``_run_sharded``) and ``--serve`` (``_run_serve``) take the image dtype
and ignore the other four. Also: the native PNG decoder against Pillow,
and ``sharded.dryrun``'s default device.
"""

import glob
import io
import json
import os
import shutil
import subprocess
import sys

import numpy as np
import pytest
import torch

from test_e2e import synthetic_data
from test_io import image_dataset  # noqa: F401 (fixture)
from srmeetsps_cuda_tpu import cli as jcli
from srmeetsps_cuda_tpu_torch import cli
from srmeetsps_cuda_tpu_torch.config import SolverConfig
from srmeetsps_cuda_tpu_torch.io import image_loader, liveview, native_loader
from srmeetsps_cuda_tpu_torch.io.mat_loader import save_mat_dataset
from srmeetsps_cuda_tpu_torch.models import srps as tsrps
from srmeetsps_cuda_tpu_torch.parallel import sharded
from srmeetsps_cuda_tpu_torch.runtime import solver as tsolver

CPU = torch.device("cpu")
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SMALL = ["--cg-max-iter", "10", "--max-iterations", "3"]
IGNORED = ["--show", "--dump-operators", "--nan-check"]
OPERATOR_FILES = ("D.mat", "Dx.mat", "Dy.mat", "KT.mat")


def _mat(tmp_path, name="ds.mat", seed=0, nan=False, h=32, w=32):
    """A seeded synthetic MAT v5 dataset; ``nan`` puts a NaN into image 0
    at a pixel inside the mask."""
    data, _ = synthetic_data(np.random.default_rng(seed), h=h, w=w, sf=2)
    if nan:
        r, c = np.argwhere(data.mask != 0)[0]
        data.I[0, 1, r, c] = np.nan
    path = str(tmp_path / name)
    save_mat_dataset(path, data, fmt="mat5")
    return path


def _energies(text):
    return [float(line.split("Error")[1].lstrip(" :").split()[0])
            for line in text.splitlines()
            if line.startswith("Error") or line.startswith("Iteration ")
            and "Error:" in line]


def _metrics(path):
    with open(path) as f:
        return [json.loads(line) for line in f]


@pytest.fixture
def no_viewer(monkeypatch):
    """Fails the test if any path builds a LiveView."""
    def refuse(*a, **k):
        raise AssertionError("a LiveView was built")

    monkeypatch.setattr(liveview, "LiveView", refuse)


def test_cli_bf16_matches_jax_cli(tmp_path, capsys):
    """``--cpu --image-dtype bfloat16`` against the JAX CLI's bf16 solve
    (jnp CG, stepwise on the CPU): every printed energy at the rtol of
    test_torch_sharded.py's CLI comparison (1e-3), and against the port's
    own f32 run at TestBF16Images's bound."""
    path = _mat(tmp_path)
    runs = {}
    for name, main, extra in (
            ("port", cli.main, ["--cpu", "--image-dtype", "bfloat16"]),
            ("jax", jcli.main, ["--image-dtype", "bfloat16"]),
            ("port f32", cli.main, ["--cpu"])):
        assert main(["--dsloc", path, *SMALL, *extra]) == 0
        runs[name] = _energies(capsys.readouterr().out)
    assert len(runs["port"]) == len(runs["jax"]) > 0
    np.testing.assert_allclose(runs["port"], runs["jax"], rtol=1e-3)
    np.testing.assert_allclose(runs["port"][0], runs["port f32"][0],
                               rtol=3e-2)


@pytest.mark.parametrize("loop", ["--fused", "--stepwise"])
def test_nan_check_raises_on_an_injected_nan(tmp_path, loop):
    """A NaN in the images inside the mask: the lighting keeps its previous
    s (a non-finite solve), so the s-moments and albedo phase is the first
    whose output is not finite. Without the flag the solve runs on."""
    path = _mat(tmp_path, nan=True)
    argv = ["--dsloc", path, "--cpu", *SMALL, loop]
    with pytest.raises(FloatingPointError, match="s-moments and albedo"):
        cli.main(argv + ["--nan-check"])
    assert cli.main(argv) == 0


def test_jax_nan_check_raises_on_the_same_input(tmp_path):
    """The JAX CLI's ``--nan-check`` (jax_debug_nans) raises the same
    exception type on the same file, and solves on without it. It runs in
    a fresh process: once this process has dispatched the same shapes
    without the flag, JAX's cached dispatch skips the check."""
    path = _mat(tmp_path, nan=True)
    assert jcli.main(["--dsloc", path, *SMALL]) == 0
    proc = subprocess.run(
        [sys.executable, "-m", "srmeetsps_cuda_tpu", "--dsloc", path, *SMALL,
         "--nan-check"], cwd=REPO, capture_output=True, text=True,
        timeout=300, env=dict(os.environ, JAX_PLATFORMS="cpu"))
    assert proc.returncode != 0
    assert "FloatingPointError" in proc.stderr


@pytest.mark.parametrize("loop", ["--fused", "--stepwise"])
def test_nan_check_leaves_a_clean_solve_bit_equal(tmp_path, loop):
    path = _mat(tmp_path)
    out = {}
    for flag in ([], ["--nan-check"]):
        d = tmp_path / ("checked" if flag else "plain")
        assert cli.main(["--dsloc", path, "--cpu", *SMALL, loop, "--dump",
                         "--dump-format", "npz", "--dump-dir", str(d),
                         "--metrics-jsonl", str(d / "m.jsonl"), *flag]) == 0
        out[bool(flag)] = (np.load(d / "state_final.npz"),
                           [r.get("energy") for r in _metrics(d / "m.jsonl")])
    (a, ea), (b, eb) = out[False], out[True]
    assert ea == eb
    for k in ("s", "rho", "z", "N"):
        np.testing.assert_array_equal(a[k], b[k])


def _traces(d):
    return glob.glob(os.path.join(str(d), "*.pt.trace.json"))


def test_profile_dir_writes_a_trace(tmp_path):
    path = _mat(tmp_path)
    prof = tmp_path / "prof"
    assert cli.main(["--dsloc", path, "--cpu", *SMALL, "--profile-dir",
                     str(prof)]) == 0
    (trace,) = _traces(prof)
    with open(trace) as f:
        names = {e.get("name") for e in json.load(f)["traceEvents"]}
    assert "aten::bmm" in names  # the lighting and s-moments contractions


def test_single_solve_honours_every_flag(tmp_path, monkeypatch):
    """All five on the single solve: bf16 images, the operator files, the
    trace, the viewer (a fake cv2 on a display) and the check."""
    from test_liveview import FakeCV2

    cv2 = FakeCV2()
    monkeypatch.setattr(liveview.LiveView, "_default_cv2",
                        staticmethod(lambda: cv2))
    monkeypatch.setenv("DISPLAY", ":0")
    path = _mat(tmp_path)
    out, prof = tmp_path / "out", tmp_path / "prof"
    assert cli.main(["--dsloc", path, "--cpu", *SMALL, "--image-dtype",
                     "bfloat16", *IGNORED, "--profile-dir", str(prof),
                     "--dump-dir", str(out), "--metrics-jsonl",
                     str(out / "m.jsonl")]) == 0
    assert all((out / f).exists() for f in OPERATOR_FILES)
    assert len(_traces(prof)) == 1 and cv2.waits[-1] == 0
    data = cli._loader("matlab")(path)
    cfg = SolverConfig(cg_max_iter=10, max_iterations=3,
                       image_dtype="bfloat16")
    _, metrics = tsolver.solve(data, cfg, device=CPU, verbose=False)
    assert ([r.get("energy") for r in _metrics(out / "m.jsonl")]
            == [r.get("energy") for r in metrics])


def test_batched_takes_dtype_and_profile_ignores_the_rest(tmp_path,
                                                          no_viewer):
    """JAX ``_run_batched``: the image dtype through cfg and a profiler
    trace around the solve; no viewer, no operator files and no check (a
    lane with a NaN in its images solves on)."""
    a = _mat(tmp_path, "a.mat", seed=0)
    b = _mat(tmp_path, "b.mat", seed=1, nan=True)
    out, prof = tmp_path / "out", tmp_path / "prof"
    assert cli.main(["--dsloc", f"{a},{b}", "--cpu", *SMALL, "--image-dtype",
                     "bfloat16", *IGNORED, "--profile-dir", str(prof),
                     "--dump-dir", str(out), "--metrics-jsonl",
                     str(out / "m.jsonl")]) == 0
    assert len(_traces(prof)) == 1
    assert not glob.glob(str(out / "**" / "*.mat"), recursive=True)
    recs = _metrics(out / "m.jsonl")
    got = [r["energy"] for r in recs if r.get("object") == "a.mat"
           and "iteration" in r]
    cfg = SolverConfig(cg_max_iter=10, max_iterations=3,
                       image_dtype="bfloat16")
    prob, st = tsolver.prepare(cli._loader("matlab")(a), cfg, CPU)
    final, trace = tsrps.solve_fused(st, prob, 2, cfg)
    assert got == trace[:final.iteration].tolist()


def test_sharded_takes_dtype_ignores_the_rest(tmp_path, capsys, no_viewer):
    """JAX ``_run_sharded``: the image dtype through prepare; no viewer, no
    operator files, no trace, no check. Held to the JAX CLI's bf16
    ``--sharded 2`` at test_torch_sharded.py's CLI bound (rtol 1e-3)."""
    path = _mat(tmp_path)
    out, prof = tmp_path / "out", tmp_path / "prof"
    argv = ["--dsloc", path, "--sharded", "2", *SMALL, "--image-dtype",
            "bfloat16"]
    assert cli.main(argv + ["--cpu", *IGNORED, "--profile-dir", str(prof),
                            "--dump-dir", str(out)]) == 0
    mine = _energies(capsys.readouterr().out)
    assert not prof.exists() and not out.exists()
    assert jcli.main(argv) == 0
    theirs = _energies(capsys.readouterr().out)
    assert len(mine) == len(theirs) > 0
    np.testing.assert_allclose(mine, theirs, rtol=1e-3)
    # A NaN input solves on: the check is not the sharded path's.
    nan_path = _mat(tmp_path, "nan.mat", nan=True)
    assert cli.main(["--dsloc", nan_path, "--sharded", "2", "--cpu", *SMALL,
                     "--nan-check"]) == 0


def test_serve_takes_dtype_ignores_the_rest(tmp_path, monkeypatch, capsys,
                                            no_viewer):
    """JAX ``_run_serve``: the image dtype through cfg (a single and a comma
    request answer as the bf16 runtime solve), nothing of the runtime
    options; a NaN request is answered, not refused."""
    path = _mat(tmp_path)
    nan_path = _mat(tmp_path, "nan.mat", nan=True)
    out, prof = tmp_path / "out", tmp_path / "prof"
    monkeypatch.setattr(sys, "stdin", io.StringIO(
        f"{path}\n{path},{path}\n{nan_path}\nquit\n"))
    assert cli.main(["--serve", "--cpu", *SMALL, "--image-dtype", "bfloat16",
                     *IGNORED, "--profile-dir", str(prof), "--dump-dir",
                     str(out)]) == 0
    lines = [json.loads(line) for line in
             capsys.readouterr().out.strip().splitlines()
             if line.startswith("{")]
    single, multi, nan = lines[1:]
    assert not prof.exists() and not out.exists()
    cfg = SolverConfig(cg_max_iter=10, max_iterations=3,
                       image_dtype="bfloat16")
    final, _ = tsolver.solve(cli._loader("matlab")(path), cfg,
                             tsolver.RuntimeConfig(fused_outer_loop=True),
                             device=CPU, verbose=False)
    assert single["iterations"] == final.iteration
    assert single["final_energy"] == float(final.energy)
    assert multi["final_energy"] == [single["final_energy"]] * 2
    assert "error" not in nan and nan["dsloc"] == nan_path


def test_native_loader_matches_pil_if_built(image_dataset, tmp_path):  # noqa: F811
    """The port's binding of native/pngio.cpp, built into tmp_path with
    g++ and libpng, decodes tests/test_io.py's images as Pillow does, and
    the image loader reads the same dataset through it."""
    from PIL import Image

    cxx = shutil.which("g++")
    lib = str(tmp_path / "libpngio.so")
    if cxx is None or subprocess.run(
            [cxx, "-O2", "-fPIC", "-std=c++17", "-shared", "-o", lib,
             os.path.join(REPO, "native", "pngio.cpp"), "-lpng", "-lz"],
            capture_output=True).returncode != 0:
        pytest.skip("native/pngio.cpp does not build here (g++, libpng)")
    path, rgbs, depths, *_ = image_dataset
    for f, want in ((path / "RGB" / "I_1.png", rgbs[0]),
                    (path / "Depth" / "z0_1.png", depths[0]),
                    (path / "mask.png", None)):
        got = native_loader.decode_png(str(f), lib_path=lib)
        with Image.open(f) as im:
            pil = np.asarray(im)
        assert got.dtype == pil.dtype
        np.testing.assert_array_equal(got, pil)
        if want is not None:
            np.testing.assert_array_equal(got, want)
    assert native_loader.decode_png(str(path / "mask.png"),
                                    lib_path=str(tmp_path / "none.so")) is None


def test_image_loader_prefers_the_native_decoder(image_dataset,  # noqa: F811
                                                 monkeypatch):
    """``_decode_png`` takes the native decoder's array for each of the 7
    files when it gives one, and Pillow's when it gives None (the library
    is not built): the same dataset either way."""
    from PIL import Image

    path = str(image_dataset[0])
    monkeypatch.setattr(native_loader, "decode_png", lambda p: None)
    pil = image_loader.load_image_dataset(path)
    calls = []

    def native(p):
        calls.append(p)
        with Image.open(p) as im:
            return np.asarray(im)

    monkeypatch.setattr(native_loader, "decode_png", native)
    data = image_loader.load_image_dataset(path)
    assert len(calls) == 3 + 1 + 3  # RGB, mask, Depth
    for k in ("I", "mask", "z0"):
        np.testing.assert_array_equal(getattr(data, k), getattr(pil, k))


def test_dryrun_defaults_to_the_card():
    """``sharded.dryrun`` runs on the CUDA device unless asked for the CPU;
    without one it raises as ``device.resolve_device`` does."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="--cpu"):
        sharded.dryrun(2)
