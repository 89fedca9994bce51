"""The port's sparse-operator dumps (io/sparse_dump.py, ``--dump-operators``)
and debug dumps (io/debug.py) against the JAX package's.

The triplets are rebuilt from the port's own GradientMasks and LR mask and
must equal the JAX package's array for array on tests/test_writers.py's
fixtures; the four files a ``--dump-operators`` solve writes must equal
those JAX ``dump_operators`` writes for the same problem. The debug cases
are port copies of tests/test_debug.py's.
"""

import io

import numpy as np
import pytest
import scipy.sparse as sp
import torch

import oracle
from conftest import random_mask
from test_e2e import synthetic_data
from srmeetsps_cuda_tpu.io import sparse_dump as jdump
from srmeetsps_cuda_tpu.io import writers as jwriters
from srmeetsps_cuda_tpu.models import srps as jsrps
from srmeetsps_cuda_tpu.ops.grid import lr_mask as jlr_mask
from srmeetsps_cuda_tpu.runtime import solver as jsolver
from srmeetsps_cuda_tpu.config import SolverConfig as JConfig
from srmeetsps_cuda_tpu_torch import cli
from srmeetsps_cuda_tpu_torch.io import debug, sparse_dump, writers
from srmeetsps_cuda_tpu_torch.io.mat_loader import save_mat_dataset
from srmeetsps_cuda_tpu_torch.ops import grid as tgrid
from srmeetsps_cuda_tpu_torch.ops.gradients import GradientMasks
from srmeetsps_cuda_tpu_torch.ops.grid import masked_select_colmajor

OPERATORS = ("D", "Dx", "Dy", "KT")


def _equal(got, want):
    assert len(got) == len(want)
    for a, b in zip(got, want):
        a, b = np.asarray(a), np.asarray(b)
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)


def test_gradient_coo_equals_jax(rng):
    h, w = 20, 14
    mask = random_mask(rng, h, w)
    dx, dy, npix = sparse_dump.gradient_coo(
        GradientMasks.from_mask(torch.from_numpy(mask)), torch.from_numpy(mask))
    jdx, jdy, jnpix = jdump.gradient_coo(
        jsrps.GradientMasks.from_mask(np.asarray(mask)), mask)
    assert npix == jnpix
    _equal(dx, jdx)
    _equal(dy, jdy)


@pytest.mark.parametrize("h,w,sf", [(16, 12, 2), (16, 16, 4), (6, 9, 1)])
def test_downsample_coo_equals_jax(h, w, sf):
    _equal(sparse_dump.downsample_coo(h, w, sf), jdump.downsample_coo(h, w, sf))


def test_kt_coo_equals_jax_and_oracle(rng):
    h, w, sf = 24, 16, 2
    mask = random_mask(rng, h, w)
    masks = tgrid.lr_mask(torch.from_numpy(mask), sf)
    got = sparse_dump.kt_coo(torch.from_numpy(mask), masks, sf)
    _equal(got, jdump.kt_coo(mask, np.asarray(jlr_mask(mask, sf)), sf))
    ii, jj, kk, rows, cols = got
    _, _, KT_o = oracle.lr_mask_and_KT(mask.T.ravel(), h, w, sf)
    KT = sp.csr_matrix((kk, (ii, jj)), shape=(rows, cols))
    assert KT.shape == KT_o.shape and np.abs(KT - KT_o).max() < 1e-7


@pytest.mark.parametrize("version", ["7.3", "5"])
def test_save_sparse_mat_roundtrip(tmp_path, version):
    p = str(tmp_path / "op.mat")
    writers.save_sparse_mat(p, [0, 1, 2], [2, 0, 1], [1.0, -1.0, 0.5], 3, 3,
                            version=version)
    for load in (writers.load_mat_any, jwriters.load_mat_any):
        d = load(p)
        assert d["ii"].dtype == np.int32 and d["kk"].dtype == np.float32
        np.testing.assert_array_equal(d["ii"].ravel(), [0, 1, 2])
        np.testing.assert_array_equal(d["jj"].ravel(), [2, 0, 1])
        assert int(d["rows"].ravel()[0]) == 3
        assert int(d["cols"].ravel()[0]) == 3


@pytest.mark.parametrize("fmt", ["mat", "mat5"])
def test_cli_dump_operators_equals_jax_files(rng, tmp_path, fmt):
    """The four files of ``--cpu --dump-operators`` against JAX
    ``dump_operators`` on the problem of the same data (MAT 7.3, the JAX
    container; ``--dump-format mat5`` gives the same arrays in MAT v5)."""
    data, _ = synthetic_data(rng, h=32, w=24, sf=2)
    path = str(tmp_path / "ds.mat")
    save_mat_dataset(path, data, fmt="mat5")
    out, ref = tmp_path / "port", tmp_path / "jax"
    assert cli.main(["--dsloc", path, "--cpu", "--dump-operators",
                     "--dump-dir", str(out), "--dump-format", fmt,
                     "--max-iterations", "1", "--cg-max-iter", "2"]) == 0
    jp, _ = jsolver.prepare(data, JConfig(inpaint_iters=8))
    jdump.dump_operators(str(ref), jp, 2)
    for name in OPERATORS:
        got = writers.load_mat_any(str(out / f"{name}.mat"))
        want = jwriters.load_mat_any(str(ref / f"{name}.mat"))
        assert sorted(got) == sorted(want) == ["cols", "ii", "jj", "kk",
                                               "rows"], name
        for k in want:
            assert got[k].dtype == want[k].dtype, (name, k)
            np.testing.assert_array_equal(got[k], want[k], err_msg=name)


class TestPrintFromDevice:
    def test_float_format(self):
        s = io.StringIO()
        debug.print_from_device(torch.tensor([1.5, -2.0, 0.25]), stream=s)
        assert s.getvalue() == "[1.5 -2 0.25 ];\n"

    def test_int_format(self):
        s = io.StringIO()
        debug.print_from_device(torch.tensor([[3, 4], [5, 6]]), stream=s)
        assert s.getvalue() == "[3 4 5 6 ];\n"

    def test_bf16_prints_its_f32_values(self):
        s = io.StringIO()
        debug.print_from_device(torch.tensor([1.5, 0.1]).bfloat16(), stream=s)
        assert s.getvalue() == "[1.5 0.100098 ];\n"

    def test_masked_colmajor_pack(self, rng):
        z = rng.random((6, 5)).astype(np.float32)
        m = random_mask(rng, 6, 5, blob=False)
        s = io.StringIO()
        debug.print_from_device(torch.from_numpy(z), pack=torch.from_numpy(m),
                                stream=s)
        want = masked_select_colmajor(z, m)
        got = np.array(s.getvalue().strip("[];\n ").split(), np.float64)
        np.testing.assert_allclose(got, want, rtol=1e-5)

    def test_print_sync(self, capsys):
        """The JAX print_in_jit's line (tests/test_debug.py), printed from
        the host once the tensor is ready."""
        debug.print_sync(torch.tensor([1.0, 2.0]) * 2, name="y")
        assert capsys.readouterr().out == "y = [2 4 ];\n"


class TestWriteMatFromDevice:
    def test_float_roundtrip(self, tmp_path, rng):
        x = rng.standard_normal(17).astype(np.float32)
        p = str(tmp_path / "x.mat")
        debug.write_mat_from_device(torch.from_numpy(x), p)
        got = writers.load_mat_any(p)["x"]
        np.testing.assert_array_equal(got.ravel(), x)

    def test_int_dtype_kept(self, tmp_path):
        p = str(tmp_path / "i.mat")
        debug.write_mat_from_device(torch.arange(5), p)
        got = writers.load_mat_any(p)["x"]
        assert got.dtype == np.int32
        np.testing.assert_array_equal(got.ravel(), np.arange(5))


class TestPrintSparse:
    def test_operator_format(self):
        s = io.StringIO()
        debug.print_sparse([0, 1], [2, 0], [1.0, -1.0], 2, 3, stream=s)
        assert s.getvalue() == (
            "ii = [1 2  ];\njj = [3 1  ];\nkk = [1 -1  ];\n"
            "rows = 2, cols = 3\n")

    def test_print_operator_matches_oracle(self, rng):
        """Dx printed triplets rebuild the oracle's Dx matrix."""
        h, w = 10, 8
        mask = random_mask(rng, h, w)
        s = io.StringIO()
        debug.print_operator("Dx", _prob(mask), 2, stream=s)
        lines = s.getvalue().splitlines()
        num = lambda ln: np.array(ln.split("[")[1].rstrip(" ];").split(),  # noqa: E731
                                  np.float64)
        ii, jj, kk = num(lines[0]) - 1, num(lines[1]) - 1, num(lines[2])
        npix = int((mask != 0).sum())
        got = sp.coo_matrix((kk, (ii, jj)), shape=(npix, npix)).toarray()
        dx_o, _, _, _ = oracle.make_gradient(mask.T.ravel(), h, w)
        np.testing.assert_allclose(got, dx_o.toarray(), atol=0)

    def test_print_operator_rejects_unknown(self, rng):
        with pytest.raises(ValueError, match="unknown operator"):
            debug.print_operator("Dz", _prob(random_mask(rng, 4, 4)), 2)


def _prob(mask):
    """The fields of a problem that print_operator reads."""
    class P:
        pass

    prob = P()
    prob.mask = torch.from_numpy(mask)
    prob.gm = GradientMasks.from_mask(prob.mask)
    return prob
