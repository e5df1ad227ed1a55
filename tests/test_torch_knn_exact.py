"""The port's exact 3-NN (``luciddreamer_tpu_torch/points/knn_exact.py``)
against the JAX package's host extension, ``luciddreamer_tpu.native.
mean_sq_dist_3nn_cpu`` (a KD-tree), and a float64 brute force, on the CPU.

The KD-tree is built from ``luciddreamer_tpu/native/knn_native.cpp`` with
the package's own g++ flags into the test's tmp dir and handed to
``native`` as its loaded library, so that no test writes the shared
``_knn_native.so`` while ``tests/test_native.py`` builds it in another
worker.

Tolerances: against the KD-tree rtol 1e-5, atol 1e-7 (its g++ -O3
-march=native build may fuse the sum of squares into FMAs; the plain
version sums unfused products, as the kernel does with -fmad=false);
against the float64 brute force 1e-6 relative (three fp32 products and
two sums round to a few 1e-7), which the matrix-product formula of
``points/knn.py`` misses.
"""
import ctypes
import subprocess

import numpy as np
import pytest
import torch

from luciddreamer_tpu import native
from luciddreamer_tpu_torch import points as port_points
from luciddreamer_tpu_torch.points import knn_exact
from luciddreamer_tpu_torch.points.knn import mean_sq_dist_3nn
from luciddreamer_tpu_torch.render import kernels
from tests.port_helpers import one_torch_thread  # noqa: F401  (a fixture)

pytestmark = pytest.mark.usefixtures("one_torch_thread")


def _cloud(name):
    rng = np.random.default_rng(17)
    if name == "normal500":
        p = rng.normal(size=(500, 3))
    elif name == "normal3000":
        p = rng.normal(size=(3000, 3))
    elif name == "offset1e3":          # far from the origin: the formula cancels
        p = rng.normal(size=(1000, 3)) + 1e3
    elif name == "duplicates":         # every point three times
        p = np.repeat(rng.normal(size=(60, 3)), 3, axis=0)
    else:                              # "n0" ... "n4"
        p = rng.normal(size=(int(name[1:]), 3))
    return p.astype(np.float32)


def _brute_force64(p):
    """float64 mean of the 3 smallest squared distances to other points,
    missing neighbours as 0."""
    n = p.shape[0]
    if n <= 1:
        return np.zeros(n)
    q = p.astype(np.float64)
    d = ((q[:, None] - q[None]) ** 2).sum(-1)
    np.fill_diagonal(d, np.inf)
    part = np.sort(d, axis=1)[:, :3]
    part[~np.isfinite(part)] = 0.0
    return part.sum(1) / 3.0


def _rel(out, ref):
    return float((np.abs(out - ref) / np.maximum(np.abs(ref), 1e-30)).max())


@pytest.fixture(scope="module")
def kdtree_lib(tmp_path_factory):
    """``knn_native.cpp`` built as ``native`` builds it, in a private dir."""
    src = native.__file__.replace("__init__.py", "knn_native.cpp")
    out = str(tmp_path_factory.mktemp("native") / "_knn_native.so")
    subprocess.run(["g++", "-O3", "-march=native", "-shared", "-fPIC",
                    "-std=c++17", src, "-o", out], check=True,
                   capture_output=True)
    lib = ctypes.CDLL(out)
    lib.mean_sq_dist_3nn.argtypes = [ctypes.POINTER(ctypes.c_float),
                                     ctypes.c_int64,
                                     ctypes.POINTER(ctypes.c_float)]
    return lib


@pytest.fixture
def kdtree(monkeypatch, kdtree_lib):
    monkeypatch.setattr(native, "_LIB", kdtree_lib)
    return native.mean_sq_dist_3nn_cpu


@pytest.mark.parametrize("name", ["normal500", "normal3000", "offset1e3",
                                  "duplicates", "n0", "n1", "n2", "n3", "n4"])
def test_plain_matches_the_kdtree(kdtree, name):
    p = _cloud(name)
    out = knn_exact.mean_sq_dist_3nn_exact_torch(torch.as_tensor(p))
    assert out.dtype == torch.float32 and out.shape == (p.shape[0],)
    np.testing.assert_allclose(out.numpy(), kdtree(p), rtol=1e-5, atol=1e-7)
    if p.shape[0] <= 1:
        assert not out.numpy().any()


@pytest.mark.parametrize("name", ["normal500", "normal3000", "offset1e3",
                                  "duplicates"])
def test_exact_where_the_formula_is_not(kdtree, name):
    p = _cloud(name)
    ref = _brute_force64(p)
    exact = knn_exact.mean_sq_dist_3nn_exact(torch.as_tensor(p)).numpy()
    formula = mean_sq_dist_3nn(torch.as_tensor(p)).numpy()
    assert _rel(exact, ref) <= 1e-6
    assert _rel(kdtree(p), ref) <= 1e-6
    assert _rel(formula, ref) > 1e-6


def test_small_clouds_count_missing_neighbours_as_zero():
    p = torch.tensor([[0.0, 0.0, 0.0], [3.0, 0.0, 0.0], [0.0, 4.0, 0.0]])
    np.testing.assert_array_equal(
        knn_exact.mean_sq_dist_3nn_exact_torch(p[:2]).numpy(),
        np.float32([9.0 / 3, 9.0 / 3]))
    np.testing.assert_array_equal(
        knn_exact.mean_sq_dist_3nn_exact_torch(p).numpy(),
        np.float32([(9.0 + 16.0) / 3, (9.0 + 25.0) / 3, (16.0 + 25.0) / 3]))


def test_wrapper_runs_the_plain_version_on_cpu_tensors():
    p = torch.as_tensor(_cloud("normal500"))
    before = knn_exact.mean_sq_dist_3nn_exact.launches
    out = port_points.mean_sq_dist_3nn_exact(p)
    assert knn_exact.mean_sq_dist_3nn_exact.launches == before
    ref = knn_exact.mean_sq_dist_3nn_exact_torch(p, row_block=64,
                                                 col_block=128)
    assert torch.equal(out, ref)            # the blocks change nothing
    rows = torch.tensor([499, 0, 250, 7])
    assert torch.equal(knn_exact.mean_sq_dist_3nn_exact_torch(p, rows), ref[rows])


def test_wrapper_raises_without_the_card(monkeypatch, tmp_path):
    """No fallback: a CUDA request with no card, another device, or a
    failed build of the kernel raises."""
    if not torch.cuda.is_available():
        with pytest.raises((RuntimeError, AssertionError)):
            knn_exact.mean_sq_dist_3nn_exact(torch.zeros((4, 3), device="cuda"))
    with pytest.raises(ValueError, match="unsupported device"):
        knn_exact.mean_sq_dist_3nn_exact(torch.zeros((4, 3), device="meta"))
    monkeypatch.setattr(kernels, "BUILD_DIR", tmp_path)
    monkeypatch.setattr(kernels, "_nvcc", lambda: "false")
    with pytest.raises(RuntimeError, match="nvcc failed"):
        kernels.build("knn3_exact")
    assert not list(tmp_path.glob("*.so"))
