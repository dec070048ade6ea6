"""The port's native ETL binding against the JAX package's and numpy.

Mirrors ``tests/test_native.py``:

* the k-core mask equal to JAX's native mask and to the reference's
  numpy fixpoint at k in {1, 5, 16};
* ``build_norm_edges_native`` bit-equal to JAX's native output (the same
  source built with the same flags on the same host) and within rtol
  1e-6 of the numpy path (the native path normalizes in float32, numpy
  in float64 with one rounding: about 2 ULP);
* ``prepare``'s k-core filter and ``build_normalized_adjacency`` take the
  native path when the library loads, the numpy path when it does not;
* two processes building the library at once both load it.

Skipped only where there is no ``g++``.
"""

import os
import shutil
import subprocess
import sys

import numpy as np
import pytest

from gcn_recommendation_tpu.data import native_ext as jax_native
from gcn_recommendation_tpu.graph.build import _dedup_sum as jax_dedup_sum
from gcn_recommendation_tpu.graph.build import normalize_sym as jax_normalize_sym
from gcn_recommendation_tpu_torch.data import native_ext
from gcn_recommendation_tpu_torch.data import prepare
from gcn_recommendation_tpu_torch.graph import build
from test_torch_spmm import one_thread  # noqa: F401  (autouse: one thread)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

pytestmark = pytest.mark.skipif(shutil.which("g++") is None, reason="no g++ to build the "
                                "native library with")


@pytest.fixture(scope="module")
def jax_lib():
    """The JAX package's library.  Its first load builds it with ``make``
    in place; test workers that reach that build together can see a
    partly written file and mark it failed for the process, so a failed
    first load is retried once the file exists."""
    if not jax_native.available() and os.path.exists(jax_native._LIB_PATH):
        jax_native._load_failed = False
    assert jax_native.available(), "the JAX package's native library does not load"
    return jax_native


@pytest.fixture(autouse=True, scope="module")
def port_lib():
    """The port's library for this module's tests, which test the native
    path itself: a process whose earlier load failed (its numpy path runs
    for the rest of its life) retries the load here, and gets its own state
    back after the module."""
    saved = native_ext._lib, native_ext._load_failed
    if not native_ext.available():
        native_ext._load_failed = False
    assert native_ext.available(), "the port's native library does not load"
    yield native_ext
    native_ext._lib, native_ext._load_failed = saved


def _reference_kcore(users, items, k):
    """The reference's fixpoint loop (prepare_data.py:39-48) on codes."""
    keep = np.ones(len(users), bool)
    if k <= 1:
        return keep
    idx = np.arange(len(users))
    u, it = users.copy(), items.copy()
    while True:
        uv, uc = np.unique(u, return_counts=True)
        iv, ic = np.unique(it, return_counts=True)
        weak_u = set(uv[uc < k].tolist())
        weak_i = set(iv[ic < k].tolist())
        if not weak_u and not weak_i:
            break
        m = ~(np.isin(u, list(weak_u)) | np.isin(it, list(weak_i)))
        u, it, idx = u[m], it[m], idx[m]
    out = np.zeros(len(users), bool)
    out[idx] = True
    return out


def _edges(seed=0, nu=80, ni=60, n=700):
    rng = np.random.default_rng(seed)
    u = rng.integers(0, nu, n)
    i = rng.integers(0, ni, n) + nu
    return np.concatenate([u, i]), np.concatenate([i, u]), nu + ni


def test_library_builds_under_the_port():
    assert native_ext.available()
    path = native_ext.library_path()
    assert os.path.exists(path)
    assert os.path.dirname(path) == os.path.join(REPO, "gcn_recommendation_tpu_torch", "_build")
    assert native_ext.CXX_FLAGS == ["-O3", "-march=native", "-std=c++17", "-fPIC", "-shared"]


@pytest.mark.parametrize("k", [1, 5, 16])
def test_kcore_matches_jax_and_numpy_fixpoint(jax_lib, k):
    rng = np.random.default_rng(k)
    n = 6000
    users = rng.integers(0, 300, n)
    items = rng.integers(0, 200, n)
    got = native_ext.kcore_filter_native(users, items, k)
    np.testing.assert_array_equal(got, jax_lib.kcore_filter_native(users, items, k))
    np.testing.assert_array_equal(got, _reference_kcore(users, items, k))
    if k == 16:
        assert 0 < got.sum() < n  # the filter removes some and keeps some


def test_build_norm_edges_bit_equal_to_jax_and_close_to_numpy(jax_lib):
    rows, cols, n_nodes = _edges()
    dst, src, w = native_ext.build_norm_edges_native(rows, cols, n_nodes)
    assert (dst.dtype, src.dtype, w.dtype) == (np.int32, np.int32, np.float32)
    dst_j, src_j, w_j = jax_lib.build_norm_edges_native(rows, cols, n_nodes)
    np.testing.assert_array_equal(dst, dst_j)
    np.testing.assert_array_equal(src, src_j)
    assert w.tobytes() == w_j.tobytes()
    r_u, c_u, vals = jax_dedup_sum(rows, cols, n_nodes)
    np.testing.assert_array_equal(dst, r_u)
    np.testing.assert_array_equal(src, c_u)
    np.testing.assert_allclose(w, jax_normalize_sym(r_u, c_u, vals, n_nodes), rtol=1e-6)


def test_inputs_are_checked():
    with pytest.raises(ValueError, match="edge ids"):
        native_ext.build_norm_edges_native(np.array([0, 5]), np.array([5, 0]), 5)
    with pytest.raises(ValueError, match="equal 1-D"):
        native_ext.kcore_filter_native(np.zeros(3, np.int64), np.zeros(2, np.int64), 2)


def _record(monkeypatch, name):
    calls = []
    real = getattr(native_ext, name)

    def wrapped(*args, **kwargs):
        calls.append(name)
        return real(*args, **kwargs)

    monkeypatch.setattr(native_ext, name, wrapped)
    return calls


def test_prepare_kcore_takes_the_native_path(monkeypatch):
    rng = np.random.default_rng(1)
    users = rng.integers(0, 50, 500)
    items = rng.integers(0, 40, 500)
    calls = _record(monkeypatch, "kcore_filter_native")
    native = prepare.kcore_filter(users, items, 3)
    assert calls == ["kcore_filter_native"]
    monkeypatch.setattr(native_ext, "available", lambda: False)
    numpy_mask = prepare.kcore_filter(users, items, 3)
    assert calls == ["kcore_filter_native"]  # the numpy path ran
    np.testing.assert_array_equal(native, numpy_mask)
    np.testing.assert_array_equal(native, _reference_kcore(users, items, 3))


def test_build_normalized_adjacency_takes_the_native_path(monkeypatch):
    rng = np.random.default_rng(2)
    u, i = rng.integers(0, 90, 900), rng.integers(0, 70, 900)
    bi, bb = np.arange(70), rng.integers(0, 5, 70)
    args = (u, i, 90, 70, 5)
    kw = dict(item_brand_item_idx=bi, item_brand_brand_idx=bb, pad_multiple=128,
              dense_threshold=12)
    calls = _record(monkeypatch, "build_norm_edges_native")
    g = build.build_normalized_adjacency(*args, **kw)
    assert calls == ["build_norm_edges_native"]
    monkeypatch.setattr(native_ext, "available", lambda: False)
    g_np = build.build_normalized_adjacency(*args, **kw)
    assert calls == ["build_norm_edges_native"]
    assert g.dense_mat.shape[0] > 0  # hub rows on both paths
    for f in ("src", "dst", "row_ptr", "gather_idx", "dense_node_ids"):
        np.testing.assert_array_equal(getattr(g, f), getattr(g_np, f), err_msg=f)
    for f in ("weight", "dense_mat"):
        np.testing.assert_allclose(getattr(g, f), getattr(g_np, f), rtol=1e-6, err_msg=f)
    for b, b_np in zip(g.buckets, g_np.buckets):
        np.testing.assert_array_equal(b.nbr_idx, b_np.nbr_idx)
        np.testing.assert_allclose(b.nbr_w, b_np.nbr_w, rtol=1e-6)


def test_two_processes_building_at_once_both_load(tmp_path):
    code = (
        "import ctypes, sys\n"
        "from gcn_recommendation_tpu_torch.data import native_ext\n"
        "path = native_ext.build_library(sys.argv[1])\n"
        "lib = ctypes.CDLL(path)\n"
        "print(path, hasattr(lib, 'gcnrec_build_norm_edges'))\n"
    )
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    procs = [subprocess.Popen([sys.executable, "-c", code, str(tmp_path)], cwd=REPO, env=env,
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
             for _ in range(2)]
    outs = [p.communicate(timeout=180) for p in procs]
    for p, (out, err) in zip(procs, outs):
        assert p.returncode == 0, err
    lines = {out.strip() for out, _ in outs}
    want = native_ext.library_path(str(tmp_path))
    assert lines == {f"{want} True"}
    # one library, no temporary left behind
    assert sorted(os.listdir(tmp_path)) == sorted([os.path.basename(want), "libgcnrec.lock"])
