"""The port's propagation (ELL and COO) against the JAX package and scipy.

Graphs cover the bucket widths of the width schedule (1, 2, 4, multiples
of 8 and 32), hub rows lifted into the dense matrix, and degree-0 nodes.
f32 holds to 1e-5 (same products, other summation order); bf16 storage
to 2e-2 (inputs and per-bucket outputs rounded to 8 mantissa bits).  Every
graph kind's backward is its forward on the cotangent, bit for bit, and
the symmetric backward agrees with the COO oracle's autograd one.
"""

import os

import jax.numpy as jnp
import numpy as np
import pytest
import scipy.sparse as sp
import torch

from gcn_recommendation_tpu.graph.build import (
    build_normalized_adjacency as jax_build,
)
from gcn_recommendation_tpu.ops import spmm as jspmm
from gcn_recommendation_tpu_torch.graph.build import build_normalized_adjacency
from gcn_recommendation_tpu_torch.ops import spmm

GRAPHS = {
    # uniform random degrees; brands attached
    "uniform": dict(nu=60, ni=50, nb=10, edges=500, zipf=False, dense_threshold=None),
    # power-law item degrees, hub rows in the dense matrix, isolated brands
    "powerlaw_hubs": dict(nu=200, ni=120, nb=6, edges=2400, zipf=True, dense_threshold=40),
}


def _inputs(spec, seed=7):
    rng = np.random.default_rng(seed)
    u = rng.integers(0, spec["nu"], spec["edges"])
    if spec["zipf"]:
        p = 1.0 / (np.arange(spec["ni"]) + 1.0)
        i = rng.choice(spec["ni"], spec["edges"], p=p / p.sum())
    else:
        i = rng.integers(0, spec["ni"], spec["edges"])
    # brands on the first 40 items only; the last brand stays isolated
    bi = rng.integers(0, 40, 80)
    bb = rng.integers(0, spec["nb"] - 1, 80)
    kw = dict(
        item_brand_item_idx=bi, item_brand_brand_idx=bb, pad_multiple=128,
        dense_threshold=spec["dense_threshold"],
    )
    return (u, i, spec["nu"], spec["ni"], spec["nb"]), kw


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """One torch intra-op thread, and ``OMP_NUM_THREADS=1`` for the processes
    the tests start: the test workers share the cores, and the tests' steps
    are many small ops that would otherwise wait on each other.  The port's
    other test modules import it from here (autouse, module scope)."""
    n, omp = torch.get_num_threads(), os.environ.get("OMP_NUM_THREADS")
    torch.set_num_threads(1)
    os.environ["OMP_NUM_THREADS"] = "1"
    yield
    torch.set_num_threads(n)
    if omp is None:
        del os.environ["OMP_NUM_THREADS"]
    else:
        os.environ["OMP_NUM_THREADS"] = omp


@pytest.fixture(scope="module", params=sorted(GRAPHS))
def graphs(request):
    args, kw = _inputs(GRAPHS[request.param])
    g = build_normalized_adjacency(*args, **kw)
    gj = jax_build(*args, **kw)
    dense = sp.coo_matrix(
        (g.weight[: g.nnz], (g.dst[: g.nnz], g.src[: g.nnz])),
        shape=(g.num_nodes, g.num_nodes),
    ).tocsr()
    return g, gj, dense


def test_graph_covers_widths_hubs_and_isolated_nodes():
    args, kw = _inputs(GRAPHS["powerlaw_hubs"])
    g = build_normalized_adjacency(*args, **kw)
    widths = {b.width for b in g.buckets}
    assert {1, 2, 4}.issubset(widths) and max(widths) >= 32
    assert g.dense_mat.shape[0] > 0
    deg = np.diff(g.row_ptr)
    assert (deg == 0).any()


def assert_same_graph(g, gj):
    """Index arrays equal; weights within 1e-6 relative: the JAX package
    normalizes in its native C++ ETL when that is built, which rounds
    some weights one float32 ulp away from the numpy path the port
    copies (tests/test_native.py holds the two to the same 1e-6)."""
    for f in ("src", "dst", "row_ptr", "gather_idx", "dense_node_ids"):
        np.testing.assert_array_equal(getattr(g, f), getattr(gj, f), err_msg=f)
    for f in ("weight", "dense_mat"):
        np.testing.assert_allclose(getattr(g, f), getattr(gj, f), rtol=1e-6, err_msg=f)
    assert [b.width for b in g.buckets] == [b.width for b in gj.buckets]
    for b, bj in zip(g.buckets, gj.buckets):
        np.testing.assert_array_equal(b.node_ids, bj.node_ids)
        np.testing.assert_array_equal(b.nbr_idx, bj.nbr_idx)
        np.testing.assert_allclose(b.nbr_w, bj.nbr_w, rtol=1e-6)


def test_port_graph_equals_jax_graph(graphs):
    g, gj, _ = graphs
    assert_same_graph(g, gj)


@pytest.mark.parametrize("d", [8, 64])
def test_ell_matches_jax_and_scipy_f32(graphs, d):
    g, gj, dense = graphs
    emb = np.random.default_rng(d).standard_normal((g.num_nodes, d)).astype(np.float32)
    dg = spmm.to_device_graph(g, device="cpu")
    out = spmm.propagate(torch.from_numpy(emb), dg).numpy()
    dj = jspmm.to_device_graph(gj, fuse_layers=False)
    ref = np.asarray(jspmm.propagate_ell(
        jnp.asarray(emb), dj.bucket_nbr_idx, dj.bucket_nbr_w, dj.gather_idx, dj.dense_mat
    ))
    np.testing.assert_allclose(out, ref, rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(out, dense @ emb, rtol=1e-5, atol=1e-5)


def test_coo_matches_jax_and_scipy(graphs):
    g, gj, dense = graphs
    emb = np.random.default_rng(3).standard_normal((g.num_nodes, 16)).astype(np.float32)
    dg = spmm.to_device_coo_graph(g, device="cpu")
    out = spmm.propagate(torch.from_numpy(emb), dg).numpy()
    dj = jspmm.to_device_graph(gj, include_coo=True, fuse_layers=False)
    ref = np.asarray(jspmm.propagate_coo(jnp.asarray(emb), dj.src, dj.dst, dj.weight, g.num_nodes))
    np.testing.assert_allclose(out, ref, rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(out, dense @ emb, rtol=1e-5, atol=1e-5)


def test_ell_bf16_storage(graphs):
    g, gj, dense = graphs
    emb = np.random.default_rng(5).standard_normal((g.num_nodes, 16)).astype(np.float32)
    dg = spmm.to_device_graph(g, compute_dtype=torch.bfloat16, device="cpu")
    out = spmm.propagate(torch.from_numpy(emb).to(torch.bfloat16), dg).float().numpy()
    dj = jspmm.to_device_graph(gj, compute_dtype=jnp.bfloat16, fuse_layers=False)
    ref = np.asarray(jspmm.propagate(
        jnp.asarray(emb, jnp.bfloat16), dj, g.num_nodes
    ).astype(jnp.float32))
    np.testing.assert_allclose(out, ref, rtol=2e-2, atol=2e-2)
    np.testing.assert_allclose(out, dense @ emb, rtol=2e-2, atol=2e-2)


def test_degree_zero_rows_are_zero():
    g = build_normalized_adjacency(
        np.array([0, 1]), np.array([0, 1]), 2, 2, 3, use_brand=False, pad_multiple=8
    )
    dg = spmm.to_device_graph(g, device="cpu")
    out = spmm.propagate(torch.ones((g.num_nodes, 4)), dg)
    assert torch.equal(out[-3:], torch.zeros((3, 4)))


def test_coo_view_excluded_by_default(graphs):
    """The ELL graph carries no COO view; the COO oracle graph, which
    does, differentiates through autograd's own ``index_add_`` and agrees
    with the ELL graph's symmetric backward."""
    g, _, _ = graphs
    dg = spmm.to_device_graph_auto(g, device="cpu")
    assert not hasattr(dg, "src")
    assert dg.gather_idx.dtype == torch.int64
    coo = spmm.to_device_coo_graph(g, device="cpu")
    rng = np.random.default_rng(11)
    emb = torch.from_numpy(rng.standard_normal((g.num_nodes, 8)).astype(np.float32))
    w = torch.from_numpy(rng.standard_normal((g.num_nodes, 8)).astype(np.float32))
    grads = []
    for graph in (coo, dg):
        x = emb.clone().requires_grad_(True)
        out = spmm.propagate(x, graph)
        assert (out.grad_fn.name() == "_SymmetricProductBackward") == (graph is dg)
        grads.append(torch.autograd.grad((out * w).sum(), x)[0])
    np.testing.assert_allclose(grads[0].numpy(), grads[1].numpy(), rtol=1e-5, atol=1e-5)


@pytest.fixture
def world_of_one(monkeypatch):
    """A one-rank gloo world and its (1, 1) mesh."""
    from gcn_recommendation_tpu_torch.core import distributed
    from gcn_recommendation_tpu_torch.core.mesh import MeshSpec, create_mesh

    for v in ("RANK", "WORLD_SIZE", "LOCAL_RANK", "MASTER_ADDR", "LOCAL_WORLD_SIZE"):
        monkeypatch.delenv(v, raising=False)
    distributed.initialize("cpu", mesh_spec=MeshSpec(1, 1))
    try:
        yield create_mesh(MeshSpec(1, 1))
    finally:
        distributed.shutdown()


KINDS = ["ell", "merge_skip_2", "merge_skip_3", "chunks_2", "tiles", "sharded"]


@pytest.mark.parametrize("kind", KINDS)
def test_backward_is_the_forward_on_the_cotangent(kind, request):
    """Every graph kind's gradient is its own forward product applied to
    the cotangent, bit for bit (``A_norm`` and ``sum_k A_norm^k`` are
    symmetric): per-layer ELL, merge-skip at K = 2 and 3, two source
    chunks, the tile partition (plain version) and ``ShardedGraph`` on a
    world of one."""
    from gcn_recommendation_tpu_torch.data.synthetic import synthetic_bundle
    from gcn_recommendation_tpu_torch.graph.tiles import partition_tiles
    from gcn_recommendation_tpu_torch.ops import block_spmm

    g = synthetic_bundle(300, 200, 20, seed=0).graph
    if kind.startswith("merge_skip"):
        dg, k = spmm.to_device_graph(g, device="cpu"), int(kind[-1])
        assert dg.fused
        fn = lambda x: dg.layer_sum(x, k)  # noqa: E731
    else:
        if kind == "ell":
            graph = spmm.to_device_graph(g, device="cpu")
        elif kind == "chunks_2":
            graph = spmm.to_device_chunked_graph(g, 2, device="cpu")
        elif kind == "tiles":
            part = partition_tiles(g, min_fill=4)
            assert part is not None and part.covered_edges > 0
            graph = block_spmm.TiledDeviceGraph(
                base=spmm.to_device_graph(part.residual, device="cpu", fuse_layers=False),
                tiles=block_spmm.to_device_tiles(part, device="cpu"))
        else:
            from gcn_recommendation_tpu_torch.parallel.spmd import shard_graph

            mesh = request.getfixturevalue("world_of_one")
            graph = shard_graph(spmm.to_device_graph(g, device="cpu", fuse_layers=False), mesh)
        fn = lambda x: spmm.propagate(x, graph)  # noqa: E731
    gout = torch.randn(g.num_nodes, 8, generator=torch.Generator().manual_seed(0))
    x = torch.zeros_like(gout, requires_grad=True)
    (gx,) = torch.autograd.grad(fn(x), x, gout)
    with torch.no_grad():
        assert torch.equal(gx, fn(gout))
