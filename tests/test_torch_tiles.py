"""The port's block-sparse tile partition and tile product against the JAX
package.

Same host graph in both (the JAX bundle's arrays copied into the port's
``Graph``), then: the partition arrays equal; the plain tile product
(``_tile_matvec_reference``) against the Pallas kernel in interpret mode
to 1e-5 (f32, same products, another summation order); the partitioned
propagation to 1e-4 and its gradient of ``sum(out**2)`` to 1e-3 against
``jax.grad`` (the tolerances of ``tests/test_tile_spmm.py``); bfloat16
tiles within 2e-2 of the f32 scale (8 mantissa bits in the tile values
and the window).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gcn_recommendation_tpu.data.synthetic import synthetic_bundle as jax_bundle
from gcn_recommendation_tpu.graph.tiles import partition_tiles as jax_partition
from gcn_recommendation_tpu.ops import block_spmm as jbs
from gcn_recommendation_tpu.ops.spmm import to_device_graph as jax_device_graph
from gcn_recommendation_tpu_torch.data.synthetic import synthetic_bundle
from gcn_recommendation_tpu_torch.graph.build import EllBucket, Graph
from gcn_recommendation_tpu_torch.graph.tiles import partition_tiles
from gcn_recommendation_tpu_torch.ops import block_spmm
from gcn_recommendation_tpu_torch.ops.spmm import propagate_ell, to_device_graph
from helpers import dense_from_graph

MIN_FILL, TB = 8, 4


def port_graph(gj) -> Graph:
    """The JAX package's host Graph as the port's (same arrays)."""
    return Graph(
        num_users=gj.num_users, num_items=gj.num_items, num_brands=gj.num_brands,
        nnz=gj.nnz, src=gj.src, dst=gj.dst, weight=gj.weight, row_ptr=gj.row_ptr,
        buckets=[EllBucket(b.node_ids, b.nbr_idx, b.nbr_w, b.width) for b in gj.buckets],
        gather_idx=gj.gather_idx, dense_node_ids=gj.dense_node_ids, dense_mat=gj.dense_mat,
    )


@pytest.fixture(scope="module")
def heavy():
    # the heavy-tailed bundle of tests/test_tile_spmm.py
    bj = jax_bundle(
        num_users=1500, num_items=600, num_brands=40, mean_degree=24.0, core=6,
        seed=3, style="latent", pop_zipf=0.8, deg_sigma=1.0,
    )
    gj = bj.graph
    g = port_graph(gj)
    pj = jax_partition(gj, min_fill=MIN_FILL, tiles_per_step=TB)
    p = partition_tiles(g, min_fill=MIN_FILL, tiles_per_step=TB)
    return gj, g, pj, p


def _emb(n, d, seed):
    return np.random.default_rng(seed).standard_normal((n, d)).astype(np.float32)


def _jax_tiles(pj, dtype=jnp.float32):
    return jbs.to_device_tiles(pj, tile_dtype=dtype)


def _port_tiles(p, dtype=torch.float32):
    return block_spmm.to_device_tiles(p, tile_dtype=dtype, device="cpu")


@pytest.mark.parametrize("field", [
    "tile_a", "tile_col", "step_row", "tile_gather_idx", "row_block_nodes",
])
def test_partition_arrays_equal_jax(heavy, field):
    _, _, pj, p = heavy
    assert p.num_tiles > 0
    np.testing.assert_array_equal(getattr(p, field), getattr(pj, field))
    assert getattr(p, field).dtype == getattr(pj, field).dtype


def test_partition_counts_equal_jax(heavy):
    _, g, pj, p = heavy
    assert (p.tiles_per_step, p.n_row_blocks, p.covered_edges) == (
        pj.tiles_per_step, pj.n_row_blocks, pj.covered_edges)
    assert p.covered_edges + p.residual.nnz == g.nnz


def test_residual_graph_equal_jax(heavy):
    _, _, pj, p = heavy
    r, rj = p.residual, pj.residual
    assert r.nnz == rj.nnz and len(r.buckets) == len(rj.buckets)
    for name in ("src", "dst", "weight", "row_ptr", "gather_idx", "dense_node_ids", "dense_mat"):
        np.testing.assert_array_equal(getattr(r, name), getattr(rj, name), err_msg=name)
    for b, bj in zip(r.buckets, rj.buckets):
        assert b.width == bj.width
        np.testing.assert_array_equal(b.node_ids, bj.node_ids)
        np.testing.assert_array_equal(b.nbr_idx, bj.nbr_idx)
        np.testing.assert_array_equal(b.nbr_w, bj.nbr_w)


def test_min_fill_too_high_returns_none():
    g = synthetic_bundle(300, 200, 10, mean_degree=6.0, core=3, seed=0).graph
    assert partition_tiles(g, min_fill=10_000) is None


def test_row_step_ptr_gives_each_row_blocks_steps(heavy):
    _, _, _, p = heavy
    t = _port_tiles(p)
    ptr = t.row_step_ptr.numpy()
    assert t.row_step_ptr.dtype == torch.int32 and len(ptr) == p.n_row_blocks + 1
    assert ptr[0] == 0 and ptr[-1] == len(p.step_row)
    for r in range(p.n_row_blocks):
        assert (p.step_row[ptr[r] : ptr[r + 1]] == r).all() and ptr[r + 1] > ptr[r]
    assert t.tiles_per_step == TB and t.n_row_blocks == p.n_row_blocks


@pytest.mark.parametrize("d", [16, 48])
def test_tile_matvec_reference_matches_pallas_interpret(heavy, d):
    gj, _, pj, p = heavy
    e = _emb(gj.num_nodes, d, seed=d)
    ref = np.asarray(jbs.tile_matvec(jnp.asarray(e), _jax_tiles(pj)))
    before = block_spmm.tile_matvec.launches
    out = block_spmm.tile_matvec(torch.from_numpy(e), _port_tiles(p))
    assert block_spmm.tile_matvec.launches == before  # CPU: the plain version
    assert out.dtype == torch.float32 and out.shape == (p.n_row_blocks * 128, d)
    np.testing.assert_allclose(out.numpy(), ref, rtol=0, atol=1e-5)


def test_tile_matvec_bf16_matches_pallas_interpret(heavy):
    gj, _, pj, p = heavy
    e = _emb(gj.num_nodes, 32, seed=5)
    ref = np.asarray(jbs.tile_matvec(jnp.asarray(e), _jax_tiles(pj, jnp.bfloat16)))
    out = block_spmm.tile_matvec(torch.from_numpy(e), _port_tiles(p, torch.bfloat16))
    # bf16 x bf16 products are exact in f32: only the f32 sum order differs
    np.testing.assert_allclose(out.numpy(), ref, rtol=0, atol=1e-5)


def test_propagate_ell_tiles_matches_jax(heavy):
    gj, g, pj, p = heavy
    e = _emb(g.num_nodes, 32, seed=0)
    ref = jbs.propagate_ell_tiles(
        jnp.asarray(e), jax_device_graph(pj.residual), _jax_tiles(pj))
    out = block_spmm.propagate_ell_tiles(
        torch.from_numpy(e), to_device_graph(p.residual, device="cpu"), _port_tiles(p))
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=0, atol=1e-4)


def test_propagate_ell_tiles_equals_plain_ell(heavy):
    _, g, _, p = heavy
    e = torch.from_numpy(_emb(g.num_nodes, 32, seed=1))
    dg = to_device_graph(g, device="cpu")
    ref = propagate_ell(e, dg.bucket_nbr_idx, dg.bucket_nbr_w, dg.gather_idx, dg.dense_mat)
    out = block_spmm.propagate_ell_tiles(
        e, to_device_graph(p.residual, device="cpu"), _port_tiles(p))
    np.testing.assert_allclose(out.numpy(), ref.numpy(), rtol=0, atol=1e-4)


def test_propagate_ell_tiles_gradient_matches_jax(heavy):
    gj, g, pj, p = heavy
    e = _emb(g.num_nodes, 16, seed=1)
    dres, tiles = jax_device_graph(pj.residual), _jax_tiles(pj)
    g_jax = jax.grad(
        lambda x: jnp.sum(jbs.propagate_ell_tiles(x, dres, tiles) ** 2))(jnp.asarray(e))
    x = torch.from_numpy(e).requires_grad_(True)
    out = block_spmm.propagate_ell_tiles(
        x, to_device_graph(p.residual, device="cpu"), _port_tiles(p))
    (g_port,) = torch.autograd.grad((out**2).sum(), x)
    np.testing.assert_allclose(g_port.numpy(), np.asarray(g_jax), rtol=0, atol=1e-3)


def test_bf16_tiles_close_to_f32(heavy):
    _, g, _, p = heavy
    e = torch.from_numpy(_emb(g.num_nodes, 32, seed=2))
    res = to_device_graph(p.residual, device="cpu")
    ref = block_spmm.propagate_ell_tiles(e, res, _port_tiles(p))
    out = block_spmm.propagate_ell_tiles(e, res, _port_tiles(p, torch.bfloat16))
    err = float((out - ref).abs().max())
    assert 0 < err < 2e-2 * float(ref.abs().max())


def test_ragged_node_count_reads_zero_window_rows():
    # 74 nodes: the only column block is ragged (rows 74..127 absent)
    g = synthetic_bundle(40, 30, 4, seed=0).graph
    p = partition_tiles(g, min_fill=1, tiles_per_step=2)
    assert g.num_nodes % 128 != 0 and p.num_tiles == 2  # one tile + one pad tile
    e = np.random.default_rng(3).standard_normal((g.num_nodes, 8)).astype(np.float32)
    tiles = _port_tiles(p)
    out = block_spmm.tile_matvec(torch.from_numpy(e), tiles).numpy()
    want = (dense_from_graph(g) - dense_from_graph(p.residual)) @ e
    ext = np.concatenate([out, np.zeros((1, 8), np.float32)])
    np.testing.assert_allclose(ext[tiles.tile_gather_idx.numpy()], want, rtol=0, atol=1e-5)


def test_tile_matvec_refuses_other_devices(heavy):
    _, _, _, p = heavy
    with pytest.raises(ValueError, match="unsupported device"):
        block_spmm.tile_matvec(torch.zeros((4, 8), device="meta"), _port_tiles(p))

