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

The tiles come in two layouts.  The first tests hold the dense layout's
plain version, the later ones the compressed layout's (the partition's
edges as a CSR over the compact rows) to the same references and
tolerances, the arrays of both layouts to each other, and the host plan
that cuts dense tiles into ranges for the card's thread blocks to an
emulation of it in numpy.
"""

import dataclasses

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
from gcn_recommendation_tpu_torch.ops.spmm import propagate, to_device_graph
from helpers import dense_from_graph
from test_torch_spmm import one_thread  # noqa: F401  (autouse: one thread)

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


def _port_tiles(p, dtype=torch.float32, layout="dense"):
    return block_spmm.to_device_tiles(p, tile_dtype=dtype, device="cpu", layout=layout)


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


def _propagate_tiles(emb, residual, tiles):
    """``A_norm @ emb`` over the partition's ``TiledDeviceGraph``."""
    return propagate(emb, block_spmm.TiledDeviceGraph(base=residual, tiles=tiles))


def test_propagate_ell_tiles_matches_jax(heavy):
    gj, g, pj, p = heavy
    e = _emb(g.num_nodes, 32, seed=0)
    ref = jbs.propagate_ell_tiles(
        jnp.asarray(e), jax_device_graph(pj.residual), _jax_tiles(pj))
    out = _propagate_tiles(
        torch.from_numpy(e), to_device_graph(p.residual, device="cpu"), _port_tiles(p))
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=0, atol=1e-4)


def test_propagate_ell_tiles_equals_plain_ell(heavy):
    _, g, _, p = heavy
    e = torch.from_numpy(_emb(g.num_nodes, 32, seed=1))
    dg = to_device_graph(g, device="cpu")
    ref = propagate(e, dg)
    out = _propagate_tiles(
        e, to_device_graph(p.residual, device="cpu"), _port_tiles(p))
    np.testing.assert_allclose(out.numpy(), ref.numpy(), rtol=0, atol=1e-4)


def test_propagate_ell_tiles_gradient_matches_jax(heavy):
    gj, g, pj, p = heavy
    e = _emb(g.num_nodes, 16, seed=1)
    dres, tiles = jax_device_graph(pj.residual), _jax_tiles(pj)
    g_jax = jax.grad(
        lambda x: jnp.sum(jbs.propagate_ell_tiles(x, dres, tiles) ** 2))(jnp.asarray(e))
    x = torch.from_numpy(e).requires_grad_(True)
    out = _propagate_tiles(
        x, to_device_graph(p.residual, device="cpu"), _port_tiles(p))
    (g_port,) = torch.autograd.grad((out**2).sum(), x)
    np.testing.assert_allclose(g_port.numpy(), np.asarray(g_jax), rtol=0, atol=1e-3)


def test_bf16_tiles_close_to_f32(heavy):
    _, g, _, p = heavy
    e = torch.from_numpy(_emb(g.num_nodes, 32, seed=2))
    res = to_device_graph(p.residual, device="cpu")
    ref = _propagate_tiles(e, res, _port_tiles(p))
    out = _propagate_tiles(e, res, _port_tiles(p, torch.bfloat16))
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



# ------------------------------------------------------- the compressed layout


def _tile_rows(tile_col, step_row):
    return np.repeat(step_row, len(tile_col) // max(len(step_row), 1))


def _rebuild_tile_a(ptr, src, w, tile_col, tile_row):
    """Dense tiles from the compressed arrays; an edge goes to the first
    tile of its row block with its column block (padding tiles come last)."""
    slot = {}
    for t in range(len(tile_col) - 1, -1, -1):
        slot[(int(tile_row[t]), int(tile_col[t]))] = t
    row = np.repeat(np.arange(len(ptr) - 1), np.diff(ptr))
    t = np.array([slot[(r // 128, c // 128)] for r, c in zip(row, src)], dtype=np.int64)
    tile_a = np.zeros((len(tile_col), 128, 128), np.float32)
    tile_a[t, row % 128, src % 128] = w
    return tile_a, t


def test_partition_edge_arrays_rebuild_tile_a(heavy):
    _, _, _, p = heavy
    ptr, src, w = p.edge_row_ptr, p.edge_src, p.edge_w
    assert (ptr.dtype, src.dtype, w.dtype) == (np.int32, np.int32, np.float32)
    assert len(ptr) == p.n_row_blocks * 128 + 1 and ptr[0] == 0 and (np.diff(ptr) >= 0).all()
    assert ptr[-1] == len(src) == len(w) == p.covered_edges == np.count_nonzero(p.tile_a)
    rebuilt, t = _rebuild_tile_a(ptr, src, w, p.tile_col, _tile_rows(p.tile_col, p.step_row))
    np.testing.assert_array_equal(rebuilt, p.tile_a)
    # within a row: by tile, then column
    row = np.repeat(np.arange(len(ptr) - 1), np.diff(ptr))
    key = (row * len(p.tile_col) + t) * 128 + src % 128
    assert (np.diff(key) > 0).all()


def test_compress_tiles_equals_the_partitions_edge_arrays(heavy):
    _, _, _, p = heavy
    ptr, src, w = block_spmm.compress_tiles(
        p.tile_a, p.tile_col, _tile_rows(p.tile_col, p.step_row), p.n_row_blocks)
    np.testing.assert_array_equal(ptr, p.edge_row_ptr)
    np.testing.assert_array_equal(src, p.edge_src)
    np.testing.assert_array_equal(w, p.edge_w)


def _raw_tiles(seed=0, fill=0.05):
    """7 tiles in 4 row blocks over 3 column blocks: row block 0 holds column
    block 1 twice, row block 1 ends in an all-zero padding tile, row block 2
    holds no tile at all."""
    rng = np.random.default_rng(seed)
    tile_row = np.array([0, 0, 0, 1, 1, 3, 3], np.int32)
    tile_col = np.array([1, 1, 2, 0, 0, 2, 0], np.int32)
    a = rng.standard_normal((7, 128, 128)).astype(np.float32)
    a *= rng.random((7, 128, 128)) < fill
    a[4] = 0.0
    return a, tile_col, tile_row, 4


def test_compress_tiles_with_duplicate_column_blocks_and_padding_tiles():
    a, tile_col, tile_row, r = _raw_tiles()
    ptr, src, w = block_spmm.compress_tiles(a, tile_col, tile_row, r)
    assert ptr[-1] == len(src) == np.count_nonzero(a) and (w != 0).all()
    assert (np.diff(ptr)[2 * 128 : 3 * 128] == 0).all()  # the empty row block
    # the same operator: duplicates add up, the padding tile adds nothing
    dense = np.zeros((r * 128, 3 * 128), np.float32)
    for t in range(len(a)):
        dense[tile_row[t] * 128 :, tile_col[t] * 128 :][:128, :128] += a[t]
    from_edges = np.zeros_like(dense)
    np.add.at(from_edges, (np.repeat(np.arange(r * 128), np.diff(ptr)), src), w)
    np.testing.assert_array_equal(from_edges, dense)
    # without the duplicate the tiles themselves come back
    keep = np.array([0, 2, 3, 4, 5, 6])
    ptr, src, w = block_spmm.compress_tiles(a[keep], tile_col[keep], tile_row[keep], r)
    rebuilt, _ = _rebuild_tile_a(ptr, src, w, tile_col[keep], tile_row[keep])
    np.testing.assert_array_equal(rebuilt, a[keep])


@pytest.mark.parametrize("layout,dtype", [
    ("dense", torch.float32), ("compressed", torch.float32),
    ("dense", torch.bfloat16), ("compressed", torch.bfloat16),
])
def test_tiles_from_arrays_layouts_agree_on_raw_tiles(layout, dtype):
    a, tile_col, tile_row, r = _raw_tiles(seed=1)
    e = _emb(3 * 128 - 20, 16, seed=4)  # ragged: the last window lacks 20 rows
    tiles = block_spmm.tiles_from_arrays(a, tile_col, tile_row, 1, r, tile_dtype=dtype,
                                         device="cpu", layout=layout)
    assert tiles.layout == layout and tiles.values.dtype == dtype
    out = block_spmm.tile_matvec(torch.from_numpy(e), tiles).numpy()
    e_pad = np.concatenate([e, np.zeros((20, 16), np.float32)])
    rnd = lambda x: torch.from_numpy(x).to(dtype).float().numpy()  # noqa: E731
    want = np.zeros((r * 128, 16), np.float32)
    for t in range(len(a)):
        want[tile_row[t] * 128 :][:128] += rnd(a[t]) @ rnd(e_pad[tile_col[t] * 128 :][:128])
    np.testing.assert_allclose(out, want, rtol=0, atol=1e-5)
    assert not out[2 * 128 : 3 * 128].any()


def test_layout_auto_picks_compressed_on_a_graph_partition(heavy):
    _, _, _, p = heavy
    fill = p.covered_edges / (p.num_tiles * 128 * 128)
    assert fill < block_spmm.AUTO_DENSE_MIN_FILL
    auto = block_spmm.to_device_tiles(p, device="cpu")
    assert auto.layout == "compressed"
    with pytest.raises(ValueError, match="layout"):
        block_spmm.to_device_tiles(p, device="cpu", layout="csr")


def test_each_layout_holds_only_its_arrays(heavy):
    _, _, _, p = heavy
    c, d = _port_tiles(p, layout="compressed"), _port_tiles(p, layout="dense")
    assert c.tile_a is None and c.plan is None
    assert d.edge_row_ptr is None and d.edge_src is None and d.edge_w is None
    assert c.values is c.edge_w and d.values is d.tile_a
    assert (c.edge_row_ptr.dtype, c.edge_src.dtype, c.edge_w.dtype) == (
        torch.int32, torch.int32, torch.float32)
    assert _port_tiles(p, torch.bfloat16, "compressed").edge_w.dtype == torch.bfloat16
    for t in (c, d):
        assert (t.num_tiles, t.tiles_per_step, t.n_row_blocks) == (p.num_tiles, TB, p.n_row_blocks)
        assert torch.equal(t.tile_gather_idx, d.tile_gather_idx)
        assert torch.equal(t.row_block_nodes, d.row_block_nodes)


@pytest.mark.parametrize("d", [16, 48])
def test_compressed_reference_matches_pallas_interpret(heavy, d):
    gj, _, pj, p = heavy
    e = _emb(gj.num_nodes, d, seed=d)
    ref = np.asarray(jbs.tile_matvec(jnp.asarray(e), _jax_tiles(pj)))
    before = block_spmm.tile_matvec.launches
    out = block_spmm.tile_matvec(torch.from_numpy(e), _port_tiles(p, layout="compressed"))
    assert block_spmm.tile_matvec.launches == before  # CPU: the plain version
    assert out.dtype == torch.float32 and out.shape == (p.n_row_blocks * 128, d)
    np.testing.assert_allclose(out.numpy(), ref, rtol=0, atol=1e-5)


def test_compressed_bf16_matches_pallas_interpret(heavy):
    gj, _, pj, p = heavy
    e = _emb(gj.num_nodes, 32, seed=5)
    ref = np.asarray(jbs.tile_matvec(jnp.asarray(e), _jax_tiles(pj, jnp.bfloat16)))
    out = block_spmm.tile_matvec(
        torch.from_numpy(e), _port_tiles(p, torch.bfloat16, "compressed"))
    # bf16 x bf16 products are exact in f32: only the f32 sum order differs
    np.testing.assert_allclose(out.numpy(), ref, rtol=0, atol=1e-5)
    # and the rounding of the embedding is there: the f32 product is far off
    unrounded = block_spmm.tile_matvec(
        torch.from_numpy(e), dataclasses.replace(
            _port_tiles(p, torch.bfloat16, "compressed"),
            edge_w=_port_tiles(p, torch.bfloat16, "compressed").edge_w.float()))
    assert float((unrounded - out).abs().max()) > 1e-4


def test_propagate_ell_tiles_compressed_matches_jax(heavy):
    gj, g, pj, p = heavy
    e = _emb(g.num_nodes, 32, seed=0)
    ref = jbs.propagate_ell_tiles(
        jnp.asarray(e), jax_device_graph(pj.residual), _jax_tiles(pj))
    out = _propagate_tiles(
        torch.from_numpy(e), to_device_graph(p.residual, device="cpu"),
        _port_tiles(p, layout="compressed"))
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=0, atol=1e-4)


def test_propagate_ell_tiles_compressed_gradient_matches_jax(heavy):
    gj, g, pj, p = heavy
    e = _emb(g.num_nodes, 16, seed=1)
    dres, tiles = jax_device_graph(pj.residual), _jax_tiles(pj)
    g_jax = jax.grad(
        lambda x: jnp.sum(jbs.propagate_ell_tiles(x, dres, tiles) ** 2))(jnp.asarray(e))
    x = torch.from_numpy(e).requires_grad_(True)
    out = _propagate_tiles(
        x, to_device_graph(p.residual, device="cpu"), _port_tiles(p, layout="compressed"))
    (g_port,) = torch.autograd.grad((out**2).sum(), x)
    np.testing.assert_allclose(g_port.numpy(), np.asarray(g_jax), rtol=0, atol=1e-3)


def test_ragged_node_count_on_the_compressed_layout():
    g = synthetic_bundle(40, 30, 4, seed=0).graph
    p = partition_tiles(g, min_fill=1, tiles_per_step=2)
    assert g.num_nodes % 128 != 0
    e = np.random.default_rng(3).standard_normal((g.num_nodes, 8)).astype(np.float32)
    tiles = _port_tiles(p, layout="compressed")
    assert int(tiles.edge_src.max()) < g.num_nodes
    out = block_spmm.tile_matvec(torch.from_numpy(e), tiles).numpy()
    want = (dense_from_graph(g) - dense_from_graph(p.residual)) @ e
    ext = np.concatenate([out, np.zeros((1, 8), np.float32)])
    np.testing.assert_allclose(ext[tiles.tile_gather_idx.numpy()], want, rtol=0, atol=1e-5)
    # a source past N reads as zeros, as a ragged window does
    short = block_spmm.tile_matvec(torch.from_numpy(e[:50]), tiles).numpy()
    e0 = e.copy()
    e0[50:] = 0.0
    np.testing.assert_array_equal(short, block_spmm.tile_matvec(torch.from_numpy(e0), tiles))


# ------------------------------------------------- the dense kernel's host plan


def _emulate_plan(plan, tile_a, tile_col, e, n_row_blocks):
    """What the card's two passes compute from a plan, in numpy: each
    thread block sums its segments' tiles, a whole row block goes straight
    out, the others to partial slots that the second pass adds in order."""
    d = e.shape[1]
    out = np.full((n_row_blocks, 128, d), np.nan, np.float32)
    partials = np.full((plan["n_partials"], 128, d), np.nan, np.float32)
    seen = []
    for b in range(plan["n_blocks"]):
        for begin, end, row, slot in plan["segments"][
                plan["block_seg_ptr"][b] : plan["block_seg_ptr"][b + 1]]:
            acc = np.zeros((128, d), np.float32)
            for t in plan["list_tile"][begin:end]:
                acc += tile_a[t] @ e[tile_col[t] * 128 :][:128]
                seen.append(int(t))
            if slot < 0:
                assert np.isnan(out[row]).all()  # written once
                out[row] = acc
            else:
                assert np.isnan(partials[slot]).all()
                partials[slot] = acc
    for i, row in enumerate(plan["reduce_rows"]):
        assert np.isnan(out[row]).all()
        out[row] = partials[plan["reduce_ptr"][i] : plan["reduce_ptr"][i + 1]].sum(0)
    return out.reshape(n_row_blocks * 128, d), seen


@pytest.mark.parametrize("n_blocks", [1, 2, 3, 5, 64])
def test_plan_tile_ranges_covers_every_active_tile_once_in_order(n_blocks):
    a, tile_col, tile_row, r = _raw_tiles(seed=2)
    active = a.reshape(len(a), -1).any(axis=1)
    plan = block_spmm.plan_tile_ranges(tile_row, active, r, n_blocks)
    e = _emb(3 * 128, 8, seed=6)
    out, seen = _emulate_plan(plan, a, tile_col, e, r)
    assert seen == list(np.flatnonzero(active)) == list(plan["list_tile"])
    assert plan["n_blocks"] == min(n_blocks, int(active.sum()))
    sizes = [plan["segments"][plan["block_seg_ptr"][b + 1] - 1][1]
             - plan["segments"][plan["block_seg_ptr"][b]][0] for b in range(plan["n_blocks"])]
    assert max(sizes) - min(sizes) <= 1 and sum(sizes) == int(active.sum())
    assert all(v.dtype == np.int32 for v in plan.values() if isinstance(v, np.ndarray))
    want = np.zeros((r * 128, 8), np.float32)
    for t in range(len(a)):
        want[tile_row[t] * 128 :][:128] += a[t] @ e[tile_col[t] * 128 :][:128]
    assert not np.isnan(out).any() and not out[2 * 128 : 3 * 128].any()
    np.testing.assert_allclose(out, want, rtol=0, atol=1e-5)


def test_plan_tile_ranges_without_an_active_tile():
    plan = block_spmm.plan_tile_ranges(np.zeros(3, np.int32), np.zeros(3, bool), 2, 8)
    assert plan["n_blocks"] == 0 and plan["n_partials"] == 0 and len(plan["segments"]) == 0
    np.testing.assert_array_equal(plan["reduce_rows"], [0, 1])
    np.testing.assert_array_equal(plan["reduce_ptr"], [0, 0, 0])


def test_dense_tiles_carry_the_plan_of_the_partition(heavy):
    _, _, _, p = heavy
    tiles = _port_tiles(p)
    active = p.tile_a.reshape(p.num_tiles, -1).any(axis=1)
    want = block_spmm.plan_tile_ranges(
        _tile_rows(p.tile_col, p.step_row), active, p.n_row_blocks,
        block_spmm.DENSE_BLOCKS_PER_SM * block_spmm.DEFAULT_SM_COUNT)
    plan = tiles.plan
    assert plan.n_blocks == want["n_blocks"] and plan.n_partials == want["n_partials"]
    for key in ("list_tile", "segments", "block_seg_ptr", "reduce_rows", "reduce_ptr"):
        np.testing.assert_array_equal(getattr(plan, key).numpy(), want[key], err_msg=key)
        assert getattr(plan, key).dtype == torch.int32
    np.testing.assert_array_equal(plan.list_col.numpy(), p.tile_col[want["list_tile"]])
    assert plan.max_col == int(p.tile_col[active].max())
    assert active.sum() < p.num_tiles  # the partition's padding tiles are left out
    e = _emb(p.residual.num_nodes, 8, seed=7)
    e_pad = np.concatenate([e, np.zeros((-len(e) % 128, 8), np.float32)])
    out, _ = _emulate_plan(want, p.tile_a, p.tile_col, e_pad, p.n_row_blocks)
    ref = block_spmm.tile_matvec(torch.from_numpy(e), tiles).numpy()
    np.testing.assert_allclose(out, ref, rtol=0, atol=1e-5)
