"""The port's source-chunked layout against the JAX package's, on the CPU.

* ``build_chunked_ell`` equal to JAX's, array for array, at C in {2, 3, 5},
  and with more destination slices than rows (JAX
  ``tests/test_spmm.py::test_chunked_build_more_slices_than_rows``);
* ``ChunkedDeviceGraph`` propagation at C = 3 within 1e-5 of JAX's
  ``propagate_chunked`` and of the plain ELL path (same products, other
  summation order), its gradient within 1e-5 of ``jax.grad``; bf16
  storage with f32 accumulation within 2e-2 of the scale
  (``tests/test_spmm.py:251``'s bound);
* propagation through ``propagate()``, the layout's own product;
* the knee rule: this card's constants (``ops/spmm.py``'s scan);
  ``GATHER_KNEE_ROWS = None`` gives one chunk; with the knee
  monkeypatched low ``num_chunks_for`` / ``to_device_graph_auto`` chunk
  (two chunks at most), and the ``Trainer`` then picks a
  ``ChunkedDeviceGraph`` and takes the same losses as the plain layout,
  rtol 2e-5 (``tests/test_spmm.py:218``), while the gspmd trainer keeps
  its ``ShardedGraph``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import scipy.sparse as sp
import torch

from gcn_recommendation_tpu.graph import build as jbuild
from gcn_recommendation_tpu.ops import spmm as jspmm
from gcn_recommendation_tpu_torch.config import Config
from gcn_recommendation_tpu_torch.data.synthetic import synthetic_bundle
from gcn_recommendation_tpu_torch.graph.build import (
    build_chunked_ell,
    build_normalized_adjacency,
)
from gcn_recommendation_tpu_torch.models import get_model
from gcn_recommendation_tpu_torch.ops import spmm
from gcn_recommendation_tpu_torch.train.trainer import Trainer
from test_torch_spmm import (  # noqa: F401  (one_thread: autouse, one thread)
    GRAPHS,
    _inputs,
    one_thread,
    world_of_one,
)

B = 128


@pytest.fixture(scope="module", params=sorted(GRAPHS))
def graph(request):
    args, kw = _inputs(GRAPHS[request.param])
    g = build_normalized_adjacency(*args, **kw)
    dense = sp.coo_matrix((g.weight[: g.nnz], (g.dst[: g.nnz], g.src[: g.nnz])),
                          shape=(g.num_nodes, g.num_nodes)).toarray()
    return g, dense


def _tiny_graph():
    """3 users + 2 items + 1 brand = 6 nodes: at 4 chunks, slice_rows = 2
    and slice 3 would span rows [6, 8), which build_chunked_ell clamps."""
    return build_normalized_adjacency(
        np.asarray([0, 1, 2, 0], np.int64), np.asarray([0, 1, 0, 1], np.int64), 3, 2, 1,
        item_brand_item_idx=np.asarray([0], np.int64),
        item_brand_brand_idx=np.asarray([0], np.int64), use_brand=True,
    )


def _jax_propagate(n):
    """JAX's propagation, jitted with the layout as an argument (its
    eager dispatch of the many small cells is what costs time here)."""
    return jax.jit(lambda e, graph: jspmm.propagate(e, graph, n))


def _assert_same_layout(got, want):
    (cb, cg, dg), (jb, jg, jd) = got, want
    assert len(cb) == len(jb) and len(cg) == len(jg)
    for cell_p, cell_j in zip(cb, jb):
        assert len(cell_p) == len(cell_j)
        for bp, bj in zip(cell_p, cell_j):
            assert [b.width for b in bp] == [b.width for b in bj]
            for x, y in zip(bp, bj):
                for f in ("node_ids", "nbr_idx", "nbr_w"):
                    np.testing.assert_array_equal(getattr(x, f), getattr(y, f), err_msg=f)
    for gp, gj in zip(cg, jg):
        for x, y in zip(gp, gj):
            np.testing.assert_array_equal(x, y)
    np.testing.assert_array_equal(dg, jd)


@pytest.mark.parametrize("chunks", [2, 3, 5])
def test_build_chunked_ell_equals_jax(graph, chunks):
    g, _ = graph
    _assert_same_layout(build_chunked_ell(g, chunks), jbuild.build_chunked_ell(g, chunks))


def test_build_chunked_ell_more_slices_than_rows():
    g = _tiny_graph()
    got = build_chunked_ell(g, 4)
    _assert_same_layout(got, jbuild.build_chunked_ell(g, 4))
    assert [len(gi) for gi in got[1][0]] == [2, 2, 2, 0]  # the last slice is empty
    emb = np.random.default_rng(0).standard_normal((6, 8)).astype(np.float32)
    plain = spmm.propagate(torch.from_numpy(emb), spmm.to_device_graph(g, device="cpu"))
    chunked = spmm.propagate(torch.from_numpy(emb),
                             spmm.to_device_chunked_graph(g, 4, device="cpu"))
    np.testing.assert_allclose(chunked.numpy(), plain.numpy(), rtol=1e-5, atol=1e-6)


def test_propagate_chunked_matches_jax_and_plain(graph):
    g, dense = graph
    n = g.num_nodes
    emb = np.random.default_rng(3).standard_normal((n, 16)).astype(np.float32)
    cj = jspmm.to_device_chunked_graph(g, 3)
    want = np.asarray(_jax_propagate(n)(jnp.asarray(emb), cj))
    cg = spmm.to_device_chunked_graph(g, 3, device="cpu")
    assert isinstance(cg, spmm.ChunkedDeviceGraph) and cg.num_chunks == 3
    got = spmm.propagate(torch.from_numpy(emb), cg)  # the layout's own product
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-5)
    plain = spmm.propagate(torch.from_numpy(emb), spmm.to_device_graph(g, device="cpu"))
    np.testing.assert_allclose(got.numpy(), plain.numpy(), rtol=0, atol=1e-5)
    np.testing.assert_allclose(got.numpy(), dense @ emb, rtol=0, atol=1e-5)


def test_propagate_chunked_gradient_matches_jax(graph):
    g, _ = graph
    n = g.num_nodes
    rng = np.random.default_rng(4)
    emb = rng.standard_normal((n, 8)).astype(np.float32)
    w = rng.standard_normal(emb.shape).astype(np.float32)
    cj = jspmm.to_device_chunked_graph(g, 3)
    want = jax.jit(jax.grad(lambda e, c: jnp.sum(jspmm.propagate(e, c, n) * w)))(
        jnp.asarray(emb), cj)
    cg = spmm.to_device_chunked_graph(g, 3, device="cpu")
    x = torch.from_numpy(emb).requires_grad_(True)
    (got,) = torch.autograd.grad((spmm.propagate(x, cg) * torch.from_numpy(w)).sum(), x)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=1e-5)


def test_propagate_chunked_bf16_f32_accumulation(graph):
    """bf16 storage: the partial sums accumulate in f32, so the result
    stays within one rounding of the f32 path (C+1 bf16 roundings of each
    row would not)."""
    g, dense = graph
    n = g.num_nodes
    emb = np.random.default_rng(11).standard_normal((n, 16)).astype(np.float32)
    cg = spmm.to_device_chunked_graph(g, 4, compute_dtype=torch.bfloat16, device="cpu")
    assert cg.dense_mat.dtype == torch.bfloat16
    out = spmm.propagate(torch.from_numpy(emb).to(torch.bfloat16), cg)
    assert out.dtype == torch.bfloat16
    ref = dense @ emb
    assert np.abs(out.float().numpy() - ref).max() < 2e-2 * np.abs(ref).max()
    cj = jspmm.to_device_chunked_graph(g, 4, compute_dtype=jnp.bfloat16)
    want = _jax_propagate(n)(jnp.asarray(emb, jnp.bfloat16), cj)
    np.testing.assert_allclose(out.float().numpy(), np.asarray(want, np.float32),
                               rtol=2e-2, atol=2e-2)


# ------------------------------------------------------------ the knee rule


def test_no_knee_means_one_chunk(graph, monkeypatch):
    g, _ = graph
    monkeypatch.setattr(spmm, "GATHER_KNEE_ROWS", None)
    assert spmm.knee_rows_for(64) is None
    for n in (g.num_nodes, 10**6, 10**9):
        assert spmm.num_chunks_for(n, 64) == 1
        assert spmm.num_chunks_for(n, 256, torch.bfloat16) == 1
    assert isinstance(spmm.to_device_graph_auto(g, device="cpu"), spmm.DeviceGraph)


def test_knee_rule_of_this_card():
    """The measured knee (ops/spmm.py's scan table): f32 d = 64 chunks from
    500k rows, bf16 from 1M (the same bytes), never into more than two."""
    assert spmm.GATHER_KNEE_ROWS == 500_000 and spmm.MAX_GATHER_CHUNKS == 2
    assert spmm.knee_rows_for(64) == 500_000
    assert spmm.knee_rows_for(64, torch.bfloat16) == 1_000_000
    assert spmm.knee_rows_for(128) == 250_000
    assert spmm.num_chunks_for(72_000, 64) == 1  # the books bundle
    assert spmm.num_chunks_for(400_000, 64) == 1 and spmm.num_chunks_for(600_000, 64) == 2
    assert spmm.num_chunks_for(1_000_000, 64, torch.bfloat16) == 1
    assert spmm.num_chunks_for(1_400_000, 64, torch.bfloat16) == 2
    assert spmm.num_chunks_for(10**8, 64) == 2  # three or four chunks lose


def test_knee_rule_when_the_knee_is_lowered(graph, monkeypatch):
    g, _ = graph
    monkeypatch.setattr(spmm, "GATHER_KNEE_ROWS", 1000)
    # a bytes model: the row's bytes against an f32 d = 64 row
    assert spmm.knee_rows_for(64) == 1000
    assert spmm.knee_rows_for(128) == 500
    assert spmm.knee_rows_for(64, torch.bfloat16) == 2000
    assert spmm.num_chunks_for(999, 64) == 1 and spmm.num_chunks_for(1001, 64) == 2
    assert spmm.num_chunks_for(1001, 64, torch.bfloat16) == 1
    assert spmm.num_chunks_for(5000, 64) == spmm.MAX_GATHER_CHUNKS
    monkeypatch.setattr(spmm, "GATHER_KNEE_ROWS", g.num_nodes)
    assert isinstance(spmm.to_device_graph_auto(g, device="cpu"), spmm.DeviceGraph)
    # the knee is dim-aware: at d = 256 a row holds 4x the bytes
    wide = spmm.to_device_graph_auto(g, embedding_dim=256, device="cpu")
    assert isinstance(wide, spmm.ChunkedDeviceGraph) and wide.num_chunks == 2
    emb = torch.from_numpy(np.random.default_rng(0).standard_normal(
        (g.num_nodes, 8)).astype(np.float32))
    np.testing.assert_allclose(
        spmm.propagate(emb, wide).numpy(),
        spmm.propagate(emb, spmm.to_device_graph(g, device="cpu")).numpy(),
        rtol=0, atol=1e-5)


def test_trainer_picks_chunked_above_the_knee(monkeypatch, tmp_path, capsys, request):
    b = synthetic_bundle(300, 200, 20, seed=0)
    cfg = Config(embedding_dim=8, n_layers=2, batch_size=B,
                 checkpoint_dir=str(tmp_path / "ck"), results_dir=str(tmp_path / "res"))
    rng = np.random.default_rng(0)
    rows = rng.integers(0, len(b.train), (3, B))
    users = torch.from_numpy(b.train.user_idx[rows].astype(np.int64))
    pos = torch.from_numpy(b.train.item_idx[rows].astype(np.int64))
    neg = torch.from_numpy(rng.integers(0, b.num_items, (3, B)))

    def run():
        m = get_model("LightGCN")(b.num_users, b.num_items, b.num_brands, cfg, device="cpu")
        m.init(torch.Generator().manual_seed(0))
        tr = Trainer(cfg, m, b)
        return tr, np.array([float(tr.train_step(users[s], pos[s], neg[s])) for s in range(3)])

    plain, l_plain = run()
    assert isinstance(plain.graph, spmm.DeviceGraph)
    # at d = 8 the bytes model puts the knee at 8 x GATHER_KNEE_ROWS rows
    monkeypatch.setattr(spmm, "GATHER_KNEE_ROWS", b.graph.num_nodes // 3 // 8)
    chunked, l_chunked = run()
    assert isinstance(chunked.graph, spmm.ChunkedDeviceGraph)
    assert chunked.graph.num_chunks == spmm.MAX_GATHER_CHUNKS
    assert "source-chunked gathers" in capsys.readouterr().out
    np.testing.assert_allclose(l_chunked, l_plain, rtol=2e-5)
    # the sharded trainers never chunk: under the same knee the gspmd one
    # shards the per-layer ELL graph
    from gcn_recommendation_tpu_torch.parallel.spmd import ShardedGraph, ShardedTrainer

    mesh = request.getfixturevalue("world_of_one")
    m = get_model("LightGCN")(b.num_users, b.num_items, b.num_brands, cfg, device="cpu")
    assert isinstance(ShardedTrainer(cfg, m, b, mesh).graph, ShardedGraph)
