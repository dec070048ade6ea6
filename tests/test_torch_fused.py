"""The port's merge-skip propagation against the JAX package's, on the CPU.

* the permuted views of ``to_device_graph(fuse_layers=True)`` equal to
  JAX's, built from the same host graph;
* ``DeviceGraph.layer_sum`` at 2 and 3 layers: f32 within 1e-5 of JAX's
  ``propagate_sum_ell`` (same
  products, other summation order), its gradient within 1e-5 of
  ``jax.grad``, bf16 storage within rtol 2e-2 of JAX's bf16 (inputs and
  parts tables rounded to 8 mantissa bits; the sums stay f32), f32 out;
* ``LightGCN`` and ``LightGCN_Fusion`` forward and gradients, fused
  against JAX fused, within 2e-5 (JAX's own limit for fused against
  per-layer, ``tests/test_spmm.py::test_model_apply_fused_matches_per_layer``),
  and fused against the port's per-layer path, row-padded too;
* which graph kind each caller builds: the default ``Trainer`` a fused
  ``DeviceGraph`` (a ``ChunkedDeviceGraph`` above the knee, tiles or not),
  the tile residual, ``Retriever``, ``ShardedTrainer`` and ``HaloTrainer``
  none with the views;
* a port ``Trainer``, fused against per-layer, 3 steps with per-step
  losses within rtol 2e-5 (JAX's limit, ``tests/test_spmm.py:214``).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gcn_recommendation_tpu.config import Config as JaxConfig
from gcn_recommendation_tpu.models import get_model as jax_get_model
from gcn_recommendation_tpu.ops import spmm as jspmm
from gcn_recommendation_tpu_torch import serve
from gcn_recommendation_tpu_torch.config import Config
from gcn_recommendation_tpu_torch.data.synthetic import synthetic_bundle
from gcn_recommendation_tpu_torch.graph.build import build_normalized_adjacency
from gcn_recommendation_tpu_torch.models import get_model
from gcn_recommendation_tpu_torch.models.convert import params_from_jax
from gcn_recommendation_tpu_torch.ops import spmm
from gcn_recommendation_tpu_torch.ops.block_spmm import TiledDeviceGraph
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
    return build_normalized_adjacency(*args, **kw)


@pytest.fixture(scope="module")
def bundle():
    return synthetic_bundle(300, 200, 20, seed=0)


def _views(dg):
    """The JAX or port device graph's fused views as numpy."""
    return ([np.asarray(a) for a in dg.bucket_nbr_idx_perm], np.asarray(dg.dense_mat_perm))


def _sum_args(dg):
    return (dg.bucket_nbr_idx, dg.bucket_nbr_w, dg.bucket_nbr_idx_perm, dg.gather_idx,
            dg.dense_mat, dg.dense_mat_perm)


def test_perm_views_equal_jax(graph):
    g = graph
    dg = spmm.to_device_graph(g, device="cpu")
    dj = jspmm.to_device_graph(g, fuse_layers=True)  # the port's host graph, JAX's views
    assert dg.fused and len(dg.bucket_nbr_idx_perm) == len(g.buckets)
    assert all(t.dtype == torch.int64 for t in dg.bucket_nbr_idx_perm)
    (idx_p, dense_p), (idx_j, dense_j) = _views(dg), _views(dj)
    for a, b in zip(idx_p, idx_j):
        np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(dense_p, dense_j)
    # the bf16 hub matrix is JAX's rounded the same way
    dg16 = spmm.to_device_graph(g, compute_dtype=torch.bfloat16, device="cpu")
    dj16 = jspmm.to_device_graph(g, compute_dtype=jnp.bfloat16, fuse_layers=True)
    np.testing.assert_array_equal(dg16.dense_mat_perm.float().numpy(),
                                  np.asarray(dj16.dense_mat_perm, np.float32))


def test_unfused_graph_has_no_views(graph):
    dg = spmm.to_device_graph(graph, device="cpu", fuse_layers=False)
    assert dg.bucket_nbr_idx_perm == () and dg.dense_mat_perm is None and not dg.fused


@pytest.mark.parametrize("layers", [2, 3])
def test_propagate_sum_ell_matches_jax(graph, layers):
    g = graph
    emb = np.random.default_rng(layers).standard_normal((g.num_nodes, 16)).astype(np.float32)
    dj = jspmm.to_device_graph(g, fuse_layers=True)
    want = np.asarray(jspmm.propagate_sum_ell(layers, jnp.asarray(emb), *_sum_args(dj)))
    dg = spmm.to_device_graph(g, device="cpu")
    got = dg.layer_sum(torch.from_numpy(emb), layers)
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-5)
    # and the sum of per-layer propagations of the port
    x, acc = torch.from_numpy(emb), torch.zeros(g.num_nodes, 16)
    for _ in range(layers):
        x = spmm.propagate(x, dg)
        acc = acc + x
    np.testing.assert_allclose(got.numpy(), acc.numpy(), rtol=0, atol=1e-5)


@pytest.mark.parametrize("layers", [2, 3])
def test_propagate_sum_ell_gradient_matches_jax(graph, layers):
    g = graph
    rng = np.random.default_rng(10 + layers)
    emb = rng.standard_normal((g.num_nodes, 8)).astype(np.float32)
    w = rng.standard_normal(emb.shape).astype(np.float32)
    dj = jspmm.to_device_graph(g, fuse_layers=True)
    want = jax.grad(lambda e: jnp.sum(
        jspmm.propagate_sum_ell(layers, e, *_sum_args(dj)) * w))(jnp.asarray(emb))
    dg = spmm.to_device_graph(g, device="cpu")
    x = torch.from_numpy(emb).requires_grad_(True)
    out = dg.layer_sum(x, layers)
    (got,) = torch.autograd.grad((out * torch.from_numpy(w)).sum(), x)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=1e-5)


def test_propagate_sum_ell_bf16_matches_jax(graph):
    g = graph
    emb = np.random.default_rng(5).standard_normal((g.num_nodes, 8)).astype(np.float32)
    dj = jspmm.to_device_graph(g, compute_dtype=jnp.bfloat16, fuse_layers=True)
    want = jspmm.propagate_sum_ell(2, jnp.asarray(emb, jnp.bfloat16), *_sum_args(dj))
    assert want.dtype == jnp.float32
    dg = spmm.to_device_graph(g, compute_dtype=torch.bfloat16, device="cpu")
    x = torch.from_numpy(emb).to(torch.bfloat16).requires_grad_(True)
    got = dg.layer_sum(x, 2)
    assert got.dtype == torch.float32  # the f32 accumulator comes out
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), rtol=2e-2, atol=2e-2)
    # the backward hands the input's dtype back
    (gx,) = torch.autograd.grad(got.sum(), x)
    assert gx.dtype == torch.bfloat16 and torch.isfinite(gx.float()).all()


# ------------------------------------------------------------------ models


def _models(bundle, name, **kw):
    b = bundle
    base = dict(embedding_dim=16, n_layers=3, model_name=name)
    base.update(kw)
    content = None
    if name == "LightGCN_Fusion":
        content = np.random.default_rng(7).standard_normal((b.num_items, 24)).astype(np.float32)
    m = get_model(name)(b.num_users, b.num_items, b.num_brands, Config(**base),
                        pretrained_item_emb=content, device="cpu")
    jm = jax_get_model(name)(b.num_users, b.num_items, b.num_brands, JaxConfig(**base),
                             pretrained_item_emb=content)
    return m, jm


def _loss_torch(out):
    fu, fi, fb, u0, i0 = out
    return (fu[:4] * fi[:4]).sum() + fb.sum() + 1e-3 * (u0 * u0).sum()


def _loss_jax(out):
    fu, fi, fb, u0, i0 = out
    return jnp.sum(fu[:4] * fi[:4]) + jnp.sum(fb) + 1e-3 * jnp.sum(u0 * u0)


@pytest.mark.parametrize("name", ["LightGCN", "LightGCN_Fusion"])
def test_model_fused_matches_jax_fused(bundle, name):
    b = bundle
    m, jm = _models(bundle, name)
    jp = jm.init(jax.random.PRNGKey(1))
    dj = jspmm.to_device_graph(b.graph, fuse_layers=True)  # the port's host graph
    want = jm.apply(jp, dj)
    want_g = jax.grad(lambda p: _loss_jax(jm.apply(p, dj)))(jp)
    m.load_params(params_from_jax({k: np.asarray(v) for k, v in jp.items()}, m, device="cpu"))
    out = m(spmm.to_device_graph(b.graph, device="cpu"))
    for got, w in zip(out, want):
        np.testing.assert_allclose(got.detach().numpy(), np.asarray(w), rtol=0, atol=2e-5)
    _loss_torch(out).backward()
    for k in m.trainable_keys:
        np.testing.assert_allclose(getattr(m, k).grad.numpy(), np.asarray(want_g[k]),
                                   rtol=0, atol=2e-5, err_msg=k)


@pytest.mark.parametrize("name", ["LightGCN", "LightGCN_Fusion"])
@pytest.mark.parametrize("row_multiple", [1, 48])
def test_model_fused_matches_per_layer(bundle, name, row_multiple):
    """The fused branch against the per-layer branch of the same model:
    on the logical graph and on the row-padded one (``set_row_multiple``,
    every table padded at 48)."""
    m, _ = _models(bundle, name)
    m.init(torch.Generator().manual_seed(0))
    if row_multiple > 1:
        m.set_row_multiple(row_multiple)
        assert m.is_row_padded
    g = m.padded_graph(bundle.graph)
    results = {}
    for fuse in (True, False):
        m.zero_grad(set_to_none=True)
        dg = spmm.to_device_graph(g, device="cpu", fuse_layers=fuse)
        assert dg.fused == fuse
        out = m(dg)
        _loss_torch(out).backward()
        results[fuse] = ([t.detach().clone() for t in out],
                         {k: getattr(m, k).grad.clone() for k in m.trainable_keys})
    for a, b in zip(results[True][0], results[False][0]):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=0, atol=2e-5)
    for k in m.trainable_keys:
        np.testing.assert_allclose(results[True][1][k].numpy(), results[False][1][k].numpy(),
                                   rtol=0, atol=2e-5, err_msg=k)


def test_one_layer_and_coo_take_the_per_layer_path(bundle):
    """Fusion needs 2 layers or more and a graph with the views; otherwise
    the layer mean runs layer by layer: the views are ignored at 1 layer,
    and the COO oracle graph, which has none, runs the running f32 sum."""
    b = bundle
    m, _ = _models(bundle, "LightGCN", n_layers=1)
    m.init(torch.Generator().manual_seed(0))
    with torch.no_grad():
        got = m(spmm.to_device_graph(b.graph, device="cpu"))
        want = m(spmm.to_device_graph(b.graph, device="cpu", fuse_layers=False))
    for a, w in zip(got, want):
        assert torch.equal(a, w)
    m, _ = _models(bundle, "LightGCN", n_layers=3)
    m.init(torch.Generator().manual_seed(0))
    coo = spmm.to_device_coo_graph(b.graph, device="cpu")
    with torch.no_grad():
        got = torch.cat(m(coo)[:3])
        ego = torch.cat(m._initial_tables())
        acc, x = ego.float(), ego
        for _ in range(3):
            x = spmm.propagate_coo(x, coo.src, coo.dst, coo.weight, coo.num_nodes)
            acc = acc + x.float()
    assert torch.equal(got, acc / 4)


# ------------------------------------------------- which caller builds what


def _cfg(tmp, **kw):
    base = dict(embedding_dim=16, n_layers=2, batch_size=B, checkpoint_dir=str(tmp / "ck"),
                results_dir=str(tmp / "res"))
    base.update(kw)
    return Config(**base)


def _model(bundle, cfg):
    b = bundle
    m = get_model("LightGCN")(b.num_users, b.num_items, b.num_brands, cfg, device="cpu")
    m.init(torch.Generator().manual_seed(0))
    return m


class PerLayer(Trainer):
    """The default trainer's per-layer twin: the ELL graph without the
    merge-skip views."""

    def _device_graph(self):
        return spmm.to_device_graph(self.model.padded_graph(self.bundle.graph),
                                    device=self.device, fuse_layers=False)


def test_default_trainer_fuses_and_tile_residual_does_not(bundle, tmp_path, capsys,
                                                          monkeypatch):
    """The graph kind each single-device trainer builds, in the JAX
    package's order: chunks above the knee (tiles asked for or not), then
    the tile partition, then the fused ELL graph."""
    tr = Trainer(_cfg(tmp_path), _model(bundle, _cfg(tmp_path)), bundle)
    assert isinstance(tr.graph, spmm.DeviceGraph) and tr.graph.fused
    cfg = _cfg(tmp_path, tile_spmm=True, tile_min_fill=32)
    tiles = Trainer(cfg, _model(bundle, cfg), bundle)
    assert isinstance(tiles.graph, TiledDeviceGraph) and not tiles.graph.base.fused
    assert not PerLayer(_cfg(tmp_path), _model(bundle, _cfg(tmp_path)), bundle).graph.fused
    assert "source-chunked" not in capsys.readouterr().out
    # a knee of half the bundle's d = 16 rows (a quarter of a d = 64 row's
    # bytes): two chunks, whatever tile_spmm says
    monkeypatch.setattr(spmm, "GATHER_KNEE_ROWS", bundle.graph.num_nodes // 8)
    for c in (_cfg(tmp_path), cfg):
        chunked = Trainer(c, _model(bundle, c), bundle)
        assert isinstance(chunked.graph, spmm.ChunkedDeviceGraph)
        assert chunked.graph.num_chunks == 2
        assert capsys.readouterr().out == (
            "Graph: source-chunked gathers (2 chunks — embedding block above the gather "
            "knee, see PERF.md)\n")


def test_retriever_builds_no_views(bundle, monkeypatch):
    built = []

    def record(*args, **kwargs):
        built.append(spmm.to_device_graph_auto(*args, **kwargs))
        return built[-1]

    monkeypatch.setattr(serve, "to_device_graph_auto", record)
    m = _model(bundle, Config(embedding_dim=16, n_layers=2))
    serve.Retriever.from_params(m, m.params(), bundle)
    assert len(built) == 1 and isinstance(built[0], spmm.DeviceGraph)
    assert not built[0].fused


def test_sharded_trainers_build_no_views(bundle, tmp_path, monkeypatch, world_of_one):
    """Each sharded trainer builds its own kind, per-layer and unchunked
    even with a knee below the bundle's node count."""
    from gcn_recommendation_tpu_torch.parallel import halo, spmd

    built = []

    def record(*args, **kwargs):
        built.append(spmm.to_device_graph(*args, **kwargs))
        return built[-1]

    monkeypatch.setattr(spmd, "to_device_graph", record)
    monkeypatch.setattr(spmm, "GATHER_KNEE_ROWS", bundle.graph.num_nodes // 8)
    for cls, kind in ((spmd.ShardedTrainer, spmd.ShardedGraph),
                      (halo.HaloTrainer, halo.ShardedEllArrays)):
        cfg = _cfg(tmp_path)
        tr = cls(cfg, _model(bundle, cfg), bundle, world_of_one)
        assert isinstance(tr.graph, kind)  # a sharded layout
    # the gspmd schedule shards a per-layer graph; halo builds its own
    assert len(built) == 1 and not built[0].fused


# ---------------------------------------------------------- trainer, 3 steps


def test_trainer_fused_matches_per_layer(bundle, tmp_path):
    rng = np.random.default_rng(0)
    rows = rng.integers(0, len(bundle.train), (3, B))
    users = torch.from_numpy(bundle.train.user_idx[rows].astype(np.int64))
    pos = torch.from_numpy(bundle.train.item_idx[rows].astype(np.int64))
    neg = torch.from_numpy(rng.integers(0, bundle.num_items, (3, B)))
    losses = {}
    for cls in (Trainer, PerLayer):
        cfg = _cfg(tmp_path)
        tr = cls(cfg, _model(bundle, cfg), bundle)
        assert tr.graph.fused == (cls is Trainer)
        losses[cls] = np.array([float(tr.train_step(users[s], pos[s], neg[s]))
                                for s in range(3)])
    np.testing.assert_allclose(losses[Trainer], losses[PerLayer], rtol=2e-5)
