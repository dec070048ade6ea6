"""Row padding and the debug diagnostics of the port against the JAX package.

* ``pad_graph_nodes`` / ``pad_ell_rows``: every array bit-equal to the JAX
  module's on the same host graph (numpy in both, same operations);
* a row-padded model over the padded graph: the JAX padded ``apply``
  within 1e-6, and the unpadded forward within 1e-6 (pad nodes are
  isolated: the same sums per node, in the same order);
* ``pad_state_tree`` / ``unpad_state_tree`` are inverses on params and on
  Adam moments; a padded three-step run equals the unpadded one within
  1e-6 and leaves the pad rows zero; a padded trainer's checkpoints hold
  logical shapes and resume;
* ``debug_diagnostics`` against the JAX function within 1e-5 (f32 dense
  products on the host in both).
"""

import contextlib
import io
import os

import jax
import numpy as np
import pytest
import torch

from gcn_recommendation_tpu.config import Config as JaxConfig
from gcn_recommendation_tpu.data.synthetic import synthetic_bundle as jax_bundle
from gcn_recommendation_tpu.graph import build as jbuild
from gcn_recommendation_tpu.models import get_model as jax_get_model
from gcn_recommendation_tpu.models.lightgcn import debug_diagnostics as jax_diagnostics
from gcn_recommendation_tpu.ops.spmm import to_device_graph as jax_device_graph
from gcn_recommendation_tpu_torch.config import Config
from gcn_recommendation_tpu_torch.data.synthetic import synthetic_bundle
from gcn_recommendation_tpu_torch.graph import build
from gcn_recommendation_tpu_torch.graph.tiles import partition_tiles
from gcn_recommendation_tpu_torch.models import get_model
from gcn_recommendation_tpu_torch.models.convert import params_from_jax
from gcn_recommendation_tpu_torch.models.lightgcn import debug_diagnostics
from gcn_recommendation_tpu_torch.ops import block_spmm
from gcn_recommendation_tpu_torch.ops.spmm import to_device_graph
from gcn_recommendation_tpu_torch.serve import Retriever
from gcn_recommendation_tpu_torch.train.trainer import Trainer
from gcn_recommendation_tpu_torch.utils import checkpoint as ckpt
from test_torch_tiles import port_graph
from test_torch_spmm import one_thread  # noqa: F401  (autouse: one thread)

U, I, NB = 301, 203, 21   # no size divides 8
D = 16
B = 256


@pytest.fixture(scope="module")
def bundles():
    bj = jax_bundle(U, I, NB, seed=0)
    b = synthetic_bundle(U, I, NB, seed=0)
    # the JAX host graph's own arrays in the port's Graph: bit-equal inputs
    return b, bj, port_graph(bj.graph)


def _assert_graphs_bit_equal(g, gj):
    assert (g.num_users, g.num_items, g.num_brands, g.nnz) == (
        gj.num_users, gj.num_items, gj.num_brands, gj.nnz)
    for f in ("src", "dst", "weight", "row_ptr", "gather_idx", "dense_node_ids", "dense_mat"):
        a, bj = getattr(g, f), getattr(gj, f)
        assert a.dtype == bj.dtype and a.shape == bj.shape, f
        np.testing.assert_array_equal(a, bj, err_msg=f)
    assert len(g.buckets) == len(gj.buckets)
    for bk, bkj in zip(g.buckets, gj.buckets):
        assert bk.width == bkj.width
        for f in ("node_ids", "nbr_idx", "nbr_w"):
            assert getattr(bk, f).dtype == getattr(bkj, f).dtype
            np.testing.assert_array_equal(getattr(bk, f), getattr(bkj, f), err_msg=f)


# ------------------------------------------------------------- the host graph


@pytest.mark.parametrize("pads,mult", [((304, 208, 24), 8), ((304, 208, 24), 1),
                                       ((U, I, NB), 4), ((320, 203, 21), 1)])
def test_pad_graph_nodes_bit_equal_jax(bundles, pads, mult):
    _, bj, g = bundles
    got = build.pad_graph_nodes(g, *pads, bucket_row_multiple=mult)
    want = jbuild.pad_graph_nodes(bj.graph, *pads, bucket_row_multiple=mult)
    _assert_graphs_bit_equal(got, want)
    assert got.num_nodes == sum(pads)
    if mult > 1:
        assert all(bk.nbr_idx.shape[0] % mult == 0 for bk in got.buckets)


def test_pad_graph_nodes_identity_and_refusal(bundles):
    _, _, g = bundles
    assert build.pad_graph_nodes(g, U, I, NB) is g
    with pytest.raises(ValueError, match="below the logical sizes"):
        build.pad_graph_nodes(g, U - 1, I, NB)


@pytest.mark.parametrize("mult", [1, 8, 5])
def test_pad_ell_rows_bit_equal_jax(bundles, mult):
    _, bj, g = bundles
    gj = bj.graph
    got = build.pad_ell_rows(g.buckets, g.gather_idx, g.dense_node_ids, g.dense_mat,
                             g.num_nodes, mult)
    want = jbuild.pad_ell_rows(gj.buckets, gj.gather_idx, gj.dense_node_ids, gj.dense_mat,
                               gj.num_nodes, mult)
    for a, w in zip(got[1:], want[1:]):
        assert a.dtype == w.dtype
        np.testing.assert_array_equal(a, w)
    for bk, bkj in zip(got[0], want[0]):
        np.testing.assert_array_equal(bk.nbr_idx, bkj.nbr_idx)
        np.testing.assert_array_equal(bk.nbr_w, bkj.nbr_w)
        assert bk.nbr_idx.shape[0] % mult == 0


# ------------------------------------------------------------ the padded model


def _model(name, b, mult=1, content=None, **kw):
    cfg = Config(embedding_dim=D, n_layers=2, batch_size=B, model_name=name, **kw)
    m = get_model(name)(b.num_users, b.num_items, b.num_brands, cfg,
                        pretrained_item_emb=content, device="cpu")
    if mult > 1:
        m.set_row_multiple(mult)
    return m, cfg


def _content():
    return np.random.default_rng(5).standard_normal((I, 12)).astype(np.float32)


def _device_graph(model, g, tile):
    g = model.padded_graph(g)
    if not tile:
        return to_device_graph(g, device="cpu")
    part = partition_tiles(g, min_fill=16)
    return block_spmm.TiledDeviceGraph(
        base=to_device_graph(part.residual, device="cpu"),
        tiles=block_spmm.to_device_tiles(part, device="cpu"))


def test_set_row_multiple_sizes_and_zero_pad_rows(bundles):
    b, _, _ = bundles
    m, _ = _model("LightGCN_Fusion", b, content=_content())
    assert m.needs_row_padding(8) and not m.needs_row_padding(1) and not m.is_row_padded
    logical = {k: v.clone() for k, v in m.init(torch.Generator().manual_seed(0)).items()}
    m.set_row_multiple(8)
    assert m.is_row_padded and m.row_multiple == 8
    assert (m.num_users_pad, m.num_items_pad, m.num_brands_pad) == (304, 208, 24)
    p = m.params()
    assert p["user_embedding"].shape == (304, D) and p["item_embedding"].shape == (208, D)
    assert p["brand_embedding"].shape == (24, D)
    assert p["item_content_embedding"].shape == (208, 12)
    assert p["fusion_kernel"].shape == (D + 12, D)
    for k, rows in (("user_embedding", U), ("item_embedding", I), ("brand_embedding", NB),
                    ("item_content_embedding", I)):
        assert torch.equal(p[k][:rows], logical[k]) and not p[k][rows:].any()
    # the logical rows of a fresh init do not depend on the row multiple
    again = m.init(torch.Generator().manual_seed(0))
    assert all(torch.equal(m.unpad_state_tree(again)[k], logical[k]) for k in logical)
    assert [n for n, _ in m.named_buffers()] == ["item_content_embedding"]
    # sizes that divide: no table grows, but ELL bucket rows are still padded
    m2, _ = _model("LightGCN", synthetic_bundle(64, 32, 8, seed=0), mult=8)
    assert (m2.num_users_pad, m2.num_items_pad, m2.num_brands_pad) == (64, 32, 8)
    assert m2.is_row_padded


@pytest.mark.parametrize("name", ["LightGCN", "LightGCN_Fusion"])
def test_pad_and_unpad_state_trees_are_inverses(bundles, name):
    b, _, _ = bundles
    m, _ = _model(name, b, mult=8, content=_content() if name.endswith("Fusion") else None)
    m.init(torch.Generator().manual_seed(1))
    padded = {k: v.clone() for k, v in m.params().items()}
    logical = m.unpad_state_tree(padded)
    assert logical["user_embedding"].shape == (U, D) and logical["item_embedding"].shape == (I, D)
    back = m.pad_state_tree(logical)
    assert all(torch.equal(back[k], padded[k]) for k in padded)
    assert all(torch.equal(m.unpad_state_tree(back)[k], logical[k]) for k in logical)
    # nested trees keyed like the params (Adam moments), scalars untouched
    tree = {"exp_avg": dict(logical), "step": torch.tensor(3.0), "lr": 0.1}
    up = m.pad_state_tree(tree)
    assert up["exp_avg"]["item_embedding"].shape == (208, D)
    assert up["step"] is tree["step"] and up["lr"] == 0.1
    down = m.unpad_state_tree(up)
    assert all(torch.equal(down["exp_avg"][k], logical[k]) for k in logical)


@pytest.mark.parametrize("name", ["LightGCN", "LightGCN_Fusion"])
def test_padded_forward_matches_jax_padded_apply(bundles, name):
    b, bj, g = bundles
    content = _content() if name.endswith("Fusion") else None
    jm = jax_get_model(name)(U, I, NB, JaxConfig(embedding_dim=D, n_layers=2),
                             pretrained_item_emb=content)
    jm.set_row_multiple(8)
    jp = jm.init(jax.random.PRNGKey(0))
    gj = jbuild.pad_graph_nodes(bj.graph, jm.num_users_pad, jm.num_items_pad,
                                jm.num_brands_pad, bucket_row_multiple=8)
    want = jm.apply(jp, jax_device_graph(gj))
    m, _ = _model(name, b, mult=8, content=content)
    params = params_from_jax({k: np.asarray(v) for k, v in jp.items()}, m, device="cpu")
    assert params["user_embedding"].shape == (U, D)  # logical out of the padded JAX tables
    m.load_params(params)
    with torch.no_grad():
        got = m(_device_graph(m, g, tile=False))
    for g_, w_ in zip(got, want):
        assert tuple(g_.shape) == tuple(w_.shape)
        np.testing.assert_allclose(g_.detach().numpy(), np.asarray(w_), rtol=0, atol=1e-6)


@pytest.mark.parametrize("tile", [False, True], ids=["ell", "tiles"])
@pytest.mark.parametrize("name", ["LightGCN", "LightGCN_Fusion"])
def test_padded_forward_equals_unpadded(bundles, name, tile):
    b, _, _ = bundles
    content = _content() if name.endswith("Fusion") else None
    plain, _ = _model(name, b, content=content)
    params = {k: v.clone() for k, v in plain.init(torch.Generator().manual_seed(2)).items()}
    padded, _ = _model(name, b, mult=8, content=content)
    padded.load_params(params)  # logical shapes into a padded model
    with torch.no_grad():
        want = plain(_device_graph(plain, b.graph, tile))
        got = padded(_device_graph(padded, b.graph, tile))
    for g_, w_ in zip(got, want):
        assert g_.shape == w_.shape
        np.testing.assert_allclose(g_.detach().numpy(), w_.detach().numpy(), rtol=0, atol=1e-6)


def _batches(bundle, n):
    out = []
    for s in range(n):
        rng = np.random.default_rng(s)
        rows = rng.integers(0, len(bundle.train), B)
        out.append(tuple(torch.from_numpy(a.astype(np.int64)) for a in (
            bundle.train.user_idx[rows], bundle.train.item_idx[rows],
            rng.integers(0, bundle.num_items, B))))
    return out


@pytest.mark.parametrize("tile", [False, True], ids=["ell", "tiles"])
@pytest.mark.parametrize("name", ["LightGCN", "LightGCN_Fusion"])
def test_padded_three_steps_equal_unpadded(bundles, name, tile, tmp_path):
    b, _, _ = bundles
    content = _content() if name.endswith("Fusion") else None
    kw = dict(tile_spmm=tile, tile_min_fill=16, checkpoint_dir=str(tmp_path),
              results_dir=str(tmp_path))
    plain, cfg = _model(name, b, content=content, **kw)
    params = {k: v.clone() for k, v in plain.init(torch.Generator().manual_seed(3)).items()}
    padded, _ = _model(name, b, mult=8, content=content, **kw)
    padded.load_params(params)
    with contextlib.redirect_stdout(io.StringIO()):
        trainers = [Trainer(cfg, plain, b), Trainer(cfg, padded, b)]
    want_graph = "TiledDeviceGraph" if tile else "DeviceGraph"
    assert all(type(t.graph).__name__ == want_graph for t in trainers)
    assert trainers[1].graph is not None and padded.is_row_padded
    for batch in _batches(b, 3):
        l0, l1 = (float(t.train_step(*batch)) for t in trainers)
        np.testing.assert_allclose(l1, l0, rtol=1e-6)
    got, want = padded.unpad_state_tree(padded.params()), plain.params()
    for k in plain.param_keys:
        np.testing.assert_allclose(got[k].numpy(), want[k].numpy(), rtol=0, atol=1e-6,
                                   err_msg=k)
    # zero gradient on the pad rows: Adam leaves them at zero
    for k, rows in (("user_embedding", U), ("item_embedding", I), ("brand_embedding", NB)):
        assert not padded.params()[k][rows:].any(), k
        assert not getattr(padded, k).grad[rows:].any(), k


def test_padded_trainer_writes_logical_checkpoints_and_resumes(bundles, tmp_path):
    b, _, _ = bundles
    content = _content()

    def fit(epochs, resume, mult):
        m, cfg = _model("LightGCN_Fusion", b, mult=mult, content=content, epochs=epochs,
                        val_interval=1, checkpoint_dir=str(tmp_path / "ck"),
                        results_dir=str(tmp_path / "res"))
        with contextlib.redirect_stdout(io.StringIO()) as out:
            tr = Trainer(cfg, m, b)
            tr.fit(resume=resume)
        return tr, cfg, out.getvalue()

    tr, cfg, _ = fit(2, False, 8)
    d = os.path.join(cfg.checkpoint_dir, cfg.checkpoint_name())
    for tag in ("best", "last"):
        state = ckpt.load_state(d, tag)
        p = state["params"]
        assert p["user_embedding"].shape == (U, D) and p["item_embedding"].shape == (I, D)
        assert p["brand_embedding"].shape == (NB, D)
        assert p["item_content_embedding"].shape == (I, 12)
        for i, k in enumerate(tr.model.trainable_keys):
            for moment in ("exp_avg", "exp_avg_sq"):
                assert state["optimizer"]["state"][i][moment].shape == p[k].shape, (k, moment)
    last = ckpt.load_state(d, "last")["params"]
    now = tr.model.unpad_state_tree(tr.model.params())
    assert all(torch.equal(last[k], now[k]) for k in last)
    # a logical checkpoint restores into a padded trainer and into another multiple
    for epochs, mult in ((3, 8), (4, 4)):
        tr2, _, out = fit(epochs, True, mult)
        assert f"Resumed from epoch {epochs - 1}" in out and f"Epoch {epochs}/{epochs}" in out
        assert tr2.model.params()["user_embedding"].shape[0] % mult == 0
        assert tr2.optimizer.state_dict()["state"][0]["exp_avg"].shape == (
            tr2.model.num_users_pad, D)


@pytest.mark.parametrize("quantize", [False, True], ids=["f32", "int8"])
def test_padded_retriever_serves_logical_rows(bundles, quantize):
    b, _, _ = bundles
    content = _content()
    plain, _ = _model("LightGCN_Fusion", b, content=content)
    params = {k: v.clone() for k, v in plain.init(torch.Generator().manual_seed(4)).items()}
    padded, _ = _model("LightGCN_Fusion", b, mult=8, content=content)
    users = np.unique(b.train.user_idx)[:32]
    want = Retriever.from_params(plain, params, b, quantize=quantize)
    got = Retriever.from_params(padded, params, b, quantize=quantize)
    assert got.num_items == I and got.user_emb.shape == (U, D)
    (vw, iw), (vg, ig) = want.recommend(users, k=10), got.recommend(users, k=10)
    if quantize:  # a 1e-9 difference may flip one stochastic rounding
        overlap = np.mean([len(set(a) & set(c)) / 10 for a, c in zip(iw, ig)])
        assert overlap >= 0.9
    else:
        np.testing.assert_allclose(vg, vw, rtol=0, atol=1e-6)
        assert (ig == iw).mean() > 0.99


# ----------------------------------------------------------- debug diagnostics


def test_debug_diagnostics_match_jax(bundles, capsys):
    b, bj, _ = bundles
    jm = jax_get_model("LightGCN")(U, I, NB, JaxConfig(embedding_dim=D, n_layers=3))
    jp = jm.init(jax.random.PRNGKey(0))
    want = jax_diagnostics(jm, jp, bj.graph)
    m, _ = _model("LightGCN", b, mult=8)
    m.n_layers = 3
    m.load_params(params_from_jax({k: np.asarray(v) for k, v in jp.items()}, m, device="cpu"))
    capsys.readouterr()
    got = debug_diagnostics(m, m.params(), b.graph)  # padded params, unpadded graph
    out = capsys.readouterr().out
    assert len(got["brand_norms"]) == 3
    np.testing.assert_allclose(got["brand_norms"], want["brand_norms"], rtol=0, atol=1e-5)
    np.testing.assert_allclose(got["brand_influence_cosine"], want["brand_influence_cosine"],
                               rtol=0, atol=1e-5)
    assert "Layer 3 brand embedding L2 norm" in out and "Average cos similarity" in out


def test_debug_diagnostics_refuse_large_graphs(bundles, capsys):
    b, _, _ = bundles
    m, _ = _model("LightGCN", b)
    m.init(torch.Generator().manual_seed(0))
    assert debug_diagnostics(m, m.params(), b.graph, max_nodes=b.graph.num_nodes - 1) == {}
    assert "graph too large for dense diagnostics" in capsys.readouterr().out


@pytest.mark.parametrize("name,runs", [("LightGCN", True), ("LightGCN_Fusion", False)])
def test_fit_runs_diagnostics_under_debug_for_lightgcn_only(bundles, tmp_path, name, runs):
    b, _, _ = bundles
    m, cfg = _model(name, b, content=_content() if name.endswith("Fusion") else None,
                    debug=True, checkpoint_dir=str(tmp_path / "ck"),
                    results_dir=str(tmp_path / "res"))
    cfg.epochs = 1
    with contextlib.redirect_stdout(io.StringIO()) as out:
        Trainer(cfg, m, b).fit()
    assert ("brand embedding L2 norm" in out.getvalue()) == runs
    assert ("Average cos similarity" in out.getvalue()) == runs


@pytest.mark.parametrize("base,runs", [("LightGCN", True), ("LightGCN_Fusion", False)])
def test_fit_asks_the_model_not_its_name_for_diagnostics(bundles, tmp_path, base, runs):
    """A subclass under another name inherits its family's answer."""
    b, _, _ = bundles
    cls = type("Variant", (get_model(base),), {"name": "Variant"})
    assert cls.has_debug_diagnostics == runs
    cfg = Config(embedding_dim=D, n_layers=2, batch_size=256, epochs=1, debug=True,
                 model_name="Variant", checkpoint_dir=str(tmp_path / "ck"),
                 results_dir=str(tmp_path / "res"))
    m = cls(b.num_users, b.num_items, b.num_brands, cfg,
            pretrained_item_emb=_content() if not runs else None, device="cpu")
    with contextlib.redirect_stdout(io.StringIO()) as out:
        Trainer(cfg, m, b).fit()
    assert ("brand embedding L2 norm" in out.getvalue()) == runs
