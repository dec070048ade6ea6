"""The port's halo-exchange schedule against dense ground truth, its
single-device path and the JAX package, on 2- and 4-rank gloo worlds.

* ``make_halo_propagator`` on (1,2), (1,4), (2,2) with hub rows forced
  (``dense_threshold=16``), against the dense layer mean (rtol 3e-5 / atol
  3e-6, ``tests/test_halo.py:56``) and against JAX's propagator on (1,2);
  its gradient against the dense transpose (rtol 3e-4 / atol 3e-5,
  ``tests/test_halo.py:83``); pad rows exactly 0;
* ``shard_ell`` against JAX's, array for array;
* the ``halo`` trainer on (1,2), (2,1), (2,2), with the brand term on
  (2,1), and a non-divisible vocabulary on (1,4): steps on given batches
  and a sampled epoch against the port's single-device trainer (rtol 1e-4
  / atol 1e-6, pad rows exactly 0), and JAX's ``HaloTrainer``'s loss at
  every step of the port's run on each mesh.  (JAX's HaloTrainer step
  takes 60-100 s to compile on this CPU, so its steps are not run here:
  the port's single-device step is held against JAX's in
  ``test_torch_train.py``.)
"""

import threading

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from gcn_recommendation_tpu.config import Config as JaxConfig
from gcn_recommendation_tpu.core.mesh import MeshSpec as JaxMeshSpec
from gcn_recommendation_tpu.core.mesh import create_mesh as jax_create_mesh
from gcn_recommendation_tpu.graph.build import (
    build_normalized_adjacency as jax_build_adjacency,
)
from gcn_recommendation_tpu.models import get_model as jax_get_model
from gcn_recommendation_tpu.parallel import halo as jhalo
from gcn_recommendation_tpu_torch.core.mesh import run_local_world
from gcn_recommendation_tpu_torch.data.loader import load_preprocessed_data
from gcn_recommendation_tpu_torch.data.synthetic import synthetic_bundle
from gcn_recommendation_tpu_torch.graph.build import build_normalized_adjacency
from gcn_recommendation_tpu_torch.parallel import drivers, halo
from helpers import dense_from_graph
from test_torch_spmm import one_thread  # noqa: F401  (autouse: one thread)

CFG = dict(embedding_dim=16, n_layers=2, batch_size=128)
BRAND_CFG = dict(CFG, brand_loss=True)
ND_CFG = dict(embedding_dim=16, n_layers=2, batch_size=64)
TRAIN_MESHES = [(1, 2), (2, 1), (2, 2)]
PROP_MESHES = [(1, 2), (1, 4), (2, 2)]
LAYERS = 3


def _batches(bundle, n, size, seed):
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        rows = rng.integers(0, len(bundle.train), size)
        out.append((bundle.train.user_idx[rows].astype(np.int32),
                    bundle.train.item_idx[rows].astype(np.int32),
                    rng.integers(0, bundle.num_items, size).astype(np.int32)))
    return out


def _graph_inputs():
    rng = np.random.default_rng(5)
    nu, ni, nb = 90, 70, 11  # deliberately not divisible by 4
    u, i = rng.integers(0, nu, 900), rng.integers(0, ni, 900)
    bi, bb = rng.integers(0, ni, 100), rng.integers(0, nb, 100)
    return (u, i, nu, ni, nb), dict(item_brand_item_idx=bi, item_brand_brand_idx=bb)


@pytest.fixture(scope="module")
def data(tiny_bundle):
    jb, path = tiny_bundle
    pb = load_preprocessed_data(path, use_brand=True, verbose=False)
    args, kw = _graph_inputs()
    g = build_normalized_adjacency(*args, **kw)
    rng = np.random.default_rng(0)
    d = dict(jb=jb, pb=pb, g=g, dense=dense_from_graph(g))
    d["emb"] = rng.standard_normal((g.num_nodes, 16)).astype(np.float32)
    d["cot"] = rng.standard_normal((g.num_nodes, 16)).astype(np.float32)
    d["params"] = {k: v.numpy() for k, v in
                   drivers.make_trainer(pb, CFG, device="cpu").model.params().items()}
    d["batches"] = _batches(pb, 3, 128, 1)
    d["nd"] = synthetic_bundle(90, 70, 11, mean_degree=8.0, seed=0)
    d["nd_batches"] = _batches(d["nd"], 2, 64, 2)
    return d


def _prop_case(d, shape):
    return ("halo_propagation_case", dict(mesh_shape=shape, graph=d["g"], emb=d["emb"],
                                          cotangent=d["cot"], n_layers=LAYERS,
                                          dense_threshold=16, device="cpu"))


def _train_case(d, shape, cfg=CFG):
    return ("train_case", dict(bundle=d["pb"], cfg_kwargs=cfg, batches=d["batches"],
                               params=d["params"], mesh_shape=shape, schedule="halo",
                               epochs=1, validate=True, device="cpu"))


def _spawn(n_ranks, cases):
    flat = [c for group in cases.values() for c in group]
    box = {}

    def run():
        try:
            box["out"] = run_local_world(n_ranks, drivers.run_cases, flat, device="cpu")
        except Exception as e:  # noqa: BLE001 - re-raised in wait()
            box["err"] = e

    t = threading.Thread(target=run)
    t.start()

    def wait():
        t.join(timeout=600)
        assert not t.is_alive(), f"the {n_ranks}-rank world did not finish in 600 s"
        if "err" in box:
            raise box["err"]
        results = iter(box["out"])
        return {name: [next(results) for _ in group] for name, group in cases.items()}

    return wait


@pytest.fixture(scope="module")
def spawned(data):
    d = data
    wait2 = _spawn(2, {
        "prop": [_prop_case(d, (1, 2))],
        "train": [_train_case(d, s) for s in TRAIN_MESHES if s != (2, 2)],
        "brand": [_train_case(d, (2, 1), BRAND_CFG)],
    })
    wait4 = _spawn(4, {
        "prop": [_prop_case(d, (1, 4)), _prop_case(d, (2, 2))],
        "train": [_train_case(d, (2, 2))],
        "nd": [("train_case", dict(bundle=d["nd"], cfg_kwargs=ND_CFG, batches=d["nd_batches"],
                                   mesh_shape=(1, 4), schedule="halo", device="cpu"))],
    })
    return wait2, wait4


@pytest.fixture(scope="module")
def world2(spawned, jax_prop):
    # jax_prop compiles while the worlds run
    return spawned[0]()


@pytest.fixture(scope="module")
def world4(spawned):
    return spawned[1]()


def _dense_mean(dense, ego, layers):
    acc, e = ego.copy(), ego
    for _ in range(layers):
        e = dense @ e
        acc += e
    return acc / (layers + 1)


@pytest.fixture(scope="module")
def jax_prop(data, spawned):
    """JAX's halo propagator on (1, 2), over JAX's own graph of the same
    edges."""
    args, kw = _graph_inputs()
    gj = jax_build_adjacency(*args, **kw)
    sh = jhalo.shard_ell(gj, 2, dense_threshold=16)
    prop = jhalo.make_halo_propagator(jax_create_mesh(JaxMeshSpec(1, 2)), sh, LAYERS)
    n = gj.num_nodes
    emb = np.zeros((sh.num_nodes_pad, 16), np.float32)
    emb[:n] = data["emb"]
    return np.asarray(prop(jnp.asarray(emb))), sh


def _prop(world2, world4, shape):
    return world2["prop"][0] if shape == (1, 2) else world4["prop"][PROP_MESHES.index(shape) - 1]


@pytest.mark.parametrize("shape", PROP_MESHES)
def test_halo_propagation_and_gradient_match_dense(data, world2, world4, shape):
    out, grad = _prop(world2, world4, shape)
    n = data["g"].num_nodes
    ref = _dense_mean(data["dense"], data["emb"], LAYERS)
    np.testing.assert_allclose(out[:n], ref, rtol=3e-5, atol=3e-6)
    np.testing.assert_array_equal(out[n:], 0.0)  # isolated pad nodes of zero rows
    # d/de0 sum(mean-of-layers * v) = (I + A + ... + A^L)^T v / (L + 1)
    expected = _dense_mean(data["dense"].T, data["cot"], LAYERS)
    np.testing.assert_allclose(grad[:n], expected, rtol=3e-4, atol=3e-5)


def test_halo_propagation_matches_jax(data, world2, jax_prop):
    out, _ = world2["prop"][0]
    j_out, _ = jax_prop
    np.testing.assert_allclose(out, j_out, rtol=3e-5, atol=3e-6)


def test_shard_ell_matches_jax(data, jax_prop):
    _, j_sh = jax_prop
    sh = halo.shard_ell(data["g"], 2, dense_threshold=16)
    assert (sh.n_shards, sh.nodes_per_shard, sh.num_nodes) == (
        j_sh.n_shards, j_sh.nodes_per_shard, j_sh.num_nodes)
    a, ja = sh.arrays, j_sh.arrays
    assert len(a.bucket_nbr_idx) == len(ja.bucket_nbr_idx)
    for x, y in zip(a.bucket_nbr_idx + (a.gather_idx,), ja.bucket_nbr_idx + (ja.gather_idx,)):
        np.testing.assert_array_equal(x, np.asarray(y))
    for x, y in zip(a.bucket_nbr_w + (a.dense_mat,), ja.bucket_nbr_w + (ja.dense_mat,)):
        np.testing.assert_allclose(x, np.asarray(y), rtol=1e-6)
    # every edge lands in exactly one shard's buckets or hub rows
    entries = sum(int((w != 0).sum()) for w in a.bucket_nbr_w) + int((a.dense_mat != 0).sum())
    assert entries == int((data["g"].weight != 0).sum())


@pytest.fixture(scope="module")
def single(data):
    d = data
    return {name: drivers.train_case(d["pb"], cfg, d["batches"], params=d["params"], epochs=1,
                                     validate=True, device="cpu")
            for name, cfg in (("plain", CFG), ("brand", BRAND_CFG))}


def _close(a, b, what):
    np.testing.assert_allclose(a, b, rtol=1e-4, atol=1e-6, err_msg=what)


def _train_result(world2, world4, shape, brand=False):
    if brand:
        return world2["brand"][0]
    if shape == (2, 2):
        return world4["train"][0]
    return world2["train"][[s for s in TRAIN_MESHES if s != (2, 2)].index(shape)]


CASES = [(s, False) for s in TRAIN_MESHES] + [((2, 1), True)]
CASE_IDS = ["1x2", "2x1", "2x2", "2x1-brand"]


@pytest.mark.parametrize("shape,brand", CASES, ids=CASE_IDS)
def test_halo_epoch_matches_single_device(single, world2, world4, shape, brand):
    out = _train_result(world2, world4, shape, brand)
    ref = single["brand" if brand else "plain"]
    _close(out["step_losses"], ref["step_losses"], "step losses")
    _close(out["epoch_losses"][0], ref["epoch_losses"][0], "epoch losses")
    for k in ref["params"]:
        _close(out["params"][k], ref["params"][k], k)
        assert out["pad_max"][k] == 0.0, k
    np.testing.assert_allclose(out["recall"], ref["recall"], rtol=1e-6)
    np.testing.assert_allclose(out["ndcg"], ref["ndcg"], rtol=1e-5)


@pytest.mark.parametrize("shape,brand", CASES, ids=CASE_IDS)
def test_halo_losses_match_jax_halo_trainer(data, world2, world4, shape, brand):
    """JAX's HaloTrainer on the same mesh gives the port's loss at every
    step of the port's run."""
    out = _train_result(world2, world4, shape, brand)
    jb = data["jb"]
    jcfg = JaxConfig(**(BRAND_CFG if brand else CFG))
    jm = jax_get_model("LightGCN")(jb.num_users, jb.num_items, jb.num_brands, jcfg)
    jt = jhalo.HaloTrainer(jcfg, jm, jb, jax_create_mesh(JaxMeshSpec(*shape)))
    loss = jax.jit(lambda p, u, i, n: jt._batch_loss(p, jt.arrays, u, i, n))
    for s, (params, batch) in enumerate(zip(out["trajectory"], data["batches"])):
        p = jax.tree.map(jnp.asarray, jt.model.pad_state_tree(params))
        p, _ = jt._place_state(p, ())
        _close(out["step_losses"][s], float(loss(p, *(jnp.asarray(a) for a in batch))),
               f"step {s}")


def test_halo_nondivisible_vocab(data, world4):
    out = world4["nd"][0]
    assert out["padded_rows"] == {"user_embedding": 92, "item_embedding": 72,
                                  "brand_embedding": 12}
    assert out["local_rows"] == {"user_embedding": 23, "item_embedding": 18,
                                 "brand_embedding": 3}
    ref = drivers.train_case(data["nd"], ND_CFG, data["nd_batches"], device="cpu")
    _close(out["step_losses"], ref["step_losses"], "losses")
    for k in ref["params"]:
        _close(out["params"][k], ref["params"][k], k)
        assert out["pad_max"][k] == 0.0


def test_pad_coo_node_space_matches_jax(data):
    b = data["nd"]
    jb_view = jhalo.pad_coo_node_space(b.graph, 92, 72, 12)
    view = halo.pad_coo_node_space(b.graph, 92, 72, 12)
    for f in ("src", "dst", "weight"):
        np.testing.assert_array_equal(getattr(view, f), getattr(jb_view, f))
    assert (view.nnz, view.num_nodes) == (jb_view.nnz, jb_view.num_nodes) == (b.graph.nnz, 176)


def test_apply_with_propagators_match_forward_and_jax(data):
    """``apply_with_propagator`` (a whole padded node block in) and
    ``apply_with_table_propagator`` (the three tables in) give the
    forward's five outputs, and JAX's ``apply_with_propagator`` gives the
    same on the same propagation."""
    import torch

    from gcn_recommendation_tpu.ops import spmm as jspmm
    from gcn_recommendation_tpu_torch.ops import spmm

    pb, jb = data["pb"], data["jb"]
    model = drivers.make_trainer(pb, CFG, params=data["params"], device="cpu").model
    dg = spmm.to_device_graph(pb.graph, device="cpu")
    n, layers = pb.graph.num_nodes, CFG["n_layers"]

    def prop(ego):  # the layer mean of the first n rows; the pad rows pass through
        acc = e = ego[:n]
        for _ in range(layers):
            e = spmm.propagate(e, dg)
            acc = acc + e
        return torch.cat([acc / (layers + 1), ego[n:]])

    with torch.no_grad():
        want = model(dg)
        got = model.apply_with_propagator(prop, n + 5)
        got_tables = model.apply_with_table_propagator(lambda u, i, b: prop(torch.cat([u, i, b])))
    for w, g, t in zip(want, got, got_tables):
        torch.testing.assert_close(g, w, rtol=1e-6, atol=1e-7)
        torch.testing.assert_close(t, w, rtol=1e-6, atol=1e-7)

    jcfg = JaxConfig(**CFG)
    jm = jax_get_model("LightGCN")(jb.num_users, jb.num_items, jb.num_brands, jcfg)
    jg = jspmm.to_device_graph(jb.graph)

    def jprop(ego):
        acc = e = ego[:n]
        for _ in range(layers):
            e = jspmm.propagate_ell(e, jg.bucket_nbr_idx, jg.bucket_nbr_w, jg.gather_idx,
                                    jg.dense_mat)
            acc = acc + e
        return jnp.concatenate([acc / (layers + 1), ego[n:]])

    jout = jm.apply_with_propagator({k: jnp.asarray(v) for k, v in data["params"].items()},
                                    jprop, n + 5)
    for g, j in zip(got, jout):
        np.testing.assert_allclose(g.detach().numpy(), np.asarray(j), rtol=1e-5, atol=1e-6)
