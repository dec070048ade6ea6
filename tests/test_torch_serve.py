"""The port's serving slice against the JAX package, end to end on the CPU.

Same bundle (the copied host modules), same weights (carried across),
then ``Retriever.recommend``: f32 scores within 1e-5 and items equal
except inside groups of scores tied within that tolerance
(``torch.topk`` does not promise ``lax.top_k``'s lower-index-first
order).
"""

import contextlib
import io

import jax
import numpy as np
import pytest
import torch

from gcn_recommendation_tpu.config import Config as JaxConfig
from gcn_recommendation_tpu.data.synthetic import synthetic_bundle as jax_bundle
from gcn_recommendation_tpu.models import get_model as jax_get_model
from gcn_recommendation_tpu.serve import Retriever as JaxRetriever
from gcn_recommendation_tpu_torch import cli
from gcn_recommendation_tpu_torch.config import Config
from gcn_recommendation_tpu_torch.data.loader import load_preprocessed_data
from gcn_recommendation_tpu_torch.data.synthetic import (
    generate_synthetic_dataset,
    synthetic_bundle,
)
from gcn_recommendation_tpu_torch.models import get_model
from gcn_recommendation_tpu_torch.models.convert import params_from_jax
from gcn_recommendation_tpu_torch.serve import Retriever
from gcn_recommendation_tpu_torch.utils.checkpoint import load_params, save_params
from test_torch_spmm import assert_same_graph, one_thread  # noqa: F401  (autouse: one thread)

TOL = 1e-5


def assert_same_topk(a, b, tol=TOL):
    (va, ia), (vb, ib) = a, b
    np.testing.assert_allclose(va, vb, rtol=0, atol=tol)
    for r in range(va.shape[0]):
        for j in np.flatnonzero(ia[r] != ib[r]):
            gaps = np.abs(va[r] - va[r, j])
            gaps[j] = np.inf
            assert gaps.min() <= tol, (r, j, ia[r], ib[r])


@pytest.fixture(scope="module")
def setup():
    b = synthetic_bundle(300, 200, 20, seed=0)
    bj = jax_bundle(300, 200, 20, seed=0)
    jm = jax_get_model("LightGCN")(
        bj.num_users, bj.num_items, bj.num_brands, JaxConfig(embedding_dim=16, n_layers=2)
    )
    jp = jm.init(jax.random.PRNGKey(0))
    m = get_model("LightGCN")(
        b.num_users, b.num_items, b.num_brands, Config(embedding_dim=16, n_layers=2),
        device="cpu",
    )
    params = params_from_jax({k: np.asarray(v) for k, v in jp.items()}, m, device="cpu")
    return b, bj, jm, jp, m, params


def test_bundle_equals_jax_bundle(setup):
    b, bj, *_ = setup
    for split in ("train", "val", "test"):
        for f in ("user_idx", "item_idx"):
            np.testing.assert_array_equal(
                getattr(getattr(b, split), f), getattr(getattr(bj, split), f)
            )
    assert (b.num_users, b.num_items, b.num_brands) == (bj.num_users, bj.num_items, bj.num_brands)
    np.testing.assert_array_equal(b.item_to_brand, bj.item_to_brand)
    assert b.graph_stats == bj.graph_stats
    assert_same_graph(b.graph, bj.graph)


@pytest.mark.parametrize("filter_seen", [True, False])
def test_recommend_f32_matches_jax(setup, filter_seen):
    b, bj, jm, jp, m, params = setup
    users = np.unique(b.train.user_idx)[:24]
    want = JaxRetriever.from_params(jm, jp, bj).recommend(users, k=10, filter_seen=filter_seen)
    got = Retriever.from_params(m, params, b).recommend(users, k=10, filter_seen=filter_seen)
    assert got[0].shape == (24, 10) and got[1].dtype == np.int64
    assert_same_topk(got, (np.asarray(want[0]), np.asarray(want[1])))


def test_recommend_filters_seen_items(setup):
    b, _, _, _, m, params = setup
    users = np.unique(b.train.user_idx)[:16]
    _, items = Retriever.from_params(m, params, b).recommend(users, k=10)
    seen = {}
    for u, i in zip(b.train.user_idx, b.train.item_idx):
        seen.setdefault(int(u), set()).add(int(i))
    for j, u in enumerate(users):
        assert not set(items[j].tolist()) & seen[int(u)]


def test_int8_catalog_overlaps_f32(setup):
    b, _, _, _, m, params = setup
    users = np.unique(b.train.user_idx)[:64]
    _, i_f = Retriever.from_params(m, params, b).recommend(users, k=20)
    rq = Retriever.from_params(m, params, b, quantize=True)
    assert rq.item_q.dtype == torch.int8 and rq.item_emb is None
    _, i_q = rq.recommend(users, k=20)
    overlap = np.mean([len(set(i_f[j]) & set(i_q[j])) / 20 for j in range(len(users))])
    assert overlap >= 0.9, overlap


@pytest.mark.parametrize("quantize", [False, True])
def test_many_and_pipelined_equal_recommend(setup, quantize):
    b, _, _, _, m, params = setup
    r = Retriever.from_params(m, params, b, quantize=quantize)
    reqs = [[1, 2, 3], [7], [5, 9, 11, 13, 2], list(range(20, 40))]
    single = [r.recommend(q, k=5) for q in reqs]
    for got in (r.recommend_many(reqs, k=5), r.recommend_pipelined(reqs, k=5)):
        assert len(got) == len(reqs)
        for s, g in zip(single, got):
            assert_same_topk(g, s)
    assert r.recommend_many([], k=5) == []


def test_checkpoint_roundtrip(tmp_path, setup):
    *_, params = setup
    save_params(str(tmp_path), params)
    back = load_params(str(tmp_path), device="cpu")
    assert set(back) == set(params)
    for k in params:
        assert torch.equal(back[k], params[k])
    assert load_params(str(tmp_path / "none"), device="cpu") is None


@pytest.mark.parametrize("extra", [[], ["--int8"], ["--include_seen"]])
def test_cli_recommend_prints_one_line_per_user(tmp_path, extra):
    data = generate_synthetic_dataset(
        str(tmp_path / "data"), num_users=120, num_items=80, num_brands=8,
        mean_degree=10.0, core=4, seed=1,
    )
    cfg = Config()
    bundle = load_preprocessed_data(data, verbose=False)
    m = get_model("LightGCN")(bundle.num_users, bundle.num_items, bundle.num_brands,
                              cfg, device="cpu")
    ckpt = str(tmp_path / "ckpt")
    save_params(ckpt, m.init(torch.Generator().manual_seed(0)))
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        rc = cli.main(["recommend", "--processed_dir", data, "--model_path", ckpt,
                       "--users", "3,7", "--k", "5", "--device", "cpu", *extra])
    assert rc == 0
    lines = [ln for ln in out.getvalue().splitlines() if ln.startswith("user ")]
    assert [ln.split(":")[0] for ln in lines] == ["user 3", "user 7"]
    assert all(len(ln.split(": ", 1)[1].split()) == 5 for ln in lines)


def test_synthetic_dataset_and_loader_match_jax(tmp_path):
    from gcn_recommendation_tpu.data.loader import load_preprocessed_data as jax_load
    from gcn_recommendation_tpu.data.synthetic import (
        generate_synthetic_dataset as jax_generate,
    )

    kw = dict(num_users=90, num_items=60, num_brands=6, mean_degree=9.0, core=4,
              seed=2, embedding_dim=8)
    a = load_preprocessed_data(generate_synthetic_dataset(str(tmp_path / "a"), **kw),
                               verbose=False)
    b = jax_load(jax_generate(str(tmp_path / "b"), **kw), verbose=False)
    for split in ("train", "val", "test"):
        for f in ("user_idx", "item_idx"):
            np.testing.assert_array_equal(
                getattr(getattr(a, split), f), getattr(getattr(b, split), f)
            )
    np.testing.assert_array_equal(a.item_to_brand, b.item_to_brand)
    assert_same_graph(a.graph, b.graph)
    np.testing.assert_array_equal(
        np.load(tmp_path / "a" / "item_embeddings.npy"),
        np.load(tmp_path / "b" / "item_embeddings.npy"),
    )
