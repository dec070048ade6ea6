"""The plain reference against the port at a tiny size on the CPU: three
training steps, a validation pass and a coalesced serve dispatch."""

import numpy as np
import pytest
import torch

from benchmark import data, program
from benchmark.loads import train
from benchmark.reference import lightgcn as ref

GRAPH = {"num_users": 300, "num_items": 200, "num_brands": 20, "mean_degree": 12.0, "core": 4,
         "use_brand": True, "structure_seed": 3}
CFG = {"model": "LightGCN", "embedding_dim": 16, "n_layers": 3, "learning_rate": 1e-3,
       "weight_decay": 1e-4, "batch_size": 64, "top_k": 20, "eval_user_batch": 128,
       "graph": GRAPH}


@pytest.fixture(scope="module")
def setup():
    torch.manual_seed(0)
    ds = data.make_dataset(GRAPH, 2**31 + 9)
    return ds, program.make_bundle(ds, True), ref.adjacency(ds, "cpu")


def tables(ds, popularity=0.0):
    return data.draw_tables(ds, CFG["embedding_dim"], 2**31 + 9, "cpu", popularity=popularity)


def test_adjacency_matches_port(setup):
    ds, bundle, adj = setup
    g = bundle.graph
    dense = torch.zeros(adj.shape)
    dense.index_put_((torch.as_tensor(g.dst[:g.nnz]).long(), torch.as_tensor(g.src[:g.nnz]).long()),
                     torch.as_tensor(g.weight[:g.nnz]), accumulate=True)
    assert adj._nnz() == g.nnz
    torch.testing.assert_close(adj.to_dense(), dense, rtol=1e-6, atol=1e-7)


def test_three_training_steps(setup):
    ds, bundle, adj = setup
    trainer = program.make_trainer(program.make_config(CFG, "float32"), ds, bundle, tables(ds),
                                   "cpu")
    feed = train.draw_feed(ds, CFG["batch_size"], 8, 5, "cpu")
    batches = [tuple(x[s] for x in feed) for s in range(3)]
    losses = [float(trainer.train_step(*b)) for b in batches]
    r_losses, _, r_after = ref.train_steps(adj, tables(ds), batches, CFG["n_layers"],
                                           CFG["learning_rate"], CFG["weight_decay"])
    np.testing.assert_allclose(losses, r_losses, rtol=1e-6)
    for k, v in r_after.items():
        torch.testing.assert_close(getattr(trainer.model, k).detach(), v, rtol=0, atol=1e-6)


def test_validation_pass(setup):
    ds, bundle, adj = setup
    t = tables(ds, popularity=3.0)
    trainer = program.make_trainer(program.make_config(CFG, "float32"), ds, bundle, t, "cpu")
    recall, ndcg = trainer.validate()
    fu, fi = ref.final_embeddings(adj, t, CFG["n_layers"])
    m = ref.recall_ndcg(ds, fu, fi, CFG["top_k"], tie=1e-5)
    assert m["users"] == ds.num_users
    assert recall == pytest.approx(m["recall"], abs=1e-12)
    assert ndcg == pytest.approx(m["ndcg"], rel=1e-6)
    assert m["ndcg_lo"] <= m["ndcg"] <= m["ndcg_hi"]
    assert m["recall_lo"] <= m["recall"] <= m["recall_hi"]
    assert m["recall"] > 0.05  # the popularity direction gives the ranking hits to find


def test_coalesced_dispatch(setup):
    ds, bundle, adj = setup
    t = tables(ds, popularity=3.0)
    retriever = program.make_retriever(program.make_config(CFG, "float32"), ds, bundle, t, "cpu")
    disp = program.Dispatcher(retriever, max_coalesce=16)
    rng = np.random.default_rng(0)
    reqs = [np.sort(rng.choice(ds.num_users, size=s, replace=False)).astype(np.int32)
            for s in (3, 17, 40, 8)]
    pend = [disp.submit(program.Pending(u, CFG["top_k"], True)) for u in reqs]  # queued first
    disp.start()
    try:
        for p in pend:
            assert p.done.wait(timeout=60) and p.error is None
    finally:
        disp.stop()
    assert disp.stats["dispatches"] == 1 and disp.stats["coalesced_requests"] == 4
    fu, fi = ref.final_embeddings(adj, t, CFG["n_layers"])
    ptr, items = ref.seen_csr(ds, "cpu")
    for u, p in zip(reqs, pend):
        scores, got = p.result
        s = ref.masked_scores(fu[torch.as_tensor(u).long()], fi, torch.as_tensor(u).long(), ptr,
                              items)
        best, idx = ref.topk_stable(s, CFG["top_k"])
        np.testing.assert_array_equal(got, idx.numpy())
        np.testing.assert_allclose(scores, best.numpy(), rtol=1e-5, atol=1e-7)
