"""The port's evaluation against the JAX package's ``evaluate_embeddings``.

Same final embeddings, same eval and filter interactions: Recall@k and
NDCG@k agree within 1e-6 (f32 scores; the metric sums are exact counts
and reciprocals of logs).  Tied scores are built on purpose: duplicated
item rows score exactly alike, and the held-out item sits in a tie
group that straddles the top-k boundary, so only ``lax.top_k``'s
lower-index-first order gives the JAX package's hits.  A batch's hit
histogram (``hit_histogram_plain``) is held against ``topk_hit_metrics``,
its float reference, and a row-by-row count.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gcn_recommendation_tpu.data.loader import Interactions as JaxInteractions
from gcn_recommendation_tpu.train.evaluate import (
    dedup_eval_users as jax_dedup,
    evaluate_embeddings as jax_evaluate,
)
from gcn_recommendation_tpu_torch.data.loader import Interactions
from gcn_recommendation_tpu_torch.ops.topk import (
    hit_histogram,
    hit_histogram_plain,
    masked_topk,
    masked_topk_scores,
    topk_hit_metrics,
)
from gcn_recommendation_tpu_torch.train.evaluate import (
    build_eval_batches,
    dedup_eval_users,
    evaluate_batches,
    evaluate_embeddings,
)
from test_torch_spmm import one_thread  # noqa: F401  (autouse: one thread)

NU, NI, D, K = 90, 60, 8, 10


def _setup(seed, ties):
    rng = np.random.default_rng(seed)
    fu = rng.standard_normal((NU, D)).astype(np.float32)
    fi = rng.standard_normal((NI, D)).astype(np.float32)
    if ties:
        # 6 groups of 10 identical items: every score ties 9 others
        fi = np.repeat(fi[:6], 10, axis=0)
    # filter: train items; one user far heavier than the rest (a wider tier)
    fu_idx = np.concatenate([rng.integers(0, NU, 300), np.full(40, 3)]).astype(np.int32)
    fi_idx = rng.integers(0, NI, 340).astype(np.int32)
    ev_u = np.concatenate([np.arange(NU), rng.integers(0, NU, 20)]).astype(np.int32)
    ev_i = rng.integers(0, NI, len(ev_u)).astype(np.int32)
    return fu, fi, (ev_u, ev_i), (fu_idx, fi_idx)


@pytest.mark.parametrize("ties", [False, True])
@pytest.mark.parametrize("batch_size", [16, 1024])
def test_metrics_equal_jax(ties, batch_size):
    fu, fi, ev, filt = _setup(0, ties)
    want = jax_evaluate(jnp.asarray(fu), jnp.asarray(fi), JaxInteractions(*ev),
                        JaxInteractions(*filt), NU, NI, K, batch_size)
    got = evaluate_embeddings(torch.from_numpy(fu), torch.from_numpy(fi), Interactions(*ev),
                              Interactions(*filt), NU, NI, K, batch_size)
    np.testing.assert_allclose(got, [float(x) for x in want], rtol=0, atol=1e-6)
    assert 0.0 < got[0] <= 1.0 and 0.0 < got[1] <= got[0]


def test_tie_order_decides_a_hit():
    # 4 items tied; k = 2; the true item is index 1 (a hit only when the
    # lower indices come first) or index 3 (then a miss)
    scores = torch.tensor([[1.0, 1.0, 0.5, 1.0, 1.0]])
    filt = torch.tensor([[5]])  # pad only
    vals, idx = masked_topk(scores, filt, 2, stable=True)
    assert idx.tolist() == [[0, 1]] and vals.tolist() == [[1.0, 1.0]]
    valid = torch.tensor([True])
    hit1 = topk_hit_metrics(idx, torch.tensor([1]), valid)
    hit3 = topk_hit_metrics(idx, torch.tensor([3]), valid)
    assert [float(x) for x in hit1] == pytest.approx([1.0, 1 / np.log2(3), 1.0])
    assert [float(x) for x in hit3] == [0.0, 0.0, 1.0]


def test_masked_items_rank_last_in_index_order():
    scores = torch.tensor([[3.0, 2.0, 1.0, 0.0]])
    vals, idx = masked_topk(scores, torch.tensor([[0, 1, 2, 4]]), 3, stable=True)
    assert idx.tolist() == [[3, 0, 1]]


def test_dedup_keeps_last_occurrence_like_jax():
    u = np.array([3, 1, 3, 2, 1], np.int32)
    i = np.array([10, 11, 12, 13, 14], np.int32)
    for a, b in zip(dedup_eval_users(Interactions(u, i)), jax_dedup(JaxInteractions(u, i))):
        np.testing.assert_array_equal(a, b)


def test_eval_batches_pad_and_tier():
    # a large catalog narrows the first tier (compare_max_f(100k) = 12)
    _, _, ev, (fu_idx, _) = _setup(1, False)
    fi_idx = np.random.default_rng(1).integers(0, 100_000, len(fu_idx)).astype(np.int32)
    batches = build_eval_batches(Interactions(*ev), Interactions(fu_idx, fi_idx), NU,
                                 100_000, batch_size=16, device="cpu")
    users = torch.cat([b[0][b[3]] for b in batches])
    assert sorted(users.tolist()) == list(range(NU))  # each user once
    widths = {b[2].shape[1] for b in batches}
    assert len(widths) >= 2  # the heavy user sits in a wider tier
    for u, t, f, v in batches:
        assert u.shape == t.shape == v.shape == (16,) and f.dtype == torch.int64


def _hist_case(kind, seed=0):
    """(topk_idx, true_items, valid, k) of one evaluation batch, drawn so
    that ``kind`` occurs: ``ties`` (seven score levels, held-out items in
    tie groups), ``pad_rows`` (a third of the rows not valid, hits among
    them), ``masked_ranked`` (rows with fewer than k unmasked items, the
    held-out item masked yet in the top k), ``miss`` (no held-out item in
    its top k), ``k_above_n`` (N < k: N columns), ``no_valid_row``,
    ``repeated_index`` (an index row with repeats: the first one counts)."""
    rng = np.random.default_rng(seed)
    b, n, k, f = 64, 50, 10, 8
    if kind == "k_above_n":
        n = 8
    if kind == "masked_ranked":
        n, f = 30, 25
    scores = torch.from_numpy(rng.standard_normal((b, n)).astype(np.float32))
    if kind == "ties":
        scores = torch.from_numpy(rng.integers(-3, 4, (b, n)).astype(np.float32) * 0.5)
    filt = torch.from_numpy(np.stack([rng.choice(n, f, replace=False) for _ in range(b)]))
    _, idx = masked_topk(scores, filt, k, stable=True)
    if kind == "repeated_index":
        idx = torch.from_numpy(rng.integers(0, 4, (b, k)))
    width = idx.shape[1]
    if kind == "miss":
        # an item of the row's filter that did not rank: masked below k others
        true = torch.stack([next(t for t in filt[r] if t not in idx[r]) for r in range(b)])
    elif kind == "masked_ranked":
        true = torch.stack([next(t for t in idx[r].flip(0) if t in filt[r]) for r in range(b)])
    else:
        pos = torch.from_numpy(rng.integers(0, width, b))
        true = idx.gather(1, pos[:, None])[:, 0]
        miss = torch.from_numpy(rng.random(b) < 0.3)
        true = torch.where(miss, torch.from_numpy(rng.integers(0, n, b)), true)
    valid = torch.ones(b, dtype=torch.bool)
    if kind == "pad_rows":
        valid = torch.from_numpy(rng.random(b) < 0.67)
    if kind == "no_valid_row":
        valid = torch.zeros(b, dtype=torch.bool)
    return idx, true.to(torch.int64), valid, k


HIST_CASES = ["ties", "pad_rows", "masked_ranked", "miss", "k_above_n", "no_valid_row",
              "repeated_index"]


@pytest.mark.parametrize("kind", HIST_CASES)
def test_hit_histogram_matches_topk_hit_metrics(kind):
    idx, true, valid, k = _hist_case(kind)
    hist = hit_histogram_plain(idx, true, valid, k)
    assert hist.dtype == torch.int32 and hist.shape == (k + 1,)
    assert torch.equal(hit_histogram(idx, true, valid, k), hist)
    want = [0] * (k + 1)
    for r in range(idx.shape[0]):
        if valid[r]:
            want[k] += 1
            hits = (idx[r] == true[r]).nonzero()
            if len(hits):
                want[int(hits[0])] += 1
    assert hist.tolist() == want
    recall_sum, ndcg_sum, count = (float(x) for x in topk_hit_metrics(idx, true, valid))
    assert (recall_sum, count) == (sum(want[:k]), want[k])
    ndcg = sum(h / np.log2(p + 2) for p, h in enumerate(want[:k]))
    np.testing.assert_allclose(ndcg_sum, ndcg, rtol=1e-6)
    if kind == "masked_ranked":
        assert sum(want[:k]) == want[k]  # every row's masked held-out item ranked
    if kind == "miss":
        assert sum(want[:k]) == 0 and want[k] == idx.shape[0]
    if kind == "k_above_n":
        assert idx.shape[1] < k and sum(want[:k]) > 0
    if kind in ("ties", "pad_rows"):
        assert 0 < sum(want[:k]) < want[k]


@pytest.mark.parametrize("ties", [False, True])
@pytest.mark.parametrize("batch_size", [16, 1024])
def test_evaluate_batches_equals_float32_sums(ties, batch_size):
    """The metrics from the summed histogram agree with the float32 sums of
    ``topk_hit_metrics`` over the same batches (pad rows included)."""
    fu, fi, ev, filt = _setup(2, ties)
    fu, fi = torch.from_numpy(fu), torch.from_numpy(fi)
    batches = build_eval_batches(Interactions(*ev), Interactions(*filt), NU, NI, batch_size,
                                 device="cpu")
    assert any(not bool(b[3].all()) for b in batches)
    sums = torch.zeros(3, dtype=torch.float32)
    for users, true_items, f, valid in batches:
        _, idx = masked_topk_scores(fu.index_select(0, users), fi, f, K, stable=True)
        sums += torch.stack(topk_hit_metrics(idx, true_items, valid))
    recall, ndcg, n = sums.tolist()
    got = evaluate_batches(fu, fi, batches, K)
    np.testing.assert_allclose(got, (recall / n, ndcg / n), rtol=1e-6, atol=1e-6)
    assert evaluate_batches(fu, fi, [], K) == (0.0, 0.0)
