"""The port's evaluation against the JAX package's ``evaluate_embeddings``.

Same final embeddings, same eval and filter interactions: Recall@k and
NDCG@k agree within 1e-6 (f32 scores; the metric sums are exact counts
and reciprocals of logs).  Tied scores are built on purpose: duplicated
item rows score exactly alike, and the held-out item sits in a tie
group that straddles the top-k boundary, so only ``lax.top_k``'s
lower-index-first order gives the JAX package's hits.
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
from gcn_recommendation_tpu_torch.ops.topk import masked_topk, topk_hit_metrics
from gcn_recommendation_tpu_torch.train.evaluate import (
    build_eval_batches,
    dedup_eval_users,
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
