"""The port's negative sampler and epoch batching.

``torch.Generator`` and ``jax.random`` give different numbers from one
seed, so the sampler is held to the JAX package's contract by
distribution, as ``tests/test_sampler.py`` holds the JAX sampler: no
positive is ever returned (given enough rounds), draws are uniform over
the user's non-positives (chi-square), and epoch batches cover a
permutation, the last batch wrapping to its head.
"""

import numpy as np
import pytest
import torch
from scipy import stats

from gcn_recommendation_tpu.data.sampler import membership_arrays as jax_membership
from gcn_recommendation_tpu_torch.data.sampler import (
    epoch_batches,
    membership_arrays,
    positive_keys,
    sample_negatives,
)
from test_torch_spmm import one_thread  # noqa: F401  (autouse: one thread)

NUM_ITEMS = 10


def _toy_keys():
    # user 0: items {0,1,2}; user 1: {3}; user 2: {} (no positives)
    users = np.array([0, 0, 0, 1], np.int32)
    items = np.array([2, 0, 1, 3], np.int32)
    ptr, flat = membership_arrays(users, items, num_users=3)
    return torch.from_numpy(positive_keys(ptr, flat, NUM_ITEMS))


def _gen(seed):
    return torch.Generator().manual_seed(seed)


def test_membership_arrays_equal_jax():
    rng = np.random.default_rng(0)
    u = rng.integers(0, 50, 400).astype(np.int32)
    i = rng.integers(0, 80, 400).astype(np.int32)
    for a, b in zip(membership_arrays(u, i, 60), jax_membership(u, i, 60)):
        np.testing.assert_array_equal(a, b)


def test_positive_keys_sorted_and_exact():
    keys = _toy_keys().numpy()
    np.testing.assert_array_equal(keys, [0, 1, 2, 13])


def test_negatives_never_positive():
    keys = _toy_keys()
    users = torch.from_numpy(np.repeat([0, 1, 2], 500))
    negs = sample_negatives(_gen(0), users, keys, num_items=NUM_ITEMS, n_rounds=24)
    pos_sets = {0: {0, 1, 2}, 1: {3}, 2: set()}
    assert negs.dtype == torch.int64 and negs.shape == users.shape
    for u, n in zip(users.tolist(), negs.tolist()):
        assert n not in pos_sets[u] and 0 <= n < NUM_ITEMS


def test_negatives_uniform_over_non_positives():
    negs = sample_negatives(
        _gen(1), torch.zeros(70_000, dtype=torch.int64), _toy_keys(),
        num_items=NUM_ITEMS, n_rounds=24,
    ).numpy()
    counts = np.bincount(negs, minlength=NUM_ITEMS)
    assert counts[:3].sum() == 0
    # chi-square goodness of fit against uniform over items 3..9
    assert stats.chisquare(counts[3:]).pvalue > 1e-3
    np.testing.assert_allclose(counts[3:], len(negs) / 7, rtol=0.05)


def test_six_rounds_keep_the_last_draw_when_all_collide():
    # user 0 owns every item but one: with 6 rounds some draws collide in
    # every round and keep the last draw (the p**6 residual of the JAX rule)
    keys = torch.arange(NUM_ITEMS - 1, dtype=torch.int64)
    negs = sample_negatives(_gen(2), torch.zeros(20_000, dtype=torch.int64), keys,
                            num_items=NUM_ITEMS).numpy()
    clean = (negs == NUM_ITEMS - 1).mean()
    np.testing.assert_allclose(clean, 1 - 0.9**6, atol=0.02)


def test_sampler_deterministic_per_generator_and_shapes():
    keys = _toy_keys()
    users = torch.tensor([[0, 1, 2, 0]] * 8)
    a = sample_negatives(_gen(7), users, keys, num_items=NUM_ITEMS)
    b = sample_negatives(_gen(7), users, keys, num_items=NUM_ITEMS)
    c = sample_negatives(_gen(8), users, keys, num_items=NUM_ITEMS)
    assert a.shape == users.shape
    assert torch.equal(a, b) and not torch.equal(a, c)


def test_no_positives_at_all():
    negs = sample_negatives(_gen(0), torch.zeros(100, dtype=torch.int64),
                            torch.zeros(0, dtype=torch.int64), num_items=NUM_ITEMS)
    assert ((negs >= 0) & (negs < NUM_ITEMS)).all()


@pytest.mark.parametrize("n,batch", [(103, 16), (64, 8), (50, 128)])
def test_epoch_batches_cover_a_permutation_with_wrap(n, batch):
    idx = epoch_batches(_gen(0), n, batch).numpy()
    steps = -(-n // batch)
    assert idx.shape == (steps, batch)
    flat = idx.reshape(-1)
    np.testing.assert_array_equal(np.sort(flat[:n]), np.arange(n))
    # the tail wraps to the head of the same permutation
    np.testing.assert_array_equal(flat[n:], np.tile(flat[:n], -(-len(flat) // n))[: len(flat) - n])


def test_epoch_batches_shuffle_between_generators():
    a = epoch_batches(_gen(0), 64, 8)
    b = epoch_batches(_gen(1), 64, 8)
    assert not torch.equal(a, b)
