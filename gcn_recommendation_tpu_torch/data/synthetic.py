"""Synthetic dataset generation (host side, numpy).

A copy of the popularity-style generator of
``gcn_recommendation_tpu/data/synthetic.py``: Zipf-ish item popularity,
lognormal user activity floored at ``core``, leave-one-out random split.
The same seed draws the same numbers in the same order as the JAX
package, so both build the same bundle.  The latent-factor styles of the
JAX package (regime calibration for training) are not carried over.
"""

from __future__ import annotations

import json
import os
from typing import Optional, Tuple

import numpy as np


def generate_interactions(
    rng: np.random.Generator,
    num_users: int,
    num_items: int,
    mean_degree: float,
    core: int,
) -> Tuple[np.ndarray, np.ndarray]:
    """Sample (user, item) pairs with power-law popularity, deduplicated."""
    deg = np.maximum(
        core, rng.lognormal(np.log(mean_degree), 0.6, num_users)
    ).astype(np.int64)
    deg = np.minimum(deg, num_items)
    total = int(deg.sum())
    users = np.repeat(np.arange(num_users, dtype=np.int64), deg)
    ranks = rng.permutation(num_items).astype(np.float64)
    probs = 1.0 / (ranks + 10.0)
    probs /= probs.sum()
    items = rng.choice(num_items, size=total, p=probs)
    key = users * num_items + items
    _, keep = np.unique(key, return_index=True)
    keep.sort()
    return users[keep].astype(np.int32), items[keep].astype(np.int32)


def _keep_users_with_three(users, items, num_users):
    """Keep users with >= 3 interactions so every user survives the test
    split plus the validation split."""
    counts = np.bincount(users, minlength=num_users)
    ok = counts[users] >= 3
    return users[ok], items[ok]


def _first_row_mask(users: np.ndarray) -> np.ndarray:
    _, first = np.unique(users, return_index=True)
    mask = np.zeros(len(users), dtype=bool)
    mask[first] = True
    return mask


def generate_synthetic_dataset(
    out_dir: str,
    num_users: int = 2000,
    num_items: int = 1000,
    num_brands: int = 50,
    mean_degree: float = 20.0,
    core: int = 5,
    seed: int = 42,
    embedding_dim: Optional[int] = None,
) -> str:
    """Write a synthetic processed dataset (``train.parquet``,
    ``test.parquet``, ``item_brand.parquet``, ``stats.json`` and, with
    ``embedding_dim``, ``item_embeddings.npy``); returns the output dir."""
    import pandas as pd

    rng = np.random.default_rng(seed)
    users, items = generate_interactions(rng, num_users, num_items, mean_degree, core)
    users, items = _keep_users_with_three(users, items, num_users)

    # leave-one-out: one random interaction per user -> test
    order = rng.permutation(len(users))
    u_shuf, i_shuf = users[order], items[order]
    is_test = _first_row_mask(u_shuf)
    train_u, train_i = u_shuf[~is_test], i_shuf[~is_test]
    test_u, test_i = u_shuf[is_test], i_shuf[is_test]

    # one or two brands per item
    brand1 = rng.integers(0, num_brands, num_items)
    has2 = rng.random(num_items) < 0.3
    brand2 = rng.integers(0, num_brands, num_items)
    ib_item = np.concatenate([np.arange(num_items), np.arange(num_items)[has2]])
    ib_brand = np.concatenate([brand1, brand2[has2]])

    os.makedirs(out_dir, exist_ok=True)
    pd.DataFrame({"user_idx": train_u, "item_idx": train_i}).to_parquet(
        os.path.join(out_dir, "train.parquet"), index=False
    )
    pd.DataFrame({"user_idx": test_u, "item_idx": test_i}).to_parquet(
        os.path.join(out_dir, "test.parquet"), index=False
    )
    pd.DataFrame(
        {"item_idx": ib_item.astype(np.int32), "brand_idx": ib_brand.astype(np.int32)}
    ).to_parquet(os.path.join(out_dir, "item_brand.parquet"), index=False)
    with open(os.path.join(out_dir, "stats.json"), "w") as f:
        json.dump(
            {
                "num_users": int(num_users),
                "num_items": int(num_items),
                "num_brands": int(num_brands),
            },
            f,
        )
    if embedding_dim:
        emb = rng.standard_normal((num_items, embedding_dim)).astype(np.float32)
        np.save(os.path.join(out_dir, "item_embeddings.npy"), emb)
    return out_dir


def synthetic_bundle(
    num_users: int = 512,
    num_items: int = 256,
    num_brands: int = 32,
    mean_degree: float = 16.0,
    core: int = 4,
    seed: int = 0,
    use_brand: bool = True,
):
    """Build a DataBundle fully in memory (no parquet round trip):
    test = one random row per user, val = the next, train = the rest."""
    from gcn_recommendation_tpu_torch.data.loader import (
        DataBundle,
        Interactions,
        ItemBrand,
        compute_graph_stats,
    )
    from gcn_recommendation_tpu_torch.graph.build import build_normalized_adjacency

    rng = np.random.default_rng(seed)
    users, items = generate_interactions(rng, num_users, num_items, mean_degree, core)
    users, items = _keep_users_with_three(users, items, num_users)

    order = rng.permutation(len(users))
    u_shuf, i_shuf = users[order], items[order]
    mask = _first_row_mask(u_shuf)
    test = Interactions(u_shuf[mask], i_shuf[mask])
    rest_u, rest_i = u_shuf[~mask], i_shuf[~mask]
    mask2 = _first_row_mask(rest_u)
    val = Interactions(rest_u[mask2], rest_i[mask2])
    train = Interactions(rest_u[~mask2], rest_i[~mask2])

    brand1 = rng.integers(0, num_brands, num_items).astype(np.int32)
    item_brand = ItemBrand(np.arange(num_items, dtype=np.int32), brand1)

    graph = build_normalized_adjacency(
        train.user_idx,
        train.item_idx,
        num_users,
        num_items,
        num_brands,
        item_brand_item_idx=item_brand.item_idx,
        item_brand_brand_idx=item_brand.brand_idx,
        use_brand=use_brand,
    )
    stats = compute_graph_stats(
        train, item_brand, num_users, num_items, num_brands, use_brand
    )
    return DataBundle(
        train=train,
        val=val,
        test=test,
        num_users=num_users,
        num_items=num_items,
        num_brands=num_brands,
        graph=graph,
        item_brand=item_brand,
        item_to_brand=brand1.copy(),
        graph_stats=stats,
    )
