"""Runtime data loading and graph assembly (host side, numpy).

A copy of ``gcn_recommendation_tpu/data/loader.py``: reads
``train.parquet`` / ``test.parquet`` / ``item_brand.parquet`` +
``stats.json``, takes each user's first train row as validation
(main.py:201-203), computes the graph statistics (main.py:213-279) and
builds the normalized adjacency.  ``pandas`` is imported only inside
``load_preprocessed_data``, so the in-memory synthetic path runs without
it.
"""

from __future__ import annotations

import dataclasses
import json
import os
from typing import Dict, Optional, Tuple

import numpy as np

from gcn_recommendation_tpu_torch.data.parquet import read_columns
from gcn_recommendation_tpu_torch.graph.build import Graph, build_normalized_adjacency


@dataclasses.dataclass
class Interactions:
    """A set of (user, item) interactions as parallel arrays."""

    user_idx: np.ndarray  # int32
    item_idx: np.ndarray  # int32

    def __len__(self):
        return len(self.user_idx)


@dataclasses.dataclass
class ItemBrand:
    """Item->brand (attribute) association pairs; items may repeat."""

    item_idx: np.ndarray   # int32
    brand_idx: np.ndarray  # int32

    def __len__(self):
        return len(self.item_idx)


@dataclasses.dataclass
class DataBundle:
    train: Interactions
    val: Interactions
    test: Interactions
    num_users: int
    num_items: int
    num_brands: int
    graph: Graph
    item_brand: ItemBrand
    item_to_brand: np.ndarray  # [num_items] int32, first brand or -1
    graph_stats: Dict[str, float]


def _first_row_per_user_split(
    user_idx: np.ndarray, item_idx: np.ndarray
) -> Tuple[Interactions, Interactions]:
    """val = first-appearing row per user, train = rest (main.py:201-203)."""
    _, first_pos = np.unique(user_idx, return_index=True)
    is_val = np.zeros(len(user_idx), dtype=bool)
    is_val[first_pos] = True
    val = Interactions(user_idx[is_val], item_idx[is_val])
    train = Interactions(user_idx[~is_val], item_idx[~is_val])
    return train, val


def compute_graph_stats(
    train: Interactions,
    item_brand: ItemBrand,
    num_users: int,
    num_items: int,
    num_brands: int,
    use_brand: bool,
) -> Dict[str, float]:
    """Graph structure statistics, mirroring main.py:213-258."""
    s: Dict[str, float] = {}
    s["num_users"] = num_users
    s["num_items"] = num_items
    s["num_brands"] = num_brands
    s["total_nodes"] = (
        num_users + num_items + num_brands if use_brand else num_users + num_items
    )
    total = len(train)
    s["total_user_item_interactions"] = total

    def _group_nunique(keys, values):
        # per-key count of distinct values, for keys present in the data
        if len(keys) == 0:
            return np.zeros(0, dtype=np.int64)
        pair = np.unique(
            np.stack([keys.astype(np.int64), values.astype(np.int64)]), axis=1
        )
        counts = np.bincount(pair[0])
        return counts[counts > 0]

    upc = _group_nunique(train.user_idx, train.item_idx)
    if len(upc):
        s["avg_items_per_user"] = round(float(upc.mean()), 2)
        s["median_items_per_user"] = round(float(np.median(upc)), 2)
        s["max_items_per_user"] = int(upc.max())
        s["min_items_per_user"] = int(upc.min())
    ipc = _group_nunique(train.item_idx, train.user_idx)
    if len(ipc):
        s["avg_users_per_item"] = round(float(ipc.mean()), 2)
        s["median_users_per_item"] = round(float(np.median(ipc)), 2)
        s["max_users_per_item"] = int(ipc.max())
        s["min_users_per_item"] = int(ipc.min())

    ibc = _group_nunique(item_brand.item_idx, item_brand.brand_idx)
    if len(ibc):
        s["avg_brands_per_item"] = round(float(ibc.mean()), 2)
        s["median_brands_per_item"] = round(float(np.median(ibc)), 2)
    bic = _group_nunique(item_brand.brand_idx, item_brand.item_idx)
    if len(bic):
        s["avg_items_per_brand"] = round(float(bic.mean()), 2)
        s["median_items_per_brand"] = round(float(np.median(bic)), 2)
        s["max_items_per_brand"] = int(bic.max())
        s["min_items_per_brand"] = int(bic.min())

    if num_users * num_items:
        s["user_item_graph_density"] = round(total / (num_users * num_items) * 100, 6)
    if use_brand and num_brands * num_items:
        s["brand_item_graph_density"] = round(
            len(item_brand) / (num_brands * num_items) * 100, 6
        )
    return s


def print_graph_stats(s: Dict[str, float], use_brand: bool) -> None:
    """Formatted stats block, mirroring main.py:261-279."""
    print("\n" + "=" * 40 + " Graph Structure Statistics " + "=" * 40)
    print("[Basic Node Count]")
    print(f"  - Users: {s['num_users']:,}")
    print(f"  - Items: {s['num_items']:,}")
    print(f"  - Brands (Attributes): {s['num_brands']:,}")
    print(f"  - Total Nodes (with brand): {s['total_nodes']:,}")
    print("\n[User-Item Interaction]")
    print(f"  - Total Interactions: {s['total_user_item_interactions']:,}")
    if "avg_items_per_user" in s:
        print(
            f"  - Avg Items per User: {s['avg_items_per_user']}"
            f" (median: {s['median_items_per_user']})"
        )
        print(
            f"  - Avg Users per Item: {s['avg_users_per_item']}"
            f" (median: {s['median_users_per_item']})"
        )
    if "user_item_graph_density" in s:
        d = s["user_item_graph_density"]
        print(f"  - User-Item Graph Density: {d}% (sparsity: {100 - d:.6f}%)")
    print("\n[Item-Brand (Attribute) Association]")
    if "avg_brands_per_item" in s:
        print(
            f"  - Avg Brands per Item: {s['avg_brands_per_item']}"
            f" (median: {s['median_brands_per_item']})"
        )
    if "avg_items_per_brand" in s:
        print(
            f"  - Avg Items per Brand: {s['avg_items_per_brand']}"
            f" (median: {s['median_items_per_brand']})"
        )
    if use_brand and "brand_item_graph_density" in s:
        print(f"  - Brand-Item Graph Density: {s['brand_item_graph_density']}%")
    print("=" * 90 + "\n")


def load_preprocessed_data(
    data_dir: str,
    use_brand: bool = True,
    debug: bool = False,
    rng: Optional[np.random.Generator] = None,
    verbose: bool = True,
    pad_multiple: int = 1024,
) -> DataBundle:
    """Load processed parquet artifacts and build the normalized graph."""
    stats_path = os.path.join(data_dir, "stats.json")
    if not os.path.exists(stats_path):
        raise FileNotFoundError(
            f"Stats file not found in '{data_dir}'. Please run data preparation first."
        )

    all_train = read_columns(os.path.join(data_dir, "train.parquet"))
    test_cols = read_columns(os.path.join(data_dir, "test.parquet"))
    item_brand_cols = read_columns(os.path.join(data_dir, "item_brand.parquet"))

    with open(stats_path) as f:
        base_stats = json.load(f)
    num_users = int(base_stats["num_users"])
    num_items = int(base_stats["num_items"])
    num_brands = int(base_stats["num_brands"])

    tr_u = all_train["user_idx"].astype(np.int32)
    tr_i = all_train["item_idx"].astype(np.int32)
    te_u = test_cols["user_idx"].astype(np.int32)
    te_i = test_cols["item_idx"].astype(np.int32)
    if debug:
        # 1% user subsample, >=1 user (main.py:191-198); the users in order
        # of first appearance, as pandas' Series.unique gives them
        rng = rng or np.random.default_rng(42)
        uniq, first = np.unique(tr_u, return_index=True)
        unique_users = uniq[np.argsort(first, kind="stable")]
        sample_size = max(1, int(len(unique_users) * 0.01))
        sample_users = rng.choice(unique_users, size=sample_size, replace=False)
        keep_tr, keep_te = np.isin(tr_u, sample_users), np.isin(te_u, sample_users)
        tr_u, tr_i = tr_u[keep_tr], tr_i[keep_tr]
        te_u, te_i = te_u[keep_te], te_i[keep_te]
        if verbose:
            print("\n[Debug Mode] Using 1.0% of the original data")

    train, val = _first_row_per_user_split(tr_u, tr_i)
    test = Interactions(te_u, te_i)
    item_brand = ItemBrand(
        item_brand_cols["item_idx"].astype(np.int32),
        item_brand_cols["brand_idx"].astype(np.int32),
    )

    graph_stats = compute_graph_stats(
        train, item_brand, num_users, num_items, num_brands, use_brand
    )
    if verbose:
        print_graph_stats(graph_stats, use_brand)

    graph = build_normalized_adjacency(
        train.user_idx,
        train.item_idx,
        num_users,
        num_items,
        num_brands,
        item_brand_item_idx=item_brand.item_idx,
        item_brand_brand_idx=item_brand.brand_idx,
        use_brand=use_brand,
        pad_multiple=pad_multiple,
    )
    if verbose:
        print(f"[Adjacency] nodes={graph.num_nodes:,} nnz={graph.nnz:,} "
              f"buckets={len(graph.buckets)}")
        print(f"[Final Data Overview] train={len(train):,} val={len(val):,} "
              f"test={len(test):,}")

    # dense item->brand map: first brand per item, -1 when unknown
    item_to_brand = np.full(num_items, -1, dtype=np.int32)
    if len(item_brand):
        # reversed so the FIRST occurrence wins
        item_to_brand[item_brand.item_idx[::-1]] = item_brand.brand_idx[::-1]

    return DataBundle(
        train=train,
        val=val,
        test=test,
        num_users=num_users,
        num_items=num_items,
        num_brands=num_brands,
        graph=graph,
        item_brand=item_brand,
        item_to_brand=item_to_brand,
        graph_stats=graph_stats,
    )
