"""Offline data preparation (ETL).

The reference ships five near-clone ``prepare_data.py`` scripts (SURVEY.md
§2.1 #14-18).  Here the shared pipeline is written once —

    parse reviews -> K-core filter -> parse metadata -> dense ID maps ->
    leave-one-out split -> parquet + stats.json [+ item_embeddings.npy]

— and each dataset is a declarative ``Recipe`` describing only what
differs: the review filter/fields, the brand/category extractor, the
split rule, defaults, and the output-dir suffix.

Recipe parity (each bullet cites the reference script it reproduces):

* ``amazon_books`` — all reviews (user_id, parent_asin, rating); brand =
  author['name'] if author is a dict else 'Unknown'; rating-rank split;
  20-core (dataset/amazon_books/prepare_data.py:33,59-65,95-97,122).
* ``amazon_books_senti`` — same shape; brand = details.Brand
  (dataset/amazon_books_senti/prepare_data.py:58).
* ``amazon_books_emb`` — sentiment=='positive' only; item_id key;
  categories[1:3] as multi-label "brands"; 'embd' vectors ->
  item_embeddings.npy; K-core skipped when <=1; ``_pos_only_cat`` suffix
  (dataset/amazon_books_emb/prepare_data.py:34,10-21,87-89,130).
* ``amazon_sport_emb`` — as books_emb with metadata key parent_asin and
  9-core default (dataset/amazon_sport_emb/prepare_data.py:78,166).
* ``steam_emb`` — recommanded is True; categories = genres + tags keys;
  temporal leave-one-out split by timestamp; 16-core
  (dataset/steam_emb/prepare_data.py:21,66-73,104-112,149).

The port's own copy of ``gcn_recommendation_tpu/data/prepare.py``, held
against it file for file by ``tests/test_torch_prepare.py``.  It needs no
pandas: the JAX package's frame operations (``factorize``, ``unique`` /
``map``, ``nunique``, the split's ``sort_values`` + ``cumcount`` and
``rank(method="first")``) are numpy and dicts here, with pandas'
treatment of the ids kept (``_factorize``): equal ids collapse as in its
hashtable (``1``, ``1.0`` and ``True`` are one id, ``12345`` and
``"12345"`` two), and a NaN id is one id, which a metadata record finds
only where pandas keeps the parsed NaN object (a column of mixed types).
The parquet files are written by the port's ``data/parquet.py``.  The
K-core filter runs in the native C++ library (``data/native_ext.py``)
when it loads and in numpy otherwise; both give the same mask.
"""

from __future__ import annotations

import dataclasses
import json
import os
from operator import itemgetter
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np

from gcn_recommendation_tpu_torch.data.parquet import write_columns


# ---------------------------------------------------------------------------
# K-core filtering
# ---------------------------------------------------------------------------

def kcore_filter(
    users: np.ndarray, items: np.ndarray, k: int
) -> np.ndarray:
    """Boolean keep-mask after iterative K-core filtering.

    Iterates until every remaining user and item has >= k interactions
    (reference loop at dataset/amazon_books/prepare_data.py:39-48).
    Uses the native C++ implementation when it loads.
    """
    from gcn_recommendation_tpu_torch.data import native_ext

    if native_ext.available():
        return native_ext.kcore_filter_native(users, items, k)

    keep = np.ones(len(users), dtype=bool)
    if k <= 1:
        return keep
    u = users.copy()
    it = items.copy()
    idx = np.arange(len(users))
    while True:
        uc = np.unique(u, return_counts=True)
        ic = np.unique(it, return_counts=True)
        weak_u = set(uc[0][uc[1] < k].tolist())
        weak_i = set(ic[0][ic[1] < k].tolist())
        if not weak_u and not weak_i:
            break
        m = ~(np.isin(u, list(weak_u)) | np.isin(it, list(weak_i)))
        u, it, idx = u[m], it[m], idx[m]
    keep[:] = False
    keep[idx] = True
    return keep


# ---------------------------------------------------------------------------
# Recipes
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class Recipe:
    name: str
    # review-record -> (user_id, item_id, order_value) or None to drop
    parse_review: Callable[[dict], Optional[Tuple[str, str, float]]]
    # metadata-record -> (item_id, [brands], embedding-or-None) or None
    parse_meta: Callable[[dict], Optional[Tuple[str, List[str], Optional[list]]]]
    split: str  # 'rating_rank' (highest value first = test) or 'timestamp'
    default_core: int
    out_suffix: str  # '' or '_pos_only_cat'
    kcore_skippable: bool  # skip the loop when core <= 1


def _author_brand(rec):
    author = rec.get("author")
    brand = author.get("name", "Unknown") if isinstance(author, dict) else "Unknown"
    return brand


def _meaningful_categories(categories):
    """categories[1] and [2] when present, else ['Unknown']
    (dataset/amazon_books_emb/prepare_data.py:10-21)."""
    out = []
    if isinstance(categories, list) and len(categories) > 1:
        out.append(categories[1])
        if len(categories) > 2:
            out.append(categories[2])
    return out if out else ["Unknown"]


def _mk_recipes() -> Dict[str, Recipe]:
    def books_review(rec):
        u, i, r = rec.get("user_id"), rec.get("parent_asin"), rec.get("rating")
        if u is None or i is None or r is None:
            return None
        return u, i, float(r)

    def books_meta(rec):
        i = rec.get("parent_asin")
        if i is None:
            return None
        return i, [_author_brand(rec)], None

    def senti_meta(rec):
        i = rec.get("parent_asin")
        if i is None:
            return None
        brand = (rec.get("details") or {}).get("Brand", "Unknown")
        return i, [brand], None

    def emb_review(rec):
        if rec.get("sentiment") != "positive":
            return None
        u, i, r = rec.get("user_id"), rec.get("item_id"), rec.get("rating")
        if u is None or i is None or r is None:
            return None
        return u, i, float(r)

    def emb_meta_key(key):
        def parse(rec):
            i = rec.get(key)
            if i is None:
                return None
            cats = _meaningful_categories(rec.get("categories", []))
            return i, cats, rec.get("embd")

        return parse

    def steam_review(rec):
        if rec.get("recommanded") is not True:
            return None
        u, i, t = rec.get("user_id"), rec.get("item_id"), rec.get("timestamp")
        if u is None or i is None or t is None:
            return None
        return u, i, float(t)

    def steam_meta(rec):
        i = rec.get("item_id")
        if i is None:
            return None
        genres = rec.get("genres", []) or []
        tags = list((rec.get("tags") or {}).keys())
        cats = sorted(set(genres + tags))  # deterministic order (the
        # reference used an unordered set — dataset/steam_emb/prepare_data.py:71)
        return i, cats if cats else ["Unknown"], rec.get("embd")

    return {
        "amazon_books": Recipe(
            "amazon_books", books_review, books_meta, "rating_rank", 20, "", False
        ),
        "amazon_books_senti": Recipe(
            "amazon_books_senti", books_review, senti_meta, "rating_rank", 20, "", False
        ),
        "amazon_books_emb": Recipe(
            "amazon_books_emb", emb_review, emb_meta_key("item_id"),
            "rating_rank", 20, "_pos_only_cat", True,
        ),
        "amazon_sport_emb": Recipe(
            "amazon_sport_emb", emb_review, emb_meta_key("parent_asin"),
            "rating_rank", 9, "_pos_only_cat", True,
        ),
        "steam_emb": Recipe(
            "steam_emb", steam_review, steam_meta,
            "timestamp", 16, "_pos_only_cat", True,
        ),
    }


RECIPES = _mk_recipes()


# ---------------------------------------------------------------------------
# Pipeline
# ---------------------------------------------------------------------------

def _iter_jsonl(path: str, label: str):
    """Stream records from a .jsonl file, tolerating real-dump dirt.

    Raw Amazon/Steam dumps contain occasional truncated/garbage lines and
    non-object rows; the reference scripts would die on the first one
    (bare ``json.loads`` per line).  Malformed and non-dict lines are
    skipped and counted; a summary prints at the end so silent data loss
    is visible.
    """
    bad = nondict = 0
    with open(path, encoding="utf-8", errors="replace") as f:
        for line in f:
            line = line.strip()
            if not line:
                continue
            try:
                rec = json.loads(line)
            except (json.JSONDecodeError, ValueError):
                bad += 1
                continue
            if not isinstance(rec, dict):
                nondict += 1
                continue
            yield rec
    if bad or nondict:
        print(
            f"WARNING: {label}: skipped {bad} malformed and {nondict} "
            f"non-object lines in {os.path.basename(path)}"
        )


def _safe_parse(parse, rec):
    """Apply a recipe parser, dropping records whose field *types* are
    garbage (e.g. rating='five', tags as a list) instead of crashing."""
    try:
        return parse(rec)
    except (TypeError, ValueError, AttributeError, KeyError):
        return None


# A NaN id in a column that pandas stores as float64 or as strings is a
# missing value: one class of its own, but no metadata record's id equals
# it.  In a column of mixed types pandas keeps the parsed NaN object, and
# the metadata's NaN, the same object (``json`` parses every NaN into one),
# finds it.
_MISSING = object()


def _first_appearance(codes: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """``codes`` renumbered 0.. in order of first appearance (int32, as
    pandas' ``unique`` + ``map``), and the code of each new number."""
    uniq, first, inv = np.unique(codes, return_index=True, return_inverse=True)
    order = np.argsort(first)
    rank = np.empty(len(uniq), np.int64)
    rank[order] = np.arange(len(uniq))
    return rank[inv.reshape(-1)].astype(np.int32), uniq[order]


def _is_float_column(values: list, types: set) -> bool:
    """Whether ``pandas.DataFrame`` stores these parsed ids as float64:
    ints and floats, with every int inside int64's or uint64's range."""
    if not (types <= {int, float} and float in types):
        return False
    # the distinct (type, id) pairs: an int equal to a float id still counts
    ints = [v for t, v in dict.fromkeys(zip(map(type, values), values)) if t is int]
    lo, hi = min(ints, default=0), max(ints, default=0)
    return -(1 << 63) <= lo and hi < (1 << 63) or 0 <= lo and hi < (1 << 64)


def _factorize(values: list) -> Tuple[np.ndarray, list, int]:
    """One id column as pandas treats it: (codes, classes numbered
    in order of first appearance; the key that looks up each class; the
    class of NaN ids, or -1).  An unhashable id raises ``TypeError``, as in
    pandas."""
    types = set(map(type, values))
    if _is_float_column(values, types):
        x = np.array(values, dtype=np.float64)  # large ints round as in pandas
        uniq, inv = np.unique(x, return_inverse=True)  # NaNs are one value
        codes, classes = _first_appearance(inv.reshape(-1))
        keys = [_MISSING if v != v else v for v in uniq[classes].tolist()]
    else:
        keys = list(dict.fromkeys(values))
        index = dict(zip(keys, range(len(keys))))
        codes = np.fromiter(map(index.__getitem__, values), np.int64, len(values))
        floats = [k for k in keys if type(k) is float]
        if str in types and types <= {str, float} and all(k != k for k in floats):
            # strings and NaN: pandas' string column, where NaN is missing
            keys = [_MISSING if type(k) is float else k for k in keys]
    nan = [c for c, k in enumerate(keys) if k is _MISSING or (type(k) is float and k != k)]
    return codes, keys, nan[0] if nan else -1


def prepare_and_save_data(
    recipe: Recipe,
    review_path: str,
    meta_path: str,
    output_base_dir: str,
    core: Optional[int] = None,
) -> str:
    core = recipe.default_core if core is None else core
    print(f"--- Starting Data Preparation ({recipe.name}) ---")

    # 1. reviews
    rows = []
    dropped = 0
    for rec in _iter_jsonl(review_path, "reviews"):
        parsed = _safe_parse(recipe.parse_review, rec)
        if parsed is not None:
            rows.append(parsed)
        else:
            dropped += 1
    if dropped:
        print(f"Dropped {dropped} review records (filtered or unusable fields).")
    if not rows:
        print("Error: no usable reviews found.")
        return ""
    print(f"Loaded {len(rows)} interactions initially.")
    user_codes, user_keys, user_nan = _factorize(list(map(itemgetter(0), rows)))
    item_codes, item_keys, item_nan = _factorize(list(map(itemgetter(1), rows)))
    order_value = np.fromiter(map(itemgetter(2), rows), np.float64, len(rows))
    del rows

    # 2. K-core
    if recipe.kcore_skippable and core <= 1:
        keep = np.ones(len(order_value), dtype=bool)
    else:
        keep = kcore_filter(user_codes, item_codes, core)
    # 3. dense ID maps (first-appearance order, like the reference's
    #    dict-comprehension over .unique())
    user_idx, user_classes = _first_appearance(user_codes[keep])
    item_idx, item_classes = _first_appearance(item_codes[keep])
    order_value = order_value[keep]
    print(
        f"Filtered to {len(order_value)} interactions, "
        f"{len(user_classes) - int(user_nan in user_classes)} users, "
        f"{len(item_classes) - int(item_nan in item_classes)} items."
    )
    item_map = {item_keys[c]: k for k, c in enumerate(item_classes.tolist())}

    # 4. metadata
    meta_brands: Dict[str, List[str]] = {}
    meta_embeddings: Dict[str, list] = {}
    for rec in _iter_jsonl(meta_path, "metadata"):
        parsed = _safe_parse(recipe.parse_meta, rec)
        if parsed is None:
            continue
        item_id, brands, embd = parsed
        if item_id not in item_map:
            continue
        # brand labels must be hashable strings — real category lists
        # occasionally contain None / numbers / nested lists
        meta_brands[item_id] = [
            b if isinstance(b, str) else str(b) for b in brands
        ]
        if embd:
            meta_embeddings[item_id] = embd
    print(f"Extracted brand/category metadata for {len(meta_brands)} items.")

    ib_items, ib_brands = [], []
    for item_id, brands in meta_brands.items():
        for b in brands:
            ib_items.append(item_id)
            ib_brands.append(b)
    brand_map: Dict[str, int] = {}
    for b in ib_brands:
        if b not in brand_map:
            brand_map[b] = len(brand_map)
    ib_item_idx = np.array(
        [item_map[i] for i in ib_items if i in item_map], dtype=np.int32
    )
    ib_brand_idx = np.array(
        [brand_map[b] for i, b in zip(ib_items, ib_brands) if i in item_map],
        dtype=np.int32,
    )

    # 5. leave-one-out split: each user's rows in rank order, ties by
    #    appearance (np.lexsort is stable)
    test_mask = np.zeros(len(order_value), dtype=bool)
    if recipe.split == "timestamp":
        # newest interaction per user = test (steam_emb/prepare_data.py:104-112):
        # the last of the user's rows in ascending time, NaN times last.
        # Documented deviation: the reference's sort_values default is an
        # UNSTABLE quicksort, so among tied max-timestamps it picks an
        # arbitrary (platform/version-dependent) row; the stable order here
        # deterministically keeps the last-in-file row.  Splits therefore
        # differ on users whose newest interactions share a timestamp —
        # both choices are uniform over the tie set, but cross-pipeline
        # split comparisons must account for it.
        by_user = np.lexsort((order_value, user_idx))
        u = user_idx[by_user]
        test_mask[by_user[np.diff(u, append=-1) != 0]] = True
        # the files keep the frame's stable time order
        rows = np.argsort(order_value, kind="stable")
    else:
        # highest rating first, ties by appearance (rating-rank recipes,
        # amazon_books/prepare_data.py:95-97); a NaN rating has no rank, so
        # a user whose ratings are all NaN has no test row
        rated = np.flatnonzero(~np.isnan(order_value))
        by_user = rated[np.lexsort((-order_value[rated], user_idx[rated]))]
        u = user_idx[by_user]
        test_mask[by_user[np.diff(u, prepend=-1) != 0]] = True
        rows = np.arange(len(order_value))
    test_rows, train_rows = rows[test_mask[rows]], rows[~test_mask[rows]]
    print(f"Split to {len(train_rows)} training and {len(test_rows)} testing interactions.")

    # 6. save artifacts
    out_dir = os.path.join(
        output_base_dir, f"processed_data_{core}{recipe.out_suffix}"
    )
    os.makedirs(out_dir, exist_ok=True)
    for name, r in (("train", train_rows), ("test", test_rows)):
        write_columns(os.path.join(out_dir, f"{name}.parquet"),
                      {"user_idx": user_idx[r], "item_idx": item_idx[r]})
    write_columns(os.path.join(out_dir, "item_brand.parquet"),
                  {"item_idx": ib_item_idx, "brand_idx": ib_brand_idx})
    if meta_embeddings:
        # embd_dim = the MODAL length over all parseable finite vectors —
        # never the first record's, which on a dirty dump can be a scalar
        # (len() crash) or a truncated list (silently rejecting every
        # valid vector and saving a wrong-dim near-zero matrix).
        from collections import Counter

        length_counts: Counter = Counter()
        for e in meta_embeddings.values():
            try:
                v = np.asarray(e, dtype=np.float32)
            except (TypeError, ValueError):
                continue
            if v.ndim == 1 and v.shape[0] > 0 and np.isfinite(v).all():
                length_counts[int(v.shape[0])] += 1
        if not length_counts:
            print("WARNING: no usable 'embd' vectors in the metadata dump; "
                  "skipping item_embeddings.npy.")
        else:
            embd_dim = length_counts.most_common(1)[0][0]
            mat = np.zeros((len(item_map), embd_dim), dtype=np.float32)
            bad_embd = 0
            for item_id, e in meta_embeddings.items():
                idx = item_map.get(item_id)
                if idx is None or idx >= len(item_map):
                    continue
                try:
                    v = np.asarray(e, dtype=np.float32)
                except (TypeError, ValueError):
                    bad_embd += 1
                    continue
                if v.shape != (embd_dim,) or not np.isfinite(v).all():
                    bad_embd += 1  # wrong length / nested / NaN vectors
                    continue
                mat[idx] = v
            if bad_embd:
                print(f"WARNING: skipped {bad_embd} unusable 'embd' vectors "
                      f"(wrong length / non-numeric / non-finite); rows stay zero.")
            np.save(os.path.join(out_dir, "item_embeddings.npy"), mat)
            print("Item embeddings saved to 'item_embeddings.npy'.")
    with open(os.path.join(out_dir, "stats.json"), "w") as f:
        json.dump(
            {
                "num_users": len(user_classes),
                "num_items": len(item_map),
                "num_brands": len(brand_map),
            },
            f,
        )
    print(f"--- Data Preparation Finished --- ({out_dir})")
    return out_dir


def run_recipe(args) -> int:
    """CLI dispatch for ``prepare`` (see cli.py)."""
    if args.recipe == "synthetic":
        from gcn_recommendation_tpu_torch.data.synthetic import generate_synthetic_dataset

        core = args.core if args.core is not None else 16
        out = args.output_dir or os.path.join(
            "dataset", "synthetic", f"processed_data_{core}"
        )
        generate_synthetic_dataset(
            out,
            num_users=args.num_users,
            num_items=args.num_items,
            num_brands=args.num_brands,
            mean_degree=args.mean_degree,
            core=core,
            seed=args.seed,
            embedding_dim=args.embedding_dim,
            style=getattr(args, "style", "popularity"),
            latent_dim=getattr(args, "latent_dim", 16),
            temperature=getattr(args, "temperature", 0.35),
            pop_scale=getattr(args, "pop_scale", 0.5),
            emb_noise=getattr(args, "emb_noise", None),
            brand_style=getattr(args, "brand_style", "random"),
            split=getattr(args, "split", "random") or "random",
            pop_df=getattr(args, "pop_df", None),
            pop_zipf=getattr(args, "pop_zipf", None),
            deg_sigma=getattr(args, "deg_sigma", 0.5),
            emb_style=getattr(args, "emb_style", "informative"),
            spectrum=getattr(args, "spectrum", 0.0) or 0.0,
            rank_key=getattr(args, "rank_key", "full") or "full",
            taste_style=getattr(args, "taste_style", "gaussian") or "gaussian",
            clusters_per_user=getattr(args, "clusters_per_user", 3) or 3,
        )
        print(f"Synthetic dataset written to {out}")
        return 0
    recipe = RECIPES.get(args.recipe)
    if recipe is None:
        raise SystemExit(
            f"Unknown recipe {args.recipe!r}; known: {sorted(RECIPES)} + synthetic"
        )
    if not args.review_path or not args.meta_path:
        raise SystemExit("--review_path and --meta_path are required")
    out_base = args.output_dir or os.path.join("dataset", recipe.name)
    prepare_and_save_data(
        recipe, args.review_path, args.meta_path, out_base, core=args.core
    )
    return 0
