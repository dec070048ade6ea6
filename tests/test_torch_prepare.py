"""The port's copy of the offline data preparation against the JAX package's.

The same raw JSONL, made from a seed, goes through
``gcn_recommendation_tpu.data.prepare`` and
``gcn_recommendation_tpu_torch.data.prepare``: the files they write must be
identical (parquet frames equal, ``.npy`` bit-equal, ``stats.json`` equal),
for the recipes that ``tests/test_prepare.py`` covers, for hostile dumps, and
for the synthetic recipe through each package's ``prepare`` command line.
``kcore_filter`` is held against the JAX package's on random edge lists.
"""

import contextlib
import io
import json
import os

import numpy as np
import pandas as pd
import pytest

from gcn_recommendation_tpu import cli as jax_cli
from gcn_recommendation_tpu.data import prepare as jax_prepare
from gcn_recommendation_tpu_torch import cli
from gcn_recommendation_tpu_torch.data import prepare
from test_torch_spmm import one_thread  # noqa: F401  (autouse: one thread)

FILES = ("train.parquet", "test.parquet", "item_brand.parquet", "stats.json",
         "item_embeddings.npy")


def assert_same_dataset(a: str, b: str) -> None:
    """Every artifact of the two output directories is the same."""
    assert os.path.basename(a) == os.path.basename(b)
    assert sorted(os.listdir(a)) == sorted(os.listdir(b))
    for name in os.listdir(a):
        pa, pb = os.path.join(a, name), os.path.join(b, name)
        if name.endswith(".parquet"):
            fa, fb = pd.read_parquet(pa), pd.read_parquet(pb)
            pd.testing.assert_frame_equal(fa, fb, check_exact=True)
            assert list(fa.dtypes) == list(fb.dtypes)
        elif name.endswith(".npy"):
            xa, xb = np.load(pa), np.load(pb)
            assert xa.dtype == xb.dtype and xa.shape == xb.shape
            assert xa.tobytes() == xb.tobytes()
        else:
            with open(pa) as f, open(pb) as g:
                assert json.load(f) == json.load(g)


def _raw_dump(recipe_name, seed, n_users=30, n_items=20, per_user=8, emb_dim=6):
    """(review records, metadata records) for one recipe, from a seed:
    ratings and timestamps with ties, sentiments and flags that drop some
    rows, repeated interactions, items without metadata or embeddings."""
    rng = np.random.default_rng(seed)
    item_key = "parent_asin" if recipe_name in ("amazon_books", "amazon_books_senti") else "item_id"
    meta_key = ("parent_asin" if recipe_name in ("amazon_books", "amazon_books_senti",
                                                 "amazon_sport_emb") else "item_id")
    reviews = []
    for u in range(n_users):
        for i in rng.choice(n_items, per_user + int(rng.integers(0, 4)), replace=True):
            reviews.append({
                "user_id": f"u{u}", item_key: f"i{int(i)}",
                "rating": float(rng.integers(1, 6)),
                "timestamp": float(rng.integers(0, 40)),
                "sentiment": "positive" if rng.random() < 0.85 else "negative",
                "recommanded": bool(rng.random() < 0.9),
            })
    meta = []
    for i in rng.permutation(n_items):
        if rng.random() < 0.1:
            continue  # an item without metadata
        meta.append({
            meta_key: f"i{int(i)}",
            "author": {"name": f"A{int(rng.integers(0, 5))}"} if rng.random() < 0.8 else "plain",
            "details": {"Brand": f"B{int(rng.integers(0, 4))}"},
            "categories": ["Root"] + [f"C{int(c)}" for c in rng.integers(0, 5, rng.integers(0, 4))],
            "genres": [f"G{int(c)}" for c in rng.integers(0, 4, rng.integers(0, 3))],
            "tags": {f"T{int(c)}": 1 for c in rng.integers(0, 4, rng.integers(0, 3))},
            "embd": (rng.standard_normal(emb_dim).round(4).tolist()
                     if rng.random() < 0.9 else None),
        })
    return reviews, meta


def _write_jsonl(path, records, raw_lines=()):
    with open(path, "w", encoding="utf-8") as f:
        for r in records:
            f.write(json.dumps(r) + "\n")
        for line in raw_lines:
            f.write(line + "\n")


def _both(tmp_path, recipe_name, reviews, meta, core, raw_reviews=(), raw_meta=()):
    rp, mp = str(tmp_path / "r.jsonl"), str(tmp_path / "m.jsonl")
    _write_jsonl(rp, reviews, raw_reviews)
    _write_jsonl(mp, meta, raw_meta)
    outs = []
    for mod, tag in ((jax_prepare, "jax"), (prepare, "port")):
        with contextlib.redirect_stdout(io.StringIO()) as log:
            out = mod.prepare_and_save_data(
                mod.RECIPES[recipe_name], rp, mp, str(tmp_path / tag), core=core)
        outs.append((out, log.getvalue()))
    (a, log_a), (b, log_b) = outs
    assert a and b
    assert_same_dataset(a, b)
    # the same progress lines too, but for the output directory's name
    assert log_a.replace(str(tmp_path / "jax"), "") == log_b.replace(str(tmp_path / "port"), "")
    return b


def test_recipes_are_the_jax_packages():
    assert sorted(prepare.RECIPES) == sorted(jax_prepare.RECIPES)
    for name, r in prepare.RECIPES.items():
        j = jax_prepare.RECIPES[name]
        assert (r.name, r.split, r.default_core, r.out_suffix, r.kcore_skippable) == (
            j.name, j.split, j.default_core, j.out_suffix, j.kcore_skippable)


@pytest.mark.parametrize("seed,k", [(0, 1), (1, 2), (2, 3), (3, 5), (4, 8)])
def test_kcore_filter_matches_jax_on_random_edges(seed, k):
    rng = np.random.default_rng(seed)
    n = 600
    users = rng.integers(0, 60, n).astype(np.int64)
    items = (rng.zipf(1.5, n) % 40).astype(np.int64)
    keep = prepare.kcore_filter(users, items, k)
    np.testing.assert_array_equal(keep, jax_prepare.kcore_filter(users, items, k))
    assert keep.dtype == bool and keep.shape == (n,)
    if keep.any():  # what is kept is a k-core
        assert np.unique(users[keep], return_counts=True)[1].min() >= k
        assert np.unique(items[keep], return_counts=True)[1].min() >= k


def test_kcore_filter_cascades():
    users = np.array([0, 0, 1, 1, 2], np.int64)
    items = np.array([0, 1, 0, 1, 2], np.int64)
    np.testing.assert_array_equal(
        prepare.kcore_filter(users, items, k=2), [True, True, True, True, False])
    assert prepare.kcore_filter(users, items, 1).all()


@pytest.mark.parametrize("recipe_name", sorted(jax_prepare.RECIPES))
def test_seeded_dump_gives_identical_files(tmp_path, recipe_name):
    reviews, meta = _raw_dump(recipe_name, seed=len(recipe_name))
    out = _both(tmp_path, recipe_name, reviews, meta, core=3)
    stats = json.load(open(os.path.join(out, "stats.json")))
    assert stats["num_users"] > 5 and stats["num_items"] > 5
    test = pd.read_parquet(os.path.join(out, "test.parquet"))
    assert len(test) == stats["num_users"]  # leave-one-out
    has_emb = os.path.exists(os.path.join(out, "item_embeddings.npy"))
    assert has_emb == (recipe_name not in ("amazon_books", "amazon_books_senti"))


@pytest.mark.parametrize("recipe_name", sorted(jax_prepare.RECIPES))
def test_hostile_dump_gives_identical_files(tmp_path, recipe_name):
    """Truncated lines, non-objects, garbage field types, embeddings of
    drifting length: skipped and counted alike by both."""
    reviews, meta = _raw_dump(recipe_name, seed=7)
    meta[0]["embd"] = [0.5, 0.5]          # drifted length
    meta[1]["embd"] = "corrupt"
    meta[2]["categories"] = [None, 7, 2.5]
    raw_reviews = ['{"user_id": "u0", "item_id": "i0", "rat', "[1, 2, 3]", "null", "",
                   json.dumps({"user_id": 12345, "item_id": {"nested": True},
                               "parent_asin": ["list"], "rating": "four-ish",
                               "timestamp": "yesterday", "sentiment": "positive",
                               "recommanded": True})]
    raw_meta = ['{"item_id": "i2", "categor', json.dumps({"wrong_key_only": True}),
                json.dumps({"item_id": "i3", "parent_asin": "i3", "author": 999,
                            "details": "not-a-dict", "genres": "not-a-list",
                            "tags": ["not", "a", "dict"], "embd": 3.14})]
    _both(tmp_path, recipe_name, reviews, meta, core=2, raw_reviews=raw_reviews,
          raw_meta=raw_meta)


def test_core_one_skips_the_filter_and_keeps_the_suffix(tmp_path):
    reviews, meta = _raw_dump("amazon_books_emb", seed=3, n_users=6, n_items=5, per_user=2)
    out = _both(tmp_path, "amazon_books_emb", reviews, meta, core=1)
    assert out.endswith("processed_data_1_pos_only_cat")


def test_steam_split_is_temporal(tmp_path):
    reviews = [{"user_id": f"u{u}", "item_id": i, "timestamp": t, "recommanded": True}
               for u in range(2) for t, i in enumerate(["a", "b", "c"])]
    reviews.append({"user_id": "u0", "item_id": "a", "timestamp": 99, "recommanded": False})
    meta = [{"item_id": "a", "genres": ["RPG"], "tags": {"Indie": 10}},
            {"item_id": "b", "genres": [], "tags": {}}]
    out = _both(tmp_path, "steam_emb", reviews, meta, core=1)
    test = pd.read_parquet(os.path.join(out, "test.parquet"))
    assert (test["item_idx"] == 2).all() and len(test) == 2  # 'c', the newest


def test_no_usable_review_returns_empty(tmp_path, capsys):
    rp, mp = str(tmp_path / "r.jsonl"), str(tmp_path / "m.jsonl")
    _write_jsonl(rp, [{"nothing": 1}])
    _write_jsonl(mp, [])
    for mod in (prepare, jax_prepare):
        assert mod.prepare_and_save_data(mod.RECIPES["amazon_books"], rp, mp,
                                         str(tmp_path / "o")) == ""
    assert capsys.readouterr().out.count("Error: no usable reviews found.") == 2


@pytest.mark.parametrize("extra", [
    ["--embedding_dim", "8"],
    ["--style", "latent", "--latent_dim", "6", "--emb_noise", "0.3", "--embedding_dim", "12",
     "--brand_style", "latent", "--split", "rank", "--rank_key", "taste"],
])
def test_synthetic_recipe_through_both_command_lines(tmp_path, extra):
    common = ["prepare", "--recipe", "synthetic", "--num_users", "120", "--num_items", "80",
              "--num_brands", "8", "--mean_degree", "9", "--core", "3", "--seed", "5", *extra]
    outs = []
    for mod, tag in ((jax_cli, "jax"), (cli, "port")):
        out = str(tmp_path / tag / "processed_data_3")
        with contextlib.redirect_stdout(io.StringIO()):
            assert mod.main([*common, "--output_dir", out]) == 0
        outs.append(out)
    assert_same_dataset(*outs)
    assert os.path.exists(os.path.join(outs[1], "item_embeddings.npy"))


def test_run_recipe_refuses_what_it_cannot_run():
    with pytest.raises(SystemExit, match="Unknown recipe"):
        cli.main(["prepare", "--recipe", "nope"])
    with pytest.raises(SystemExit, match="--review_path and --meta_path are required"):
        cli.main(["prepare", "--recipe", "steam_emb"])
