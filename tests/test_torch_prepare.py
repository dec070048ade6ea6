"""The port's copy of the offline data preparation against the JAX package's.

The same raw JSONL, made from a seed, goes through
``gcn_recommendation_tpu.data.prepare`` and
``gcn_recommendation_tpu_torch.data.prepare``: the files they write must be
identical (parquet frames equal, ``.npy`` bit-equal, ``stats.json`` equal),
for the recipes that ``tests/test_prepare.py`` covers, for hostile dumps, for
hostile values (NaN ratings, timestamps and ids, ids of mixed types, tied
times, a user rated only NaN) and fuzzed ids, for every recipe through the port's
``prepare`` command line in a process where pandas cannot be imported, and
for the synthetic recipe through each package's ``prepare`` command line.
``kcore_filter`` is held against the JAX package's on random edge lists.
"""

import contextlib
import io
import json
import os
import subprocess
import sys

import numpy as np
import pandas as pd
import pytest

from gcn_recommendation_tpu import cli as jax_cli
from gcn_recommendation_tpu.data import native_ext as jax_native_ext
from gcn_recommendation_tpu.data import prepare as jax_prepare
from gcn_recommendation_tpu_torch import cli
from gcn_recommendation_tpu_torch.data import prepare
from test_torch_spmm import one_thread  # noqa: F401  (autouse: one thread)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
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


# ------------------------------------------------ the recipes without pandas

NO_PANDAS_SCRIPT = r"""
import contextlib, io, json, sys
sys.modules["pandas"] = None  # any import of pandas now raises ImportError
from gcn_recommendation_tpu_torch import cli
from gcn_recommendation_tpu_torch.tools import real_data_dryrun
runs = json.loads(sys.argv[1])
out = {}
for recipe, argv in runs.items():
    with contextlib.redirect_stdout(io.StringIO()) as log:
        rc = cli.main(argv)
    out[recipe] = {"rc": rc, "log": log.getvalue()}
steam = runs["steam_emb"]
with contextlib.redirect_stdout(io.StringIO()) as log:
    rc = real_data_dryrun.main(["--recipe", "steam_emb", "--review_path", steam[4],
                                "--meta_path", steam[6], "--core", "2", "--skip_train",
                                "--full_dir", steam[8] + "_dryrun", "--device", "cpu"])
out["real_data_dryrun"] = {"rc": rc, "log": log.getvalue()}
out["pandas_loaded"] = sorted(k for k, v in sys.modules.items()
                              if v is not None and k.split(".")[0] == "pandas")
print(json.dumps(out))
"""
RAW_REVIEW_LINES = ['{"user_id": "u0", "item_id": "i0", "rat', "[1, 2, 3]", "null"]


@pytest.fixture(scope="module")
def no_pandas(tmp_path_factory):
    """A seeded dump of each recipe through the port's ``prepare`` command
    line in one process where ``import pandas`` fails (and
    ``real_data_dryrun`` on the steam dump); the paths and what each
    printed."""
    tmp = tmp_path_factory.mktemp("no_pandas")
    runs, paths = {}, {}
    for recipe in sorted(prepare.RECIPES):
        reviews, meta = _raw_dump(recipe, seed=20 + len(recipe))
        rp, mp = str(tmp / f"{recipe}_r.jsonl"), str(tmp / f"{recipe}_m.jsonl")
        _write_jsonl(rp, reviews, RAW_REVIEW_LINES)
        _write_jsonl(mp, meta, ['{"item_id": "i2", "categor'])
        argv = ["prepare", "--recipe", recipe, "--review_path", rp, "--meta_path", mp,
                "--output_dir", str(tmp / recipe / "port"), "--core", "3"]
        runs[recipe], paths[recipe] = argv, (rp, mp, tmp / recipe)
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    res = subprocess.run([sys.executable, "-c", NO_PANDAS_SCRIPT, json.dumps(runs)],
                         cwd=REPO, env=env, capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stdout[-3000:] + res.stderr[-3000:]
    return json.loads(res.stdout.strip().splitlines()[-1]), paths


@pytest.mark.parametrize("recipe_name", sorted(jax_prepare.RECIPES))
def test_recipe_command_line_without_pandas(no_pandas, recipe_name):
    """The port's ``prepare --recipe R`` with pandas unimportable writes
    the files, and prints the lines, of the JAX package's (pandas)
    command line on the same dump."""
    out, paths = no_pandas
    assert out["pandas_loaded"] == []
    assert out[recipe_name]["rc"] == 0
    rp, mp, base = paths[recipe_name]
    with contextlib.redirect_stdout(io.StringIO()) as log:
        assert jax_cli.main(["prepare", "--recipe", recipe_name, "--review_path", rp,
                             "--meta_path", mp, "--output_dir", str(base / "jax"),
                             "--core", "3"]) == 0
    suffix = jax_prepare.RECIPES[recipe_name].out_suffix
    a, b = (str(base / tag / f"processed_data_3{suffix}") for tag in ("jax", "port"))
    assert_same_dataset(a, b)
    assert log.getvalue().replace(str(base / "jax"), "") == (
        out[recipe_name]["log"].replace(str(base / "port"), ""))
    assert "skipped 1 malformed and 2 non-object lines" in log.getvalue()


def test_real_data_dryrun_without_pandas(no_pandas):
    out, paths = no_pandas
    assert out["real_data_dryrun"]["rc"] == 0, out["real_data_dryrun"]["log"]
    assert "dryrun OK (train skipped)" in out["real_data_dryrun"]["log"]
    assert os.path.exists(os.path.join(str(paths["steam_emb"][2] / "port") + "_dryrun",
                                       "processed_data_2_pos_only_cat", "train.parquet"))


# ------------------------------------------------------------ hostile values

NAN = float("nan")


def _every(records, key, step, value=NAN, start=0):
    for r in records[start::step]:
        r[key] = value
    return records


def _rows(recipe_name, triples, key="rating"):
    """Review records of ``recipe_name``'s layout from (user, item, value)."""
    item_key = "parent_asin" if recipe_name in ("amazon_books", "amazon_books_senti") else "item_id"
    return [{"user_id": u, item_key: i, key: v, "sentiment": "positive", "recommanded": True}
            for u, i, v in triples]


def _meta(recipe_name, items):
    key = ("parent_asin" if recipe_name in ("amazon_books", "amazon_books_senti",
                                            "amazon_sport_emb") else "item_id")
    return [{key: i, "author": {"name": f"A{n % 2}"}, "categories": ["Root", f"C{n % 3}"],
             "genres": [f"G{n}"], "embd": [0.25 * n, -0.5]} for n, i in enumerate(items)]


def _seeded(recipe_name, seed, mutate):
    reviews, meta = _raw_dump(recipe_name, seed=seed)
    return mutate(reviews), meta


# name: (recipe, core, reviews, metadata, the JAX package on its numpy K-core
#        filter (NaN ids), the test and train rows expected or None)
HOSTILE = {
    "nan_ratings": ("amazon_books", 3, *_seeded(
        "amazon_books", 11, lambda r: _every(r, "rating", 4)), False, None),
    "all_nan_ratings_user": ("amazon_books_senti", 3, *_seeded(
        "amazon_books_senti", 5, lambda r: [dict(x, rating=NAN) if x["user_id"] == "u0" else x
                                            for x in r]), False, None),
    "nan_timestamps": ("steam_emb", 2, *_seeded(
        "steam_emb", 12, lambda r: _every(r, "timestamp", 5)), False, None),
    # u0: b's NaN time is the newest; u1: the last of two NaN rows
    "nan_timestamps_exact": ("steam_emb", 1, _rows("steam_emb", [
        ("u0", "a", 1.0), ("u0", "b", NAN), ("u0", "c", 3.0),
        ("u1", "a", NAN), ("u1", "b", NAN), ("u1", "c", 5.0)], "timestamp"),
        _meta("steam_emb", "abc"), False,
        ([(0, 1), (1, 1)], [(0, 0), (0, 2), (1, 2), (1, 0)])),
    # u0's times all tie: its last row in the file; rows in stable time order
    "tied_timestamps": ("steam_emb", 1, _rows("steam_emb", [
        ("u0", "a", 7.0), ("u0", "b", 7.0), ("u0", "c", 7.0),
        ("u1", "a", 1.0), ("u1", "c", 2.0)], "timestamp"),
        _meta("steam_emb", "abc"), False,
        ([(1, 2), (0, 2)], [(1, 0), (0, 0), (0, 1)])),
    # 1, 1.0 and True one item, "1" another; 12345 and "12345" two users
    "mixed_type_ids": ("amazon_books_emb", 1, _rows("amazon_books_emb", [
        (12345, 1, 5.0), (12345, 1.0, 3.0), ("12345", True, 4.0), ("12345", "1", 2.0),
        (12345, "1", 1.0)]), _meta("amazon_books_emb", [True, "1", 1.0]), False,
        ([(0, 0), (1, 0)], [(0, 0), (1, 1), (0, 1)])),
    # numeric ids: a float64 column, where 2**53 + 1 rounds onto 2**53
    "numeric_ids": ("amazon_books", 1, _rows("amazon_books", [
        (1, 2**53 + 1, 2.0), (1.0, 2**53, 4.0), (2, 7, 4.0), (2**53 + 1, 7.5, 1.0),
        (2**53, 7, 3.0)]), _meta("amazon_books", [7, 2**53, 7.5]), False,
        ([(0, 0), (1, 1), (2, 1)], [(0, 0), (2, 2)])),
    # NaN users among strings (missing: one user, no metadata finds it) and
    # a NaN item among ids of mixed types (the parsed NaN: its metadata counts)
    "nan_ids": ("amazon_books", 1, _rows("amazon_books", [
        (NAN, "x", 4.0), ("a", NAN, 5.0), (NAN, NAN, 2.0), ("a", 3, 1.0), ("b", NAN, 3.0),
        ("b", "x", 3.0)]), _meta("amazon_books", [NAN, "x", 3]), True,
        ([(0, 0), (1, 1), (2, 1)], [(0, 1), (1, 2), (2, 0)])),
    # a NaN item among strings is missing: its metadata record finds nothing
    "nan_item_among_strings": ("amazon_books", 1, _rows("amazon_books", [
        ("a", "x", 4.0), ("a", NAN, 5.0), ("b", NAN, 1.0), ("b", "y", 3.0)]),
        _meta("amazon_books", [NAN, "x", "y"]), True,
        ([(0, 1), (1, 2)], [(0, 0), (1, 1)])),
    # a float among strings makes a column of mixed types: its metadata and
    # the NaN item's count
    "float_item_among_strings": ("amazon_books", 1, _rows("amazon_books", [
        ("a", "x", 4.0), ("a", 2.5, 5.0), ("b", 2.5, 1.0), ("b", "y", 3.0), ("b", NAN, 2.0)]),
        _meta("amazon_books", [NAN, "x", 2.5, "y"]), True,
        ([(0, 1), (1, 2)], [(0, 0), (1, 1), (1, 3)])),
    "nan_ids_seeded": ("amazon_books_emb", 2, *_seeded(
        "amazon_books_emb", 13, lambda r: _every(_every(r, "user_id", 7), "item_id", 9, start=3)),
        True, None),
}


@pytest.mark.parametrize("case", sorted(HOSTILE))
def test_hostile_values_give_identical_files(tmp_path, monkeypatch, case):
    """NaN ratings, times and ids, ids of mixed types, tied times: the
    port's files and lines are the JAX package's, and where the rows are
    written out, they are the ones pandas' split picks."""
    recipe_name, core, reviews, meta, nan_ids, expect = HOSTILE[case]
    if nan_ids:
        # pd.factorize codes a NaN id -1, which the JAX package's native
        # K-core binding would index out of bounds; its numpy filter takes
        # -1 as one more id
        monkeypatch.setattr(jax_native_ext, "_lib", None)
        monkeypatch.setattr(jax_native_ext, "_load_failed", True)
    out = _both(tmp_path, recipe_name, json.loads(json.dumps(reviews)), meta, core)
    stats = json.load(open(os.path.join(out, "stats.json")))
    test = pd.read_parquet(os.path.join(out, "test.parquet"))
    train = pd.read_parquet(os.path.join(out, "train.parquet"))
    if expect is not None:
        assert [tuple(r) for r in test.to_numpy()] == expect[0]
        assert [tuple(r) for r in train.to_numpy()] == expect[1]
    if case == "all_nan_ratings_user":  # u0, the first user, has no test row
        assert 0 in set(train["user_idx"]) and 0 not in set(test["user_idx"])
        assert len(test) == stats["num_users"] - 1
    else:
        assert len(test) == stats["num_users"] and test["user_idx"].is_unique
    if case == "nan_ids":  # the NaN item's metadata counts, the NaN user's id does not
        assert stats == {"num_users": 3, "num_items": 3, "num_brands": 2}
    item_brand = pd.read_parquet(os.path.join(out, "item_brand.parquet"))
    if case == "nan_item_among_strings":
        assert item_brand["item_idx"].tolist() == [0, 2]
    if case == "float_item_among_strings":
        assert item_brand["item_idx"].tolist() == [3, 0, 1, 2]


# ids drawn from pools of one kind or of mixed kinds: strings, ints, floats,
# bools, NaN, ints past 2**53, 2**63 and 2**64, unhashable lists and dicts
ID_POOLS = {
    "strings": ["a", "b", "c", "d", "e"],
    "strings_nan": ["a", "b", "c", NAN],
    "strings_floats": ["a", "b", 1.5, 2.5],
    "ints": [1, 2, 3, 4, 5, 6],
    "numeric": [1, 2, 3, 1.0, 2.5, NAN, 2**53 + 1, 2**53, -0.0, 0],
    "mixed": ["u1", "u2", 1, 1.0, True, False, 0, 12345, "12345", 2.5, NAN, 2**53 + 1],
    "bools": [True, False],
    "wide_ints": [2**64 + 1, 2**64, float(2**64), 1, 1.5, 2**63 + 5, -1],
    "unhashable": ["a", "b", [1], {"x": 1}],
}


def _fuzzed_dump(rng, recipe_name):
    pools = list(ID_POOLS.values())
    users, items = pools[rng.integers(len(pools))], pools[rng.integers(len(pools))]
    triples = [(users[rng.integers(len(users))], items[rng.integers(len(items))],
                [1.0, 2.0, 5.0, NAN, float("inf"), -0.0][rng.integers(6)])
               for _ in range(int(rng.integers(20, 60)))]
    key = "timestamp" if recipe_name == "steam_emb" else "rating"
    meta = [m for m in _meta(recipe_name, items) if rng.random() < 0.8]
    return _rows(recipe_name, triples, key), meta


@pytest.mark.parametrize("seed", range(10))
def test_fuzzed_ids_give_identical_files(tmp_path, monkeypatch, seed):
    """Ten dumps a seed, every recipe, ids and values drawn from the pools
    above: the same files and lines from both packages, or the same error
    (pandas raises ``TypeError`` on an unhashable id, so does the port)."""
    monkeypatch.setattr(jax_native_ext, "_lib", None)  # NaN ids: see HOSTILE
    monkeypatch.setattr(jax_native_ext, "_load_failed", True)
    rng = np.random.default_rng(1000 + seed)
    for n in range(10):
        recipe_name = sorted(prepare.RECIPES)[n % 5]
        reviews, meta = _fuzzed_dump(rng, recipe_name)
        core = int(rng.integers(1, 4))
        case = tmp_path / str(n)
        case.mkdir()
        try:
            _both(case, recipe_name, reviews, meta, core)
        except TypeError as e:
            assert "unhashable" in str(e)
            for mod in (jax_prepare, prepare):
                with pytest.raises(TypeError, match="unhashable"), \
                        contextlib.redirect_stdout(io.StringIO()):
                    mod.prepare_and_save_data(mod.RECIPES[recipe_name], str(case / "r.jsonl"),
                                              str(case / "m.jsonl"), str(case / "again"), core)
