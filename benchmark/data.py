"""The benchmark's own inputs: interactions, the leave-one-out split and
the seeded embedding tables.

``generate_interactions`` and the split in ``draw_structure`` are a frozen
copy of the port's ``data/synthetic.py`` (``generate_interactions`` and
``synthetic_bundle``'s popularity path: Zipf-ish item popularity,
lognormal user activity floored at ``core``, users with fewer than three
interactions dropped, one random interaction per user held out as test,
the next as validation, one brand per item).  The copy lives here so that
a change to the program cannot move the benchmark's data.

The structure (who interacted with what) is drawn from the configuration's
``structure_seed``; the run's ``--seed`` then relabels users, items and
brands by random permutations.  Every seed so gets the same graph up to
the numbering: the same degrees, buckets and hub rows, in another order,
so that a seed changes which rows the work touches and not how much work
there is.  The tables and everything the traffic draws come from
``--seed`` as well.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch


@dataclasses.dataclass
class Dataset:
    num_users: int
    num_items: int
    num_brands: int
    train_user: np.ndarray  # int32
    train_item: np.ndarray  # int32
    val_user: np.ndarray    # int32, one row per user
    val_item: np.ndarray
    test_user: np.ndarray
    test_item: np.ndarray
    item_brand: np.ndarray  # [num_items] int32, one brand per item


def generate_interactions(rng, num_users, num_items, mean_degree, core):
    """Sample (user, item) pairs with power-law popularity, deduplicated."""
    deg = np.maximum(core, rng.lognormal(np.log(mean_degree), 0.6, num_users)).astype(np.int64)
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


def draw_structure(graph: dict) -> Dataset:
    """The configuration's graph before relabelling (``structure_seed``)."""
    nu, ni, nb = graph["num_users"], graph["num_items"], graph["num_brands"]
    rng = np.random.default_rng(graph["structure_seed"])
    users, items = generate_interactions(rng, nu, ni, graph["mean_degree"], graph["core"])
    counts = np.bincount(users, minlength=nu)
    ok = counts[users] >= 3
    users, items = users[ok], items[ok]
    order = rng.permutation(len(users))
    u_shuf, i_shuf = users[order], items[order]
    _, first = np.unique(u_shuf, return_index=True)
    mask = np.zeros(len(u_shuf), dtype=bool)
    mask[first] = True
    test_u, test_i = u_shuf[mask], i_shuf[mask]
    rest_u, rest_i = u_shuf[~mask], i_shuf[~mask]
    _, first2 = np.unique(rest_u, return_index=True)
    mask2 = np.zeros(len(rest_u), dtype=bool)
    mask2[first2] = True
    brand = rng.integers(0, nb, ni).astype(np.int32)
    return Dataset(nu, ni, nb, rest_u[~mask2], rest_i[~mask2], rest_u[mask2], rest_i[mask2],
                   test_u, test_i, brand)


def seed_rng(seed: int, stream: int) -> np.random.Generator:
    """A host generator for one purpose (``stream``) of one run's seed."""
    return np.random.default_rng(np.random.SeedSequence([int(seed), int(stream)]))


def torch_seed(seed: int, stream: int) -> int:
    """A 63-bit seed for a ``torch.Generator``, from the run's seed."""
    return int(np.random.SeedSequence([int(seed), int(stream)]).generate_state(2, np.uint64)[0]
               >> np.uint64(1))


def permutations(ds: Dataset, seed: int):
    """The new numbers of users, items and brands under ``seed``."""
    rng = seed_rng(seed, 0)
    return tuple(rng.permutation(n).astype(np.int32)
                 for n in (ds.num_users, ds.num_items, ds.num_brands))


def relabel(ds: Dataset, seed: int) -> Dataset:
    """``ds`` with users, items and brands renumbered by ``permutations``
    (rows keep their order)."""
    pu, pi, pb = permutations(ds, seed)
    brand = np.empty_like(ds.item_brand)
    brand[pi] = pb[ds.item_brand]
    return Dataset(ds.num_users, ds.num_items, ds.num_brands,
                   pu[ds.train_user], pi[ds.train_item], pu[ds.val_user], pi[ds.val_item],
                   pu[ds.test_user], pi[ds.test_item], brand)


def make_dataset(graph: dict, seed: int) -> Dataset:
    return relabel(draw_structure(graph), seed)


TABLES = ("user_embedding", "item_embedding", "brand_embedding")


def draw_tables(ds: Dataset, dim: int, seed: int, device, popularity: float = 0.0,
                keys=TABLES):
    """The Xavier-uniform tables (bound sqrt(6 / (rows + dim)), as
    ``torch.nn.init.xavier_uniform_``, the model's own initialisation),
    drawn in float32 on ``device`` from ``seed``: one generator and one
    call a table, so that any of ``keys`` can be drawn again alone.

    ``popularity`` > 0 adds a shared direction ``c`` (a unit vector from
    the seed): ``popularity * bound`` of it to every user row and
    ``popularity * bound * log(1 + deg) / log(1 + max deg)`` to each item
    row, by the item's train degree.  Scores then rank popular items
    first, as a trained model's do, so that a ranking finds thousands of
    held-out items rather than the few that random tables find."""
    rows = dict(zip(TABLES, (ds.num_users, ds.num_items, ds.num_brands)))
    if popularity:
        gen = torch.Generator(device=device).manual_seed(torch_seed(seed, 13))
        c = torch.randn(dim, generator=gen, device=device)
        c /= c.norm()
        deg = np.log1p(np.bincount(ds.train_item, minlength=ds.num_items).astype(np.float64))
        deg = torch.as_tensor(deg / max(deg.max(), 1e-12), dtype=torch.float32, device=device)
    out = {}
    for key in keys:
        n = rows[key]
        gen = torch.Generator(device=device).manual_seed(torch_seed(seed, 10 + TABLES.index(key)))
        bound = float(np.sqrt(6.0 / (n + dim)))
        t = torch.empty((n, dim), dtype=torch.float32, device=device).uniform_(
            -bound, bound, generator=gen)
        if popularity and key == "user_embedding":
            t += (popularity * bound) * c
        elif popularity and key == "item_embedding":
            t += (popularity * bound) * deg[:, None] * c
        out[key] = t
    return out
