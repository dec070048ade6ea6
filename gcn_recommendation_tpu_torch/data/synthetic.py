"""Synthetic dataset generation (host side, numpy).

A copy of ``gcn_recommendation_tpu/data/synthetic.py`` (the port imports
nothing from the JAX package): the same seed draws the same numbers in
the same order, so both packages build the same arrays bit for bit.

Writes the artifact layout of the reference's prepare_data.py recipes
(``train.parquet`` / ``test.parquet`` / ``item_brand.parquet`` /
``stats.json`` [+ ``item_embeddings.npy``]; the parquet files through the
port's own writer, ``data/parquet.py``, with no pandas) or builds a
``DataBundle`` in memory.  Two styles: ``popularity`` (Zipf-ish item popularity, lognormal
user activity floored at ``core``) and ``latent`` (a latent-factor taste
model with collaborative structure a model can learn, from which
content embeddings and brands correlated with taste are derived: the
data ``LightGCN_Fusion`` trains on).  ``core`` is a sampling floor before
deduplication, not a strict K-core guarantee.
"""

from __future__ import annotations

import json
import os
from typing import Optional, Tuple

import numpy as np

from gcn_recommendation_tpu_torch.data.parquet import write_columns


def generate_interactions_latent(
    rng: np.random.Generator,
    num_users: int,
    num_items: int,
    mean_degree: float,
    core: int,
    latent_dim: int = 16,
    temperature: float = 0.35,
    pop_scale: float = 0.5,
    return_latents: bool = False,
    pop_df: Optional[float] = None,
    deg_sigma: float = 0.5,
    return_state: bool = False,
    spectrum: float = 0.0,
    pop_zipf: Optional[float] = None,
    rank_key: str = "full",
    taste_style: str = "gaussian",
    clusters_per_user: int = 3,
):
    """Sample interactions from a latent-factor taste model.

    Users/items get latent vectors; user u's items are a Gumbel-top-k
    draw from softmax((u . v + popularity_bias) / temperature) — i.e.
    sampling without replacement proportional to preference.  Unlike the
    pure-popularity mode this has collaborative structure LightGCN can
    actually learn, so training curves climb like on real review data.

    ``temperature`` and ``latent_dim`` are the regime knobs: low
    temperature / low dim -> highly predictable taste (dense-catalog
    regime, reference exp/ recall ~0.66); high temperature / high dim ->
    weak signal (exp_zno regime, ~0.06).  With ``return_latents`` the
    item factor matrix ``lv`` is also returned so callers can derive
    *informative* content embeddings / brand assignments from the same
    generative state (mirroring real metadata, which correlates with
    taste — e.g. the reference's pretrained review-text embeddings,
    dataset/amazon_books_emb/prepare_data.py:141-150).

    Tail knobs (REGIMES.md divergence #1 —
    real K-core review data has heavier-tailed degree structure than a
    Gaussian latent model produces):

    * ``pop_df`` — when set, popularity logits are Student-t with this
      many degrees of freedom instead of Gaussian (df ~ 2-4 gives the
      Zipf-like item-degree tail of review dumps: a few huge hubs, a
      long thin tail that takes many epochs to learn).
    * ``pop_zipf`` — when set, popularity logits are EXACT Zipf:
      ``pop = -s * temperature * log(rank)`` over a random item ranking,
      so a pure-popularity sampler draws item of rank r with probability
      proportional to ``r^-s`` regardless of temperature.  The
      controlled way to get review-dump degree tails (s ~ 0.5-0.8 for
      K-core'd Amazon data); overrides ``pop_df``/``pop_scale``'s
      distribution but composes additively with the taste scores.
    * ``deg_sigma`` — lognormal sigma of the per-user degree draw
      (0.5 = the original light tail; ~1.0 matches the heavy spread of
      K-core'd users).
    * ``spectrum`` — power-law decay exponent of the taste-factor
      variances (factor j scaled by (1+j)^-spectrum, renormalized to
      keep the total taste variance fixed).  0 = isotropic factors,
      which a dim-64 model resolves within a few epochs — the flat
      curves of REGIMES.md divergence #1; ~1 gives a few strong
      directions (learned early) plus a long tail of weak ones that
      keep improving recall for >100 epochs, the eigenspectrum shape of
      real co-occurrence data and the source of the reference's
      late-climb curves.

    Each user's returned items are ordered by **descending realized
    preference key** — the synthetic analogue of the reference's rating
    order, which its split consumes via rating-rank
    (dataset/amazon_books/prepare_data.py:95-97).  Callers implementing
    rank-based splits rely on this ordering.

    ``rank_key`` selects what that ordering ranks by: ``'full'`` uses
    the same sampling key (taste + popularity + Gumbel noise), so a
    user's rank-1 item skews toward globally popular items — a model
    that merely learns popularity nails the rank split within a few
    epochs, the early-peak failure of REGIMES.md divergence #1.
    ``'taste'`` orders by the taste score ``u . v`` alone, the analogue
    of the reference's RATING rank (ratings reflect how much the user
    liked the item, not how popular it is): the rank-1 test item is
    then predictable only through the collaborative structure, which a
    spectrum-tailed factor model keeps revealing for >100 epochs — the
    late-climb-and-hold shape of every reference curve.

    ``taste_style`` selects the loading distribution of the factor
    model:

    * ``'gaussian'`` — dense i.i.d. loadings (the original model).
      Every probe of this style decays 12-25% post-peak
      regardless of dim/spectrum/temperature/density: with diffuse
      loadings, BPR sharpening on observed pairs always displaces the
      held-out item's score mass (REGIMES.md divergence #1).
    * ``'cluster'`` — community structure, the statistical signature of
      real co-purchase data: ``latent_dim`` becomes the number of item
      communities; each item loads on ONE community (plus small
      Gaussian jitter), each user on ``clusters_per_user`` random
      communities with Dirichlet-ish weights.  Taste u.v is then "how
      much u likes i's community": train and held-out items of the same
      community share their score trajectory, so fitting train pairs
      harder keeps LIFTING the held-out item instead of displacing it —
      memorization IS generalization, the property behind the
      reference's curves (loss falls 3.3x across 150 epochs while
      recall climbs monotonically — exp_books base_150e20c_nob).
    """
    if taste_style == "cluster":
        # item communities: one-hot loading + jitter; community sizes
        # follow the same popularity machinery via the pop logits below
        comm = rng.integers(0, latent_dim, num_items)
        lv = 0.25 * rng.standard_normal((num_items, latent_dim)) / np.sqrt(
            latent_dim
        )
        lv[np.arange(num_items), comm] += 1.0
        lu = np.zeros((num_users, latent_dim))
        k = min(clusters_per_user, latent_dim)
        for u in range(num_users):
            cs = rng.choice(latent_dim, size=k, replace=False)
            wts = np.sort(rng.dirichlet(np.ones(k)))[::-1]
            lu[u, cs] = wts
        # normalize the taste-score scale to ~unit std so temperature
        # calibrations transfer between styles
        s = (lu @ lv.T).std()
        lu /= max(s, 1e-9)
    else:
        lu = rng.standard_normal((num_users, latent_dim)) / np.sqrt(latent_dim)
        lv = rng.standard_normal((num_items, latent_dim)) / np.sqrt(latent_dim)
    if spectrum:
        w = (1.0 + np.arange(latent_dim)) ** (-float(spectrum))
        # keep sum(w^2) = latent_dim so the taste-score std (and hence
        # the temperature calibration) is unchanged by the exponent
        w *= np.sqrt(latent_dim / np.sum(w * w))
        lv = lv * w[None, :]
    # popularity bias: ``pop_scale`` sets how much taste concentrates on
    # globally popular items — the dense-catalog regime (steam-like, a few
    # hugely popular titles everyone has) needs a high value, which is
    # also what makes its leave-one-out recall band (~0.66) reachable
    if pop_zipf is not None:
        ranks = rng.permutation(num_items).astype(np.float64) + 1.0
        pop = -float(pop_zipf) * temperature * np.log(ranks)
    elif pop_df is not None:
        pop = pop_scale * rng.standard_t(pop_df, num_items)
    else:
        pop = pop_scale * rng.standard_normal(num_items)
    deg = np.maximum(
        core, rng.lognormal(np.log(mean_degree), deg_sigma, num_users)
    ).astype(np.int64)
    deg = np.minimum(deg, num_items)

    users_out, items_out = [], []
    chunk = max(1, 2_000_000 // num_items)
    max_deg = int(deg.max())
    for lo in range(0, num_users, chunk):
        hi = min(lo + chunk, num_users)
        scores = (lu[lo:hi] @ lv.T + pop[None, :]) / temperature
        gumbel = -np.log(-np.log(rng.random(scores.shape) + 1e-12) + 1e-12)
        keys = scores + gumbel
        # top-max_deg per row, then trim to each user's degree
        top = np.argpartition(-keys, max_deg - 1, axis=1)[:, :max_deg]
        if rank_key == "taste":
            taste = lu[lo:hi] @ lv.T
        for r, u in enumerate(range(lo, hi)):
            d = deg[u]
            # the drawn set is always top-d by the SAMPLING key ...
            row = top[r][np.argsort(-keys[r, top[r]])[:d]]
            if rank_key == "taste":
                # ... but the rating-rank ordering ranks by taste alone
                row = row[np.argsort(-taste[r, row])]
            users_out.append(np.full(d, u, np.int64))
            items_out.append(row.astype(np.int64))
    users = np.concatenate(users_out)
    items = np.concatenate(items_out)
    if return_state:
        # full generative state (user factors, item factors, popularity
        # logits) for oracle-recall calibration
        return users.astype(np.int32), items.astype(np.int32), (lu, lv, pop)
    if return_latents:
        return users.astype(np.int32), items.astype(np.int32), lv
    return users.astype(np.int32), items.astype(np.int32)


def informative_item_embeddings(
    rng: np.random.Generator,
    lv: np.ndarray,
    embedding_dim: int,
    noise: float = 1.0,
) -> np.ndarray:
    """Content embeddings correlated with the true item taste factors.

    Real pretrained content embeddings (review-text/metadata encoders,
    dataset/amazon_books_emb/prepare_data.py:141-150) carry signal about
    what the item IS — which correlates with who likes it.  Model that as
    a random linear projection of the generative latent factors plus
    Gaussian noise: ``E = lv @ P + noise * N(0, 1)``, row-normalized to
    unit scale like encoder outputs.  ``noise`` tunes how useful the
    content signal is (0 = perfectly informative, >> 1 = the
    pure-noise embeddings, under which emb/fus variants cannot beat
    base — unlike on the reference's real data where they do,
    BASELINE.md: books base 0.0866 < emb 0.0951 < fus 0.1015).
    """
    latent_dim = lv.shape[1]
    proj = rng.standard_normal((latent_dim, embedding_dim)) / np.sqrt(latent_dim)
    emb = lv @ proj + noise * rng.standard_normal((lv.shape[0], embedding_dim))
    emb /= np.maximum(np.linalg.norm(emb, axis=1, keepdims=True), 1e-8)
    return emb.astype(np.float32)


def misleading_item_embeddings(
    rng: np.random.Generator,
    lv: np.ndarray,
    embedding_dim: int,
    noise: float = 0.0,
) -> np.ndarray:
    """Content embeddings that actively CONFLICT with item taste.

    Row-permutes the item factor matrix before projecting, so each
    item's content carries the (strong, internally consistent) latent
    structure of an unrelated item: content-similar items are taste-
    unrelated.  This models real metadata that misleads a content-fusion
    model — the regime behind the reference's dense Fusion collapse
    (exp/results/base_150e20c_brd_fus: best 0.6255 at ep10 decaying to
    0.5364), which purely *noisy* content cannot reproduce because the
    fusion Linear simply learns to ignore noise (REGIMES.md divergence
    #3).  ``noise`` adds Gaussian on top as in
    informative_item_embeddings.
    """
    return informative_item_embeddings(
        rng, lv[rng.permutation(lv.shape[0])], embedding_dim, noise
    )


def latent_cluster_brands(
    rng: np.random.Generator, lv: np.ndarray, num_brands: int
) -> np.ndarray:
    """Brand-per-item assignment correlated with taste: k-means-ish
    clustering of the item latent factors (a few Lloyd iterations).
    Mirrors real metadata, where brand/author predicts audience; random
    brands give the brand graph zero signal, so ``brd`` vs ``nob``
    deltas could never reproduce the reference's."""
    n = lv.shape[0]
    centers = lv[rng.choice(n, size=min(num_brands, n), replace=False)]
    assign = np.zeros(n, np.int32)
    for _ in range(5):
        # ||a-b||^2 = ||a||^2 - 2ab + ||b||^2 via one [n,k] matmul —
        # the naive [n, k, d] broadcast is ~n*k*d*8 bytes of host RAM
        # per Lloyd iteration (~12 GB at 100k items
        # x 1000 brands x 16 dims); argmin ignores the constant ||a||^2
        d2 = (centers * centers).sum(-1)[None, :] - 2.0 * (lv @ centers.T)
        assign = d2.argmin(1).astype(np.int32)
        for b in range(centers.shape[0]):
            m = assign == b
            if m.any():
                centers[b] = lv[m].mean(0)
    return assign


def generate_interactions(
    rng: np.random.Generator,
    num_users: int,
    num_items: int,
    mean_degree: float,
    core: int,
) -> Tuple[np.ndarray, np.ndarray]:
    """Sample (user, item) pairs with power-law popularity, deduplicated."""
    # per-user degree: lognormal around mean_degree, floored at core
    deg = np.maximum(
        core, rng.lognormal(np.log(mean_degree), 0.6, num_users)
    ).astype(np.int64)
    deg = np.minimum(deg, num_items)
    total = int(deg.sum())
    users = np.repeat(np.arange(num_users, dtype=np.int64), deg)
    # Zipf-ish popularity over items via a shuffled ranking
    ranks = rng.permutation(num_items).astype(np.float64)
    probs = 1.0 / (ranks + 10.0)
    probs /= probs.sum()
    items = rng.choice(num_items, size=total, p=probs)
    # dedup per (user, item)
    key = users * num_items + items
    _, keep = np.unique(key, return_index=True)
    keep.sort()
    return users[keep].astype(np.int32), items[keep].astype(np.int32)


def generate_synthetic_dataset(
    out_dir: str,
    num_users: int = 2000,
    num_items: int = 1000,
    num_brands: int = 50,
    mean_degree: float = 20.0,
    core: int = 5,
    seed: int = 42,
    embedding_dim: Optional[int] = None,
    style: str = "popularity",
    latent_dim: int = 16,
    temperature: float = 0.35,
    pop_scale: float = 0.5,
    emb_noise: Optional[float] = None,
    brand_style: str = "random",
    split: str = "random",
    pop_df: Optional[float] = None,
    deg_sigma: float = 0.5,
    emb_style: str = "informative",
    spectrum: float = 0.0,
    pop_zipf: Optional[float] = None,
    rank_key: str = "full",
    taste_style: str = "gaussian",
    clusters_per_user: int = 3,
) -> str:
    """Write a synthetic processed dataset; returns the output dir.

    ``style``: 'popularity' (Zipf, fast) or 'latent' (latent-factor taste
    model with learnable collaborative structure).  In latent style,
    ``latent_dim``/``temperature`` set the regime (see
    generate_interactions_latent), ``emb_noise`` (not None) derives the
    item-embedding matrix from the true item factors via
    informative_item_embeddings instead of pure noise
    (``emb_style='mislead'`` uses misleading_item_embeddings instead),
    and ``brand_style='latent'`` clusters brands in taste space
    (latent_cluster_brands).

    ``split``: 'random' holds out one uniformly chosen interaction per
    user; 'rank' (latent style only) holds out each user's **highest
    realized-preference** interaction and writes train rows in
    descending preference order — the reference recipes' rating-rank
    leave-one-out (dataset/amazon_books/prepare_data.py:95-97: test =
    rank-1 by rating; the runtime loader then takes the first train row
    per user as val, main.py:201-203 — here rank-2).  The random split
    holds out a *draw* (partly Gumbel noise, unpredictable from taste),
    so eval recall decays once the model sharpens past the popularity
    prior; the rank split holds out the most preference-aligned item,
    which better training keeps ranking higher — the late-climb-and-hold
    curve shape of every reference run (REGIMES.md divergence #1).

    ``pop_df`` / ``deg_sigma``: tail knobs, see
    generate_interactions_latent.
    """
    rng = np.random.default_rng(seed)
    lv = None
    if style == "latent":
        users, items, lv = generate_interactions_latent(
            rng, num_users, num_items, mean_degree, core,
            latent_dim=latent_dim, temperature=temperature,
            pop_scale=pop_scale, return_latents=True,
            pop_df=pop_df, deg_sigma=deg_sigma, spectrum=spectrum,
            pop_zipf=pop_zipf, rank_key=rank_key,
            taste_style=taste_style, clusters_per_user=clusters_per_user,
        )
    else:
        users, items = generate_interactions(
            rng, num_users, num_items, mean_degree, core
        )

    # keep only users with >= 3 interactions so every user survives the
    # leave-one-out test split plus the loader's val split
    counts = np.bincount(users, minlength=num_users)
    ok = counts[users] >= 3
    users, items = users[ok], items[ok]

    if split == "rank":
        if style != "latent":
            raise ValueError("split='rank' requires style='latent'")
        # rows are already per-user contiguous in descending realized-
        # preference order (generate_interactions_latent docstring);
        # test = rank-1 per user, train keeps the order for the loader's
        # rank-2 val pick
        _, first_pos = np.unique(users, return_index=True)
        is_test = np.zeros(len(users), dtype=bool)
        is_test[first_pos] = True
        train_u, train_i = users[~is_test], items[~is_test]
        test_u, test_i = users[is_test], items[is_test]
    else:
        # leave-one-out: one random interaction per user -> test
        order = rng.permutation(len(users))
        u_shuf, i_shuf = users[order], items[order]
        _, first_pos = np.unique(u_shuf, return_index=True)
        is_test = np.zeros(len(u_shuf), dtype=bool)
        is_test[first_pos] = True

        train_u, train_i = u_shuf[~is_test], i_shuf[~is_test]
        test_u, test_i = u_shuf[is_test], i_shuf[is_test]

    # one or two brands per item
    if brand_style == "latent" and lv is not None:
        brand1 = latent_cluster_brands(rng, lv, num_brands)
    else:
        brand1 = rng.integers(0, num_brands, num_items)
    has2 = rng.random(num_items) < 0.3
    brand2 = rng.integers(0, num_brands, num_items)
    ib_item = np.concatenate([np.arange(num_items), np.arange(num_items)[has2]])
    ib_brand = np.concatenate([brand1, brand2[has2]])

    os.makedirs(out_dir, exist_ok=True)
    write_columns(os.path.join(out_dir, "train.parquet"),
                  {"user_idx": train_u, "item_idx": train_i})
    write_columns(os.path.join(out_dir, "test.parquet"),
                  {"user_idx": test_u, "item_idx": test_i})
    write_columns(os.path.join(out_dir, "item_brand.parquet"),
                  {"item_idx": ib_item.astype(np.int32), "brand_idx": ib_brand.astype(np.int32)})
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
        if emb_noise is not None and lv is not None:
            maker = (
                misleading_item_embeddings
                if emb_style == "mislead"
                else informative_item_embeddings
            )
            emb = maker(rng, lv, embedding_dim, emb_noise)
        else:
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
    style: str = "popularity",
    latent_dim: int = 16,
    temperature: float = 0.35,
    pop_scale: float = 0.5,
    split: str = "random",
    pop_df: Optional[float] = None,
    deg_sigma: float = 0.5,
    return_latents: bool = False,
    spectrum: float = 0.0,
    pop_zipf: Optional[float] = None,
    rank_key: str = "full",
    taste_style: str = "gaussian",
    clusters_per_user: int = 3,
):
    """Build a DataBundle fully in memory (no parquet round-trip).

    Used where file I/O is noise (``chip_smoke.py``, the tests).
    ``style`` as in generate_synthetic_dataset; ``latent_dim`` /
    ``temperature`` are the latent-style regime knobs; ``split`` /
    ``pop_df`` / ``deg_sigma`` as in generate_synthetic_dataset
    (split='rank': test = rank-1, val = rank-2 realized preference —
    the reference's rating-rank protocol).  ``return_latents`` also
    returns ``(lu, lv, pop)`` so calibration tools can compute the
    oracle recall of the true generative scores.
    """
    from gcn_recommendation_tpu_torch.data.loader import (
        DataBundle,
        Interactions,
        ItemBrand,
        compute_graph_stats,
    )
    from gcn_recommendation_tpu_torch.graph.build import build_normalized_adjacency

    rng = np.random.default_rng(seed)
    latents = None
    if style == "latent":
        users, items, latents = generate_interactions_latent(
            rng, num_users, num_items, mean_degree, core,
            latent_dim=latent_dim, temperature=temperature,
            pop_scale=pop_scale, pop_df=pop_df, deg_sigma=deg_sigma,
            spectrum=spectrum, pop_zipf=pop_zipf, rank_key=rank_key,
            taste_style=taste_style, clusters_per_user=clusters_per_user,
            return_state=True,
        )
    else:
        if split == "rank":
            raise ValueError("split='rank' requires style='latent'")
        users, items = generate_interactions(
            rng, num_users, num_items, mean_degree, core
        )
    counts = np.bincount(users, minlength=num_users)
    ok = counts[users] >= 3
    users, items = users[ok], items[ok]

    if split == "rank":
        # rows are per-user contiguous in descending realized-preference
        # order; hold out rank-1 as test, rank-2 as val
        u_shuf, i_shuf = users, items
    else:
        order = rng.permutation(len(users))
        u_shuf, i_shuf = users[order], items[order]
    _, first = np.unique(u_shuf, return_index=True)
    mask = np.zeros(len(u_shuf), dtype=bool)
    mask[first] = True
    test = Interactions(u_shuf[mask], i_shuf[mask])
    rest_u, rest_i = u_shuf[~mask], i_shuf[~mask]
    _, first2 = np.unique(rest_u, return_index=True)
    mask2 = np.zeros(len(rest_u), dtype=bool)
    mask2[first2] = True
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
    item_to_brand = brand1.copy()
    stats = compute_graph_stats(
        train, item_brand, num_users, num_items, num_brands, use_brand
    )
    bundle = DataBundle(
        train=train,
        val=val,
        test=test,
        num_users=num_users,
        num_items=num_items,
        num_brands=num_brands,
        graph=graph,
        item_brand=item_brand,
        item_to_brand=item_to_brand,
        graph_stats=stats,
    )
    if return_latents:
        return bundle, latents
    return bundle
