"""Experiment: how many edges node orderings put into 128 x 128 tiles worth a dense product.

Counterpart of the JAX package's ``tools/exp_block_density.py``, a
host-only study (numpy; scipy's ``svds`` for the co-clustering) on the
port's generator (``data/synthetic.py``) at bench scale (50k users / 20k
items / 2k brands, degree 28, core 8, seed 42), over three styles:
``popularity``, ``latent`` and ``heavy`` (``latent`` with ``pop_zipf=0.6,
deg_sigma=1.0, spectrum=1.0, split="rank", rank_key="taste"``).  For the
user-item matrix in its original order, degree-sorted, and co-clustered
(truncated SVD, k-means on the factors, order by cluster), it prints the
share of edges in tiles that hold at least the break-even count of edges;
then the share of hub edges and the non-hub tiles after degree sorting,
and the coverage of greedy co-occurrence pair packing.

Two break-evens.  ``BREAK_EVEN_EDGES = 36`` is the TPU's (a 64 KB f32
tile at its HBM rate against its ~2.2 ns gathered row); the lines at 36
are the JAX tool's, text for text.  The card's follows the same rule with
its own rates: one f32 128 x 128 tile is 65,536 bytes, 19.6 ns at 3.35
TB/s; a gathered d = 64 row of the production ELL gather costs 0.91 ns
(``tools/exp_min_width.py``'s fused form at width 8, measured on an
NVIDIA H100 80GB HBM3 at 700 W; its width-1 gathers 0.72 ns), so a tile
pays from 19.6 / 0.91 = 21.5 edges (27.2 against the width-1 form).
``--card_break_even`` (default 22) prints a second line at that count.

``svds`` starts ARPACK from a random vector, so the co-clustered line
depends on its start; this tool draws it from a fixed seed.

    python -m gcn_recommendation_tpu_torch.tools.exp_block_density
"""

from __future__ import annotations

import argparse

import numpy as np

TILE = 128
BREAK_EVEN_EDGES = 36
CARD_TILE_NS = TILE * TILE * 4 / 3.35e12 * 1e9     # 19.56 ns
CARD_GATHER_NS = 0.91                               # exp_min_width, fused, width 8
CARD_BREAK_EVEN_EDGES = int(np.ceil(CARD_TILE_NS / CARD_GATHER_NS))  # 22
STYLES = ("popularity", "latent", "heavy")


def tile_stats(u, i, nu, ni, name, break_even: int = BREAK_EVEN_EDGES):
    """Fraction of edges in >= ``break_even`` tiles of the U x I grid."""
    tu = u // TILE
    ti = i // TILE
    key = tu.astype(np.int64) * (-(-ni // TILE)) + ti
    counts = np.bincount(key)
    nz_tiles = counts[counts > 0]
    dense_edges = counts[counts >= break_even].sum()
    frac = dense_edges / len(u)
    print(
        f"{name:14s} tiles>={break_even}: {frac*100:5.1f}% of edges   "
        f"(nz tiles {len(nz_tiles):,}, mean fill {nz_tiles.mean():.2f}, "
        f"p99 {np.percentile(nz_tiles, 99):.0f})",
        flush=True,
    )
    return frac


def tile_stats_both(u, i, nu, ni, name, card_break_even: int):
    """``tile_stats`` at the TPU's break-even, then at the card's."""
    return (tile_stats(u, i, nu, ni, name),
            tile_stats(u, i, nu, ni, name, card_break_even))


def degree_order(x, n):
    """Rank of each id when sorted by descending degree."""
    p = np.empty(n, np.int64)
    p[np.argsort(-np.bincount(x, minlength=n))] = np.arange(n)
    return p


def hub_split_stats(u, i, nu, ni, hub_threshold=512, card_break_even=None):
    """Hub-destination edges go to the dense path; only non-hub edges are
    candidates for tiling.  Tile coverage of the non-hub edges after
    degree sorting."""
    di = np.bincount(i, minlength=ni)
    hub = di[i] >= hub_threshold
    frac_hub = hub.mean()
    uu, ii = u[~hub], i[~hub]
    print(f"  hub edges (item deg>={hub_threshold}): {frac_hub*100:.1f}%",
          flush=True)
    pu, pi = degree_order(uu, nu), degree_order(ii, ni)
    out = [tile_stats(pu[uu], pi[ii], nu, ni, "  non-hub deg-sorted")]
    if card_break_even is not None:
        out.append(tile_stats(pu[uu], pi[ii], nu, ni, "  non-hub deg-sorted", card_break_even))
    return out


def pair_coverage(u, i, nu, ni, sample_per_user=32, seed=0):
    """Greedy co-occurrence pair packing coverage: the fraction of edges
    (u, i) whose item's matched partner also appears in u's list (each
    such pair of edges could be served by one gathered paired row)."""
    rng = np.random.default_rng(seed)
    order = np.argsort(u, kind="stable")
    us, isrt = u[order], i[order]
    starts = np.searchsorted(us, np.arange(nu))
    ends = np.searchsorted(us, np.arange(nu) + 1)
    # co-occurrence counts on a per-user sample (hub users capped):
    # all within-user pair keys, then unique + count
    keys = []
    tri = np.triu_indices(sample_per_user, k=1)
    for a, b in zip(starts, ends):
        row = isrt[a:b]
        if len(row) > sample_per_user:
            row = rng.choice(row, sample_per_user, replace=False)
        row = np.sort(row)
        n = len(row)
        if n < 2:
            continue
        x, y = tri
        m = y < n
        keys.append(row[x[m]].astype(np.int64) * ni + row[y[m]])
    allk = np.concatenate(keys)
    uk, cnt = np.unique(allk, return_counts=True)
    srt = np.argsort(-cnt)
    # greedy disjoint matching by count
    partner = np.full(ni, -1, np.int64)
    for k in uk[srt]:
        a, b = int(k // ni), int(k % ni)
        if partner[a] < 0 and partner[b] < 0:
            partner[a] = b
            partner[b] = a
    # coverage over all edges: (u, i) is covered iff partner[i] is one of u's items
    covered = 0
    for a, b in zip(starts, ends):
        row = isrt[a:b]
        p = partner[row]
        ok = p >= 0
        if ok.any():
            covered += int(np.isin(p[ok], row).sum())
    print(f"  pair-packing coverage: {covered / len(u) * 100:.1f}% of edges "
          f"(break-even ~20%)", flush=True)
    return covered / len(u)


def kmeans(x, n_clusters, rng, iters=15):
    """Lloyd's k-means from ``n_clusters`` rows drawn by ``rng``; returns
    each row's cluster."""
    c = x[rng.choice(len(x), n_clusters, replace=False)]
    assign = np.zeros(len(x), np.int64)
    for _ in range(iters):
        for lo in range(0, len(x), 4096):  # chunked assignment
            xx = x[lo:lo + 4096]
            dd = (xx ** 2).sum(1)[:, None] - 2 * xx @ c.T + (c ** 2).sum(1)[None]
            assign[lo:lo + 4096] = dd.argmin(1)
        for j in range(n_clusters):
            mask = assign == j
            if mask.any():
                c[j] = x[mask].mean(0)
    return assign


def cocluster_order(u, i, nu, ni, k=16, svd_seed=0):
    """(user rank, item rank) ordering ids by k-means cluster of their SVD
    factors (scaled by sqrt of the singular values), ties by id."""
    import scipy.sparse as sp
    from scipy.sparse.linalg import svds

    m = sp.coo_matrix((np.ones(len(u), np.float32), (u, i)), (nu, ni)).tocsr()
    v0 = np.random.default_rng(svd_seed).standard_normal(min(nu, ni)).astype(np.float32)
    uf, s, vt = svds(m.astype(np.float32), k=k, v0=v0)
    rng = np.random.default_rng(0)
    cu = kmeans(uf * s[None, :] ** 0.5, max(2, nu // 2000), rng)
    ci = kmeans(vt.T * s[None, :] ** 0.5, max(2, ni // 1000), rng)
    pu = np.empty(nu, np.int64)
    pu[np.lexsort((np.arange(nu), cu))] = np.arange(nu)
    pi = np.empty(ni, np.int64)
    pi[np.lexsort((np.arange(ni), ci))] = np.arange(ni)
    return pu, pi


def style_kwargs(style: str) -> dict:
    if style == "heavy":
        return dict(style="latent", pop_zipf=0.6, deg_sigma=1.0, spectrum=1.0,
                    split="rank", rank_key="taste")
    return dict(style=style)


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--num_users", type=int, default=50_000)
    ap.add_argument("--num_items", type=int, default=20_000)
    ap.add_argument("--num_brands", type=int, default=2_000)
    ap.add_argument("--styles", nargs="+", choices=STYLES, default=list(STYLES))
    ap.add_argument("--card_break_even", type=int, default=CARD_BREAK_EVEN_EDGES,
                    help="edges a tile must hold to beat the gathers on the card")
    args = ap.parse_args(argv)

    from gcn_recommendation_tpu_torch.data.synthetic import synthetic_bundle

    print("device: host (numpy / scipy; no device time)", flush=True)
    print(f"break-even: TPU {BREAK_EVEN_EDGES} edges; card {args.card_break_even} edges "
          f"(f32 tile {CARD_TILE_NS:.1f} ns at 3.35 TB/s over {CARD_GATHER_NS} ns a "
          f"gathered row)", flush=True)
    out = {}
    for style in args.styles:
        print(f"--- {style} graph (bench scale) ---", flush=True)
        bundle = synthetic_bundle(
            num_users=args.num_users, num_items=args.num_items, num_brands=args.num_brands,
            mean_degree=28.0, core=8, seed=42, **style_kwargs(style),
        )
        u = bundle.train.user_idx.astype(np.int64)
        i = bundle.train.item_idx.astype(np.int64)
        nu, ni = bundle.num_users, bundle.num_items
        res = {"original": tile_stats_both(u, i, nu, ni, "original", args.card_break_even)}
        pu, pi = degree_order(u, nu), degree_order(i, ni)
        res["degree-sorted"] = tile_stats_both(pu[u], pi[i], nu, ni, "degree-sorted",
                                               args.card_break_even)
        pu, pi = cocluster_order(u, i, nu, ni)
        res["co-clustered"] = tile_stats_both(pu[u], pi[i], nu, ni, "co-clustered",
                                              args.card_break_even)
        res["non-hub"] = hub_split_stats(u, i, nu, ni, card_break_even=args.card_break_even)
        res["pair"] = pair_coverage(u, i, nu, ni)
        out[style] = res
    return {"card_break_even": args.card_break_even, "styles": out}


if __name__ == "__main__":
    main()
