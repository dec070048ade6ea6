"""Calibrate synthetic regime knobs against the reference recall bands.

Counterpart of the JAX package's ``tools/calibrate_regimes.py``: it
short-trains LightGCN (the port's ``Trainer`` and ``Logger``) on a latent
generator's knob setting (``data/synthetic.py``: temperature, latent dim,
catalog size, degree, the tail and split knobs) and prints the recall
trajectory, so the regime definitions below, which
``tools/run_regime_grids.py`` reads, are measured, not guessed.  The
arguments, the regime overrides and the printed lines are the JAX tool's:
``bundle: ...``, ``oracle recall@20 (val): ...`` (with ``--oracle``: the
recall of ranking by the true generative scores, train items masked, the
ceiling no trained model can beat) and ``SUMMARY best R@20=... hold=...
peak_frac=...``.

    python -m gcn_recommendation_tpu_torch.tools.calibrate_regimes --regime dense
    python -m gcn_recommendation_tpu_torch.tools.calibrate_regimes --regime zno --oracle
    python -m gcn_recommendation_tpu_torch.tools.calibrate_regimes --num_users 6000 \\
        --num_items 2500 --mean_degree 50 --temperature 0.2 --latent_dim 8 --epochs 40

Runs on the card unless ``--device cpu`` is given.  Checkpoints and CSVs
go to a fresh temporary directory.
"""

from __future__ import annotations

import argparse
import tempfile
import time

import numpy as np

# The regime definitions, as the JAX package's tools/calibrate_regimes.py
# commits them (calibrated there against the reference's recall bands).
REGIMES = {
    # books: the committed exp_synth/ grid's recipe
    "books": dict(num_users=10000, num_items=5000, num_brands=200,
                  mean_degree=25.0, latent_dim=16, temperature=0.35,
                  pop_scale=0.5),
    # the community-structured generator, a starting point for re-banding
    # the sparse regimes
    "books_cluster": dict(num_users=10000, num_items=5000, num_brands=200,
                          mean_degree=25.0, latent_dim=50, temperature=0.3,
                          pop_scale=0.5, split="rank", rank_key="taste",
                          pop_zipf=0.6, deg_sigma=1.0,
                          taste_style="cluster", clusters_per_user=3),
    # dense steam-like: popularity-concentrated taste, converged by ep135
    "dense": dict(num_users=6000, num_items=2500, num_brands=100,
                  mean_degree=100.0, latent_dim=8, temperature=0.27,
                  pop_scale=1.0, emb_style="mislead"),
    # weak signal: best R@20 ~0.06, flat from epoch 5
    "zno": dict(num_users=12000, num_items=8000, num_brands=300,
                mean_degree=15.0, latent_dim=20, temperature=0.40,
                pop_scale=0.5),
    # sparse sport: one Fusion run, early peak in the 0.05 band
    "sport": dict(num_users=12000, num_items=10000, num_brands=300,
                  mean_degree=13.0, latent_dim=20, temperature=0.41,
                  pop_scale=0.5),
}


def oracle_recall(bundle, lu, lv, pop, k: int = 20) -> float:
    """Recall@k on the val split of ranking by the true generative scores
    ``lu @ lv.T + pop`` with each user's train items masked."""
    hits = 0
    train_sets = {}
    for u, i in zip(bundle.train.user_idx, bundle.train.item_idx):
        train_sets.setdefault(int(u), set()).add(int(i))
    scores_all = lu @ lv.T + pop[None, :]
    for u, i in zip(bundle.val.user_idx, bundle.val.item_idx):
        s = scores_all[int(u)].copy()
        seen = train_sets.get(int(u))
        if seen:
            s[list(seen)] = -1e10
        top = np.argpartition(-s, k)[:k]
        hits += int(i) in set(int(t) for t in top)
    return hits / len(bundle.val)


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--regime", choices=sorted(REGIMES), default=None)
    ap.add_argument("--num_users", type=int, default=6000)
    ap.add_argument("--num_items", type=int, default=2500)
    ap.add_argument("--num_brands", type=int, default=100)
    ap.add_argument("--mean_degree", type=float, default=50.0)
    ap.add_argument("--latent_dim", type=int, default=8)
    ap.add_argument("--temperature", type=float, default=0.2)
    ap.add_argument("--pop_scale", type=float, default=0.5)
    ap.add_argument("--epochs", type=int, default=40)
    ap.add_argument("--val_interval", type=int, default=5)
    ap.add_argument("--seed", type=int, default=42)
    ap.add_argument("--split", choices=["random", "rank"], default=None,
                    help="Leave-one-out mode (default: the regime's; "
                         "'rank' = reference rating-rank protocol)")
    ap.add_argument("--pop_df", type=float, default=None,
                    help="Student-t df for popularity logits (heavy tail)")
    ap.add_argument("--deg_sigma", type=float, default=None,
                    help="Lognormal sigma of user degrees")
    ap.add_argument("--spectrum", type=float, default=None,
                    help="Power-law decay of taste-factor variances")
    ap.add_argument("--pop_zipf", type=float, default=None,
                    help="Exact-Zipf popularity exponent (overrides "
                         "pop_df/pop_scale's distribution)")
    ap.add_argument("--taste_style", choices=["gaussian", "cluster"], default=None,
                    help="Factor-loading distribution ('cluster' = item "
                         "communities; latent_dim = community count)")
    ap.add_argument("--clusters_per_user", type=int, default=None)
    ap.add_argument("--rank_key", choices=["full", "taste"], default=None,
                    help="Rank-split ordering key ('taste' = rating-rank "
                         "analogue, popularity excluded)")
    ap.add_argument("--oracle", action="store_true",
                    help="Also print the oracle recall@20 of the true "
                         "generative scores on the val split")
    ap.add_argument("--device", type=str, default="cuda")
    args = ap.parse_args(argv)
    # flags for the tail/split knobs override the regime dict; unset
    # anywhere -> generator defaults
    flags = {k: getattr(args, k)
             for k in ("split", "pop_df", "deg_sigma", "spectrum", "pop_zipf",
                       "rank_key", "taste_style", "clusters_per_user")
             if getattr(args, k) is not None}
    if args.regime:
        for k, v in REGIMES[args.regime].items():
            setattr(args, k, v)
    for k, default in (("split", "random"), ("pop_df", None),
                       ("deg_sigma", 0.5), ("spectrum", 0.0),
                       ("pop_zipf", None), ("rank_key", "full"),
                       ("taste_style", "gaussian"),
                       ("clusters_per_user", 3)):
        value = flags.get(k)
        if value is None:
            value = getattr(args, k, None)
        if value is None:
            value = default
        setattr(args, k, value)

    from gcn_recommendation_tpu_torch.config import Config
    from gcn_recommendation_tpu_torch.core.device import resolve_device
    from gcn_recommendation_tpu_torch.data.synthetic import synthetic_bundle
    from gcn_recommendation_tpu_torch.models import get_model
    from gcn_recommendation_tpu_torch.train.trainer import Trainer
    from gcn_recommendation_tpu_torch.utils.logging import Logger
    from gcn_recommendation_tpu_torch.utils.timing import device_line

    dev = resolve_device(args.device)
    print(device_line(dev), flush=True)
    t0 = time.time()
    bundle, (lu, lv, pop) = synthetic_bundle(
        num_users=args.num_users, num_items=args.num_items, num_brands=args.num_brands,
        mean_degree=args.mean_degree, core=16, seed=args.seed, style="latent",
        latent_dim=args.latent_dim, temperature=args.temperature, pop_scale=args.pop_scale,
        split=args.split, pop_df=args.pop_df, deg_sigma=args.deg_sigma,
        spectrum=args.spectrum, pop_zipf=args.pop_zipf, rank_key=args.rank_key,
        taste_style=args.taste_style, clusters_per_user=args.clusters_per_user,
        return_latents=True,
    )
    item_deg = np.bincount(bundle.train.item_idx, minlength=bundle.num_items)
    print(
        f"bundle: users={bundle.num_users} items={bundle.num_items} "
        f"train={len(bundle.train)} nnz={bundle.graph.nnz} "
        f"split={args.split} rank_key={args.rank_key} "
        f"pop_df={args.pop_df} deg_sigma={args.deg_sigma} "
        f"item-deg p50/p90/max={int(np.percentile(item_deg, 50))}/"
        f"{int(np.percentile(item_deg, 90))}/{int(item_deg.max())} "
        f"({time.time() - t0:.1f}s)",
        flush=True,
    )
    out = {}
    if args.oracle:
        out["oracle"] = oracle_recall(bundle, lu, lv, pop)
        print(f"oracle recall@20 (val): {out['oracle']:.4f}", flush=True)

    scratch = tempfile.mkdtemp(prefix="calib_")
    cfg = Config(epochs=args.epochs, val_interval=args.val_interval,
                 checkpoint_dir=scratch, results_dir=scratch)
    model = get_model("LightGCN")(bundle.num_users, bundle.num_items, bundle.num_brands, cfg,
                                  device=dev)
    logger = Logger(scratch, "calib", top_k=cfg.top_k)
    Trainer(cfg, model, bundle, logger=logger).fit()
    hist = logger.history
    if hist["epoch"]:
        recalls = np.asarray(hist["recall"])
        epochs = np.asarray(hist["epoch"])
        best = int(np.argmax(recalls))
        hold = recalls[-1] / max(recalls[best], 1e-12)
        out.update(best_recall=float(recalls[best]), best_epoch=int(epochs[best]),
                   final_recall=float(recalls[-1]), hold=float(hold),
                   peak_frac=float(epochs[best] / epochs[-1]))
        print(
            f"SUMMARY best R@{cfg.top_k}={recalls[best]:.4f} "
            f"(ep{epochs[best]}) final={recalls[-1]:.4f} (ep{epochs[-1]}) "
            f"hold={hold:.3f} peak_frac={epochs[best] / epochs[-1]:.2f}",
            flush=True,
        )
    return out


if __name__ == "__main__":
    main()
