"""Experiment-grid runner with the reference's artifact layout.

Counterpart of the JAX package's ``tools/run_experiments.py``: the same
grid tables, code names, flags, directory layout and summary lines, run
through the port's ``Config``, ``load_preprocessed_data``, ``get_model``,
``Logger`` and ``Trainer.fit``.  Each code
``{base|loss|lase}_<E>e<C>c_{brd|nob}[_emb|_fus|_fusemb]`` writes
``<exp_name>/results/<code>/<name>_epoch_history.csv`` (``epoch,avg_loss,
recall,ndcg``, one row every ``val_interval`` epochs), ``<name>_throughput.csv``
and, where matplotlib is installed, the curves PNG; checkpoints go under
``<exp_name>/checkpoints/<code>/``.

    python -m gcn_recommendation_tpu_torch.tools.run_experiments \\
        --processed_dir dataset/torch_synthetic_books/processed_data_16 \\
        --exp_name exp_torch_synth --epochs 150 --core 16 --with_brand_loss

Runs on the card unless ``--device cpu`` is given.
"""

from __future__ import annotations

import argparse
import os
import time

import numpy as np

# (suffix, model_name, use_brand, brand_loss, use_pretrained_emb, fusion_id_init)
GRID = [
    ("brd", "LightGCN", True, False, False, False),
    ("nob", "LightGCN", False, False, False, False),
    ("brd_emb", "LightGCN", True, False, True, False),
    ("nob_emb", "LightGCN", False, False, True, False),
    ("brd_fus", "LightGCN_Fusion", True, False, True, False),
    ("nob_fus", "LightGCN_Fusion", False, False, True, False),
    # Fusion + pretrained item-ID init (trainable): the reference's
    # exp_books/results/base_150e20c_nob_fusemb run
    ("nob_fusemb", "LightGCN_Fusion", False, False, True, True),
]
LOSS_GRID = [
    ("brd", "LightGCN", True, True, False, False),
    ("nob", "LightGCN", False, True, False, False),
    # brand-loss + pretrained-emb init (reference
    # exp_books/results/loss_150e20c_{brd,nob}_emb)
    ("brd_emb", "LightGCN", True, True, True, False),
    ("nob_emb", "LightGCN", False, True, True, False),
]
ALL_GRIDS = {"base": GRID, "loss": LOSS_GRID, "lase": GRID}


def run_variant(args, tag, suffix, model_name, use_brand, brand_loss,
                use_pretrained, fusion_id_init=False):
    """Train one code; returns (code, best val recall), or None when a
    Fusion code has no content matrix to read."""
    from gcn_recommendation_tpu_torch.config import Config
    from gcn_recommendation_tpu_torch.core.device import resolve_device
    from gcn_recommendation_tpu_torch.data.loader import load_preprocessed_data
    from gcn_recommendation_tpu_torch.models import get_model
    from gcn_recommendation_tpu_torch.train.trainer import Trainer
    from gcn_recommendation_tpu_torch.utils.logging import Logger

    code = f"{tag}_{args.epochs}e{args.core}c_{suffix}"
    results_dir = os.path.join(args.exp_name, "results", code)
    ckpt_dir = os.path.join(args.exp_name, "checkpoints", code)
    cfg = Config(
        model_name=model_name,
        epochs=args.epochs,
        core=args.core,
        processed_data_dir=args.processed_dir,
        use_brand=use_brand,
        brand_loss=brand_loss,
        use_pretrained_emb=use_pretrained,
        fusion_id_init=fusion_id_init,
        checkpoint_dir=ckpt_dir,
        results_dir=results_dir,
        batch_size=args.batch_size,
        seed=args.seed,
    )
    pretrained = None
    needs_emb = use_pretrained or model_name == "LightGCN_Fusion"
    if needs_emb:
        path = cfg.pretrained_emb_path
        if os.path.exists(path):
            pretrained = np.load(path)
        elif model_name == "LightGCN_Fusion":
            print(f"[{code}] SKIP — Fusion needs {path}")
            return None
        else:
            print(f"[{code}] WARNING: no pretrained embeddings at {path}")

    print(f"=== [{code}] {model_name} brand={use_brand} loss={brand_loss} "
          f"pretrained={use_pretrained} ===", flush=True)
    t0 = time.perf_counter()
    bundle = load_preprocessed_data(cfg.data_dir, use_brand=use_brand, verbose=False)
    model = get_model(model_name)(
        bundle.num_users, bundle.num_items, bundle.num_brands, cfg,
        pretrained_item_emb=pretrained, device=resolve_device(args.device),
    )
    logger = Logger(results_dir, cfg.logger_name(), top_k=cfg.top_k)
    trainer = Trainer(cfg, model, bundle, logger=logger)
    _, best = trainer.fit()
    print(f"[{code}] best val recall = {best:.4f}")
    print(f"[{code}] {time.perf_counter() - t0:.1f} s, {trainer.steps_per_epoch} steps an epoch",
          flush=True)
    return code, best


def selected_grids(args):
    """[(tag, grid)] in run order, as the flags pick them."""
    if args.grids:
        return [(t, ALL_GRIDS[t]) for t in args.grids.split(",")]
    grids = [("base", GRID)]
    if args.with_brand_loss:
        grids.append(("loss", LOSS_GRID))
    if args.with_lase:
        grids.append(("lase", GRID))
    return grids


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--processed_dir", type=str, required=True)
    ap.add_argument("--exp_name", type=str, default="exp")
    ap.add_argument("--epochs", type=int, default=150)
    ap.add_argument("--core", type=int, default=16)
    ap.add_argument("--batch_size", type=int, default=2048)
    ap.add_argument("--with_brand_loss", action="store_true",
                    help="also run the loss_* grid (brand-preference loss)")
    ap.add_argument("--with_lase", action="store_true",
                    help="also emit the reference's lase_* dirs (same runs as "
                         "base_* under the alternate code of its exp_zno)")
    ap.add_argument("--only", type=str, default=None,
                    help="comma-separated suffixes to run (e.g. brd,nob_fus)")
    ap.add_argument("--seed", type=int, default=42,
                    help="RNG seed (the duplicate lase_* runs differ from base_* "
                         "by run-to-run variance, so give them another, e.g. 43)")
    ap.add_argument("--grids", type=str, default=None,
                    help="comma-separated grid tags to run (base,loss,lase); "
                         "default: base (+loss/lase per the flags above)")
    ap.add_argument("--device", type=str, default="cuda",
                    help="torch device ('cuda', 'cuda:1', 'cpu')")
    return ap


def main(argv=None):
    args = build_parser().parse_args(argv)
    results = []
    for tag, grid in selected_grids(args):
        for suffix, model, brand, bloss, pre, id_init in grid:
            if args.only and suffix not in args.only.split(","):
                continue
            out = run_variant(args, tag, suffix, model, brand, bloss, pre,
                              fusion_id_init=id_init)
            if out:
                results.append(out)

    print("\n=== Summary (best val Recall@20) ===")
    for code, best in results:
        print(f"  {code}: {best:.4f}")
    return results


if __name__ == "__main__":
    main()
