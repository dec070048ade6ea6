"""One-command readiness drill for a real review dump.

Counterpart of the JAX package's ``tools/real_data_dryrun.py``.  The raw
Amazon and Steam dumps of the reference are not in the repository, so
every recipe has run only on synthetic or fixture data; this is the
command to run against a real dump:

    python -m gcn_recommendation_tpu_torch.tools.real_data_dryrun --recipe amazon_books \\
        --review_path /data/Books.jsonl --meta_path /data/meta_Books.jsonl

It runs, in order, and prints each stage:

1. the recipe's ETL (``data/prepare.py``, numpy and the standard library,
   no pandas) into a scratch directory, malformed lines skipped and
   counted, never fatal;
2. the loader and the graph build (``data/loader.py``: dedup-sum,
   D^-1/2 A D^-1/2, the graph statistics);
3. a debug-scale training smoke (the reference's ``--debug`` protocol: a
   1% user sample, at most 10 batches an epoch, a validation every epoch;
   ``Config(debug=True)`` runs 5 epochs, as in the JAX package, though the
   stage asks for 2) on the port's ``Trainer``.

Exit 0: the dump is ingestible and trainable; 2: an unknown recipe or a
missing input file; 1: the ETL kept no interaction.  ``--full_dir`` keeps
the processed files for a real run.  Training runs on the card unless
``--device cpu`` is given.
"""

from __future__ import annotations

import argparse
import os
import sys
import tempfile


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--recipe", required=True,
                   help="amazon_books | amazon_books_emb | amazon_books_senti "
                        "| amazon_sport_emb | steam_emb")
    p.add_argument("--review_path", required=True)
    p.add_argument("--meta_path", required=True)
    p.add_argument("--core", type=int, default=None,
                   help="K-core threshold (default: the recipe's)")
    p.add_argument("--full_dir", type=str, default=None,
                   help="Keep processed artifacts here (default: temp dir)")
    p.add_argument("--skip_train", action="store_true",
                   help="Stop after the loader/graph stage")
    p.add_argument("--device", type=str, default="cuda")
    args = p.parse_args(argv)

    from gcn_recommendation_tpu_torch.data.prepare import RECIPES, prepare_and_save_data

    if args.recipe not in RECIPES:
        print(f"unknown recipe {args.recipe!r}; known: {sorted(RECIPES)}")
        return 2
    for path in (args.review_path, args.meta_path):
        if not os.path.exists(path):
            print(f"missing input file: {path}")
            return 2

    from gcn_recommendation_tpu_torch.core.device import resolve_device
    from gcn_recommendation_tpu_torch.utils.timing import device_line

    dev = resolve_device(args.device)
    print(device_line(dev), flush=True)
    base = args.full_dir or tempfile.mkdtemp(prefix="gcnrec_dryrun_")
    print(f"=== stage 1/3: ETL ({args.recipe}) -> {base}", flush=True)
    out = prepare_and_save_data(RECIPES[args.recipe], args.review_path, args.meta_path, base,
                                core=args.core)
    if not out:
        print("FAIL: ETL produced no usable interactions")
        return 1

    print("=== stage 2/3: loader + graph build", flush=True)
    from gcn_recommendation_tpu_torch.data.loader import load_preprocessed_data

    bundle = load_preprocessed_data(out, use_brand=True, debug=False)
    if bundle.graph.nnz == 0:
        print("FAIL: empty adjacency")
        return 1
    if args.skip_train:
        print("dryrun OK (train skipped)")
        return 0

    print("=== stage 3/3: 2-epoch debug-scale training smoke", flush=True)
    from gcn_recommendation_tpu_torch.config import Config
    from gcn_recommendation_tpu_torch.models import get_model
    from gcn_recommendation_tpu_torch.train.trainer import Trainer

    with tempfile.TemporaryDirectory() as scratch:
        cfg = Config(processed_data_dir=out, epochs=2,
                     debug=True,  # 1% user sample + <= 10 batches an epoch
                     val_interval=1, checkpoint_dir=os.path.join(scratch, "ck"),
                     results_dir=os.path.join(scratch, "res"))
        debug_bundle = load_preprocessed_data(out, use_brand=True, debug=True)
        model = get_model("LightGCN")(debug_bundle.num_users, debug_bundle.num_items,
                                      debug_bundle.num_brands, cfg, device=dev)
        _, best = Trainer(cfg, model, debug_bundle).fit()
        print(f"debug-train best recall: {best:.4f}")

    print(f"dryrun OK — artifacts at {out}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
