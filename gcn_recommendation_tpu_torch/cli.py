"""Command-line entry point of the port: ``train``, ``test`` and ``recommend``.

Counterpart of ``gcn_recommendation_tpu/cli.py``'s modes of the same
names, with the same output lines:

    python -m gcn_recommendation_tpu_torch train --processed_dir DIR \
        [--model_name LightGCN_Fusion [--fusion_id_init]] \
        [--epochs 150] [--batch_size 2048] [--resume] \
        [--tile_spmm [--tile_min_fill 64] [--tile_dtype bfloat16]] [--device cpu]
    python -m gcn_recommendation_tpu_torch test --processed_dir DIR [--device cpu]
    python -m gcn_recommendation_tpu_torch recommend --processed_dir DIR \
        --model_path CKPT_DIR [--users 3,7] [--k 20] [--int8] \
        [--include_seen] [--device cpu]

Runs on ``cuda`` unless ``--device cpu`` is given.  Checkpoints are the
port's own (``utils/checkpoint.py``): ``train`` writes ``best.pt`` and
``last.pt`` under ``<checkpoint_dir>/<checkpoint_name>``, which ``test``
and ``recommend`` read.  Params of the JAX package, as numpy arrays, are
carried across with ``models/convert.py`` and saved with ``save_params``.
``LightGCN_Fusion`` reads its content matrix from the dataset's
``item_embeddings.npy`` in every mode and fails without it.  Reading the
parquet dataset needs pandas.
"""

from __future__ import annotations

import argparse
import os

import numpy as np


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        description="Train, test and serve LightGCN / LightGCN_Fusion (PyTorch/CUDA port)."
    )
    sub = p.add_subparsers(dest="mode", required=True)

    def add_common(sp):
        sp.add_argument("--model_name", type=str, default="LightGCN")
        sp.add_argument("--core", type=int, default=16)
        sp.add_argument("--dataset", type=str, default="steam_emb",
                        help="Dataset recipe name (see config.DATASET_DIR_TEMPLATES).")
        sp.add_argument("--data_root", type=str, default=".")
        sp.add_argument("--processed_dir", type=str, default=None,
                        help="Explicit processed-data dir (overrides --dataset).")
        sp.add_argument("--no_brand", action="store_true")
        sp.add_argument("--debug", action="store_true")
        sp.add_argument("--use_pretrained_emb", action="store_true",
                        help="Initialize item embeddings with pretrained text "
                             "embeddings (train); selects the checkpoint name.")
        sp.add_argument("--seed", type=int, default=42)
        sp.add_argument("--output_root", type=str, default=None,
                        help="Root of exp/ outputs (checkpoints + results).")
        sp.add_argument("--compute_dtype", type=str, default="float32",
                        choices=["float32", "bfloat16"])
        sp.add_argument("--device", type=str, default=None,
                        help="'cuda' (default) or 'cpu'.")

    tr = sub.add_parser("train", help="Train a model.")
    add_common(tr)
    tr.add_argument("--epochs", type=int, default=150)
    tr.add_argument("--batch_size", type=int, default=None)
    tr.add_argument("--learning_rate", type=float, default=None)
    tr.add_argument("--val_interval", type=int, default=None,
                    help="Validate every N epochs (default 5, main.py:66).")
    tr.add_argument("--brand_loss", action="store_true",
                    help="Enable the brand preference loss.")
    tr.add_argument("--fusion_id_init", action="store_true",
                    help="LightGCN_Fusion: also initialize the trainable item "
                         "ID table from the pretrained matrix.")
    tr.add_argument("--resume", action="store_true",
                    help="Resume from the rolling 'last' checkpoint.")
    tr.add_argument("--tile_spmm", action="store_true",
                    help="Propagate the dense row-block mass through block-"
                         "sparse 128x128 tiles (csrc/tile_spmm.cu on the card).")
    tr.add_argument("--tile_min_fill", type=int, default=64,
                    help="Edges a 128x128 tile needs to qualify.")
    tr.add_argument("--tile_dtype", type=str, default="float32",
                    choices=["float32", "bfloat16"])

    te = sub.add_parser("test", help="Evaluate the best checkpoint on the test split.")
    add_common(te)
    te.add_argument("--model_path", type=str, default=None,
                    help="Checkpoint dir (default: the train-mode location).")

    rc = sub.add_parser(
        "recommend", help="Serve top-k recommendations from a trained checkpoint."
    )
    add_common(rc)
    rc.add_argument("--model_path", type=str, default=None,
                    help="Checkpoint dir (default: the train-mode location).")
    rc.add_argument("--users", type=str, default=None,
                    help="Comma-separated user ids; default: a random sample.")
    rc.add_argument("--num_sample", type=int, default=8)
    rc.add_argument("--k", type=int, default=None,
                    help="Top-k size (default: config top_k).")
    rc.add_argument("--int8", action="store_true",
                    help="Serve from the int8 item catalog (CUDA "
                         "stochastic-rounding quantizer on the card).")
    rc.add_argument("--include_seen", action="store_true",
                    help="Do not filter the user's train-seen items.")
    return p


def _make_config(args):
    from gcn_recommendation_tpu_torch.config import Config

    kwargs = dict(
        model_name=args.model_name,
        dataset=args.dataset,
        core=args.core,
        data_root=args.data_root,
        processed_data_dir=args.processed_dir,
        use_brand=not args.no_brand,
        debug=args.debug,
        use_pretrained_emb=args.use_pretrained_emb,
        seed=args.seed,
        compute_dtype=args.compute_dtype,
    )
    if args.output_root:
        kwargs["checkpoint_dir"] = os.path.join(
            args.output_root, "exp", "checkpoints", "checkpoints"
        )
        kwargs["results_dir"] = os.path.join(args.output_root, "exp", "results", "results")
    if args.mode == "train":
        kwargs.update(
            epochs=args.epochs,
            brand_loss=args.brand_loss,
            fusion_id_init=args.fusion_id_init,
            tile_spmm=args.tile_spmm,
            tile_min_fill=args.tile_min_fill,
            tile_dtype=args.tile_dtype,
        )
        for name in ("batch_size", "learning_rate", "val_interval"):
            if getattr(args, name) is not None:
                kwargs[name] = getattr(args, name)
    return Config(**kwargs)


def _load_everything(config, device):
    """(bundle, model on ``device``).  The pretrained item matrix is read
    when the run asks for it or the model class says it needs one
    (``needs_content``: the content matrix of ``LightGCN_Fusion``;
    without the file the model's own ValueError stops the run)."""
    from gcn_recommendation_tpu_torch.data.loader import load_preprocessed_data
    from gcn_recommendation_tpu_torch.models import get_model

    print(f"Using device: {device}")
    model_cls = get_model(config.model_name)
    emb = None
    if config.use_pretrained_emb or model_cls.needs_content:
        if os.path.exists(config.pretrained_emb_path):
            print(f"Loading pretrained item embeddings from {config.pretrained_emb_path}")
            emb = np.load(config.pretrained_emb_path)
        elif config.use_pretrained_emb:
            print(f"WARNING: --use_pretrained_emb was set, but file not found at "
                  f"{config.pretrained_emb_path}. Using random initialization.")
    bundle = load_preprocessed_data(
        config.data_dir, use_brand=config.use_brand, debug=config.debug
    )
    model = model_cls(
        bundle.num_users, bundle.num_items, bundle.num_brands, config,
        pretrained_item_emb=emb, device=device,
    )
    return bundle, model


def _restore_best_params(config, args, device):
    from gcn_recommendation_tpu_torch.utils.checkpoint import load_params

    ckpt_dir = args.model_path or os.path.join(config.checkpoint_dir, config.checkpoint_name())
    params = load_params(ckpt_dir, device=device)
    if params is None:
        raise FileNotFoundError(f"Model checkpoint not found at '{ckpt_dir}'")
    print(f"Model loaded from '{ckpt_dir}'")
    return params


def run_train(args) -> int:
    from gcn_recommendation_tpu_torch.core.device import resolve_device
    from gcn_recommendation_tpu_torch.train.trainer import Trainer
    from gcn_recommendation_tpu_torch.utils.logging import Logger

    config = _make_config(args)
    device = resolve_device(args.device)
    bundle, model = _load_everything(config, device)
    logger = Logger(config.results_dir, config.logger_name(), top_k=config.top_k)
    trainer = Trainer(config, model, bundle, logger=logger)
    print("\nStep 2: Starting model training...")
    if config.use_brand:
        print(f"Author Loss Config: brand_loss={config.brand_loss}, "
              f"weight={config.brand_loss_weight}")
    trainer.fit(resume=args.resume)
    print("Training finished.")
    return 0


def run_test(args) -> int:
    from gcn_recommendation_tpu_torch.core.device import resolve_device
    from gcn_recommendation_tpu_torch.data.loader import Interactions
    from gcn_recommendation_tpu_torch.ops.spmm import to_device_graph_auto
    from gcn_recommendation_tpu_torch.train.evaluate import evaluate

    config = _make_config(args)
    device = resolve_device(args.device)
    bundle, model = _load_everything(config, device)
    model.load_params(_restore_best_params(config, args, device))

    print("Evaluating on the TEST set...")
    # test-time filter = train + val (main.py:576)
    filt = Interactions(
        np.concatenate([bundle.train.user_idx, bundle.val.user_idx]),
        np.concatenate([bundle.train.item_idx, bundle.val.item_idx]),
    )
    graph = to_device_graph_auto(
        bundle.graph, compute_dtype=model.compute_dtype, device=device
    )
    recall, ndcg = evaluate(
        model, graph, bundle.test, filt, bundle.num_users, bundle.num_items,
        config.top_k, config.eval_user_batch,
    )
    print("\n--- Final Test Results ---")
    print(f"Recall@{config.top_k}: {recall:.4f}")
    print(f"NDCG@{config.top_k}:   {ndcg:.4f}")
    print("--------------------------")
    return 0


def run_recommend(args) -> int:
    from gcn_recommendation_tpu_torch.core.device import resolve_device
    from gcn_recommendation_tpu_torch.serve import Retriever

    config = _make_config(args)
    device = resolve_device(args.device)
    bundle, model = _load_everything(config, device)

    # validate cheap inputs before the restore and the propagation
    k = config.top_k if args.k is None else args.k
    if not 0 < k <= bundle.num_items:
        raise ValueError(f"--k must be in [1, {bundle.num_items}], got {k}")
    if args.users:
        users = np.array([int(u) for u in args.users.split(",")], np.int32)
        bad = users[(users < 0) | (users >= bundle.num_users)]
        if len(bad):
            raise ValueError(
                f"user ids out of range [0, {bundle.num_users}): {bad.tolist()}"
            )
    else:
        users = np.random.default_rng(config.seed).integers(
            0, bundle.num_users, args.num_sample
        ).astype(np.int32)

    params = _restore_best_params(config, args, device)
    retriever = Retriever.from_params(model, params, bundle, quantize=args.int8)
    scores, items = retriever.recommend(
        users, k=k, filter_seen=not args.include_seen
    )
    catalog = "int8" if args.int8 else "f32"
    print(f"Top-{k} recommendations ({catalog} catalog, "
          f"{'seen items included' if args.include_seen else 'seen items filtered'}):")
    for u, s_row, i_row in zip(users, scores, items):
        pairs = " ".join(f"{i}:{v:.3f}" for i, v in zip(i_row, s_row))
        print(f"user {u}: {pairs}")
    return 0


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    modes = {"train": run_train, "test": run_test, "recommend": run_recommend}
    return modes[args.mode](args)


if __name__ == "__main__":
    raise SystemExit(main())
