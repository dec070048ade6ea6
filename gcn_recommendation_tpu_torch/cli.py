"""Command-line entry point of the port: the ``recommend`` mode.

Counterpart of ``gcn_recommendation_tpu/cli.py::run_recommend``: load a
processed dataset and a checkpoint, propagate once, print masked top-k
per user in the same ``user u: item:score ...`` lines.

    python -m gcn_recommendation_tpu_torch recommend --processed_dir DIR \
        --model_path CKPT_DIR [--users 3,7] [--k 20] [--int8] \
        [--include_seen] [--device cpu]

Runs on ``cuda`` unless ``--device cpu`` is given.  Checkpoints are the
port's own (``utils/checkpoint.py``); params of the JAX package, as
numpy arrays, are carried across with ``models/convert.py`` and saved
with ``save_params``.
"""

from __future__ import annotations

import argparse
import os

import numpy as np


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        description="Serve LightGCN recommendations (PyTorch/CUDA port)."
    )
    sub = p.add_subparsers(dest="mode", required=True)
    rc = sub.add_parser(
        "recommend", help="Serve top-k recommendations from a trained checkpoint."
    )
    rc.add_argument("--model_name", type=str, default="LightGCN")
    rc.add_argument("--core", type=int, default=16)
    rc.add_argument("--dataset", type=str, default="steam_emb",
                    help="Dataset recipe name (see config.DATASET_DIR_TEMPLATES).")
    rc.add_argument("--data_root", type=str, default=".")
    rc.add_argument("--processed_dir", type=str, default=None,
                    help="Explicit processed-data dir (overrides --dataset).")
    rc.add_argument("--no_brand", action="store_true")
    rc.add_argument("--debug", action="store_true")
    rc.add_argument("--use_pretrained_emb", action="store_true",
                    help="Selects the default checkpoint name of such a run.")
    rc.add_argument("--seed", type=int, default=42)
    rc.add_argument("--output_root", type=str, default=None,
                    help="Root of exp/ outputs holding the default checkpoint dir.")
    rc.add_argument("--compute_dtype", type=str, default="float32",
                    choices=["float32", "bfloat16"])
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
    rc.add_argument("--device", type=str, default=None,
                    help="'cuda' (default) or 'cpu'.")
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
    return Config(**kwargs)


def run_recommend(args) -> int:
    from gcn_recommendation_tpu_torch.core.device import resolve_device
    from gcn_recommendation_tpu_torch.data.loader import load_preprocessed_data
    from gcn_recommendation_tpu_torch.models import get_model
    from gcn_recommendation_tpu_torch.serve import Retriever
    from gcn_recommendation_tpu_torch.utils.checkpoint import load_params

    config = _make_config(args)
    device = resolve_device(args.device)
    print(f"Using device: {device}")
    bundle = load_preprocessed_data(
        config.data_dir, use_brand=config.use_brand, debug=config.debug
    )
    # the checkpoint overwrites every table, so no pretrained init is read
    model = get_model(config.model_name)(
        bundle.num_users, bundle.num_items, bundle.num_brands, config, device=device
    )

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

    ckpt_dir = args.model_path or os.path.join(
        config.checkpoint_dir, config.checkpoint_name()
    )
    params = load_params(ckpt_dir, device=device)
    if params is None:
        raise FileNotFoundError(f"Model checkpoint not found at '{ckpt_dir}'")
    print(f"Model loaded from '{ckpt_dir}'")

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
    if args.mode == "recommend":
        return run_recommend(args)
    raise ValueError(args.mode)


if __name__ == "__main__":
    raise SystemExit(main())
