"""Command-line entry point of the port: ``prepare``, ``train``, ``test``,
``recommend`` and ``serve``.

Counterpart of ``gcn_recommendation_tpu/cli.py``'s modes of the same
names, with the same output lines:

    python -m gcn_recommendation_tpu_torch prepare --recipe synthetic \
        --num_users 400 --num_items 300 --output_dir DIR   (or a dataset
        recipe with --review_path / --meta_path, which needs pandas; no device)
    python -m gcn_recommendation_tpu_torch train --processed_dir DIR \
        [--model_name LightGCN_Fusion [--fusion_id_init]] \
        [--epochs 150] [--batch_size 2048] [--resume] \
        [--tile_spmm [--tile_min_fill 64] [--tile_dtype bfloat16]] [--device cpu]
    python -m gcn_recommendation_tpu_torch test --processed_dir DIR [--device cpu]
    python -m gcn_recommendation_tpu_torch recommend --processed_dir DIR \
        --model_path CKPT_DIR [--users 3,7] [--k 20] [--int8] \
        [--include_seen] [--device cpu]
    python -m gcn_recommendation_tpu_torch serve --processed_dir DIR \
        [--model_path CKPT_DIR] [--int8] [--host 127.0.0.1] [--port 8000] \
        [--max_coalesce 16] [--max_request_users 8192] [--warm_batch 0] \
        [--device cpu]      (the HTTP daemon of server.py)

``--profile_dir DIR`` (every mode but ``prepare``) writes one
``torch.profiler`` Chrome trace per training epoch under DIR; it is the
same as setting ``GCN_TPU_TRACE_DIR``.  ``--debug_nans`` runs each
training step under ``torch.autograd.detect_anomaly`` and stops at the
first non-finite loss with its epoch and step.

``--mesh DATA,MODEL [--schedule auto|gspmd|halo]`` (every mode but
``prepare``) runs one process per device over a ('data', 'model') mesh
(``core/mesh.py``, ``parallel/``): tables, Adam moments, ELL rows and the
item catalog row-sharded over ``model``, batches and evaluation users
split over ``data``.  Start it with one process per device:

    torchrun --nproc_per_node 2 -m gcn_recommendation_tpu_torch train \
        --processed_dir DIR --mesh 1,2 [--device cpu]

(``--device cpu``: gloo on the CPU; else NCCL, one card per rank).
``--mesh 1,1`` needs no launcher.  ``--schedule auto`` takes ``halo``
when the model axis is above 1, else ``gspmd``, as the JAX package does.
Only rank 0 prints results and writes files; ``serve`` answers HTTP on
rank 0, and the other ranks follow its dispatches.

Runs on ``cuda`` unless ``--device cpu`` is given.  Checkpoints are the
port's own (``utils/checkpoint.py``): ``train`` writes ``best.pt`` and
``last.pt`` under ``<checkpoint_dir>/<checkpoint_name>``, which ``test``
and ``recommend`` read.  Params of the JAX package, as numpy arrays, are
carried across with ``models/convert.py`` and saved with ``save_params``.
``LightGCN_Fusion`` reads its content matrix from the dataset's
``item_embeddings.npy`` in every mode and fails without it.  The parquet
files are read and written by ``data/parquet.py`` (no pandas): only the
dataset recipes of ``prepare`` that parse raw JSONL dumps need pandas.
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
        sp.add_argument("--profile_dir", type=str, default=None,
                        help="Write torch.profiler traces (one per epoch) under "
                             "this dir; equivalent to setting GCN_TPU_TRACE_DIR.")
        sp.add_argument("--device", type=str, default=None,
                        help="'cuda' (default) or 'cpu'.")
        sp.add_argument("--debug_nans", action="store_true",
                        help="Autograd anomaly mode around each training step; "
                             "stop at the first non-finite loss.")
        sp.add_argument("--tile_spmm", action="store_true",
                        help="Propagate the dense row-block mass through block-"
                             "sparse 128x128 tiles (csrc/tile_spmm.cu on the "
                             "card; single-device only).")
        sp.add_argument("--tile_min_fill", type=int, default=64,
                        help="Edges a 128x128 tile needs to qualify.")
        sp.add_argument("--tile_dtype", type=str, default="float32",
                        choices=["float32", "bfloat16"])
        sp.add_argument("--mesh", type=str, default=None,
                        help="DATA,MODEL device-mesh shape for sharded execution, "
                             "one process per device (e.g. '1,2': tables and "
                             "catalog row-sharded 2 ways). Default: one device.")
        sp.add_argument("--schedule", type=str, default="auto",
                        choices=["auto", "gspmd", "halo"],
                        help="Sharded propagation schedule: 'halo' (per-layer "
                             "all-gather of the node block, local rows only — "
                             "parallel/halo.py) or 'gspmd' (bucket rows sharded, "
                             "bucket outputs all-gathered — parallel/spmd.py). "
                             "'auto' picks halo whenever the model axis is "
                             "sharded, gspmd for pure data parallelism.")

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

    sv = sub.add_parser("serve",
                        help="Run the HTTP serving daemon (server.py): "
                             "micro-batched top-k over a trained checkpoint.")
    add_common(sv)
    sv.add_argument("--model_path", type=str, default=None,
                    help="Checkpoint dir (default: the train-mode location).")
    sv.add_argument("--int8", action="store_true",
                    help="Serve from the int8-quantized item catalog.")
    sv.add_argument("--host", type=str, default="127.0.0.1")
    sv.add_argument("--port", type=int, default=8000,
                    help="TCP port (0 = pick a free one and print it).")
    sv.add_argument("--max_coalesce", type=int, default=16,
                    help="Max queued requests coalesced into one device dispatch.")
    sv.add_argument("--max_request_users", type=int, default=8192,
                    help="Reject /recommend requests with more users than "
                         "this (400) — protects the single dispatcher "
                         "thread from one oversized device batch.")
    sv.add_argument("--warm_batch", type=int, default=0,
                    help="Dispatch the coalesce ladder at startup with dummy "
                         "requests of this many users (0 = off), so that the "
                         "first real request of a shape does not pay for "
                         "handles, workspaces and buffers; set this to your "
                         "typical request size in production.")

    pr = sub.add_parser("prepare", help="Offline data preparation (ETL).")
    pr.add_argument("--recipe", type=str, required=True,
                    help="One of: amazon_books, amazon_books_emb, "
                         "amazon_books_senti, amazon_sport_emb, steam_emb, synthetic. "
                         "The dataset recipes parse raw JSONL dumps and need pandas "
                         "(host-only ETL); synthetic needs none.")
    pr.add_argument("--core", type=int, default=None, help="K-core threshold.")
    pr.add_argument("--review_path", type=str, default=None)
    pr.add_argument("--meta_path", type=str, default=None)
    pr.add_argument("--output_dir", type=str, default=None)
    # synthetic-recipe knobs
    pr.add_argument("--num_users", type=int, default=10000)
    pr.add_argument("--num_items", type=int, default=5000)
    pr.add_argument("--num_brands", type=int, default=200)
    pr.add_argument("--mean_degree", type=float, default=25.0)
    pr.add_argument("--embedding_dim", type=int, default=None)
    pr.add_argument("--style", type=str, default="popularity",
                    choices=["popularity", "latent"],
                    help="Synthetic data flavor (latent = learnable structure).")
    # latent-style regime knobs (see data/synthetic.py: temperature/dim set
    # how predictable taste is; emb_noise derives informative content
    # embeddings from the item factors; brand_style=latent clusters brands
    # in taste space)
    pr.add_argument("--latent_dim", type=int, default=16)
    pr.add_argument("--temperature", type=float, default=0.35)
    pr.add_argument("--pop_scale", type=float, default=0.5,
                    help="Popularity-bias scale (latent style) — high values "
                         "concentrate taste on globally popular items "
                         "(the dense steam-like regime).")
    pr.add_argument("--emb_noise", type=float, default=None,
                    help="If set (latent style), item_embeddings.npy is a "
                         "noisy projection of the true item factors instead "
                         "of pure noise.")
    pr.add_argument("--brand_style", type=str, default="random",
                    choices=["random", "latent"])
    # curve-shape knobs (they reproduce the reference's rating-rank
    # split and late-climb training curves — data/synthetic.py)
    pr.add_argument("--split", type=str, default="random",
                    choices=["random", "rank"],
                    help="Leave-one-out mode: 'rank' holds out each user's "
                         "highest realized-preference item (the reference "
                         "recipes' rating-rank protocol).")
    pr.add_argument("--pop_df", type=float, default=None,
                    help="Student-t df for heavy-tailed popularity logits.")
    pr.add_argument("--pop_zipf", type=float, default=None,
                    help="Exact-Zipf popularity exponent (overrides "
                         "pop_df/pop_scale's distribution).")
    pr.add_argument("--deg_sigma", type=float, default=0.5,
                    help="Lognormal sigma of per-user degrees.")
    pr.add_argument("--spectrum", type=float, default=0.0,
                    help="Power-law decay of taste-factor variances.")
    pr.add_argument("--rank_key", type=str, default="full",
                    choices=["full", "taste"],
                    help="Rank-split ordering key: 'taste' ranks by the "
                         "taste score alone (rating-rank analogue; "
                         "popularity excluded), 'full' by the sampling "
                         "key.")
    pr.add_argument("--taste_style", type=str, default="gaussian",
                    choices=["gaussian", "cluster"],
                    help="Factor-loading distribution: 'cluster' gives "
                         "community-structured interactions (latent_dim = "
                         "community count) - the real-co-purchase curve-"
                         "shape mechanism, see REGIMES.md.")
    pr.add_argument("--clusters_per_user", type=int, default=3)
    pr.add_argument("--emb_style", type=str, default="informative",
                    choices=["informative", "mislead"],
                    help="'mislead' writes content embeddings that "
                         "conflict with taste (permuted factors).")
    pr.add_argument("--seed", type=int, default=42)
    return p


def _make_config(args):
    from gcn_recommendation_tpu_torch.config import Config

    if args.profile_dir:
        # utils/profiling.trace picks this up around every training epoch: a
        # Chrome trace of each, with the port's spans as ranges
        os.environ["GCN_TPU_TRACE_DIR"] = args.profile_dir
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
        debug_nans=args.debug_nans,
        tile_spmm=args.tile_spmm,
        tile_min_fill=args.tile_min_fill,
        tile_dtype=args.tile_dtype,
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


def _build_mesh(args):
    """This rank's ('data', 'model') mesh from ``--mesh``, or None for one
    device.  Joins the run's process group first (``torchrun``'s, or a
    world of one for ``1,1``)."""
    mesh_arg = getattr(args, "mesh", None)
    if not mesh_arg:
        return None
    from gcn_recommendation_tpu_torch.core.distributed import get_world_size, initialize
    from gcn_recommendation_tpu_torch.core.mesh import MeshSpec, create_mesh

    try:
        data, model_par = (int(x) for x in mesh_arg.split(","))
    except ValueError:
        raise ValueError(f"--mesh must be 'DATA,MODEL', got {mesh_arg!r}") from None
    if args.tile_spmm and args.mode in ("train", "test"):
        # the tile partition is single-device only (the JAX package's flag says so)
        raise ValueError("--tile_spmm is single-device only: drop it or --mesh")
    spec = MeshSpec(data=data, model=model_par)
    initialize(args.device, mesh_spec=spec)
    n = get_world_size()
    if data * model_par != n:
        raise ValueError(f"--mesh {data}x{model_par} needs {data * model_par} devices, have {n}")
    return create_mesh(spec)


def _pick_schedule(args, mesh):
    """``--schedule``; ``auto`` is ``halo`` when the model axis is
    sharded, else ``gspmd`` (pure data parallelism has no halo)."""
    from gcn_recommendation_tpu_torch.core.mesh import MODEL_AXIS

    schedule = getattr(args, "schedule", "auto") or "auto"
    if schedule == "auto":
        schedule = "halo" if mesh.shape[MODEL_AXIS] > 1 else "gspmd"
    return schedule


def _make_trainer(config, model, bundle, logger, args, mesh=None):
    """Single-device Trainer, or the schedule's sharded trainer on ``mesh``."""
    from gcn_recommendation_tpu_torch.train.trainer import Trainer

    if mesh is None:
        return Trainer(config, model, bundle, logger=logger)
    schedule = _pick_schedule(args, mesh)
    if _is_rank0():
        print(f"Sharded execution: mesh {mesh.shape}, schedule={schedule}")
    if schedule == "halo":
        from gcn_recommendation_tpu_torch.parallel.halo import HaloTrainer

        return HaloTrainer(config, model, bundle, mesh, logger=logger)
    from gcn_recommendation_tpu_torch.parallel.spmd import ShardedTrainer

    return ShardedTrainer(config, model, bundle, mesh, logger=logger)


def _is_rank0() -> bool:
    from gcn_recommendation_tpu_torch.core.distributed import get_rank

    return get_rank() == 0


def _device_and_mesh(args):
    """(the rank's device, its mesh or None)."""
    from gcn_recommendation_tpu_torch.core.device import resolve_device

    mesh = _build_mesh(args)
    return (mesh.device if mesh is not None else resolve_device(args.device)), mesh


def run_train(args) -> int:
    from gcn_recommendation_tpu_torch.utils.logging import Logger

    config = _make_config(args)
    device, mesh = _device_and_mesh(args)
    bundle, model = _load_everything(config, device)
    logger = (Logger(config.results_dir, config.logger_name(), top_k=config.top_k)
              if _is_rank0() else None)
    trainer = _make_trainer(config, model, bundle, logger, args, mesh)
    if _is_rank0():
        print("\nStep 2: Starting model training...")
        if config.use_brand:
            print(f"Author Loss Config: brand_loss={config.brand_loss}, "
                  f"weight={config.brand_loss_weight}")
    trainer.fit(resume=args.resume)
    if _is_rank0():
        print("Training finished.")
    return 0


def run_test_loaded(config, args, bundle, model, device, mesh=None):
    """The ``test`` mode over loaded data: restore the best checkpoint and
    evaluate on the test split (train + val filtered), through the
    schedule's sharded forward on ``mesh``; prints on rank 0.  Returns
    (recall, ndcg)."""
    from gcn_recommendation_tpu_torch.data.loader import Interactions
    from gcn_recommendation_tpu_torch.ops.spmm import to_device_graph_auto
    from gcn_recommendation_tpu_torch.train.evaluate import evaluate

    params = _restore_best_params(config, args, device)
    model.load_params(params)
    if _is_rank0():
        print("Evaluating on the TEST set...")
    # test-time filter = train + val (main.py:576)
    filt = Interactions(
        np.concatenate([bundle.train.user_idx, bundle.val.user_idx]),
        np.concatenate([bundle.train.item_idx, bundle.val.item_idx]),
    )
    if mesh is not None:
        # the schedule's sharded forward, then items row-sharded over
        # 'model' and the test users split over 'data'
        from gcn_recommendation_tpu_torch.parallel.spmd import evaluate_sharded

        trainer = _make_trainer(config, model, bundle, None, args, mesh)
        fu, fi, *_ = trainer._forward_eval()
        recall, ndcg = evaluate_sharded(
            mesh, fu, fi, bundle.test, filt, bundle.num_users, bundle.num_items,
            config.top_k, config.eval_user_batch,
        )
    else:
        # the JAX package's arguments: fused (its default) below the knee
        graph = to_device_graph_auto(
            bundle.graph, compute_dtype=model.compute_dtype,
            embedding_dim=config.embedding_dim, device=device,
        )
        recall, ndcg = evaluate(
            model, graph, bundle.test, filt, bundle.num_users, bundle.num_items,
            config.top_k, config.eval_user_batch,
        )
    if _is_rank0():
        print("\n--- Final Test Results ---")
        print(f"Recall@{config.top_k}: {recall:.4f}")
        print(f"NDCG@{config.top_k}:   {ndcg:.4f}")
        print("--------------------------")
    return recall, ndcg


def run_test(args) -> int:
    config = _make_config(args)
    device, mesh = _device_and_mesh(args)
    bundle, model = _load_everything(config, device)
    run_test_loaded(config, args, bundle, model, device, mesh)
    return 0


def recommend_loaded(config, args, bundle, model, device, mesh=None):
    """The ``recommend`` mode over loaded data: restore the best
    checkpoint, build the ``Retriever`` (sharded on ``mesh``), answer the
    users, print on rank 0.  Returns (users, scores, items)."""
    from gcn_recommendation_tpu_torch.serve import Retriever

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
    retriever = Retriever.from_params(model, params, bundle, quantize=args.int8, mesh=mesh)
    scores, items = retriever.recommend(
        users, k=k, filter_seen=not args.include_seen
    )
    if _is_rank0():
        catalog = "int8" if args.int8 else "f32"
        print(f"Top-{k} recommendations ({catalog} catalog, "
              f"{'seen items included' if args.include_seen else 'seen items filtered'}):")
        for u, s_row, i_row in zip(users, scores, items):
            pairs = " ".join(f"{i}:{v:.3f}" for i, v in zip(i_row, s_row))
            print(f"user {u}: {pairs}")
    return users, scores, items


def run_recommend(args) -> int:
    config = _make_config(args)
    device, mesh = _device_and_mesh(args)
    bundle, model = _load_everything(config, device)
    recommend_loaded(config, args, bundle, model, device, mesh)
    return 0


def _retriever_builder(config, args, bundle, model, device, mesh):
    def build_retriever():
        """Also the /reload target.  It runs on the server's dispatcher
        thread, which has its own grad mode and current device: the
        checkpoint is mapped to the serving device here, and
        ``Retriever.from_params`` brings its own ``no_grad``."""
        from gcn_recommendation_tpu_torch.serve import Retriever

        params = _restore_best_params(config, args, device)
        return Retriever.from_params(model, params, bundle, quantize=args.int8, mesh=mesh)

    return build_retriever


def make_server(config, args, bundle, model, device, mesh=None):
    """The daemon over loaded data: restore the best checkpoint, build the
    ``Retriever`` (``args.int8``: the int8 catalog; ``mesh``: sharded, with
    this rank as the leader the other ranks follow), answer one request so
    that the first real one finds the device set up, and return the
    ``RecommendServer`` (not yet serving), whose ``POST /reload`` reads
    the checkpoint from disk again and rebuilds the retriever."""
    from gcn_recommendation_tpu_torch.server import MeshLeader, RecommendServer

    build_retriever = _retriever_builder(config, args, bundle, model, device, mesh)
    retriever = build_retriever()
    retriever.recommend(np.zeros(1, np.int32), k=config.top_k)
    reload_fn, on_stop = build_retriever, None
    if mesh is not None:
        retriever = MeshLeader(retriever)
        reload_fn = lambda: retriever.reload(build_retriever)  # noqa: E731
        on_stop = retriever.stop
    return RecommendServer(
        retriever, bundle.num_users, host=args.host, port=args.port,
        max_coalesce=args.max_coalesce,
        max_request_users=args.max_request_users,
        reload_fn=reload_fn,
        warm=(args.warm_batch, config.top_k) if args.warm_batch else None,
        on_stop=on_stop,
    )


def follow_server(config, args, bundle, model, device, mesh) -> int:
    """A rank other than 0 of ``serve --mesh``: build the same retriever,
    answer the same first request, then make every call rank 0 announces
    until it shuts down.  An error ends the process (nonzero exit)."""
    from gcn_recommendation_tpu_torch.server import follow

    build_retriever = _retriever_builder(config, args, bundle, model, device, mesh)
    retriever = build_retriever()
    retriever.recommend(np.zeros(1, np.int32), k=config.top_k)
    follow(retriever, build_retriever)
    return 0


def run_serve(args) -> int:
    """Serving daemon entry: checkpoint -> Retriever -> HTTP loop (rank 0;
    the other ranks of a mesh follow it)."""
    config = _make_config(args)
    device, mesh = _device_and_mesh(args)
    bundle, model = _load_everything(config, device)
    if not _is_rank0():
        return follow_server(config, args, bundle, model, device, mesh)
    server = make_server(config, args, bundle, model, device, mesh)
    print(f"serving on http://{args.host}:{server.port} "
          f"({'int8' if args.int8 else 'f32'} catalog, "
          f"max_coalesce={args.max_coalesce})", flush=True)
    try:
        server.serve_forever()
    except KeyboardInterrupt:
        pass
    return 0


def run_prepare(args) -> int:
    from gcn_recommendation_tpu_torch.data import prepare

    return prepare.run_recipe(args)


def main(argv=None) -> int:
    import torch.distributed as dist

    from gcn_recommendation_tpu_torch.core import distributed

    args = build_parser().parse_args(argv)
    modes = {"train": run_train, "test": run_test, "recommend": run_recommend,
             "serve": run_serve, "prepare": run_prepare}
    joined_here = not dist.is_initialized()
    try:
        return modes[args.mode](args)
    finally:
        if joined_here:  # a mesh run leaves the process group it joined
            distributed.shutdown()


if __name__ == "__main__":
    raise SystemExit(main())
