"""Training loop: BPR + Adam over full-graph forwards, validation, checkpoints.

PyTorch counterpart of ``gcn_recommendation_tpu/train/trainer.py``
(reference train(), main.py:443-554):

* one full-graph propagation per batch (the gradient reaches every node
  through the propagation);
* BPR + L2 (+ optional brand) loss on the batch rows (``train/loss.py``);
* ``torch.optim.Adam(lr, betas=(0.9, 0.999), eps=1e-8)``, no weight
  decay: optax's ``adam`` is the same update, and L2 lives in the loss.
  The tables are dense ``nn.Parameter``s, so every row's moments update
  every step, as under optax;
* negatives pre-sampled for the whole epoch up to
  ``epoch_presample_max_examples``, in-step above it (same distribution);
* debug mode caps an epoch at 10 batches and, for the plain ``LightGCN``,
  runs the reference's self-checks (``models.lightgcn.debug_diagnostics``);
* the optimizer holds the model's trainable parameters only (the content
  buffer of ``LightGCN_Fusion`` is not one);
* a row-padded model (``set_row_multiple``) trains over the padded node
  space (``model.padded_graph``), on the ELL path and under ``tile_spmm``;
  checkpoints store logical shapes whatever the row multiple;
* validation every ``val_interval`` epochs, a ``best`` checkpoint on a
  new best recall and a rolling ``last`` one; ``fit(resume=True)``
  continues from ``last``.

A Python loop over steps takes the place of the JAX package's
``lax.scan``; the step losses stay on the device until the epoch ends.
``Config.debug_nans`` runs each step under ``torch.autograd.detect_anomaly``
and stops at the first non-finite loss, naming its epoch and step.

The sharded trainers of ``parallel/`` override the hooks: where the
state lives (``_load_model_params``, ``_import_tree``, ``_export_tree``,
``params``), the graph (``_device_graph``), the forward (``_forward``),
the batch (``batch_loss``), the gradient and loss reductions, and
validation.
The ELL graph carries the merge-skip views, so a step propagates through
one ``DeviceGraph.layer_sum`` forward and one backward; above the gather
knee the graph is source-chunked (``ops/spmm.py::to_device_graph_auto``).
A subclass that wants another layout (a per-layer twin, a forced chunk
count) overrides ``_device_graph``.
With ``Config.tile_spmm`` the propagation runs over the block-sparse tile
partition (``ops/block_spmm.py``, the ``csrc/tile_spmm.cu`` kernel three
times forward and three times backward per step at 3 layers).

Spans (``utils/profiling.py``): ``train.step`` around a step, inside it
``train.forward``, ``train.loss`` (the batch's gathers and BPR),
``train.backward`` and ``train.adam``; ``eval.validate`` around a
validation.  ``fit`` wraps each epoch in ``trace``, which writes a Chrome
trace of it, spans included, when ``GCN_TPU_TRACE_DIR`` is set.
"""

from __future__ import annotations

import os
import time
from typing import Optional

import numpy as np
import torch

from gcn_recommendation_tpu_torch.data.loader import DataBundle
from gcn_recommendation_tpu_torch.data.sampler import (
    epoch_batches,
    membership_arrays,
    positive_keys,
    sample_negatives,
)
from gcn_recommendation_tpu_torch.models.lightgcn import debug_diagnostics
from gcn_recommendation_tpu_torch.ops.spmm import (
    ChunkedDeviceGraph,
    num_chunks_for,
    to_device_graph,
    to_device_graph_auto,
)
from gcn_recommendation_tpu_torch.train.evaluate import build_eval_batches, evaluate_batches
from gcn_recommendation_tpu_torch.train.loss import bpr_loss_reg
from gcn_recommendation_tpu_torch.utils import checkpoint as ckpt
from gcn_recommendation_tpu_torch.utils.logging import Logger
from gcn_recommendation_tpu_torch.utils.profiling import span, trace


class Trainer:
    # Above this many examples per epoch, negatives are drawn in-step so
    # the sampler's memory stays [batch]-sized (the JAX package's rule).
    epoch_presample_max_examples = 4_000_000

    def __init__(self, config, model, bundle: DataBundle, logger: Optional[Logger] = None):
        """Training state lives on ``model.device``; the model's tables
        are trained in place."""
        self.config = config
        self.model = model
        self.bundle = bundle
        self.logger = logger
        self.device = model.device

        def dev(a):
            return torch.from_numpy(np.asarray(a, dtype=np.int64)).to(self.device)

        user_ptr, flat_items = membership_arrays(
            bundle.train.user_idx, bundle.train.item_idx, bundle.num_users
        )
        self.pos_keys = dev(positive_keys(user_ptr, flat_items, bundle.num_items))
        self.train_users = dev(bundle.train.user_idx)
        self.train_items = dev(bundle.train.item_idx)
        self.item_to_brand = dev(bundle.item_to_brand)
        self.graph = self._device_graph()

        self.optimizer = self._make_optimizer()
        self.generator = torch.Generator(device=self.device).manual_seed(config.seed + 1)
        self.n_train = len(bundle.train)
        steps = max(1, -(-self.n_train // config.batch_size))
        self.steps_per_epoch = min(10, steps) if config.debug else steps
        self._eval_batches = None  # built at the first validation, then reused
        self._epoch = 0  # the epoch being run, for the --debug_nans message
        self._print = print  # progress lines (a sharded run prints on rank 0 only)

    def _device_graph(self):
        """The device graph, in the JAX package's order: the source-chunked
        layout above the gather knee; else the tile partition's
        TiledDeviceGraph when ``config.tile_spmm`` is set and some tile
        qualifies (its residual unfused); else the ELL graph with the
        merge-skip views.  ``to_device_graph_auto`` applies the knee rule."""
        g = self.model.padded_graph(self.bundle.graph)
        cdtype = getattr(torch, self.config.compute_dtype)
        dim = self.config.embedding_dim
        if self.config.tile_spmm and num_chunks_for(g.num_nodes, dim, cdtype) == 1:
            from gcn_recommendation_tpu_torch.graph.tiles import partition_tiles
            from gcn_recommendation_tpu_torch.ops.block_spmm import (
                TiledDeviceGraph,
                to_device_tiles,
            )

            part = partition_tiles(g, min_fill=int(self.config.tile_min_fill))
            if part is not None:
                tiles = to_device_tiles(
                    part, tile_dtype=getattr(torch, self.config.tile_dtype), device=self.device)
                print(
                    f"Graph: CUDA tile partition — {part.num_tiles} tiles "
                    f"cover {part.covered_edges:,}/{g.nnz:,} edges "
                    f"({part.covered_edges / max(g.nnz, 1) * 100:.1f}%), "
                    f"{part.n_row_blocks} row blocks, {tiles.layout} layout (see PERF.md)"
                )
                return TiledDeviceGraph(
                    base=to_device_graph(part.residual, compute_dtype=cdtype,
                                         device=self.device, fuse_layers=False),
                    tiles=tiles,
                )
            print("Graph: tile partition empty at min_fill="
                  f"{self.config.tile_min_fill}; using the ELL path")
        graph = to_device_graph_auto(g, compute_dtype=cdtype, embedding_dim=dim,
                                     device=self.device)
        if isinstance(graph, ChunkedDeviceGraph):
            print(f"Graph: source-chunked gathers ({graph.num_chunks} chunks — "
                  f"embedding block above the gather knee, see PERF.md)")
        return graph

    def _make_optimizer(self) -> torch.optim.Adam:
        return torch.optim.Adam(
            [getattr(self.model, k) for k in self.model.trainable_keys],
            lr=self.config.learning_rate,
            betas=(0.9, 0.999), eps=1e-8, weight_decay=0.0,
        )

    def sample_negatives(self, users: torch.Tensor) -> torch.Tensor:
        return sample_negatives(
            self.generator, users, self.pos_keys, num_items=self.bundle.num_items
        )

    def _forward(self):
        """(final_user, final_item, final_brand, user0, item0) of the
        model's current tables, differentiable."""
        return self.model(self.graph)

    def batch_loss(self, users, pos, neg, brand_denom=None) -> torch.Tensor:
        """The loss of one batch after a full forward (differentiable)."""
        cfg = self.config
        with span("train.forward"):
            fu_all, fi_all, fb_all, u0_all, i0_all = self._forward()
        with span("train.loss"):
            fu = fu_all.index_select(0, users)
            fp = fi_all.index_select(0, pos)
            fn = fi_all.index_select(0, neg)
            iu = u0_all.index_select(0, users)
            ip = i0_all.index_select(0, pos)
            in_ = i0_all.index_select(0, neg)
            if cfg.brand_loss and cfg.use_brand:
                return bpr_loss_reg(
                    fu, fp, fn, iu, ip, in_, cfg.weight_decay,
                    brand_loss=True, final_brand_emb=fb_all,
                    pos_item_brand_idx=self.item_to_brand.index_select(0, pos),
                    neg_item_brand_idx=self.item_to_brand.index_select(0, neg),
                    brand_loss_weight=cfg.brand_loss_weight, brand_denom=brand_denom,
                )
            return bpr_loss_reg(fu, fp, fn, iu, ip, in_, cfg.weight_decay)

    def _reduce_gradients(self) -> None:
        """Combine the gradients of the ranks that share the step (none
        on one device)."""

    def _reduce_loss(self, loss: torch.Tensor) -> torch.Tensor:
        """The whole batch's loss from this rank's share (itself here)."""
        return loss

    def train_step(self, users, pos, neg, step: int = 0) -> torch.Tensor:
        """One Adam step on one batch (int64 index tensors on the device);
        returns the batch loss as a device scalar.  ``step`` names the step
        in the ``debug_nans`` message."""
        with span("train.step"):
            self.optimizer.zero_grad(set_to_none=True)
            if self.config.debug_nans:
                with torch.autograd.detect_anomaly():
                    loss = self.batch_loss(users, pos, neg)
                    if not torch.isfinite(loss).item():
                        raise FloatingPointError(
                            f"debug_nans: loss {loss.item()} at epoch {self._epoch} step {step}")
                    with span("train.backward"):
                        loss.backward()
            else:
                loss = self.batch_loss(users, pos, neg)
                with span("train.backward"):
                    loss.backward()
            self._reduce_gradients()
            with span("train.adam"):
                self.optimizer.step()
            return self._reduce_loss(loss.detach())

    def run_epoch(self) -> np.ndarray:
        """One shuffled epoch; returns the per-step losses."""
        cfg = self.config
        n_steps = self.steps_per_epoch
        batches = epoch_batches(self.generator, self.n_train, cfg.batch_size, self.device)
        batches = batches[:n_steps]
        users = self.train_users[batches]
        pos = self.train_items[batches]
        presample = n_steps * cfg.batch_size <= self.epoch_presample_max_examples
        neg = self.sample_negatives(users) if presample else None
        losses = []
        for s in range(n_steps):
            n = neg[s] if presample else self.sample_negatives(users[s])
            losses.append(self.train_step(users[s], pos[s], n, step=s))
        return torch.stack(losses).cpu().numpy()

    # --- where the state lives ---
    def _draw_params(self):
        """Fresh logical params (Xavier uniform from ``config.seed``)."""
        return self.model._draw_params(torch.Generator().manual_seed(self.config.seed))

    def _load_model_params(self, params) -> None:
        """Put a params dict (logical or padded shapes) into the model."""
        self.model.load_params(params)

    def _import_tree(self, tree):
        """A logical tree (params, or Adam moments keyed like them) in the
        layout this trainer stores."""
        return self.model.pad_state_tree(tree)

    def _export_tree(self, tree):
        """The logical tree of a stored one (checkpoints are logical)."""
        return self.model.unpad_state_tree(tree)

    def params(self):
        """The model's whole params, padded rows included."""
        return self.model.params()

    def init_state(self) -> None:
        """Fresh tables (Xavier uniform from ``config.seed``), fresh Adam
        moments and a reseeded sampling generator."""
        self._load_model_params(self._draw_params())
        self.optimizer = self._make_optimizer()
        self.generator.manual_seed(self.config.seed + 1)

    @torch.no_grad()
    def _forward_eval(self):
        return self._forward()

    @torch.no_grad()
    def validate(self):
        """(Recall@k, NDCG@k) on the val split, train items filtered."""
        with span("eval.validate"):
            fu, fi, *_ = self._forward_eval()
            if self._eval_batches is None:
                b = self.bundle
                self._eval_batches = build_eval_batches(
                    b.val, b.train, b.num_users, b.num_items,
                    self.config.eval_user_batch, device=self.device,
                )
            return evaluate_batches(fu, fi, self._eval_batches, self.config.top_k)

    def _map_optimizer_tables(self, state_dict, fn):
        """``fn`` (the model's ``pad_state_tree`` or ``unpad_state_tree``)
        over the Adam moments of ``state_dict``, whose entries follow the
        order of ``model.trainable_keys``."""
        keys = self.model.trainable_keys
        state = {
            i: {name: fn({keys[i]: v})[keys[i]] for name, v in entry.items()}
            for i, entry in state_dict["state"].items()
        }
        return {"state": state, "param_groups": state_dict["param_groups"]}

    def save_checkpoint(self, ckpt_dir: str, tag: str, epoch: int, best_recall: float) -> None:
        """Write a checkpoint at logical shapes (pad rows sliced off)."""
        ckpt.save_state(
            ckpt_dir, tag, self._export_tree(self.model.params()),
            self._map_optimizer_tables(self.optimizer.state_dict(), self._export_tree),
            epoch, best_recall, self.generator.get_state(),
        )

    def fit(self, resume: bool = False):
        """Train ``config.epochs`` epochs from fresh tables, or from the
        ``last`` checkpoint with ``resume``.  Returns (params, best recall)."""
        cfg = self.config
        self.init_state()
        start_epoch, best_recall = 1, 0.0
        if cfg.debug and self.model.has_debug_diagnostics:
            # the reference's debug-mode self-checks (models/lightgcn.py:49-78)
            debug_diagnostics(self.model, self.params(), self.bundle.graph)
        ckpt_dir = os.path.join(cfg.checkpoint_dir, cfg.checkpoint_name())
        if resume:
            state = ckpt.load_state(ckpt_dir, "last")
            if state is not None:
                self._load_model_params(state["params"])
                self.optimizer.load_state_dict(
                    self._map_optimizer_tables(state["optimizer"], self._import_tree)
                )
                self.generator.set_state(state["generator"])
                start_epoch = state["epoch"] + 1
                best_recall = state["best_recall"]
                if self.logger is not None:
                    self.logger.set_start_step(self.steps_per_epoch * (start_epoch - 1))
                self._print(f"Resumed from epoch {start_epoch - 1} "
                      f"(best recall {best_recall:.4f})")

        examples_per_epoch = self.steps_per_epoch * cfg.batch_size
        for epoch in range(start_epoch, cfg.epochs + 1):
            self._epoch = epoch
            t0 = time.perf_counter()
            with trace(f"epoch_{epoch}"):  # a no-op unless GCN_TPU_TRACE_DIR is set
                losses = self.run_epoch()  # ends in a copy to the host
            dt = time.perf_counter() - t0
            avg_loss = float(losses.mean()) if len(losses) else 0.0
            if self.logger is not None:
                for loss in losses:
                    self.logger.log_batch_loss(float(loss))
                self.logger.log_throughput(examples_per_epoch / dt)
            self._print(f"Epoch {epoch}/{cfg.epochs}, Average Loss: {avg_loss:.4f} "
                  f"({examples_per_epoch / dt:,.0f} ex/s)")

            if epoch % cfg.val_interval == 0:
                recall, ndcg = self.validate()
                self._print(f"Epoch {epoch} | Val Recall@{cfg.top_k}: {recall:.4f}, "
                      f"Val NDCG@{cfg.top_k}: {ndcg:.4f}")
                if self.logger is not None:
                    self.logger.log_epoch_metrics(epoch, avg_loss, recall, ndcg)
                if recall > best_recall:
                    best_recall = recall
                    self.save_checkpoint(ckpt_dir, "best", epoch, best_recall)
                    self._print("New best model saved...")
                self.save_checkpoint(ckpt_dir, "last", epoch, best_recall)

        if self.logger is not None:
            self.logger.save(total_epochs=cfg.epochs)
        return self.params(), best_recall
