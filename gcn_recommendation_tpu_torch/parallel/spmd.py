"""Multi-device execution: DP x TP over a ('data', 'model') mesh.

PyTorch counterpart of ``gcn_recommendation_tpu/parallel/spmd.py``.  The
JAX package annotates shardings and lets GSPMD place the collectives; the
port runs one process per device and places them itself, where GSPMD
would:

* **Tensor parallelism.**  The embedding tables and their Adam moments
  are row-sharded over ``model`` (``shard_params``): each rank stores
  ``rows / m`` rows of each table.  Each ELL bucket's rows and the hub
  rows are row-sharded too (``shard_graph``); the node gather index stays
  whole.  A propagation layer takes the whole node block, reduces this
  rank's rows of every bucket, and all-gathers the bucket outputs over
  ``model``; the layer-0 block is the all-gather of the three tables.
  ``A_norm`` is symmetric, so a layer's backward is the same sharded
  product on the cotangent (one all-gather), as the single-device ELL
  path's backward is its forward.
* **Data parallelism.**  Every rank draws the same whole batch and
  negatives from the same generator state and keeps its ``data`` slice;
  gradients are averaged over ``data`` (and summed over ``model`` for the
  few small leaves every rank holds whole, the fusion kernel and bias,
  which each rank applies to its own rows only).
* **Distributed top-k.**  The item catalog is row-sharded over ``model``;
  each rank scores its shard, takes a masked local top-k with global
  indices, the ranks all-gather their candidates and merge
  (``ops/topk.py::merge_topk_candidates``).

Pipeline and expert parallelism have no place in a 3-SpMM model with no
weight layers between the products, as in the JAX package.
"""

from __future__ import annotations

import copy
import dataclasses
import warnings
from typing import Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist

from gcn_recommendation_tpu_torch.core.mesh import DATA_AXIS, MODEL_AXIS
from gcn_recommendation_tpu_torch.ops.quant import quantized_scores
from gcn_recommendation_tpu_torch.ops.spmm import (
    BucketTable,
    DeviceGraph,
    SymmetricGraph,
    _parts_matvec,
    layer_mean,
    to_device_graph,
)
from gcn_recommendation_tpu_torch.ops.topk import (
    MASK_VALUE,
    masked_topk,
    merge_topk_candidates,
    topk_hit_metrics,
)
from gcn_recommendation_tpu_torch.parallel.collectives import (
    all_gather_rows,
    all_reduce_mean_,
    gather_rows,
)
from gcn_recommendation_tpu_torch.train.evaluate import build_eval_batches, evaluate_batches
from gcn_recommendation_tpu_torch.train.trainer import Trainer

# Replicating a table this large is almost certainly an error (the
# embedding tables ARE the model); smaller non-divisible leaves are
# legitimately replicated.
_REPLICATION_WARN_ROWS = 1024


def _device_key(device: torch.device):
    """``cuda`` and ``cuda:<current>`` name one device."""
    if device.type == "cuda" and device.index is None:
        return ("cuda", torch.cuda.current_device())
    return (device.type, device.index)


def _shard(x: torch.Tensor, mesh) -> torch.Tensor:
    rows = x.shape[0] // mesh.shape[MODEL_AXIS]
    r = mesh.coordinate(MODEL_AXIS)
    return x[r * rows : (r + 1) * rows].clone()


def shard_params(params: dict, mesh, row_keys=None) -> dict:
    """This rank's share of ``params``: the rows of every table over the
    model axis, every other leaf whole.

    A table is a 2-D leaf (or, with ``row_keys``, a leaf named there: the
    trainers pass the model's embedding tables and leave the fusion
    kernel whole).  Tables are padded to a model-axis multiple by the
    model (``set_row_multiple``, which ``ShardedTrainer`` applies); a
    large leaf whose rows do not divide stays whole and warns, since that
    throws the memory win of sharding away."""
    n_model = mesh.shape[MODEL_AXIS]

    def place(key, x):
        ndim = getattr(x, "ndim", 0)  # Adam's step count is a 0-d leaf of a moment tree
        table = ndim >= 1 and key in row_keys if row_keys is not None else ndim >= 2
        if table and x.shape[0] > 0:
            if x.shape[0] % n_model == 0:
                return _shard(x, mesh)
            if x.shape[0] >= _REPLICATION_WARN_ROWS and n_model > 1:
                warnings.warn(
                    f"replicating a large table {tuple(x.shape)} — rows not "
                    f"divisible by the {n_model}-way model axis; pad via "
                    "model.set_row_multiple (ShardedTrainer does this "
                    "automatically)",
                    stacklevel=3,
                )
        return x

    return {k: place(k, v) for k, v in params.items()}


# --------------------------------------------------------------------- graph


@dataclasses.dataclass
class ShardedGraph(SymmetricGraph):
    """This rank's share of the ELL adjacency (``shard_graph``)."""

    bucket_nbr_idx: Tuple[torch.Tensor, ...]  # this rank's rows (or all rows)
    bucket_nbr_w: Tuple[torch.Tensor, ...]
    bucket_sharded: Tuple[bool, ...]          # False: the bucket stays whole
    dense_mat: torch.Tensor                   # this rank's hub rows (or all)
    dense_sharded: bool
    gather_idx: torch.Tensor                  # node -> row of [every rank's
                                              # sharded rows | whole rows | zeros]
    group: object                             # the model axis's process group
    # the two parts tables: this rank's [sharded buckets | sharded hub rows],
    # and [whole buckets | whole hub rows | zeros row] (built here)
    mine: BucketTable = dataclasses.field(init=False, repr=False, compare=False)
    whole: BucketTable = dataclasses.field(init=False, repr=False, compare=False)

    def __post_init__(self):
        dev, h = self.gather_idx.device, int(self.dense_mat.shape[0])
        pick = [(i, w) for i, w, s in zip(self.bucket_nbr_idx, self.bucket_nbr_w,
                                          self.bucket_sharded) if s]
        rest = [(i, w) for i, w, s in zip(self.bucket_nbr_idx, self.bucket_nbr_w,
                                          self.bucket_sharded) if not s]
        self.mine = BucketTable([i for i, _ in pick], [w for _, w in pick], dev,
                                h if self.dense_sharded else 0, zeros_row=False)
        self.whole = BucketTable([i for i, _ in rest], [w for _, w in rest], dev,
                                 0 if self.dense_sharded else h)

    def product(self, x: torch.Tensor) -> torch.Tensor:
        """``A_norm @ x`` for a whole node block ``x`` that every rank of
        the model axis holds alike: this rank's bucket and hub rows, one
        all-gather of them, the whole buckets, and the node gather.  The
        cotangent is alike on every model rank too, so the backward is
        this product on it."""
        local = _parts_matvec(x, self.mine, self.dense_mat)
        gathered = all_gather_rows(local, self.group)
        tail = _parts_matvec(x, self.whole, self.dense_mat)
        return torch.cat([gathered, tail]).index_select(0, self.gather_idx)


def shard_graph(graph: DeviceGraph, mesh) -> ShardedGraph:
    """Shard the bucket rows and hub rows over the model axis; the gather
    index stays whole (rewritten for the all-gathered layout).  A bucket
    whose rows do not divide the axis stays whole on every rank, with
    JAX's warning when it is large."""
    n_model = mesh.shape[MODEL_AXIS]

    def divides(rows, what):
        if rows > 0 and rows % n_model == 0:
            return True
        if rows >= _REPLICATION_WARN_ROWS and n_model > 1:
            warnings.warn(
                f"replicating a large graph {what} of {rows} rows — rows "
                f"not divisible by the {n_model}-way model axis; pad buckets "
                "via graph.build.pad_ell_rows (ShardedTrainer does this "
                "automatically)",
                stacklevel=3,
            )
        return False

    rows = [int(b.shape[0]) for b in graph.bucket_nbr_idx]
    sharded = tuple(divides(n, "bucket") for n in rows)
    h = int(graph.dense_mat.shape[0])
    dense_sharded = divides(h, "hub block")
    # old layout: concat(buckets, hub rows, zeros row); new layout: every
    # rank's [sharded buckets, sharded hub] block, then whole parts, zeros
    parts = list(zip(rows, sharded)) + [(h, dense_sharded)]
    per_rank = sum(n // n_model for n, s in parts if s)
    whole = sum(n for n, s in parts if not s)
    old = graph.gather_idx.cpu().numpy().astype(np.int64)
    new = np.full(old.shape, n_model * per_rank + whole, np.int64)  # the zeros row
    old_off = local_off = whole_off = 0
    for n, s in parts:
        sel = (old >= old_off) & (old < old_off + n)
        q = old[sel] - old_off
        if s:
            r = n // n_model
            new[sel] = (q // r) * per_rank + local_off + q % r
            local_off += r
        else:
            new[sel] = n_model * per_rank + whole_off + q
            whole_off += n
        old_off += n
    return ShardedGraph(
        bucket_nbr_idx=tuple(_shard(b, mesh) if s else b
                             for b, s in zip(graph.bucket_nbr_idx, sharded)),
        bucket_nbr_w=tuple(_shard(b, mesh) if s else b
                           for b, s in zip(graph.bucket_nbr_w, sharded)),
        bucket_sharded=sharded,
        dense_mat=_shard(graph.dense_mat, mesh) if dense_sharded else graph.dense_mat,
        dense_sharded=dense_sharded,
        gather_idx=torch.from_numpy(new).to(graph.gather_idx.device),
        group=mesh.group(MODEL_AXIS),
    )


def make_gspmd_table_propagator(mesh, graph: ShardedGraph, n_layers: int,
                                compute_dtype=torch.float32):
    """``fn(user, item, brand) -> final [N_pad, d]`` over ROW-SHARDED
    tables: the layer-0 block is the all-gather of the three tables in node
    order, then ``ops/spmm.py::layer_mean`` over the ``ShardedGraph`` on
    the whole block (every model rank holds the result)."""
    group = mesh.group(MODEL_AXIS)

    def propagate(u, i, b):
        ego = torch.cat([gather_rows(t, group) for t in (u, i, b)])
        return layer_mean(ego, graph, n_layers, compute_dtype)

    return propagate


# ------------------------------------------------------------------- trainer


class ShardedTrainer(Trainer):
    """Trainer whose tables, Adam moments and graph live sharded on a
    ('data', 'model') mesh (the ``gspmd`` schedule).

    The model is copied and padded to a model-axis multiple
    (``set_row_multiple``, applied even when every vocabulary divides, so
    the ELL bucket rows are padded too); the caller's model is left as it
    is.  The copy's tables are replaced by this rank's rows, taken from the
    model's current tables.  The loss, sampler, optimizer, checkpoints and
    the epoch loop are ``Trainer``'s; checkpoints stay logical (rank 0
    gathers and writes them), so a checkpoint of one mesh resumes on
    another.
    """

    schedule = "gspmd"

    def __init__(self, config, model, bundle, mesh, logger=None):
        if config.tile_spmm:
            raise ValueError("--tile_spmm is single-device only: drop it or --mesh")
        if _device_key(model.device) != _device_key(mesh.device):
            raise ValueError(f"the model lives on {model.device}, this rank on {mesh.device}")
        n_model, n_data = mesh.shape[MODEL_AXIS], mesh.shape[DATA_AXIS]
        if config.batch_size % n_data:
            raise ValueError(
                f"batch size {config.batch_size} does not split over the {n_data}-way data axis")
        self.mesh = mesh
        self._source_model = model  # draws fresh params (init_state)
        padded = model.needs_row_padding(n_model)
        model = copy.deepcopy(model)
        model.set_row_multiple(n_model)
        if padded and dist.get_rank() == 0:
            print(f"TP padding ({self.schedule}): tables -> multiples of {n_model} "
                  f"(users {model.num_users}->{model.num_users_pad}, "
                  f"items {model.num_items}->{model.num_items_pad}, "
                  f"brands {model.num_brands}->{model.num_brands_pad})")
        # the embedding tables (and the content matrix that rides the item
        # table's padding) are row-sharded; the fusion kernel and bias stay whole
        self._sharded_keys = frozenset(
            k for k, v in model.params().items()
            if k in model._table_pad_spec() and v.shape[0] and v.shape[0] % n_model == 0)
        super().__init__(config, model, bundle, logger=logger)
        if dist.get_rank() != 0:
            self._print = lambda *args, **kwargs: None
        self.propagator = self._make_propagator()
        self._load_model_params(model.params())

    # --- graph and forward ---
    def _device_graph(self):
        """The plain, per-layer ELL layout, sharded: no source chunks (the
        row shards already split the tables) and no merge-skip views."""
        g = self.model.padded_graph(self.bundle.graph)
        cdtype = getattr(torch, self.config.compute_dtype)
        return shard_graph(to_device_graph(g, compute_dtype=cdtype, device=self.device,
                                           fuse_layers=False), self.mesh)

    def _make_propagator(self):
        return make_gspmd_table_propagator(
            self.mesh, self.graph, self.model.n_layers, self.model.compute_dtype)

    def _gather_table(self, t):
        return gather_rows(t, self.mesh.group(MODEL_AXIS))

    def _forward(self):
        return self.model.apply_with_table_propagator(
            self.propagator, gather_table=self._gather_table)

    # --- state placement ---
    def _draw_params(self):
        return self._source_model._draw_params(torch.Generator().manual_seed(self.config.seed))

    def _load_model_params(self, params) -> None:
        """This rank's rows of ``params`` (logical or padded) become the
        model's tensors; the optimizer is rebuilt over them."""
        local = self._import_tree({k: torch.as_tensor(v) for k, v in params.items()})
        for key in self.model.param_keys:
            self.model._set_tensor(key, local[key].to(self.model.param_dtype))
        self.optimizer = self._make_optimizer()

    def _import_tree(self, tree):
        return shard_params(self.model.pad_state_tree(tree), self.mesh, self._sharded_keys)

    def _gather_tree(self, tree):
        group = self.mesh.group(MODEL_AXIS)
        return {k: all_gather_rows(v, group)
                if k in self._sharded_keys and torch.is_tensor(v) and v.ndim >= 1 else v
                for k, v in tree.items()}

    def _export_tree(self, tree):
        return self.model.unpad_state_tree(self._gather_tree(tree))

    def params(self):
        """The whole padded params, gathered from every model rank."""
        return self._gather_tree(self.model.params())

    # --- the step ---
    def _local_batch(self, *arrays):
        n_data = self.mesh.shape[DATA_AXIS]
        c = self.mesh.coordinate(DATA_AXIS)
        w = arrays[0].shape[0] // n_data
        return tuple(a[c * w : (c + 1) * w] for a in arrays)

    def batch_loss(self, users, pos, neg, brand_denom=None) -> torch.Tensor:
        """This rank's share of the loss of the whole batch ``users``,
        ``pos``, ``neg``: its data slice, normalized so that the mean over
        the data axis is the whole batch's loss."""
        cfg = self.config
        if brand_denom is None and cfg.brand_loss and cfg.use_brand:
            valid = (self.item_to_brand.index_select(0, pos) >= 0) & (
                self.item_to_brand.index_select(0, neg) >= 0)
            brand_denom = valid.sum().clamp_min(1) / self.mesh.shape[DATA_AXIS]
        return super().batch_loss(*self._local_batch(users, pos, neg), brand_denom=brand_denom)

    def _reduce_gradients(self) -> None:
        n_data = self.mesh.shape[DATA_AXIS]
        for key in self.model.trainable_keys:
            grad = getattr(self.model, key).grad
            if grad is None:
                continue
            if key in self._sharded_keys:
                all_reduce_mean_(grad, self.mesh.group(DATA_AXIS), n_data)
            else:  # whole on every rank, used on the rank's own rows
                all_reduce_mean_(grad, dist.group.WORLD, n_data)

    def _reduce_loss(self, loss):
        return all_reduce_mean_(loss.clone(), self.mesh.group(DATA_AXIS),
                                self.mesh.shape[DATA_AXIS])

    def validate(self):
        return validate_with_sharded_topk(self)


@torch.no_grad()
def validate_with_sharded_topk(trainer):
    """Distributed validation of every mesh-sharded trainer: the forward
    of the trainer's own schedule, then the item-row-sharded local top-k
    and all-gather merge, with the user batches split over the data axis.
    A 1x1 mesh takes the single-device evaluator."""
    fu, fi, *_ = trainer._forward_eval()
    b = trainer.bundle
    if trainer._eval_batches is None:
        trainer._eval_batches = build_eval_batches(
            b.val, b.train, b.num_users, b.num_items,
            trainer.config.eval_user_batch, device=trainer.device,
        )
    if trainer.mesh.size <= 1:
        return evaluate_batches(fu, fi, trainer._eval_batches, trainer.config.top_k)
    return evaluate_sharded(
        trainer.mesh, fu, fi, b.val, b.train, b.num_users, b.num_items,
        trainer.config.top_k, trainer.config.eval_user_batch,
        batches=trainer._eval_batches,
    )


# ------------------------------------------------------ distributed top-k


def _mask_local_topk(scores, filter_idx, k, mesh, num_valid_items=None, stable=False):
    """This shard's masked top-k with global item indices, shared by the
    f32 and int8 scoring paths.

    ``num_valid_items``, when given, masks the zero pad rows at global
    column >= num_valid_items.  Global filter ids outside this shard map
    to the pad index masking drops.  ``k`` may exceed the shard's rows:
    the local top-k is clamped and padded back to k with MASK_VALUE.
    Every slot at MASK_VALUE (pad slots, and masked entries a starved
    shard returns) carries an index sentinel >= the catalog size, so a
    merged top-k of fewer than k real candidates never names a real item
    it did not select."""
    b, shard_items = scores.shape
    n_model = mesh.shape[MODEL_AXIS]
    offset = mesh.coordinate(MODEL_AXIS) * shard_items
    if num_valid_items is not None:
        col = offset + torch.arange(shard_items, device=scores.device)
        scores = scores.masked_fill(col[None, :] >= num_valid_items, MASK_VALUE)
    mine = (filter_idx >= offset) & (filter_idx < offset + shard_items)
    local_filter = torch.where(mine, filter_idx - offset, shard_items)
    kk = min(k, shard_items)
    vals, loc = masked_topk(scores, local_filter, kk, stable=stable)
    sentinel = num_valid_items if num_valid_items is not None else shard_items * n_model
    loc = torch.where(vals == MASK_VALUE, sentinel - offset, loc)
    if kk < k:
        vals = torch.cat([vals, vals.new_full((b, k - kk), MASK_VALUE)], dim=1)
        loc = torch.cat([loc, loc.new_full((b, k - kk), sentinel - offset)], dim=1)
    return vals, loc + offset


def _local_masked_topk(u_emb, item_shard, filter_idx, k, mesh, num_valid_items=None,
                       stable=False):
    """Score ``u_emb`` against this rank's item rows, then
    ``_mask_local_topk``."""
    scores = u_emb.float() @ item_shard.float().T
    return _mask_local_topk(scores, filter_idx, k, mesh, num_valid_items, stable)


def _merge_over_model(vals, gidx, k, mesh):
    group = mesh.group(MODEL_AXIS)
    all_vals = all_gather_rows(vals[None], group)  # [m, B, k]
    all_idx = all_gather_rows(gidx[None], group)
    return merge_topk_candidates(all_vals, all_idx, k)


def sharded_topk_eval_batch(
    mesh,
    user_emb_batch: torch.Tensor,  # [B, d], alike on every model rank
    item_shard: torch.Tensor,      # [I_pad / m, d] this rank's catalog rows
    filter_idx: torch.Tensor,      # [B, F] global item ids (pad >= I)
    k: int,
    num_valid_items: Optional[int] = None,
    stable: bool = False,
):
    """Distributed masked top-k: local top-k per item shard, all-gather
    over ``model``, merge.  Pass ``num_valid_items`` (the true catalog
    size) so the zero pad rows are masked: a pad row scores 0, which can
    beat a user's all-negative real scores.  ``stable``: ties in
    ``lax.top_k``'s order inside a shard too (evaluation).  Returns
    (values, global indices) [B, k], alike on every model rank."""
    vals, gidx = _local_masked_topk(user_emb_batch, item_shard, filter_idx, k, mesh,
                                    num_valid_items, stable)
    return _merge_over_model(vals, gidx, k, mesh)


def sharded_quantized_topk_batch(
    mesh,
    user_emb_batch: torch.Tensor,    # [B, d] f32, alike on every model rank
    item_q_shard: torch.Tensor,      # [I_pad / m, d] int8, this rank's rows
    item_scale_shard: torch.Tensor,  # [I_pad / m, 1] f32
    filter_idx: torch.Tensor,        # [B, F] global item ids (pad >= I)
    k: int,
    num_valid_items: Optional[int] = None,
    user_buffers=None,
):
    """Distributed masked top-k over an int8 catalog: each rank quantizes
    the users round-to-nearest (one launch of the quantizer's nearest mode
    on the card), scores its shard int8 x int8 -> int32
    (``ops/quant.py::quantized_scores``), then the local top-k, all-gather
    and merge of ``sharded_topk_eval_batch``.  The user codes are alike on
    every rank, so each shard's scores equal the single-device columns."""
    scores = quantized_scores(user_emb_batch, item_q_shard, item_scale_shard, user_buffers)
    vals, gidx = _mask_local_topk(scores, filter_idx, k, mesh, num_valid_items)
    return _merge_over_model(vals, gidx, k, mesh)


def pad_rows(x: torch.Tensor, multiple: int) -> torch.Tensor:
    """Zero-pad the leading dim to a multiple (for even row sharding)."""
    n = x.shape[0]
    target = ((n + multiple - 1) // multiple) * multiple
    if target == n:
        return x
    return torch.cat([x, x.new_zeros((target - n,) + tuple(x.shape[1:]))])


def catalog_shard(item_emb: torch.Tensor, mesh) -> torch.Tensor:
    """This rank's rows of the catalog padded to ``n_model * 8`` rows (a
    multiple of 8 on every shard, the int8 product's row multiple)."""
    return _shard(pad_rows(item_emb, mesh.shape[MODEL_AXIS] * 8), mesh)


@torch.no_grad()
def evaluate_sharded(
    mesh,
    fu: torch.Tensor,   # [U, d] final user embeddings, alike on every rank
    fi: torch.Tensor,   # [I, d] final item embeddings, alike on every rank
    eval_inter,
    filter_inter,
    num_users: int,
    num_items: int,
    k: int,
    batch_size: int = 1024,
    batches=None,
):
    """Leave-one-out Recall/NDCG@k with the distributed top-k.

    The protocol of ``train/evaluate.py`` (main.py:404-439 semantics) with
    the items padded to ``n_model * 8`` and row-sharded over ``model``.
    Each batch's users split over ``data`` when the batch width divides it
    (``build_eval_batches`` pads every batch to ``batch_size``), and the
    three sums are all-reduced over ``data``; otherwise every data rank
    evaluates every batch.  Pass prebuilt ``batches`` to reuse them."""
    if batches is None:
        batches = build_eval_batches(
            eval_inter, filter_inter, num_users, num_items, batch_size, device=mesh.device)
    if not batches:
        return 0.0, 0.0
    n_data = mesh.shape[DATA_AXIS]
    item_shard = catalog_shard(fi, mesh)
    data_sharded = n_data > 1 and all(b[0].shape[0] % n_data == 0 for b in batches)
    c = mesh.coordinate(DATA_AXIS)
    sums = torch.zeros(3, dtype=torch.float32, device=fu.device)
    for batch in batches:
        if data_sharded:
            w = batch[0].shape[0] // n_data
            batch = tuple(a[c * w : (c + 1) * w] for a in batch)
        users, true_items, filt, valid = batch
        _, idx = sharded_topk_eval_batch(
            mesh, fu.index_select(0, users), item_shard, filt, k,
            num_valid_items=num_items, stable=True)
        sums += torch.stack(topk_hit_metrics(idx, true_items, valid))
    if data_sharded:
        dist.all_reduce(sums, group=mesh.group(DATA_AXIS))
    recall_sum, ndcg_sum, count = sums.tolist()
    if count == 0:
        return 0.0, 0.0
    return recall_sum / count, ndcg_sum / count
