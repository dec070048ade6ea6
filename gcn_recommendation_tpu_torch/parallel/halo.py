"""Explicit sharded propagation: row-partitioned nodes + halo exchange.

PyTorch counterpart of ``gcn_recommendation_tpu/parallel/halo.py``, the
graph analogue of sequence parallelism.  Node rows are partitioned
contiguously over the ``model`` axis, and each propagation layer

1. **all-gathers** the node embeddings over ``model`` (the halo
   exchange), then
2. runs the ELL buckets and hub rows of this rank's destination rows only.

``A_norm`` is symmetric, so a layer's backward maps the cotangent's
shards the same way: one all-gather of the cotangent and the same local
product (the transpose JAX derives, a reduce-scatter of the gathered
block's cotangent, gives the same sums).

Host-side, ``shard_ell`` re-buckets the graph per shard with a common
bucket-width set and per-width row counts padded to the maximum across
shards, so every rank runs the same shapes.  A rank keeps its own shard
(``ShardedEll.local``).
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch

from gcn_recommendation_tpu_torch.core.mesh import MODEL_AXIS
from gcn_recommendation_tpu_torch.graph.build import Graph, bucket_by_degree
from gcn_recommendation_tpu_torch.ops.spmm import BucketTable, _ell_matvec
from gcn_recommendation_tpu_torch.parallel.collectives import (
    all_gather_rows,
    gather_rows,
    row_slice,
)
from gcn_recommendation_tpu_torch.parallel.spmd import ShardedTrainer


class ShardedEllArrays(NamedTuple):
    """The per-shard ELL adjacency: stacked over shards on the host
    (``[m, ...]`` numpy), or one rank's shard on its device (tensors,
    leading axis dropped)."""

    bucket_nbr_idx: Tuple  # per width [m, rows, w] int
    bucket_nbr_w: Tuple    # per width [m, rows, w] f32
    gather_idx: object     # [m, nodes_per_shard] int
    dense_mat: object      # [m, h_max, num_nodes_pad] f32
    # one shard's parts table on its device (None on the host)
    buckets: Optional[BucketTable] = None


class ShardedEll:
    """Per-shard ELL adjacency: the host arrays of every shard plus
    static metadata."""

    def __init__(self, arrays: ShardedEllArrays, n_shards, nodes_per_shard, num_nodes):
        self.arrays = arrays
        self.n_shards = n_shards
        self.nodes_per_shard = nodes_per_shard
        self.num_nodes = num_nodes            # true (unpadded) node count

    @property
    def num_nodes_pad(self):
        return self.n_shards * self.nodes_per_shard

    def local(self, shard: int, device, compute_dtype=torch.float32) -> ShardedEllArrays:
        """Shard ``shard``'s arrays on ``device`` (int64 indices, values in
        ``compute_dtype``)."""
        a = self.arrays

        def idx(x):
            return torch.as_tensor(np.ascontiguousarray(x[shard]), dtype=torch.int64,
                                   device=device)

        def val(x):
            return torch.as_tensor(np.ascontiguousarray(x[shard]), device=device).to(
                compute_dtype)

        bucket_idx = tuple(idx(x) for x in a.bucket_nbr_idx)
        bucket_w = tuple(val(x) for x in a.bucket_nbr_w)
        dense = val(a.dense_mat)
        return ShardedEllArrays(
            bucket_nbr_idx=bucket_idx,
            bucket_nbr_w=bucket_w,
            gather_idx=idx(a.gather_idx),
            dense_mat=dense,
            buckets=BucketTable(bucket_idx, bucket_w, dense.device, int(dense.shape[0])),
        )


def shard_ell(graph: Graph, n_shards: int, dense_threshold: int = 128) -> ShardedEll:
    """Partition destination rows contiguously into ``n_shards`` shards.

    Each shard gets its own degree-bucketed ELL (+ dense hub rows over the
    whole padded node space) over a shared width set; row counts are
    zero-padded to the per-width maximum so every shard has one shape.
    ``graph`` needs ``src`` / ``dst`` / ``weight`` / ``nnz`` /
    ``num_nodes`` (a ``Graph`` or ``pad_coo_node_space``'s view)."""
    n = graph.num_nodes
    nps = -(-n // n_shards)
    n_pad = nps * n_shards

    dst = graph.dst[: graph.nnz].astype(np.int64)
    src = graph.src[: graph.nnz].astype(np.int64)
    w = graph.weight[: graph.nnz]

    per_shard = []
    for s in range(n_shards):
        lo, hi = s * nps, min((s + 1) * nps, n)
        m = (dst >= lo) & (dst < hi)
        # local dst ids, global src ids
        per_shard.append(bucket_by_degree(
            dst[m] - lo, src[m], w[m], nps,
            dense_threshold=dense_threshold, num_src_nodes=n_pad,
        ))

    widths = sorted({b.width for bks, *_ in per_shard for b in bks})
    rows_max = {
        wd: max(next((b.nbr_idx.shape[0] for b in bks if b.width == wd), 0)
                for bks, *_ in per_shard)
        for wd in widths
    }
    h_max = max(d.shape[0] for *_, d in per_shard)

    stacked_idx, stacked_w = [], []
    for wd in widths:
        si = np.zeros((n_shards, rows_max[wd], wd), np.int32)
        sw = np.zeros((n_shards, rows_max[wd], wd), np.float32)
        for s, (bks, *_rest) in enumerate(per_shard):
            for b in bks:
                if b.width == wd:
                    si[s, : b.nbr_idx.shape[0]] = b.nbr_idx
                    sw[s, : b.nbr_w.shape[0]] = b.nbr_w
        stacked_idx.append(si)
        stacked_w.append(sw)

    # each shard's gather index addresses the padded concat layout
    # [width-0 rows_max | width-1 rows_max | ... | h_max hub rows | 1 zeros]
    gather = np.zeros((n_shards, nps), np.int32)
    dense_stack = np.zeros((n_shards, h_max, n_pad), np.float32)
    width_offset = {}
    off = 0
    for wd in widths:
        width_offset[wd] = off
        off += rows_max[wd]
    dense_offset = off
    zeros_row = off + h_max

    for s, (bks, _gidx, hub_ids, dense) in enumerate(per_shard):
        local = np.full(nps, zeros_row, np.int32)
        for b in bks:
            local[b.node_ids] = width_offset[b.width] + np.arange(
                b.node_ids.shape[0], dtype=np.int32)
        if hub_ids.shape[0]:
            local[hub_ids] = dense_offset + np.arange(hub_ids.shape[0], dtype=np.int32)
            dense_stack[s, : dense.shape[0], : dense.shape[1]] = dense
        gather[s] = local

    return ShardedEll(
        ShardedEllArrays(
            bucket_nbr_idx=tuple(stacked_idx),
            bucket_nbr_w=tuple(stacked_w),
            gather_idx=gather,
            dense_mat=dense_stack,
        ),
        n_shards=n_shards,
        nodes_per_shard=nps,
        num_nodes=n,
    )


def _local_propagate(full_emb, arrays: ShardedEllArrays):
    """One shard's output rows from the gathered whole node block."""
    return _ell_matvec(full_emb, arrays.buckets, arrays.gather_idx, arrays.dense_mat)


class _HaloLayer(torch.autograd.Function):
    @staticmethod
    def forward(ctx, e_local, arrays, group, full):
        ctx.arrays, ctx.group = arrays, group
        if full is None:
            full = all_gather_rows(e_local, group)  # the halo exchange
        return _local_propagate(full, arrays)

    @staticmethod
    def backward(ctx, grad):
        # A_norm is symmetric: this shard's rows of A @ (all shards' grads)
        return _local_propagate(all_gather_rows(grad, ctx.group), ctx.arrays), None, None, None


def halo_layer(e_local, arrays: ShardedEllArrays, group, full=None):
    """This rank's rows of ``A_norm @ e`` from its rows ``e_local`` (one
    all-gather, or ``full`` when the caller already holds the whole block),
    differentiable in ``e_local``."""
    return _HaloLayer.apply(e_local, arrays, group, full)


def _check_shards(mesh, sharded: ShardedEll):
    assert sharded.n_shards == mesh.shape[MODEL_AXIS], (
        f"graph sharded {sharded.n_shards}-way but model axis is "
        f"{mesh.shape[MODEL_AXIS]}"
    )


def make_halo_propagator(mesh, sharded: ShardedEll, n_layers: int,
                         compute_dtype=torch.float32, arrays=None):
    """Build ``fn(emb_pad [N_pad, d]) -> final [N_pad, d]``: the LightGCN
    layer mean ``mean(e0, A e0, ..., A^K e0)`` with one all-gather per
    layer.  Input and output are the whole padded node block, alike on
    every model rank; the compute is this rank's rows.  ``arrays``: this
    rank's shard already on the device (else taken from ``sharded``)."""
    _check_shards(mesh, sharded)
    group = mesh.group(MODEL_AXIS)
    if arrays is None:
        arrays = sharded.local(mesh.coordinate(MODEL_AXIS), mesh.device, compute_dtype)

    def propagate(emb_pad):
        e = row_slice(emb_pad, group)
        acc = e.float()
        x = e.to(compute_dtype)
        for layer in range(n_layers):
            full = emb_pad.detach().to(compute_dtype) if layer == 0 else None
            x = halo_layer(x, arrays, group, full)
            acc = acc + x.float()
        return gather_rows((acc / (n_layers + 1)).to(e.dtype), group)

    return propagate


def make_halo_table_propagator(mesh, sharded: ShardedEll, n_layers: int,
                               compute_dtype=torch.float32, arrays=None):
    """Build ``fn(u, i, b) -> final [N_pad, d]`` over ROW-SHARDED tables.

    The layer-0 halo exchange is three per-table all-gathers that
    reassemble the whole node block in node order ([users_pad | items_pad
    | brands_pad]), so params and Adam moments stay row-sharded (1/m per
    rank) and no relayout collective exists.  This rank's e0 rows are its
    slice of that block; the final block is all-gathered for the loss,
    which every model rank computes alike.  Needs every table's row count
    to divide the model axis (``HaloTrainer`` pads the tables)."""
    _check_shards(mesh, sharded)
    group = mesh.group(MODEL_AXIS)
    if arrays is None:
        arrays = sharded.local(mesh.coordinate(MODEL_AXIS), mesh.device, compute_dtype)

    def propagate(u, i, b):
        full = torch.cat([gather_rows(t, group) for t in (u, i, b)])
        e = row_slice(full, group)
        acc = e.float()
        x = e.to(compute_dtype)
        for layer in range(n_layers):
            # layer 0 reuses the table-gather block
            x = halo_layer(x, arrays, group,
                           full.detach().to(compute_dtype) if layer == 0 else None)
            acc = acc + x.float()
        return gather_rows((acc / (n_layers + 1)).to(e.dtype), group)

    return propagate


class _CooView(NamedTuple):
    """A COO graph view ``shard_ell`` can consume (it re-buckets per shard
    itself, so a remap into the padded node space needs no full Graph)."""

    src: np.ndarray
    dst: np.ndarray
    weight: np.ndarray
    nnz: int
    num_nodes: int


def pad_coo_node_space(graph: Graph, num_users_pad, num_items_pad, num_brands_pad):
    """Remap COO node ids into the ``[users_pad | items_pad | brands_pad]``
    layout (the monotone remap of ``graph.build.pad_graph_nodes``, COO
    only)."""
    U, I = graph.num_users, graph.num_items
    du = np.int64(num_users_pad - U)
    di = np.int64(num_items_pad - I)

    def remap(v):
        v = v.astype(np.int64)
        return (v + du * (v >= U) + di * (v >= U + I)).astype(np.int32)

    return _CooView(
        src=remap(graph.src[: graph.nnz]),
        dst=remap(graph.dst[: graph.nnz]),
        weight=graph.weight[: graph.nnz],
        nnz=graph.nnz,
        num_nodes=num_users_pad + num_items_pad + num_brands_pad,
    )


class HaloTrainer(ShardedTrainer):
    """Trainer whose forward runs the explicit halo-exchange schedule.

    Overrides only how the adjacency is laid out (``shard_ell`` over the
    padded node space, this rank's shard on its device) and the propagator
    (``make_halo_table_propagator``); state placement (row-sharded tables
    and Adam moments), the data-axis batch split, the loss, sampler,
    optimizer, checkpoints and the sharded validation are those of
    ``ShardedTrainer`` and ``Trainer``, so the paths cannot diverge.
    """

    schedule = "halo"

    def _device_graph(self):
        """This rank's shard of ``shard_ell`` over the padded COO list."""
        m = self.model
        coo = pad_coo_node_space(self.bundle.graph, m.num_users_pad, m.num_items_pad,
                                 m.num_brands_pad)
        self.sharded = shard_ell(coo, self.mesh.shape[MODEL_AXIS])
        return self.sharded.local(self.mesh.coordinate(MODEL_AXIS), self.device,
                                  getattr(torch, self.config.compute_dtype))

    def _make_propagator(self):
        return make_halo_table_propagator(
            self.mesh, self.sharded, self.model.n_layers, self.model.compute_dtype,
            arrays=self.graph)
