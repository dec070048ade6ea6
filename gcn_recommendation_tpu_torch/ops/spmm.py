"""Sparse propagation ``A_norm @ emb`` over the degree-bucketed ELL graph.

PyTorch counterpart of ``gcn_recommendation_tpu/ops/spmm.py``:

* ``propagate_ell`` — per bucket a gather, multiply and reduce over the
  padded neighbor axis, the hub rows as one dense matrix product, a
  zeros row for degree-0 nodes, and one gather restoring node order.
  These are ``index_select`` and ``torch.matmul``: the JAX package
  leaves them to XLA, not to a Pallas kernel.  ``A_norm`` is symmetric,
  so its backward pass is the same gather product applied to the
  cotangent (a ``torch.autograd.Function``), never autograd's
  ``index_add_`` scatter through the gathers.
* ``propagate_sum_ell`` — ``sum_{k=1..K} A_norm^k @ ego`` with one
  restore gather for all K layers (merge-skip), over the permuted views
  that ``to_device_graph(fuse_layers=True)`` builds; what the default
  ``Trainer`` and ``test`` mode run.  ``sum_k A^k`` is symmetric too, so
  its backward is the same sum on the cotangent.
* ``propagate_chunked`` — the source-chunked, destination-sliced layout
  (``to_device_chunked_graph``), which ``to_device_graph_auto`` picks
  above this card's gather knee (``GATHER_KNEE_ROWS``).
* ``propagate_coo`` — ``index_add_`` over the dst-sorted COO list; the
  in-port oracle for the ELL path.

Index arrays are converted to int64 once, when a graph is shipped:
``index_select`` and ``index_add_`` take int64 indices.

Spans (``utils/profiling.py``): ``spmm.forward`` / ``spmm.backward``
around each propagation of the autograd functions, ``spmm.hub`` around
each hub-row product, ``spmm.to_device`` around a graph's layout and
upload; the counter ``spmm.gathered_rows`` counts the embedding rows a
propagation gathers (ELL slots, padding included, and restore gathers).
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import numpy as np
import torch

from gcn_recommendation_tpu_torch.core.device import DeviceLike, resolve_device
from gcn_recommendation_tpu_torch.graph.build import Graph, build_chunked_ell
from gcn_recommendation_tpu_torch.utils import profiling
from gcn_recommendation_tpu_torch.utils.profiling import span

GATHERED_ROWS = "spmm.gathered_rows"


@dataclasses.dataclass
class DeviceGraph:
    """Device-resident adjacency.  The COO view is empty unless built
    with ``include_coo=True``.

    The two ``*_perm`` fields are the permuted-space views that let
    multi-layer propagation skip the per-layer restore gather
    (``propagate_sum_ell``): neighbor ids composed with ``gather_idx``, so
    that layer k >= 2 gathers straight from layer k-1's bucket-concat
    output, and the hub matrix with its columns moved into that parts
    order.  Empty unless built with ``fuse_layers=True``."""

    src: torch.Tensor                          # [nnz_pad] int64, dst-sorted COO
    dst: torch.Tensor                          # [nnz_pad] int64
    weight: torch.Tensor                       # [nnz_pad] compute dtype
    bucket_nbr_idx: Tuple[torch.Tensor, ...]   # per bucket [nb, width] int64
    bucket_nbr_w: Tuple[torch.Tensor, ...]     # per bucket [nb, width]
    gather_idx: torch.Tensor                   # [num_nodes] int64 into
                                               # concat(buckets, hub rows, zeros row)
    dense_mat: torch.Tensor                    # [H, num_nodes] hub rows
    bucket_nbr_idx_perm: Tuple[torch.Tensor, ...] = ()  # gather_idx[nbr_idx], int64
    dense_mat_perm: Optional[torch.Tensor] = None       # [H, nrows], columns in parts order

    @property
    def fused(self) -> bool:
        """True when the permuted views of ``propagate_sum_ell`` are here."""
        return (len(self.bucket_nbr_idx_perm) == len(self.bucket_nbr_idx)
                and self.dense_mat_perm is not None)


def to_device_graph(
    g: Graph,
    compute_dtype: torch.dtype = torch.float32,
    include_coo: bool = False,
    device: DeviceLike = None,
    dense_dtype: Optional[torch.dtype] = None,
    fuse_layers: bool = True,
) -> DeviceGraph:
    """Ship the ELL view to ``device`` with weights in ``compute_dtype``
    and the hub matrix in ``dense_dtype`` (default: ``compute_dtype``).

    ``include_coo`` adds the COO view (~20 bytes per edge), which only
    ``path='coo'`` reads.  ``fuse_layers`` (the JAX package's default)
    adds the permuted views of ``propagate_sum_ell``: the hub matrix is
    then resident twice (0.50 GB more for the books bundle's 1,748 x
    72,001 f32 hub rows), the composed neighbor ids once more.  Callers
    that propagate once or shard the graph pass ``fuse_layers=False``."""
    with span("spmm.to_device"):
        dev = resolve_device(device)
        if dense_dtype is None:
            dense_dtype = compute_dtype

        def idx(a):
            return torch.as_tensor(a, dtype=torch.int64, device=dev)

        def val(a, dtype=compute_dtype):
            return torch.as_tensor(a, device=dev).to(dtype)

        idx_perm, dense_perm = (), None
        if fuse_layers:
            # neighbor ids composed into parts order, on the host
            gi = np.asarray(g.gather_idx, np.int64)
            idx_perm = tuple(idx(gi[b.nbr_idx]) for b in g.buckets)
            h = g.dense_mat.shape[0]
            nrows = sum(b.nbr_idx.shape[0] for b in g.buckets) + h + 1
            dp = np.zeros((h, nrows), g.dense_mat.dtype)
            # column v of the node-space hub matrix lands at parts position
            # gather_idx[v]; degree-0 nodes share the trailing zeros position,
            # but their columns are all zero (no edges), so the collision is
            # harmless (the last write wins over zeros)
            dp[:, gi] = g.dense_mat
            dense_perm = val(dp, dense_dtype)

        empty_i = torch.zeros(0, dtype=torch.int64, device=dev)
        return DeviceGraph(
            src=idx(g.src) if include_coo else empty_i,
            dst=idx(g.dst) if include_coo else empty_i,
            weight=val(g.weight) if include_coo
            else torch.zeros(0, dtype=compute_dtype, device=dev),
            bucket_nbr_idx=tuple(idx(b.nbr_idx) for b in g.buckets),
            bucket_nbr_w=tuple(val(b.nbr_w) for b in g.buckets),
            gather_idx=idx(g.gather_idx),
            dense_mat=val(g.dense_mat, dense_dtype),
            bucket_nbr_idx_perm=idx_perm,
            dense_mat_perm=dense_perm,
        )


def propagate_coo(
    emb: torch.Tensor,
    src: torch.Tensor,
    dst: torch.Tensor,
    weight: torch.Tensor,
    num_nodes: int,
) -> torch.Tensor:
    """``out[v] = sum_{e: dst[e]=v} w[e] * emb[src[e]]``."""
    msgs = emb.index_select(0, src) * weight[:, None]
    out = torch.zeros((num_nodes, emb.shape[1]), dtype=emb.dtype, device=emb.device)
    return out.index_add_(0, dst, msgs)


# Widths up to this use a sum of width-1 gathers instead of one
# [nb, width, d] gather.  The JAX package's value (chosen there for the
# TPU's tile padding), kept so that both packages sum each row in the same
# order.  On this card tools/exp_min_width.py found no crossover above it:
# width-1 gathers summed beat the one gather at every width it measured,
# 8 to 64 (0.72 against 0.91 ns a gathered row at width 8; NVIDIA H100
# 80GB HBM3, 700 W).  Raising the value is a question for the whole step.
COLSUM_MAX_WIDTH = 4


def _bucket_reduce(emb: torch.Tensor, idx: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """One ELL bucket's ``sum_j emb[idx[:, j]] * w[:, j]`` as f32 rows
    (f32 accumulation even when ``emb`` is stored in bf16: widths reach
    2048, where a bf16 sum loses about two digits)."""
    width = idx.shape[1]
    if width <= COLSUM_MAX_WIDTH:
        acc = None
        for j in range(width):
            t = (emb.index_select(0, idx[:, j]) * w[:, j, None]).float()
            acc = t if acc is None else acc + t
        return acc
    gathered = emb[idx]                                  # [nb, width, d]
    return (gathered * w[..., None]).sum(dim=1, dtype=torch.float32)


def _hub_rows(dense_mat: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """The hub rows ``dense_mat @ x`` in f32: one dense product replaces
    the power-law gather tail, with f32 accumulation as in the JAX
    package's ``preferred_element_type`` (bf16 x bf16 is exact in f32)."""
    with span("spmm.hub"):
        return torch.matmul(dense_mat.float(), x.to(dense_mat.dtype).float())


def _parts_matvec(x, bucket_idx, bucket_w, dense):
    """One propagation in parts order, ``[nrows, d]``: the bucket rows,
    the hub rows and one zeros row for degree-0 nodes, each part cast to
    ``x``'s dtype, without the restore gather.  ``x`` is node-ordered
    (with the node-space indices and hub matrix) or parts-ordered (with
    the composed views of ``to_device_graph(fuse_layers=True)``)."""
    if profiling.collecting():
        profiling.count(GATHERED_ROWS, sum(i.numel() for i in bucket_idx))
    parts = [_bucket_reduce(x, idx, w).to(x.dtype) for idx, w in zip(bucket_idx, bucket_w)]
    if dense.shape[0]:
        parts.append(_hub_rows(dense, x).to(x.dtype))
    parts.append(x.new_zeros((1, x.shape[1])))
    return torch.cat(parts, dim=0)


def _restore(parts, gather_idx):
    """Node order from parts order: the restore gather."""
    profiling.count(GATHERED_ROWS, gather_idx.shape[0])
    return parts.index_select(0, gather_idx)


def _ell_matvec(emb, bucket_nbr_idx, bucket_nbr_w, gather_idx, dense_mat):
    return _restore(_parts_matvec(emb, bucket_nbr_idx, bucket_nbr_w, dense_mat), gather_idx)


class _PropagateEll(torch.autograd.Function):
    @staticmethod
    def forward(ctx, emb, bucket_nbr_idx, bucket_nbr_w, gather_idx, dense_mat):
        ctx.graph = (bucket_nbr_idx, bucket_nbr_w, gather_idx, dense_mat)
        with span("spmm.forward"):
            return _ell_matvec(emb, bucket_nbr_idx, bucket_nbr_w, gather_idx, dense_mat)

    @staticmethod
    def backward(ctx, grad):
        # A_norm is symmetric: d(emb) = A_norm^T @ grad = A_norm @ grad
        with span("spmm.backward"):
            return (_ell_matvec(grad, *ctx.graph),) + (None,) * 4


def propagate_ell(
    emb: torch.Tensor,
    bucket_nbr_idx: Tuple[torch.Tensor, ...],
    bucket_nbr_w: Tuple[torch.Tensor, ...],
    gather_idx: torch.Tensor,
    dense_mat: torch.Tensor,
) -> torch.Tensor:
    """Scatter-free SpMM over the ELL adjacency plus dense hub rows,
    differentiable in ``emb``."""
    return _PropagateEll.apply(emb, bucket_nbr_idx, bucket_nbr_w, gather_idx, dense_mat)


# ---------------------------------------------------------------------------
# Merge-skip: all K layers with one restore gather
# ---------------------------------------------------------------------------
#
# Per-layer propagate_ell ends every pass with an [N]-row restore gather
# whose only consumer is the next layer's bucket gathers.  Composing the
# restore permutation into those gathers when the graph is shipped
# (idx_perm = gather_idx[nbr_idx], the hub columns moved the same way)
# lets layers 2..K read layer k-1's parts table directly: K layers need
# one restore gather instead of K, and, sum_k A^k being symmetric, the
# backward is the same sum on the cotangent (2 restore gathers in a
# 3-layer training step instead of 6).


def _sum_matvec(n_layers, ego, bucket_idx, bucket_w, idx_perm, gather_idx, dense_mat,
                dense_perm):
    """``sum_{k=1..K} A^k @ ego`` in f32: the parts tables in ``ego``'s
    dtype, their sum in f32, one restore gather at the end."""
    p = _parts_matvec(ego, bucket_idx, bucket_w, dense_mat)
    s = p.float()
    for _ in range(n_layers - 1):
        p = _parts_matvec(p, idx_perm, bucket_w, dense_perm)
        s = s + p.float()
    return _restore(s, gather_idx)


class _PropagateSumEll(torch.autograd.Function):
    @staticmethod
    def forward(ctx, n_layers, ego, bucket_idx, bucket_w, idx_perm, gather_idx, dense_mat,
                dense_perm):
        ctx.n_layers = n_layers
        ctx.dtype = ego.dtype
        ctx.graph = (bucket_idx, bucket_w, idx_perm, gather_idx, dense_mat, dense_perm)
        with span("spmm.forward"):
            return _sum_matvec(n_layers, ego, *ctx.graph)

    @staticmethod
    def backward(ctx, grad):
        # sum_k A^k is symmetric (A is): d(ego) is the same fused sum on the
        # cotangent, cast to the primal's storage dtype and handed back in it
        with span("spmm.backward"):
            d_ego = _sum_matvec(ctx.n_layers, grad.to(ctx.dtype), *ctx.graph)
            return (None, d_ego.to(ctx.dtype)) + (None,) * 6


def propagate_sum_ell(
    n_layers: int,
    ego: torch.Tensor,
    bucket_idx: Tuple[torch.Tensor, ...],
    bucket_w: Tuple[torch.Tensor, ...],
    idx_perm: Tuple[torch.Tensor, ...],
    gather_idx: torch.Tensor,
    dense_mat: torch.Tensor,
    dense_perm: torch.Tensor,
) -> torch.Tensor:
    """``sum_{k=1..K} A_norm^k @ ego`` in f32, whatever ``ego``'s dtype,
    scatter-free, with one restore gather in all; differentiable in
    ``ego``.  Callers form the LightGCN layer mean as ``(ego + result) /
    (K + 1)``."""
    return _PropagateSumEll.apply(
        n_layers, ego, bucket_idx, bucket_w, idx_perm, gather_idx, dense_mat, dense_perm)


def propagate(emb: torch.Tensor, graph, num_nodes: int, *, path: str = "ell"):
    """One propagation step ``A_norm @ emb``.  ``graph`` is a DeviceGraph
    (``path`` 'ell' or 'coo'), a ChunkedDeviceGraph (the source-chunked
    layout) or an ``ops/block_spmm.py`` TiledDeviceGraph; the last two
    always take their own path."""
    from gcn_recommendation_tpu_torch.ops.block_spmm import (
        TiledDeviceGraph,
        propagate_ell_tiles,
    )

    if isinstance(graph, TiledDeviceGraph):
        return propagate_ell_tiles(emb, graph.base, graph.tiles)
    if isinstance(graph, ChunkedDeviceGraph):
        return propagate_chunked(
            emb, graph.chunk_bucket_idx, graph.chunk_bucket_w, graph.chunk_gather_idx,
            graph.dense_mat, graph.dense_gather_idx,
        )
    if path == "ell":
        return propagate_ell(
            emb, graph.bucket_nbr_idx, graph.bucket_nbr_w, graph.gather_idx,
            graph.dense_mat,
        )
    if path == "coo":
        if graph.src.shape[0] == 0:
            raise ValueError(
                "COO view not on device — build with "
                "to_device_graph(..., include_coo=True)"
            )
        return propagate_coo(emb, graph.src, graph.dst, graph.weight, num_nodes)
    raise ValueError(f"unknown propagation path {path!r}")


# ---------------------------------------------------------------------------
# Source-chunked ELL: the large-graph layout
# ---------------------------------------------------------------------------

# The gather knee of this card, from tools/exp_gather_knee.py on an NVIDIA
# H100 80GB HBM3 at 700 W: random user-item graphs, 28 interactions a
# user, d = 64; the median ms of one propagation over three repeats in
# turns (the repeats within 0.5% of each other from 400k nodes on, 1.5% at
# 180k; 180k-400k from one run, 600k-2M from another):
#
#   nodes   f32 plain   C=2    C=3    C=4  |  bf16 plain   C=2    C=3    C=4
#   180k        7.66   7.78     -    9.02 |       7.05   7.23     -    8.48
#   400k       16.85  16.94     -   19.03 |      15.29  15.45     -   17.58
#   600k       25.08  25.02  25.73  28.08 |      22.69  22.78  23.55  25.92
#   800k       33.37  33.18  34.17  36.88 |      30.15  30.18  31.21  34.04
#   1M         41.68  41.41  42.58  45.73 |      37.59  37.59  38.84  42.08
#   1.4M       58.29  57.79  59.37  63.59 |      52.55  52.44  54.11  58.38
#   2M         83.13  82.38  84.60  90.32 |      74.91  74.68  76.98  82.86
#
# The rate per edge is flat (~1.07 ns an edge from 180k to 2M nodes): no
# knee like the TPU's, where it halves above 180k rows.  Two source chunks
# win in every repeat, by 0.2-0.9%, once the source table passes ~128 MB:
# f32 from 600k rows (400k: +0.5%), bf16 from 1.4M (1M: a tie), the same
# bytes; three or four chunks lose at every size.  Hence a bytes model
# anchored at 500k f32 d = 64 rows (128 MB), and two chunks at most.  The
# JAX package's 180_000 and its (8/16-sublane x 128-lane) tile model
# describe the TPU v5e's gather unit, not this card.
# None would mean no knee (num_chunks_for then always gives 1).
GATHER_KNEE_ROWS: Optional[int] = 500_000
MAX_GATHER_CHUNKS = 2


def knee_rows_for(embedding_dim: int = 64, compute_dtype: torch.dtype = torch.float32
                  ) -> Optional[int]:
    """The knee in rows of an ``embedding_dim``-wide ``compute_dtype``
    source table: ``GATHER_KNEE_ROWS`` scaled by the row's bytes against
    an f32 d = 64 row (the knee is a table size, ~128 MB); None without a
    knee."""
    if GATHER_KNEE_ROWS is None:
        return None
    row_bytes = int(embedding_dim) * torch.empty((), dtype=compute_dtype).element_size()
    return max(1, GATHER_KNEE_ROWS * 64 * 4 // row_bytes)


def num_chunks_for(num_nodes: int, embedding_dim: int = 64,
                   compute_dtype: torch.dtype = torch.float32) -> int:
    """Chunk count that keeps each source sub-table under the knee, at
    most ``MAX_GATHER_CHUNKS`` (1: don't chunk; always 1 without a knee)."""
    knee = knee_rows_for(embedding_dim, compute_dtype)
    if knee is None:
        return 1
    return max(1, min(MAX_GATHER_CHUNKS, -(-int(num_nodes) // knee)))


def to_device_graph_auto(
    g: Graph,
    compute_dtype: torch.dtype = torch.float32,
    dense_dtype: Optional[torch.dtype] = None,
    embedding_dim: int = 64,
    fuse_layers: bool = True,
    device: DeviceLike = None,
):
    """The plain or the source-chunked device graph by the knee rule (the
    JAX package's rule, over this card's ``num_chunks_for``).  The
    single-device entry points share it: ``test`` mode (fused, the
    default) and serving (``fuse_layers=False``: it propagates once, and
    the permuted views would hold the hub matrix twice)."""
    n_chunks = num_chunks_for(g.num_nodes, embedding_dim, compute_dtype)
    if n_chunks > 1:
        return to_device_chunked_graph(
            g, n_chunks, compute_dtype=compute_dtype, dense_dtype=dense_dtype, device=device)
    return to_device_graph(
        g, compute_dtype=compute_dtype, device=device, dense_dtype=dense_dtype,
        fuse_layers=fuse_layers)


@dataclasses.dataclass
class ChunkedDeviceGraph:
    """Device-resident source-chunked, destination-sliced adjacency
    (``graph/build.py::build_chunked_ell``).

    ``chunk_bucket_idx[c][t]`` holds the chunk-local neighbor ids of
    destination slice t; ``chunk_gather_idx[c][t]`` is slice-local.  The
    chunk and slice counts come from the nesting, the chunk span from the
    embedding's rows (``chunk_rows = ceil(N / C)``)."""

    chunk_bucket_idx: Tuple[Tuple[Tuple[torch.Tensor, ...], ...], ...]  # [C][S][bucket] int64
    chunk_bucket_w: Tuple[Tuple[Tuple[torch.Tensor, ...], ...], ...]
    chunk_gather_idx: Tuple[Tuple[torch.Tensor, ...], ...]  # [C][S] x [slice rows] int64
    dense_mat: torch.Tensor                                 # [H, num_nodes]
    dense_gather_idx: torch.Tensor                          # [num_nodes] -> H rows + zeros


def to_device_chunked_graph(
    g: Graph,
    num_chunks: int,
    compute_dtype: torch.dtype = torch.float32,
    dense_dtype: Optional[torch.dtype] = None,
    device: DeviceLike = None,
) -> ChunkedDeviceGraph:
    """Build the chunked layout on the host and ship it to ``device``."""
    with span("spmm.to_device"):
        dev = resolve_device(device)
        if dense_dtype is None:
            dense_dtype = compute_dtype
        per_cell_buckets, per_cell_gidx, dense_gidx = build_chunked_ell(g, num_chunks)

        def idx(a):
            return torch.as_tensor(a, dtype=torch.int64, device=dev)

        def val(a, dtype=compute_dtype):
            return torch.as_tensor(a, device=dev).to(dtype)

        return ChunkedDeviceGraph(
            chunk_bucket_idx=tuple(
                tuple(tuple(idx(b.nbr_idx) for b in buckets) for buckets in cell)
                for cell in per_cell_buckets),
            chunk_bucket_w=tuple(
                tuple(tuple(val(b.nbr_w) for b in buckets) for buckets in cell)
                for cell in per_cell_buckets),
            chunk_gather_idx=tuple(tuple(idx(gi) for gi in cell) for cell in per_cell_gidx),
            dense_mat=val(g.dense_mat, dense_dtype),
            dense_gather_idx=idx(dense_gidx),
        )


def _chunked_matvec(emb, chunk_bucket_idx, chunk_bucket_w, chunk_gather_idx, dense_mat,
                    dense_gather_idx):
    n, d = emb.shape
    c = len(chunk_gather_idx)
    s = len(chunk_gather_idx[0])
    chunk_rows = -(-n // c)
    pad = c * chunk_rows - n
    src = torch.cat([emb, emb.new_zeros((pad, d))]) if pad else emb

    # the cross-chunk and hub partial sums accumulate in f32 even in bf16
    # storage (a bf16 accumulator would round each row C+1 times), with one
    # cast at the end.  One accumulator per destination slice: each cell's
    # merge gather reads a parts table of at most slice_rows rows, and the
    # slices concatenate in node order.  A cell's [nb, width, d]
    # intermediates are freed as soon as its bucket is reduced.
    zeros_row = emb.new_zeros((1, d), dtype=torch.float32)
    slice_acc = [None] * s
    for ci in range(c):
        sub = src.narrow(0, ci * chunk_rows, chunk_rows)
        for ti in range(s):
            cell_idx = chunk_bucket_idx[ci][ti]
            if profiling.collecting():
                profiling.count(GATHERED_ROWS, sum(i.numel() for i in cell_idx))
            parts = [_bucket_reduce(sub, idx, w)
                     for idx, w in zip(cell_idx, chunk_bucket_w[ci][ti])]
            out_ct = _restore(torch.cat(parts + [zeros_row]), chunk_gather_idx[ci][ti])
            slice_acc[ti] = out_ct if slice_acc[ti] is None else slice_acc[ti] + out_ct
    acc = torch.cat(slice_acc) if s > 1 else slice_acc[0]
    if dense_mat.shape[0]:
        hub = torch.cat([_hub_rows(dense_mat, emb), zeros_row])
        acc = acc + _restore(hub, dense_gather_idx)
    return acc.to(emb.dtype)


class _PropagateChunked(torch.autograd.Function):
    @staticmethod
    def forward(ctx, emb, chunk_bucket_idx, chunk_bucket_w, chunk_gather_idx, dense_mat,
                dense_gather_idx):
        ctx.graph = (chunk_bucket_idx, chunk_bucket_w, chunk_gather_idx, dense_mat,
                     dense_gather_idx)
        with span("spmm.forward"):
            return _chunked_matvec(emb, *ctx.graph)

    @staticmethod
    def backward(ctx, grad):
        # A^T = A: the backward is the same chunked product on the cotangent
        with span("spmm.backward"):
            return (_chunked_matvec(grad, *ctx.graph),) + (None,) * 5


def propagate_chunked(
    emb: torch.Tensor,
    chunk_bucket_idx,
    chunk_bucket_w,
    chunk_gather_idx,
    dense_mat: torch.Tensor,
    dense_gather_idx: torch.Tensor,
) -> torch.Tensor:
    """Scatter-free ``A_norm @ emb`` over the source-chunked layout, in
    ``emb``'s dtype (f32 accumulation), differentiable in ``emb``."""
    return _PropagateChunked.apply(
        emb, chunk_bucket_idx, chunk_bucket_w, chunk_gather_idx, dense_mat, dense_gather_idx)
