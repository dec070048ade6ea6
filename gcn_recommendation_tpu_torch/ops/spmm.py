"""Sparse propagation ``A_norm @ emb``: the device graph kinds and their
one symmetric backward.

PyTorch counterpart of ``gcn_recommendation_tpu/ops/spmm.py``.  Each graph
kind owns its product, ``product(x)``, node order in and node order out;
``propagate(x, graph)`` is the one entry point and ``layer_mean`` the
LightGCN layer mean over any kind:

* ``DeviceGraph`` — the degree-bucketed ELL graph: per bucket a gather,
  multiply and reduce over the padded neighbor axis, the hub rows as one
  dense matrix product, a zeros row for degree-0 nodes, and one gather
  restoring node order.  The JAX package leaves these to XLA, not to a
  Pallas kernel.  On a card every bucket of a parts table is one launch of
  the port's own kernel, ``csrc/ell_spmm.cu`` (``ell_spmm``): the gathered
  rows stay in registers; a CPU tensor takes the plain version,
  ``_bucket_reduce`` per bucket.  Built with
  ``fuse_layers=True`` (the default) it also carries the permuted views of
  merge-skip, and ``layer_sum`` runs ``sum_{k=1..K} A_norm^k @ ego`` with
  one restore gather for all K layers: what the default ``Trainer`` and
  ``test`` mode run.
* ``ChunkedDeviceGraph`` — the source-chunked, destination-sliced layout
  (``to_device_chunked_graph``), which ``to_device_graph_auto`` picks
  above this card's gather knee (``GATHER_KNEE_ROWS``).
* ``ops/block_spmm.py::TiledDeviceGraph`` (the tile partition) and
  ``parallel/spmd.py::ShardedGraph`` (one rank's rows) are kinds too.
* ``CooGraph`` — ``index_add_`` over the dst-sorted COO list; the in-port
  oracle.  Its backward is autograd's own scatter through the gathers, the
  independent check on the symmetric one.

``A_norm`` is symmetric, and so is ``sum_k A_norm^k``: every kind but the
oracle propagates through ``_SymmetricProduct``, whose backward is the same
product applied to the cotangent, never autograd's ``index_add_``.

Index arrays are converted to int64 once, when a graph is shipped:
``index_select`` and ``index_add_`` take int64 indices, and the kernel
reads them where they lie, through each parts table's descriptor
(``BucketTable``, built with the graph).

Spans (``utils/profiling.py``): ``spmm.forward`` / ``spmm.backward``
around each propagation of ``_SymmetricProduct``, ``spmm.hub`` around
each hub-row product, ``spmm.to_device`` around a graph's layout and
upload; the counter ``spmm.gathered_rows`` counts the embedding rows a
propagation gathers (ELL slots, padding included, and restore gathers),
``spmm.kernel_slots`` the ELL slots the kernel reduced (0 on the CPU).
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Optional, Tuple

import numpy as np
import torch

from gcn_recommendation_tpu_torch.core.device import DeviceLike, resolve_device
from gcn_recommendation_tpu_torch.graph.build import Graph, build_chunked_ell
from gcn_recommendation_tpu_torch.utils import profiling
from gcn_recommendation_tpu_torch.utils.profiling import span

GATHERED_ROWS = "spmm.gathered_rows"
KERNEL_SLOTS = "spmm.kernel_slots"


class _SymmetricProduct(torch.autograd.Function):
    """``product(x)`` for a symmetric linear ``product``: the backward is
    the same product on the cotangent, cast to ``x``'s dtype and handed
    back in it (casts that do nothing unless the product's output dtype
    is not ``x``'s, as in merge-skip's f32 sum over bf16 storage)."""

    @staticmethod
    def forward(ctx, x, product):
        ctx.product, ctx.dtype = product, x.dtype
        with span("spmm.forward"):
            return product(x)

    @staticmethod
    def backward(ctx, grad):
        with span("spmm.backward"):
            return ctx.product(grad.to(ctx.dtype)).to(ctx.dtype), None


class SymmetricGraph:
    """Base of the graph kinds whose ``product(x)`` applies the symmetric
    ``A_norm``: ``propagate`` differentiates it by the product itself."""

    # True on a DeviceGraph that carries the merge-skip views
    fused = False

    def propagate(self, x: torch.Tensor) -> torch.Tensor:
        return _SymmetricProduct.apply(x, self.product)


def propagate(x: torch.Tensor, graph) -> torch.Tensor:
    """One propagation step ``A_norm @ x`` over any graph kind, in ``x``'s
    dtype, differentiable in ``x``."""
    return graph.propagate(x)


def layer_mean(ego: torch.Tensor, graph, n_layers: int,
               compute_dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """The LightGCN layer mean of ``ego, A ego, ..., A^K ego``: the layers
    propagated in ``compute_dtype``, their mean taken in f32 and returned
    in ``ego``'s dtype.  A graph with the merge-skip views (``fused``) at
    K >= 2 takes one ``layer_sum``, as in the JAX package; any other
    graph a running f32 sum of K ``propagate`` calls."""
    if n_layers >= 2 and graph.fused:
        s = graph.layer_sum(ego.to(compute_dtype), n_layers)
        return ((ego.float() + s) / (n_layers + 1)).to(ego.dtype)
    acc = ego.float()
    x = ego.to(compute_dtype)
    for _ in range(n_layers):
        x = propagate(x, graph)
        acc = acc + x.float()
    return (acc / (n_layers + 1)).to(ego.dtype)


def _idx(a, dev) -> torch.Tensor:
    return torch.as_tensor(a, dtype=torch.int64, device=dev)


def _val(a, dtype, dev) -> torch.Tensor:
    return torch.as_tensor(a, device=dev).to(dtype)


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


def _hub_rows(dense_mat: torch.Tensor, x: torch.Tensor,
              out: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The hub rows ``dense_mat @ x`` in f32: one dense product replaces
    the power-law gather tail, with f32 accumulation as in the JAX
    package's ``preferred_element_type`` (bf16 x bf16 is exact in f32).
    With ``out`` (rows of a parts table) they are written there, in its
    dtype."""
    with span("spmm.hub"):
        a, b = dense_mat.float(), x.to(dense_mat.dtype).float()
        if out is None:
            return torch.matmul(a, b)
        if out.dtype == torch.float32:
            return torch.matmul(a, b, out=out)
        return out.copy_(torch.matmul(a, b))


# Rows at least this wide are split over the kernel's eight lane groups
# (one row a block, eight contiguous slices added in slice order); a
# narrower row takes one lane group, eight rows a block.  From 1024 on a
# slice holds 128 slots or more; the north-star graph's widest rows
# (16,384 slots) would otherwise hold one lane group for 2,048 rounds of
# dependent gathers while the rest of the card has finished.
SPLIT_MIN_WIDTH = 1024
GROUPS_PER_BLOCK = 8  # csrc/ell_spmm.cu's kGroups


def describe_buckets(widths, rows, zeros_row_at: Optional[int] = None
                     ) -> Tuple[np.ndarray, int]:
    """The descriptor of one parts table's buckets, in the order the kernel
    issues them, and the blocks of the launch: ``[entries, 6]`` int64 rows
    of (bucket, first block, first output row, rows, width, wide).  Bucket
    b's output rows follow bucket b-1's; the entries go widest first (equal
    widths in bucket order), a bucket without rows has none, and
    ``zeros_row_at`` adds one row of zeros there (bucket -1, width 0) last.
    ``wide`` entries take one block a row, the others ``GROUPS_PER_BLOCK``
    rows a block."""
    rows = [int(r) for r in rows]
    starts = np.concatenate([[0], np.cumsum(rows)[:-1]]).astype(np.int64) if rows else []
    order = sorted((b for b in range(len(rows)) if rows[b]), key=lambda b: -int(widths[b]))
    entries = [(b, int(starts[b]), rows[b], int(widths[b])) for b in order]
    if zeros_row_at is not None:
        entries.append((-1, int(zeros_row_at), 1, 0))
    out = np.zeros((len(entries), 6), np.int64)
    block = 0
    for i, (b, row0, nb, width) in enumerate(entries):
        wide = width >= SPLIT_MIN_WIDTH
        out[i] = (b, block, row0, nb, width, wide)
        block += nb if wide else -(-nb // GROUPS_PER_BLOCK)
    return out, block


class BucketTable:
    """The ELL buckets of one parts table, laid out ``[bucket rows | hub
    rows | zeros row]``, and their descriptor for one launch of
    ``csrc/ell_spmm.cu``: built once, when a graph is shipped.  The
    descriptor (``[entries, 8]`` int64 on the buckets' device: first block,
    first output row, rows, width, the ids' and the weights' addresses,
    wide, 0) points at the ids and weights where they lie; the table holds
    those tensors, so their memory outlives every launch."""

    def __init__(self, idx, w, device: torch.device, hub_rows: int = 0,
                 zeros_row: bool = True):
        self.idx = tuple(i.to(torch.int64).contiguous() for i in idx)
        self.w = tuple(v.contiguous() for v in w)
        rows = [int(i.shape[0]) for i in self.idx]
        self.bucket_rows = sum(rows)
        self.hub_rows = int(hub_rows)
        self.zeros_row = bool(zeros_row)
        self.rows = self.bucket_rows + self.hub_rows + int(self.zeros_row)
        self.slots = sum(int(i.numel()) for i in self.idx)
        self.w_dtype = self.w[0].dtype if self.w else torch.float32
        desc, self.n_blocks = describe_buckets(
            [int(i.shape[1]) for i in self.idx], rows,
            self.bucket_rows + self.hub_rows if zeros_row else None)
        table = np.zeros((desc.shape[0], 8), np.int64)
        table[:, :4] = desc[:, 1:5]
        table[:, 6] = desc[:, 5]
        for e, b in enumerate(desc[:, 0]):
            if b >= 0:
                table[e, 4] = self.idx[b].data_ptr()
                table[e, 5] = self.w[b].data_ptr()
        self.n_entries = int(table.shape[0])
        self.table = torch.as_tensor(table, device=device)


# the launcher of csrc/ell_spmm.cu and the stream lookup, set at the first launch
_ell_launcher = None
_raw_stream = None


def _launch_ell_spmm(*args, device: torch.device) -> None:
    global _ell_launcher, _raw_stream
    if _ell_launcher is None:
        from gcn_recommendation_tpu_torch.kernels._build import load_library

        _raw_stream = getattr(torch._C, "_cuda_getCurrentRawStream", None) or (
            lambda index: torch.cuda.current_stream(index).cuda_stream)
        _ell_launcher = load_library("ell_spmm").ell_spmm_launch
    index = device.index
    if index == torch.cuda.current_device():
        err = _ell_launcher(*args, _raw_stream(index))
    else:
        with torch.cuda.device(index):
            err = _ell_launcher(*args, _raw_stream(index))
    if err != 0:
        raise RuntimeError(f"ELL kernel launch failed: CUDA error {err}")


def ell_spmm(x: torch.Tensor, buckets: BucketTable,
             dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """``buckets``' parts table over ``x`` [n, d] as ``[buckets.rows, d]``
    in ``dtype`` (default ``x``'s): every bucket row and the zeros row by
    one launch of ``csrc/ell_spmm.cu``, the hub rows left for the caller to
    write.  A CUDA tensor only: it launches or raises."""
    dtype = x.dtype if dtype is None else dtype
    if x.device.type != "cuda":
        raise ValueError(f"the ELL kernel runs on a CUDA device, not {x.device}")
    if x.dim() != 2 or x.dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"the ELL kernel takes a 2-D float32 or bfloat16 table, got "
                         f"{x.dtype} {tuple(x.shape)}")
    if dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"the ELL kernel writes float32 or bfloat16, not {dtype}")
    if buckets.w_dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"the ELL kernel takes float32 or bfloat16 weights, not "
                         f"{buckets.w_dtype}")
    if buckets.table.device != x.device:
        raise ValueError(f"buckets on {buckets.table.device}, table on {x.device}")
    n, d = x.shape
    if n >= 2**31:
        raise ValueError(f"the ELL kernel takes fewer than 2^31 source rows, got {n}")
    # the kernel reads rows as groups of 4: other widths get zero columns in a
    # scratch copy, sliced off the output
    dk = -(-d // 4) * 4
    x = x.contiguous()
    if dk != d:
        x = torch.nn.functional.pad(x, (0, dk - d))
    if x.data_ptr() % 16:
        x = x.clone()
    out = torch.empty((buckets.rows, dk), dtype=dtype, device=x.device)
    if buckets.n_entries and d:
        _launch_ell_spmm(buckets.table.data_ptr(), buckets.n_entries, buckets.n_blocks,
                         x.data_ptr(), int(x.dtype == torch.bfloat16),
                         int(buckets.w_dtype == torch.bfloat16), n, dk, out.data_ptr(),
                         int(dtype == torch.bfloat16), device=x.device)
        ell_spmm.launches += 1
        profiling.count(KERNEL_SLOTS, buckets.slots)
    return out if dk == d else out[:, :d].contiguous()


# kernel launches since the last reset (tests and the chip smoke test read it)
ell_spmm.launches = 0


def _parts_plain(x, buckets: BucketTable, dense=None, dtype=None) -> torch.Tensor:
    """The plain version of ``_parts_matvec``: ``_bucket_reduce`` bucket by
    bucket, the hub rows, the zeros row, one ``torch.cat``."""
    dtype = x.dtype if dtype is None else dtype
    parts = [_bucket_reduce(x, idx, w).to(dtype) for idx, w in zip(buckets.idx, buckets.w)]
    if buckets.hub_rows:
        parts.append(_hub_rows(dense, x).to(dtype))
    if buckets.zeros_row:
        parts.append(x.new_zeros((1, x.shape[1]), dtype=dtype))
    return torch.cat(parts, dim=0) if parts else x.new_zeros((0, x.shape[1]), dtype=dtype)


def _parts_matvec(x, buckets: BucketTable, dense=None, dtype=None) -> torch.Tensor:
    """One propagation in parts order, ``[buckets.rows, d]`` in ``dtype``
    (default ``x``'s): the bucket rows, ``dense @ x`` in the hub rows and
    the zeros row, without the restore gather.  ``x`` is node-ordered (with
    the node-space ids and hub matrix) or parts-ordered (with the composed
    views of ``to_device_graph(fuse_layers=True)``).  A CUDA tensor takes
    the kernel (it launches or raises), a CPU tensor the plain version."""
    profiling.count(GATHERED_ROWS, buckets.slots)
    if x.device.type == "cuda":
        parts = ell_spmm(x, buckets, dtype)
        if buckets.hub_rows:
            _hub_rows(dense, x, out=parts.narrow(0, buckets.bucket_rows, buckets.hub_rows))
        return parts
    if x.device.type == "cpu":
        return _parts_plain(x, buckets, dense, dtype)
    raise ValueError(f"propagation: unsupported device {x.device}")


def _restore(parts, gather_idx):
    """Node order from parts order: the restore gather."""
    profiling.count(GATHERED_ROWS, gather_idx.shape[0])
    return parts.index_select(0, gather_idx)


def _ell_matvec(emb, buckets: BucketTable, gather_idx, dense_mat):
    """``A_norm @ emb`` over ELL buckets (a ``DeviceGraph``'s, or one halo
    shard's in ``parallel/halo.py``), in ``emb``'s dtype."""
    return _restore(_parts_matvec(emb, buckets, dense_mat), gather_idx)


@dataclasses.dataclass
class DeviceGraph(SymmetricGraph):
    """Device-resident ELL adjacency plus dense hub rows.

    The two ``*_perm`` fields are the permuted-space views that let
    multi-layer propagation skip the per-layer restore gather
    (``layer_sum``): neighbor ids composed with ``gather_idx``, so that
    layer k >= 2 gathers straight from layer k-1's bucket-concat output,
    and the hub matrix with its columns moved into that parts order.
    Empty unless built with ``fuse_layers=True``."""

    bucket_nbr_idx: Tuple[torch.Tensor, ...]   # per bucket [nb, width] int64
    bucket_nbr_w: Tuple[torch.Tensor, ...]     # per bucket [nb, width]
    gather_idx: torch.Tensor                   # [num_nodes] int64 into
                                               # concat(buckets, hub rows, zeros row)
    dense_mat: torch.Tensor                    # [H, num_nodes] hub rows
    bucket_nbr_idx_perm: Tuple[torch.Tensor, ...] = ()  # gather_idx[nbr_idx], int64
    dense_mat_perm: Optional[torch.Tensor] = None       # [H, nrows], columns in parts order
    # the parts tables' descriptors, node-space and merge-skip ids (built here)
    buckets: BucketTable = dataclasses.field(init=False, repr=False, compare=False)
    buckets_perm: Optional[BucketTable] = dataclasses.field(init=False, repr=False,
                                                            compare=False)

    def __post_init__(self):
        dev, h = self.gather_idx.device, int(self.dense_mat.shape[0])
        self.buckets = BucketTable(self.bucket_nbr_idx, self.bucket_nbr_w, dev, h)
        self.buckets_perm = (BucketTable(self.bucket_nbr_idx_perm, self.bucket_nbr_w, dev, h)
                             if self.fused else None)

    @property
    def fused(self) -> bool:
        """True when the permuted views of ``layer_sum`` are here."""
        return (len(self.bucket_nbr_idx_perm) == len(self.bucket_nbr_idx)
                and self.dense_mat_perm is not None)

    def product(self, x: torch.Tensor) -> torch.Tensor:
        return _ell_matvec(x, self.buckets, self.gather_idx, self.dense_mat)

    # Merge-skip.  Per-layer propagation ends every pass with an [N]-row
    # restore gather whose only consumer is the next layer's bucket
    # gathers.  Composing the restore permutation into those gathers when
    # the graph is shipped (idx_perm = gather_idx[nbr_idx], the hub columns
    # moved the same way) lets layers 2..K read layer k-1's parts table
    # directly: K layers need one restore gather instead of K, and, sum_k
    # A^k being symmetric, the backward is the same sum on the cotangent
    # (2 restore gathers in a 3-layer training step instead of 6).

    def _sum_product(self, n_layers: int, ego: torch.Tensor) -> torch.Tensor:
        """``sum_{k=1..K} A^k @ ego`` in f32: the parts tables in ``ego``'s
        dtype, their sum in f32, one restore gather at the end."""
        p = _parts_matvec(ego, self.buckets, self.dense_mat)
        s = p.float()
        for _ in range(n_layers - 1):
            p = _parts_matvec(p, self.buckets_perm, self.dense_mat_perm)
            s = s + p.float()
        return _restore(s, self.gather_idx)

    def layer_sum(self, ego: torch.Tensor, n_layers: int) -> torch.Tensor:
        """``sum_{k=1..K} A_norm^k @ ego`` in f32, whatever ``ego``'s dtype,
        through the merge-skip views; differentiable in ``ego`` (the
        gradient in ``ego``'s dtype)."""
        return _SymmetricProduct.apply(ego, functools.partial(self._sum_product, n_layers))


def to_device_graph(
    g: Graph,
    compute_dtype: torch.dtype = torch.float32,
    device: DeviceLike = None,
    dense_dtype: Optional[torch.dtype] = None,
    fuse_layers: bool = True,
) -> DeviceGraph:
    """Ship the ELL view to ``device`` with weights in ``compute_dtype``
    and the hub matrix in ``dense_dtype`` (default: ``compute_dtype``).

    ``fuse_layers`` (the JAX package's default) adds the permuted views of
    merge-skip: the hub matrix is then resident twice (0.50 GB more for
    the books bundle's 1,748 x 72,001 f32 hub rows), the composed neighbor
    ids once more.  Callers that propagate once or shard the graph pass
    ``fuse_layers=False``."""
    with span("spmm.to_device"):
        dev = resolve_device(device)
        if dense_dtype is None:
            dense_dtype = compute_dtype

        idx_perm, dense_perm = (), None
        if fuse_layers:
            # neighbor ids composed into parts order, on the host
            gi = np.asarray(g.gather_idx, np.int64)
            idx_perm = tuple(_idx(gi[b.nbr_idx], dev) for b in g.buckets)
            h = g.dense_mat.shape[0]
            nrows = sum(b.nbr_idx.shape[0] for b in g.buckets) + h + 1
            dp = np.zeros((h, nrows), g.dense_mat.dtype)
            # column v of the node-space hub matrix lands at parts position
            # gather_idx[v]; degree-0 nodes share the trailing zeros position,
            # but their columns are all zero (no edges), so the collision is
            # harmless (the last write wins over zeros)
            dp[:, gi] = g.dense_mat
            dense_perm = _val(dp, dense_dtype, dev)

        return DeviceGraph(
            bucket_nbr_idx=tuple(_idx(b.nbr_idx, dev) for b in g.buckets),
            bucket_nbr_w=tuple(_val(b.nbr_w, compute_dtype, dev) for b in g.buckets),
            gather_idx=_idx(g.gather_idx, dev),
            dense_mat=_val(g.dense_mat, dense_dtype, dev),
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


@dataclasses.dataclass
class CooGraph:
    """The dst-sorted COO list on the device (~20 bytes an edge): the
    in-port oracle of the other kinds.  It propagates through autograd's
    own ``index_add_`` backward, not ``_SymmetricProduct``."""

    src: torch.Tensor      # [nnz_pad] int64
    dst: torch.Tensor      # [nnz_pad] int64
    weight: torch.Tensor   # [nnz_pad] compute dtype
    num_nodes: int

    fused = False  # no merge-skip views: layer_mean runs it layer by layer

    def product(self, x: torch.Tensor) -> torch.Tensor:
        return propagate_coo(x, self.src, self.dst, self.weight, self.num_nodes)

    propagate = product


def to_device_coo_graph(g: Graph, compute_dtype: torch.dtype = torch.float32,
                        device: DeviceLike = None) -> CooGraph:
    """Ship the COO view of ``g`` to ``device``, weights in ``compute_dtype``."""
    with span("spmm.to_device"):
        dev = resolve_device(device)
        return CooGraph(src=_idx(g.src, dev), dst=_idx(g.dst, dev),
                        weight=_val(g.weight, compute_dtype, dev), num_nodes=g.num_nodes)


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
    JAX package's rule, over this card's ``num_chunks_for``).  Every
    single-device entry point takes it: the ``Trainer`` (below the knee
    after its tile partition), ``test`` mode (fused, the default) and
    serving (``fuse_layers=False``: it propagates once, and the permuted
    views would hold the hub matrix twice)."""
    n_chunks = num_chunks_for(g.num_nodes, embedding_dim, compute_dtype)
    if n_chunks > 1:
        return to_device_chunked_graph(
            g, n_chunks, compute_dtype=compute_dtype, dense_dtype=dense_dtype, device=device)
    return to_device_graph(
        g, compute_dtype=compute_dtype, device=device, dense_dtype=dense_dtype,
        fuse_layers=fuse_layers)


@dataclasses.dataclass
class ChunkedDeviceGraph(SymmetricGraph):
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
    # each cell's parts table [bucket rows | zeros row] (built here)
    cell_buckets: Tuple[Tuple[BucketTable, ...], ...] = dataclasses.field(
        init=False, repr=False, compare=False)

    def __post_init__(self):
        self.cell_buckets = tuple(
            tuple(BucketTable(idx, w, gi.device) for idx, w, gi in zip(*cells))
            for cells in zip(self.chunk_bucket_idx, self.chunk_bucket_w, self.chunk_gather_idx))

    @property
    def num_chunks(self) -> int:
        return len(self.chunk_gather_idx)

    def product(self, emb: torch.Tensor) -> torch.Tensor:
        """``A_norm @ emb`` in ``emb``'s dtype (f32 accumulation)."""
        n, d = emb.shape
        c = self.num_chunks
        s = len(self.chunk_gather_idx[0])
        chunk_rows = -(-n // c)
        pad = c * chunk_rows - n
        src = torch.cat([emb, emb.new_zeros((pad, d))]) if pad else emb

        # the cross-chunk and hub partial sums accumulate in f32 even in bf16
        # storage (a bf16 accumulator would round each row C+1 times), with one
        # cast at the end.  One accumulator per destination slice: each cell's
        # merge gather reads a parts table of at most slice_rows rows (f32,
        # one kernel launch on a card), and the slices concatenate in node
        # order.
        slice_acc = [None] * s
        for ci in range(c):
            sub = src.narrow(0, ci * chunk_rows, chunk_rows)
            for ti in range(s):
                parts = _parts_matvec(sub, self.cell_buckets[ci][ti], dtype=torch.float32)
                out_ct = _restore(parts, self.chunk_gather_idx[ci][ti])
                slice_acc[ti] = out_ct if slice_acc[ti] is None else slice_acc[ti] + out_ct
        acc = torch.cat(slice_acc) if s > 1 else slice_acc[0]
        if self.dense_mat.shape[0]:
            hub = torch.cat([_hub_rows(self.dense_mat, emb),
                             emb.new_zeros((1, d), dtype=torch.float32)])
            acc = acc + _restore(hub, self.dense_gather_idx)
        return acc.to(emb.dtype)


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
        return ChunkedDeviceGraph(
            chunk_bucket_idx=tuple(
                tuple(tuple(_idx(b.nbr_idx, dev) for b in buckets) for buckets in cell)
                for cell in per_cell_buckets),
            chunk_bucket_w=tuple(
                tuple(tuple(_val(b.nbr_w, compute_dtype, dev) for b in buckets)
                      for buckets in cell)
                for cell in per_cell_buckets),
            chunk_gather_idx=tuple(tuple(_idx(gi, dev) for gi in cell) for cell in per_cell_gidx),
            dense_mat=_val(g.dense_mat, dense_dtype, dev),
            dense_gather_idx=_idx(dense_gidx, dev),
        )
