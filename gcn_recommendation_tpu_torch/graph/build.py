"""Heterogeneous graph construction and symmetric normalization (host ETL).

A numpy copy of ``gcn_recommendation_tpu/graph/build.py`` (the port
imports nothing from the JAX package).  Semantics of the reference
(main.py:282-336):

* node id layout ``[users | items | brands]``;
* user-item edges both directions; item-brand edges both directions only
  when ``use_brand`` (brand nodes are allocated either way);
* duplicate (row, col) pairs are summed, like scipy's ``coo_matrix``;
* normalization ``D^-1/2 A D^-1/2`` with isolated nodes scaled by 0.

Two views of the normalized adjacency: a dst-sorted COO (the reference
path) and a degree-bucketed ELL view plus dense hub rows (the
propagation path, ops/spmm.py), and the source-chunked ELL view of
large graphs (``build_chunked_ell``).  The dedup, normalization and sort
run in the native C++ library (``data/native_ext.py``) when it loads, in
numpy otherwise, as in the JAX package.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Tuple

import numpy as np

__all__ = [
    "Graph", "build_normalized_adjacency", "normalize_sym", "bucket_by_degree",
    "pad_graph_nodes", "pad_ell_rows", "build_chunked_ell",
]


def default_width_schedule(deg: int) -> int:
    """ELL bucket width for a node of degree ``deg``: 1/2/4 for degrees
    <= 4, then multiples of 8 up to 64, of 32 up to 256, of 128 up to
    1024, powers of two beyond (bounds padding waste at ~10% with few
    buckets)."""
    if deg <= 2:
        return max(1, deg)
    if deg <= 4:
        return 4
    if deg <= 64:
        return -(-deg // 8) * 8
    if deg <= 256:
        return -(-deg // 32) * 32
    if deg <= 1024:
        return -(-deg // 128) * 128
    w = 2048
    while w < deg:
        w *= 2
    return w


def width_schedule_vec(deg: np.ndarray) -> np.ndarray:
    """Vectorized ``default_width_schedule`` over a degree array."""
    width_class = np.zeros(deg.shape[0], dtype=np.int64)
    m = deg > 0
    width_class[m] = ((deg[m] + 7) // 8) * 8
    width_class[deg == 1] = 1
    width_class[deg == 2] = 2
    width_class[(deg == 3) | (deg == 4)] = 4
    m = deg > 64
    width_class[m] = ((deg[m] + 31) // 32) * 32
    m = deg > 256
    width_class[m] = ((deg[m] + 127) // 128) * 128
    m = deg > 1024
    if m.any():
        width_class[m] = np.power(
            2, np.ceil(np.log2(deg[m].astype(np.float64)))
        ).astype(np.int64).clip(2048, None)
    return width_class


@dataclasses.dataclass
class EllBucket:
    """One degree bucket of the ELL view: ``nbr_idx[i, j]`` is the j-th
    neighbor of the i-th node (0-padded), ``nbr_w`` its normalized edge
    weight (0 on padding)."""

    node_ids: np.ndarray  # [nb] int32 — global node ids, ascending
    nbr_idx: np.ndarray   # [nb, width] int32
    nbr_w: np.ndarray     # [nb, width] float32
    width: int


@dataclasses.dataclass
class Graph:
    """Normalized symmetric adjacency over users+items+brands."""

    num_users: int
    num_items: int
    num_brands: int
    nnz: int  # true (deduplicated) edge-entry count

    # Sorted-COO view (dst-major, then src), padded to pad_multiple.
    src: np.ndarray      # [nnz_pad] int32
    dst: np.ndarray      # [nnz_pad] int32
    weight: np.ndarray   # [nnz_pad] float32 (0 on padding)
    row_ptr: np.ndarray  # [num_nodes + 1] int64 CSR offsets by dst row

    # Degree-bucketed ELL view + dense hub rows.
    buckets: List[EllBucket]
    gather_idx: np.ndarray      # [num_nodes] int32 — row of each node in
                                # concat(bucket rows, hub rows, zeros row)
    dense_node_ids: np.ndarray  # [H] int32 hub nodes
    dense_mat: np.ndarray       # [H, num_nodes] f32 normalized hub rows

    @property
    def num_nodes(self) -> int:
        return self.num_users + self.num_items + self.num_brands

    @property
    def nnz_padded(self) -> int:
        return int(self.src.shape[0])


def normalize_sym(
    rows: np.ndarray, cols: np.ndarray, vals: np.ndarray, num_nodes: int
) -> np.ndarray:
    """Per-entry weights of ``D^-1/2 A D^-1/2`` for deduplicated entries
    (main.py:326-331: isolated nodes' ``inf`` scale becomes 0)."""
    deg = np.zeros(num_nodes, dtype=np.float64)
    np.add.at(deg, rows, vals)
    with np.errstate(divide="ignore"):
        d_inv_sqrt = np.power(deg, -0.5)
    d_inv_sqrt[np.isinf(d_inv_sqrt)] = 0.0
    return (vals * d_inv_sqrt[rows] * d_inv_sqrt[cols]).astype(np.float32)


def _dedup_sum(
    rows: np.ndarray, cols: np.ndarray, num_nodes: int
) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Sum duplicate (row, col) entries; returns (rows, cols, vals)
    sorted by (row, col)."""
    key = rows.astype(np.int64) * num_nodes + cols.astype(np.int64)
    order = np.argsort(key, kind="stable")
    key_sorted = key[order]
    uniq_mask = np.empty(len(key_sorted), dtype=bool)
    if len(key_sorted):
        uniq_mask[0] = True
        np.not_equal(key_sorted[1:], key_sorted[:-1], out=uniq_mask[1:])
    uniq_pos = np.flatnonzero(uniq_mask)
    seg_id = np.cumsum(uniq_mask) - 1
    vals = np.bincount(seg_id, minlength=len(uniq_pos)).astype(np.float32)
    uniq_key = key_sorted[uniq_pos]
    out_rows = (uniq_key // num_nodes).astype(np.int64)
    out_cols = (uniq_key % num_nodes).astype(np.int64)
    return out_rows, out_cols, vals


def bucket_by_degree(
    dst_sorted: np.ndarray,
    src_sorted: np.ndarray,
    w_sorted: np.ndarray,
    num_nodes: int,
    dense_threshold: Optional[int] = None,
    max_dense_bytes: int = 512 * 1024 * 1024,
    num_src_nodes: Optional[int] = None,
) -> Tuple[List[EllBucket], np.ndarray, np.ndarray, np.ndarray]:
    """Degree-bucketed ELL view (+ dense hub rows) from dst-sorted edges.

    Nodes of degree > ``dense_threshold`` (default 128) become rows of a
    dense ``[H, num_src_nodes]`` f32 matrix, aggregated by one matrix
    product; the threshold is raised until that matrix fits
    ``max_dense_bytes``.  ``num_src_nodes`` (default ``num_nodes``) is the
    source id space: a shard's rows over the whole graph's columns
    (``parallel/halo.py::shard_ell``).
    Returns (buckets, gather_idx, dense_node_ids, dense_mat).
    """
    if num_src_nodes is None:
        num_src_nodes = num_nodes
    deg = np.bincount(dst_sorted, minlength=num_nodes).astype(np.int64)
    row_start = np.zeros(num_nodes + 1, dtype=np.int64)
    np.cumsum(deg, out=row_start[1:])

    if dense_threshold is None:
        dense_threshold = 128
    while True:
        hub_mask = deg > dense_threshold
        if (
            hub_mask.sum() * num_src_nodes * 4 <= max_dense_bytes
            or dense_threshold >= max(int(deg.max()), 1)
        ):
            break
        # a caller-provided threshold <= 0 would never grow by doubling
        dense_threshold = dense_threshold * 2 if dense_threshold > 0 else 1
    dense_node_ids = np.flatnonzero(hub_mask).astype(np.int64)
    h = len(dense_node_ids)
    dense_mat = np.zeros((h, num_src_nodes), dtype=np.float32)
    if h:
        lengths = deg[dense_node_ids]
        starts = row_start[dense_node_ids]
        flat_rows = np.repeat(np.arange(h), lengths)
        flat_edge = np.concatenate(
            [np.arange(s, s + l) for s, l in zip(starts, lengths)]
        )
        # np.add.at so duplicate (dst, src) pairs accumulate like the ELL
        # path, which gives each duplicate its own slot
        np.add.at(dense_mat, (flat_rows, src_sorted[flat_edge]), w_sorted[flat_edge])

    width_class = width_schedule_vec(deg)
    buckets: List[EllBucket] = []
    gather_idx = np.full(num_nodes, -1, dtype=np.int64)
    n_out_rows = 0

    active = (deg > 0) & ~hub_mask
    for width in np.sort(np.unique(width_class[active])):
        node_ids = np.flatnonzero(active & (width_class == width)).astype(np.int64)
        nb = len(node_ids)
        w = int(width)
        nbr_idx = np.zeros((nb, w), dtype=np.int32)
        nbr_w = np.zeros((nb, w), dtype=np.float32)
        lengths = deg[node_ids]
        starts = row_start[node_ids]
        total = int(lengths.sum())
        flat_rows = np.repeat(np.arange(nb), lengths)
        row_offsets = np.cumsum(lengths) - lengths
        flat_cols = np.arange(total) - np.repeat(row_offsets, lengths)
        flat_edge = np.repeat(starts, lengths) + flat_cols
        nbr_idx[flat_rows, flat_cols] = src_sorted[flat_edge]
        nbr_w[flat_rows, flat_cols] = w_sorted[flat_edge]
        gather_idx[node_ids] = n_out_rows + np.arange(nb)
        n_out_rows += nb
        buckets.append(
            EllBucket(node_ids=node_ids.astype(np.int32), nbr_idx=nbr_idx, nbr_w=nbr_w, width=w)
        )

    # hub rows follow the bucket rows; degree-0 nodes read the zeros row
    if h:
        gather_idx[dense_node_ids] = n_out_rows + np.arange(h)
    gather_idx[gather_idx < 0] = n_out_rows + h
    return buckets, gather_idx.astype(np.int32), dense_node_ids.astype(np.int32), dense_mat


def build_normalized_adjacency(
    user_idx: np.ndarray,
    item_idx: np.ndarray,
    num_users: int,
    num_items: int,
    num_brands: int,
    item_brand_item_idx: Optional[np.ndarray] = None,
    item_brand_brand_idx: Optional[np.ndarray] = None,
    use_brand: bool = True,
    pad_multiple: int = 1024,
    dense_threshold: Optional[int] = None,
    max_dense_bytes: int = 512 * 1024 * 1024,
) -> Graph:
    """Build the normalized heterogeneous adjacency (main.py:282-331)."""
    num_nodes = num_users + num_items + num_brands
    item_offset = num_users
    brand_offset = num_users + num_items

    u = np.asarray(user_idx, dtype=np.int64)
    i = np.asarray(item_idx, dtype=np.int64) + item_offset
    if use_brand:
        if item_brand_item_idx is None or item_brand_brand_idx is None:
            raise ValueError("use_brand=True requires item-brand edges")
        bi = np.asarray(item_brand_item_idx, dtype=np.int64) + item_offset
        bb = np.asarray(item_brand_brand_idx, dtype=np.int64) + brand_offset
        rows = np.concatenate([u, i, bi, bb])
        cols = np.concatenate([i, u, bb, bi])
    else:
        rows = np.concatenate([u, i])
        cols = np.concatenate([i, u])

    # dst-major sorted COO with dst := row (A is symmetric, so
    # "out[dst] += w * emb[src]" computes A @ E).  The native path and the
    # numpy path agree to ~2 ULP, not bitwise: the native one normalizes
    # in float32, numpy multiplies in float64 and rounds once
    # (tests/test_torch_native.py holds them to rtol 1e-6), so runs with
    # and without the toolchain are not bit-reproducible.  (Imported here:
    # the data package's loader imports this module.)
    from gcn_recommendation_tpu_torch.data import native_ext

    if native_ext.available():
        dst_sorted, src_sorted, w_sorted = native_ext.build_norm_edges_native(
            rows, cols, num_nodes
        )
        dst_sorted = dst_sorted.astype(np.int64)
        src_sorted = src_sorted.astype(np.int64)
    else:
        dst_sorted, src_sorted, vals = _dedup_sum(rows, cols, num_nodes)
        w_sorted = normalize_sym(dst_sorted, src_sorted, vals, num_nodes)
    nnz = len(dst_sorted)

    row_ptr = np.zeros(num_nodes + 1, dtype=np.int64)
    np.cumsum(np.bincount(dst_sorted, minlength=num_nodes), out=row_ptr[1:])

    # pad COO to a multiple (weight 0, dst pinned to the last row)
    nnz_pad = ((nnz + pad_multiple - 1) // pad_multiple) * pad_multiple
    pad = nnz_pad - nnz
    src_p = np.concatenate([src_sorted, np.zeros(pad, dtype=np.int64)]).astype(np.int32)
    dst_p = np.concatenate(
        [dst_sorted, np.full(pad, num_nodes - 1, dtype=np.int64)]
    ).astype(np.int32)
    w_p = np.concatenate([w_sorted, np.zeros(pad, dtype=np.float32)])

    buckets, gather_idx, dense_node_ids, dense_mat = bucket_by_degree(
        dst_sorted,
        src_sorted,
        w_sorted,
        num_nodes,
        dense_threshold=dense_threshold,
        max_dense_bytes=max_dense_bytes,
    )

    return Graph(
        num_users=num_users,
        num_items=num_items,
        num_brands=num_brands,
        nnz=nnz,
        src=src_p,
        dst=dst_p,
        weight=w_p,
        row_ptr=row_ptr,
        buckets=buckets,
        gather_idx=gather_idx,
        dense_node_ids=dense_node_ids,
        dense_mat=dense_mat,
    )


def pad_graph_nodes(
    g: Graph,
    num_users_pad: int,
    num_items_pad: int,
    num_brands_pad: int,
    bucket_row_multiple: int = 1,
    pad_multiple: int = 1024,
) -> Graph:
    """Remap the graph into a padded ``[users_pad | items_pad | brands_pad]``
    node layout (pad nodes isolated, degree 0).

    The graph half of row padding: the embedding tables are zero-padded to
    a row multiple (``models/lightgcn.py::set_row_multiple``), and every
    node id the adjacency carries must address the padded block.  The id
    remap ``v -> v + (v >= U)*dU + (v >= U+I)*dI`` is strictly monotone,
    so the dst-major edge order, and with it each node's summation order,
    is preserved exactly; the ELL view is re-bucketed over the padded
    space (same degrees, same width classes, same row and neighbor order).

    ``bucket_row_multiple`` additionally zero-pads every ELL bucket's row
    count (and the dense hub block) to a multiple (``pad_ell_rows``).
    """
    U, I, B = g.num_users, g.num_items, g.num_brands
    if (num_users_pad, num_items_pad, num_brands_pad) == (U, I, B) and (
        bucket_row_multiple <= 1
    ):
        return g
    if not (num_users_pad >= U and num_items_pad >= I and num_brands_pad >= B):
        raise ValueError(
            f"padded sizes {(num_users_pad, num_items_pad, num_brands_pad)} "
            f"below the logical sizes {(U, I, B)}"
        )
    du = np.int64(num_users_pad - U)
    di = np.int64(num_items_pad - I)
    n_pad = num_users_pad + num_items_pad + num_brands_pad

    def remap(v):
        v = np.asarray(v, np.int64)
        return v + (v >= U) * du + (v >= U + I) * di

    dst_r = remap(g.dst[: g.nnz])
    src_r = remap(g.src[: g.nnz])
    w = g.weight[: g.nnz].copy()

    buckets, gather_idx, dense_node_ids, dense_mat = bucket_by_degree(
        dst_r, src_r, w, n_pad
    )
    if bucket_row_multiple > 1:
        buckets, gather_idx, dense_node_ids, dense_mat = pad_ell_rows(
            buckets, gather_idx, dense_node_ids, dense_mat, n_pad,
            bucket_row_multiple,
        )

    row_ptr = np.zeros(n_pad + 1, dtype=np.int64)
    np.cumsum(np.bincount(dst_r, minlength=n_pad), out=row_ptr[1:])

    nnz = g.nnz
    nnz_pad = ((nnz + pad_multiple - 1) // pad_multiple) * pad_multiple
    pad = nnz_pad - nnz
    src_p = np.concatenate([src_r, np.zeros(pad, np.int64)]).astype(np.int32)
    dst_p = np.concatenate([dst_r, np.full(pad, n_pad - 1, np.int64)]).astype(np.int32)
    w_p = np.concatenate([w, np.zeros(pad, np.float32)])

    return Graph(
        num_users=num_users_pad,
        num_items=num_items_pad,
        num_brands=num_brands_pad,
        nnz=nnz,
        src=src_p,
        dst=dst_p,
        weight=w_p,
        row_ptr=row_ptr,
        buckets=buckets,
        gather_idx=gather_idx,
        dense_node_ids=dense_node_ids,
        dense_mat=dense_mat,
    )


def pad_ell_rows(
    buckets: List[EllBucket],
    gather_idx: np.ndarray,
    dense_node_ids: np.ndarray,
    dense_mat: np.ndarray,
    num_nodes: int,
    multiple: int,
):
    """Zero-pad every ELL bucket's row count (and the dense hub block) to a
    multiple, rebuilding ``gather_idx`` against the padded concat layout.

    Pad rows gather ``emb[0] * 0`` (index 0, weight 0) and no node's
    ``gather_idx`` points at them, so the propagation output is unchanged.
    """
    if multiple <= 1:
        return buckets, gather_idx, dense_node_ids, dense_mat

    def up(n):
        return ((n + multiple - 1) // multiple) * multiple

    new_buckets: List[EllBucket] = []
    new_gather = np.full(num_nodes, -1, dtype=np.int64)
    off = 0
    for b in buckets:
        nb = b.nbr_idx.shape[0]
        nb_pad = up(nb)
        idx = np.zeros((nb_pad, b.width), np.int32)
        wts = np.zeros((nb_pad, b.width), np.float32)
        idx[:nb] = b.nbr_idx
        wts[:nb] = b.nbr_w
        new_gather[b.node_ids] = off + np.arange(nb)
        off += nb_pad
        new_buckets.append(
            EllBucket(node_ids=b.node_ids, nbr_idx=idx, nbr_w=wts, width=b.width)
        )

    h = len(dense_node_ids)
    h_pad = up(h) if h else 0
    if h:
        dm = np.zeros((h_pad, dense_mat.shape[1]), np.float32)
        dm[:h] = dense_mat
        new_gather[dense_node_ids] = off + np.arange(h)
    else:
        dm = dense_mat
    off += h_pad
    new_gather[new_gather < 0] = off  # degree-0 / pad nodes -> zeros row
    return new_buckets, new_gather.astype(np.int32), dense_node_ids, dm


def build_chunked_ell(graph: Graph, num_chunks: int, num_dest_slices: Optional[int] = None):
    """The non-hub ELL view rebuilt as source chunks x destination slices
    (the layout of ``ops/spmm.py::to_device_chunked_graph``).

    * **Source chunks**: chunk c covers source ids ``[c*chunk_rows,
      (c+1)*chunk_rows)`` with ``chunk_rows = ceil(num_nodes/num_chunks)``;
      each destination row is split into up to ``num_chunks`` sub-rows,
      one per chunk, so neighbor gathers read a sub-table of the
      embedding block.
    * **Destination slices** of ``slice_rows = ceil(num_nodes/S)`` rows
      (``S = num_dest_slices``, default ``num_chunks``): each cell's merge
      gather reads a parts table of at most ``slice_rows`` rows, and the
      slice outputs concatenate in node order.

    Composing the merge into the next layer's indices (the merge-skip of
    ``ops/spmm.py::DeviceGraph.layer_sum``) does not carry over: the merged output is a sum
    of per-chunk parts tables, so every downstream edge gather would read
    all C of them.

    Each (chunk, slice) cell is degree-bucketed on its own, with
    chunk-local neighbor ids and slice-local destination rows; hub rows
    keep the graph's global dense path.

    Returns (per_cell_buckets, per_cell_gather_idx, dense_gather_idx):
    ``per_cell_buckets[c][t]`` is a list of EllBucket with chunk-local
    ``nbr_idx``; ``per_cell_gather_idx[c][t]`` maps every node of slice t
    (slice-local) to its row among cell (c, t)'s bucket outputs (the
    trailing zeros row when it has no neighbor in chunk c);
    ``dense_gather_idx`` maps hub nodes to their dense-output rows (the
    trailing zeros row otherwise).  Numpy copy of the JAX package's
    ``graph/build.py::build_chunked_ell``; the arrays are equal to its.
    """
    n = graph.num_nodes
    if num_dest_slices is None:
        num_dest_slices = num_chunks
    chunk_rows = -(-n // num_chunks)
    slice_rows = -(-n // num_dest_slices)
    dst = graph.dst[: graph.nnz].astype(np.int64)
    src = graph.src[: graph.nnz].astype(np.int64)
    w = graph.weight[: graph.nnz]

    hub_set = np.zeros(n, dtype=bool)
    hub_set[graph.dense_node_ids] = True
    keep = ~hub_set[dst]
    dst, src, w = dst[keep], src[keep], w[keep]
    chunk_of = src // chunk_rows

    per_cell_buckets = []
    per_cell_gidx = []
    max_deg = int(np.bincount(dst, minlength=n).max()) if len(dst) else 0
    slice_edges = np.arange(num_dest_slices + 1, dtype=np.int64) * slice_rows
    for c in range(num_chunks):
        m = chunk_of == c
        # boolean selection keeps the dst-major order
        dst_c, src_c, w_c = dst[m], src[m] - c * chunk_rows, w[m]
        bounds = np.searchsorted(dst_c, slice_edges)
        cell_buckets = []
        cell_gidx = []
        for t in range(num_dest_slices):
            lo, hi = bounds[t], bounds[t + 1]
            # trailing slices are empty when (S-1)*ceil(n/S) >= n (few
            # rows, many slices): clamp them to zero rows
            rows_t = max(0, min(slice_rows, n - t * slice_rows))
            buckets, gidx, dn, _ = bucket_by_degree(
                dst_c[lo:hi] - t * slice_rows,
                src_c[lo:hi],
                w_c[lo:hi],
                rows_t,
                dense_threshold=max_deg + 1,  # hubs stay on the global path
                num_src_nodes=chunk_rows,
            )
            if len(dn):
                raise AssertionError("a chunk cell produced hub rows")
            cell_buckets.append(buckets)
            cell_gidx.append(gidx)
        per_cell_buckets.append(cell_buckets)
        per_cell_gidx.append(cell_gidx)

    h = len(graph.dense_node_ids)
    dense_gidx = np.full(n, h, dtype=np.int32)  # default: the trailing zeros row
    dense_gidx[graph.dense_node_ids] = np.arange(h, dtype=np.int32)
    return per_cell_buckets, per_cell_gidx, dense_gidx
