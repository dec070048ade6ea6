"""Block-sparse tile partition of the normalized adjacency (host, numpy).

A copy of ``gcn_recommendation_tpu/graph/tiles.py`` (the port imports
nothing from the JAX package).  The layout:

* **Rows sorted, columns original.**  Destination rows are ranked by
  residual degree so dense rows pack into 128-row blocks; source columns
  keep node order, so a tile's embedding window is a plain 128-row slice
  of the embedding table (no input permutation).
* **Hub rows excluded.**  Hub destinations already aggregate through the
  dense hub-row product (``graph/build.py::bucket_by_degree``).
* **Compact output.**  Only row blocks holding a qualifying tile appear
  in the tile output ``[R*128, d]``; ``tile_gather_idx`` maps each node
  to its row there, or to a trailing zeros row.
* **Symmetry lives at the matrix level.**  The tile subset is not
  symmetric (rows are sorted on one side only), but tiles + residual ELL
  + hub rows sum to the symmetric ``A_norm``, so the backward pass applies
  the same partitioned product to the cotangent (``ops/block_spmm.py``).
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np

from gcn_recommendation_tpu_torch.graph.build import Graph, bucket_by_degree

TILE = 128


@dataclasses.dataclass
class TilePartition:
    """Host-side tile view + residual ELL rebuild of a Graph.

    ``tile_a`` is grouped by output row block and zero-padded so every
    group is a multiple of ``tiles_per_step`` (zero tiles are harmless
    adds).  ``tile_col[t]`` indexes 128-row blocks of the node-order
    embedding table; ``step_row[s]`` is the compact output row block of
    step s (non-decreasing).  ``tile_gather_idx[v]`` is node v's row in
    the compact output, or R*128 (a trailing zeros row) when v's row
    holds no tile.

    The ``edge_*`` arrays hold the same tile edges compressed: a CSR over
    the ``R*128`` compact output rows whose entries are (global source
    node ``128*col_t + c``, weight), ordered within a row by tile, then
    column.  They rebuild ``tile_a`` exactly; the compressed layout of
    ``ops/block_spmm.py`` ships them instead of the dense tiles.
    """

    tile_a: np.ndarray           # [T, 128, 128] f32
    tile_col: np.ndarray         # [T] int32 — source column block ids
    step_row: np.ndarray         # [T // tiles_per_step] int32, sorted
    row_block_nodes: np.ndarray  # [R, 128] int32 node ids (-1 pad rows)
    tile_gather_idx: np.ndarray  # [num_nodes] int32 into [R*128 + 1]
    tiles_per_step: int
    n_row_blocks: int
    covered_edges: int
    residual: Graph              # same Graph type, tile edges removed
    edge_row_ptr: np.ndarray     # [R*128 + 1] int32 — edges of each compact row
    edge_src: np.ndarray         # [covered_edges] int32 — source node ids
    edge_w: np.ndarray           # [covered_edges] f32

    @property
    def num_tiles(self) -> int:
        return int(self.tile_a.shape[0])


def partition_tiles(
    g: Graph,
    min_fill: int = 64,
    tiles_per_step: int = 8,
    max_tile_bytes: int = 1 << 30,
) -> Optional[TilePartition]:
    """Split ``g``'s edges into (qualifying tiles, residual ELL graph).

    A 128x128 (row block, column block) pair becomes a dense tile when it
    holds at least ``min_fill`` edges; the thinnest tiles are dropped
    first when the f32 tiles would pass ``max_tile_bytes``.  Returns None
    when no tile qualifies (the caller then builds the plain ELL graph).
    """
    num_nodes = g.num_nodes
    nnz = g.nnz
    dst = g.dst[:nnz].astype(np.int64)
    src = g.src[:nnz].astype(np.int64)
    w = g.weight[:nnz]

    # hub rows are on the dense path already
    hub = np.zeros(num_nodes, dtype=bool)
    hub[g.dense_node_ids] = True
    cand = ~hub[dst]

    # rank non-hub rows by degree (dense rows first); columns stay in
    # node order
    deg = np.bincount(dst[cand], minlength=num_nodes)
    rank = np.full(num_nodes, -1, np.int64)
    nonhub_nodes = np.flatnonzero(~hub)
    order = nonhub_nodes[np.argsort(-deg[nonhub_nodes], kind="stable")]
    rank[order] = np.arange(len(order))

    rblk = rank[dst[cand]] // TILE
    cblk = src[cand] // TILE
    n_cblk = -(-num_nodes // TILE)
    key = rblk * n_cblk + cblk
    counts = np.bincount(key)
    qual = np.flatnonzero(counts >= min_fill)
    if len(qual) == 0:
        return None
    max_tiles = max_tile_bytes // (TILE * TILE * 4)
    if len(qual) > max_tiles:
        qual = qual[np.argsort(-counts[qual], kind="stable")[:max_tiles]]
    qual_set = np.zeros(len(counts), dtype=bool)
    qual_set[qual] = True

    in_tile_cand = qual_set[key]
    in_tile = np.zeros(nnz, dtype=bool)
    cand_pos = np.flatnonzero(cand)
    in_tile[cand_pos[in_tile_cand]] = True

    # compact row blocks: only blocks that own >= 1 qualifying tile
    used_rblk = np.unique(qual // n_cblk)
    n_row_blocks = len(used_rblk)
    rblk_compact = np.full(int(rblk.max()) + 1 if len(rblk) else 1, -1, np.int64)
    rblk_compact[used_rblk] = np.arange(n_row_blocks)

    row_block_nodes = np.full((n_row_blocks, TILE), -1, np.int64)
    tile_gather_idx = np.full(num_nodes, n_row_blocks * TILE, np.int64)
    in_used = np.isin(rank[order] // TILE, used_rblk)
    nodes_in_used = order[in_used]
    pos = rblk_compact[rank[nodes_in_used] // TILE] * TILE + (rank[nodes_in_used] % TILE)
    tile_gather_idx[nodes_in_used] = pos
    row_block_nodes[pos // TILE, pos % TILE] = nodes_in_used

    # dense tiles grouped by compact row block, padded to tiles_per_step
    te_dst = dst[in_tile]
    te_src = src[in_tile]
    te_w = w[in_tile]
    te_r = rblk_compact[rank[te_dst] // TILE]
    te_c = te_src // TILE
    tkey = te_r * n_cblk + te_c
    torder = np.argsort(tkey, kind="stable")
    tkey_s = tkey[torder]
    uniq_key, tile_of_edge = np.unique(tkey_s, return_inverse=True)

    rb_of_tile = (uniq_key // n_cblk).astype(np.int64)
    cb_of_tile = (uniq_key % n_cblk).astype(np.int64)
    tb = tiles_per_step
    tiles_per_rb = np.bincount(rb_of_tile, minlength=n_row_blocks)
    padded_per_rb = -(-tiles_per_rb // tb) * tb
    T = int(padded_per_rb.sum())
    tile_a = np.zeros((T, TILE, TILE), np.float32)
    tile_col = np.zeros(T, np.int64)
    rb_start = np.zeros(n_row_blocks + 1, np.int64)
    np.cumsum(padded_per_rb, out=rb_start[1:])
    slot_in_rb = np.concatenate(
        [np.arange(n) for n in tiles_per_rb]
    ) if len(tiles_per_rb) else np.zeros(0, np.int64)
    tile_slot = rb_start[rb_of_tile] + slot_in_rb
    tile_col[tile_slot] = cb_of_tile
    e_slot = tile_slot[tile_of_edge]
    e_r = (rank[te_dst[torder]] % TILE).astype(np.int64)
    e_c = (te_src[torder] % TILE).astype(np.int64)
    tile_a[e_slot, e_r, e_c] = te_w[torder]

    step_row = np.repeat(np.arange(n_row_blocks), padded_per_rb // tb)

    # the same edges as a CSR over the compact rows: by row, tile, column
    e_row = rb_of_tile[tile_of_edge] * TILE + e_r
    eorder = np.lexsort((e_c, e_slot, e_row))
    edge_row_ptr = np.zeros(n_row_blocks * TILE + 1, np.int64)
    np.cumsum(np.bincount(e_row, minlength=n_row_blocks * TILE), out=edge_row_ptr[1:])

    # residual graph: every edge not in a tile, re-bucketed (hub rows keep
    # all their edges, so the dense path re-emerges identically)
    keep = ~in_tile
    r_dst = g.dst[:nnz][keep]
    r_src = g.src[:nnz][keep]
    r_w = w[keep]
    buckets, gather_idx, dense_ids, dense_mat = bucket_by_degree(
        r_dst, r_src, r_w, num_nodes
    )
    pad = g.nnz_padded - len(r_dst)
    residual = Graph(
        num_users=g.num_users,
        num_items=g.num_items,
        num_brands=g.num_brands,
        nnz=len(r_dst),
        src=np.concatenate([r_src, np.zeros(pad, g.src.dtype)]),
        dst=np.concatenate([r_dst, np.zeros(pad, g.dst.dtype)]),
        weight=np.concatenate([r_w, np.zeros(pad, np.float32)]),
        row_ptr=_row_ptr(r_dst, num_nodes),
        buckets=buckets,
        gather_idx=gather_idx,
        dense_node_ids=dense_ids,
        dense_mat=dense_mat,
    )
    return TilePartition(
        tile_a=tile_a,
        tile_col=tile_col.astype(np.int32),
        step_row=step_row.astype(np.int32),
        row_block_nodes=row_block_nodes.astype(np.int32),
        tile_gather_idx=tile_gather_idx.astype(np.int32),
        tiles_per_step=tb,
        n_row_blocks=n_row_blocks,
        covered_edges=int(in_tile.sum()),
        residual=residual,
        edge_row_ptr=edge_row_ptr.astype(np.int32),
        edge_src=te_src[torder][eorder].astype(np.int32),
        edge_w=te_w[torder][eorder].astype(np.float32),
    )


def _row_ptr(dst_sorted: np.ndarray, num_nodes: int) -> np.ndarray:
    deg = np.bincount(dst_sorted, minlength=num_nodes)
    rp = np.zeros(num_nodes + 1, np.int64)
    np.cumsum(deg, out=rp[1:])
    return rp
