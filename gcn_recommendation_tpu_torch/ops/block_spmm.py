"""Block-sparse tile product fused with the ELL gather path.

PyTorch counterpart of ``gcn_recommendation_tpu/ops/block_spmm.py``.

* ``tile_matvec`` — the compact tile output ``[R*128, d]``: for each row
  block r, the f32 sum of its 128x128 tiles times their 128-row embedding
  windows.  The tiles come in one of two **layouts**, fixed when they are
  built, and each has its own hand-written CUDA kernel (both replace the
  Pallas kernel ``gcn_recommendation_tpu/ops/block_spmm.py::_make_tile_call``):

  - ``"compressed"`` (``csrc/tile_gather_spmm.cu``): the tile edges as a
    CSR over the compact output rows; a group of lanes owns one row and
    gathers its source rows.  For a graph partition, whose tiles are
    almost empty; the dense tile values are not shipped at all.
  - ``"dense"`` (``csrc/tile_spmm.cu``): the ``[T, 128, 128]`` tile values;
    persistent thread blocks take equal ranges of tiles through a
    ``cp.async`` ring (float32 on the FMA units, bfloat16 on the tensor
    cores) and a second pass adds the partial sums of row blocks that a
    range boundary cuts.  For tiles that are mostly nonzero.

  On a CPU tensor it runs the plain PyTorch version
  ``_tile_matvec_reference`` of the tiles' layout.
* ``TiledDeviceGraph`` — a graph kind of ``ops/spmm.py`` whose product
  is the full partitioned ``A_norm @ emb = ELL(residual) + hub rows +
  tiles``.  The partition is not symmetric but its sum is, so
  ``ops/spmm.py::propagate`` applies the same product to the cotangent in
  the backward pass: the tile kernel runs once per layer forward and once
  per layer backward.
* ``to_device_tiles`` ships a graph partition (``graph/tiles.py``);
  ``tiles_from_arrays`` builds tiles for ``tile_matvec`` from raw arrays
  at any number of tiles per step, with a row id per tile or per step
  (the layouts of ``tools/exp_block_tiles.py``).  Both take
  ``layout="auto"`` (by the measured fill), ``"dense"`` or
  ``"compressed"``.
"""

from __future__ import annotations

import ctypes
import dataclasses
from typing import Optional

import numpy as np
import torch

from gcn_recommendation_tpu_torch.core.device import DeviceLike, resolve_device
from gcn_recommendation_tpu_torch.graph.tiles import TILE, TilePartition
from gcn_recommendation_tpu_torch.ops.spmm import DeviceGraph, SymmetricGraph
from gcn_recommendation_tpu_torch.utils.profiling import span

LAYOUTS = ("dense", "compressed")

# ``layout="auto"``: tiles whose fill (nonzeros / (T * 128 * 128)) reaches
# this go to the dense kernel, thinner ones to the compressed kernel.  From
# the fill scan of chip_smoke.py (1,536 tiles, d = 64, NVIDIA H100 80GB
# HBM3, 700.00 W): the compressed kernel's time passes the dense kernel's at
# a fill of 9.2% with float32 tiles and 2.2% with bfloat16 tiles; a graph
# partition is below 1%, the experiment's tiles are full.
AUTO_DENSE_MIN_FILL = 0.05

# persistent thread blocks of the dense kernel per multiprocessor, and the
# multiprocessor count assumed for tiles built on the CPU (an H100's)
DENSE_BLOCKS_PER_SM = 2
DEFAULT_SM_COUNT = 132


@dataclasses.dataclass
class DenseTilePlan:
    """Host-made schedule of the dense kernel (``plan_tile_ranges``), on
    the tiles' device.  All-zero tiles are left out of ``list_*``."""

    list_tile: torch.Tensor      # [Ta] int32 — the tiles to multiply, in order
    list_col: torch.Tensor       # [Ta] int32 — their column blocks
    segments: torch.Tensor       # [S, 4] int32 — (begin, end, row block, partial slot or -1)
    block_seg_ptr: torch.Tensor  # [G + 1] int32 — segments of each thread block
    reduce_rows: torch.Tensor    # [Rr] int32 — row blocks written by the second pass
    reduce_ptr: torch.Tensor     # [Rr + 1] int32 — their partial slots
    n_blocks: int                # G thread blocks (0 when no tile holds a value)
    n_partials: int
    max_col: int                 # largest column block of a listed tile (-1: none)


@dataclasses.dataclass
class TileDeviceArrays:
    """Device-resident tiles in one ``layout``.  ``"dense"`` holds
    ``tile_a`` and its ``plan``; ``"compressed"`` holds the ``edge_*``
    arrays and no ``tile_a``.  The node maps carry the compact tile output
    back to nodes and exist only for a graph partition
    (``to_device_tiles``)."""

    layout: str                    # "dense" or "compressed"
    tile_col: torch.Tensor         # [T] int32 — source column blocks
    step_row: torch.Tensor         # [T // TB] int32, sorted
    row_step_ptr: torch.Tensor     # [R + 1] int32 — steps of each row block
    tile_a: Optional[torch.Tensor] = None        # [T, 128, 128] float32 or bfloat16
    plan: Optional[DenseTilePlan] = None
    edge_row_ptr: Optional[torch.Tensor] = None  # [R*128 + 1] int32
    edge_src: Optional[torch.Tensor] = None      # [E] int32 — source node ids
    edge_w: Optional[torch.Tensor] = None        # [E] float32 or bfloat16
    tile_gather_idx: Optional[torch.Tensor] = None  # [num_nodes] int64 into [R*128 + 1]
    row_block_nodes: Optional[torch.Tensor] = None  # [R, 128] int32 (-1 pad rows)

    @property
    def num_tiles(self) -> int:
        return int(self.tile_col.shape[0])

    @property
    def tiles_per_step(self) -> int:
        return self.num_tiles // max(int(self.step_row.shape[0]), 1)

    @property
    def n_row_blocks(self) -> int:
        return int(self.row_step_ptr.shape[0]) - 1

    @property
    def values(self) -> torch.Tensor:
        """The tile values the layout holds: ``tile_a`` or ``edge_w``."""
        return self.tile_a if self.layout == "dense" else self.edge_w


def _row_step_ptr(step_row: np.ndarray, n_row_blocks: int) -> np.ndarray:
    """Row block r owns steps ``ptr[r] .. ptr[r+1]`` of the sorted ``step_row``."""
    return np.searchsorted(step_row, np.arange(n_row_blocks + 1), side="left").astype(np.int32)


def plan_tile_ranges(
    tile_row: np.ndarray, active: np.ndarray, n_row_blocks: int, n_blocks: int
) -> dict:
    """Cut the active tiles into ``n_blocks`` equal contiguous ranges, one
    per persistent thread block of the dense kernel.

    ``tile_row`` [T] is the sorted row block of every tile and ``active``
    [T] marks the tiles that hold a value.  The cut is made in tiles, so
    it does not depend on the number of tiles per step.  Each range is
    split where the row block changes into *segments* ``(begin, end, row
    block, slot)`` over the list of active tiles.  A segment that holds
    all of its row block's active tiles has slot -1 and is written
    straight to the output; any other is written to partial slot
    ``slot``, and the second pass writes each row block of
    ``reduce_rows`` as the sum of its slots ``reduce_ptr[i] ..
    reduce_ptr[i+1]`` in order (none: zeros).  Numpy arrays, int32."""
    lst = np.flatnonzero(active)
    ta = len(lst)
    rows = np.asarray(tile_row)[lst].astype(np.int64)
    g = min(int(n_blocks), ta)
    cuts = (np.arange(g + 1, dtype=np.int64) * ta) // max(g, 1)
    row_ptr = np.searchsorted(rows, np.arange(n_row_blocks + 1), side="left")
    bounds = np.unique(np.concatenate([cuts, row_ptr]))
    seg_b, seg_e = bounds[:-1], bounds[1:]
    seg_row = rows[seg_b]
    full = (seg_b == row_ptr[seg_row]) & (seg_e == row_ptr[seg_row + 1])
    slot = np.where(full, -1, np.cumsum(~full) - 1)
    written = np.zeros(n_row_blocks, dtype=bool)
    written[seg_row[full]] = True
    reduce_rows = np.flatnonzero(~written)
    partials_per_row = np.bincount(seg_row[~full], minlength=n_row_blocks)
    reduce_ptr = np.zeros(len(reduce_rows) + 1, np.int64)
    np.cumsum(partials_per_row[reduce_rows], out=reduce_ptr[1:])
    i32 = np.int32
    return {
        "list_tile": lst.astype(i32),
        "segments": np.stack([seg_b, seg_e, seg_row, slot], axis=1).astype(i32).reshape(-1, 4),
        "block_seg_ptr": np.searchsorted(seg_b, cuts, side="left").astype(i32),
        "reduce_rows": reduce_rows.astype(i32),
        "reduce_ptr": reduce_ptr.astype(i32),
        "n_blocks": g,
        "n_partials": int((~full).sum()),
    }


def _dense_plan(tile_a: np.ndarray, tile_col: np.ndarray, tile_row: np.ndarray,
                n_row_blocks: int, dev: torch.device) -> DenseTilePlan:
    sms = (torch.cuda.get_device_properties(dev).multi_processor_count
           if dev.type == "cuda" else DEFAULT_SM_COUNT)
    active = tile_a.reshape(tile_a.shape[0], -1).any(axis=1)
    p = plan_tile_ranges(tile_row, active, n_row_blocks, DENSE_BLOCKS_PER_SM * sms)

    def to(a: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(np.ascontiguousarray(a)).to(dev)

    return DenseTilePlan(
        list_tile=to(p["list_tile"]),
        list_col=to(tile_col[p["list_tile"]].astype(np.int32)),
        segments=to(p["segments"]), block_seg_ptr=to(p["block_seg_ptr"]),
        reduce_rows=to(p["reduce_rows"]), reduce_ptr=to(p["reduce_ptr"]),
        n_blocks=p["n_blocks"], n_partials=p["n_partials"],
        max_col=int(tile_col[p["list_tile"]].max()) if len(p["list_tile"]) else -1,
    )


def compress_tiles(tile_a: np.ndarray, tile_col: np.ndarray, tile_row: np.ndarray,
                   n_row_blocks: int):
    """The nonzeros of ``tile_a`` as a CSR over the ``n_row_blocks * 128``
    compact rows: ``(edge_row_ptr, edge_src, edge_w)`` with ``edge_src =
    128 * tile_col + column``, ordered within a row by tile, then column."""
    t, i, j = np.nonzero(tile_a)
    row = np.asarray(tile_row).astype(np.int64)[t] * TILE + i
    order = np.argsort(row, kind="stable")  # nonzero() walks tile, row, column
    ptr = np.zeros(n_row_blocks * TILE + 1, np.int64)
    np.cumsum(np.bincount(row, minlength=n_row_blocks * TILE), out=ptr[1:])
    src = (tile_col.astype(np.int64)[t] * TILE + j)[order]
    return ptr.astype(np.int32), src.astype(np.int32), tile_a[t, i, j][order]


def _pick_layout(layout: str, nonzeros: int, num_tiles: int) -> str:
    if layout == "auto":
        fill = nonzeros / max(num_tiles * TILE * TILE, 1)
        return "dense" if fill >= AUTO_DENSE_MIN_FILL else "compressed"
    if layout not in LAYOUTS:
        raise ValueError(f"layout {layout!r}: want 'auto', 'dense' or 'compressed'")
    return layout


def _build_tiles(tile_a, tile_col, step_row, n_row_blocks, edges, layout, tile_dtype, dev,
                 **node_maps) -> TileDeviceArrays:
    """Device tiles in ``layout``; ``edges`` is the compressed triple, or
    None to compress ``tile_a`` when the layout needs it."""
    step_row = step_row.astype(np.int32)
    tile_col = tile_col.astype(np.int32)
    tb = len(tile_col) // max(len(step_row), 1)
    tile_row = np.repeat(step_row, tb)
    common = dict(
        layout=layout,
        tile_col=torch.from_numpy(tile_col).to(dev),
        step_row=torch.from_numpy(step_row).to(dev),
        row_step_ptr=torch.from_numpy(_row_step_ptr(step_row, n_row_blocks)).to(dev),
        **node_maps,
    )
    if layout == "dense":
        return TileDeviceArrays(
            tile_a=torch.from_numpy(np.ascontiguousarray(tile_a)).to(device=dev, dtype=tile_dtype),
            plan=_dense_plan(tile_a, tile_col, tile_row, n_row_blocks, dev),
            **common,
        )
    ptr, src, w = edges if edges is not None else compress_tiles(
        tile_a, tile_col, tile_row, n_row_blocks)
    return TileDeviceArrays(
        edge_row_ptr=torch.from_numpy(ptr).to(dev),
        edge_src=torch.from_numpy(src).to(dev),
        edge_w=torch.from_numpy(w).to(device=dev, dtype=tile_dtype),
        **common,
    )


def tiles_from_arrays(
    tile_a: np.ndarray,
    tile_col: np.ndarray,
    rows: np.ndarray,
    tiles_per_step: int,
    n_row_blocks: int,
    tile_dtype: torch.dtype = torch.float32,
    device: DeviceLike = None,
    layout: str = "auto",
) -> TileDeviceArrays:
    """Tiles for ``tile_matvec`` from raw arrays: ``tile_a`` [T, 128, 128],
    ``tile_col`` [T] column blocks, and ``rows``, the sorted output row
    block of every tile ([T]) or of every step ([T // tiles_per_step]).
    There is no graph behind such tiles, so the node maps stay unset.
    ``layout="auto"`` picks the layout from the fill of ``tile_a``."""
    dev = resolve_device(device)
    t, tb = int(tile_a.shape[0]), int(tiles_per_step)
    if tile_a.shape[1:] != (TILE, TILE) or tile_col.shape != (t,):
        raise ValueError(
            f"tile_a {tile_a.shape} / tile_col {tile_col.shape}: want [T, 128, 128] / [T]"
        )
    if tb < 1 or t % tb:
        raise ValueError(f"{t} tiles do not split into steps of {tb}")
    rows = np.asarray(rows)
    if rows.shape == (t,) and tb > 1:
        per_step = rows.reshape(t // tb, tb)
        if (per_step != per_step[:, :1]).any():
            raise ValueError("the tiles of one step belong to different row blocks")
        rows = per_step[:, 0]
    if rows.shape != (t // tb,):
        raise ValueError(f"rows {rows.shape}: want one id per tile [{t}] or per step [{t // tb}]")
    if len(rows) and ((np.diff(rows) < 0).any() or rows[0] < 0 or rows[-1] >= n_row_blocks):
        raise ValueError(f"row ids must be sorted and in [0, {n_row_blocks})")
    layout = _pick_layout(layout, int(np.count_nonzero(tile_a)) if layout == "auto" else 0, t)
    return _build_tiles(tile_a, tile_col, rows, n_row_blocks, None, layout, tile_dtype, dev)


def to_device_tiles(
    part: TilePartition, tile_dtype: torch.dtype = torch.float32, device: DeviceLike = None,
    layout: str = "auto",
) -> TileDeviceArrays:
    """Ship a ``graph/tiles.py`` partition to ``device``.  ``row_step_ptr``
    is derived here from the sorted ``step_row``: row block r owns steps
    ``row_step_ptr[r] .. row_step_ptr[r+1]``.  ``layout="auto"`` picks the
    layout from the partition's fill; the compressed layout ships the
    partition's edge arrays and no dense tile."""
    dev = resolve_device(device)
    layout = _pick_layout(layout, part.covered_edges, part.num_tiles)
    with span("spmm.to_device"):
        return _build_tiles(
            part.tile_a, part.tile_col, part.step_row, part.n_row_blocks,
            (part.edge_row_ptr, part.edge_src, part.edge_w), layout, tile_dtype, dev,
            tile_gather_idx=torch.from_numpy(part.tile_gather_idx.astype(np.int64)).to(dev),
            row_block_nodes=torch.from_numpy(part.row_block_nodes).to(dev),
        )


def _round_like(x: torch.Tensor, values: torch.Tensor) -> torch.Tensor:
    """``x`` in f32, rounded through the tile values' dtype when that is
    not f32 (the kernel's ``e_refs[j][:].astype(compute_dtype)``)."""
    x = x.float()
    return x if values.dtype == torch.float32 else x.to(values.dtype).float()


def _tile_matvec_reference(emb: torch.Tensor, tiles: TileDeviceArrays) -> torch.Tensor:
    """Plain PyTorch version of both kernels, on any device; products and
    sums in f32, bfloat16 tile values meeting the embedding rounded to
    bfloat16 (their products are exact in f32).

    Dense layout: gather the [T, 128, d] windows of the zero-padded
    embedding, one batched product, and an ``index_add_`` of each tile's
    product into its row block.  Compressed layout: gather each edge's
    source row (zeros past N), scale it by the edge's weight, and
    ``index_add_`` by compact row."""
    n, d = emb.shape
    r = tiles.n_row_blocks
    if tiles.layout == "compressed":
        src = tiles.edge_src.long()
        counts = tiles.edge_row_ptr[1:].long() - tiles.edge_row_ptr[:-1].long()
        row = torch.repeat_interleave(torch.arange(r * TILE, device=emb.device), counts)
        inside = (src < n).unsqueeze(1)
        gathered = _round_like(emb, tiles.edge_w).index_select(0, src.clamp(max=n - 1))
        prod = torch.where(inside, gathered * tiles.edge_w.float().unsqueeze(1), 0.0)
        out = torch.zeros((r * TILE, d), dtype=torch.float32, device=emb.device)
        return out.index_add_(0, row, prod)
    n_blocks = -(-n // TILE)
    emb_p = torch.nn.functional.pad(emb.float(), (0, 0, 0, n_blocks * TILE - n))
    win = emb_p.view(n_blocks, TILE, d).index_select(0, tiles.tile_col.long())
    prod = torch.bmm(tiles.tile_a.float(), _round_like(win, tiles.tile_a))
    tile_row = tiles.step_row.long().repeat_interleave(tiles.tiles_per_step)
    out = torch.zeros((r, TILE, d), dtype=torch.float32, device=emb.device)
    out.index_add_(0, tile_row, prod)
    return out.view(r * TILE, d)


def _ptr(t: Optional[torch.Tensor]) -> ctypes.c_void_p:
    return ctypes.c_void_p(t.data_ptr() if t is not None and t.numel() else 0)


def _tile_matvec_cuda(emb: torch.Tensor, tiles: TileDeviceArrays) -> torch.Tensor:
    from gcn_recommendation_tpu_torch.kernels._build import load_library

    if tiles.layout not in LAYOUTS:
        raise ValueError(f"tiles of unknown layout {tiles.layout!r}")
    a = tiles.values
    if a.device != emb.device:
        raise ValueError(f"tiles on {a.device}, embedding on {emb.device}")
    if a.dtype not in (torch.float32, torch.bfloat16) or not a.is_contiguous():
        raise ValueError(
            f"the tile kernels take contiguous float32 or bfloat16 tile values, got "
            f"{a.dtype} contiguous={a.is_contiguous()}"
        )
    x = emb.float().contiguous()
    n, d = x.shape
    if d < 1:
        raise ValueError(f"the tile kernels take d >= 1, got {d}")
    # the kernels read rows as whole float4s: other widths get zero columns
    # in a scratch copy, sliced off the output
    dk = -(-d // 4) * 4
    if dk != d:
        x = torch.nn.functional.pad(x, (0, dk - d))
    if x.data_ptr() % 16:
        raise ValueError("the tile kernels need a 16-byte aligned embedding")
    r = tiles.n_row_blocks
    out = torch.empty((r * TILE, dk), dtype=torch.float32, device=x.device)
    if r == 0:
        return out[:, :d]
    bf16 = ctypes.c_int(int(a.dtype == torch.bfloat16))
    with torch.cuda.device(x.device):
        stream = ctypes.c_void_p(torch.cuda.current_stream(x.device).cuda_stream)
        if tiles.layout == "compressed":
            err = load_library("tile_gather_spmm").tile_gather_spmm_launch(
                _ptr(tiles.edge_row_ptr), _ptr(tiles.edge_src), _ptr(a), bf16,
                _ptr(x), _ptr(out), ctypes.c_int(r * TILE), ctypes.c_int64(n),
                ctypes.c_int(dk), stream,
            )
        else:
            p = tiles.plan
            if p.max_col * TILE >= n:
                raise ValueError(f"a tile's column block starts past the {n} embedding rows")
            partials = torch.empty((p.n_partials, TILE, dk), dtype=torch.float32, device=x.device)
            # bf16 tiles: the embedding rounded to bf16, rows padded to whole
            # windows and columns to a multiple of 16 (written by the launcher)
            window = (torch.empty((-(-n // TILE) * TILE, -(-dk // 16) * 16),
                                  dtype=torch.bfloat16, device=x.device)
                      if a.dtype == torch.bfloat16 else None)
            err = load_library("tile_spmm").tile_spmm_launch(
                _ptr(a), bf16, _ptr(p.list_tile), _ptr(p.list_col), _ptr(p.segments),
                _ptr(p.block_seg_ptr), ctypes.c_int(p.n_blocks), _ptr(p.reduce_rows),
                _ptr(p.reduce_ptr), ctypes.c_int(int(p.reduce_rows.shape[0])),
                _ptr(x), _ptr(window), _ptr(partials), _ptr(out), ctypes.c_int64(n),
                ctypes.c_int(dk), stream,
            )
    if err != 0:
        raise RuntimeError(f"{tiles.layout} tile kernel launch failed: CUDA error {err}")
    tile_matvec.launches += 1
    return out if dk == d else out[:, :d].contiguous()


def tile_matvec(emb: torch.Tensor, tiles: TileDeviceArrays) -> torch.Tensor:
    """Compact tile output [R*128, d] float32 for node-order ``emb`` [N, d],
    any ``d >= 1`` (the kernels cover the columns in slabs of 128): on a
    CUDA tensor the CUDA kernel of the tiles' layout (it launches or
    raises), on a CPU tensor the plain version."""
    if emb.device.type == "cuda":
        return _tile_matvec_cuda(emb, tiles)
    if emb.device.type == "cpu":
        return _tile_matvec_reference(emb, tiles)
    raise ValueError(f"tile_matvec: unsupported device {emb.device}")


# kernel launches since the last reset (the chip smoke test reads it)
tile_matvec.launches = 0


@dataclasses.dataclass
class TiledDeviceGraph(SymmetricGraph):
    """Device graph for the tile partition: the residual ELL + hub
    ``DeviceGraph`` plus the tile arrays."""

    base: DeviceGraph
    tiles: TileDeviceArrays

    def product(self, emb: torch.Tensor) -> torch.Tensor:
        """``A_norm @ emb`` over the partition: residual ELL + hub rows +
        tiles.  The partition is not symmetric but its sum is
        (``graph/tiles.py``), so the backward is this product too."""
        if self.tiles.tile_gather_idx is None:
            raise ValueError("these tiles carry no node map: they are not a graph partition")
        base = self.base.product(emb)
        tile_out = tile_matvec(emb, self.tiles)
        # trailing zeros row for nodes whose row holds no tile
        ext = torch.cat([tile_out, tile_out.new_zeros((1, emb.shape[1]))])
        return base + ext.index_select(0, self.tiles.tile_gather_idx).to(emb.dtype)
