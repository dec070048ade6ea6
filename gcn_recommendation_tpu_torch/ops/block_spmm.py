"""Block-sparse tile product fused with the ELL gather path.

PyTorch counterpart of ``gcn_recommendation_tpu/ops/block_spmm.py``.

* ``tile_matvec`` — the compact tile output ``[R*128, d]``: for each row
  block r, the f32 sum of its dense 128x128 tiles times their 128-row
  embedding windows.  On a CUDA tensor it launches the hand-written
  kernel ``csrc/tile_spmm.cu`` (it replaces the Pallas kernel
  ``gcn_recommendation_tpu/ops/block_spmm.py::_make_tile_call``); on a
  CPU tensor it runs the plain PyTorch version ``_tile_matvec_reference``
  (window gather, one batched product, ``index_add_`` per row block).
* ``propagate_ell_tiles`` — the full partitioned product ``A_norm @ emb
  = ELL(residual) + hub rows + tiles``.  The partition is not symmetric
  but its sum is, so the backward pass applies the same forward to the
  cotangent (as ``ops/spmm.py::propagate_ell``): the tile kernel runs
  once per layer forward and once per layer backward.
* ``to_device_tiles`` ships a graph partition (``graph/tiles.py``);
  ``tiles_from_arrays`` builds tiles for ``tile_matvec`` from raw arrays
  at any number of tiles per step, with a row id per tile or per step
  (the layouts of ``tools/exp_block_tiles.py``).
"""

from __future__ import annotations

import ctypes
import dataclasses
from typing import Optional

import numpy as np
import torch

from gcn_recommendation_tpu_torch.core.device import DeviceLike, resolve_device
from gcn_recommendation_tpu_torch.graph.tiles import TILE, TilePartition
from gcn_recommendation_tpu_torch.ops.spmm import DeviceGraph, _ell_matvec

# widest embedding the kernel takes (its block has 16 * d / 4 threads)
MAX_D = 128


@dataclasses.dataclass
class TileDeviceArrays:
    """Device-resident tiles.  ``tile_matvec`` needs the first four
    arrays; the last two map the compact tile output back to nodes and
    exist only for a graph partition (``to_device_tiles``)."""

    tile_a: torch.Tensor           # [T, 128, 128] float32 or bfloat16
    tile_col: torch.Tensor         # [T] int32 — source column blocks
    step_row: torch.Tensor         # [T // TB] int32, sorted
    row_step_ptr: torch.Tensor     # [R + 1] int32 — steps of each row block
    tile_gather_idx: Optional[torch.Tensor] = None  # [num_nodes] int64 into [R*128 + 1]
    row_block_nodes: Optional[torch.Tensor] = None  # [R, 128] int32 (-1 pad rows)

    @property
    def num_tiles(self) -> int:
        return int(self.tile_a.shape[0])

    @property
    def tiles_per_step(self) -> int:
        return self.num_tiles // max(int(self.step_row.shape[0]), 1)

    @property
    def n_row_blocks(self) -> int:
        return int(self.row_step_ptr.shape[0]) - 1


def _row_step_ptr(step_row: np.ndarray, n_row_blocks: int) -> np.ndarray:
    """Row block r owns steps ``ptr[r] .. ptr[r+1]`` of the sorted ``step_row``."""
    return np.searchsorted(step_row, np.arange(n_row_blocks + 1), side="left").astype(np.int32)


def tiles_from_arrays(
    tile_a: np.ndarray,
    tile_col: np.ndarray,
    rows: np.ndarray,
    tiles_per_step: int,
    n_row_blocks: int,
    tile_dtype: torch.dtype = torch.float32,
    device: DeviceLike = None,
) -> TileDeviceArrays:
    """Tiles for ``tile_matvec`` from raw arrays: ``tile_a`` [T, 128, 128],
    ``tile_col`` [T] column blocks, and ``rows``, the sorted output row
    block of every tile ([T]) or of every step ([T // tiles_per_step]).
    There is no graph behind such tiles, so the node maps stay unset."""
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
    step_row = rows.astype(np.int32)
    return TileDeviceArrays(
        tile_a=torch.from_numpy(np.ascontiguousarray(tile_a)).to(device=dev, dtype=tile_dtype),
        tile_col=torch.from_numpy(tile_col.astype(np.int32)).to(dev),
        step_row=torch.from_numpy(step_row).to(dev),
        row_step_ptr=torch.from_numpy(_row_step_ptr(step_row, n_row_blocks)).to(dev),
    )


def to_device_tiles(
    part: TilePartition, tile_dtype: torch.dtype = torch.float32, device: DeviceLike = None
) -> TileDeviceArrays:
    """Ship a ``graph/tiles.py`` partition to ``device``.  ``row_step_ptr``
    is derived here from the sorted ``step_row``: row block r owns steps
    ``row_step_ptr[r] .. row_step_ptr[r+1]``."""
    dev = resolve_device(device)
    row_step_ptr = _row_step_ptr(part.step_row, part.n_row_blocks)
    return TileDeviceArrays(
        tile_a=torch.from_numpy(part.tile_a).to(device=dev, dtype=tile_dtype),
        tile_col=torch.from_numpy(part.tile_col).to(dev),
        step_row=torch.from_numpy(part.step_row).to(dev),
        row_step_ptr=torch.from_numpy(row_step_ptr).to(dev),
        tile_gather_idx=torch.from_numpy(part.tile_gather_idx.astype(np.int64)).to(dev),
        row_block_nodes=torch.from_numpy(part.row_block_nodes).to(dev),
    )


def _tile_matvec_reference(emb: torch.Tensor, tiles: TileDeviceArrays) -> torch.Tensor:
    """Plain PyTorch version of the kernel, on any device: gather the
    [T, 128, d] windows of the zero-padded embedding, one batched product
    in f32 (bfloat16 tiles meet the window rounded to bfloat16, as in the
    kernel; their products are exact in f32), and an ``index_add_`` of
    each tile's product into its row block."""
    n, d = emb.shape
    n_blocks = -(-n // TILE)
    emb_p = torch.nn.functional.pad(emb.float(), (0, 0, 0, n_blocks * TILE - n))
    win = emb_p.view(n_blocks, TILE, d).index_select(0, tiles.tile_col.long())
    if tiles.tile_a.dtype != torch.float32:
        win = win.to(tiles.tile_a.dtype).float()
    prod = torch.bmm(tiles.tile_a.float(), win)
    tile_row = tiles.step_row.long().repeat_interleave(tiles.tiles_per_step)
    out = torch.zeros((tiles.n_row_blocks, TILE, d), dtype=torch.float32, device=emb.device)
    out.index_add_(0, tile_row, prod)
    return out.view(tiles.n_row_blocks * TILE, d)


def _tile_matvec_cuda(emb: torch.Tensor, tiles: TileDeviceArrays) -> torch.Tensor:
    from gcn_recommendation_tpu_torch.kernels._build import load_library

    a = tiles.tile_a
    if a.device != emb.device:
        raise ValueError(f"tiles on {a.device}, embedding on {emb.device}")
    if a.dtype not in (torch.float32, torch.bfloat16) or not a.is_contiguous():
        raise ValueError(
            f"tile_spmm kernel takes contiguous float32 or bfloat16 tiles, got "
            f"{a.dtype} contiguous={a.is_contiguous()}"
        )
    x = emb.float().contiguous()
    n, d = x.shape
    if d % 4 or not 4 <= d <= MAX_D:
        raise ValueError(f"tile_spmm kernel takes d a multiple of 4 in [4, {MAX_D}], got {d}")
    if x.data_ptr() % 16:
        raise ValueError("tile_spmm kernel needs a 16-byte aligned embedding")
    r = tiles.n_row_blocks
    out = torch.empty((r * TILE, d), dtype=torch.float32, device=x.device)
    if r == 0:
        return out
    lib = load_library("tile_spmm")
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = lib.tile_spmm_launch(
            ctypes.c_void_p(a.data_ptr()),
            ctypes.c_int(int(a.dtype == torch.bfloat16)),
            ctypes.c_void_p(tiles.tile_col.data_ptr()),
            ctypes.c_void_p(tiles.row_step_ptr.data_ptr()),
            ctypes.c_void_p(x.data_ptr()),
            ctypes.c_void_p(out.data_ptr()),
            ctypes.c_int(r),
            ctypes.c_int(tiles.tiles_per_step),
            ctypes.c_int64(n),
            ctypes.c_int(d),
            ctypes.c_void_p(stream),
        )
    if err != 0:
        raise RuntimeError(f"tile_spmm kernel launch failed: CUDA error {err}")
    tile_matvec.launches += 1
    return out


def tile_matvec(emb: torch.Tensor, tiles: TileDeviceArrays) -> torch.Tensor:
    """Compact tile output [R*128, d] float32 for node-order ``emb`` [N, d]:
    the CUDA kernel on a CUDA tensor (it launches or raises), its plain
    version on a CPU tensor."""
    if emb.device.type == "cuda":
        return _tile_matvec_cuda(emb, tiles)
    if emb.device.type == "cpu":
        return _tile_matvec_reference(emb, tiles)
    raise ValueError(f"tile_matvec: unsupported device {emb.device}")


# kernel launches since the last reset (the chip smoke test reads it)
tile_matvec.launches = 0


def _ell_tiles_matvec(emb: torch.Tensor, graph: DeviceGraph, tiles: TileDeviceArrays):
    if tiles.tile_gather_idx is None:
        raise ValueError("these tiles carry no node map: they are not a graph partition")
    base = _ell_matvec(
        emb, graph.bucket_nbr_idx, graph.bucket_nbr_w, graph.gather_idx, graph.dense_mat
    )
    tile_out = tile_matvec(emb, tiles)
    # trailing zeros row for nodes whose row holds no tile
    ext = torch.cat([tile_out, tile_out.new_zeros((1, emb.shape[1]))])
    return base + ext.index_select(0, tiles.tile_gather_idx).to(emb.dtype)


class _PropagateEllTiles(torch.autograd.Function):
    @staticmethod
    def forward(ctx, emb, graph, tiles):
        ctx.graph, ctx.tiles = graph, tiles
        return _ell_tiles_matvec(emb, graph, tiles)

    @staticmethod
    def backward(ctx, grad):
        # the whole partition sums to the symmetric A_norm (graph/tiles.py),
        # so d(emb) = A_norm @ grad through the same partitioned product
        return _ell_tiles_matvec(grad, ctx.graph, ctx.tiles), None, None


def propagate_ell_tiles(emb: torch.Tensor, graph: DeviceGraph, tiles: TileDeviceArrays):
    """``A_norm @ emb`` over the tile partition (residual ELL + hub rows +
    tiles), differentiable in ``emb``."""
    return _PropagateEllTiles.apply(emb, graph, tiles)


@dataclasses.dataclass
class TiledDeviceGraph:
    """Device graph for the tile partition: the residual ELL + hub
    ``DeviceGraph`` plus the tile arrays; ``ops/spmm.py::propagate``
    dispatches it to ``propagate_ell_tiles``."""

    base: DeviceGraph
    tiles: TileDeviceArrays
