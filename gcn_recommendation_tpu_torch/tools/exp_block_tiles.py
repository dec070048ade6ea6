"""Experiment: the tile product on dense, balanced tiles.

Counterpart of ``tools/exp_block_pallas.py``, whose two Pallas kernels
compute ``ops/block_spmm.py::tile_matvec``'s function on a synthetic
layout: every row block owns the same number of tiles, every tile value
is nonzero, the column blocks are random.  Neither the fill nor the
imbalance of a real partition is in the way, so the time per tile here is
the kernel's own.

* the single-tile kernel (``exp_block_pallas.py:47``, call ``:73``): one
  tile per step, a row id per tile; float32 tiles, or bfloat16 tiles with
  the embedding window rounded to bfloat16;
* the batched kernel (``:155``, call ``:185``): 8 tiles per step, a row id
  per step.

Both are launched here as the hand-written CUDA kernel for dense tiles,
``csrc/tile_spmm.cu``, through ``tile_matvec`` on a CUDA tensor (the plain
version on a CPU tensor), on tiles built with
``ops.block_spmm.tiles_from_arrays``, whose ``layout="auto"`` picks the
dense layout for tiles this full.  That kernel cuts the list of tiles into
equal ranges for its thread blocks, whatever the number of tiles per
step, so the two cases give the same bits.  Each case is checked against the
tool's reference formula (window gather, ``einsum("tij,tjd->tid")``, sum
over each row block's tiles), then timed over the tool's chain of
``CHAIN`` dependent applications.

    python -m gcn_recommendation_tpu_torch.tools.exp_block_tiles \\
        [--tiles_per_step 1|8] [--dtype float32|bfloat16] [--device cpu]

The layout is the tool's: 564 column blocks, d = 64, 16 tiles in
each of 384 row blocks (6,144 tiles: 402.7 MB of float32 tile values, an
18.5 MB embedding, a 12.6 MB output), drawn from seed 0.  The tool draws
a second set of tiles for its bfloat16 pass; here that pass rounds the
same tiles, so all cases share one layout and can be compared with each
other.
"""

from __future__ import annotations

import argparse
import dataclasses

import numpy as np
import torch

from gcn_recommendation_tpu_torch.core.device import DeviceLike, resolve_device
from gcn_recommendation_tpu_torch.graph.tiles import TILE
from gcn_recommendation_tpu_torch.ops.block_spmm import (
    TileDeviceArrays,
    tile_matvec,
    tiles_from_arrays,
)
from gcn_recommendation_tpu_torch.utils.timing import cuda_ms, host_ms

N_BLOCKS = 564   # 128-row blocks of the embedding
D = 64
M = 16           # tiles per row block
R_BLOCKS = 384   # output row blocks
CHAIN = 30       # dependent applications in the timed chain

# Limit of every case, x max(1, max|plain|).  float32: the same products
# summed in another order.  bfloat16: the plain formula rounds the window
# as the kernel does and bf16 x bf16 products are exact in f32, so again
# only the order of the f32 sums differs; a kernel that left the window
# unrounded would be off by ~1e-3 of the scale and fails this limit.
RTOL = 1e-5


@dataclasses.dataclass
class Layout:
    """The experiment's arrays on the host."""

    e: np.ndarray         # [n_blocks * 128, d] float32
    tile_a: np.ndarray    # [m * r_blocks, 128, 128] float32
    tile_col: np.ndarray  # [m * r_blocks] int32, random column blocks
    m: int
    r_blocks: int

    @property
    def num_tiles(self) -> int:
        return int(self.tile_a.shape[0])

    @property
    def d(self) -> int:
        return int(self.e.shape[1])


def make_layout(
    seed: int = 0, n_blocks: int = N_BLOCKS, d: int = D, m: int = M, r_blocks: int = R_BLOCKS
) -> Layout:
    """The tool's arrays, drawn in its order (embedding, tile values,
    column blocks) from ``np.random.default_rng(seed)``."""
    if r_blocks > n_blocks:
        raise ValueError(f"the chain feeds the [{r_blocks}*128, d] output back into the "
                         f"[{n_blocks}*128, d] embedding: r_blocks must be <= n_blocks")
    rng = np.random.default_rng(seed)
    t = m * r_blocks
    e = rng.standard_normal((n_blocks * TILE, d)).astype(np.float32)
    tile_a = (rng.standard_normal((t, TILE, TILE)) * 0.01).astype(np.float32)
    tile_col = rng.integers(0, n_blocks, t).astype(np.int32)
    return Layout(e=e, tile_a=tile_a, tile_col=tile_col, m=m, r_blocks=r_blocks)


def device_tiles(
    layout: Layout, tiles_per_step: int = 1, dtype: torch.dtype = torch.float32,
    device: DeviceLike = None,
) -> TileDeviceArrays:
    """The layout's tiles on ``device``: a row id per tile at one tile per
    step (the single-tile kernel), a row id per step otherwise (the
    batched kernel)."""
    if layout.m % tiles_per_step:
        raise ValueError(f"{layout.m} tiles per row block do not split into steps of "
                         f"{tiles_per_step}")
    rows = np.repeat(np.arange(layout.r_blocks, dtype=np.int32), layout.m // tiles_per_step)
    return tiles_from_arrays(
        layout.tile_a, layout.tile_col, rows, tiles_per_step, layout.r_blocks,
        tile_dtype=dtype, device=device,
    )


def reference(
    e: torch.Tensor, tiles: TileDeviceArrays, m: int, round_window: bool = True
) -> torch.Tensor:
    """The tool's reference formula, the plain version of this experiment:
    gather each tile's [128, d] window, one batched product with f32
    accumulation (tile and window in the tiles' dtype), and the sum over
    the ``m`` tiles of each row block.  ``round_window=False`` keeps the
    window in f32 whatever the tiles' dtype: what a kernel that forgot
    to round it would compute, for showing that the limit tells the two
    apart."""
    t, d = tiles.num_tiles, e.shape[1]
    g = e.reshape(-1, TILE * d).index_select(0, tiles.tile_col.long()).reshape(t, TILE, d)
    if round_window:
        g = g.to(tiles.tile_a.dtype)
    prod = torch.einsum("tij,tjd->tid", tiles.tile_a.float(), g.float())
    return prod.reshape(t // m, m, TILE, d).sum(1).reshape(t // m * TILE, d)


def chain(e: torch.Tensor, tiles: TileDeviceArrays, steps: int = CHAIN) -> torch.Tensor:
    """``steps`` dependent applications ``c <- cat(out, zeros) * 1e-2 +
    c * 0.99`` from ``c = e``; returns ``sum(c)`` (a scalar tensor)."""
    pad = e.new_zeros((e.shape[0] - tiles.n_row_blocks * TILE, e.shape[1]))
    c = e
    for _ in range(steps):
        c = torch.cat([tile_matvec(c, tiles), pad]) * 1e-2 + c * 0.99
    return c.sum()


def moved_bytes(tiles: TileDeviceArrays, d: int) -> int:
    """The tool's byte count: every tile's values and its f32 window."""
    return tiles.num_tiles * TILE * (TILE * tiles.values.element_size() + d * 4)


def timed_chain(e: torch.Tensor, tiles: TileDeviceArrays, steps: int = CHAIN):
    """(seconds per application, chain sum) of the second of two chains:
    CUDA events on the card, the host clock on the CPU."""
    total = float(chain(e, tiles, steps))
    if e.device.type == "cuda":
        ms = cuda_ms(lambda: chain(e, tiles, steps), reps=1, windows=1, warmup=0)
    else:
        ms = host_ms(lambda: chain(e, tiles, steps), reps=1, warmup=0)
    return ms / 1e3 / steps, total


def run_case(
    layout: Layout, tiles_per_step: int, dtype: torch.dtype, device: DeviceLike = None,
    chain_steps: int = CHAIN,
) -> dict:
    """Check one case against the reference formula (raises when it is
    out of tolerance), time its chain, and return the figures."""
    dev = resolve_device(device)
    e = torch.from_numpy(layout.e).to(dev)
    tiles = device_tiles(layout, tiles_per_step, dtype, dev)
    out = tile_matvec(e, tiles)
    ref = reference(e, tiles, layout.m)
    err = float((out - ref).abs().max())
    scale = float(ref.abs().max())
    tol = RTOL * max(1.0, scale)
    if not err <= tol:
        raise RuntimeError(
            f"tile_matvec at {tiles_per_step} tiles per step, {dtype}: max abs diff {err:.3e} "
            f"above {tol:.3e} (max|plain| {scale:.3e})"
        )
    del out, ref
    dt, total = timed_chain(e, tiles, chain_steps)
    return {
        "tiles_per_step": tiles_per_step,
        "dtype": str(dtype).replace("torch.", ""),
        "tiles": layout.num_tiles,
        "row_blocks": layout.r_blocks,
        "max_abs_err": err,
        "scale": scale,
        "tol": tol,
        "ms": dt * 1e3,
        "gb_per_s": moved_bytes(tiles, layout.d) / dt / 1e9,
        "ns_per_tile": dt / layout.num_tiles * 1e9,
        "chain_sum": total,
        "clock": "cuda events" if dev.type == "cuda" else "host clock (CPU)",
    }


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--tiles_per_step", type=int, default=1, choices=[1, 8])
    p.add_argument("--dtype", type=str, default="float32", choices=["float32", "bfloat16"])
    p.add_argument("--device", type=str, default=None, help="'cuda' (default) or 'cpu'.")
    args = p.parse_args(argv)
    dev = resolve_device(args.device)
    layout = make_layout(0)
    r = run_case(layout, args.tiles_per_step, getattr(torch, args.dtype), dev)
    name = f"TB={r['tiles_per_step']} {r['dtype']}"
    print(f"[{name}] max err vs reference: {r['max_abs_err']:.3e} "
          f"(scale {r['scale']:.3e}, limit {r['tol']:.3e})")
    print(f"[{name}] tile_matvec on {dev}: {r['ms']:7.3f} ms per application "
          f"({r['gb_per_s']:,.0f} GB/s, {r['ns_per_tile']:.0f} ns/tile; {r['clock']})")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
