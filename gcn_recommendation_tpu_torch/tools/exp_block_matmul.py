"""Experiment: what the block path's parts cost on the card, built from library calls.

Counterpart of the JAX package's ``tools/exp_block_matmul.py``, which timed
XLA's pieces of a block-sparse propagation (not a Pallas kernel).  On a
table of ``N_BLOCKS`` x 128 rows (72k nodes) x ``D`` = 64 and ``T = m x
r_blocks`` random 128 x 128 tiles, for (m, r_blocks) in {(16, 384), (32,
192)} (6,144 tiles each):

  block gather only        g = E_blocks[tile_col]                [T, 128, 64]
  gather + batched matmul  prod = bmm(tile_a, g)                 [T, 128, 64]
  full                     prod.reshape(R, m, 128, 64).sum(1)    [R x 128, 64]
  full, bf16 tiles         the same with tile_a and g in bf16,
                           products accumulated in f32

The first two reduce their result over the tiles (the JAX tool's way of
forcing the gather and the product).  The closing line replaces the JAX
tool's TPU constants with this card's: a row gather of the same
``covered_edges`` rows from the table, timed in this run, and the A
tiles' read floor at 3.35 TB/s.  The port's own kernels on 6,144 tiles
are ``tools/exp_block_tiles.py`` (X1/X2, ``csrc/tile_spmm.cu``).

    python -m gcn_recommendation_tpu_torch.tools.exp_block_matmul

Times are CUDA-event medians over ``CHAIN`` calls, and the same calls
replayed from a CUDA graph (``utils/timing.py``); ``--device cpu`` times
the CPU.
"""

from __future__ import annotations

import argparse

import numpy as np
import torch

N_BLOCKS = 564          # 72k nodes / 128
D = 64
CHAIN = 30
CONFIGS = ((16, 384), (32, 192))
HBM_BYTES_PER_S = 3.35e12


def _gather(e, tile_col, n_blocks):
    t = tile_col.shape[0]
    return e.reshape(n_blocks, -1).index_select(0, tile_col).reshape(t, 128, e.shape[1])


def gather_only(e, tile_a, tile_col, n_blocks, m, r_blocks):
    return _gather(e, tile_col, n_blocks).sum(0)                    # [128, D]


def gather_matmul(e, tile_a, tile_col, n_blocks, m, r_blocks):
    return torch.bmm(tile_a, _gather(e, tile_col, n_blocks)).sum(0)  # [128, D]


def full(e, tile_a, tile_col, n_blocks, m, r_blocks):
    prod = torch.bmm(tile_a, _gather(e, tile_col, n_blocks))
    return prod.reshape(r_blocks, m, 128, -1).sum(1).reshape(r_blocks * 128, -1)


def _bmm_bf16_f32(a, b):
    """bf16 x bf16 batched product accumulated and returned in f32 (on the
    card cuBLAS's f32-output bf16 GEMM; on the CPU the same products in f32,
    exact for bf16 inputs)."""
    if a.is_cuda:
        return torch.bmm(a, b, out_dtype=torch.float32)
    return torch.bmm(a.float(), b.float())


def full_bf16(e, tile_a, tile_col, n_blocks, m, r_blocks):
    g = _gather(e, tile_col, n_blocks)
    prod = _bmm_bf16_f32(tile_a.to(torch.bfloat16), g.to(torch.bfloat16))
    return prod.reshape(r_blocks, m, 128, -1).sum(1).reshape(r_blocks * 128, -1)


VARIANTS = (("block gather only", gather_only), ("gather + batched matmul", gather_matmul),
            ("full (gather+mm+reduce)", full), ("full, bf16 tiles", full_bf16))


def make_case(rng, n_blocks: int, d: int, t: int, dev):
    """(e [n_blocks*128, d], tile_a [t, 128, 128], tile_col [t]) drawn as
    the JAX tool draws them."""
    e = torch.from_numpy(rng.standard_normal((n_blocks * 128, d)).astype(np.float32))
    tile_a = torch.from_numpy((rng.standard_normal((t, 128, 128)) * 0.01).astype(np.float32))
    tile_col = torch.from_numpy(rng.integers(0, n_blocks, t).astype(np.int64))
    return e.to(dev), tile_a.to(dev), tile_col.to(dev)


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--n_blocks", type=int, default=N_BLOCKS)
    ap.add_argument("--d", type=int, default=D)
    ap.add_argument("--chain", type=int, default=CHAIN)
    ap.add_argument("--configs", type=str, nargs="+", default=[f"{m}x{r}" for m, r in CONFIGS],
                    help="tiles a row block x row blocks, e.g. 16x384")
    ap.add_argument("--device", type=str, default="cuda")
    args = ap.parse_args(argv)

    from gcn_recommendation_tpu_torch.core.device import resolve_device
    from gcn_recommendation_tpu_torch.utils.timing import (
        cuda_windows,
        device_line,
        graph_ms,
        host_windows,
    )

    dev = resolve_device(args.device)
    cuda = dev.type == "cuda"
    print(device_line(dev), flush=True)
    rng = np.random.default_rng(0)
    row_rng = np.random.default_rng(1)  # rng's draws stay the JAX tool's
    out = []
    for cfg in args.configs:
        m, r_blocks = (int(x) for x in cfg.split("x"))
        t = m * r_blocks  # total tile slots
        if r_blocks > args.n_blocks:
            ap.error(f"{cfg}: more row blocks than --n_blocks")
        covered_edges = int(t * 184 * 0.8)  # ~mean fill, 20% slot padding
        print(f"--- T={t} tiles ({m} per row-block x {r_blocks} row-blocks), "
              f"~{covered_edges/1e6:.2f}M covered edges ---", flush=True)
        e, tile_a, tile_col = make_case(rng, args.n_blocks, args.d, t, dev)
        row_idx = torch.from_numpy(
            row_rng.integers(0, args.n_blocks * 128, covered_edges).astype(np.int64)).to(dev)
        rows = []
        with torch.no_grad():
            calls = [(name, lambda fn=fn: fn(e, tile_a, tile_col, args.n_blocks, m, r_blocks))
                     for name, fn in VARIANTS]
            calls.append(("row gather (covered edges)", lambda: e.index_select(0, row_idx)))
            for name, call in calls:
                if cuda:
                    times = cuda_windows(call, reps=args.chain, windows=3, warmup=2)
                    ms, gms = float(np.median(times)), graph_ms(call, reps=args.chain, windows=3)
                    print(f"{name:28s} {ms:7.3f} ms   cuda graph {gms:7.3f} ms", flush=True)
                else:
                    ms, gms = float(np.median(host_windows(call, reps=2, warmup=1))), None
                    print(f"{name:28s} {ms:7.3f} ms (cpu)", flush=True)
                rows.append(dict(name=name, ms=ms, graph_ms=gms))
        floor_ms = t * 128 * 128 * 4 / HBM_BYTES_PER_S * 1e3
        print(f"(row-gather equivalent: {rows[-1]['ms']:.3f} ms measured for "
              f"{covered_edges:,} rows; A-tile HBM read floor f32 at 3.35 TB/s: "
              f"{floor_ms:.3f} ms)", flush=True)
        out.append(dict(m=m, r_blocks=r_blocks, tiles=t, covered_edges=covered_edges,
                        rows=rows, a_floor_ms=floor_ms))
        del e, tile_a, tile_col, row_idx
    return {"device": str(dev), "configs": out}


if __name__ == "__main__":
    main()
