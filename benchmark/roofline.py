"""Peaks of the card, and the operations and bytes of the work the cells do.

Peaks: one NVIDIA H100 SXM, from NVIDIA's data sheet (dense rates, no
sparsity), which assume the full 700 W power limit; the result line
carries the card's ``nvidia-smi`` name and power limit beside every share.

Counting rule: each input byte read once and each output byte written
once, whatever an implementation reads again, and the operations that
these inputs need.  A sparse product ``A @ X`` over ``nnz`` stored entries
of an ``[n, n]`` matrix with ``d`` columns reads the entries once (a 4-byte
column id and a 4-byte float32 weight each, the row offsets), reads
``X`` once and writes the result once, and does ``2 nnz d`` operations.
Adam reads the parameter, its gradient and both moments and writes the
parameter and both moments: 7 float32 passes, ``ADAM_OPS`` operations an
element.

``quant_bound_s`` and ``tile_bound_s`` are the least times of the int8
quantizer (K2) and of one tile product (K3), kept for the cells that
launch those kernels.
"""

from __future__ import annotations

import subprocess

HBM_BYTES_PER_S = 3.35e12   # H100 SXM HBM3
FP32_OPS_PER_S = 67e12      # float32 outside the tensor cores (TF32 is off)
BF16_OPS_PER_S = 989e12     # bf16 tensor cores, dense
F32 = 4
IDX = 4                     # a node or item id as the data needs it (int32)
ADAM_OPS = 12               # two moment updates, bias corrections, sqrt, divide, update
QUANT_OPS_PER_ELEMENT = 20  # hash (~12 integer ops) + divide, add, floor, clamp
TILE = 128
MAX_SHARE_PCT = 105.0


class Work:
    """Operations and bytes, added up."""

    def __init__(self, ops: float = 0.0, nbytes: float = 0.0):
        self.ops, self.nbytes = float(ops), float(nbytes)

    def __add__(self, other: "Work") -> "Work":
        return Work(self.ops + other.ops, self.nbytes + other.nbytes)

    def __mul__(self, k: float) -> "Work":
        return Work(self.ops * k, self.nbytes * k)

    __rmul__ = __mul__

    def least_s(self, ops_per_s: float = FP32_OPS_PER_S) -> float:
        return max(self.ops / ops_per_s, self.nbytes / HBM_BYTES_PER_S)


def spmm(nnz: int, n: int, d: int) -> Work:
    """One ``A @ X``: entries, row offsets and ``X`` read, the result written."""
    return Work(2.0 * nnz * d, nnz * (IDX + F32) + (n + 1) * IDX + 2.0 * n * d * F32)


def forward(nnz: int, n: int, d: int, layers: int) -> Work:
    """The propagation of a forward: K products and the layer mean (the K+1
    layer outputs read once, the mean written once)."""
    return layers * spmm(nnz, n, d) + Work((layers + 1) * n * d, (layers + 2) * n * d * F32)


def train_step(nnz: int, n: int, d: int, layers: int, batch: int) -> Work:
    """One training step: the forward, its backward (the same K products on
    the cotangent, A being symmetric), the BPR + L2 loss over the batch's
    rows and its gradient, and Adam over every table."""
    prop = forward(nnz, n, d, layers)
    rows = 3 * batch  # users, positives, negatives
    loss = Work(2 * (4 * rows * d), 2 * (2 * rows * d * F32 + rows * IDX))
    adam = Work(ADAM_OPS * n * d, 7 * n * d * F32)
    return 2 * prop + loss + adam


def ranking(users: int, items: int, d: int, seen: int, k: int) -> Work:
    """Full-catalog scores of ``users`` with masking and top-k: the user and
    item rows, the ``seen`` filter entries and the held-out items read once,
    the top-k written once, 2·U·I·d operations.  The [U, I] score matrix is
    not counted: an implementation need not write it."""
    return Work(2.0 * users * items * d,
                (users + items) * d * F32 + seen * IDX + users * IDX + users * k * (IDX + F32))


def share_pct(least_s: float, measured_s: float) -> float:
    """``least_s / measured_s`` in percent.  Above 105% the count is too high
    or the time misses part of the work: that raises, it is never printed."""
    pct = 100.0 * least_s / measured_s
    if pct > MAX_SHARE_PCT:
        raise ValueError(f"share of peak {pct:.2f}% > {MAX_SHARE_PCT}%: the operations or "
                         f"bytes are counted too high, or the time leaves out work")
    return pct


def quant_bound_s(n: int, d: int) -> float:
    """K2: ``x`` [n, d] f32 read once, int8 codes and f32 scales written once."""
    return Work(QUANT_OPS_PER_ELEMENT * n * d, F32 * n * d + n * d + F32 * n).least_s()


def tile_bound_s(layout: str, value_count: int, value_bytes: int, nonzeros: int,
                 num_tiles: int, n_row_blocks: int, row_ptr_len: int, n: int, d: int) -> float:
    """K3, one ``tile_matvec``: the layout's arrays read once (dense: tile
    values, column ids, step pointers; compressed: edge sources, weights,
    row pointers), the [n, d] embedding read once and the row blocks'
    output written once, two operations per nonzero and column; dense
    bf16 tiles on the tensor cores, else float32 outside them."""
    if layout == "dense":
        nbytes = value_count * value_bytes + IDX * num_tiles + IDX * (n_row_blocks + 1)
    else:
        nbytes = value_count * (value_bytes + IDX) + IDX * row_ptr_len
    nbytes += F32 * n * d + F32 * n_row_blocks * TILE * d
    rate = BF16_OPS_PER_S if layout == "dense" and value_bytes == 2 else FP32_OPS_PER_S
    return Work(2.0 * nonzeros * d, nbytes).least_s(rate)


def card() -> dict:
    """The card's name and power limit, as ``nvidia-smi`` reports them."""
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60)
    line = out.stdout.strip().splitlines()[0] if out.returncode == 0 and out.stdout.strip() else ""
    name, _, limit = line.partition(",")
    return {"name": name.strip() or None, "power_limit": limit.strip() or None}
