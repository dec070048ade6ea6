"""K1's host side on the CPU: the parts tables' descriptors and the
dispatch of ``ops/spmm.py``.

The kernel itself (``csrc/ell_spmm.cu``) runs only on a card
(``tests/test_torch_cuda.py``).  Here: every descriptor tiles its parts
table and its launch exactly; the descriptors point at the graph's own
arrays; a CPU tensor takes the plain version, whose outputs equal those of
the code before the kernel (kept below as ``_before_*``) bit for bit; the
kernel counter stays 0; and the summation order the kernel follows
(``tests/ell_order.py``) is the plain version's at widths up to 4 and
within the stated bound of it beyond.
"""

import numpy as np
import pytest
import torch

from gcn_recommendation_tpu_torch.data.synthetic import synthetic_bundle
from gcn_recommendation_tpu_torch.ops import spmm
from gcn_recommendation_tpu_torch.utils import profiling

from ell_order import kernel_order, sum_order_bound

# the books graph's buckets (width: rows) and a north-star cell's widest
BOOKS = {1: 2, 2: 6, 4: 64, 8: 4314, 16: 17604, 24: 15765, 32: 10893, 40: 7173, 48: 4722,
         56: 3034, 64: 2109, 96: 3565, 128: 1001}
NORTH_STAR_CELL = {1: 5000, 4: 9000, 640: 31, 1024: 660, 2048: 410, 4096: 410, 8192: 201,
                   16384: 105}


@pytest.fixture(scope="module")
def bundle():
    return synthetic_bundle(1000, 700, 30, mean_degree=20.0, core=4, seed=1)


@pytest.mark.parametrize("buckets,hub", [(BOOKS, 1748), (NORTH_STAR_CELL, 0),
                                         ({8: 0, 16: 3, 4: 0}, 5), ({}, 0)])
@pytest.mark.parametrize("zeros_row", [True, False])
def test_descriptor_tiles_the_parts_table_and_the_launch(buckets, hub, zeros_row):
    """Output rows: each bucket's rows once, in bucket order, the hub rows
    left to the caller, the zeros row after them.  Blocks: contiguous from
    0 in issue order, widest first; a wide row a block, eight narrow rows a
    block."""
    widths, rows = list(buckets), list(buckets.values())
    bucket_rows = sum(rows)
    desc, n_blocks = spmm.describe_buckets(widths, rows,
                                           bucket_rows + hub if zeros_row else None)
    covered = np.zeros(bucket_rows + hub + 1, np.int64)
    block = 0
    for b, block0, row0, nb, width, wide in desc:
        assert block0 == block and nb > 0
        covered[row0:row0 + nb] += 1
        if b >= 0:
            assert (width, nb) == (widths[b], rows[b]) and row0 == sum(rows[:b])
            assert wide == (width >= spmm.SPLIT_MIN_WIDTH)
        else:
            assert (row0, nb, width, wide) == (bucket_rows + hub, 1, 0, 0)
        block += nb if wide else -(-nb // spmm.GROUPS_PER_BLOCK)
    assert block == n_blocks
    assert (covered[:bucket_rows] == 1).all() and (covered[bucket_rows:-1] == 0).all()
    assert covered[-1] == int(zeros_row)
    assert list(desc[:, 4]) == sorted(desc[:, 4], reverse=True)  # widest first
    assert sorted(b for b in desc[:, 0] if b >= 0) == [b for b, n in enumerate(rows) if n]


def test_tables_point_at_the_graphs_own_arrays(bundle):
    """Every graph kind builds its parts tables when it is made, and they
    hold the addresses of the graph's ids and weights: no second copy."""
    g = bundle.graph
    dg = spmm.to_device_graph(g, device="cpu")
    for table, idx in ((dg.buckets, dg.bucket_nbr_idx), (dg.buckets_perm, dg.bucket_nbr_idx_perm)):
        assert table.rows == sum(b.nbr_idx.shape[0] for b in g.buckets) + g.dense_mat.shape[0] + 1
        assert table.slots == sum(int(i.numel()) for i in idx)
        t = table.table.numpy()
        desc, n_blocks = spmm.describe_buckets([i.shape[1] for i in idx],
                                               [i.shape[0] for i in idx], table.rows - 1)
        assert table.n_blocks == n_blocks and (t[:, :4] == desc[:, 1:5]).all()
        for e, b in enumerate(desc[:, 0]):
            if b >= 0:
                assert t[e, 4] == idx[b].data_ptr() and t[e, 5] == dg.bucket_nbr_w[b].data_ptr()
    assert spmm.to_device_graph(g, device="cpu", fuse_layers=False).buckets_perm is None
    cg = spmm.to_device_chunked_graph(g, 2, device="cpu")
    for ci, chunk in enumerate(cg.cell_buckets):
        for ti, table in enumerate(chunk):
            assert table.hub_rows == 0 and table.zeros_row
            assert [i.data_ptr() for i in table.idx] == [
                i.data_ptr() for i in cg.chunk_bucket_idx[ci][ti]]


# --------------------------------------------- the code before the kernel


def _before_parts(x, bucket_idx, bucket_w, dense):
    parts = [spmm._bucket_reduce(x, idx, w).to(x.dtype) for idx, w in zip(bucket_idx, bucket_w)]
    if dense.shape[0]:
        parts.append(spmm._hub_rows(dense, x).to(x.dtype))
    parts.append(x.new_zeros((1, x.shape[1])))
    return torch.cat(parts, dim=0)


def _before_product(g, x):
    return _before_parts(x, g.bucket_nbr_idx, g.bucket_nbr_w, g.dense_mat).index_select(
        0, g.gather_idx)


def _before_layer_sum(g, ego, n_layers):
    p = _before_parts(ego, g.bucket_nbr_idx, g.bucket_nbr_w, g.dense_mat)
    s = p.float()
    for _ in range(n_layers - 1):
        p = _before_parts(p, g.bucket_nbr_idx_perm, g.bucket_nbr_w, g.dense_mat_perm)
        s = s + p.float()
    return s.index_select(0, g.gather_idx)


def _before_chunked(g, emb):
    n, d = emb.shape
    c, s = g.num_chunks, len(g.chunk_gather_idx[0])
    chunk_rows = -(-n // c)
    pad = c * chunk_rows - n
    src = torch.cat([emb, emb.new_zeros((pad, d))]) if pad else emb
    zeros_row = emb.new_zeros((1, d), dtype=torch.float32)
    slice_acc = [None] * s
    for ci in range(c):
        sub = src.narrow(0, ci * chunk_rows, chunk_rows)
        for ti in range(s):
            parts = [spmm._bucket_reduce(sub, idx, w)
                     for idx, w in zip(g.chunk_bucket_idx[ci][ti], g.chunk_bucket_w[ci][ti])]
            out_ct = torch.cat(parts + [zeros_row]).index_select(0, g.chunk_gather_idx[ci][ti])
            slice_acc[ti] = out_ct if slice_acc[ti] is None else slice_acc[ti] + out_ct
    acc = torch.cat(slice_acc) if s > 1 else slice_acc[0]
    if g.dense_mat.shape[0]:
        hub = torch.cat([spmm._hub_rows(g.dense_mat, emb), zeros_row])
        acc = acc + hub.index_select(0, g.dense_gather_idx)
    return acc.to(emb.dtype)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_cpu_takes_the_plain_version_as_before(bundle, dtype):
    """On the CPU every kind's product (and the merge-skip layer sum) is
    the code before the kernel, bit for bit; the kernel counter stays 0
    while ``spmm.gathered_rows`` counts the slots and restore rows as
    before."""
    g = bundle.graph
    x = torch.from_numpy(np.random.default_rng(0).standard_normal((g.num_nodes, 24),
                                                                  dtype=np.float32)).to(dtype)
    dg = spmm.to_device_graph(g, dtype, "cpu")
    cg = spmm.to_device_chunked_graph(g, 2, dtype, device="cpu")
    before = spmm.ell_spmm.launches
    with profiling.collect() as rec:
        assert torch.equal(dg.product(x), _before_product(dg, x))
        assert torch.equal(dg.layer_sum(x, 3), _before_layer_sum(dg, x, 3))
        assert torch.equal(cg.product(x), _before_chunked(cg, x))
    assert spmm.ell_spmm.launches == before
    assert rec.counters.get(spmm.KERNEL_SLOTS, 0) == 0
    cells = [t for chunk in cg.cell_buckets for t in chunk]
    restore = sum(int(gi.shape[0]) for chunk in cg.chunk_gather_idx for gi in chunk)
    want = (dg.buckets.slots + g.num_nodes                                   # product
            + dg.buckets.slots + 2 * dg.buckets_perm.slots + g.num_nodes     # layer sum
            + sum(t.slots for t in cells) + restore + g.num_nodes)           # chunked
    assert rec.counters[spmm.GATHERED_ROWS] == want


def test_propagation_refuses_a_device_it_has_no_path_for(bundle):
    g = spmm.to_device_graph(bundle.graph, device="cpu")
    with pytest.raises(ValueError, match="unsupported device"):
        spmm._parts_matvec(torch.empty((bundle.graph.num_nodes, 8), device="meta"),
                           g.buckets, g.dense_mat)
    with pytest.raises(ValueError, match="CUDA device"):
        spmm.ell_spmm(torch.zeros((bundle.graph.num_nodes, 8)), g.buckets)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("width", [1, 2, 4, 24, 128, 1024, 2048])
def test_kernel_order_is_the_plain_sum_up_to_order(width, dtype):
    """The kernel's summation order against ``_bucket_reduce``: the same
    sum of width-1 gathers at widths up to 4 in float32, bit for bit; wider
    (or in bfloat16, where the plain version's bfloat16 products are
    summed by ``torch.sum``) within ``sum_order_bound``."""
    rng = np.random.default_rng(width)
    n, rows, d = 500, 7, 12
    idx = torch.from_numpy(rng.integers(0, n, (rows, width)))
    w = torch.from_numpy(rng.random((rows, width), dtype=np.float32)).to(dtype)
    x = torch.from_numpy(rng.standard_normal((n, d), dtype=np.float32)).to(dtype)
    got, plain = kernel_order(x, idx, w), spmm._bucket_reduce(x, idx, w)
    if width <= spmm.COLSUM_MAX_WIDTH:
        assert torch.equal(got, plain)
    else:
        assert ((got - plain).abs() <= sum_order_bound(x, idx, w)).all()
