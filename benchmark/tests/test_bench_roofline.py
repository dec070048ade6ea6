"""Operation and byte counts against hand-worked small shapes, and shares
of a peak that cannot pass 105%."""

import pytest

from benchmark import roofline as rf


def test_spmm_and_forward_counts():
    w = rf.spmm(nnz=10, n=4, d=2)
    assert (w.ops, w.nbytes) == (40, 10 * 8 + 5 * 4 + 2 * 4 * 2 * 4)
    f = rf.forward(nnz=10, n=4, d=2, layers=3)
    # three products, then the layer mean: 4 layer outputs read, 1 written
    assert (f.ops, f.nbytes) == (3 * 40 + 4 * 4 * 2, 3 * 164 + 5 * 4 * 2 * 4)


def test_train_step_count():
    w = rf.train_step(nnz=10, n=4, d=2, layers=3, batch=1)
    loss = (2 * 4 * 3 * 2, 2 * (2 * 3 * 2 * 4 + 3 * 4))
    adam = (12 * 8, 7 * 8 * 4)
    assert (w.ops, w.nbytes) == (2 * 152 + loss[0] + adam[0], 2 * 652 + loss[1] + adam[1])


def test_ranking_count():
    w = rf.ranking(users=2, items=3, d=4, seen=5, k=2)
    assert (w.ops, w.nbytes) == (2 * 2 * 3 * 4, (2 + 3) * 4 * 4 + 5 * 4 + 2 * 4 + 2 * 2 * 8)


def test_least_time_and_bound():
    assert rf.Work(rf.FP32_OPS_PER_S, 0).least_s() == pytest.approx(1.0)
    assert rf.Work(0, rf.HBM_BYTES_PER_S).least_s() == pytest.approx(1.0)
    assert rf.quant_bound_s(1000, 64) == pytest.approx((4 * 64000 + 64000 + 4000) / 3.35e12)


def test_share_of_peak():
    assert rf.share_pct(1.0, 2.0) == pytest.approx(50.0)
    assert rf.share_pct(1.05, 1.0) == pytest.approx(105.0)
    with pytest.raises(ValueError):
        rf.share_pct(1.06, 1.0)


def test_tile_bound():
    # compressed: 10 edges (4-byte value and id each), 129 row pointers, the
    # [4, 2] embedding read and one 128-row block of output written
    nbytes = 10 * 8 + 4 * 129 + 4 * 4 * 2 + 4 * 128 * 2
    assert rf.tile_bound_s("compressed", 10, 4, 10, 2, 1, 129, 4, 2) == pytest.approx(
        nbytes / rf.HBM_BYTES_PER_S)
    # dense bf16 tiles on the tensor cores: bytes still bound a tiny shape
    nbytes = 2 * 128 * 128 * 2 + 4 * 2 + 4 * 2 + 4 * 4 * 2 + 4 * 128 * 2
    assert rf.tile_bound_s("dense", 2 * 128 * 128, 2, 10, 2, 1, 0, 4, 2) == pytest.approx(
        nbytes / rf.HBM_BYTES_PER_S)
