"""The port's profiling hooks on the CPU: spans, counters and ``trace()``.

Spans and counters record nothing unless collection is on; inside
``collect()`` they nest by thread and share ``torch.profiler``'s clock;
the training step, propagation, top-k and validation record the layers
that the benchmark attributes device time to, and the numbers are the
same with collection on or off.  ``trace`` writes a Chrome trace, spans
included, only when ``GCN_TPU_TRACE_DIR`` is set, which ``--profile_dir``
does, and the trainer wraps each epoch in it.
"""

import contextlib
import dataclasses
import json
import os
import threading

import numpy as np
import pytest
import torch

from gcn_recommendation_tpu_torch import cli
from gcn_recommendation_tpu_torch.config import Config
from gcn_recommendation_tpu_torch.data.synthetic import synthetic_bundle
from gcn_recommendation_tpu_torch.graph.build import build_normalized_adjacency
from gcn_recommendation_tpu_torch.models import get_model
from gcn_recommendation_tpu_torch.ops import spmm, topk
from gcn_recommendation_tpu_torch.train.trainer import Trainer
from gcn_recommendation_tpu_torch.utils import profiling
from gcn_recommendation_tpu_torch.utils.profiling import collect, count, span, trace
from test_torch_spmm import one_thread  # noqa: F401  (autouse: one thread)


def test_trace_is_a_no_op_without_the_variable(tmp_path, monkeypatch):
    monkeypatch.delenv("GCN_TPU_TRACE_DIR", raising=False)
    monkeypatch.chdir(tmp_path)
    with trace("step"):
        torch.ones(4).sum()
    assert os.listdir(tmp_path) == []


def test_trace_writes_a_chrome_trace_when_the_variable_is_set(tmp_path, monkeypatch):
    monkeypatch.setenv("GCN_TPU_TRACE_DIR", str(tmp_path))
    with trace("step"):
        (torch.ones(64, 64) @ torch.ones(64, 64)).sum()
    path = tmp_path / "step" / profiling.TRACE_FILE
    assert path.exists()
    events = json.load(open(path))["traceEvents"]
    assert any("mm" in str(e.get("name", "")) for e in events)


def test_profile_dir_flag_sets_the_variable(tmp_path, monkeypatch):
    monkeypatch.delenv("GCN_TPU_TRACE_DIR", raising=False)
    args = cli.build_parser().parse_args(
        ["train", "--processed_dir", "x", "--profile_dir", str(tmp_path), "--device", "cpu"])
    cli._make_config(args)
    try:
        assert os.environ["GCN_TPU_TRACE_DIR"] == str(tmp_path)
    finally:
        monkeypatch.delenv("GCN_TPU_TRACE_DIR", raising=False)
    for mode in ("train", "test", "recommend", "serve"):
        assert cli.build_parser().parse_args([mode]).profile_dir is None


def test_trainer_traces_each_epoch(tmp_path, monkeypatch):
    monkeypatch.setenv("GCN_TPU_TRACE_DIR", str(tmp_path / "traces"))
    b = synthetic_bundle(60, 40, 4, mean_degree=8.0, seed=0)
    cfg = Config(embedding_dim=8, n_layers=1, epochs=2, batch_size=128, val_interval=5,
                 checkpoint_dir=str(tmp_path / "c"), results_dir=str(tmp_path / "r"))
    m = get_model("LightGCN")(b.num_users, b.num_items, b.num_brands, cfg, device="cpu")
    _, best = Trainer(cfg, m, b).fit()
    assert np.isfinite(best)
    assert sorted(os.listdir(tmp_path / "traces")) == ["epoch_1", "epoch_2"]
    assert (tmp_path / "traces" / "epoch_2" / profiling.TRACE_FILE).exists()


def test_span_off_is_the_shared_no_op_and_records_nothing():
    assert not profiling.collecting()
    s = span("train.step")
    assert s is span("spmm.forward") is profiling._NO_SPAN
    with s as inner:
        count("spmm.gathered_rows", 5)
    assert inner is s and profiling._recorder is None
    with collect() as rec:
        pass
    with span("train.step"):  # collection is off again
        count("spmm.gathered_rows", 5)
    assert rec.spans == [] and dict(rec.counters) == {}


def test_spans_nest_by_thread_with_parents_and_native_ids():
    seen = {}

    def worker():
        with span("spmm.backward"):
            with span("spmm.hub"):
                pass
        seen["tid"] = threading.get_native_id()

    with collect() as rec:
        with span("train.step"):
            with span("train.forward"):
                count("spmm.gathered_rows", 3)
            t = threading.Thread(target=worker)
            t.start()
            t.join(timeout=30)
            count("spmm.gathered_rows", 4)
    assert not t.is_alive()
    by_name = {r.name: r for r in rec.spans}
    main = threading.get_native_id()
    assert by_name["train.step"].parent is None and by_name["train.step"].tid == main
    assert by_name["train.forward"].parent == by_name["train.step"].id
    # the other thread's spans nest among themselves, not under the open step
    assert by_name["spmm.backward"].parent is None
    assert by_name["spmm.hub"].parent == by_name["spmm.backward"].id
    assert by_name["spmm.hub"].tid == by_name["spmm.backward"].tid == seen["tid"] != main
    outer = by_name["train.step"]
    for r in rec.spans:
        assert r.start_ns <= r.end_ns
        assert outer.start_ns <= r.start_ns and r.end_ns <= outer.end_ns
    assert rec.counters == {"spmm.gathered_rows": 7}


def test_inner_collect_goes_on_with_the_outer_recorder():
    with collect() as outer:
        with collect() as inner:
            with span("eval.validate"):
                pass
        assert inner is outer and profiling.collecting()
        with span("eval.metrics"):
            pass
    assert not profiling.collecting()
    assert [r.name for r in outer.spans] == ["eval.validate", "eval.metrics"]


def test_a_span_holds_the_profiler_events_recorded_inside_it():
    """Spans read the profiler's clock: an operator's event lies inside
    the span that issued it."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU]) as prof, collect() as rec:
        with span("train.step"):
            (torch.ones(64, 64) @ torch.ones(64, 64)).sum()
    (r,) = rec.spans
    events = [e for e in prof.profiler.kineto_results.events() if e.name() == "aten::mm"]
    assert events
    for e in events:
        assert r.start_ns <= e.start_ns() and e.start_ns() + e.duration_ns() <= r.end_ns


def _bundle(seed=0):
    """A tiny bundle whose graph has hub rows (brand and popular-item
    nodes above degree 10)."""
    b = synthetic_bundle(60, 40, 4, mean_degree=8.0, seed=seed)
    g = build_normalized_adjacency(
        b.train.user_idx, b.train.item_idx, b.num_users, b.num_items, b.num_brands,
        item_brand_item_idx=b.item_brand.item_idx, item_brand_brand_idx=b.item_brand.brand_idx,
        dense_threshold=10)
    assert g.dense_mat.shape[0] > 0
    return dataclasses.replace(b, graph=g)


def _trainer(layout, tmp_path, layers=2):
    b = _bundle()
    cfg = Config(embedding_dim=8, n_layers=layers, batch_size=64, eval_user_batch=16,
                 checkpoint_dir=str(tmp_path / "c"), results_dir=str(tmp_path / "r"))
    m = get_model("LightGCN")(b.num_users, b.num_items, b.num_brands, cfg, device="cpu")
    t = Trainer(cfg, m, b)
    t.init_state()
    if layout == "chunked":
        t.graph = spmm.to_device_chunked_graph(m.padded_graph(b.graph), 2, device="cpu")
    return t


def _batch(t, seed=0):
    g = torch.Generator().manual_seed(seed)
    rows = torch.randint(0, t.n_train, (t.config.batch_size,), generator=g)
    users, pos = t.train_users[rows], t.train_items[rows]
    return users, pos, t.sample_negatives(users)


def _tree(rec):
    """(name, parent's name) of each span, in the order they opened."""
    names = {r.id: r.name for r in rec.spans}
    return [(r.name, names.get(r.parent)) for r in sorted(rec.spans, key=lambda r: r.id)]


@pytest.mark.parametrize("layout", ["ell", "chunked"])
def test_train_step_records_its_layers(layout, tmp_path):
    t = _trainer(layout, tmp_path)
    batch = _batch(t)
    with collect() as rec:
        t.train_step(*batch)
    k = t.config.n_layers
    # the merge-skip ELL path propagates once for all K layers, with a hub
    # product a layer; the chunked layout propagates once a layer
    prop = lambda way: ([(f"spmm.{way}", f"train.{way}")] + [("spmm.hub", f"spmm.{way}")] * k
                        if layout == "ell"
                        else [(f"spmm.{way}", f"train.{way}"), ("spmm.hub", f"spmm.{way}")] * k)
    assert _tree(rec) == [("train.step", None), ("train.forward", "train.step"),
                          *prop("forward"), ("train.loss", "train.step"),
                          ("train.backward", "train.step"), *prop("backward"),
                          ("train.adam", "train.step")]


@pytest.mark.parametrize("layout", ["ell", "chunked"])
def test_gathered_rows_counts_the_slots_the_graph_implies(layout, tmp_path):
    t = _trainer(layout, tmp_path)
    g = t.model.padded_graph(t.bundle.graph)
    k = t.config.n_layers
    if layout == "ell":
        # K layers of ELL slots (padding included) and one restore gather,
        # forward and backward
        slots = sum(b.nbr_idx.size for b in g.buckets)
        want = 2 * (k * slots + g.gather_idx.shape[0])
    else:
        # a layer: every cell's slots and merge gather, and the hub rows'
        # restore; forward and backward
        cg = t.graph
        cells = [(sum(i.numel() for i in bi), gi.numel())
                 for cb, cg_idx in zip(cg.chunk_bucket_idx, cg.chunk_gather_idx)
                 for bi, gi in zip(cb, cg_idx)]
        per_layer = sum(a + b for a, b in cells) + cg.dense_gather_idx.numel()
        assert cg.dense_gather_idx.numel() == g.num_nodes
        want = 2 * k * per_layer
    with collect() as rec:
        t.train_step(*_batch(t))
    assert rec.counters["spmm.gathered_rows"] == want


def test_validate_records_mask_select_and_metrics_per_batch(tmp_path):
    t = _trainer("ell", tmp_path)
    t.validate()  # builds the evaluation batches
    n = len(t._eval_batches)
    assert n > 1
    with collect() as rec:
        t.validate()
    tree = _tree(rec)
    assert tree[0] == ("eval.validate", None)
    assert tree.count(("spmm.forward", "eval.validate")) == 1
    assert tree.count(("topk.mask", "eval.validate")) == n
    assert tree.count(("topk.select", "eval.validate")) == n
    # each batch's hit/NDCG, and the sums' copy to the host
    assert tree.count(("eval.metrics", "eval.validate")) == n + 1
    assert {name for name, _ in tree} == {"eval.validate", "spmm.forward", "spmm.hub",
                                          "topk.mask", "topk.select", "eval.metrics"}


@pytest.mark.parametrize("strategy", ["scatter", "compare"])
def test_masked_topk_records_one_mask_and_one_select(strategy):
    scores = torch.randn(4, 30, generator=torch.Generator().manual_seed(0))
    filt = torch.tensor([[0, 30], [1, 2], [30, 30], [5, 29]])
    with collect() as rec:
        vals, idx = topk.masked_topk(scores, filt, 5, strategy=strategy, stable=True)
    assert _tree(rec) == [("topk.mask", None), ("topk.select", None)]
    ref_vals, ref_idx = topk.masked_topk(scores, filt, 5, strategy=strategy, stable=True)
    assert torch.equal(vals, ref_vals) and torch.equal(idx, ref_idx)


@pytest.mark.parametrize("chunks", [1, 2])
def test_a_graph_upload_records_one_to_device_span(chunks, monkeypatch):
    g = _bundle().graph
    if chunks > 1:  # a knee under the graph's rows: the auto rule chunks it
        monkeypatch.setattr(spmm, "GATHER_KNEE_ROWS", g.num_nodes // 2 + 1)
    with collect() as rec:
        dg = spmm.to_device_graph_auto(g, device="cpu")
    assert isinstance(dg, spmm.ChunkedDeviceGraph) == (chunks > 1)
    assert _tree(rec) == [("spmm.to_device", None)]


@pytest.mark.parametrize("layout", ["ell", "chunked"])
def test_numbers_are_the_same_with_collection_on_or_off(layout, tmp_path):
    runs = []
    for on in (False, True):
        t = _trainer(layout, tmp_path)
        with collect() if on else contextlib.nullcontext():
            losses = [t.train_step(*_batch(t, seed=s)) for s in range(3)]
            metrics = t.validate()
        runs.append(([float(x) for x in losses], metrics, t.params()))
    (l0, m0, p0), (l1, m1, p1) = runs
    assert l0 == l1 and m0 == m1
    for k in p0:
        assert torch.equal(p0[k], p1[k]), k


def test_trace_shows_the_spans_as_ranges(tmp_path, monkeypatch):
    monkeypatch.setenv("GCN_TPU_TRACE_DIR", str(tmp_path))
    t = _trainer("ell", tmp_path / "run")
    batch = _batch(t)
    with trace("step"):
        t.train_step(*batch)
        assert profiling.collecting()
    assert not profiling.collecting()
    events = json.load(open(tmp_path / "step" / profiling.TRACE_FILE))["traceEvents"]
    names = {e.get("name") for e in events}
    for name in ("train.step", "train.forward", "train.loss", "train.backward", "train.adam",
                 "spmm.forward", "spmm.backward", "spmm.hub"):
        assert name in names, name
