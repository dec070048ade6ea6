"""The port's single-process measurement tools against the JAX side, on the CPU.

Each tool of ``gcn_recommendation_tpu_torch/tools/`` runs small with
``--device cpu`` (the plain versions of the kernels; CPU times are only
labels) and is held against the JAX package where the JAX side computes
something deterministic:

* ``utils/timing.py`` refuses a device time on the CPU;
* ``calibrate_regimes``: ``REGIMES`` equals the JAX tool's; at
  ``--epochs 0 --oracle`` its ``bundle:`` line and oracle recall equal the
  JAX tool's; 2 epochs print ``SUMMARY``;
* ``exp_serve``: pipelined and coalesced answers equal ``recommend``'s;
  the daemon mode serves 2 clients;
* ``exp_step_profile``: the graph line equals the JAX build's, every row
  runs, the full steps' first loss equals the port ``Trainer``'s;
* ``exp_topk_mask``: scatter, compare and fixup give the same items as
  each other and as the JAX package's masking of the same scores;
* ``exp_hub_threshold``: hubs and padded rows equal JAX's at each
  threshold, the forward equals the COO oracle;
* ``exp_min_width``: every form equals the fused one;
* ``exp_tile_spmm``: the partition equals JAX's (bit for bit on one graph,
  to rtol 1e-6 in the tile values on the graph each side's ETL built, with
  either side on its numpy ETL path), the errors against ELL stay within
  the tile tests' limits;
* ``card_checks`` passes on the plain version.
"""

import contextlib
import importlib.util
import io
import os
import re
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gcn_recommendation_tpu.data import native_ext as jax_native_ext
from gcn_recommendation_tpu.data.synthetic import synthetic_bundle as jax_bundle
from gcn_recommendation_tpu.graph.build import build_normalized_adjacency as jax_build
from gcn_recommendation_tpu.graph.tiles import partition_tiles as jax_partition
from gcn_recommendation_tpu.ops.topk import masked_topk as jax_masked_topk
from gcn_recommendation_tpu_torch.config import Config
from gcn_recommendation_tpu_torch.data import native_ext as port_native_ext
from gcn_recommendation_tpu_torch.data.synthetic import synthetic_bundle
from gcn_recommendation_tpu_torch.graph.tiles import partition_tiles
from gcn_recommendation_tpu_torch.models import get_model
from gcn_recommendation_tpu_torch.ops.spmm import (
    propagate,
    to_device_coo_graph,
    to_device_graph,
)
from gcn_recommendation_tpu_torch.tools import (
    calibrate_regimes,
    card_checks,
    exp_hub_threshold,
    exp_min_width,
    exp_serve,
    exp_step_profile,
    exp_tile_spmm,
    exp_topk_mask,
    regime_comparison,
    run_regime_grids,
)
from gcn_recommendation_tpu_torch.train.trainer import Trainer
from gcn_recommendation_tpu_torch.utils import timing
from test_torch_spmm import assert_same_graph, one_thread  # noqa: F401  (autouse: one thread)
from test_torch_tiles import port_graph

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SMALL = ["--num_users", "300", "--num_items", "200", "--num_brands", "12"]


def _jax_tool(name):
    spec = importlib.util.spec_from_file_location(
        f"jax_tool_{name}", os.path.join(REPO, "tools", f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _run(main, argv):
    """(result, printed text) of a port tool's ``main(argv)``."""
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        result = main(argv)
    return result, buf.getvalue()


def test_timing_refuses_a_device_time_on_the_cpu():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    calls = []
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        timing.cuda_ms(lambda: calls.append(1))
    with pytest.raises(RuntimeError, match="needs a CUDA device"):
        timing.cuda_windows(lambda: None, device="cpu")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        timing.graph_ms(lambda: None)
    assert calls == []  # nothing ran before the refusal
    assert len(timing.host_windows(lambda: calls.append(1), reps=3, warmup=1)) == 3
    assert len(calls) == 4 and timing.host_ms(lambda: None, device="cpu") >= 0.0
    assert timing.device_line("cpu").startswith("device: cpu")


def test_calibrate_regimes_tables_are_the_jax_tool_s():
    assert calibrate_regimes.REGIMES == _jax_tool("calibrate_regimes").REGIMES
    assert run_regime_grids.REGIMES is calibrate_regimes.REGIMES


def _bundle_line(text):
    line = next(ln for ln in text.splitlines() if ln.startswith("bundle:"))
    return re.sub(r" \([\d.]+s\)$", "", line)


def test_calibrate_regimes_bundle_and_oracle_equal_the_jax_tool_s(monkeypatch, tmp_path):
    argv = ["--num_users", "300", "--num_items", "200", "--num_brands", "10",
            "--mean_degree", "20", "--epochs", "0", "--oracle", "--split", "rank",
            "--pop_df", "3"]
    res, text = _run(calibrate_regimes.main, argv + ["--device", "cpu"])
    jtool = _jax_tool("calibrate_regimes")
    cache_dir = jax.config.jax_compilation_cache_dir
    monkeypatch.chdir(tmp_path)  # the JAX tool's trainer writes under ./exp
    monkeypatch.setattr(sys, "argv", ["calibrate_regimes.py", *argv])
    buf = io.StringIO()
    try:
        with contextlib.redirect_stdout(buf):
            jtool.main()
    finally:
        jax.config.update("jax_compilation_cache_dir", cache_dir)
    jtext = buf.getvalue()
    assert _bundle_line(text) == _bundle_line(jtext)
    oracle = [ln for ln in text.splitlines() if ln.startswith("oracle recall@20")]
    assert oracle == [ln for ln in jtext.splitlines() if ln.startswith("oracle recall@20")]
    assert len(oracle) == 1 and 0 < res["oracle"] <= 1
    assert "SUMMARY" not in text


def test_calibrate_regimes_two_epochs_print_a_summary():
    res, text = _run(calibrate_regimes.main, [
        "--num_users", "200", "--num_items", "120", "--num_brands", "8", "--mean_degree", "20",
        "--epochs", "2", "--val_interval", "1", "--device", "cpu"])
    assert re.search(r"^SUMMARY best R@20=[\d.]+ \(ep\d\) final=[\d.]+ \(ep2\) hold=[\d.]+ "
                     r"peak_frac=[\d.]+$", text, re.M)
    assert 0 <= res["best_recall"] <= 1 and res["hold"] <= 1.0 + 1e-9


SERVE = ["--users", "300", "--items", "200", "--brands", "12", "--batch", "16", "--reqs", "2",
         "--device", "cpu"]


def test_exp_serve_pipelined_and_coalesced_answers_equal_recommend_s():
    res, text = _run(exp_serve.main, SERVE + ["--depths", "1", "4"])
    assert text.splitlines()[0].startswith("device: cpu")
    assert set(res["per_request"]) == {"f32", "int8"}
    for key in ("pipelined", "many"):
        got, want = res["answers"][key], res["answers"]["recommend_" + key]
        assert len(got) == len(want) == 4
        for (gv, gi), (wv, wi) in zip(got, want):
            assert gi.shape == (16, 20)
            np.testing.assert_array_equal(gi, wi)
            np.testing.assert_allclose(gv, wv, rtol=0, atol=1e-6)
        assert all(v["ms_per_req"] > 0 for v in res[key].values())


def test_exp_serve_daemon_serves_two_clients():
    res, text = _run(exp_serve.main, SERVE + ["--daemon", "--daemon_clients", "2",
                                              "--daemon_coalesce", "1", "4",
                                              "--daemon_reqs", "2"])
    rows = res["daemon"]
    assert [(r["catalog"], r["max_coalesce"]) for r in rows] == [
        ("f32", 1), ("f32", 4), ("int8", 1), ("int8", 4)]
    assert all(r["clients"] == 2 and r["qps"] > 0 and r["coalesce"] >= 1 for r in rows)
    assert "coal.factor" in text


@pytest.fixture(scope="module")
def step_profile():
    return _run(exp_step_profile.main, SMALL + ["--chain", "1", "--device", "cpu"])


def test_exp_step_profile_graph_line_is_the_jax_build_s(step_profile):
    res, text = step_profile
    g = jax_bundle(num_users=300, num_items=200, num_brands=12, mean_degree=28.0, core=8,
                   seed=42).graph
    want = (f"graph: nodes={g.num_nodes} nnz={g.nnz} buckets={len(g.buckets)} "
            f"padded_rows={sum(b.nbr_idx.size for b in g.buckets)} "
            f"hubs={len(g.dense_node_ids)}")
    assert res["graph_line"] == want
    assert want in text


def test_exp_step_profile_runs_every_row(step_profile):
    res, text = step_profile
    rows = res["rows"]
    assert len(rows) == 16 and all(np.isfinite(r["wall"]) and r["wall"] > 0
                                   for r in rows.values())
    assert "--- attribution (ms/step; wall) ---" in text
    for label in ("sampler (ladder)", "adam - sgd (ladder)", "batch rows (ladder)",
                  "propagation fwd+bwd", "residual (dot - fwdbwd)", "sampler isolated"):
        assert label in res["attribution"]["wall"]


@pytest.mark.parametrize("row, fuse", [("full_step (per-layer)", False),
                                       ("full_step (fused merge-skip)", True)])
def test_exp_step_profile_first_loss_is_the_trainer_s(step_profile, row, fuse):
    res, _ = step_profile
    b = synthetic_bundle(
        num_users=300, num_items=200, num_brands=12, mean_degree=28.0, core=8, seed=42)
    cfg = Config(embedding_dim=64, n_layers=3, batch_size=2048)
    model = get_model("LightGCN")(b.num_users, b.num_items, b.num_brands, cfg, device="cpu")
    model.load_params(res["params0"])
    class PerLayer(Trainer):  # the default Trainer's twin without the merge-skip views
        def _device_graph(self):
            return to_device_graph(self.bundle.graph, device=self.device, fuse_layers=False)

    tr = (Trainer if fuse else PerLayer)(cfg, model, b)
    assert tr.graph.fused == fuse
    users, pos, neg = (torch.from_numpy(np.asarray(a, np.int64)) for a in res["first_batch"])
    loss = float(tr.train_step(users, pos, neg))
    np.testing.assert_allclose(res["rows"][row]["first_loss"], loss, rtol=1e-6)


@pytest.mark.parametrize("f", [8, 32])
def test_exp_topk_mask_strategies_agree_with_jax_masking(f):
    b, n = 64, 500
    res, text = _run(exp_topk_mask.main, ["--batch", str(b), "--items", str(n),
                                          "--filters", str(f), "--device", "cpu"])
    assert f"F={f:5d} scatter torch.topk" in text
    items = res["items"][f]
    assert set(items) == {"scatter", "fixup", "compare"}
    # the tool's draws, the tool's scores
    rng = np.random.default_rng(0)
    u = torch.from_numpy(rng.standard_normal((b, exp_topk_mask.D)).astype(np.float32))
    it = torch.from_numpy(rng.standard_normal((n, exp_topk_mask.D)).astype(np.float32))
    filt = exp_topk_mask.filter_rows(rng, b, n, f)
    scores = jnp.asarray((u @ it.T).numpy())
    for name in ("scatter", "compare", "fixup"):
        _, jidx = jax_masked_topk(scores, jnp.asarray(filt.astype(np.int32)), exp_topk_mask.K,
                                  strategy=name)
        np.testing.assert_array_equal(items[name], np.asarray(jidx))
        np.testing.assert_array_equal(items[name], items["scatter"])


def test_exp_hub_threshold_hubs_and_rows_are_jax_s_and_forward_is_coo_s():
    thresholds = (128, 32)
    res, _ = _run(exp_hub_threshold.main, SMALL + ["--thresholds", *map(str, thresholds),
                                                   "--chain", "1", "--device", "cpu"])
    jb = jax_bundle(num_users=300, num_items=200, num_brands=12, mean_degree=28.0, core=8,
                    seed=42)
    pb = synthetic_bundle(
        num_users=300, num_items=200, num_brands=12, mean_degree=28.0, core=8, seed=42)
    for row, t in zip(res["rows"], thresholds):
        jg = jax_build(jb.train.user_idx, jb.train.item_idx, jb.num_users, jb.num_items,
                       jb.num_brands, item_brand_item_idx=jb.item_brand.item_idx,
                       item_brand_brand_idx=jb.item_brand.brand_idx, dense_threshold=t)
        assert row["thresh"] == t
        assert row["hubs"] == len(jg.dense_node_ids)
        assert row["padded_rows"] == sum(bk.nbr_idx.size for bk in jg.buckets)
        g = exp_hub_threshold.build_graph(pb, t)
        dg = to_device_graph(g, fuse_layers=False, device="cpu")
        e = torch.from_numpy(np.random.default_rng(t).standard_normal((g.num_nodes, 16))
                             .astype(np.float32))
        ell = propagate(e, dg)
        coo = propagate(e, to_device_coo_graph(g, device="cpu"))
        np.testing.assert_allclose(ell.numpy(), coo.numpy(), rtol=0, atol=1e-5)
    assert res["rows"][1]["hubs"] > res["rows"][0]["hubs"]


@pytest.mark.parametrize("width", [1, 3, 8, 13])
def test_exp_min_width_forms_equal_fused(width):
    rng = np.random.default_rng(width)
    e = torch.from_numpy(rng.standard_normal((500, 16)).astype(np.float32) * 0.1)
    idx, wts = exp_min_width.bucket(rng, width, 700, 500, "cpu")
    want = exp_min_width.fused(e, idx, wts).numpy()
    for name, form in exp_min_width.FORMS.items():
        # the same products summed in another order: rtol 1e-6 of the largest
        np.testing.assert_allclose(form(e, idx, wts).numpy(), want, rtol=1e-6,
                                   atol=1e-6 * np.abs(want).max(), err_msg=name)


def test_exp_min_width_times_every_form():
    res, text = _run(exp_min_width.main, ["--src_rows", "300", "--nb", "400", "--wide_nb", "300",
                                          "--wide_widths", "16", "--device", "cpu"])
    assert [(r["width"], r["form"]) for r in res["rows"]] == [
        (8, "fused"), (8, "colsum"), (8, "grp4"), (8, "grp2"), (16, "fused"), (16, "grp4")]
    assert all(r["ns_per_row"] > 0 for r in res["rows"]) and "ns/gathered-row" in text


TILE = ["--num_users", "1500", "--num_items", "800", "--num_brands", "40"]


def _tile_partition_against_jax():
    """exp_tile_spmm's graph and its tile partition held against JAX's.  The
    host ETL has a native and a numpy path on each side, which agree to about
    2 ULP in the weights, not bitwise: the graphs are held to each other with
    the structure exact and the weights to rtol 1e-6, the partition of one
    graph on both sides bit for bit, and the partition of the port's own
    graph with its tile values to rtol 1e-6.  Returns the last."""
    jb = jax_bundle(num_users=1500, num_items=800, num_brands=40, mean_degree=28.0, core=8,
                    seed=42, style="latent", pop_zipf=0.6, deg_sigma=1.0, spectrum=1.0,
                    split="rank", rank_key="taste")
    g = exp_tile_spmm.bench_bundle(1500, 800, 40).graph
    assert_same_graph(g, jb.graph)
    jp = jax_partition(jb.graph, min_fill=16)
    same, p = (partition_tiles(x, min_fill=16) for x in (port_graph(jb.graph), g))
    for q in (same, p):
        assert q.covered_edges == jp.covered_edges and q.n_row_blocks == jp.n_row_blocks
        np.testing.assert_array_equal(q.tile_col, jp.tile_col)
        np.testing.assert_array_equal(q.step_row, jp.step_row)
    np.testing.assert_array_equal(same.tile_a, jp.tile_a)
    np.testing.assert_allclose(p.tile_a, jp.tile_a, rtol=1e-6)
    return p


@pytest.mark.parametrize("side", [jax_native_ext, port_native_ext], ids=["jax", "port"])
def test_exp_tile_spmm_partition_when_one_side_takes_its_numpy_etl(monkeypatch, side):
    # a test worker whose native build failed (or lost a race to load it)
    # runs the numpy path for the rest of its life, the other side may not
    monkeypatch.setattr(side, "_lib", None)
    monkeypatch.setattr(side, "_load_failed", True)
    assert not side.available()
    _tile_partition_against_jax()


def test_exp_tile_spmm_partition_is_jax_s_and_errors_stay_in_the_tile_limits():
    res, text = _run(exp_tile_spmm.main, TILE + ["--min_fills", "16", "--chain", "1",
                                                 "--device", "cpu"])
    p = _tile_partition_against_jax()
    cases = {c["dtype"]: c for c in res["cases"]}
    assert set(cases) == {"float32", "bfloat16"}
    assert all(c["tiles"] == p.num_tiles and c["covered"] == p.covered_edges
               for c in cases.values())
    assert cases["float32"]["max_err"] <= 1e-4            # tests/test_torch_tiles.py
    assert 0 < cases["bfloat16"]["max_err"] < 2e-2 * cases["bfloat16"]["scale"]
    assert "x vs plain ELL" in text


def test_card_checks_pass_on_the_plain_version():
    res, text = _run(card_checks.main, ["--device", "cpu"])
    assert text.rstrip().endswith("ALL CARD CHECKS PASSED")
    assert res["step_err"] <= 1.0 + 1e-3 and abs(res["mean_bias"]) < 5e-4
    assert res["overlap"] > 0.9 and 0 < res["seed_differ"] < 1


def test_regime_comparison_judges_jax_seeds_with_the_roles_swapped():
    def run(code, best, ndcg=0.03, epoch=20):
        return dict(code=code, best_recall=best, best_ndcg=ndcg, best_epoch=epoch,
                    final_recall=best, final_ndcg=ndcg,
                    shape=regime_comparison.curve_shape(epoch, 150, best, best))

    jax = [run("base_150e16c_nob", 0.090, ndcg=0.040), run("base_150e16c_brd", 0.090)]
    port = [run("base_150e16c_nob", 0.094, ndcg=0.044), run("base_150e16c_brd", 0.090,
                                                            epoch=100)]
    jax_seed = {"jax_cpu_seed44": [run("base_150e16c_nob", 0.095, ndcg=0.0435),
                                   run("base_150e16c_brd", 0.090, epoch=20)]}
    rows = regime_comparison.jax_seed_rows(port, jax, jax_seed)
    got = {(r["code"], r["metric"]): r["variance"] for r in rows}
    assert got == {("base_150e16c_nob", "best_recall"): True,    # 0.090 <= 0.094 <= 0.095
                   ("base_150e16c_nob", "best_ndcg"): False,     # 0.044 above both
                   ("base_150e16c_brd", "shape"): False}         # neither JAX run climbs late
    text = regime_comparison.fmt_second_seeds(rows, ref="port", ours="JAX")
    assert text.startswith("| code | missed | port | JAX | JAX, second seed |")
    assert ("| `base_150e16c_nob` | best_recall | 0.0940 | 0.0900 | 0.0950 (jax_cpu_seed44) "
            "| yes |") in text
    assert regime_comparison.jax_seed_rows(port, jax, {}) == []
