"""The port's experiment-grid tools against the JAX package's root tools.

* ``GRID``, ``LOSS_GRID``, ``REGIMES``, ``EMB_NOISE`` and ``BRAND_STYLE``
  equal the JAX tools' (loaded from ``tools/`` by path, here only);
* the port's ``run_regime_grids.generate`` writes the dataset the JAX
  package's generator writes for the same regime;
* the port's runner and the JAX runner, on one 300-user dataset, write
  the same directory layout, CSV headers and summary codes;
* the port's ``read_runs``, ``orderings``, ``duplicate_spread``,
  ``fmt_table`` and ``fmt_orderings`` equal the JAX tool's on the
  committed ``exp_synth*/`` grids, and its comparison holds a grid against
  itself and flags what leaves the band;
* 100 Adam steps of the grid's variants (pretrained-emb init, brand loss,
  Fusion) from one init on the same batches stay with the JAX trainer's:
  what a long run carries (Adam's moments, the L2 and brand terms, the
  fusion layer) does not drift, and validation gives the same metrics.
"""

import contextlib
import functools
import importlib.util
import io
import math
import os
import re
import shutil

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gcn_recommendation_tpu.config import Config as JaxConfig
from gcn_recommendation_tpu.data import synthetic as jsyn
from gcn_recommendation_tpu.models import get_model as jax_get_model
from gcn_recommendation_tpu.train.trainer import Trainer as JaxTrainer
from gcn_recommendation_tpu_torch.config import Config
from gcn_recommendation_tpu_torch.data.synthetic import synthetic_bundle
from gcn_recommendation_tpu_torch.models import get_model
from gcn_recommendation_tpu_torch.models.convert import params_from_jax
from gcn_recommendation_tpu_torch.train.trainer import Trainer
from gcn_recommendation_tpu_torch.data.parquet import read_columns
from gcn_recommendation_tpu_torch.tools import regime_comparison as rc
from gcn_recommendation_tpu_torch.tools import run_experiments, run_regime_grids
from test_torch_spmm import one_thread  # noqa: F401  (autouse: one thread)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
JAX_GRIDS = ("exp_synth", "exp_synth_dense", "exp_synth_zno", "exp_synth_sport")


def _jax_tool(name):
    spec = importlib.util.spec_from_file_location(
        f"jax_tool_{name}", os.path.join(REPO, "tools", f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_tables_equal_the_jax_tools():
    assert run_experiments.GRID == _jax_tool("run_experiments").GRID
    assert run_experiments.LOSS_GRID == _jax_tool("run_experiments").LOSS_GRID
    assert run_regime_grids.REGIMES == _jax_tool("calibrate_regimes").REGIMES
    jgrids = _jax_tool("run_regime_grids")
    assert run_regime_grids.EMB_NOISE == jgrids.EMB_NOISE
    assert run_regime_grids.BRAND_STYLE == jgrids.BRAND_STYLE
    assert [m[1] for m in rc.REGIME_MAP] == [
        "exp_synth_dense", "exp_synth", "exp_synth_sport", "exp_synth_zno"]


def test_generate_writes_the_jax_regime_dataset(tmp_path, monkeypatch):
    """The dense regime (the misleading content matrix) from both tools."""
    jgrids = _jax_tool("run_regime_grids")
    monkeypatch.setattr(jgrids, "dataset_dir", lambda regime, core=16: str(tmp_path / "jax"))
    with contextlib.redirect_stdout(io.StringIO()):
        want = jgrids.generate("dense")
        got = run_regime_grids.generate("dense", root=str(tmp_path / "port"))
    assert got == run_regime_grids.dataset_dir("dense", 16, str(tmp_path / "port"))
    for name in ("train", "test", "item_brand"):
        a, b = (read_columns(os.path.join(d, f"{name}.parquet")) for d in (got, want))
        assert list(a) == list(b)
        for col in a:
            np.testing.assert_array_equal(a[col], b[col])
    np.testing.assert_array_equal(np.load(os.path.join(got, "item_embeddings.npy")),
                                  np.load(os.path.join(want, "item_embeddings.npy")))


def test_generate_writes_datasets_and_no_results(tmp_path):
    """What tools/grid_lanes.sh runs once before its --skip_generate jobs."""
    with contextlib.redirect_stdout(io.StringIO()):
        run_regime_grids.generate("dense", root=str(tmp_path))
    assert sorted(os.listdir(tmp_path)) == ["dataset"]
    assert os.listdir(tmp_path / "dataset") == ["torch_synthetic_dense"]


def _tree(root):
    return sorted(os.path.relpath(os.path.join(d, f), root)
                  for d, _, files in os.walk(root) for f in files)


def _summary_codes(text):
    tail = text.split("=== Summary (best val Recall@20) ===", 1)[1]
    return re.findall(r"^  (\S+): \d\.\d{4}$", tail, re.M)


def test_runner_layout_equals_the_jax_runner(tmp_path, monkeypatch):
    """Two codes, two epochs, validation every epoch (``Config`` wrapped
    in both packages): the same result files, CSV headers and rows, the
    same checkpoint directory names and summary codes."""
    from gcn_recommendation_tpu import config as jax_config
    from gcn_recommendation_tpu_torch import config as port_config

    data = jsyn.generate_synthetic_dataset(
        str(tmp_path / "data"), num_users=300, num_items=120, num_brands=10, mean_degree=10.0,
        core=4, seed=1, style="latent", embedding_dim=8, emb_noise=0.5)
    for mod in (jax_config, port_config):
        monkeypatch.setattr(mod, "Config", functools.partial(mod.Config, val_interval=1))
    args = ["--processed_dir", data, "--epochs", "2", "--batch_size", "256",
            "--only", "brd,nob_fus", "--grids", "base"]
    out = {}
    for tag, runner, extra in (("jax", _jax_tool("run_experiments"), []),
                               ("port", run_experiments, ["--device", "cpu"])):
        exp = str(tmp_path / tag)
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            if tag == "jax":
                monkeypatch.setattr("sys.argv", ["run_experiments.py", *args, "--exp_name", exp])
                runner.main()
            else:
                runner.main([*args, "--exp_name", exp, *extra])
        out[tag] = (exp, buf.getvalue())
    (jexp, jtext), (pexp, ptext) = out["jax"], out["port"]
    codes = ["base_2e16c_brd", "base_2e16c_nob_fus"]
    assert _summary_codes(jtext) == _summary_codes(ptext) == codes
    assert _tree(os.path.join(jexp, "results")) == _tree(os.path.join(pexp, "results"))
    assert sorted(os.listdir(os.path.join(pexp, "results"))) == codes
    for code in codes:
        assert (os.listdir(os.path.join(jexp, "checkpoints", code))
                == os.listdir(os.path.join(pexp, "checkpoints", code)))
    for rel in _tree(os.path.join(pexp, "results")):
        if not rel.endswith(".csv"):
            continue
        rows = [open(os.path.join(e, "results", rel)).read().splitlines() for e in (jexp, pexp)]
        assert rows[0][0] == rows[1][0]
        assert len(rows[0]) == len(rows[1]) == 3
        if rel.endswith("_epoch_history.csv"):
            assert rows[1][0] == "epoch,avg_loss,recall,ndcg"
            assert [r.split(",")[0] for r in rows[1][1:]] == ["1", "2"]


@pytest.mark.parametrize("grid", JAX_GRIDS)
def test_read_runs_and_orderings_equal_the_jax_tool(grid):
    jrc = _jax_tool("regime_comparison")
    want = jrc.read_runs(os.path.join(REPO, grid))
    got = rc.read_runs(os.path.join(REPO, grid))
    assert len(got) == len(want) > 0
    # pandas' read_csv parses floats to within an ULP, csv + float() exactly
    for w, g in zip(want.to_dict("records"), got):
        assert w.keys() == g.keys()
        for k, v in w.items():
            if isinstance(v, float):
                assert math.isclose(v, g[k], rel_tol=1e-12), (k, w, g)
            else:
                assert v == g[k], (k, w, g)
    jo, po = jrc.orderings(want), rc.orderings(got)
    assert jo.keys() == po.keys()
    for k in jo:
        assert math.isclose(jo[k], po[k], rel_tol=1e-9, abs_tol=1e-15)
    assert math.isclose(jrc.duplicate_spread(want), rc.duplicate_spread(got), abs_tol=1e-15)
    assert jrc.fmt_table(want) == rc.fmt_table(got)
    ref = {(rc._tag(r["code"]), rc._suffix(r["code"])) for r in got[:2]}
    assert jrc.fmt_table(want, ref_suffixes=ref) == rc.fmt_table(got, ref_suffixes=ref)
    assert jrc.fmt_orderings(jo, jo) == rc.fmt_orderings(po, po)


def test_comparison_of_a_grid_with_itself_holds(tmp_path, capsys):
    for port_dir, jax_dir, _ in rc.REGIME_MAP:
        shutil.copytree(os.path.join(REPO, jax_dir, "results"),
                        os.path.join(tmp_path, port_dir, "results"))
    assert rc.main(["--port_root", str(tmp_path)]) == 0
    text = capsys.readouterr().out
    assert text.count("misses: none.") == 4
    assert "codes that hold: 13/13" in text and "codes that hold: 9/9" in text
    assert "| NO |" not in text


def _run(code, best, epoch=20, final=None, ndcg=0.03):
    final = best if final is None else final
    return dict(code=code, best_recall=best, best_ndcg=ndcg, best_epoch=epoch,
                final_recall=final, final_ndcg=ndcg,
                shape=rc.curve_shape(epoch, 150, best, final))


def test_comparison_flags_what_leaves_the_band():
    jax = [_run("base_150e16c_nob", 0.090), _run("base_150e16c_nob_emb", 0.100),
           _run("base_150e16c_brd", 0.091), _run("lase_150e16c_nob", 0.0905)]
    port = [_run("base_150e16c_nob", 0.0925),               # inside the band
            _run("base_150e16c_nob_emb", 0.0890),           # out: R and the emb sign
            _run("base_150e16c_brd", 0.0915, epoch=100)]    # same R, other shape
    cmp = rc.compare(port, jax)
    assert cmp["band"] == rc.MIN_BAND
    assert [r["holds"] for r in cmp["rows"]] == [True, False, False, False]
    assert cmp["misses"] == ["base_150e16c_nob_emb", "base_150e16c_brd", "lase_150e16c_nob",
                             "emb_uplift"]
    # a wide duplicate spread widens the band
    port.append(_run("lase_150e16c_nob", 0.0995))
    assert rc.compare(port, jax)["band"] == pytest.approx(0.007)
    assert rc.ordering_holds(-0.001, 0.002, 0.003) and not rc.ordering_holds(-0.001, 0.004, 0.003)
    assert "| pretrained-emb init vs base | -0.0035 | +0.0100 | NO |" in rc.fmt_comparison(cmp)
    assert "no run" in rc.fmt_comparison(rc.compare([], jax))


def test_second_seed_rows_call_variance_when_they_straddle():
    jax = [_run("base_150e16c_nob", 0.090, ndcg=0.040), _run("base_150e16c_brd", 0.090)]
    port = [_run("base_150e16c_nob", 0.094, ndcg=0.044),   # R and N out of the band
            _run("base_150e16c_brd", 0.090, epoch=100)]    # shape out
    cmp = rc.compare(port, jax)
    second = {"seed43": [_run("base_150e16c_nob", 0.089, ndcg=0.0405),  # R straddles, N not
                         _run("base_150e16c_brd", 0.090, epoch=20)]}     # the JAX shape
    rows = rc.second_seed_rows(cmp, second)
    got = {(r["code"], r["metric"]): r["variance"] for r in rows}
    assert got == {("base_150e16c_nob", "best_recall"): True,
                   ("base_150e16c_nob", "best_ndcg"): False,
                   ("base_150e16c_brd", "shape"): True}
    text = rc.fmt_second_seeds(rows)
    assert "| `base_150e16c_brd` | shape | early-plateau | late-climb | early-plateau (seed43) | yes |" in text
    assert rc.second_seed_rows(cmp, {}) == []


TRAJECTORY_STEPS = 100
TRAJECTORY_CASES = {  # grid suffix: (model, use_brand, brand_loss, use_pretrained_emb)
    "brd_emb": ("LightGCN", True, False, True),
    "loss_brd": ("LightGCN", True, True, False),
    "nob_fus": ("LightGCN_Fusion", False, False, True),
}


@pytest.mark.parametrize("case", sorted(TRAJECTORY_CASES))
def test_long_trajectory_stays_with_jax(case, tmp_path):
    model, use_brand, brand_loss, pretrained = TRAJECTORY_CASES[case]
    kw = dict(style="latent", latent_dim=8, temperature=0.3, mean_degree=16.0, core=4, seed=0)
    b, bj = synthetic_bundle(200, 120, 10, **kw), jsyn.synthetic_bundle(200, 120, 10, **kw)
    content = np.random.default_rng(7).standard_normal((b.num_items, 16)).astype(np.float32)
    content *= 0.1
    cfg = dict(model_name=model, embedding_dim=16, n_layers=3, batch_size=128,
               use_brand=use_brand, brand_loss=brand_loss, use_pretrained_emb=pretrained,
               checkpoint_dir=str(tmp_path / "ck"), results_dir=str(tmp_path / "res"))
    emb = content if pretrained else None
    jt = JaxTrainer(JaxConfig(**cfg), jax_get_model(model)(
        bj.num_users, bj.num_items, bj.num_brands, JaxConfig(**cfg), pretrained_item_emb=emb), bj)
    p, o = jt.init_state(jax.random.PRNGKey(0))
    m = get_model(model)(b.num_users, b.num_items, b.num_brands, Config(**cfg),
                         pretrained_item_emb=emb, device="cpu")
    m.load_params(params_from_jax({k: np.asarray(v) for k, v in p.items()}, m, device="cpu"))
    tr = Trainer(Config(**cfg), m, b)
    step, key = jax.jit(jt._train_step), jax.random.PRNGKey(5)  # negatives are given
    rng = np.random.default_rng(1)
    for _ in range(TRAJECTORY_STEPS):
        rows = rng.integers(0, len(b.train), 128)
        batch = (b.train.user_idx[rows], b.train.item_idx[rows],
                 rng.integers(0, b.num_items, 128))
        p, o, loss_j = step(p, o, key, jt.arrays, *(jnp.asarray(a, jnp.int32) for a in batch))
        loss = tr.train_step(*(torch.from_numpy(np.asarray(a, np.int64)) for a in batch))
        np.testing.assert_allclose(float(loss), float(loss_j), rtol=1e-5)
    for k in tr.model.trainable_keys:
        diff = np.abs(getattr(tr.model, k).detach().numpy() - np.asarray(p[k]))
        if model == "LightGCN_Fusion":
            # a pre-activation of the fusion layer's leaky ReLU that sits at
            # 0 can land on either side in the two float orders; its slope
            # (1 or 0.01) then differs for that item, and Adam moves its row
            # and the kernel entries it feeds apart by a few learning rates
            assert diff.max() <= 5 * tr.config.learning_rate, diff.max()
            assert diff.mean() <= 5e-5, diff.mean()
        else:
            assert diff.max() <= 1e-5, (k, diff.max())
    (recall, ndcg), (recall_j, ndcg_j) = tr.validate(), jt.validate(p)
    assert recall == pytest.approx(recall_j, abs=1e-6)
    assert ndcg == pytest.approx(ndcg_j, abs=1e-6)
