"""The port's training slice against the JAX package, on the CPU.

* the per-layer ELL graph's backward (the forward on the cotangent)
  against ``jax.grad`` of ``propagate_ell`` to 1e-5;
* ``bpr_loss_reg`` with and without the brand term to rtol 1e-6;
* one training step from the same params, users, positives and
  negatives, tile path off and on: loss to rtol 1e-5, gradients within
  1e-5 * max|g|, Adam-updated params to atol 1e-5.  The params bound is
  looser on purpose: at step 1 Adam moves each entry by lr * g / (|g| +
  1e-8), which turns summation-order noise in near-zero gradients into
  differences of up to lr;
* a second step after carrying optax's Adam state across
  (``models/convert.py::load_adam_state_from_jax``);
* ``Trainer.fit``, resume, the tile path against the ELL path, the CLI
  (``train`` -> ``test`` -> ``recommend``), checkpoints and the Logger.
"""

import contextlib
import io
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gcn_recommendation_tpu.config import Config as JaxConfig
from gcn_recommendation_tpu.data.synthetic import synthetic_bundle as jax_bundle
from gcn_recommendation_tpu.models import get_model as jax_get_model
from gcn_recommendation_tpu.ops import spmm as jspmm
from gcn_recommendation_tpu.train.loss import bpr_loss_reg as jax_bpr
from gcn_recommendation_tpu.train.trainer import Trainer as JaxTrainer
from gcn_recommendation_tpu.utils.logging import Logger as JaxLogger
from gcn_recommendation_tpu_torch import cli
from gcn_recommendation_tpu_torch.config import Config
from gcn_recommendation_tpu_torch.data.loader import load_preprocessed_data
from gcn_recommendation_tpu_torch.data.synthetic import synthetic_bundle
from gcn_recommendation_tpu_torch.models import get_model
from gcn_recommendation_tpu_torch.models.convert import (
    load_adam_state_from_jax,
    params_from_jax,
)
from gcn_recommendation_tpu_torch.models.lightgcn import LightGCN
from test_torch_spmm import one_thread  # noqa: F401  (autouse: one thread)

PARAM_KEYS = LightGCN.param_keys
from gcn_recommendation_tpu_torch.ops import spmm
from gcn_recommendation_tpu_torch.train.loss import bpr_loss_reg
from gcn_recommendation_tpu_torch.train.trainer import Trainer
from gcn_recommendation_tpu_torch.utils import checkpoint as ckpt
from gcn_recommendation_tpu_torch.utils.logging import Logger

B = 256


def _np(t):
    return np.asarray(t.detach().cpu() if isinstance(t, torch.Tensor) else t)


# --------------------------------------------------------------- propagation


def test_propagate_ell_gradient_matches_jax():
    b = synthetic_bundle(300, 200, 20, seed=0)
    bj = jax_bundle(300, 200, 20, seed=0)
    e = np.random.default_rng(0).standard_normal((b.graph.num_nodes, 16)).astype(np.float32)
    w = np.random.default_rng(1).standard_normal(e.shape).astype(np.float32)
    dj = jspmm.to_device_graph(bj.graph)
    g_jax = jax.grad(lambda x: jnp.sum(jspmm.propagate_ell(
        x, dj.bucket_nbr_idx, dj.bucket_nbr_w, dj.gather_idx, dj.dense_mat) * w))(
        jnp.asarray(e))
    dg = spmm.to_device_graph(b.graph, device="cpu")
    x = torch.from_numpy(e).requires_grad_(True)
    out = spmm.propagate(x, dg)
    (g_port,) = torch.autograd.grad((out * torch.from_numpy(w)).sum(), x)
    np.testing.assert_allclose(g_port.numpy(), np.asarray(g_jax), rtol=0, atol=1e-5)


# ---------------------------------------------------------------------- loss


@pytest.mark.parametrize("brand", [False, True])
def test_bpr_loss_matches_jax(brand):
    rng = np.random.default_rng(3)
    bsz, d, nb = 64, 16, 10
    arrs = [rng.standard_normal((bsz, d)).astype(np.float32) for _ in range(6)]
    kw_j, kw_t = {}, {}
    if brand:
        table = rng.standard_normal((nb, d)).astype(np.float32)
        pb = rng.integers(-1, nb, bsz)  # -1: item without a brand
        nbi = rng.integers(-1, nb, bsz)
        assert (pb < 0).any() and (nbi < 0).any()
        kw_j = dict(brand_loss=True, final_brand_emb=jnp.asarray(table),
                    pos_item_brand_idx=jnp.asarray(pb), neg_item_brand_idx=jnp.asarray(nbi))
        kw_t = dict(brand_loss=True, final_brand_emb=torch.from_numpy(table),
                    pos_item_brand_idx=torch.from_numpy(pb),
                    neg_item_brand_idx=torch.from_numpy(nbi))
    want = float(jax_bpr(*(jnp.asarray(a) for a in arrs), 1e-4, **kw_j))
    got = float(bpr_loss_reg(*(torch.from_numpy(a) for a in arrs), 1e-4, **kw_t))
    np.testing.assert_allclose(got, want, rtol=1e-6)


def test_brand_term_ignores_sentinel_pairs():
    rng = np.random.default_rng(4)
    arrs = [torch.from_numpy(rng.standard_normal((4, 8)).astype(np.float32)) for _ in range(6)]
    table = torch.from_numpy(rng.standard_normal((3, 8)).astype(np.float32))
    pb, nb = torch.tensor([0, -1, 2, 1]), torch.tensor([1, 2, -1, 0])
    full = bpr_loss_reg(*arrs, 0.0, brand_loss=True, final_brand_emb=table,
                        pos_item_brand_idx=pb, neg_item_brand_idx=nb)
    # the same loss from the two valid pairs alone (brand term = their mean)
    keep = torch.tensor([0, 3])
    base = bpr_loss_reg(*arrs, 0.0)
    brand_pos = (arrs[0][keep] * table[pb[keep]]).sum(1)
    brand_neg = (arrs[0][keep] * table[nb[keep]]).sum(1)
    brand = -torch.log(torch.sigmoid(brand_pos - brand_neg) + 1e-8).mean()
    torch.testing.assert_close(full, base + 0.1 * brand)


# ------------------------------------------------------- one step against JAX


@pytest.fixture(scope="module")
def bundles():
    return synthetic_bundle(300, 200, 20, seed=0), jax_bundle(300, 200, 20, seed=0)


def _configs(tile, tmp):
    kw = dict(embedding_dim=16, n_layers=2, batch_size=B, tile_spmm=tile, tile_min_fill=32,
              checkpoint_dir=str(tmp / "ck"), results_dir=str(tmp / "res"))
    return Config(**kw), JaxConfig(**kw)


def _batch(bundle, seed):
    rng = np.random.default_rng(seed)
    rows = rng.integers(0, len(bundle.train), B)
    users = bundle.train.user_idx[rows].astype(np.int32)
    pos = bundle.train.item_idx[rows].astype(np.int32)
    neg = rng.integers(0, bundle.num_items, B).astype(np.int32)
    return users, pos, neg


@pytest.fixture(scope="module", params=[False, True], ids=["ell", "tiles"])
def two_steps(request, bundles, tmp_path_factory):
    """JAX: two Adam steps from one init; the gradients of the first."""
    tile = request.param
    _, bj = bundles
    _, jcfg = _configs(tile, tmp_path_factory.mktemp("jax"))
    jm = jax_get_model("LightGCN")(bj.num_users, bj.num_items, bj.num_brands, jcfg)
    jt = JaxTrainer(jcfg, jm, bj)
    if tile:
        assert type(jt.arrays.graph).__name__ == "TiledDeviceGraph"
    p0, o0 = jt.init_state(jax.random.PRNGKey(0))
    batches = [tuple(jnp.asarray(a) for a in _batch(bj, s)) for s in (1, 2)]
    loss0, g0 = jax.value_and_grad(lambda p: jt._batch_loss(p, jt.arrays, *batches[0]))(p0)
    key = jax.random.PRNGKey(5)  # unused: negatives are given
    p1, o1, _ = jt._train_step(p0, o0, key, jt.arrays, *batches[0])
    p2, _, loss1 = jt._train_step(p1, o1, key, jt.arrays, *batches[1])
    as_np = lambda tree: {k: np.asarray(v) for k, v in tree.items()}  # noqa: E731
    return dict(tile=tile, p0=as_np(p0), p1=as_np(p1), p2=as_np(p2), o1=o1, g0=as_np(g0),
                loss0=float(loss0), loss1=float(loss1),
                batches=[tuple(np.asarray(a) for a in b) for b in batches])


def _port_trainer(bundles, tile, tmp, params):
    b, _ = bundles
    cfg, _ = _configs(tile, tmp)
    m = get_model("LightGCN")(b.num_users, b.num_items, b.num_brands, cfg, device="cpu")
    m.load_params(params_from_jax(params, m, device="cpu"))
    tr = Trainer(cfg, m, b)
    assert type(tr.graph).__name__ == ("TiledDeviceGraph" if tile else "DeviceGraph")
    return tr


def _idx(batch):
    return tuple(torch.from_numpy(a.astype(np.int64)) for a in batch)


def test_one_step_matches_jax(bundles, two_steps, tmp_path):
    ref = two_steps
    tr = _port_trainer(bundles, ref["tile"], tmp_path, ref["p0"])
    loss = tr.train_step(*_idx(ref["batches"][0]))
    np.testing.assert_allclose(float(loss), ref["loss0"], rtol=1e-5)
    for k in PARAM_KEYS:
        g, gj = getattr(tr.model, k).grad.numpy(), ref["g0"][k]
        np.testing.assert_allclose(g, gj, rtol=0, atol=1e-5 * np.abs(gj).max(), err_msg=k)
        np.testing.assert_allclose(_np(getattr(tr.model, k)), ref["p1"][k], rtol=0, atol=1e-5,
                                   err_msg=k)


def test_second_step_after_carrying_optax_state(bundles, two_steps, tmp_path):
    ref = two_steps
    tr = _port_trainer(bundles, ref["tile"], tmp_path, ref["p1"])
    adam = ref["o1"][0]  # optax.adam state: (ScaleByAdamState, EmptyState)
    load_adam_state_from_jax(
        tr.optimizer, tr.model, np.asarray(adam.count),
        {k: np.asarray(v) for k, v in adam.mu.items()},
        {k: np.asarray(v) for k, v in adam.nu.items()},
    )
    loss = tr.train_step(*_idx(ref["batches"][1]))
    np.testing.assert_allclose(float(loss), ref["loss1"], rtol=1e-5)
    for k in PARAM_KEYS:
        np.testing.assert_allclose(_np(getattr(tr.model, k)), ref["p2"][k], rtol=0, atol=1e-5,
                                   err_msg=k)


# ------------------------------------------------------------ fit and resume


def _fit_config(tmp, **kw):
    base = dict(embedding_dim=16, n_layers=2, epochs=6, batch_size=B, val_interval=3,
                checkpoint_dir=str(tmp / "ckpt"), results_dir=str(tmp / "results"))
    base.update(kw)
    return Config(**base)


@pytest.fixture(scope="module")
def port_tiny(tiny_bundle):
    _, data_dir = tiny_bundle
    return load_preprocessed_data(data_dir, use_brand=True, verbose=False)


def _fit(bundle, cfg, resume=False):
    m = get_model("LightGCN")(bundle.num_users, bundle.num_items, bundle.num_brands, cfg,
                              device="cpu")
    logger = Logger(cfg.results_dir, cfg.logger_name(), top_k=cfg.top_k)
    with contextlib.redirect_stdout(io.StringIO()) as out:
        tr = Trainer(cfg, m, bundle, logger=logger)
        params, best = tr.fit(resume=resume)
    return tr, logger, best, out.getvalue()


def test_fit_learns_and_writes_checkpoints(port_tiny, tmp_path):
    cfg = _fit_config(tmp_path)
    tr, logger, best, out = _fit(port_tiny, cfg)
    losses = np.asarray(logger.history["batch_loss"]).reshape(cfg.epochs, -1)
    assert np.isfinite(losses).all() and losses[-1].mean() < losses[0].mean()
    # random ranking recall@20 over 200 items is ~0.1
    assert best > 0.12 and "New best model saved" in out
    d = os.path.join(cfg.checkpoint_dir, cfg.checkpoint_name())
    for tag in ("best", "last"):
        state = ckpt.load_state(d, tag)
        assert set(state) == {"params", "optimizer", "epoch", "best_recall", "generator"}
    assert ckpt.load_state(d, "last")["epoch"] == 6
    assert ckpt.load_state(d, "best")["best_recall"] == pytest.approx(best)
    assert os.path.exists(os.path.join(cfg.results_dir, "LightGCN_brand_epoch_history.csv"))


def test_resume_continues_from_last(port_tiny, tmp_path):
    cfg = _fit_config(tmp_path, epochs=3)
    _, _, best, _ = _fit(port_tiny, cfg)
    d = os.path.join(cfg.checkpoint_dir, cfg.checkpoint_name())
    last = ckpt.load_state(d, "last")
    cfg.epochs = 6
    tr, logger, best2, out = _fit(port_tiny, cfg, resume=True)
    assert "Resumed from epoch 3" in out and "Epoch 1/6" not in out and "Epoch 4/6" in out
    assert logger.history["step"][0] == 3 * tr.steps_per_epoch
    assert best2 >= best
    assert ckpt.load_state(d, "last")["epoch"] == 6
    # the resumed run restored the saved Adam moments, not fresh ones
    assert last["optimizer"]["state"][0]["step"] == 3 * tr.steps_per_epoch


def test_resume_without_checkpoint_starts_fresh(port_tiny, tmp_path):
    _, _, _, out = _fit(port_tiny, _fit_config(tmp_path, epochs=1, val_interval=1), resume=True)
    assert "Resumed" not in out and "Epoch 1/1" in out


def test_tile_path_trains_like_ell(bundles, tmp_path):
    b, _ = bundles
    losses = {}
    for tile in (False, True):
        cfg = _fit_config(tmp_path / str(tile), epochs=2, val_interval=1, tile_spmm=tile,
                          tile_min_fill=32)
        _, logger, _, out = _fit(b, cfg)
        assert ("CUDA tile partition" in out) == tile
        losses[tile] = np.asarray(logger.history["epoch_avg_loss"])
    np.testing.assert_allclose(losses[True], losses[False], rtol=2e-3)


def test_tile_partition_empty_falls_back_to_ell(bundles, tmp_path):
    b, _ = bundles
    cfg = _fit_config(tmp_path, tile_spmm=True, tile_min_fill=10**6)
    m = get_model("LightGCN")(b.num_users, b.num_items, b.num_brands, cfg, device="cpu")
    with contextlib.redirect_stdout(io.StringIO()) as out:
        tr = Trainer(cfg, m, b)
    assert type(tr.graph).__name__ == "DeviceGraph"
    assert "tile partition empty" in out.getvalue()


def test_debug_caps_ten_batches_and_in_step_sampling(port_tiny, tmp_path):
    cfg = _fit_config(tmp_path, debug=True, batch_size=16)
    m = get_model("LightGCN")(port_tiny.num_users, port_tiny.num_items,
                              port_tiny.num_brands, cfg, device="cpu")
    tr = Trainer(cfg, m, port_tiny)
    assert tr.steps_per_epoch == 10
    tr.epoch_presample_max_examples = 0  # draw negatives in-step
    losses = tr.run_epoch()
    assert losses.shape == (10,) and np.isfinite(losses).all()


# ------------------------------------------------------- CLI and checkpoints


def _run_cli(argv):
    with contextlib.redirect_stdout(io.StringIO()) as out:
        assert cli.main(argv) == 0
    return out.getvalue()


def test_cli_train_test_recommend(tiny_bundle, tmp_path):
    _, data_dir = tiny_bundle
    common = ["--processed_dir", data_dir, "--output_root", str(tmp_path), "--device", "cpu"]
    out = _run_cli(["train", *common, "--epochs", "5", "--batch_size", "512"])
    assert "Val Recall@20" in out and "New best model saved" in out
    assert "Training finished." in out
    out = _run_cli(["test", *common])
    recall = float(out.split("Recall@20: ")[1].split()[0])
    assert 0.0 < recall <= 1.0 and "NDCG@20:" in out
    out = _run_cli(["recommend", *common, "--users", "3,7", "--k", "5"])
    lines = [l for l in out.splitlines() if l.startswith("user ")]
    assert len(lines) == 2 and all(len(l.split()) == 2 + 5 for l in lines)
    out = _run_cli(["train", *common, "--epochs", "6", "--val_interval", "1", "--resume"])
    assert "Resumed from epoch 5" in out and "Epoch 6/6" in out


def test_cli_train_with_tiles(tiny_bundle, tmp_path):
    _, data_dir = tiny_bundle
    out = _run_cli(["train", "--processed_dir", data_dir, "--output_root", str(tmp_path),
                    "--device", "cpu", "--epochs", "1", "--val_interval", "1",
                    "--tile_spmm", "--tile_min_fill", "16", "--tile_dtype", "bfloat16"])
    assert "CUDA tile partition" in out and "Val Recall@20" in out


def test_checkpoints_of_both_kinds_serve(tiny_bundle, port_tiny, tmp_path):
    """``load_params`` and the ``recommend`` CLI read the full training
    state that ``fit`` writes as well as a params-only file."""
    _, data_dir = tiny_bundle
    # the CLI's model: dim 64, 3 layers (Config defaults)
    cfg = _fit_config(tmp_path, epochs=1, val_interval=1, embedding_dim=64, n_layers=3)
    _fit(port_tiny, cfg)
    full_dir = os.path.join(cfg.checkpoint_dir, cfg.checkpoint_name())
    params = ckpt.load_params(full_dir, device="cpu")
    state = ckpt.load_state(full_dir, "best")
    for k in PARAM_KEYS:
        assert torch.equal(params[k], state["params"][k])
    only_dir = str(tmp_path / "params_only")
    ckpt.save_params(only_dir, params)
    with pytest.raises(ValueError, match="params only"):
        ckpt.load_state(only_dir, "best")
    outs = []
    for d in (full_dir, only_dir):
        outs.append(_run_cli(["recommend", "--processed_dir", data_dir, "--model_path", d,
                              "--users", "1,2", "--device", "cpu"]))
    assert outs[0].split("Top-")[1] == outs[1].split("Top-")[1]


def test_checkpoint_write_is_atomic(tmp_path, monkeypatch):
    d = str(tmp_path)
    p = {k: torch.ones(2, 2) for k in PARAM_KEYS}
    ckpt.save_params(d, p)

    def crash(obj, path):
        open(path, "wb").write(b"torn")
        raise OSError("disk full")

    monkeypatch.setattr(torch, "save", crash)
    with pytest.raises(OSError):
        ckpt.save_params(d, {k: torch.zeros(2, 2) for k in PARAM_KEYS})
    monkeypatch.undo()
    assert torch.equal(ckpt.load_params(d, device="cpu")["user_embedding"], torch.ones(2, 2))


# -------------------------------------------------------------------- logger


@pytest.mark.parametrize("throughput", [False, True])
def test_logger_csvs_byte_equal_jax(tmp_path, throughput):
    logs = []
    for cls, sub in ((Logger, "port"), (JaxLogger, "jax")):
        lg = cls(str(tmp_path / sub), "LightGCN_brand", top_k=20)
        for s in range(6):
            lg.log_batch_loss(0.7 - 0.01 * s)
        with contextlib.redirect_stdout(io.StringIO()):
            lg.log_epoch_metrics(3, 0.6853333333333333, 0.11666666666666667, 0.04)
            lg.log_epoch_metrics(6, 2.0, 1e-05, 0.0)
            if throughput:
                lg.log_throughput(12345.678)
                lg.log_throughput(1e6)
            lg.save(total_epochs=6)
        logs.append(tmp_path / sub)
    names = ["LightGCN_brand_epoch_history.csv"] + (
        ["LightGCN_brand_throughput.csv"] if throughput else [])
    for name in names:
        assert (logs[0] / name).read_bytes() == (logs[1] / name).read_bytes(), name
    assert os.path.exists(logs[0] / "LightGCN_brand_throughput.csv") == throughput
