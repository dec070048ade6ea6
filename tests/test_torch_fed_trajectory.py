"""Whole epochs of the JAX trainer and the port's, fed the same batches.

Each epoch draws its batches and negatives on the JAX side, with the JAX
package's ``epoch_batches`` and ``sample_negatives`` and the key schedule
of ``Trainer.fit`` / ``Trainer._build_epoch_fn`` (outside ``jit``), and
hands the same batch to ``jt._train_step`` and to the port's
``Trainer.train_step``.  Both start from the JAX ``init_state`` params
(carried across by ``params_from_jax``) and validate every
``val_interval`` epochs.  What stays apart between the two is then only
what each computes from the same inputs: the forward, the loss with its
L2 and brand terms, Adam, and the evaluation's tie order.

* the tier-1 cases, 600 x 400 nodes, d = 32, one torch thread: LightGCN
  on a small bundle of the zno regime's shape, 3 epochs, per-step losses
  to rtol 1e-5; LightGCN_Fusion (no brand, the content matrix) on a small
  dataset of the dense regime's generator, 3 epochs run free, per-step
  losses to rtol 1e-4 and the parameters to the grid's Fusion limits (the
  reason is beside the limits), and 1 epoch in which the port takes every
  step from the JAX side's state (``resync``), per-step losses to rtol
  1e-5; validation recall and NDCG to 1e-6 in all;
* the full cases (``slow``), parametrised over (regime, code) at seed 43:
  the zno regime's ``lase_150e16c_brd`` (LightGCN with brands) and the
  dense regime's ``base_150e16c_nob_fus`` (LightGCN_Fusion, no brand), on
  the regime's dataset for ``FED_TRAJECTORY_EPOCHS`` epochs (150) with
  ``FED_TRAJECTORY_THREADS`` torch threads (4).  Each validation prints
  both sides and the committed JAX run's Recall@20 (``FED_TRAJECTORY_CSV``
  appends it there); the end prints the first step at which the losses
  part by more than rtol 1e-5, the first epoch at which Recall@20 or
  NDCG@20 part by more than 0.001, the first epoch at which the fed JAX
  side leaves the committed run, and the mean and signs of the port's
  NDCG@20 minus JAX's.  It holds the two runs' hold (final / best
  Recall@20) to 0.01 of each other.

    FED_TRAJECTORY_EPOCHS=60 FED_TRAJECTORY_CSV=fed.csv JAX_PLATFORMS=cpu python -m pytest \
        -q -s -m slow "tests/test_torch_fed_trajectory.py::test_fed_150_epochs[dense-base_150e16c_nob_fus]"
"""

import csv
import os
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gcn_recommendation_tpu.config import Config as JaxConfig
from gcn_recommendation_tpu.data import loader as jloader
from gcn_recommendation_tpu.data import synthetic as jsyn
from gcn_recommendation_tpu.data.sampler import epoch_batches, sample_negatives
from gcn_recommendation_tpu.models import get_model as jax_get_model
from gcn_recommendation_tpu.train.trainer import Trainer as JaxTrainer
from gcn_recommendation_tpu_torch.config import Config
from gcn_recommendation_tpu_torch.data import loader
from gcn_recommendation_tpu_torch.data.synthetic import synthetic_bundle
from gcn_recommendation_tpu_torch.models import get_model
from gcn_recommendation_tpu_torch.models.convert import load_adam_state_from_jax, params_from_jax
from gcn_recommendation_tpu_torch.tools import run_experiments, run_regime_grids
from gcn_recommendation_tpu_torch.train.trainer import Trainer
from test_torch_spmm import one_thread  # noqa: F401  (autouse: one thread)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# the zno regime's generator settings at a small size
SMALL_ZNO = dict(mean_degree=15.0, latent_dim=20, temperature=0.40, pop_scale=0.5,
                 style="latent", core=4, seed=3)


def fed_run(bundle_j, bundle_p, cfg_kw, on_step=None, on_val=None, content=None,
            resync=False):
    """Train both trainers ``cfg_kw["epochs"]`` epochs on the JAX side's
    batches and negatives.  ``on_step(epoch, step, loss_jax, loss_port)``
    and ``on_val(epoch, (recall_j, ndcg_j), (recall_p, ndcg_p))`` see every
    step and validation.  ``content`` is the item content matrix both
    models get as ``pretrained_item_emb`` (Fusion needs it).  With
    ``resync`` the port takes every step from the JAX side's params and Adam
    moments, so each step compares one step's arithmetic and nothing
    carried over.  Returns the validation rows, the JAX params and the port
    model at the end."""
    jcfg, cfg = JaxConfig(**cfg_kw), Config(**cfg_kw)
    name = cfg_kw["model_name"]
    emb = {} if content is None else dict(pretrained_item_emb=content)
    jt = JaxTrainer(jcfg, jax_get_model(name)(
        bundle_j.num_users, bundle_j.num_items, bundle_j.num_brands, jcfg, **emb), bundle_j)
    key = jax.random.PRNGKey(jcfg.seed)  # Trainer.fit's key schedule
    init_key, key = jax.random.split(key)
    p, o = jt.init_state(init_key)
    m = get_model(name)(bundle_p.num_users, bundle_p.num_items, bundle_p.num_brands, cfg,
                        device="cpu", **emb)
    m.load_params(params_from_jax({k: np.asarray(v) for k, v in p.items()}, m, device="cpu"))
    tr = Trainer(cfg, m, bundle_p)
    step = jax.jit(jt._train_step)
    a, n_steps, bs = jt.arrays, jt.steps_per_epoch, jcfg.batch_size
    rows = []
    for epoch in range(1, jcfg.epochs + 1):
        key, epoch_key = jax.random.split(key)
        perm_key, neg_key, skey = jax.random.split(epoch_key, 3)  # run_epoch's split
        batches = epoch_batches(perm_key, jt.n_train, bs)[:n_steps]
        users = jnp.take(a.train_users, batches)
        pos = jnp.take(a.train_items, batches)
        neg = sample_negatives(neg_key, users, a.user_ptr, a.flat_items,
                               num_items=bundle_j.num_items, n_iters=jt.sampler_iters)
        host = [torch.from_numpy(np.asarray(x, np.int64)) for x in (users, pos, neg)]
        for s in range(n_steps):
            skey, k1 = jax.random.split(skey)
            if resync:
                adam = o[0]  # optax.adam's state: (ScaleByAdamState, EmptyState)
                m.load_params(params_from_jax({k: np.asarray(v) for k, v in p.items()}, m,
                                              device="cpu"))
                load_adam_state_from_jax(tr.optimizer, m, np.asarray(adam.count),
                                         {k: np.asarray(v) for k, v in adam.mu.items()},
                                         {k: np.asarray(v) for k, v in adam.nu.items()})
            p, o, loss_j = step(p, o, k1, a, users[s], pos[s], neg[s])
            loss = tr.train_step(host[0][s], host[1][s], host[2][s])
            if on_step is not None:
                on_step(epoch, s, float(loss_j), float(loss))
        if epoch % jcfg.val_interval == 0:
            vj, vp = jt.validate(p), tr.validate()
            rows.append((epoch, *map(float, vj), *map(float, vp)))
            if on_val is not None:
                on_val(epoch, vj, vp)
    return rows, p, m


def small_zno(tmp_path, monkeypatch):
    return (jsyn.synthetic_bundle(600, 400, 30, **SMALL_ZNO),
            synthetic_bundle(600, 400, 30, **SMALL_ZNO), None)


def small_dense(tmp_path, monkeypatch):
    """The dense regime's generator (its misleading content matrix included)
    at 600 x 400, written once and read by both loaders."""
    monkeypatch.setitem(run_regime_grids.REGIMES, "dense", dict(
        run_regime_grids.REGIMES["dense"], num_users=600, num_items=400, num_brands=20))
    d = run_regime_grids.generate("dense", root=str(tmp_path))
    bj = jloader.load_preprocessed_data(d, use_brand=False, verbose=False)
    b = loader.load_preprocessed_data(d, use_brand=False, verbose=False)
    return bj, b, np.load(Config(processed_data_dir=d).pretrained_emb_path)


def fusion_preactivation(params):
    """``[item ID row, content row] @ fusion_kernel + fusion_bias`` per item,
    in float64: the input of the fusion layer's leaky ReLU."""
    x = np.concatenate([params["item_embedding"], params["item_content_embedding"]], axis=1)
    return x.astype(np.float64) @ params["fusion_kernel"] + params["fusion_bias"]


FUSION = dict(model_name="LightGCN_Fusion", use_brand=False, use_pretrained_emb=True)
# (bundles, the model's Config fields, resync, epochs)
SMALL_CASES = {
    "zno-LightGCN": (small_zno, dict(model_name="LightGCN", use_brand=True), False, 3),
    "dense-LightGCN_Fusion": (small_dense, FUSION, False, 3),
    "dense-LightGCN_Fusion-resync": (small_dense, FUSION, True, 1),
}


@pytest.mark.parametrize("case", list(SMALL_CASES))
def test_fed_epochs_stay_with_jax(tmp_path, monkeypatch, case):
    bundles, model_kw, resync, epochs = SMALL_CASES[case]
    bj, b, content = bundles(tmp_path, monkeypatch)
    cfg = dict(model_kw, embedding_dim=32, n_layers=3, batch_size=256, epochs=epochs,
               val_interval=1, seed=43, checkpoint_dir=str(tmp_path / "ck"),
               results_dir=str(tmp_path / "res"))
    losses = []

    def on_step(epoch, s, lj, lp):
        losses.append((lj, lp))

    rows, p, m = fed_run(bj, b, cfg, on_step=on_step, content=content, resync=resync)
    assert len(losses) == epochs * -(-len(b.train) // 256) > 30
    lj, lp = np.array(losses).T
    rel = np.abs(lp - lj) / np.abs(lj)
    apart = np.flatnonzero(rel > 1e-5)
    diff = {k: np.abs(getattr(m, k).detach().numpy() - np.asarray(p[k])[: getattr(m, k).shape[0]])
            for k in m.trainable_keys}
    print(f"{case}: per-step losses max rel {rel.max():.2e} (step {rel.argmax()} of {len(rel)}), "
          f"first apart by > 1e-5: {apart[0] if len(apart) else 'none'}; params max abs diff "
          + ", ".join(f"{k} {d.max():.1e}" for k, d in diff.items()))
    if model_kw is FUSION:
        n = b.num_items
        zj, zp = (fusion_preactivation({k: np.asarray(v)[:n] for k, v in q.items()})
                  for q in (p, {k: getattr(m, k).detach() for k in m.param_keys}))
        print(f"{case}: fusion pre-activations of opposite sign at the end: "
              f"{int(((zj >= 0) != (zp >= 0)).sum())} of {zj.size}")
    free_fusion = model_kw is FUSION and not resync
    # Fusion run free: the fusion kernel feeds every item row, so the one-step
    # differences of the two float orders (the resync case: at most 3e-7 in
    # a loss and 1e-6 in any parameter, where a step moves one by up to a
    # learning rate, 1e-3) grow through the steep first descent: the losses
    # part by more than 1e-5 from step 77 of 783, by up to 4.0e-5.  Where a
    # fusion pre-activation sits near 0 the two sides can put it on opposite
    # sides for some steps; its slope (1 or 0.01) then differs, and Adam
    # moves the item's row and the kernel column apart (item table 1.3e-3,
    # kernel 6.4e-4, user table 3.2e-5 at the end; `pytest -s` prints them):
    # the parameter limits of the grid's 100-step Fusion trajectory
    # (tests/test_torch_grid.py).
    np.testing.assert_allclose(lp, lj, rtol=1e-4 if free_fusion else 1e-5)
    assert lj[-1] < lj[0]  # it trains
    if free_fusion:
        lr = Config(**cfg).learning_rate
        for k, d in diff.items():
            assert d.max() <= 5 * lr and d.mean() <= 5e-5, (k, d.max(), d.mean())
    if resync:  # the last step's difference alone
        assert max(d.max() for d in diff.values()) <= 1e-6
    assert [r[0] for r in rows] == list(range(1, epochs + 1))
    for _, rj, nj, rp, np_ in rows:
        assert rp == pytest.approx(rj, abs=1e-6)
        assert np_ == pytest.approx(nj, abs=1e-6)
    assert rows[-1][1] > 0


def hold(recalls):
    return recalls[-1] / max(recalls)


# (regime, code, rows of the regime's train.parquet, the committed JAX run of
# the code at seed 43, validated every 5 epochs)
SLOW_CASES = [
    ("zno", "lase_150e16c_brd", 221_755, "exp_synth_zno/results/lase_150e16c_brd"),
    ("dense", "base_150e16c_nob_fus", 667_679,
     "exp_torch_synth_dense/jax_cpu_seed43/results/base_150e16c_nob_fus"),
]


def code_config(code):
    """The ``Config`` fields ``tools/run_experiments.py`` gives a grid code."""
    tag, size, suffix = code.split("_", 2)
    core = int(size.split("e")[1].rstrip("c"))
    grid = {row[0]: row[1:] for row in run_experiments.ALL_GRIDS[tag]}
    model_name, use_brand, brand_loss, use_pretrained, fusion_id_init = grid[suffix]
    return dict(model_name=model_name, use_brand=use_brand, brand_loss=brand_loss,
                use_pretrained_emb=use_pretrained, fusion_id_init=fusion_id_init, core=core)


def committed_recall(run_dir):
    """{epoch: Recall@20} of a committed run's epoch history."""
    (name,) = [f for f in os.listdir(run_dir) if f.endswith("_epoch_history.csv")]
    with open(os.path.join(run_dir, name)) as f:
        return {int(r["epoch"]): float(r["recall"]) for r in csv.DictReader(f)}


def sign_pattern(diffs, tol=1e-6):
    """One character per difference: ``+``, ``-``, or ``0`` within ``tol``."""
    return "".join("+" if x > tol else "-" if x < -tol else "0" for x in diffs)


@pytest.mark.slow
@pytest.mark.parametrize("regime,code,parquet_rows,committed", SLOW_CASES,
                         ids=[f"{r}-{c}" for r, c, _, _ in SLOW_CASES])
def test_fed_150_epochs(tmp_path, regime, code, parquet_rows, committed):
    """The regime's dataset and the grid code at seed 43, fed for
    ``FED_TRAJECTORY_EPOCHS`` (150) epochs on ``FED_TRAJECTORY_THREADS`` (4)
    torch threads, validating every 5.  Each validation prints both sides
    and the committed JAX run's Recall@20; with ``FED_TRAJECTORY_CSV`` set
    each is also appended there as it comes.  The fed JAX side departs from
    the committed run only where the jitted single step and ``Trainer.fit``'s
    epoch function part (a Fusion leaky-ReLU input at 0 can land on either
    side of it in the two float orders): that epoch is printed."""
    torch.set_num_threads(int(os.environ.get("FED_TRAJECTORY_THREADS", "4")))
    epochs = int(os.environ.get("FED_TRAJECTORY_EPOCHS", "150"))
    d = run_regime_grids.generate(regime, root=str(tmp_path))
    kw = code_config(code)
    bj = jloader.load_preprocessed_data(d, use_brand=kw["use_brand"], verbose=False)
    b = loader.load_preprocessed_data(d, use_brand=kw["use_brand"], verbose=False)
    # one row per user held out for validation
    assert len(b.train) == len(bj.train) == parquet_rows - b.num_users
    cfg = dict(kw, epochs=epochs, batch_size=2048, seed=43, processed_data_dir=d,
               checkpoint_dir=str(tmp_path / "ck"), results_dir=str(tmp_path / "res"))
    needs_content = kw["use_pretrained_emb"] or kw["model_name"] == "LightGCN_Fusion"
    content = np.load(Config(**cfg).pretrained_emb_path) if needs_content else None
    ref = committed_recall(os.path.join(REPO, committed))
    out = os.environ.get("FED_TRAJECTORY_CSV")
    if out:
        with open(out, "w", newline="") as f:
            csv.writer(f).writerow(["epoch", "loss_jax", "loss_port", "recall_jax", "ndcg_jax",
                                    "recall_port", "ndcg_port", "ndcg_port_minus_jax"])
    t0, ep_losses, first = time.perf_counter(), {}, {}

    def on_step(epoch, s, lj, lp):
        ep_losses.setdefault(epoch, []).append((lj, lp))
        if "loss" not in first and abs(lp - lj) > 1e-5 * abs(lj):
            first["loss"] = (epoch, s)
            print(f"losses part by > rtol 1e-5 first at epoch {epoch} step {s} "
                  f"(step {sum(map(len, ep_losses.values())) - 1} of the run): "
                  f"jax {lj:.9g} port {lp:.9g}", flush=True)

    def on_val(epoch, vj, vp):
        lj, lp = np.array(ep_losses[epoch]).T
        (rj, nj), (rp, np_) = map(float, vj), map(float, vp)
        print(f"epoch {epoch:3d}  loss jax {lj.mean():.6f} port {lp.mean():.6f}  "
              f"R@20 jax {rj:.6f} port {rp:.6f} committed jax {ref[epoch]:.6f}  "
              f"N@20 jax {nj:.6f} port {np_:.6f} port-jax {np_ - nj:+.6f}  "
              f"({time.perf_counter() - t0:.0f} s)", flush=True)
        if out:
            with open(out, "a", newline="") as f:
                csv.writer(f).writerow([epoch, f"{lj.mean():.7f}", f"{lp.mean():.7f}",
                                        f"{rj:.6f}", f"{nj:.6f}", f"{rp:.6f}", f"{np_:.6f}",
                                        f"{np_ - nj:+.6f}"])

    rows, _, _ = fed_run(bj, b, cfg, on_step=on_step, on_val=on_val, content=content)
    apart = [e for e, rj, nj, rp, np_ in rows if max(abs(rp - rj), abs(np_ - nj)) > 1e-3]
    split = [e for e, rj, *_ in rows if abs(rj - ref[e]) > 1e-5]
    rj = [r[1] for r in rows]
    rp = [r[3] for r in rows]
    dn = [r[4] - r[2] for r in rows]
    print(f"first step apart by > rtol 1e-5 in loss: {first.get('loss', 'none')}")
    print(f"first epoch apart by > 0.001 in R@20 or N@20: {apart[0] if apart else 'none'}")
    print(f"first epoch the fed JAX R@20 leaves the committed run by > 1e-5: "
          f"{split[0] if split else 'none'}")
    print(f"N@20 port - jax over {len(dn)} validations: mean {np.mean(dn):+.6f}, "
          f"signs {sign_pattern(dn)}")
    print(f"best R@20 jax {max(rj):.6f} port {max(rp):.6f}; final jax {rj[-1]:.6f} "
          f"port {rp[-1]:.6f}; hold jax {hold(rj):.4f} port {hold(rp):.4f}")
    print(f"best N@20 jax {max(r[2] for r in rows):.6f} port {max(r[4] for r in rows):.6f}")
    assert abs(hold(rp) - hold(rj)) < 0.01
