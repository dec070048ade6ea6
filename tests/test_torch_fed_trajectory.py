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

* the tier-1 case: a small bundle of the zno regime's shape, 3 epochs;
  per-step losses to rtol 1e-5, validation recall and NDCG to 1e-6;
* the full case (``slow``): the zno regime's dataset and the
  ``lase_150e16c_brd`` code (LightGCN with brands, seed 43), all 150
  epochs.  It prints each validation's recall on both sides and the
  first epoch at which they differ by more than 0.001, and holds the two
  runs' hold (final / best Recall@20) to 0.01 of each other.  With
  ``FED_TRAJECTORY_CSV`` set it writes the per-validation rows there.

    JAX_PLATFORMS=cpu python -m pytest -q -s -m slow tests/test_torch_fed_trajectory.py
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
from gcn_recommendation_tpu_torch.models.convert import params_from_jax
from gcn_recommendation_tpu_torch.tools import run_regime_grids
from gcn_recommendation_tpu_torch.train.trainer import Trainer

# the zno regime's generator settings at a small size
SMALL_ZNO = dict(mean_degree=15.0, latent_dim=20, temperature=0.40, pop_scale=0.5,
                 style="latent", core=4, seed=3)


@pytest.fixture(autouse=True, scope="module")
def _threads():
    """One intra-op thread for the small case (test workers share the cores);
    the full case sets its own."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def fed_run(bundle_j, bundle_p, cfg_kw, on_step=None, on_val=None):
    """Train both trainers ``cfg_kw["epochs"]`` epochs on the JAX side's
    batches and negatives.  ``on_step(epoch, step, loss_jax, loss_port)``
    and ``on_val(epoch, (recall_j, ndcg_j), (recall_p, ndcg_p))`` see every
    step and validation.  Returns the validation rows."""
    jcfg, cfg = JaxConfig(**cfg_kw), Config(**cfg_kw)
    name = cfg_kw["model_name"]
    jt = JaxTrainer(jcfg, jax_get_model(name)(
        bundle_j.num_users, bundle_j.num_items, bundle_j.num_brands, jcfg), bundle_j)
    key = jax.random.PRNGKey(jcfg.seed)  # Trainer.fit's key schedule
    init_key, key = jax.random.split(key)
    p, o = jt.init_state(init_key)
    m = get_model(name)(bundle_p.num_users, bundle_p.num_items, bundle_p.num_brands, cfg,
                        device="cpu")
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
            p, o, loss_j = step(p, o, k1, a, users[s], pos[s], neg[s])
            loss = tr.train_step(host[0][s], host[1][s], host[2][s])
            if on_step is not None:
                on_step(epoch, s, float(loss_j), float(loss))
        if epoch % jcfg.val_interval == 0:
            vj, vp = jt.validate(p), tr.validate()
            rows.append((epoch, *map(float, vj), *map(float, vp)))
            if on_val is not None:
                on_val(epoch, vj, vp)
    return rows


def test_fed_epochs_stay_with_jax(tmp_path):
    kw = dict(SMALL_ZNO)
    bj = jsyn.synthetic_bundle(600, 400, 30, **kw)
    b = synthetic_bundle(600, 400, 30, **kw)
    cfg = dict(model_name="LightGCN", embedding_dim=32, n_layers=3, batch_size=256,
               use_brand=True, epochs=3, val_interval=1, seed=43,
               checkpoint_dir=str(tmp_path / "ck"), results_dir=str(tmp_path / "res"))
    losses = []

    def on_step(epoch, s, lj, lp):
        losses.append((lj, lp))

    rows = fed_run(bj, b, cfg, on_step=on_step)
    assert len(losses) == 3 * -(-len(b.train) // 256) > 30
    lj, lp = np.array(losses).T
    np.testing.assert_allclose(lp, lj, rtol=1e-5)
    assert lj[-1] < lj[0]  # it trains
    assert [r[0] for r in rows] == [1, 2, 3]
    for _, rj, nj, rp, np_ in rows:
        assert rp == pytest.approx(rj, abs=1e-6)
        assert np_ == pytest.approx(nj, abs=1e-6)
    assert rows[-1][1] > 0


def hold(recalls):
    return recalls[-1] / max(recalls)


@pytest.mark.slow
def test_fed_zno_150_epochs(tmp_path):
    torch.set_num_threads(int(os.environ.get("FED_TRAJECTORY_THREADS", "4")))
    d = run_regime_grids.generate("zno", root=str(tmp_path))
    bj = jloader.load_preprocessed_data(d, use_brand=True, verbose=False)
    b = loader.load_preprocessed_data(d, use_brand=True, verbose=False)
    # 221,755 rows in train.parquet, one per user held out for validation
    assert len(b.train) == len(bj.train) == 221_755 - b.num_users
    cfg = dict(model_name="LightGCN", use_brand=True, epochs=150, core=16, batch_size=2048,
               seed=43, checkpoint_dir=str(tmp_path / "ck"), results_dir=str(tmp_path / "res"))
    t0, ep_losses = time.perf_counter(), {}

    def on_step(epoch, s, lj, lp):
        ep_losses.setdefault(epoch, []).append((lj, lp))

    def on_val(epoch, vj, vp):
        lj, lp = np.array(ep_losses[epoch]).T
        print(f"epoch {epoch:3d}  loss jax {lj.mean():.6f} port {lp.mean():.6f}  "
              f"R@20 jax {float(vj[0]):.6f} port {float(vp[0]):.6f}  "
              f"N@20 jax {float(vj[1]):.6f} port {float(vp[1]):.6f}  "
              f"({time.perf_counter() - t0:.0f} s)", flush=True)

    rows = fed_run(bj, b, cfg, on_step=on_step, on_val=on_val)
    out = os.environ.get("FED_TRAJECTORY_CSV")
    if out:
        with open(out, "w", newline="") as f:
            w = csv.writer(f)
            w.writerow(["epoch", "loss_jax", "loss_port", "recall_jax", "ndcg_jax",
                        "recall_port", "ndcg_port"])
            for e, rj, nj, rp, np_ in rows:
                lj, lp = np.array(ep_losses[e]).T
                w.writerow([e, f"{lj.mean():.7f}", f"{lp.mean():.7f}",
                            f"{rj:.6f}", f"{nj:.6f}", f"{rp:.6f}", f"{np_:.6f}"])
    apart = [e for e, rj, _, rp, _ in rows if abs(rp - rj) > 1e-3]
    rj = [r[1] for r in rows]
    rp = [r[3] for r in rows]
    print(f"first epoch apart by > 0.001 in R@20: {apart[0] if apart else 'none'}")
    print(f"best R@20 jax {max(rj):.6f} port {max(rp):.6f}; final jax {rj[-1]:.6f} "
          f"port {rp[-1]:.6f}; hold jax {hold(rj):.4f} port {hold(rp):.4f}")
    assert abs(hold(rp) - hold(rj)) < 0.01
