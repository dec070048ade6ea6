"""``--compute_dtype bfloat16`` end to end: the port against the JAX package.

Both packages store the propagation in bf16 (the neighbor weights, the hub
matrix, every parts table) and sum in f32; the tables stay f32.  On the
same params, graph and batch, on the CPU:

* the model forward (fused, the default layout of both): each output
  within 2e-2 of its scale, the bound JAX sets for bf16 storage
  (``tests/test_spmm.py:251``): a bf16 rounding is 2^-8 relative, and
  two packages that sum in another order can round a part one unit apart;
* one Adam step of the default ``Trainer``: loss within rtol 1e-2,
  gradients within 2e-2 of their scale, and the updated params within
  1e-5 wherever the gradient stands above that noise.  Adam's first step
  moves an entry by lr * g / (|g| + 1e-8), so where a gradient near zero
  takes the other sign in bf16 noise the two steps lie 2 lr apart, the
  most any entry may differ.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gcn_recommendation_tpu.config import Config as JaxConfig
from gcn_recommendation_tpu.data.synthetic import synthetic_bundle as jax_bundle
from gcn_recommendation_tpu.models import get_model as jax_get_model
from gcn_recommendation_tpu.ops import spmm as jspmm
from gcn_recommendation_tpu.train.trainer import Trainer as JaxTrainer
from gcn_recommendation_tpu_torch.config import Config
from gcn_recommendation_tpu_torch.data.synthetic import synthetic_bundle
from gcn_recommendation_tpu_torch.models import get_model
from gcn_recommendation_tpu_torch.models.convert import params_from_jax
from gcn_recommendation_tpu_torch.ops import spmm
from gcn_recommendation_tpu_torch.train.trainer import Trainer
from test_torch_spmm import one_thread  # noqa: F401  (autouse: one thread)

B = 128
KW = dict(embedding_dim=16, n_layers=3, batch_size=B, compute_dtype="bfloat16")


@pytest.fixture(scope="module")
def bundles():
    return synthetic_bundle(300, 200, 20, seed=0), jax_bundle(300, 200, 20, seed=0)


def _np(tree):
    return {k: np.asarray(v) for k, v in tree.items()}


def test_forward_bf16_matches_jax(bundles):
    b, bj = bundles
    jm = jax_get_model("LightGCN")(bj.num_users, bj.num_items, bj.num_brands, JaxConfig(**KW))
    jp = jm.init(jax.random.PRNGKey(0))
    dj = jspmm.to_device_graph(b.graph, compute_dtype=jnp.bfloat16)  # the port's host graph
    assert len(dj.bucket_nbr_idx_perm) == len(dj.bucket_nbr_idx)
    want = jm.apply(jp, dj)
    m = get_model("LightGCN")(b.num_users, b.num_items, b.num_brands, Config(**KW), device="cpu")
    m.load_params(params_from_jax(_np(jp), m, device="cpu"))
    dg = spmm.to_device_graph(b.graph, compute_dtype=torch.bfloat16, device="cpu")
    assert dg.fused and dg.bucket_nbr_w[0].dtype == torch.bfloat16
    assert dg.dense_mat_perm.dtype == torch.bfloat16
    with torch.no_grad():
        got = [t.detach() for t in m(dg)]
        f32 = [t.detach() for t in m(spmm.to_device_graph(b.graph, device="cpu"))]
    for g_, w_, f_ in zip(got, want, f32):
        assert g_.dtype == torch.float32  # the tables' dtype
        scale = np.abs(np.asarray(w_)).max()
        np.testing.assert_allclose(g_.numpy(), np.asarray(w_), rtol=0, atol=2e-2 * scale)
        # and bf16 storage stays within the same bound of the f32 forward
        np.testing.assert_allclose(g_.numpy(), f_.numpy(), rtol=0, atol=2e-2 * scale)
    # the propagated outputs are not the f32 ones: bf16 storage really ran
    assert not torch.equal(got[0], f32[0])


def test_train_step_bf16_matches_jax(bundles, tmp_path):
    b, bj = bundles
    kw = dict(KW, checkpoint_dir=str(tmp_path / "ck"), results_dir=str(tmp_path / "res"))
    rng = np.random.default_rng(1)
    rows = rng.integers(0, len(b.train), B)
    batch = (b.train.user_idx[rows].astype(np.int32), b.train.item_idx[rows].astype(np.int32),
             rng.integers(0, b.num_items, B).astype(np.int32))

    jcfg = JaxConfig(**kw)
    jt = JaxTrainer(jcfg, jax_get_model("LightGCN")(bj.num_users, bj.num_items, bj.num_brands,
                                                    jcfg), bj)
    p0, o0 = jt.init_state(jax.random.PRNGKey(0))
    args = tuple(jnp.asarray(a) for a in batch)
    loss_j, g_j = jax.value_and_grad(lambda p: jt._batch_loss(p, jt.arrays, *args))(p0)
    p1_j, _, _ = jt._train_step(p0, o0, jax.random.PRNGKey(5), jt.arrays, *args)

    cfg = Config(**kw)
    m = get_model("LightGCN")(b.num_users, b.num_items, b.num_brands, cfg, device="cpu")
    m.load_params(params_from_jax(_np(p0), m, device="cpu"))
    tr = Trainer(cfg, m, b)
    assert tr.graph.fused and tr.graph.bucket_nbr_w[0].dtype == torch.bfloat16
    loss = tr.train_step(*(torch.from_numpy(a.astype(np.int64)) for a in batch))
    assert np.isfinite(float(loss))
    np.testing.assert_allclose(float(loss), float(loss_j), rtol=1e-2)
    lr = cfg.learning_rate
    for k in m.trainable_keys:
        g, gj = getattr(m, k).grad.numpy(), np.asarray(g_j[k])
        scale = np.abs(gj).max()
        np.testing.assert_allclose(g, gj, rtol=0, atol=2e-2 * scale, err_msg=k)
        diff = np.abs(getattr(m, k).detach().numpy() - np.asarray(p1_j[k]))
        assert diff.max() <= 2 * lr + 1e-6, k
        above_noise = np.abs(gj) > 2e-2 * scale
        assert above_noise.mean() > 0.5, k
        assert diff[above_noise].max() <= 1e-5, k
