"""The port's ``LightGCN_Fusion`` against the JAX package, on the CPU.

Same bundle, same content matrix (numpy, from a seed), JAX ``init`` carried
across with ``models/convert.py``:

* forward: all five outputs within 1e-6 (f32; the fusion product and the
  propagation sum in another order), with and without ``fusion_id_init``;
* gradients of the BPR loss against ``jax.grad`` within 1e-6 for the five
  trainable keys; the content buffer takes no gradient and is not in the
  optimizer;
* three Adam steps against the JAX trainer's step, ELL and tile path: loss
  rtol 1e-5, params atol 1e-5 (Adam turns order noise in near-zero
  gradients into differences of up to lr, as in ``test_torch_train.py``);
  the content matrix unchanged bit for bit;
* optax state carried across: the next update equal to atol 1e-5;
* checkpoints, resume, ``Retriever`` against the JAX ``Retriever``, and the
  CLI with ``--model_name LightGCN_Fusion``.
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
from gcn_recommendation_tpu.ops.spmm import to_device_graph as jax_device_graph
from gcn_recommendation_tpu.serve import Retriever as JaxRetriever
from gcn_recommendation_tpu.train.trainer import Trainer as JaxTrainer
from gcn_recommendation_tpu_torch import cli
from gcn_recommendation_tpu_torch.config import Config
from gcn_recommendation_tpu_torch.data.loader import load_preprocessed_data
from gcn_recommendation_tpu_torch.data.synthetic import synthetic_bundle
from gcn_recommendation_tpu_torch.models import (
    LightGCN,
    LightGCN_Fusion,
    get_model,
    register_model,
)
from gcn_recommendation_tpu_torch.models.convert import (
    load_adam_state_from_jax,
    params_from_jax,
)
from gcn_recommendation_tpu_torch.ops.spmm import to_device_graph
from gcn_recommendation_tpu_torch.serve import Retriever
from gcn_recommendation_tpu_torch.train.trainer import Trainer
from gcn_recommendation_tpu_torch.utils import checkpoint as ckpt
from test_torch_serve import assert_same_topk
from test_torch_spmm import one_thread  # noqa: F401  (autouse: one thread)

B = 256
D = 16
TRAINABLE = ("user_embedding", "item_embedding", "brand_embedding", "fusion_kernel",
             "fusion_bias")
ALL_KEYS = TRAINABLE + ("item_content_embedding",)


def _np_tree(tree):
    return {k: np.asarray(v) for k, v in tree.items()}


def _content(num_items, dim, seed=7):
    return np.random.default_rng(seed).standard_normal((num_items, dim)).astype(np.float32)


@pytest.fixture(scope="module")
def bundles():
    return synthetic_bundle(300, 200, 20, seed=0), jax_bundle(300, 200, 20, seed=0)


def _models(bundles, content, tmp=None, **kw):
    """(port model on the CPU, JAX model, port config, JAX config)."""
    b, bj = bundles
    base = dict(embedding_dim=D, n_layers=2, batch_size=B, model_name="LightGCN_Fusion")
    if tmp is not None:
        base.update(checkpoint_dir=str(tmp / "ck"), results_dir=str(tmp / "res"))
    base.update(kw)
    cfg, jcfg = Config(**base), JaxConfig(**base)
    m = get_model("LightGCN_Fusion")(b.num_users, b.num_items, b.num_brands, cfg,
                                     pretrained_item_emb=content, device="cpu")
    jm = jax_get_model("LightGCN_Fusion")(bj.num_users, bj.num_items, bj.num_brands, jcfg,
                                          pretrained_item_emb=content)
    return m, jm, cfg, jcfg


# ------------------------------------------------------------------ the model


def test_registry_builds_fusion_and_registers_models():
    assert get_model("LightGCN_Fusion") is LightGCN_Fusion
    assert issubclass(LightGCN_Fusion, LightGCN)

    class Custom(LightGCN):
        name = "Custom"

    register_model("Custom_for_test", Custom)
    assert get_model("Custom_for_test") is Custom


def test_fusion_requires_content(bundles):
    b, _ = bundles
    with pytest.raises(ValueError, match="LightGCN_Fusion model requires pretrained item "
                                         "embeddings."):
        get_model("LightGCN_Fusion")(b.num_users, b.num_items, b.num_brands, Config(),
                                     device="cpu")


def test_fusion_id_init_checks_the_dim(bundles):
    b, _ = bundles
    with pytest.raises(ValueError, match=r"fusion_id_init needs pretrained dim \(12\)"):
        get_model("LightGCN_Fusion")(
            b.num_users, b.num_items, b.num_brands,
            Config(embedding_dim=D, fusion_id_init=True),
            pretrained_item_emb=_content(b.num_items, 12), device="cpu")


def test_content_is_not_the_item_tables_init(bundles):
    b, _ = bundles
    # a content dim other than the embedding dim would fail the base
    # class's pretrained-dim check if the matrix reached it
    m, *_ = _models(bundles, _content(b.num_items, 12))
    p = m.init(torch.Generator().manual_seed(0))
    assert m.pretrained_item_emb is None and m.content_dim == 12
    assert p["item_embedding"].shape == (b.num_items, D)
    assert float(p["item_embedding"].abs().max()) <= np.sqrt(6.0 / (b.num_items + D))


@pytest.mark.parametrize("id_init", [False, True])
def test_init_shapes_bounds_and_seed(bundles, id_init):
    b, _ = bundles
    cdim = D if id_init else 24
    content = _content(b.num_items, cdim)
    m, *_ = _models(bundles, content, fusion_id_init=id_init)
    p = {k: v.clone() for k, v in m.init(torch.Generator().manual_seed(3)).items()}
    assert tuple(p) == ALL_KEYS == m.param_keys and m.trainable_keys == TRAINABLE
    fan_in = D + cdim
    assert p["fusion_kernel"].shape == (fan_in, D) and p["fusion_bias"].shape == (D,)
    assert float(p["fusion_kernel"].abs().max()) <= np.sqrt(6.0 / (fan_in + D))
    assert float(p["fusion_bias"].abs().max()) <= 1.0 / np.sqrt(fan_in)
    assert float(p["fusion_kernel"].std()) > 0 and float(p["fusion_bias"].std()) > 0
    assert torch.equal(p["item_content_embedding"], torch.from_numpy(content))
    assert torch.equal(p["item_embedding"], torch.from_numpy(content)) == id_init
    again = m.init(torch.Generator().manual_seed(3))
    assert all(torch.equal(p[k], again[k]) for k in ALL_KEYS)


def test_content_is_a_buffer_not_a_parameter(bundles, tmp_path):
    b, _ = bundles
    m, _, cfg, _ = _models(bundles, _content(b.num_items, 24), tmp_path)
    assert [n for n, _ in m.named_parameters()] == list(TRAINABLE)
    assert [n for n, _ in m.named_buffers()] == ["item_content_embedding"]
    assert not m.item_content_embedding.requires_grad
    tr = Trainer(cfg, m, b)
    held = tr.optimizer.param_groups[0]["params"]
    assert len(held) == 5 and all(p is getattr(m, k) for p, k in zip(held, TRAINABLE))


@pytest.mark.parametrize("id_init", [False, True], ids=["random_ids", "fusion_id_init"])
def test_forward_matches_jax_apply(bundles, id_init):
    b, bj = bundles
    content = _content(b.num_items, D if id_init else 24)
    m, jm, *_ = _models(bundles, content, fusion_id_init=id_init)
    jp = jm.init(jax.random.PRNGKey(1))
    want = jm.apply(jp, jax_device_graph(bj.graph))
    m.load_params(params_from_jax(_np_tree(jp), m, device="cpu"))
    with torch.no_grad():
        got = m(to_device_graph(b.graph, device="cpu"))
    assert len(got) == len(want) == 5
    for g_, w_ in zip(got, want):
        assert tuple(g_.shape) == tuple(w_.shape)
        np.testing.assert_allclose(g_.detach().numpy(), np.asarray(w_), rtol=0, atol=1e-6)
    # item0, the L2 term's input, is the ID table and not the fused block
    np.testing.assert_array_equal(got[4].detach().numpy(), np.asarray(jp["item_embedding"]))


def test_fusion_kernel_layout_is_fan_in_by_d(bundles):
    """``fusion_kernel`` keeps the JAX layout [d + content_dim, d] (no
    transpose in convert), and the fused block is
    ``leaky_relu(cat(id, content) @ kernel + bias, 0.01)``."""
    b, _ = bundles
    content = _content(b.num_items, 24)
    m, jm, *_ = _models(bundles, content)
    jp = _np_tree(jm.init(jax.random.PRNGKey(2)))
    p = params_from_jax(jp, m, device="cpu")
    assert p["fusion_kernel"].shape == (D + 24, D)
    np.testing.assert_array_equal(p["fusion_kernel"].numpy(), jp["fusion_kernel"])
    m.load_params(p)
    pre = np.concatenate([jp["item_embedding"], content], axis=1).astype(np.float64) @ jp[
        "fusion_kernel"].astype(np.float64) + jp["fusion_bias"]
    want = np.where(pre > 0, pre, 0.01 * pre)
    with torch.no_grad():
        _, fused, _ = m._initial_tables()
    np.testing.assert_allclose(fused.numpy(), want, rtol=0, atol=1e-6)


# ------------------------------------------------- gradients and steps vs JAX


def _batch(bundle, seed):
    rng = np.random.default_rng(seed)
    rows = rng.integers(0, len(bundle.train), B)
    return (bundle.train.user_idx[rows].astype(np.int32),
            bundle.train.item_idx[rows].astype(np.int32),
            rng.integers(0, bundle.num_items, B).astype(np.int32))


def _idx(batch):
    return tuple(torch.from_numpy(a.astype(np.int64)) for a in batch)


@pytest.fixture(scope="module", params=[False, True], ids=["ell", "tiles"])
def jax_steps(request, bundles, tmp_path_factory):
    """JAX: the first gradients, then three Adam steps from one init, with
    the params and the optax state after each."""
    tile = request.param
    b, bj = bundles
    content = _content(b.num_items, 24)
    tmp = tmp_path_factory.mktemp("jaxfusion")
    _, jm, _, jcfg = _models(bundles, content, tmp, tile_spmm=tile, tile_min_fill=32)
    jt = JaxTrainer(jcfg, jm, bj)
    if tile:
        assert type(jt.arrays.graph).__name__ == "TiledDeviceGraph"
    p, o = jt.init_state(jax.random.PRNGKey(0))
    batches = [tuple(jnp.asarray(a) for a in _batch(bj, s)) for s in (1, 2, 3)]
    loss0, g0 = jax.value_and_grad(lambda q: jt._batch_loss(q, jt.arrays, *batches[0]))(p)
    key = jax.random.PRNGKey(5)  # unused: negatives are given
    params, states, losses = [_np_tree(p)], [o], []
    for bt in batches:
        p, o, loss = jt._train_step(p, o, key, jt.arrays, *bt)
        params.append(_np_tree(p))
        states.append(o)
        losses.append(float(loss))
    assert float(loss0) == pytest.approx(losses[0], rel=1e-6)
    return dict(tile=tile, content=content, params=params, states=states, losses=losses,
                g0=_np_tree(g0), batches=[tuple(np.asarray(a) for a in bt) for bt in batches])


def _port_trainer(bundles, ref, tmp, params):
    b, _ = bundles
    m, _, cfg, _ = _models(bundles, ref["content"], tmp, tile_spmm=ref["tile"],
                           tile_min_fill=32)
    m.load_params(params_from_jax(params, m, device="cpu"))
    tr = Trainer(cfg, m, b)
    assert type(tr.graph).__name__ == ("TiledDeviceGraph" if ref["tile"] else "DeviceGraph")
    return tr


def test_gradients_match_jax_grad(bundles, jax_steps, tmp_path):
    ref = jax_steps
    tr = _port_trainer(bundles, ref, tmp_path, ref["params"][0])
    tr.optimizer.zero_grad(set_to_none=True)
    tr.batch_loss(*_idx(ref["batches"][0])).backward()
    for k in TRAINABLE:
        np.testing.assert_allclose(getattr(tr.model, k).grad.numpy(), ref["g0"][k],
                                   rtol=0, atol=1e-6, err_msg=k)
    assert tr.model.item_content_embedding.grad is None
    # JAX stops the content gradient: it is exactly zero there
    assert not ref["g0"]["item_content_embedding"].any()


def test_three_steps_match_the_jax_trainer(bundles, jax_steps, tmp_path):
    ref = jax_steps
    tr = _port_trainer(bundles, ref, tmp_path, ref["params"][0])
    for s in range(3):
        loss = tr.train_step(*_idx(ref["batches"][s]))
        np.testing.assert_allclose(float(loss), ref["losses"][s], rtol=1e-5)
        got = tr.model.params()
        for k in TRAINABLE:
            np.testing.assert_allclose(got[k].numpy(), ref["params"][s + 1][k], rtol=0,
                                       atol=1e-5, err_msg=f"step {s} {k}")
    content = tr.model.params()["item_content_embedding"].numpy()
    np.testing.assert_array_equal(content, ref["content"])
    np.testing.assert_array_equal(ref["params"][3]["item_content_embedding"], ref["content"])


def test_next_update_after_carrying_optax_state(bundles, jax_steps, tmp_path):
    ref = jax_steps
    tr = _port_trainer(bundles, ref, tmp_path, ref["params"][2])
    adam = ref["states"][2][0]  # optax.adam state: (ScaleByAdamState, EmptyState)
    assert set(adam.mu) == set(ALL_KEYS)  # optax keeps moments for the content too
    load_adam_state_from_jax(tr.optimizer, tr.model, np.asarray(adam.count),
                             _np_tree(adam.mu), _np_tree(adam.nu))
    assert len(tr.optimizer.state) == 5
    loss = tr.train_step(*_idx(ref["batches"][2]))
    np.testing.assert_allclose(float(loss), ref["losses"][2], rtol=1e-5)
    for k in TRAINABLE:
        np.testing.assert_allclose(tr.model.params()[k].numpy(), ref["params"][3][k], rtol=0,
                                   atol=1e-5, err_msg=k)


# -------------------------------------------------------------------- convert


def test_convert_raises_on_missing_and_unknown_keys(bundles):
    b, _ = bundles
    m, jm, *_ = _models(bundles, _content(b.num_items, 24))
    jp = _np_tree(jm.init(jax.random.PRNGKey(0)))
    for drop in ("fusion_kernel", "item_content_embedding"):
        with pytest.raises(KeyError, match=drop):
            params_from_jax({k: v for k, v in jp.items() if k != drop}, m, device="cpu")
    with pytest.raises(KeyError, match="unknown keys.*extra"):
        params_from_jax({**jp, "extra": np.zeros(2)}, m, device="cpu")
    # a LightGCN model's keys: Fusion's are not dropped silently
    plain = LightGCN(b.num_users, b.num_items, b.num_brands, Config(embedding_dim=D),
                     device="cpu")
    with pytest.raises(KeyError, match="unknown keys.*fusion_kernel"):
        params_from_jax(jp, plain, device="cpu")
    with pytest.raises(KeyError, match="params hold keys"):
        plain.load_params({k: torch.from_numpy(v.copy()) for k, v in jp.items()})


def test_adam_state_raises_on_bad_moments(bundles, tmp_path):
    b, _ = bundles
    m, _, cfg, _ = _models(bundles, _content(b.num_items, 24), tmp_path)
    tr = Trainer(cfg, m, b)
    zeros = {k: np.zeros(tuple(v.shape), np.float32) for k, v in m.params().items()}
    with pytest.raises(KeyError, match="fusion_bias"):
        load_adam_state_from_jax(tr.optimizer, m, 1,
                                 {k: v for k, v in zeros.items() if k != "fusion_bias"}, zeros)
    with pytest.raises(KeyError, match="unknown keys"):
        load_adam_state_from_jax(tr.optimizer, m, 1, zeros, {**zeros, "other": np.zeros(1)})
    moved = {**zeros, "item_content_embedding": zeros["item_content_embedding"] + 1}
    with pytest.raises(ValueError, match="frozen"):
        load_adam_state_from_jax(tr.optimizer, m, 1, moved, zeros)


# -------------------------------------------------------- checkpoints, resume


def _fit(bundle, content, tmp, epochs, resume=False):
    cfg = Config(embedding_dim=D, n_layers=2, epochs=epochs, batch_size=B, val_interval=2,
                 model_name="LightGCN_Fusion", checkpoint_dir=str(tmp / "ckpt"),
                 results_dir=str(tmp / "results"))
    m = get_model("LightGCN_Fusion")(bundle.num_users, bundle.num_items, bundle.num_brands,
                                     cfg, pretrained_item_emb=content, device="cpu")
    losses = []
    with contextlib.redirect_stdout(io.StringIO()) as out:
        tr = Trainer(cfg, m, bundle)
        run_epoch = tr.run_epoch
        tr.run_epoch = lambda: losses.append(run_epoch()) or losses[-1]
        _, best = tr.fit(resume=resume)
    return tr, cfg, np.concatenate(losses), best, out.getvalue()


def test_checkpoints_round_trip_and_resume_continues(bundles, tmp_path):
    b, _ = bundles
    content = _content(b.num_items, 24)
    _, _, straight, _, out = _fit(b, content, tmp_path / "a", 4)
    assert "Layer 1 brand embedding" not in out
    tr, cfg, first, _, _ = _fit(b, content, tmp_path / "b", 2)
    d = os.path.join(cfg.checkpoint_dir, cfg.checkpoint_name())
    assert "lightgcn_fusion" in d
    for tag in ("best", "last"):
        state = ckpt.load_state(d, tag)
        assert tuple(state["params"]) == ALL_KEYS
        assert sorted(state["optimizer"]["state"]) == [0, 1, 2, 3, 4]
        for i, k in enumerate(TRAINABLE):
            assert state["optimizer"]["state"][i]["exp_avg"].shape == state["params"][k].shape
        np.testing.assert_array_equal(state["params"]["item_content_embedding"].numpy(), content)
    last = ckpt.load_state(d, "last")
    for k in ALL_KEYS:
        assert torch.equal(last["params"][k], tr.model.params()[k])
    _, _, rest, _, out = _fit(b, content, tmp_path / "b", 4, resume=True)
    assert "Resumed from epoch 2" in out
    # same tables, Adam moments and sampling generator: the same losses
    np.testing.assert_allclose(np.concatenate([first, rest]), straight, rtol=1e-6)


# -------------------------------------------------------------------- serving


def test_retriever_matches_jax_retriever(bundles):
    b, bj = bundles
    content = _content(b.num_items, 24)
    m, jm, *_ = _models(bundles, content)
    jp = jm.init(jax.random.PRNGKey(4))
    params = params_from_jax(_np_tree(jp), m, device="cpu")
    users = np.unique(b.train.user_idx)[:64]
    want = JaxRetriever.from_params(jm, jp, bj).recommend(users, k=10)
    got = Retriever.from_params(m, params, b).recommend(users, k=10)
    assert_same_topk(got, (np.asarray(want[0]), np.asarray(want[1])))
    _, i_f = Retriever.from_params(m, params, b).recommend(users, k=20)
    rq = Retriever.from_params(m, params, b, quantize=True)
    assert rq.item_q.dtype == torch.int8 and rq.item_q.shape == (b.num_items, D)
    _, i_q = rq.recommend(users, k=20)
    overlap = np.mean([len(set(i_f[j]) & set(i_q[j])) / 20 for j in range(len(users))])
    assert overlap >= 0.9, overlap


# ------------------------------------------------------------------------ CLI


def _run_cli(argv):
    with contextlib.redirect_stdout(io.StringIO()) as out:
        assert cli.main(argv) == 0
    return out.getvalue()


def test_cli_train_test_recommend_fusion(tiny_bundle, tmp_path):
    _, data_dir = tiny_bundle
    common = ["--processed_dir", data_dir, "--output_root", str(tmp_path), "--device", "cpu",
              "--model_name", "LightGCN_Fusion"]
    out = _run_cli(["train", *common, "--epochs", "2", "--val_interval", "1",
                    "--batch_size", "512", "--tile_spmm", "--tile_min_fill", "16"])
    assert "Loading pretrained item embeddings" in out and "CUDA tile partition" in out
    assert "New best model saved" in out and "Training finished." in out
    d = tmp_path / "exp" / "checkpoints" / "checkpoints" / "best_lightgcn_fusion_core16"
    assert tuple(ckpt.load_state(str(d), "best")["params"]) == ALL_KEYS
    out = _run_cli(["test", *common])
    assert 0.0 < float(out.split("Recall@20: ")[1].split()[0]) <= 1.0
    for extra in ([], ["--int8"]):
        out = _run_cli(["recommend", *common, "--users", "3,7", "--k", "5", *extra])
        lines = [ln for ln in out.splitlines() if ln.startswith("user ")]
        assert len(lines) == 2 and all(len(ln.split()) == 2 + 5 for ln in lines)
        assert ("int8 catalog" in out) == bool(extra)


def test_cli_fusion_id_init_starts_from_the_content(tiny_bundle, tmp_path):
    _, data_dir = tiny_bundle
    _run_cli(["train", "--processed_dir", data_dir, "--output_root", str(tmp_path), "--device",
              "cpu", "--model_name", "LightGCN_Fusion", "--fusion_id_init", "--epochs", "1",
              "--val_interval", "1", "--learning_rate", "0"])
    d = tmp_path / "exp" / "checkpoints" / "checkpoints" / "best_lightgcn_fusion_core16"
    p = ckpt.load_state(str(d), "last")["params"]
    assert torch.equal(p["item_embedding"], p["item_content_embedding"])
    np.testing.assert_array_equal(p["item_content_embedding"].numpy(),
                                  np.load(os.path.join(data_dir, "item_embeddings.npy")))


@pytest.mark.parametrize("mode", ["train", "test", "recommend"])
def test_cli_fusion_without_content_raises_the_models_error(tmp_path, mode):
    from gcn_recommendation_tpu_torch.data.synthetic import generate_synthetic_dataset

    data = generate_synthetic_dataset(str(tmp_path / "data"), num_users=60, num_items=40,
                                      num_brands=4, mean_degree=8.0, core=3, seed=1)
    assert not os.path.exists(os.path.join(data, "item_embeddings.npy"))
    with pytest.raises(ValueError, match="requires pretrained item embeddings"):
        with contextlib.redirect_stdout(io.StringIO()):
            cli.main([mode, "--processed_dir", data, "--device", "cpu",
                      "--model_name", "LightGCN_Fusion"])


def test_cli_loads_content_for_a_registered_fusion_subclass(tiny_bundle, tmp_path):
    """The CLI asks the model class, not its name, whether to load the
    content matrix: a subclass registered under another name gets it."""
    _, data_dir = tiny_bundle

    class FusionVariant(LightGCN_Fusion):
        name = "FusionVariant"

    assert FusionVariant.needs_content and not LightGCN.needs_content
    register_model("FusionVariant_for_test", FusionVariant)
    out = _run_cli(["train", "--processed_dir", data_dir, "--output_root", str(tmp_path),
                    "--device", "cpu", "--model_name", "FusionVariant_for_test",
                    "--epochs", "1", "--val_interval", "1", "--batch_size", "512"])
    assert "Loading pretrained item embeddings" in out and "Training finished." in out
    d = tmp_path / "exp" / "checkpoints" / "checkpoints" / "best_fusionvariant_for_test_core16"
    assert tuple(ckpt.load_state(str(d), "last")["params"]) == ALL_KEYS


def test_loader_reads_what_the_cli_trains_on(tiny_bundle):
    _, data_dir = tiny_bundle
    b = load_preprocessed_data(data_dir, use_brand=True, verbose=False)
    emb = np.load(os.path.join(data_dir, "item_embeddings.npy"))
    assert emb.shape == (b.num_items, 64) and emb.dtype == np.float32
