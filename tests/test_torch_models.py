"""The port's LightGCN forward against the JAX package's ``apply``.

JAX ``init`` -> numpy -> ``params_from_jax`` -> port ``forward``: the five
outputs agree within 1e-5 (f32; propagation sums in another order).
"""

import jax
import numpy as np
import pytest
import torch

from gcn_recommendation_tpu.config import Config as JaxConfig
from gcn_recommendation_tpu.data.synthetic import synthetic_bundle as jax_bundle
from gcn_recommendation_tpu.models import get_model as jax_get_model
from gcn_recommendation_tpu.ops.spmm import to_device_graph as jax_device_graph
from gcn_recommendation_tpu_torch.config import Config
from gcn_recommendation_tpu_torch.data.synthetic import synthetic_bundle
from gcn_recommendation_tpu_torch.models import get_model
from gcn_recommendation_tpu_torch.models.convert import params_from_jax
from gcn_recommendation_tpu_torch.models.lightgcn import xavier_uniform
from gcn_recommendation_tpu_torch.ops.spmm import to_device_graph
from test_torch_spmm import one_thread  # noqa: F401  (autouse: one thread)


@pytest.fixture(scope="module")
def bundles():
    return synthetic_bundle(120, 80, 8, seed=3), jax_bundle(120, 80, 8, seed=3)


@pytest.mark.parametrize("dim,layers", [(8, 1), (32, 3)])
def test_forward_matches_jax_apply(bundles, dim, layers):
    b, bj = bundles
    jm = jax_get_model("LightGCN")(
        bj.num_users, bj.num_items, bj.num_brands,
        JaxConfig(embedding_dim=dim, n_layers=layers),
    )
    jp = jm.init(jax.random.PRNGKey(dim))
    want = jm.apply(jp, jax_device_graph(bj.graph))

    m = get_model("LightGCN")(
        b.num_users, b.num_items, b.num_brands,
        Config(embedding_dim=dim, n_layers=layers), device="cpu",
    )
    m.load_params(params_from_jax({k: np.asarray(v) for k, v in jp.items()}, m, device="cpu"))
    with torch.no_grad():
        got = m(to_device_graph(b.graph, device="cpu"))
    assert len(got) == len(want) == 5
    for g_, w_ in zip(got, want):
        assert tuple(g_.shape) == tuple(w_.shape)
        np.testing.assert_allclose(g_.detach().numpy(), np.asarray(w_), rtol=1e-5, atol=1e-5)


def test_params_from_jax_rejects_missing_tables():
    with pytest.raises(KeyError, match="brand_embedding"):
        params_from_jax(
            {"user_embedding": np.zeros((2, 4)), "item_embedding": np.zeros((2, 4))},
            get_model("LightGCN")(2, 2, 2, Config(embedding_dim=4), device="cpu"),
            device="cpu",
        )


def test_load_params_checks_shapes(bundles):
    b, _ = bundles
    m = get_model("LightGCN")(b.num_users, b.num_items, b.num_brands,
                              Config(embedding_dim=8), device="cpu")
    bad = {k: torch.zeros((3, 8)) for k in ("user_embedding", "item_embedding", "brand_embedding")}
    with pytest.raises(ValueError, match="shape"):
        m.load_params(bad)


def test_init_is_seeded_xavier(bundles):
    b, _ = bundles
    m = get_model("LightGCN")(b.num_users, b.num_items, b.num_brands,
                              Config(embedding_dim=16), device="cpu")
    p1 = m.init(torch.Generator().manual_seed(0))
    p1 = {k: v.clone() for k, v in p1.items()}
    p2 = m.init(torch.Generator().manual_seed(0))
    for k in p1:
        assert torch.equal(p1[k], p2[k])
    bound = np.sqrt(6.0 / (b.num_users + 16))
    assert float(p1["user_embedding"].abs().max()) <= bound
    x = xavier_uniform((4000, 64), torch.Generator().manual_seed(1))
    assert abs(float(x.std()) - np.sqrt(6.0 / 4064) / np.sqrt(3.0)) < 1e-3


@pytest.mark.parametrize("name,exc", [("NoSuchModel", ImportError), ("lightgcn", ImportError)])
def test_registry_errors(name, exc):
    with pytest.raises(exc, match="known models"):
        get_model(name)
