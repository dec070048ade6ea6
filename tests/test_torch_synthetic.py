"""The port's copy of the synthetic generators against the JAX package's.

Pure numpy in both, the same operations in the same order: the same seed
must give the same arrays bit for bit (the latent-taste generator, the
content-embedding makers, the brand clustering, the in-memory bundle and
the dataset files ``LightGCN_Fusion`` trains on).
"""

import numpy as np
import pytest

from gcn_recommendation_tpu.data import synthetic as jsyn
from gcn_recommendation_tpu.data.loader import load_preprocessed_data as jax_load
from gcn_recommendation_tpu_torch.data import synthetic as syn
from gcn_recommendation_tpu_torch.data.loader import load_preprocessed_data
from test_torch_spmm import assert_same_graph, one_thread  # noqa: F401  (autouse: one thread)

LATENT_CASES = {
    "gaussian": dict(),
    "gaussian_state": dict(return_state=True, temperature=0.5, latent_dim=8),
    "student_t_tail": dict(pop_df=3.0, deg_sigma=1.0, return_latents=True),
    "zipf_spectrum_taste_rank": dict(pop_zipf=0.8, spectrum=1.0, rank_key="taste",
                                     return_latents=True),
    "cluster": dict(taste_style="cluster", clusters_per_user=2, latent_dim=6,
                    return_state=True),
}


def _flat(out):
    flat = []
    for x in out:
        flat.extend(x if isinstance(x, tuple) else [x])
    return flat


@pytest.mark.parametrize("case", sorted(LATENT_CASES))
def test_generate_interactions_latent_bit_equal(case):
    kw = LATENT_CASES[case]
    got = syn.generate_interactions_latent(np.random.default_rng(5), 70, 50, 9.0, 3, **kw)
    want = jsyn.generate_interactions_latent(np.random.default_rng(5), 70, 50, 9.0, 3, **kw)
    got, want = _flat(got), _flat(want)
    assert len(got) == len(want) >= 2
    for a, w in zip(got, want):
        assert a.dtype == w.dtype
        np.testing.assert_array_equal(a, w)
    assert got[0].dtype == np.int32 and len(got[0]) == len(got[1]) > 70 * 3 - 1


@pytest.mark.parametrize("maker", ["informative_item_embeddings", "misleading_item_embeddings"])
@pytest.mark.parametrize("noise", [0.0, 1.5])
def test_item_embedding_makers_bit_equal(maker, noise):
    lv = np.random.default_rng(1).standard_normal((40, 8))
    got = getattr(syn, maker)(np.random.default_rng(2), lv, 12, noise)
    want = getattr(jsyn, maker)(np.random.default_rng(2), lv, 12, noise)
    assert got.dtype == np.float32 and got.shape == (40, 12)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_allclose(np.linalg.norm(got, axis=1), 1.0, rtol=1e-5)


def test_latent_cluster_brands_bit_equal():
    lv = np.random.default_rng(3).standard_normal((60, 6))
    got = syn.latent_cluster_brands(np.random.default_rng(4), lv.copy(), 7)
    want = jsyn.latent_cluster_brands(np.random.default_rng(4), lv.copy(), 7)
    assert got.dtype == np.int32 and got.shape == (60,) and got.max() < 7
    np.testing.assert_array_equal(got, want)


def _assert_same_bundle(b, bj):
    for split in ("train", "val", "test"):
        for f in ("user_idx", "item_idx"):
            np.testing.assert_array_equal(getattr(getattr(b, split), f),
                                          getattr(getattr(bj, split), f))
    np.testing.assert_array_equal(b.item_to_brand, bj.item_to_brand)
    assert b.graph_stats == bj.graph_stats
    assert_same_graph(b.graph, bj.graph)


@pytest.mark.parametrize("kw", [
    dict(style="latent", split="rank", return_latents=True),
    dict(style="latent", split="random", return_latents=True, pop_zipf=0.8, deg_sigma=1.0),
    dict(style="latent", taste_style="cluster", latent_dim=5, split="rank", rank_key="taste"),
    dict(style="popularity"),
], ids=["latent_rank", "latent_random_zipf", "cluster_rank", "popularity"])
def test_synthetic_bundle_bit_equal(kw):
    args = dict(num_users=90, num_items=60, num_brands=6, mean_degree=9.0, core=4, seed=3)
    got, want = syn.synthetic_bundle(**args, **kw), jsyn.synthetic_bundle(**args, **kw)
    if kw.get("return_latents"):
        (got, lat), (want, lat_j) = got, want
        assert len(lat) == len(lat_j) == 3  # user factors, item factors, popularity
        for a, w in zip(lat, lat_j):
            np.testing.assert_array_equal(a, w)
    _assert_same_bundle(got, want)
    if kw.get("split") == "rank":
        # test = each user's first (highest-preference) row, val = the next
        assert len(np.unique(got.test.user_idx)) == len(got.test.user_idx)


def test_rank_split_needs_the_latent_style():
    with pytest.raises(ValueError, match="split='rank' requires style='latent'"):
        syn.synthetic_bundle(30, 20, 3, split="rank")


@pytest.mark.parametrize("kw", [
    dict(style="latent", emb_noise=0.5, brand_style="latent", split="rank"),
    dict(style="latent", emb_noise=0.0, emb_style="mislead"),
    dict(style="latent"),          # no emb_noise: the pure-noise fallback matrix
    dict(style="popularity"),
], ids=["informative_latent_brands_rank", "misleading", "latent_noise_fallback", "popularity"])
def test_dataset_files_bit_equal(tmp_path, kw):
    args = dict(num_users=90, num_items=60, num_brands=6, mean_degree=9.0, core=4, seed=2,
                embedding_dim=8)
    a = syn.generate_synthetic_dataset(str(tmp_path / "a"), **args, **kw)
    b = jsyn.generate_synthetic_dataset(str(tmp_path / "b"), **args, **kw)
    ea, eb = (np.load(f"{d}/item_embeddings.npy") for d in (a, b))
    assert ea.dtype == np.float32 and ea.shape == (60, 8)
    np.testing.assert_array_equal(ea, eb)
    _assert_same_bundle(load_preprocessed_data(a, verbose=False), jax_load(b, verbose=False))


def test_rank_split_dataset_needs_the_latent_style(tmp_path):
    with pytest.raises(ValueError, match="split='rank' requires style='latent'"):
        syn.generate_synthetic_dataset(str(tmp_path), num_users=30, num_items=20, split="rank")
