"""The port at the scaled configuration's width and depth (dim 256, 4
layers) against the JAX package, on the CPU at small sizes.

* the tile product at widths past one 128-column slab and widths that are
  no multiple of 4 (d = 50, 132, 256), both layouts' plain versions against
  the Pallas kernel in interpret mode: f32 tiles within 1e-5, bf16 tiles
  within 1e-5 * max(1, max|ref|) (PERF.md section 2's tile limits);
* five training steps of a ``Trainer`` at ``embedding_dim=256, n_layers=4``
  on a 300-user bundle, the fused ELL path and the tile path, against the
  JAX trainer's steps on the same params, batches and negatives: per-step
  losses within rtol 1e-5 (the limit of ``test_torch_train.py``), and the
  tile path within rtol 2e-3 of the ELL path (``tests/test_tile_spmm.py``);
* ``Retriever`` at d = 256 against the JAX package's: f32 top-k equal
  (scores within 1e-5, items outside tie groups), the int8 scoring equal
  on JAX's int8 catalog, the port's int8 catalog overlapping JAX's f32 and
  int8 top-20 by >= 0.9 (the two quantizers draw other random bits);
* the knee rule at the north-star size and the scale tool's lines, run
  small on the CPU.
"""

import contextlib
import io

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gcn_recommendation_tpu.config import Config as JaxConfig
from gcn_recommendation_tpu.data.synthetic import synthetic_bundle as jax_bundle
from gcn_recommendation_tpu.graph.tiles import partition_tiles as jax_partition
from gcn_recommendation_tpu.models import get_model as jax_get_model
from gcn_recommendation_tpu.ops import block_spmm as jbs
from gcn_recommendation_tpu.serve import Retriever as JaxRetriever
from gcn_recommendation_tpu.train.trainer import Trainer as JaxTrainer
from gcn_recommendation_tpu_torch.config import Config
from gcn_recommendation_tpu_torch.data.synthetic import synthetic_bundle
from gcn_recommendation_tpu_torch.graph.tiles import partition_tiles
from gcn_recommendation_tpu_torch.models import get_model
from gcn_recommendation_tpu_torch.models.convert import params_from_jax
from gcn_recommendation_tpu_torch.ops import block_spmm, quant
from gcn_recommendation_tpu_torch.ops.spmm import num_chunks_for
from gcn_recommendation_tpu_torch.serve import Retriever
from gcn_recommendation_tpu_torch.tools import exp_scale
from gcn_recommendation_tpu_torch.train.trainer import Trainer
from test_torch_serve import assert_same_topk
from test_torch_tiles import port_graph
from test_torch_spmm import one_thread  # noqa: F401  (autouse: one thread)

D, LAYERS, B, STEPS = 256, 4, 256, 5


# ------------------------------------------------------------ tile product


@pytest.fixture(scope="module")
def partitions():
    bj = jax_bundle(num_users=600, num_items=300, num_brands=20, mean_degree=20.0, core=4,
                    seed=3, style="latent", pop_zipf=0.8, deg_sigma=1.0)
    gj = bj.graph
    pj = jax_partition(gj, min_fill=8, tiles_per_step=4)
    p = partition_tiles(port_graph(gj), min_fill=8, tiles_per_step=4)
    assert pj is not None and p.num_tiles == pj.num_tiles > 0
    return gj.num_nodes, pj, p


@pytest.fixture(scope="module")
def pallas_out(partitions):
    """The Pallas kernel in interpret mode, once per (d, tile dtype)."""
    n, pj, _ = partitions
    cache = {}

    def get(d, dtype):
        if (d, dtype) not in cache:
            e = np.random.default_rng(d).standard_normal((n, d)).astype(np.float32)
            jd = jnp.bfloat16 if dtype == torch.bfloat16 else jnp.float32
            cache[(d, dtype)] = e, np.asarray(
                jbs.tile_matvec(jnp.asarray(e), jbs.to_device_tiles(pj, tile_dtype=jd)))
        return cache[(d, dtype)]

    return get


@pytest.mark.parametrize("layout", ["compressed", "dense"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("d", [50, 132, 256])
def test_tile_matvec_matches_pallas_interpret_at_wide_d(partitions, pallas_out, layout, dtype,
                                                        d):
    _, _, p = partitions
    e, ref = pallas_out(d, dtype)
    tiles = block_spmm.to_device_tiles(p, tile_dtype=dtype, device="cpu", layout=layout)
    before = block_spmm.tile_matvec.launches
    out = block_spmm.tile_matvec(torch.from_numpy(e), tiles)
    assert block_spmm.tile_matvec.launches == before  # CPU: the plain version
    assert out.dtype == torch.float32 and out.shape == (p.n_row_blocks * 128, d)
    # bf16 x bf16 products are exact in f32: only the f32 sum order differs
    tol = 1e-5 if dtype == torch.float32 else 1e-5 * max(1.0, float(np.abs(ref).max()))
    np.testing.assert_allclose(out.numpy(), ref, rtol=0, atol=tol)


# ---------------------------------------------------------------- training


@pytest.fixture(scope="module")
def bundles():
    return synthetic_bundle(300, 200, 20, seed=0), jax_bundle(300, 200, 20, seed=0)


def _configs(tile, tmp):
    kw = dict(embedding_dim=D, n_layers=LAYERS, batch_size=B, tile_spmm=tile, tile_min_fill=32,
              checkpoint_dir=str(tmp / "ck"), results_dir=str(tmp / "res"))
    return Config(**kw), JaxConfig(**kw)


def _batches(bundle):
    rng = np.random.default_rng(7)
    out = []
    for _ in range(STEPS):
        rows = rng.integers(0, len(bundle.train), B)
        out.append((bundle.train.user_idx[rows].astype(np.int32),
                    bundle.train.item_idx[rows].astype(np.int32),
                    rng.integers(0, bundle.num_items, B).astype(np.int32)))
    return out


@pytest.fixture(scope="module")
def jax_run(bundles, tmp_path_factory):
    """The JAX trainer's five step losses (ELL path) and its initial params."""
    b, bj = bundles
    _, jcfg = _configs(False, tmp_path_factory.mktemp("jax"))
    jm = jax_get_model("LightGCN")(bj.num_users, bj.num_items, bj.num_brands, jcfg)
    jt = JaxTrainer(jcfg, jm, bj)
    p, o = jt.init_state(jax.random.PRNGKey(0))
    p0 = {k: np.asarray(v) for k, v in p.items()}
    key = jax.random.PRNGKey(5)  # unused: negatives are given
    losses = []
    for batch in _batches(b):
        p, o, loss = jt._train_step(p, o, key, jt.arrays, *(jnp.asarray(a) for a in batch))
        losses.append(float(loss))
    return p0, np.asarray(losses)


@pytest.fixture(scope="module")
def port_runs(bundles, jax_run, tmp_path_factory):
    """The port trainer's five step losses on each path, from JAX's params."""
    b, _ = bundles
    p0, _ = jax_run
    out = {}
    for tile in (False, True):
        cfg, _ = _configs(tile, tmp_path_factory.mktemp(f"port{tile}"))
        m = get_model("LightGCN")(b.num_users, b.num_items, b.num_brands, cfg, device="cpu")
        m.load_params(params_from_jax(p0, m, device="cpu"))
        with contextlib.redirect_stdout(io.StringIO()):
            tr = Trainer(cfg, m, b)
        kind = type(tr.graph).__name__
        assert kind == ("TiledDeviceGraph" if tile else "DeviceGraph")
        assert tile or tr.graph.fused  # the default ELL trainer runs layer_sum
        losses = [float(tr.train_step(*(torch.from_numpy(a.astype(np.int64)) for a in batch)))
                  for batch in _batches(b)]
        out[tile] = np.asarray(losses)
    return out


def test_d256_four_layer_ell_steps_match_jax(jax_run, port_runs):
    _, want = jax_run
    assert np.isfinite(want).all() and want[-1] < want[0]
    np.testing.assert_allclose(port_runs[False], want, rtol=1e-5)


def test_d256_four_layer_tile_steps_match_ell(jax_run, port_runs):
    _, want = jax_run
    np.testing.assert_allclose(port_runs[True], port_runs[False], rtol=2e-3)
    np.testing.assert_allclose(port_runs[True], want, rtol=2e-3)


# ----------------------------------------------------------------- serving


@pytest.fixture(scope="module")
def served(bundles):
    b, bj = bundles
    jm = jax_get_model("LightGCN")(bj.num_users, bj.num_items, bj.num_brands,
                                   JaxConfig(embedding_dim=D, n_layers=LAYERS))
    jp = jm.init(jax.random.PRNGKey(1))
    m = get_model("LightGCN")(b.num_users, b.num_items, b.num_brands,
                              Config(embedding_dim=D, n_layers=LAYERS), device="cpu")
    params = params_from_jax({k: np.asarray(v) for k, v in jp.items()}, m, device="cpu")
    users = np.unique(b.train.user_idx)[:64]
    return b, bj, jm, jp, m, params, users


def test_d256_retriever_f32_matches_jax(served):
    b, bj, jm, jp, m, params, users = served
    want = JaxRetriever.from_params(jm, jp, bj).recommend(users, k=20)
    got = Retriever.from_params(m, params, b).recommend(users, k=20)
    assert got[0].shape == (64, 20)
    assert_same_topk(got, (np.asarray(want[0]), np.asarray(want[1])))


def test_d256_int8_scoring_matches_jax_on_its_catalog(served):
    """The port's int8 scoring (users quantized by K2's nearest mode, plain
    version) on JAX's int8 catalog of [200, 256] gives JAX's top-20."""
    b, bj, jm, jp, m, params, users = served
    jr = JaxRetriever.from_params(jm, jp, bj, quantize=True)
    want = jr.recommend(users, k=20)
    r = Retriever.from_params(m, params, b, quantize=True)
    assert r.item_q.shape[1] == D
    r.item_q = quant.pad_int8_table(torch.from_numpy(np.array(jr.item_q)))
    r.item_scale = torch.from_numpy(np.array(jr.item_scale))
    got = r.recommend(users, k=20)
    np.testing.assert_allclose(got[0], np.asarray(want[0]), rtol=1e-6)
    assert_same_topk(got, (np.asarray(want[0]), np.asarray(want[1])), tol=1e-6)


def test_d256_int8_catalog_overlaps_jax(served):
    b, bj, jm, jp, m, params, users = served
    _, i_f = JaxRetriever.from_params(jm, jp, bj).recommend(users, k=20)
    _, i_j8 = JaxRetriever.from_params(jm, jp, bj, quantize=True).recommend(users, k=20)
    _, i_q = Retriever.from_params(m, params, b, quantize=True).recommend(users, k=20)
    for other in (np.asarray(i_f), np.asarray(i_j8)):
        overlap = np.mean([len(set(i_q[j]) & set(other[j])) / 20 for j in range(len(users))])
        assert overlap >= 0.9, overlap


# --------------------------------------------------- knee rule, scale tool


def test_knee_rule_chunks_the_north_star_graph_at_d256():
    assert num_chunks_for(720_000, 256) == 2
    assert num_chunks_for(72_001, 256) == 1
    assert num_chunks_for(720_000, 64) == 2


def test_exp_scale_prints_every_line_small_on_cpu(capsys):
    # a graph of 4 batches: the tool's windows shrink to one epoch
    assert exp_scale.main(["--device", "cpu", "--num_users", "300", "--num_items", "200",
                           "--num_brands", "20", "--dim", "16", "--layers", "2"]) == 0
    out = capsys.readouterr().out
    lines = [ln for ln in out.splitlines() if not ln.startswith("Graph:")]
    heads = ["ETL ", "config: ", "device setup ", "first steps ", "train: ", "eval: ",
             "eval (cached batches): ", "serve f32: ", "serve int8: "]
    assert len(lines) == len(heads), out
    for line, head in zip(lines, heads):
        assert line.startswith(head), (line, head)
    assert "card=none (cpu)" in out and "peak=not measured (cpu)" in out
    assert "layout=plain ELL (merge-skip)" in out
    recall = float(out.split("recall=")[1].split()[0])
    assert 0.0 <= recall <= 1.0
    assert "300 users x 200 items" in out and "(4 steps," in out
    assert "1=" in out and "64=" in out and "300=" in out  # request sizes, capped


def test_exp_scale_forces_the_chunked_layout_on_cpu(capsys):
    assert exp_scale.main(["--device", "cpu", "--num_users", "300", "--num_items", "200",
                           "--num_brands", "20", "--dim", "8", "--layers", "2",
                           "--chunks", "2"]) == 0
    assert "layout=chunked C=2" in capsys.readouterr().out
