"""The port's GSPMD-style sharded path against its single-device path and
the JAX package, on 2- and 4-rank gloo worlds of the CPU.

Each world is spawned once per module (``core.mesh.run_local_world``) and
runs every case of the module through the port's own drivers
(``parallel/drivers.py``), so no rank imports JAX or a test module.  The
JAX side runs here, on the 8 virtual devices of ``conftest.py``:

* the distributed top-k, f32 and int8, with the index sentinel of a
  starved shard and ``k`` above the shard's rows, against JAX's
  ``sharded_topk_eval_batch`` / ``sharded_quantized_topk_batch``: indices
  equal, values to rtol 1e-5 (atol 1e-6 for scores that cancel to near 0);
* ``evaluate_sharded`` with the data axis split against JAX's and the
  single-device evaluator: recall to rtol 1e-6, NDCG to rtol 1e-5;
* the ``gspmd`` trainer on (1,2), (2,1), (2,2): steps on given batches and
  a sampled epoch against the port's single-device trainer (losses and
  params to rtol 1e-4 / atol 1e-6, pad rows exactly 0), and against JAX's
  ``ShardedTrainer``: its loss at every step of the port's run on each
  mesh, and its own steps on (2,2);
* a non-divisible vocabulary on a 4-way model axis, Fusion under padding,
  a checkpoint written on (1,2) that resumes on one device, and the
  sharded ``Retriever`` (f32, and an int8 catalog bit-equal to the whole
  one).
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from gcn_recommendation_tpu.config import Config as JaxConfig
from gcn_recommendation_tpu.core.mesh import MeshSpec as JaxMeshSpec
from gcn_recommendation_tpu.core.mesh import create_mesh as jax_create_mesh
from gcn_recommendation_tpu.data.loader import Interactions as JaxInteractions
from gcn_recommendation_tpu.data.synthetic import synthetic_bundle as jax_synthetic_bundle
from gcn_recommendation_tpu.models import get_model as jax_get_model
from gcn_recommendation_tpu.ops.quant import quantize_rows_int8 as jax_quantize
from gcn_recommendation_tpu.parallel import spmd as jspmd
from gcn_recommendation_tpu_torch.core.mesh import run_local_world
from gcn_recommendation_tpu_torch.data.loader import Interactions, load_preprocessed_data
from gcn_recommendation_tpu_torch.data.synthetic import synthetic_bundle
from gcn_recommendation_tpu_torch.ops.topk import MASK_VALUE
from gcn_recommendation_tpu_torch.parallel import drivers
from gcn_recommendation_tpu_torch.train.evaluate import evaluate_embeddings
from gcn_recommendation_tpu_torch.train.trainer import Trainer
from test_torch_spmm import one_thread  # noqa: F401  (autouse: one thread)

CFG = dict(embedding_dim=16, n_layers=2, batch_size=128)
ND_CFG = dict(embedding_dim=16, n_layers=2, batch_size=64)
TRAIN_MESHES = [(1, 2), (2, 1), (2, 2)]
EVAL_MESHES = [(2, 1), (1, 2), (2, 2)]


def _batches(bundle, n, size, seed):
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        rows = rng.integers(0, len(bundle.train), size)
        out.append((bundle.train.user_idx[rows].astype(np.int32),
                    bundle.train.item_idx[rows].astype(np.int32),
                    rng.integers(0, bundle.num_items, size).astype(np.int32)))
    return out


@pytest.fixture(scope="module")
def data(tiny_bundle, tmp_path_factory):
    jb, path = tiny_bundle
    pb = load_preprocessed_data(path, use_brand=True, verbose=False)
    rng = np.random.default_rng(0)
    d = dict(jb=jb, pb=pb, ck=str(tmp_path_factory.mktemp("ck")))
    d["params"] = {k: v.numpy() for k, v in
                   drivers.make_trainer(pb, CFG, device="cpu").model.params().items()}
    d["batches"] = _batches(pb, 3, 128, 1)
    d["nd"] = synthetic_bundle(90, 70, 11, mean_degree=8.0, seed=0)
    d["nd_batches"] = _batches(d["nd"], 2, 64, 2)
    d["content"] = rng.standard_normal((70, 16)).astype(np.float32)
    # distributed top-k inputs (tests/test_parallel.py's cases)
    B, I, dd = 16, 100, 8
    d["u1"] = rng.standard_normal((B, dd)).astype(np.float32)
    d["items1"] = rng.standard_normal((I, dd)).astype(np.float32)
    filt = np.full((B, 4), I, np.int32)
    filt[0, :2] = [3, 97]
    filt[5, 0] = 42
    d["filt1"] = filt
    B, I = 4, 6
    d["u2"] = rng.standard_normal((B, dd)).astype(np.float32)
    d["items2"] = rng.standard_normal((I, dd)).astype(np.float32)
    filt = np.full((B, I), I + 1000, np.int32)
    filt[0] = np.arange(I, dtype=np.int32)  # user 0: every real item filtered
    d["filt2"] = filt
    q, s = jax_quantize(jnp.asarray(d["items2"]), use_pallas=False)
    d["q2"], d["s2"] = np.asarray(q), np.asarray(s)
    # evaluation inputs (tests/test_parallel.py::test_sharded_eval_data_axis...)
    nu, ni = 30, 500
    d["fu"] = rng.standard_normal((nu, dd)).astype(np.float32)
    d["fi"] = rng.standard_normal((ni, dd)).astype(np.float32)
    d["ev_train"] = (np.repeat(np.arange(nu, dtype=np.int32), 6),
                     rng.integers(0, ni, nu * 6).astype(np.int32))
    d["ev_val"] = (np.arange(nu, dtype=np.int32), rng.integers(0, ni, nu).astype(np.int32))
    d["requests"] = [np.array([3], np.int32), np.arange(0, 64, 3).astype(np.int32)]
    return d


def _topk_cases(d, model):
    def pad(x, m):
        return jspmd.pad_rows(x, m * 8)

    s_pad = np.concatenate([d["s2"], np.ones((pad(d["q2"], model).shape[0] - 6, 1), np.float32)])
    return [
        ("topk_case", dict(mesh_shape=(1, model), user_emb=d["u1"], k=5, filter_idx=d["filt1"],
                           num_valid_items=100, item_emb=pad(d["items1"], model),
                           device="cpu")),
        ("topk_case", dict(mesh_shape=(1, model), user_emb=d["u2"], k=20, filter_idx=d["filt2"],
                           num_valid_items=6, item_emb=pad(d["items2"], model), device="cpu")),
        ("topk_case", dict(mesh_shape=(1, model), user_emb=d["u2"], k=20, filter_idx=d["filt2"],
                           num_valid_items=6, item_q=pad(d["q2"], model), item_scale=s_pad,
                           device="cpu")),
    ]


def _eval_case(d, shape):
    return ("evaluate_case", dict(
        mesh_shape=shape, fu=d["fu"], fi=d["fi"], eval_inter=Interactions(*d["ev_val"]),
        filter_inter=Interactions(*d["ev_train"]), num_users=30, num_items=500, k=10,
        batch_size=4, device="cpu"))


def _train_case(d, shape, **kw):
    return ("train_case", dict(bundle=d["pb"], cfg_kwargs=CFG, batches=d["batches"],
                               params=d["params"], mesh_shape=shape, schedule="gspmd",
                               epochs=1, validate=True, device="cpu", **kw))


def _nd_case(d, shape, model_name="LightGCN"):
    return ("train_case", dict(
        bundle=d["nd"], cfg_kwargs=ND_CFG, batches=d["nd_batches"], model_name=model_name,
        content=d["content"] if model_name != "LightGCN" else None, mesh_shape=shape,
        schedule="gspmd", device="cpu"))


def _spawn(n_ranks, cases):
    """Start a world of ``n_ranks`` on a thread running the named case
    groups; returns a function that waits and gives {group: [results]}."""
    import threading

    flat = [c for group in cases.values() for c in group]
    box = {}

    def run():
        try:
            box["out"] = run_local_world(n_ranks, drivers.run_cases, flat, device="cpu")
        except Exception as e:  # noqa: BLE001 - re-raised in wait()
            box["err"] = e

    t = threading.Thread(target=run)
    t.start()

    def wait():
        t.join(timeout=600)
        assert not t.is_alive(), f"the {n_ranks}-rank world did not finish in 600 s"
        if "err" in box:
            raise box["err"]
        results = iter(box["out"])
        return {name: [next(results) for _ in group] for name, group in cases.items()}

    return wait


@pytest.fixture(scope="module")
def spawned(data):
    """The 2-rank and the 4-rank world of this module, started side by
    side (the JAX references compute meanwhile); their waiters."""
    d = data
    wait2 = _spawn(2, {
        "topk": _topk_cases(d, 2),
        "eval": [_eval_case(d, s) for s in EVAL_MESHES if s != (2, 2)],
        "train": [_train_case(d, s) for s in TRAIN_MESHES if s != (2, 2)],
        "fusion": [_nd_case(d, (1, 2), "LightGCN_Fusion")],
        "fit": [("fit_case", dict(bundle=d["pb"], cfg_kwargs=dict(
            CFG, epochs=2, val_interval=2, checkpoint_dir=d["ck"], results_dir=d["ck"]),
            mesh_shape=(1, 2), device="cpu"))],
        "retriever": [("retriever_case", dict(
            bundle=d["pb"], cfg_kwargs=CFG, params=d["params"], requests=d["requests"], k=10,
            quantize=q, mesh_shape=(1, 2), device="cpu")) for q in (False, True)],
    })
    wait4 = _spawn(4, {
        "topk": _topk_cases(d, 4),
        "eval": [_eval_case(d, (2, 2))],
        "train": [_train_case(d, (2, 2))],
        "nd": [_nd_case(d, (1, 4))],
    })
    return wait2, wait4


@pytest.fixture(scope="module")
def world2(spawned):
    return spawned[0]()


@pytest.fixture(scope="module")
def world4(spawned):
    return spawned[1]()


def _world(world2, world4, shape):
    return world4 if shape[0] * shape[1] == 4 else world2


# ------------------------------------------------------- distributed top-k


@pytest.fixture(scope="module")
def jax_topk(data, spawned):
    """JAX's distributed top-k of each case on a (1, 2) mesh: its results
    do not depend on the mesh (tests/test_parallel.py), and each shard_map
    compiles for seconds here."""
    return [tuple(np.asarray(a) for a in _jax_topk(data, 2, case)) for case in range(3)]


def _jax_topk(d, model, case):
    mesh = jax_create_mesh(JaxMeshSpec(1, model))
    if case == 0:
        return jspmd.sharded_topk_eval_batch(
            mesh, jnp.asarray(d["u1"]), jnp.asarray(jspmd.pad_rows(d["items1"], model * 8)),
            jnp.asarray(d["filt1"]), 5, num_valid_items=100)
    if case == 1:
        return jspmd.sharded_topk_eval_batch(
            mesh, jnp.asarray(d["u2"]), jnp.asarray(jspmd.pad_rows(d["items2"], model * 8)),
            jnp.asarray(d["filt2"]), 20, num_valid_items=6)
    q_pad = jspmd.pad_rows(d["q2"], model * 8)
    s_pad = np.concatenate([d["s2"], np.ones((q_pad.shape[0] - 6, 1), np.float32)])
    return jspmd.sharded_quantized_topk_batch(
        mesh, jnp.asarray(d["u2"]), jnp.asarray(q_pad), jnp.asarray(s_pad),
        jnp.asarray(d["filt2"]), 20, num_valid_items=6)


@pytest.mark.parametrize("model", [2, 4])
@pytest.mark.parametrize("case", [0, 1, 2], ids=["f32", "starved_f32", "starved_int8"])
def test_sharded_topk_matches_jax(jax_topk, world2, world4, model, case):
    vals, idx = (world4 if model == 4 else world2)["topk"][case]
    j_vals, j_idx = jax_topk[case]
    np.testing.assert_array_equal(idx, j_idx)
    # atol: an 8-term dot product that cancels to ~1e-3 carries 1e-7 of rounding
    np.testing.assert_allclose(vals, j_vals, rtol=1e-5, atol=1e-6)
    if case:
        # only 6 real candidates: the tail slots are sentinels, never real ids
        masked = vals <= MASK_VALUE / 2
        assert masked[:, 6:].all() and masked[0].all()
        assert (idx[masked] >= 6).all(), "a pad slot leaked a real item id"


# ---------------------------------------------------------------- evaluation


@pytest.mark.parametrize("shape", EVAL_MESHES)
def test_evaluate_sharded_matches_jax_and_single_device(data, world2, world4, shape):
    d = data
    cases = [s for s in EVAL_MESHES if s != (2, 2)]
    r, n = world4["eval"][0] if shape == (2, 2) else world2["eval"][cases.index(shape)]
    val, train = Interactions(*d["ev_val"]), Interactions(*d["ev_train"])
    r_ref, n_ref = evaluate_embeddings(torch.from_numpy(d["fu"]), torch.from_numpy(d["fi"]),
                                       val, train, 30, 500, 10, batch_size=4)
    r_jax, n_jax = jspmd.evaluate_sharded(
        jax_create_mesh(JaxMeshSpec(*shape)), jnp.asarray(d["fu"]), jnp.asarray(d["fi"]),
        JaxInteractions(*d["ev_val"]), JaxInteractions(*d["ev_train"]), 30, 500, 10,
        batch_size=4)
    for ref_r, ref_n in ((r_ref, n_ref), (r_jax, n_jax)):
        np.testing.assert_allclose(r, ref_r, rtol=1e-6)
        np.testing.assert_allclose(n, ref_n, rtol=1e-5)
    assert 0.0 < r_ref < 1.0


# ------------------------------------------------------------------ training


@pytest.fixture(scope="module")
def single(data):
    """The port's single-device trainer on the same params and batches."""
    d = data
    return drivers.train_case(d["pb"], CFG, d["batches"], params=d["params"], epochs=1,
                              validate=True, device="cpu")


def _train_result(world2, world4, shape):
    if shape == (2, 2):
        return world4["train"][0]
    return world2["train"][[s for s in TRAIN_MESHES if s != (2, 2)].index(shape)]


def _close(a, b, what):
    np.testing.assert_allclose(a, b, rtol=1e-4, atol=1e-6, err_msg=what)


@pytest.mark.parametrize("shape", TRAIN_MESHES)
def test_gspmd_epoch_matches_single_device(single, world2, world4, shape):
    out = _train_result(world2, world4, shape)
    _close(out["step_losses"], single["step_losses"], "step losses")
    _close(out["epoch_losses"][0], single["epoch_losses"][0], "epoch losses")
    for k in single["params"]:
        _close(out["params"][k], single["params"][k], k)
        assert out["pad_max"][k] == 0.0, k
    assert out["local_rows"]["user_embedding"] * shape[1] == out["padded_rows"]["user_embedding"]
    np.testing.assert_allclose(out["recall"], single["recall"], rtol=1e-6)
    np.testing.assert_allclose(out["ndcg"], single["ndcg"], rtol=1e-5)


def _jax_trainer(data, shape, cls=jspmd.ShardedTrainer):
    jb = data["jb"]
    jcfg = JaxConfig(**CFG)
    jm = jax_get_model("LightGCN")(jb.num_users, jb.num_items, jb.num_brands, jcfg)
    jt = cls(jcfg, jm, jb, jax_create_mesh(JaxMeshSpec(*shape)))
    jt.init_state(jax.random.PRNGKey(0))
    return jt


def _jax_state(jt, params):
    p = jax.tree.map(jnp.asarray, jt.model.pad_state_tree(params))
    return jt._place_state(p, jt.tx.init(p))


@pytest.mark.parametrize("shape", TRAIN_MESHES)
def test_gspmd_losses_match_jax_sharded_trainer(data, world2, world4, shape):
    """JAX's ShardedTrainer on the same mesh gives the port's loss at every
    step of the port's run."""
    out = _train_result(world2, world4, shape)
    jt = _jax_trainer(data, shape)
    loss = jax.jit(lambda p, u, i, n: jt._batch_loss(p, jt.arrays, u, i, n))
    for s, (params, batch) in enumerate(zip(out["trajectory"], data["batches"])):
        p, _ = _jax_state(jt, params)
        want = float(loss(p, *(jnp.asarray(a) for a in batch)))
        _close(out["step_losses"][s], want, f"step {s}")


def test_gspmd_steps_match_jax_sharded_trainer(data, world4):
    """Three Adam steps of JAX's ShardedTrainer on (2, 2) from the same
    params and batches: the losses, and the params after each step."""
    out = world4["train"][0]
    jt = _jax_trainer(data, (2, 2))
    p, o = _jax_state(jt, data["params"])
    for s, batch in enumerate(data["batches"]):
        if s:
            for k, v in out["trajectory"][s].items():
                _close(v, np.asarray(p[k])[: v.shape[0]], f"{k} after step {s - 1}")
        p, o, loss = jt._train_step(p, o, jax.random.PRNGKey(1), jt.arrays,
                                    *(jnp.asarray(a) for a in batch))
        _close(out["step_losses"][s], float(loss), f"step {s}")


def test_nondivisible_vocab_pads_every_table(data, world4):
    """90 / 70 / 11 rows on a 4-way model axis: the tables pad to 92 / 72 /
    12 and shard 23 / 18 / 3 rows a rank; the run equals the unpadded
    single-device one and the pad rows stay exactly 0."""
    out = world4["nd"][0]
    assert out["padded_rows"] == {"user_embedding": 92, "item_embedding": 72,
                                  "brand_embedding": 12}
    assert out["local_rows"] == {"user_embedding": 23, "item_embedding": 18,
                                 "brand_embedding": 3}
    ref = drivers.train_case(data["nd"], ND_CFG, data["nd_batches"], device="cpu")
    _close(out["step_losses"], ref["step_losses"], "losses")
    for k in ref["params"]:
        _close(out["params"][k], ref["params"][k], k)
        assert out["pad_max"][k] == 0.0


def test_fusion_under_padding_matches_single_device(data, world2):
    """LightGCN_Fusion on (1, 2): the content matrix rides the item table's
    padding and row-shards with it; the fusion kernel stays whole."""
    out = world2["fusion"][0]
    ref = drivers.train_case(data["nd"], ND_CFG, data["nd_batches"],
                             model_name="LightGCN_Fusion", content=data["content"],
                             device="cpu")
    assert out["local_rows"]["item_content_embedding"] == 35
    assert out["local_rows"]["fusion_kernel"] == 32
    _close(out["step_losses"], ref["step_losses"], "losses")
    for k in ref["params"]:
        _close(out["params"][k], ref["params"][k], k)
    np.testing.assert_array_equal(out["params"]["item_content_embedding"], data["content"])
    assert out["pad_max"]["brand_embedding"] == 0.0


def test_checkpoint_from_mesh_resumes_on_one_device(data, world2):
    """``fit`` on (1, 2) writes logical checkpoints (rank 0, sidecar of 2
    processes); a single-device trainer validates the best one to the
    recall the mesh saw, and a (1, 1) mesh and a single-device trainer
    resume the last one alike."""
    import json
    import os

    from gcn_recommendation_tpu_torch.config import Config
    from gcn_recommendation_tpu_torch.utils import checkpoint as ckpt

    best = world2["fit"][0]["best_recall"]
    cfg = dict(CFG, epochs=4, val_interval=2, checkpoint_dir=data["ck"], results_dir=data["ck"])
    ckpt_dir = os.path.join(data["ck"], Config(**cfg).checkpoint_name())
    with open(ckpt.checkpoint_path(ckpt_dir, "best") + ".layout.json") as f:
        assert json.load(f) == {"layout": "logical", "process_count": 2}
    tr = drivers.make_trainer(data["pb"], cfg, params=ckpt.load_params(ckpt_dir, device="cpu"),
                              device="cpu")
    recall, _ = tr.validate()
    np.testing.assert_allclose(recall, best, rtol=1e-6)
    state = ckpt.load_state(ckpt_dir, "last")
    assert state["params"]["user_embedding"].shape[0] == data["pb"].num_users
    # resume on a (1, 1) mesh: a world of one in this process
    from gcn_recommendation_tpu_torch.core import distributed

    distributed.initialize("cpu")
    try:
        best_mesh = drivers.fit_case(data["pb"], cfg, mesh_shape=(1, 1), resume=True,
                                     device="cpu")
    finally:
        distributed.shutdown()
    _, best2 = tr.fit(resume=True)
    assert best2 >= best
    np.testing.assert_allclose(best_mesh["best_recall"], best2, rtol=1e-6)


@pytest.mark.parametrize("quantize", [False, True], ids=["f32", "int8"])
def test_sharded_retriever_matches_single_device(data, world2, quantize):
    out = world2["retriever"][int(quantize)]
    ref = drivers.retriever_case(data["pb"], CFG, data["params"], data["requests"], 10,
                                 quantize, device="cpu")
    for (v, i), (rv, ri) in zip(out["answers"], ref["answers"]):
        np.testing.assert_array_equal(i, ri)
        np.testing.assert_allclose(v, rv, rtol=1e-6)
    if quantize:
        np.testing.assert_array_equal(out["item_q"], ref["item_q"])
        np.testing.assert_array_equal(out["item_scale"], ref["item_scale"])


# ---------------------------------------------------------- in-process checks


class _FakeMesh:
    shape = {"data": 1, "model": 4}
    device = torch.device("cpu")

    @staticmethod
    def coordinate(axis):
        return 0


def _no_device(d, name):
    """A call of one driver, or of a world, as its caller would write it
    with the ``device`` argument left out."""
    def kw(case):
        return {k: v for k, v in case[1].items() if k != "device"}

    return {
        "make_trainer": lambda: drivers.make_trainer(d["pb"], CFG),
        "train_case": lambda: drivers.train_case(**kw(_train_case(d, None))),
        "fit_case": lambda: drivers.fit_case(d["pb"], CFG),
        "topk_case": lambda: drivers.topk_case(**kw(_topk_cases(d, 1)[0])),
        "evaluate_case": lambda: drivers.evaluate_case(**kw(_eval_case(d, (1, 1)))),
        "retriever_case": lambda: drivers.retriever_case(
            d["pb"], CFG, d["params"], d["requests"], 10, False),
        "halo_propagation_case": lambda: drivers.halo_propagation_case(
            (1, 1), d["pb"].graph, d["fu"], d["fu"], 1),
        "run_local_world": lambda: run_local_world(1, drivers.run_cases, []),
    }[name]


@pytest.mark.parametrize("name", [
    "make_trainer", "train_case", "fit_case", "topk_case", "evaluate_case", "retriever_case",
    "halo_propagation_case", "run_local_world"])
def test_no_device_means_the_card(data, monkeypatch, name):
    """A driver, or a world, given no device runs on the card: without CUDA
    it raises ``core/device.py``'s error instead of running on the CPU."""
    call = _no_device(data, name)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available; pass device='cpu'"):
        call()


def test_shard_params_warns_on_large_nondivisible_table():
    from gcn_recommendation_tpu_torch.parallel.spmd import shard_params

    with pytest.warns(UserWarning, match="replicating a large table"):
        out = shard_params({"big_table": torch.zeros((1025, 4))}, _FakeMesh)
    assert out["big_table"].shape == (1025, 4)
    out = shard_params({"t": torch.arange(8.0)[:, None], "b": torch.zeros(3)}, _FakeMesh)
    assert out["t"].shape == (2, 1) and out["b"].shape == (3,)
    with pytest.warns(UserWarning, match="replicating a large table"):
        jspmd.shard_params({"big_table": jnp.zeros((1025, 4))},
                           jax_create_mesh(JaxMeshSpec(1, 4)))


def test_sharded_trainer_refuses_tile_spmm_and_split_batches(data):
    from gcn_recommendation_tpu_torch.config import Config
    from gcn_recommendation_tpu_torch.models import get_model
    from gcn_recommendation_tpu_torch.parallel.spmd import ShardedTrainer

    pb = data["pb"]
    model = get_model("LightGCN")(pb.num_users, pb.num_items, pb.num_brands, Config(**CFG),
                                  device="cpu")
    with pytest.raises(ValueError, match="single-device only"):
        ShardedTrainer(Config(**CFG, tile_spmm=True), model, pb, _FakeMesh)
    mesh = _FakeMesh()
    mesh.shape = {"data": 3, "model": 1}
    with pytest.raises(ValueError, match="does not split"):
        ShardedTrainer(Config(**CFG), model, pb, mesh)
    assert isinstance(Trainer(Config(**CFG), model, pb), Trainer)


def test_jax_reference_bundle_is_the_port_bundle(data):
    """The JAX trainers above read the JAX bundle, the port's ranks the
    port's: the same arrays."""
    jb, pb = data["jb"], data["pb"]
    np.testing.assert_array_equal(jb.train.user_idx, pb.train.user_idx)
    np.testing.assert_array_equal(jb.graph.src, pb.graph.src)
    np.testing.assert_allclose(jb.graph.weight, pb.graph.weight, rtol=1e-6)
    nd = jax_synthetic_bundle(90, 70, 11, mean_degree=8.0, seed=0)
    np.testing.assert_array_equal(nd.graph.src, data["nd"].graph.src)
