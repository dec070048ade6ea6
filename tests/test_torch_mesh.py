"""The port's mesh layer against the JAX package's, in this process.

* ``MeshSpec``, ``pad_to_multiple``, ``auto_mesh_spec`` and the error of
  ``create_mesh`` for a mesh the run cannot hold, as in
  ``gcn_recommendation_tpu/core/mesh.py`` / ``core/distributed.py``;
* a world of one on the CPU (``initialize(device="cpu")``, gloo over an
  in-process store), which a ``1,1`` mesh needs and a larger one refuses
  without a launcher;
* ``merge_topk_candidates`` on tied scores against JAX's (``lax.top_k``'s
  order);
* the quantizer's ``row_offset`` in its plain versions: a catalog quantized
  shard by shard is bit-equal to the whole one;
* the checkpoints' layout sidecar and the refusal of another layout.
"""

import json
import os
import re

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from gcn_recommendation_tpu.core import distributed as jax_distributed
from gcn_recommendation_tpu.core import mesh as jax_mesh
from gcn_recommendation_tpu.ops.topk import merge_topk_candidates as jax_merge
from gcn_recommendation_tpu_torch.core import distributed, mesh
from gcn_recommendation_tpu_torch.ops import quant
from gcn_recommendation_tpu_torch.ops.topk import merge_topk_candidates
from gcn_recommendation_tpu_torch.utils import checkpoint as ckpt
from test_torch_spmm import one_thread  # noqa: F401  (autouse: one thread)

_MESH_ERROR = r"mesh \(\d+, \d+\) needs \d+ devices, have \d+"


@pytest.fixture
def no_launcher(monkeypatch):
    for v in ("RANK", "WORLD_SIZE", "LOCAL_RANK", "MASTER_ADDR", "LOCAL_WORLD_SIZE"):
        monkeypatch.delenv(v, raising=False)
    assert not torch.distributed.is_initialized()
    yield
    distributed.shutdown()


def test_mesh_spec_and_padding_match_jax():
    assert (mesh.DATA_AXIS, mesh.MODEL_AXIS) == (jax_mesh.DATA_AXIS, jax_mesh.MODEL_AXIS)
    for d, m in ((1, 1), (2, 4), (3, 1)):
        assert mesh.MeshSpec(d, m).shape == jax_mesh.MeshSpec(d, m).shape
        assert mesh.MeshSpec(d, m).size == d * m
    assert mesh.MeshSpec() == mesh.MeshSpec(1, 1)
    for n in range(0, 40, 3):
        for m in (1, 2, 8, 16):
            assert mesh.pad_to_multiple(n, m) == jax_mesh.pad_to_multiple(n, m)


def test_world_of_one_mesh(no_launcher):
    dev = distributed.initialize("cpu", mesh_spec=mesh.MeshSpec(1, 1))
    assert dev == torch.device("cpu")
    assert distributed.initialize("cpu") == dev  # a joined rank gets its device back
    assert (distributed.get_rank(), distributed.get_world_size()) == (0, 1)
    assert not ckpt.is_multiprocess()
    m = mesh.create_mesh()
    assert m.shape == {"data": 1, "model": 1} and m.size == 1 and m.device == dev
    assert m.coordinate("data") == m.coordinate("model") == 0
    assert mesh.create_mesh(mesh.MeshSpec(1, 1)).shape == {"data": 1, "model": 1}
    with pytest.raises(ValueError, match=_MESH_ERROR) as port_err:
        mesh.create_mesh(mesh.MeshSpec(1, 2))
    assert str(port_err.value) == "mesh (1, 2) needs 2 devices, have 1"
    with pytest.raises(ValueError, match=_MESH_ERROR):
        jax_mesh.create_mesh(jax_mesh.MeshSpec(4, 4))  # the JAX package's own message
    report = distributed.runtime_report()
    assert report["backend"] == "gloo" and report["world_size"] == 1


def test_larger_mesh_needs_a_launcher(no_launcher):
    with pytest.raises(ValueError, match="torchrun --nproc_per_node 2"):
        distributed.initialize("cpu", mesh_spec=mesh.MeshSpec(1, 2))
    assert not torch.distributed.is_initialized()
    with pytest.raises(RuntimeError, match="initialize"):
        mesh.create_mesh()


@pytest.mark.parametrize("model_parallel", [None, 4, 3, 16, 1])
def test_auto_mesh_spec_matches_jax(monkeypatch, model_parallel):
    """8 ranks, 8 GPUs a node: the JAX package's split of its 8 virtual
    devices (8 local devices)."""
    monkeypatch.setattr(distributed, "get_world_size", lambda: 8)
    monkeypatch.setenv("LOCAL_WORLD_SIZE", "8")
    got = distributed.auto_mesh_spec(model_parallel)
    want = jax_distributed.auto_mesh_spec(model_parallel)
    assert got.shape == want.shape


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_merge_topk_candidates_ties_match_jax(seed):
    rng = np.random.default_rng(seed)
    m, b, k = 3, 6, 5
    vals = rng.integers(0, 3, (m, b, k)).astype(np.float32)  # many ties
    vals = -np.sort(-vals, axis=2)
    idx = rng.permutation(m * b * k).reshape(m, b, k).astype(np.int64)
    got_v, got_i = merge_topk_candidates(torch.from_numpy(vals), torch.from_numpy(idx), k)
    want_v, want_i = jax_merge(jnp.asarray(vals), jnp.asarray(idx.astype(np.int32)), k)
    np.testing.assert_array_equal(got_v.numpy(), np.asarray(want_v))
    np.testing.assert_array_equal(got_i.numpy(), np.asarray(want_i))


@pytest.mark.parametrize("n_shards", [2, 3, 8])
def test_quantizer_row_offset_shards_equal_the_whole_table(n_shards):
    x = torch.randn((48, 20), generator=torch.Generator().manual_seed(n_shards))
    q, s = quant.quantize_rows_int8(x, seed=11)
    rows = 48 // n_shards
    parts = [quant.quantize_rows_int8(x[r * rows:(r + 1) * rows], seed=11, row_offset=r * rows)
             for r in range(n_shards)]
    assert torch.equal(torch.cat([p[0] for p in parts]), q)
    assert torch.equal(torch.cat([p[1] for p in parts]), s)
    bits = quant.random_bits(48, 20, 11)
    assert torch.equal(quant.random_bits(rows, 20, 11, row_offset=rows), bits[rows:2 * rows])
    # without the offset a shard draws the first rows' bits: other codes
    assert not torch.equal(quant.quantize_rows_int8(x[rows:2 * rows], seed=11)[0],
                           q[rows:2 * rows])
    with pytest.raises(ValueError, match="row_offset"):
        quant.quantize_rows_int8(x, row_offset=-1)


def test_checkpoint_layout_sidecar_and_refusal(tmp_path):
    d = str(tmp_path)
    params = {"user_embedding": torch.zeros((3, 2))}
    path = ckpt.save_state(d, "last", params, {"state": {}, "param_groups": []}, 1, 0.5,
                           torch.Generator().get_state())
    sidecar = path + ".layout.json"
    with open(sidecar) as f:
        assert json.load(f) == {"layout": "logical", "process_count": 1}
    assert ckpt.load_state(d, "last")["epoch"] == 1
    with open(sidecar, "w") as f:
        json.dump({"layout": "sharded", "process_count": 4}, f)
    with pytest.raises(RuntimeError, match=re.escape("written in 'sharded' layout "
                                                     "(process_count=4)")):
        ckpt.load_state(d, "last")
    os.remove(sidecar)  # a checkpoint from before the sidecar loads as logical
    assert ckpt.load_state(d, "last")["best_recall"] == 0.5
