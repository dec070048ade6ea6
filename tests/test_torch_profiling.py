"""The port's profiling hooks on the CPU: ``StepTimer`` and ``trace()``.

``StepTimer`` keeps the JAX package's arithmetic (held against it on the
same durations); ``trace`` writes a Chrome trace only when
``GCN_TPU_TRACE_DIR`` is set, which ``--profile_dir`` does, and the trainer
wraps each epoch in it.
"""

import json
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gcn_recommendation_tpu.utils.profiling import StepTimer as JaxStepTimer
from gcn_recommendation_tpu_torch import cli
from gcn_recommendation_tpu_torch.config import Config
from gcn_recommendation_tpu_torch.data.synthetic import synthetic_bundle
from gcn_recommendation_tpu_torch.models import get_model
from gcn_recommendation_tpu_torch.train.trainer import Trainer
from gcn_recommendation_tpu_torch.utils import profiling
from gcn_recommendation_tpu_torch.utils.profiling import StepTimer, trace
from test_torch_spmm import one_thread  # noqa: F401  (autouse: one thread)


@pytest.mark.parametrize("sync_on", [
    None, torch.ones(3), {"a": torch.ones(2), "b": [torch.zeros(1)]}, (3, [torch.ones(1)]), [], 5,
])
def test_step_timer_stops_on_anything(sync_on):
    t = StepTimer()
    t.start()
    dt = t.stop(sync_on=sync_on)
    assert dt >= 0 and t.durations == [dt]


def test_step_timer_statistics_match_jax():
    t, j = StepTimer(), JaxStepTimer()
    assert t.mean == j.mean == 0 and t.best() == j.best() == 0
    for timer, leaf in ((t, torch.ones(2)), (j, jnp.ones(2))):
        for _ in range(4):
            timer.start()
            timer.stop(sync_on={"x": leaf})
    durations = [0.5, 0.1, 0.4, 0.2, 0.3]
    t.durations, j.durations = list(durations), list(durations)
    assert t.mean == j.mean == pytest.approx(0.3)
    for k in (1, 3, 10):
        assert t.best(k) == j.best(k)
    assert t.best(2) == pytest.approx(0.15)


def test_first_tensor_walks_dicts_lists_and_tuples():
    a = torch.ones(1)
    assert profiling._first_tensor(a) is a
    assert profiling._first_tensor({"k": [3, (None, a)]}) is a
    assert profiling._first_tensor(["text", 3.0, {}]) is None


def test_trace_is_a_no_op_without_the_variable(tmp_path, monkeypatch):
    monkeypatch.delenv("GCN_TPU_TRACE_DIR", raising=False)
    monkeypatch.chdir(tmp_path)
    with trace("step"):
        torch.ones(4).sum()
    assert os.listdir(tmp_path) == []


def test_trace_writes_a_chrome_trace_when_the_variable_is_set(tmp_path, monkeypatch):
    monkeypatch.setenv("GCN_TPU_TRACE_DIR", str(tmp_path))
    with trace("step"):
        (torch.ones(64, 64) @ torch.ones(64, 64)).sum()
    path = tmp_path / "step" / profiling.TRACE_FILE
    assert path.exists()
    events = json.load(open(path))["traceEvents"]
    assert any("mm" in str(e.get("name", "")) for e in events)


def test_profile_dir_flag_sets_the_variable(tmp_path, monkeypatch):
    monkeypatch.delenv("GCN_TPU_TRACE_DIR", raising=False)
    args = cli.build_parser().parse_args(
        ["train", "--processed_dir", "x", "--profile_dir", str(tmp_path), "--device", "cpu"])
    cli._make_config(args)
    try:
        assert os.environ["GCN_TPU_TRACE_DIR"] == str(tmp_path)
    finally:
        monkeypatch.delenv("GCN_TPU_TRACE_DIR", raising=False)
    for mode in ("train", "test", "recommend", "serve"):
        assert cli.build_parser().parse_args([mode]).profile_dir is None


def test_trainer_traces_each_epoch(tmp_path, monkeypatch):
    monkeypatch.setenv("GCN_TPU_TRACE_DIR", str(tmp_path / "traces"))
    b = synthetic_bundle(60, 40, 4, mean_degree=8.0, seed=0)
    cfg = Config(embedding_dim=8, n_layers=1, epochs=2, batch_size=128, val_interval=5,
                 checkpoint_dir=str(tmp_path / "c"), results_dir=str(tmp_path / "r"))
    m = get_model("LightGCN")(b.num_users, b.num_items, b.num_brands, cfg, device="cpu")
    _, best = Trainer(cfg, m, b).fit()
    assert np.isfinite(best)
    assert sorted(os.listdir(tmp_path / "traces")) == ["epoch_1", "epoch_2"]
    assert (tmp_path / "traces" / "epoch_2" / profiling.TRACE_FILE).exists()
