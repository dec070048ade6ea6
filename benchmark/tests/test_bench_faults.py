"""A run with the timed path broken underneath, and the control in the
program's place, both come out not correct: the harness's look for a
card is skipped and the rest of a run is driven on the CPU at a tiny size,
against the cells' own limits."""

import json
import os

import pytest

from benchmark import harness
from gcn_recommendation_tpu_torch import serve as port_serve
from gcn_recommendation_tpu_torch.ops import topk as port_topk
from gcn_recommendation_tpu_torch.train.trainer import Trainer
from tiny import tiny_root

SEED = 2**31 + 123


@pytest.fixture
def root(tmp_path):
    return tiny_root(tmp_path)


def run(root, workload):
    return harness.run_cell(root, workload, SEED, 0.5, False, device="cpu")


def test_sound_runs_are_correct(root):
    for w in ("books_d64.train", "books_d64.eval", "books_d64.serve"):
        assert run(root, w)["correct"], w


@pytest.mark.parametrize("workload", ["books_d64.train", "northstar_d256.train",
                                      "books_d64.eval", "books_d64.serve"])
def test_control_is_not_correct(root, workload):
    """The control: the program's own lower precision (bf16 propagation)."""
    bench = harness.load_bench(root)
    cfg = harness.find(bench["configs"], harness.find(bench["workloads"], workload,
                                                      "")["config"], "")["file"]
    path = os.path.join(root, cfg)
    with open(path) as f:
        c = json.load(f)
    c["compute_dtype"] = "bfloat16"
    with open(path, "w") as f:
        json.dump(c, f)
    assert not run(root, workload)["correct"]


def test_train_step_leaving_state_unchanged(root, monkeypatch):
    def step(self, users, pos, neg, step=0):
        self.optimizer.zero_grad(set_to_none=True)
        return self.batch_loss(users, pos, neg).detach()

    monkeypatch.setattr(Trainer, "train_step", step)
    line = run(root, "books_d64.train")
    assert not line["correct"]
    assert line["checks"]["change_norm_gap"]["value"] == 1.0
    assert line["checks"]["end_change_norm_gap"]["value"] == 1.0


def test_train_step_on_half_the_batch(root, monkeypatch):
    inner = Trainer.train_step

    def step(self, users, pos, neg, step=0):
        h = users.numel() // 2
        return inner(self, users[:h], pos[:h], neg[:h], step)

    monkeypatch.setattr(Trainer, "train_step", step)
    assert not run(root, "books_d64.train")["correct"]


def test_train_step_replaying_a_stale_batch(root, monkeypatch):
    """From the tenth call on, every step trains on the ninth call's batch,
    as a graph captured after the warm-up with its batch baked in would:
    the start check passes, the end check does not."""
    inner = Trainer.train_step
    seen = {"calls": 0}

    def step(self, users, pos, neg, step=0):
        seen["calls"] += 1
        if seen["calls"] == 9:
            seen["batch"] = (users, pos, neg)
        if seen["calls"] > 9:
            users, pos, neg = seen["batch"]
        return inner(self, users, pos, neg, step)

    monkeypatch.setattr(Trainer, "train_step", step)
    checks = run(root, "books_d64.train")["checks"]
    assert all(checks[k]["value"] <= checks[k]["limit"]
               for k in ("loss_gap", "grad_norm_gap", "change_norm_gap"))
    assert any(checks[k]["value"] > checks[k]["limit"]
               for k in ("end_loss_gap", "end_grad_norm_gap", "end_change_norm_gap"))


def test_eval_answers_altered(root, monkeypatch):
    """The top-k of the first batch of every pass comes out in reverse."""
    inner = port_topk.masked_topk_scores
    seen = {"n": 0}

    def altered(*a, **kw):
        vals, idx = inner(*a, **kw)
        seen["n"] += 1
        return (vals.flip(1), idx.flip(1)) if seen["n"] % 3 == 1 else (vals, idx)

    monkeypatch.setattr(port_topk, "masked_topk_scores", altered)
    assert not run(root, "books_d64.eval")["correct"]


def test_eval_half_the_batch(root, monkeypatch):
    inner = port_topk.topk_eval_batch

    def half(user_emb, item_emb, users, true_items, filter_idx, valid, k):
        valid = valid.clone()
        valid[valid.numel() // 2:] = False
        return inner(user_emb, item_emb, users, true_items, filter_idx, valid, k)

    monkeypatch.setattr("gcn_recommendation_tpu_torch.train.evaluate.topk_eval_batch", half)
    assert not run(root, "books_d64.eval")["correct"]


def test_serve_answer_altered(root, monkeypatch):
    """In each dispatch, the first request's top two items trade places."""
    inner = port_serve.Retriever.recommend_many

    def altered(self, requests, k=20, filter_seen=True):
        out = inner(self, requests, k, filter_seen)
        s, items = out[0]
        out[0] = (s, items[:, [1, 0] + list(range(2, items.shape[1]))])
        return out

    monkeypatch.setattr(port_serve.Retriever, "recommend_many", altered)
    assert not run(root, "books_d64.serve")["correct"]


def test_serve_half_the_requests(root, monkeypatch):
    """A coalesced dispatch answers the first half (rounded down) of its
    requests only; the others never complete."""
    inner = port_serve.Retriever.recommend_many

    def half(self, requests, k=20, filter_seen=True):
        return inner(self, requests, k, filter_seen)[: len(requests) // 2]

    monkeypatch.setattr(port_serve.Retriever, "recommend_many", half)
    line = run(root, "books_d64.serve")
    assert not line["correct"] and line["failed"] > 0
