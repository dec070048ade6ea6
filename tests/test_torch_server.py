"""The port's HTTP serving daemon against the JAX package's, in-process on the CPU.

One set of weights (JAX init, carried across with ``models/convert.py``),
one ``Retriever`` and one daemon of each package on a free port.  The
cases mirror ``tests/test_server.py`` one by one; further cases hold the
two daemons' bodies against each other (f32 scores agree within 1e-5, so
after the daemons' rounding to 4 digits they are equal or one unit of the
last digit apart; items equal except inside groups of scores tied within
1e-5), and check what the port adds: warm failures logged and counted,
the dispatcher thread's grad mode, ``cli.make_server``.

Every HTTP call carries a timeout of a few seconds and every server is
shut down in a ``finally`` or a fixture's teardown: a fault here must
fail, not hang.
"""

import json
import threading
import time
import urllib.error
import urllib.request

import jax
import numpy as np
import pytest
import torch

from gcn_recommendation_tpu.config import Config as JaxConfig
from gcn_recommendation_tpu.models import get_model as jax_get_model
from gcn_recommendation_tpu.serve import Retriever as JaxRetriever
from gcn_recommendation_tpu.server import RecommendServer as JaxRecommendServer
from gcn_recommendation_tpu_torch import cli
from gcn_recommendation_tpu_torch.config import Config
from gcn_recommendation_tpu_torch.data.loader import load_preprocessed_data
from gcn_recommendation_tpu_torch.models import get_model
from gcn_recommendation_tpu_torch.models.convert import params_from_jax
from gcn_recommendation_tpu_torch.serve import Retriever
from gcn_recommendation_tpu_torch.server import Dispatcher, RecommendServer, _Pending
from gcn_recommendation_tpu_torch.utils.checkpoint import save_params
from test_torch_serve import assert_same_topk
from test_torch_spmm import one_thread  # noqa: F401  (autouse: one thread)

HTTP_TIMEOUT = 10  # seconds, every call
ROUNDED_ATOL = 1e-4 + 1e-9  # one unit of the 4th digit


def _post(port, payload, path="/recommend"):
    req = urllib.request.Request(
        f"http://127.0.0.1:{port}{path}",
        data=json.dumps(payload).encode(),
        headers={"Content-Type": "application/json"},
        method="POST",
    )
    try:
        with urllib.request.urlopen(req, timeout=HTTP_TIMEOUT) as r:
            return r.status, json.loads(r.read())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read())


def _get(port, path):
    with urllib.request.urlopen(
        f"http://127.0.0.1:{port}{path}", timeout=HTTP_TIMEOUT
    ) as r:
        return r.status, json.loads(r.read())


def _port_params(jax_params, model):
    return params_from_jax({k: np.asarray(v) for k, v in jax_params.items()}, model,
                           device="cpu")


@pytest.fixture(scope="module")
def models(tiny_bundle):
    """(port bundle, port model, JAX bundle, JAX model), 2 layers, dim 16."""
    jax_bundle, path = tiny_bundle
    bundle = load_preprocessed_data(path, use_brand=True, verbose=False)
    jm = jax_get_model("LightGCN")(
        jax_bundle.num_users, jax_bundle.num_items, jax_bundle.num_brands,
        JaxConfig(embedding_dim=16, n_layers=2),
    )
    m = get_model("LightGCN")(
        bundle.num_users, bundle.num_items, bundle.num_brands,
        Config(embedding_dim=16, n_layers=2), device="cpu",
    )
    return bundle, m, jax_bundle, jm


@pytest.fixture(scope="module")
def server_setup(models):
    bundle, m, jax_bundle, jm = models
    jp = jm.init(jax.random.PRNGKey(0))
    retriever = Retriever.from_params(m, _port_params(jp, m), bundle)
    server = RecommendServer(retriever, bundle.num_users, port=0)
    jax_server = JaxRecommendServer(
        JaxRetriever.from_params(jm, jp, jax_bundle), jax_bundle.num_users, port=0)
    server.start_background()
    jax_server.start_background()
    try:
        yield server, retriever, bundle, jax_server
    finally:
        server.shutdown()
        jax_server.shutdown()


# --- the cases of tests/test_server.py, one by one ---


def test_health_and_stats(server_setup):
    server, _, _, jax_server = server_setup
    status, body = _get(server.port, "/health")
    assert status == 200 and body == {"status": "ok"}
    assert _get(jax_server.port, "/health") == (status, body)
    status, body = _get(server.port, "/stats")
    assert status == 200
    for key in ("requests", "users_served", "dispatches", "mean_latency_ms"):
        assert key in body
    # the same keys as the JAX daemon's, plus the one the port adds
    _, jax_body = _get(jax_server.port, "/stats")
    assert set(body) == set(jax_body) | {"warm_failures"}


def test_recommend_matches_direct_retriever(server_setup):
    server, retriever, bundle, _ = server_setup
    users = np.unique(bundle.train.user_idx)[:5].tolist()
    status, body = _post(server.port, {"users": users, "k": 7})
    assert status == 200
    sv, iv = retriever.recommend(np.asarray(users, np.int32), k=7)
    assert body["items"] == iv.tolist()
    np.testing.assert_allclose(
        np.asarray(body["scores"]), sv, atol=5e-5  # scores rounded to 4dp
    )
    assert body["scores"] == [[round(float(v), 4) for v in row] for row in sv]


def test_filter_seen_toggle(server_setup):
    server, _, bundle, _ = server_setup
    users = np.unique(bundle.train.user_idx)[:4].tolist()
    _, filt = _post(server.port, {"users": users, "k": 10})
    _, unfilt = _post(server.port, {"users": users, "k": 10, "filter_seen": False})
    assert filt["items"] != unfilt["items"]


def test_concurrent_requests_coalesce_and_stay_correct(server_setup):
    server, retriever, bundle, _ = server_setup
    uniq = np.unique(bundle.train.user_idx)
    reqs = [uniq[i::7][:3].tolist() for i in range(7)]
    # the direct answers first: a Retriever serves one caller at a time
    want = [retriever.recommend(np.asarray(r, np.int32), k=5)[1].tolist() for r in reqs]
    results = [None] * len(reqs)

    def call(i):
        results[i] = _post(server.port, {"users": reqs[i], "k": 5})

    threads = [threading.Thread(target=call, args=(i,)) for i in range(len(reqs))]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=3 * HTTP_TIMEOUT)
        assert not t.is_alive()
    for i in range(len(reqs)):
        status, body = results[i]
        assert status == 200
        assert body["items"] == want[i]
    _, stats = _get(server.port, "/stats")
    assert stats["requests"] >= len(reqs)
    assert stats["dispatches"] <= stats["requests"]


def test_dispatcher_coalesces_queued_burst(server_setup):
    """Requests queued BEFORE the dispatcher thread starts must be served
    in ONE device dispatch (same (k, filter_seen) group)."""
    _, retriever, bundle, _ = server_setup
    d = Dispatcher(retriever, max_coalesce=16)
    uniq = np.unique(bundle.train.user_idx)
    pendings = [
        d.submit(_Pending(uniq[i : i + 2].astype(np.int32), 5, True))
        for i in range(5)
    ]
    d.start()
    try:
        for p in pendings:
            assert p.done.wait(timeout=HTTP_TIMEOUT)
            assert p.error is None
        with d.lock:
            stats = dict(d.stats)
    finally:
        d.stop()
    for p in pendings:
        _, iv = retriever.recommend(p.users, k=5)
        np.testing.assert_array_equal(p.result[1], iv)
    assert stats["dispatches"] == 1 and stats["coalesced_requests"] == 5


def test_dispatcher_stop_fast_fails_queued(server_setup):
    """stop() must complete still-queued requests with an error instead
    of leaving their waiters to time out."""
    _, retriever, _, _ = server_setup
    d = Dispatcher(retriever, max_coalesce=16)
    p = d.submit(_Pending(np.asarray([0], np.int32), 5, True))
    d.stop()  # thread never started; stop must fail the queued request
    assert p.done.wait(timeout=5)
    assert p.error is not None


def test_error_paths(server_setup):
    """The error paths of tests/test_server.py, held against the JAX
    daemon's answers: the same status codes and the same messages."""
    server, _, bundle, jax_server = server_setup
    probes = [
        ({"users": []}, "/recommend", 400),
        ({"users": [bundle.num_users + 5]}, "/recommend", 400),
        ({}, "/recommend", 400),
        ({"users": [[0, 1]]}, "/recommend", 400),
        ({"users": [0], "k": 0}, "/recommend", 400),
        ({"users": [0], "k": bundle.num_items + 1}, "/recommend", 400),
        ({"users": ["x"]}, "/recommend", 400),
        ({"users": [0]}, "/nope", 404),
        ({}, "/reload", 501),  # no reload_fn configured on the module fixture servers
    ]
    for payload, path, want in probes:
        status, body = _post(server.port, payload, path=path)
        assert status == want and "error" in body, (payload, path, status, body)
        assert (status, body) == _post(jax_server.port, payload, path=path)
    status, body = _post(server.port, {"users": [bundle.num_users + 5]})
    assert "out of range" in body["error"]
    with pytest.raises(urllib.error.HTTPError) as err:
        _get(server.port, "/nope")
    assert err.value.code == 404


def test_request_size_cap(models):
    """An oversized /recommend is rejected with 400 before it can occupy
    the single dispatcher thread."""
    bundle, m, _, jm = models
    retriever = Retriever.from_params(
        m, _port_params(jm.init(jax.random.PRNGKey(0)), m), bundle)
    server = RecommendServer(retriever, bundle.num_users, port=0, max_request_users=4)
    server.start_background()
    try:
        status, body = _post(server.port, {"users": [0, 1, 2, 3, 0], "k": 5})
        assert status == 400 and "too many users" in body["error"]
        status, _ = _post(server.port, {"users": [0, 1, 2, 3], "k": 5})
        assert status == 200
    finally:
        server.shutdown()


def test_reload_swaps_retriever(models):
    """POST /reload rebuilds the retriever (on the dispatcher thread) and
    served scores change to the new model without a restart."""
    bundle, m, _, jm = models
    params_v1 = _port_params(jm.init(jax.random.PRNGKey(0)), m)
    params_v2 = _port_params(jm.init(jax.random.PRNGKey(7)), m)
    versions = [params_v1]

    def reload_fn():
        # v2 "checkpoint" appears on the second build — stands in for a
        # newer checkpoint landing on disk between reloads
        return Retriever.from_params(m, versions[-1], bundle)

    users = np.unique(bundle.train.user_idx)[:4].tolist()
    # a directly built v2 retriever (before the server holds the model)
    _, iv2 = Retriever.from_params(m, params_v2, bundle).recommend(
        np.asarray(users, np.int32), k=5)
    server = RecommendServer(
        Retriever.from_params(m, params_v1, bundle), bundle.num_users, port=0,
        reload_fn=reload_fn,
    )
    server.start_background()
    try:
        _, before = _post(server.port, {"users": users, "k": 5})

        versions.append(params_v2)
        status, body = _post(server.port, {}, path="/reload")
        assert status == 200 and body["status"] == "reloaded"
        assert isinstance(body["seconds"], float)

        status, after = _post(server.port, {"users": users, "k": 5})
        assert status == 200
        assert after["items"] == iv2.tolist()
        assert after != before
        _, stats = _get(server.port, "/stats")
        assert stats["reloads"] == 1
    finally:
        server.shutdown()


def test_dispatcher_skips_abandoned_requests(server_setup):
    """A request whose handler already timed out (cancelled flag) is
    dropped without device work and counted as abandoned."""
    _, retriever, _, _ = server_setup
    d = Dispatcher(retriever, max_coalesce=16)
    dead = d.submit(_Pending(np.asarray([0], np.int32), 5, True))
    dead.cancelled = True
    live = d.submit(_Pending(np.asarray([1], np.int32), 5, True))
    d.start()
    try:
        assert live.done.wait(timeout=HTTP_TIMEOUT) and live.error is None
        assert dead.done.wait(timeout=5)
        assert dead.result is None
        with d.lock:
            stats = dict(d.stats)
    finally:
        d.stop()
    assert stats["abandoned"] == 1
    assert stats["requests"] == 1  # the abandoned one is not counted


def _wait_for_stats(port, done, seconds=30):
    deadline = time.time() + seconds
    st = {}
    while time.time() < deadline:
        _, st = _get(port, "/stats")
        if done(st):
            break
        time.sleep(0.1)
    return st


def test_warm_ladder_dispatches_coalesce_shapes(models):
    """warm=(batch, k) must pre-dispatch the coalesce ladder on the
    dispatcher thread before traffic, and normal requests must still
    serve afterwards."""
    bundle, m, _, jm = models
    retriever = Retriever.from_params(
        m, _port_params(jm.init(jax.random.PRNGKey(1)), m), bundle)
    server = RecommendServer(retriever, bundle.num_users, port=0,
                             max_coalesce=4, warm=(8, 5))
    server.start_background()
    try:
        st = _wait_for_stats(server.port, lambda s: s.get("warm_dispatches", 0) >= 3)
        assert st["warm_dispatches"] == 3  # m = 1, 2, 4
        assert st["warm_failures"] == 0
        # warm dispatches must not pollute request accounting
        assert st["requests"] == 0 and st["dispatches"] == 0
        status, out = _post(server.port, {"users": [0, 1], "k": 5})
        assert status == 200 and len(out["items"]) == 2
    finally:
        server.shutdown()


# --- the two daemons against each other ---


@pytest.mark.parametrize("k,filter_seen,n_users", [(20, True, 1), (7, True, 24), (10, False, 9)])
def test_bodies_match_jax_daemon(server_setup, k, filter_seen, n_users):
    server, _, bundle, jax_server = server_setup
    users = np.unique(bundle.train.user_idx)[3 : 3 + n_users].tolist()
    payload = {"users": users, "k": k, "filter_seen": filter_seen}
    status, body = _post(server.port, payload)
    jax_status, jax_body = _post(jax_server.port, payload)
    assert status == jax_status == 200
    assert set(body) == set(jax_body) == {"items", "scores"}
    got = (np.asarray(body["scores"]), np.asarray(body["items"]))
    want = (np.asarray(jax_body["scores"]), np.asarray(jax_body["items"]))
    assert got[0].shape == (n_users, k) and got[1].dtype == want[1].dtype
    # equal after the rounding, or one unit of the last digit apart; items
    # may swap only inside a group of scores that close
    assert_same_topk(got, want, tol=ROUNDED_ATOL)


def test_int8_daemon_matches_direct_int8_retriever(models):
    bundle, m, _, jm = models
    params = _port_params(jm.init(jax.random.PRNGKey(0)), m)
    users = np.unique(bundle.train.user_idx)[:12]
    sv, iv = Retriever.from_params(m, params, bundle, quantize=True).recommend(users, k=6)
    server = RecommendServer(
        Retriever.from_params(m, params, bundle, quantize=True), bundle.num_users, port=0)
    server.start_background()
    try:
        status, body = _post(server.port, {"users": users.tolist(), "k": 6})
    finally:
        server.shutdown()
    assert status == 200 and body["items"] == iv.tolist()
    assert body["scores"] == [[round(float(v), 4) for v in row] for row in sv]


# --- what the port adds ---


class _FakeRetriever:
    """Counts calls; fails where told to.  Stands in for a Retriever."""

    num_items = 50

    def __init__(self, fail_on=()):
        self.fail_on = set(fail_on)
        self.calls = []
        self.grad_modes = []
        self.threads = []

    def recommend_many(self, requests, k=20, filter_seen=True):
        self.calls.append(len(requests))
        self.grad_modes.append(torch.is_grad_enabled())
        self.threads.append(threading.current_thread())
        if len(requests) in self.fail_on:
            raise RuntimeError(f"no room for {len(requests)} requests")
        return [(np.zeros((len(u), k), np.float32), np.zeros((len(u), k), np.int64))
                for u in requests]


def test_warm_failure_is_logged_and_counted(capsys):
    """A failing warm dispatch is printed to stderr, once per shape, and
    counted; the server goes on to serve."""
    fake = _FakeRetriever(fail_on={2, 8})
    server = RecommendServer(fake, 10, port=0, max_coalesce=8, warm=(4, 5))
    server.start_background()
    try:
        done = lambda s: s["warm_dispatches"] + s["warm_failures"] >= 4  # noqa: E731
        st = _wait_for_stats(server.port, done)
        assert st["warm_dispatches"] == 2 and st["warm_failures"] == 2  # m = 1, 4 / 2, 8
        status, out = _post(server.port, {"users": [0, 1, 2], "k": 5})
        assert status == 200 and len(out["items"]) == 3
    finally:
        server.shutdown()
    err = capsys.readouterr().err
    assert err.count("warm dispatch of") == 2
    assert "warm dispatch of 2 x 4 users (k=5) failed" in err
    assert "RuntimeError: no room for 8 requests" in err
    assert fake.calls[:4] == [1, 2, 4, 8]


def test_dispatcher_thread_runs_without_grad():
    """Grad mode is per thread: requests, the warm ladder and the reload
    all run on the dispatcher thread with grad disabled, while the
    calling thread keeps its own mode."""
    fake = _FakeRetriever()
    seen = {}

    def build():
        seen["grad"] = torch.is_grad_enabled()
        seen["thread"] = threading.current_thread()
        return fake

    d = Dispatcher(fake, max_coalesce=2, warm=(2, 5))
    p = d.submit(_Pending(np.asarray([0], np.int32), 5, True))
    r = d.request_reload(build)
    assert torch.is_grad_enabled()
    d.start()
    try:
        assert p.done.wait(timeout=HTTP_TIMEOUT) and r.done.wait(timeout=HTTP_TIMEOUT)
    finally:
        d.stop()
    assert p.error is None and r.error is None
    assert fake.grad_modes == [False] * 3  # two warm dispatches and the request
    assert seen["grad"] is False
    assert set(fake.threads) == {d.thread} and seen["thread"] is d.thread
    assert torch.is_grad_enabled()


def test_reload_is_fifo_with_queued_requests(models):
    """A request queued before the reload is answered from the old
    tables, one queued after it from the new ones."""
    bundle, m, _, jm = models
    params_v1 = _port_params(jm.init(jax.random.PRNGKey(0)), m)
    params_v2 = _port_params(jm.init(jax.random.PRNGKey(7)), m)
    users = np.unique(bundle.train.user_idx)[:6].astype(np.int32)
    want = [Retriever.from_params(m, p, bundle).recommend(users, k=5)
            for p in (params_v1, params_v2)]
    assert not np.array_equal(want[0][1], want[1][1])
    d = Dispatcher(Retriever.from_params(m, params_v1, bundle), max_coalesce=16)
    before = d.submit(_Pending(users, 5, True))
    reload = d.request_reload(lambda: Retriever.from_params(m, params_v2, bundle))
    after = d.submit(_Pending(users, 5, True))
    d.start()
    try:
        for item in (before, reload, after):
            assert item.done.wait(timeout=HTTP_TIMEOUT) and item.error is None
        with d.lock:
            stats = dict(d.stats)
    finally:
        d.stop()
    np.testing.assert_array_equal(before.result[1], want[0][1])
    np.testing.assert_array_equal(after.result[1], want[1][1])
    assert stats["reloads"] == 1 and stats["dispatches"] == 2


@pytest.mark.parametrize("int8", [False, True])
def test_make_server_reloads_the_checkpoint_on_disk(models, tmp_path, int8, capsys):
    """``cli.make_server``: the server a user gets from ``serve``, built
    over loaded data; /reload reads the checkpoint directory again."""
    bundle, m, _, jm = models
    params_v1 = _port_params(jm.init(jax.random.PRNGKey(0)), m)
    params_v2 = _port_params(jm.init(jax.random.PRNGKey(7)), m)
    ckpt = str(tmp_path / "ckpt")
    save_params(ckpt, params_v1)
    argv = ["serve", "--model_path", ckpt, "--port", "0", "--device", "cpu",
            "--max_coalesce", "4", "--warm_batch", "8"] + (["--int8"] if int8 else [])
    args = cli.build_parser().parse_args(argv)
    config = Config(embedding_dim=16, n_layers=2)
    users = np.unique(bundle.train.user_idx)[:5]
    want = [Retriever.from_params(m, p, bundle, quantize=int8).recommend(users, k=20)[1]
            for p in (params_v1, params_v2)]
    server = cli.make_server(config, args, bundle, m, torch.device("cpu"))
    server.start_background()
    try:
        st = _wait_for_stats(server.port, lambda s: s["warm_dispatches"] >= 3)
        assert st["warm_dispatches"] == 3 and st["warm_failures"] == 0
        _, body = _post(server.port, {"users": users.tolist()})
        assert body["items"] == want[0].tolist()
        save_params(ckpt, params_v2)
        status, _ = _post(server.port, {}, path="/reload")
        assert status == 200
        _, body = _post(server.port, {"users": users.tolist()})
        assert body["items"] == want[1].tolist()
        assert server.dispatcher.retriever.quantized is int8
    finally:
        server.shutdown()
    assert capsys.readouterr().out.count("Model loaded from") == 2


def test_listen_backlog_takes_a_burst_of_clients():
    """The stdlib's backlog of 5 refuses or drops connection attempts of a
    burst (a dropped one waits a second before it tries again): the server
    listens with room for one, and every client of a burst of 48 is
    answered."""
    server = RecommendServer(_FakeRetriever(), 10, port=0)
    assert server.httpd.request_queue_size >= 64
    server.start_background()
    results = [None] * 48

    def call(i):
        results[i] = _post(server.port, {"users": [i % 10], "k": 5})[0]

    try:
        threads = [threading.Thread(target=call, args=(i,)) for i in range(len(results))]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=3 * HTTP_TIMEOUT)
            assert not t.is_alive()
    finally:
        server.shutdown()
    assert results == [200] * len(results)


def test_make_server_fails_without_a_checkpoint(models, tmp_path):
    bundle, m, _, _ = models
    args = cli.build_parser().parse_args(
        ["serve", "--model_path", str(tmp_path / "none"), "--device", "cpu"])
    with pytest.raises(FileNotFoundError, match="Model checkpoint not found"):
        cli.make_server(Config(embedding_dim=16, n_layers=2), args, bundle, m,
                        torch.device("cpu"))


def test_serve_parser_has_the_jax_daemons_flags():
    from gcn_recommendation_tpu import cli as jax_cli

    def flags(parser, mode):
        sub = next(a for a in parser._actions if hasattr(a, "choices") and a.choices)
        return {o for a in sub.choices[mode]._actions for o in a.option_strings}

    mine, theirs = flags(cli.build_parser(), "serve"), flags(jax_cli.build_parser(), "serve")
    for flag in ("--model_path", "--int8", "--host", "--port", "--max_coalesce",
                 "--max_request_users", "--warm_batch", "--profile_dir"):
        assert flag in mine and flag in theirs
    # every prepare flag of the JAX CLI, with the same defaults
    assert flags(cli.build_parser(), "prepare") == flags(jax_cli.build_parser(), "prepare")
    argv = ["prepare", "--recipe", "synthetic"]
    assert vars(cli.build_parser().parse_args(argv)) == vars(
        jax_cli.build_parser().parse_args(argv))
