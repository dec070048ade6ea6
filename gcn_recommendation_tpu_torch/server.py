"""Online serving daemon: HTTP front end over serve.Retriever.

PyTorch counterpart of ``gcn_recommendation_tpu/server.py``: the same
endpoints, status codes and JSON bodies.  Design constraints, in order:

* **One device thread.**  All device work happens on a single dispatcher
  thread; HTTP handler threads only enqueue requests and wait on their
  reply events.  On CUDA this is not about the client library (PyTorch may
  be called from several threads) but about state: the current device,
  the current stream and the grad mode are per thread, a ``Retriever``
  reuses its int8 user buffers from request to request, and a reload that
  runs on the same thread as the requests is ordered with them by the
  queue alone, so the swap is atomic without a lock.  The thread runs
  under ``torch.no_grad()`` and makes the retriever's device its current
  one.
* **Micro-batched dispatch.**  The dispatcher drains whatever is queued
  (bounded by --max_coalesce) into one ``Retriever.recommend_many`` call:
  one masked top-k over all the users instead of one per request, each
  of which would pay its own launches and its own copy to the host.  An
  idle server serves single requests with no added latency window.
* **Stdlib only** (http.server) — no framework dependencies.

Endpoints:

* ``GET  /health``     -> {"status": "ok"}
* ``GET  /stats``      -> request/user counters + latency aggregates
* ``POST /recommend``  body {"users": [...], "k": 20,
  "filter_seen": true} -> {"items": [[...], ...], "scores": [[...], ...]}
* ``POST /reload``     -> rebuild the Retriever from the checkpoint on
  disk (newest weights), executed ON the dispatcher thread, and
  atomically swap it in.  Requests queued before the reload finish on
  the old tables; everything after scores on the new ones.  The old
  retriever lives until the swap, so a reload holds two catalogs (and two
  device graphs) for its duration.

Run: ``python -m gcn_recommendation_tpu_torch serve --processed_dir ...
[--port 8000] [--int8] [--device cpu]``.

On a mesh (``serve --mesh DATA,MODEL``, one process per device), the
JAX daemon's single controller becomes a leader and followers: the HTTP
server and the ``Dispatcher`` live on rank 0, whose retriever is a
``MeshLeader``.  Before each dispatch, each reload and at shutdown, rank
0 broadcasts a small header (op, n, k, filter_seen) and then the user
ids; every other rank runs ``follow``, which makes the same call and so
joins the same collectives.  An error in a follower ends its process.
"""

from __future__ import annotations

import json
import queue
import sys
import threading
import time
import traceback
from dataclasses import dataclass, field
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Callable, List, Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist


@dataclass
class _Pending:
    """One enqueued request, completed by the dispatcher thread."""

    users: np.ndarray
    k: int
    filter_seen: bool
    done: threading.Event = field(default_factory=threading.Event)
    result: Optional[Tuple[np.ndarray, np.ndarray]] = None
    error: Optional[str] = None
    t_submit: float = 0.0  # stamped by Dispatcher.submit
    # set by the handler when it gives up waiting (504): the dispatcher
    # drops abandoned requests instead of spending device time on
    # results nobody will read
    cancelled: bool = False


@dataclass
class _Reload:
    """A model-refresh request: ``build()`` runs on the dispatcher
    thread (the only thread that touches the device) and returns the
    replacement Retriever."""

    build: Callable[[], object]
    done: threading.Event = field(default_factory=threading.Event)
    error: Optional[str] = None
    seconds: float = 0.0


class Dispatcher:
    """Single-threaded device dispatcher with micro-batch coalescing.

    Requests with the same (k, filter_seen) that are waiting in the
    queue at drain time are coalesced into ONE device dispatch via
    ``Retriever.recommend_many``; mixed settings fall back to per-group
    dispatches in arrival order.
    """

    def __init__(self, retriever, max_coalesce: int = 16,
                 warm: Optional[Tuple[int, int]] = None):
        self.retriever = retriever
        self.max_coalesce = max_coalesce
        self.q: "queue.Queue[_Pending]" = queue.Queue()
        self.lock = threading.Lock()
        self.stats = {
            "requests": 0,
            "users_served": 0,
            "dispatches": 0,
            "coalesced_requests": 0,
            "latency_ms_sum": 0.0,
            "abandoned": 0,
            "reloads": 0,
            "warm_dispatches": 0,
            "warm_failures": 0,
        }
        self.warm = warm
        self._stop = threading.Event()
        self.thread = threading.Thread(target=self._run, daemon=True)

    def start(self):
        self.thread.start()

    def stop(self):
        self._stop.set()
        self.q.put(None)  # wake the drain loop
        if self.thread.is_alive():
            self.thread.join(timeout=10)
        self._fail_queued("server shutting down")

    def _fail_queued(self, reason: str):
        """Fast-fail anything still queued so waiting handlers return
        immediately instead of blocking out their full timeout."""
        while True:
            try:
                p = self.q.get_nowait()
            except queue.Empty:
                return
            if p is not None:
                p.error = reason
                p.done.set()

    def submit(self, p: _Pending) -> _Pending:
        p.t_submit = time.perf_counter()
        self.q.put(p)
        return p

    def request_reload(self, build: Callable[[], object]) -> _Reload:
        """Enqueue a retriever swap; built + swapped on the dispatcher
        thread, FIFO with the pending requests."""
        r = _Reload(build)
        self.q.put(r)
        return r

    # --- dispatcher thread ---
    def _drain(self) -> List[object]:
        """Block for one request, then grab everything else queued.

        A _Reload item ends the drain (and is returned last), so a
        reload never interleaves with requests queued after it — those
        are served by the NEW retriever on the next drain."""
        first = self.q.get()
        if first is None:
            return []
        batch = [first]
        if isinstance(first, _Reload):
            return batch
        while len(batch) < self.max_coalesce:
            try:
                nxt = self.q.get_nowait()
            except queue.Empty:
                break
            if nxt is None:
                self._stop.set()
                break
            batch.append(nxt)
            if isinstance(nxt, _Reload):
                break
        return batch

    def _reload(self, r: _Reload):
        """Swap the retriever; runs on the dispatcher thread, which is
        the only thread that dispatches device work — so the propagation
        inside ``build()`` runs under this thread's no-grad mode and
        device, and no request is in flight while the tables change."""
        t0 = time.perf_counter()
        try:
            self.retriever = r.build()
            r.seconds = time.perf_counter() - t0
            with self.lock:
                self.stats["reloads"] += 1
        except Exception as e:
            r.error = f"{type(e).__name__}: {e}"
        r.done.set()

    def _warm_ladder(self):
        """Dispatch the coalesced shapes BEFORE taking traffic.

        Nothing is compiled on CUDA, but the first call at a shape pays
        for what is set up lazily: the cuBLAS / int8-product handles and
        workspaces, the allocator's first blocks of each size, and the
        retriever's int8 user buffers of that shape.  Runs on the
        dispatcher thread, so traffic queued during the warm simply waits
        behind it, exactly like any other dispatch.  A failure is printed
        to stderr and counted (``warm_failures`` in /stats); the server
        still goes on to serve."""
        batch, k = self.warm
        users = np.zeros(batch, np.int32)
        m = 1
        while m <= self.max_coalesce:
            try:
                self.retriever.recommend_many([users] * m, k=k)
                with self.lock:
                    self.stats["warm_dispatches"] += 1
            except Exception:
                with self.lock:
                    self.stats["warm_failures"] += 1
                print(f"warm dispatch of {m} x {batch} users (k={k}) failed:\n"
                      f"{traceback.format_exc()}", file=sys.stderr, flush=True)
            m *= 2

    def _run(self):
        # grad mode and the current device are per thread: this thread
        # starts with grad enabled and device 0
        device = getattr(self.retriever, "device", None)
        if isinstance(device, torch.device) and device.type == "cuda":
            torch.cuda.set_device(device)
        with torch.no_grad():
            self._serve()

    def _serve(self):
        if self.warm:
            self._warm_ladder()
        while not self._stop.is_set():
            batch = self._drain()
            if not batch:
                continue
            reloads = [p for p in batch if isinstance(p, _Reload)]
            pendings = [p for p in batch if isinstance(p, _Pending)]
            # drop requests whose handler already timed out (504): their
            # result would go unread, so don't spend device time on them
            abandoned = [p for p in pendings if p.cancelled]
            if abandoned:
                with self.lock:
                    self.stats["abandoned"] += len(abandoned)
                for p in abandoned:
                    p.done.set()
            # group by (k, filter_seen) — each group is one device dispatch
            groups = {}
            for p in pendings:
                if p.cancelled:
                    continue
                groups.setdefault((p.k, p.filter_seen), []).append(p)
            for (k, filt), group in groups.items():
                try:
                    outs = self.retriever.recommend_many(
                        [p.users for p in group], k=k, filter_seen=filt
                    )
                    for p, (scores, items) in zip(group, outs):
                        p.result = (scores, items)
                except Exception as e:  # surface per-request, keep serving
                    for p in group:
                        p.error = f"{type(e).__name__}: {e}"
                now = time.perf_counter()
                with self.lock:
                    self.stats["dispatches"] += 1
                    self.stats["coalesced_requests"] += len(group)
                    self.stats["requests"] += len(group)
                    self.stats["users_served"] += sum(
                        len(p.users) for p in group
                    )
                    # per-request latency = queue wait + this group's
                    # dispatch (each request charged from ITS submit time)
                    self.stats["latency_ms_sum"] += sum(
                        (now - p.t_submit) * 1e3 for p in group
                    )
                for p in group:
                    p.done.set()
            for r in reloads:
                self._reload(r)
        self._fail_queued("server shutting down")


def _make_handler(dispatcher: Dispatcher, num_users: int, timeout_s: float,
                  num_items: Optional[int] = None,
                  max_request_users: int = 8192,
                  reload_fn: Optional[Callable[[], object]] = None,
                  reload_timeout_s: float = 600.0):
    class Handler(BaseHTTPRequestHandler):
        # quiet per-request stderr logging
        def log_message(self, fmt, *args):  # noqa: D102
            pass

        def _reply(self, code: int, payload: dict):
            body = json.dumps(payload).encode()
            self.send_response(code)
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def do_GET(self):  # noqa: N802
            if self.path == "/health":
                return self._reply(200, {"status": "ok"})
            if self.path == "/stats":
                with dispatcher.lock:
                    s = dict(dispatcher.stats)
                n = max(1, s["requests"])
                s["mean_latency_ms"] = round(s.pop("latency_ms_sum") / n, 2)
                return self._reply(200, s)
            return self._reply(404, {"error": "unknown path"})

        def do_POST(self):  # noqa: N802
            if self.path == "/reload":
                if reload_fn is None:
                    return self._reply(
                        501, {"error": "no reload source configured"}
                    )
                r = dispatcher.request_reload(reload_fn)
                # checkpoint restore + graph upload + re-propagation wait
                # behind whatever is queued — its own, longer timeout
                if not r.done.wait(timeout=reload_timeout_s):
                    return self._reply(504, {"error": "reload timeout"})
                if r.error is not None:
                    return self._reply(500, {"error": r.error})
                return self._reply(
                    200, {"status": "reloaded", "seconds": round(r.seconds, 3)}
                )
            if self.path != "/recommend":
                return self._reply(404, {"error": "unknown path"})
            try:
                length = int(self.headers.get("Content-Length", 0))
                req = json.loads(self.rfile.read(length) or b"{}")
                users = np.asarray(req["users"], dtype=np.int32)
                if users.ndim != 1 or len(users) == 0:
                    raise ValueError("users must be a non-empty 1-D list")
                if len(users) > max_request_users:
                    # one oversized request would occupy the single
                    # dispatcher thread with an arbitrarily large device
                    # batch, stalling every other client
                    raise ValueError(
                        f"too many users in one request: {len(users)} > "
                        f"cap {max_request_users}"
                    )
                bad = users[(users < 0) | (users >= num_users)]
                if len(bad):
                    raise ValueError(
                        f"user ids out of range [0, {num_users}): {bad.tolist()}"
                    )
                k = int(req.get("k", 20))
                # reject bad k here with a 400 (mirrors cli.run_recommend's
                # early validation) instead of a 500 from the device layer
                k_cap = num_items if num_items is not None else 1 << 20
                if not 0 < k <= k_cap:
                    raise ValueError(f"k must be in [1, {k_cap}], got {k}")
                filter_seen = bool(req.get("filter_seen", True))
            except (KeyError, ValueError, TypeError, json.JSONDecodeError) as e:
                return self._reply(400, {"error": str(e)})

            p = dispatcher.submit(_Pending(users, k, filter_seen))
            if not p.done.wait(timeout=timeout_s):
                # best-effort: if the dispatcher hasn't picked it up yet
                # it will skip the device work and count it as abandoned
                p.cancelled = True
                return self._reply(504, {"error": "dispatch timeout"})
            if p.error is not None:
                return self._reply(500, {"error": p.error})
            scores, items = p.result
            return self._reply(
                200,
                {
                    "items": items.tolist(),
                    "scores": [[round(float(v), 4) for v in row] for row in scores],
                },
            )

    return Handler


class _HTTPServer(ThreadingHTTPServer):
    # socketserver listens with a backlog of 5.  A burst of clients that
    # connect at once overflows it, the kernel drops the attempts, and each
    # client waits a second before it tries again: with 16 clients the p99
    # latency was 1.0 s whatever the device did (tools/exp_daemon_backlog.py)
    request_queue_size = 128


class RecommendServer:
    """Bind + serve loop wrapper (also used in-process by tests)."""

    def __init__(self, retriever, num_users: int, host: str = "127.0.0.1",
                 port: int = 8000, max_coalesce: int = 16,
                 timeout_s: float = 60.0, max_request_users: int = 8192,
                 reload_fn: Optional[Callable[[], object]] = None,
                 reload_timeout_s: float = 600.0,
                 warm: Optional[Tuple[int, int]] = None,
                 on_stop: Optional[Callable[[], None]] = None):
        """``reload_fn``: zero-arg callable returning a fresh Retriever
        (typically: restore the newest checkpoint + re-propagate); wired
        to ``POST /reload`` and executed on the dispatcher thread.
        ``on_stop``: called once the dispatcher has stopped (a mesh
        leader's shutdown announcement)."""
        self.on_stop = on_stop
        self.dispatcher = Dispatcher(retriever, max_coalesce=max_coalesce,
                                     warm=warm)
        handler = _make_handler(
            self.dispatcher, num_users, timeout_s,
            num_items=getattr(retriever, "num_items", None),
            max_request_users=max_request_users,
            reload_fn=reload_fn,
            reload_timeout_s=reload_timeout_s,
        )
        self.httpd = _HTTPServer((host, port), handler)
        self.port = self.httpd.server_address[1]  # resolved when port=0

    def serve_forever(self):
        self.dispatcher.start()
        try:
            self.httpd.serve_forever()
        finally:
            self.httpd.server_close()
            self._stop_dispatcher()

    def _stop_dispatcher(self):
        self.dispatcher.stop()
        if self.on_stop is not None:
            on_stop, self.on_stop = self.on_stop, None
            on_stop()

    # --- test/in-process helpers ---
    def start_background(self):
        self.dispatcher.start()
        self._srv_thread = threading.Thread(
            target=self.httpd.serve_forever, daemon=True
        )
        self._srv_thread.start()

    def shutdown(self):
        self.httpd.shutdown()
        self.httpd.server_close()
        self._stop_dispatcher()


# --- a mesh of ranks: rank 0 leads, the others follow ---
_OP_DISPATCH, _OP_RELOAD, _OP_STOP = 0, 1, 2


def _announce(device, op: int, users=None, k: int = 0, filter_seen: bool = True):
    """Rank 0: broadcast (op, n, k, filter_seen), then the n user ids."""
    users = np.zeros(0, np.int64) if users is None else np.asarray(users, np.int64)
    header = torch.tensor([op, len(users), k, int(filter_seen)], dtype=torch.int64,
                          device=device)
    dist.broadcast(header, src=0)
    if len(users):
        dist.broadcast(torch.from_numpy(users).to(device), src=0)


def _receive(device):
    """Every other rank: the next announcement as (op, users, k,
    filter_seen)."""
    header = torch.empty(4, dtype=torch.int64, device=device)
    dist.broadcast(header, src=0)
    op, n, k, filter_seen = header.tolist()
    users = torch.empty(n, dtype=torch.int64, device=device)
    if n:
        dist.broadcast(users, src=0)
    return op, users.cpu().numpy().astype(np.int32), k, bool(filter_seen)


class MeshLeader:
    """Rank 0's retriever on a mesh: it announces each call to the
    other ranks, then makes it (the dispatcher thread is the only caller)."""

    def __init__(self, retriever):
        self.retriever = retriever
        self.device = retriever.device
        self.num_items = retriever.num_items

    def recommend_many(self, requests, k: int = 20, filter_seen: bool = True):
        users = np.concatenate([np.atleast_1d(np.asarray(u, np.int32)) for u in requests])
        _announce(self.device, _OP_DISPATCH, users, k, filter_seen)
        return self.retriever.recommend_many(requests, k, filter_seen)

    def reload(self, build: Callable[[], object]):
        """Every rank rebuilds its retriever; returns this leader."""
        _announce(self.device, _OP_RELOAD)
        self.retriever = build()
        return self

    def stop(self):
        _announce(self.device, _OP_STOP)


def follow(retriever, reload_fn: Callable[[], object]) -> None:
    """The loop of a rank other than 0: wait for rank 0's announcement
    and make the same call (``recommend`` of the coalesced users, a
    rebuild), until rank 0 stops.  Runs under ``no_grad``."""
    with torch.no_grad():
        while True:
            op, users, k, filter_seen = _receive(retriever.device)
            if op == _OP_STOP:
                return
            if op == _OP_RELOAD:
                retriever = reload_fn()
            elif op == _OP_DISPATCH:
                retriever.recommend(users, k=k, filter_seen=filter_seen)
            else:
                raise RuntimeError(f"unknown announcement {op} from rank 0")
