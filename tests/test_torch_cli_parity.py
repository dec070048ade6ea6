"""The port's command line against the JAX package's, and its mesh runs.

* every option of the JAX parser's ``train``, ``test``, ``recommend`` and
  ``serve`` parses in the port, alone and all together, with the values
  the JAX parser gives it; the four lines that used to exit 2
  (``test --tile_spmm``, ``recommend --tile_min_fill 32``,
  ``train --debug_nans``, ``serve --mesh 1,1``) are pinned;
* ``train --debug_nans`` on a table with a NaN stops at the first step,
  naming its epoch and step;
* ``torchrun --nproc_per_node 2 ... train --mesh 1,2 --device cpu``: one
  tiny epoch whose printed loss and recall equal the one-process run's,
  printed once, with a logical checkpoint of 2 processes;
* ``torchrun --nproc_per_node 2 ... serve --mesh 1,2 --device cpu``: HTTP
  answers equal to the one-process server's, before and after a
  ``/reload``, and a clean shutdown on SIGINT.  Every HTTP call has a
  timeout.
"""

import argparse
import contextlib
import io
import json
import os
import re
import signal
import subprocess
import sys
import time
import urllib.error
import urllib.request

import pytest
import torch

from gcn_recommendation_tpu.cli import build_parser as jax_build_parser
from gcn_recommendation_tpu_torch import cli
from gcn_recommendation_tpu_torch.utils import checkpoint as ckpt
from test_torch_spmm import one_thread  # noqa: F401  (autouse: one thread)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
MODES = ("train", "test", "recommend", "serve")
HTTP_TIMEOUT_S = 20


def _subparser(parser, mode):
    for action in parser._actions:
        if isinstance(action, argparse._SubParsersAction):
            return action.choices[mode]
    raise KeyError(mode)


def _sample_argv(action):
    """One argv fragment that sets ``action`` to a value it accepts."""
    flag = action.option_strings[-1]
    if action.nargs == 0:
        return [flag]
    if action.choices:
        return [flag, str(list(action.choices)[-1])]
    if action.type is int:
        return [flag, "1"]
    if action.type is float:
        return [flag, "0.5"]
    return [flag, "1,1" if flag == "--mesh" else "3,7" if flag == "--users" else "x"]


@pytest.mark.parametrize("mode", MODES)
def test_every_jax_option_parses_in_the_port(mode):
    jax_sub = _subparser(jax_build_parser(), mode)
    port = cli.build_parser()
    everything = [mode]
    for action in jax_sub._actions:
        if not action.option_strings or action.dest == "help":
            continue
        argv = [mode] + _sample_argv(action)
        want = getattr(jax_build_parser().parse_args(argv), action.dest)
        got = getattr(port.parse_args(argv), action.dest)
        assert got == want, argv
        everything += argv[1:]
    jax_args = vars(jax_build_parser().parse_args(everything))
    port_args = vars(port.parse_args(everything))
    for key, value in jax_args.items():
        assert port_args[key] == value, key


@pytest.mark.parametrize("argv,dest,value", [
    (["test", "--tile_spmm"], "tile_spmm", True),
    (["recommend", "--tile_min_fill", "32"], "tile_min_fill", 32),
    (["train", "--debug_nans"], "debug_nans", True),
    (["serve", "--mesh", "1,1"], "mesh", "1,1"),
])
def test_lines_that_exited_2_parse(argv, dest, value):
    args = cli.build_parser().parse_args(argv)
    assert getattr(args, dest) == value
    config = cli._make_config(args)
    assert config.tile_min_fill == args.tile_min_fill and config.debug_nans == args.debug_nans
    assert args.schedule == "auto"


@pytest.fixture(scope="module")
def trained(tiny_bundle, tmp_path_factory):
    """A data dir and a one-process run of one epoch (its output and
    checkpoints)."""
    _, path = tiny_bundle
    out = str(tmp_path_factory.mktemp("single"))
    argv = ["train", "--processed_dir", path, "--device", "cpu", "--output_root", out,
            "--epochs", "1", "--val_interval", "1", "--batch_size", "128"]
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        assert cli.main(argv) == 0
    return path, out, buf.getvalue(), argv


def _ckpt_dir(out):
    return os.path.join(out, "exp", "checkpoints", "checkpoints", "best_lightgcn_core16")


def test_debug_nans_stops_at_the_first_nonfinite_loss(trained, tmp_path):
    path, out, _, argv = trained
    d = _ckpt_dir(out)
    state = ckpt.load_state(d, "last")
    state["params"]["user_embedding"][0, 0] = float("nan")
    nan_dir = str(tmp_path / "exp" / "checkpoints" / "checkpoints" / "best_lightgcn_core16")
    ckpt.save_state(nan_dir, "last", state["params"], state["optimizer"], state["epoch"],
                    state["best_recall"], state["generator"])
    argv = [a if a != out else str(tmp_path) for a in argv]
    argv[argv.index("--epochs") + 1] = "2"
    with pytest.raises(FloatingPointError, match=r"at epoch 2 step 0"):
        with contextlib.redirect_stdout(io.StringIO()):
            cli.main(argv + ["--resume", "--debug_nans"])


def _torchrun(argv):
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["OMP_NUM_THREADS"] = "1"
    return [sys.executable, "-m", "torch.distributed.run", "--standalone",
            "--nproc_per_node", "2", "-m", "gcn_recommendation_tpu_torch", *argv], env


def test_torchrun_train_on_a_1x2_mesh(trained, tmp_path):
    path, out, single_out, argv = trained
    argv = [a if a != out else str(tmp_path) for a in argv] + ["--mesh", "1,2"]
    cmd, env = _torchrun(argv)
    res = subprocess.run(cmd, cwd=REPO, env=env, capture_output=True, text=True, timeout=240)
    assert res.returncode == 0, res.stdout[-3000:] + res.stderr[-3000:]
    assert res.stdout.count("Sharded execution: mesh {'data': 1, 'model': 2}, "
                            "schedule=halo") == 1
    assert res.stdout.count("Training finished.") == 1
    for pattern in (r"Epoch 1/1, Average Loss: [0-9.]+", r"Val Recall@20: [0-9.]+, "
                    r"Val NDCG@20: [0-9.]+"):
        assert re.findall(pattern, res.stdout) == re.findall(pattern, single_out), pattern
    with open(ckpt.checkpoint_path(_ckpt_dir(str(tmp_path)), "best") + ".layout.json") as f:
        assert json.load(f) == {"layout": "logical", "process_count": 2}
    mesh_params = ckpt.load_params(_ckpt_dir(str(tmp_path)), device="cpu")
    single_params = ckpt.load_params(_ckpt_dir(out), device="cpu")
    for k, v in single_params.items():
        torch.testing.assert_close(mesh_params[k], v, rtol=1e-4, atol=1e-6)


def _http(port, path, payload=None):
    data = None if payload is None else json.dumps(payload).encode()
    req = urllib.request.Request(f"http://127.0.0.1:{port}{path}", data=data,
                                 method="POST" if data is not None or path == "/reload"
                                 else "GET")
    try:
        with urllib.request.urlopen(req, timeout=HTTP_TIMEOUT_S) as r:
            return r.status, json.loads(r.read())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read())


def _children(pid):
    """(pid, environ) of the processes whose parent is ``pid``."""
    out = []
    for entry in os.listdir("/proc"):
        if not entry.isdigit():
            continue
        try:
            with open(f"/proc/{entry}/stat") as f:
                ppid = int(f.read().rsplit(")", 1)[1].split()[1])
            if ppid == pid:
                with open(f"/proc/{entry}/environ", "rb") as f:
                    out.append((int(entry), f.read().split(b"\0")))
        except OSError:
            continue
    return out


REQUESTS = [{"users": [3, 7], "k": 5}, {"users": list(range(0, 60, 4)), "k": 10},
            {"users": [11], "k": 20, "filter_seen": False}, {"users": [], "k": 5},
            {"users": [10 ** 6]}]


def test_torchrun_serve_on_a_1x2_mesh(trained, tmp_path):
    path, out, _, _ = trained
    argv = ["serve", "--processed_dir", path, "--device", "cpu", "--output_root", out,
            "--port", "0", "--int8", "--warm_batch", "4"]
    # the one-process server of the same checkpoint, in this process
    args = cli.build_parser().parse_args(argv)
    config = cli._make_config(args)
    with contextlib.redirect_stdout(io.StringIO()):
        bundle, model = cli._load_everything(config, torch.device("cpu"))
        single = cli.make_server(config, args, bundle, model, torch.device("cpu"))
    single.start_background()
    cmd, env = _torchrun(argv + ["--mesh", "1,2"])
    log = open(tmp_path / "serve.log", "w+")
    proc = subprocess.Popen(cmd, cwd=REPO, env=env, stdout=log, stderr=subprocess.STDOUT,
                            text=True)
    try:
        port = None
        deadline = time.time() + 180
        while port is None and time.time() < deadline and proc.poll() is None:
            time.sleep(0.5)
            log.seek(0)
            m = re.search(r"serving on http://127\.0\.0\.1:(\d+)", log.read())
            port = int(m.group(1)) if m else None
        log.seek(0)
        assert port is not None, log.read()[-3000:]
        assert _http(port, "/health") == (200, {"status": "ok"})
        for req in REQUESTS:
            assert _http(port, "/recommend", req) == _http(single.port, "/recommend", req), req
        assert _http(port, "/reload")[0] == 200
        for req in REQUESTS[:2]:
            assert _http(port, "/recommend", req) == _http(single.port, "/recommend", req), req
        stats = _http(port, "/stats")[1]
        assert stats["reloads"] == 1 and stats["warm_dispatches"] == 5
        # SIGINT to rank 0: it stops serving and tells rank 1 to stop
        rank0 = [pid for pid, environ in _children(proc.pid) if b"RANK=0" in environ]
        assert len(rank0) == 1
        os.kill(rank0[0], signal.SIGINT)
        assert proc.wait(timeout=60) == 0
    finally:
        single.shutdown()
        if proc.poll() is None:
            proc.kill()
            proc.wait(timeout=30)
        log.close()
