"""Experiment: the daemon's listen backlog under a burst of clients.

``http.server`` listens with a backlog of 5 (``request_queue_size``).
The daemon phase of ``chip_smoke.py`` (16 client threads, 232 requests of
1-64 users, a ``/reload`` in the middle, the books-shaped bundle, LightGCN
dim 64, 3 layers) is run here with that backlog and with the 128 that
``server.py`` sets, in turns (5, 128, 5, 128), for the f32 and the int8
catalog: requests/s, users/s and the latency percentiles of each run.

    python -m gcn_recommendation_tpu_torch.tools.exp_daemon_backlog

Run it from the repository's root (it drives ``chip_smoke.py``'s own
phase).  Needs a CUDA card and ``nvcc``.  Prints one JSON line per run.
"""

from __future__ import annotations

import json
import subprocess

import torch

from gcn_recommendation_tpu_torch import server
from gcn_recommendation_tpu_torch.config import Config
from gcn_recommendation_tpu_torch.kernels import _build
from gcn_recommendation_tpu_torch.models import get_model

BACKLOGS = (5, 128, 5, 128)
KEYS = ("catalog", "requests_per_s", "users_per_s", "latency_mean_ms", "latency_p50_ms",
        "latency_p99_ms", "latency_max_ms", "coalesce_factor", "reload_s")


def main() -> int:
    if not torch.cuda.is_available():
        raise RuntimeError("CUDA is not available: the experiment runs on the card only")
    import chip_smoke  # at the repository's root

    dev = torch.device("cuda")
    _build.build()
    bundle, _ = chip_smoke.books_bundle()
    model = get_model("LightGCN")(bundle.num_users, bundle.num_items, bundle.num_brands,
                                  Config(embedding_dim=64, n_layers=3), device=dev)
    versions = [{k: v * 32.0 for k, v in
                 model.init(torch.Generator().manual_seed(seed)).items()} for seed in (42, 43)]
    shipped = server._HTTPServer.request_queue_size
    try:
        for backlog in BACKLOGS:
            server._HTTPServer.request_queue_size = backlog
            for int8 in (False, True):
                meas = chip_smoke._daemon_catalog(dev, bundle, model, *versions, int8)
                print(json.dumps({"backlog": backlog, **{k: meas[k] for k in KEYS}}), flush=True)
    finally:
        server._HTTPServer.request_queue_size = shipped
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip())
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
