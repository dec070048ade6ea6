"""Multi-process dry run of the distributed path: N OS processes, one device each.

Counterpart of the JAX package's ``tools/multiproc_dryrun.py``.  JAX runs
a process per host; the port runs a process per device, so the N worker
processes here are what N ranks of ``torchrun`` would be: each gets
``RANK`` / ``WORLD_SIZE`` / ``LOCAL_RANK`` / ``MASTER_ADDR`` /
``MASTER_PORT`` in its environment and calls the port's
``core.distributed.initialize`` (the call every rank makes), then

* phase 1: a cross-process all-reduce (every rank adds its rank) and
  all-gather, a sharded LightGCN forward over the mesh of
  ``auto_mesh_spec()`` (``parallel/spmd.py::ShardedTrainer``), then a
  2-epoch sharded run that writes its checkpoint and exits (the "kill");
* phase 2: fresh processes resume it to 4 epochs (``fit(resume=True)``)
  and hold the params against an uninterrupted 4-epoch run (rtol 1e-5,
  atol 1e-7); then the halo check: one ``HaloTrainer`` epoch and its
  sharded validation on a (1, N) mesh of the N processes;
* halo_single: the same halo run in one process (a world of one, mesh
  (1, 1)); the loss, recall and NDCG must agree with the N processes'
  within 1e-5 + 1e-4 x |one-process value|.

The parent checks every worker's exit code (each waited for under
``--timeout``), prints the halo equality line and ``multiproc_dryrun
PASSED``, and returns 0; any failure returns 1.

``--device cuda`` (the default) gives rank r the card ``cuda:r`` over
NCCL and needs one card per rank; ``--device cpu`` runs gloo on the CPU.

    python -m gcn_recommendation_tpu_torch.tools.multiproc_dryrun [nprocs] [--device cpu]
"""

from __future__ import annotations

import argparse
import json
import os
import socket
import subprocess
import sys
import tempfile

MODULE = "gcn_recommendation_tpu_torch.tools.multiproc_dryrun"
REPO = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
HALO_KEYS = ("avg_loss", "recall", "ndcg")


def _halo_check(mesh, out_path: str, rank: int, scratch: str) -> None:
    """One HaloTrainer epoch + sharded validate on ``mesh``; rank 0 writes
    {avg_loss, recall, ndcg} for the parent's equality check."""
    from gcn_recommendation_tpu_torch.config import Config
    from gcn_recommendation_tpu_torch.data.synthetic import synthetic_bundle
    from gcn_recommendation_tpu_torch.models import get_model
    from gcn_recommendation_tpu_torch.parallel.halo import HaloTrainer
    from gcn_recommendation_tpu_torch.utils.logging import Logger

    class History(Logger):
        """The run's metrics for the check; no CSV and no plot (matplotlib's
        import alone is ~2 s a process)."""

        def save(self, total_epochs: int) -> None:
            pass

    cfg = Config(embedding_dim=16, n_layers=2, batch_size=64, epochs=1, val_interval=1,
                 checkpoint_dir=os.path.join(scratch, "ck"),
                 results_dir=os.path.join(scratch, f"res{rank}"))
    # a brand count that no model axis divides: the padded row shards
    bundle = synthetic_bundle(num_users=90, num_items=70, num_brands=11, mean_degree=8.0, seed=1)
    model = get_model("LightGCN")(bundle.num_users, bundle.num_items, bundle.num_brands, cfg,
                                  device=mesh.device)
    logger = History(os.path.join(scratch, f"log{rank}"), "halo", top_k=cfg.top_k)
    HaloTrainer(cfg, model, bundle, mesh, logger=logger).fit()
    hist = logger.history
    if not hist["epoch"]:
        raise RuntimeError("halo run produced no validation metrics")
    if rank == 0:
        result = {"avg_loss": hist["epoch_avg_loss"][-1], "recall": hist["recall"][-1],
                  "ndcg": hist["ndcg"][-1]}
        with open(out_path, "w") as f:
            json.dump(result, f)
        print(f"halo check: loss={result['avg_loss']:.6f} recall={result['recall']:.6f} "
              f"-> {out_path}", flush=True)


def _make_trainer(mesh, ckroot: str, sub: str, epochs: int):
    from gcn_recommendation_tpu_torch.config import Config
    from gcn_recommendation_tpu_torch.data.synthetic import synthetic_bundle
    from gcn_recommendation_tpu_torch.models import get_model
    from gcn_recommendation_tpu_torch.parallel.spmd import ShardedTrainer

    cfg = Config(embedding_dim=16, n_layers=2, batch_size=64, epochs=epochs, val_interval=2,
                 checkpoint_dir=os.path.join(ckroot, sub),
                 results_dir=os.path.join(ckroot, sub + "_res"))
    b = synthetic_bundle(num_users=90, num_items=70, num_brands=11, mean_degree=8.0, seed=1)
    m = get_model("LightGCN")(b.num_users, b.num_items, b.num_brands, cfg, device=mesh.device)
    return ShardedTrainer(cfg, m, b, mesh)


def worker(nprocs: int, rank: int, phase: str, workdir: str, device: str) -> None:
    import numpy as np
    import torch
    import torch.distributed as dist

    from gcn_recommendation_tpu_torch.core import distributed
    from gcn_recommendation_tpu_torch.core.mesh import MeshSpec, create_mesh

    if device == "cpu":
        torch.set_num_threads(1)  # the ranks share this machine's cores
    dev = distributed.initialize(device)
    try:
        if distributed.get_world_size() != nprocs or distributed.get_rank() != rank:
            raise RuntimeError(f"rank {distributed.get_rank()} of {distributed.get_world_size()}, "
                               f"launched as {rank} of {nprocs}")
        if phase == "halo_single":
            mesh = create_mesh(MeshSpec(data=1, model=1))
            _halo_check(mesh, os.path.join(workdir, "halo_single.json"), rank,
                        os.path.join(workdir, phase))
            return

        mesh = create_mesh(distributed.auto_mesh_spec())
        if phase == "1":
            # cross-process collectives: every rank's contribution arrives
            t = torch.tensor([float(rank)], device=dev)
            dist.all_reduce(t)
            expect = float(nprocs * (nprocs - 1) / 2)
            if float(t) != expect:
                raise RuntimeError(f"all_reduce gave {float(t)}, expected {expect}")
            parts = [torch.zeros(1, device=dev) for _ in range(nprocs)]
            dist.all_gather(parts, torch.tensor([float(rank)], device=dev))
            if [float(p) for p in parts] != [float(r) for r in range(nprocs)]:
                raise RuntimeError(f"all_gather gave {[float(p) for p in parts]}")
            # a tiny sharded forward over the mesh (row-sharded tables)
            from gcn_recommendation_tpu_torch.config import Config
            from gcn_recommendation_tpu_torch.data.synthetic import synthetic_bundle
            from gcn_recommendation_tpu_torch.models import get_model
            from gcn_recommendation_tpu_torch.parallel.spmd import ShardedTrainer

            cfg = Config(embedding_dim=16, n_layers=2, batch_size=64, epochs=1)
            b = synthetic_bundle(num_users=256, num_items=128, num_brands=16, mean_degree=8.0,
                                 seed=0)
            m = get_model("LightGCN")(b.num_users, b.num_items, b.num_brands, cfg, device=dev)
            m.init(torch.Generator().manual_seed(0))
            with torch.no_grad():
                fu, fi, *_ = ShardedTrainer(cfg, m, b, mesh)._forward()
            if not (torch.isfinite(fu).all() and torch.isfinite(fi).all()):
                raise RuntimeError("sharded forward gave non-finite embeddings")
            # train 2 epochs, checkpoint, exit: the 'kill'
            _, best = _make_trainer(mesh, workdir, "ck", epochs=2).fit()
            if not best > 0.0:
                raise RuntimeError(f"phase 1 best recall {best}")
            if rank == 0:
                print(f"multiproc_dryrun: phase 1 — mesh {mesh.shape}, all_reduce={float(t):.0f} "
                      f"(expected {expect:.0f}), all_gather ok, sharded forward ok, "
                      "sharded checkpoint written", flush=True)
        else:
            resumed, _ = _make_trainer(mesh, workdir, "ck", epochs=4).fit(resume=True)
            full, _ = _make_trainer(mesh, workdir, "ck_full", epochs=4).fit()
            for k in resumed:
                np.testing.assert_allclose(resumed[k].cpu().numpy(), full[k].cpu().numpy(),
                                           rtol=1e-5, atol=1e-7, err_msg=k)
            if rank == 0:
                print("multiproc_dryrun: phase 2 — resumed across processes; params match "
                      "the uninterrupted run", flush=True)
            mesh = create_mesh(MeshSpec(data=1, model=nprocs))
            _halo_check(mesh, os.path.join(workdir, "halo_mp.json"), rank,
                        os.path.join(workdir, "halo_mp"))
    finally:
        distributed.shutdown()


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _launch(phase: str, n: int, workdir: str, device: str, timeout_s: float):
    """Start ``n`` worker processes as ranks of one world; their exit codes
    (None for one that outlived ``timeout_s`` and was killed)."""
    port = _free_port()
    procs = []
    for rank in range(n):
        env = dict(os.environ, MASTER_ADDR="127.0.0.1", MASTER_PORT=str(port), RANK=str(rank),
                   WORLD_SIZE=str(n), LOCAL_RANK=str(rank), LOCAL_WORLD_SIZE=str(n))
        procs.append(subprocess.Popen(
            [sys.executable, "-m", MODULE, str(n), "--worker", str(rank), "--phase", phase,
             "--workdir", workdir, "--device", device], cwd=REPO, env=env))
    codes = []
    for p in procs:
        try:
            codes.append(p.wait(timeout=timeout_s))
        except subprocess.TimeoutExpired:
            codes.append(None)
    for p in procs:
        if p.poll() is None:
            p.kill()
            p.wait()
    return codes


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("nprocs", type=int, nargs="?", default=2)
    ap.add_argument("--device", type=str, default="cuda", choices=["cuda", "cpu"])
    ap.add_argument("--timeout", type=float, default=600.0,
                    help="Seconds a phase's workers may take.")
    ap.add_argument("--worker", type=int, default=None, help=argparse.SUPPRESS)
    ap.add_argument("--phase", type=str, default="1", help=argparse.SUPPRESS)
    ap.add_argument("--workdir", type=str, default=None, help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    if args.worker is not None:
        worker(args.nprocs, args.worker, args.phase, args.workdir, args.device)
        return 0

    import torch

    if args.device == "cuda":
        have = torch.cuda.device_count() if torch.cuda.is_available() else 0
        if have < args.nprocs:
            raise RuntimeError(f"CUDA is not available on {args.nprocs} cards (found {have}): "
                               "--device cuda needs one card per rank; --device cpu runs gloo")
        from gcn_recommendation_tpu_torch.utils.timing import device_line

        print(device_line(torch.device("cuda")), flush=True)
    else:
        print("device: cpu (gloo)", flush=True)
    workdir = tempfile.mkdtemp(prefix="gcnrec_mp_")
    for phase, n in (("1", args.nprocs), ("2", args.nprocs), ("halo_single", 1)):
        codes = _launch(phase, n, workdir, args.device, args.timeout)
        if any(c != 0 for c in codes):
            print(f"multiproc_dryrun FAILED (phase {phase}): exit codes {codes}", flush=True)
            return 1
    with open(os.path.join(workdir, "halo_mp.json")) as f:
        mp = json.load(f)
    with open(os.path.join(workdir, "halo_single.json")) as f:
        single = json.load(f)
    for key in HALO_KEYS:
        if abs(mp[key] - single[key]) > 1e-5 + 1e-4 * abs(single[key]):
            print(f"multiproc_dryrun FAILED: halo {key} mismatch across the process boundary: "
                  f"{args.nprocs}-proc {mp[key]!r} vs 1-proc {single[key]!r}", flush=True)
            return 1
    print(f"halo process-boundary equality: loss {mp['avg_loss']:.6f} recall {mp['recall']:.6f} "
          f"({args.nprocs} processes == 1 process)", flush=True)
    print("multiproc_dryrun PASSED", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
