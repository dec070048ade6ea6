"""Process groups of a multi-device run: one process per device.

PyTorch counterpart of ``gcn_recommendation_tpu/core/distributed.py``.
JAX drives every device of a host from one controller and needs
``jax.distributed`` only across hosts.  The port runs one process per
device, started by ``torchrun`` (or by ``core.mesh.run_local_world``,
which spawns the ranks of one machine over a ``file://`` store):

* ``initialize()`` joins the run's process group and returns the rank's
  device: ``cuda:LOCAL_RANK`` over NCCL, or the CPU over gloo when the
  caller asked for ``device="cpu"``.  Under ``torchrun`` it reads
  ``RANK`` / ``WORLD_SIZE`` / ``LOCAL_RANK`` / ``MASTER_ADDR``; without
  them it starts a world of one, which only a ``1,1`` mesh may ask for.
* ``auto_mesh_spec()`` puts the local GPUs on the model axis (NVLink
  carries the per-layer all-gathers) and the nodes on the data axis (only
  the gradient all-reduce crosses nodes), as the JAX package puts local
  chips on the model axis.

A mesh run on ``cuda`` uses NCCL and never drops to gloo or the CPU.
"""

from __future__ import annotations

import datetime
import os
import sys
from typing import Optional

import torch
import torch.distributed as dist

from gcn_recommendation_tpu_torch.core.device import DeviceLike, resolve_device
from gcn_recommendation_tpu_torch.core.mesh import MeshSpec

_TORCHRUN_ENV = ("RANK", "WORLD_SIZE", "LOCAL_RANK", "MASTER_ADDR")
# a rank that dies leaves the others in a collective: they give up after this
DEFAULT_TIMEOUT_S = 600.0

_device: Optional[torch.device] = None


def _launched_by_torchrun() -> bool:
    return all(v in os.environ for v in _TORCHRUN_ENV)


def initialize(
    device: DeviceLike = None,
    *,
    mesh_spec: Optional[MeshSpec] = None,
    rank: Optional[int] = None,
    world_size: Optional[int] = None,
    init_method: Optional[str] = None,
    timeout_s: float = DEFAULT_TIMEOUT_S,
) -> torch.device:
    """Join (or start) this run's process group; returns the rank's device.

    ``rank`` / ``world_size`` / ``init_method`` name the rendezvous
    explicitly (the spawn helper passes a ``file://`` store); else
    ``torchrun``'s environment is read; else a world of one starts, which
    raises when ``mesh_spec`` asks for more than one device.  Safe to call
    again: a joined rank gets its device back.
    """
    global _device
    if dist.is_initialized():
        if _device is None:
            raise RuntimeError("a process group was started outside core.distributed")
        return _device
    dev = resolve_device(device)
    local_rank = 0
    if rank is not None:
        local_rank = rank
        kwargs = dict(init_method=init_method, rank=rank, world_size=world_size)
    elif _launched_by_torchrun():
        local_rank = int(os.environ["LOCAL_RANK"])
        kwargs = dict(init_method="env://")
    else:
        if mesh_spec is not None and mesh_spec.size != 1:
            raise ValueError(
                f"mesh {mesh_spec.shape} needs {mesh_spec.size} processes: launch one per "
                f"device with torchrun --nproc_per_node {mesh_spec.size} "
                "-m gcn_recommendation_tpu_torch ..."
            )
        kwargs = dict(store=dist.HashStore(), rank=0, world_size=1)
    if dev.type == "cuda":
        dev = torch.device("cuda", local_rank)
        torch.cuda.set_device(dev)
        backend = "nccl"
    else:
        backend = "gloo"
    dist.init_process_group(
        backend, timeout=datetime.timedelta(seconds=timeout_s), **kwargs
    )
    _device = dev
    return dev


def get_rank() -> int:
    """This process's rank in the run (0 when no group exists)."""
    return dist.get_rank() if dist.is_initialized() else 0


def get_world_size() -> int:
    return dist.get_world_size() if dist.is_initialized() else 1


def barrier() -> None:
    """Wait for every rank (nothing to wait for in a single process)."""
    if dist.is_initialized() and dist.get_world_size() > 1:
        if dist.get_backend() == "nccl":
            dist.barrier(device_ids=[torch.cuda.current_device()])
        else:
            dist.barrier()


def shutdown() -> None:
    """Leave the process group (a no-op when none was started)."""
    global _device
    if dist.is_initialized():
        dist.destroy_process_group()
    _device = None


def auto_mesh_spec(model_parallel: Optional[int] = None) -> MeshSpec:
    """('data', 'model') split of the run's ranks: the model axis spans the
    GPUs of one node (``LOCAL_WORLD_SIZE`` under torchrun, else the visible
    CUDA devices), the data axis spans the nodes."""
    n = get_world_size()
    if model_parallel is None:
        model_parallel = int(os.environ.get("LOCAL_WORLD_SIZE", 0)) or max(
            1, torch.cuda.device_count())
    model_parallel = max(1, min(model_parallel, n))
    while n % model_parallel:
        model_parallel -= 1
    return MeshSpec(data=n // model_parallel, model=model_parallel)


def runtime_report() -> dict:
    """This rank's place in the run and the top-level packages it has
    loaded (what a launcher checks of a rank's environment)."""
    return {
        "rank": get_rank(),
        "world_size": get_world_size(),
        "backend": dist.get_backend() if dist.is_initialized() else None,
        "device": str(_device) if _device is not None else None,
        "packages": sorted({name.split(".")[0] for name in sys.modules}),
    }
