"""The ('data', 'model') device mesh of a multi-device run.

PyTorch counterpart of ``gcn_recommendation_tpu/core/mesh.py``: the same
two axes,

* ``data`` splits the BPR batch and the evaluation users (data
  parallelism; gradients are averaged over it),
* ``model`` row-splits the embedding tables, their Adam moments, the ELL
  bucket rows and the item catalog (tensor parallelism for a model whose
  parameters are the tables).

JAX builds its mesh over the devices of one controller.  Here every rank
is a process with one device (``core/distributed.py``), and the mesh is a
``torch.distributed.device_mesh.DeviceMesh`` over the run's ranks in row-
major order, with one process group per axis.

``run_local_world`` is the counterpart of ``local_mesh_for_testing``: it
spawns the ranks of a small world on this machine over a ``file://``
store (gloo on the CPU, NCCL on cards), runs a function of this package
on every rank and returns rank 0's result.
"""

from __future__ import annotations

import dataclasses
import os
import pickle
import tempfile
from typing import Optional

import torch

from gcn_recommendation_tpu_torch.core.device import DeviceLike, resolve_device

DATA_AXIS = "data"
MODEL_AXIS = "model"


@dataclasses.dataclass(frozen=True)
class MeshSpec:
    """Logical mesh shape.  ``data * model`` must equal the world size."""

    data: int = 1
    model: int = 1

    @property
    def shape(self):
        return (self.data, self.model)

    @property
    def size(self) -> int:
        return self.data * self.model


class Mesh:
    """This rank's view of the ('data', 'model') mesh: the process group of
    each axis, the rank's coordinate along it, and the rank's device."""

    def __init__(self, spec: MeshSpec, device: torch.device, device_mesh):
        self.spec = spec
        self.device = device
        self.device_mesh = device_mesh

    @property
    def shape(self):
        """``{'data': d, 'model': m}``, as a JAX mesh reports it."""
        return {DATA_AXIS: self.spec.data, MODEL_AXIS: self.spec.model}

    @property
    def size(self) -> int:
        return self.spec.size

    def group(self, axis: str):
        """The process group of the ranks that differ only along ``axis``."""
        return self.device_mesh.get_group(axis)

    def coordinate(self, axis: str) -> int:
        """This rank's index along ``axis``."""
        return self.device_mesh.get_local_rank(axis)

    def __repr__(self):
        return f"Mesh({self.shape}, device={self.device})"


def create_mesh(spec: Optional[MeshSpec] = None) -> Mesh:
    """Build the 2-D ('data', 'model') mesh over this run's ranks (the
    process group of ``core.distributed.initialize``).  With ``spec=None``
    every rank goes on the data axis."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh

    from gcn_recommendation_tpu_torch.core import distributed

    if not dist.is_initialized():
        raise RuntimeError("create_mesh needs core.distributed.initialize() first")
    world = dist.get_world_size()
    if spec is None:
        spec = MeshSpec(data=world, model=1)
    n = spec.data * spec.model
    if n != world:
        raise ValueError(f"mesh {spec.shape} needs {n} devices, have {world}")
    device = distributed.initialize()
    device_mesh = init_device_mesh(
        device.type, spec.shape, mesh_dim_names=(DATA_AXIS, MODEL_AXIS)
    )
    return Mesh(spec, device, device_mesh)


def pad_to_multiple(n: int, m: int) -> int:
    """Round ``n`` up to a multiple of ``m`` (for even sharding / tiling)."""
    return ((n + m - 1) // m) * m


def _local_rank_main(rank, world, store, out, device, timeout_s, fn, args):
    torch.set_num_threads(1)  # several worlds may share this machine's cores
    from gcn_recommendation_tpu_torch.core import distributed

    distributed.initialize(device, rank=rank, world_size=world,
                           init_method=f"file://{store}", timeout_s=timeout_s)
    try:
        result = fn(*args)
        if rank == 0:
            with open(out, "wb") as f:
                pickle.dump(result, f)
    finally:
        distributed.shutdown()


def run_local_world(n_ranks: int, fn, *args, device: DeviceLike = None,
                    timeout_s: float = 600.0):
    """Run ``fn(*args)`` on every rank of a world of ``n_ranks`` processes
    on this machine and return rank 0's result.

    Each rank joins over a ``file://`` store in a fresh temporary
    directory (worlds started side by side never share a port), on
    ``cuda:rank`` over NCCL or, when asked with ``device="cpu"``, on the CPU
    over gloo (``core/device.py``: no CUDA and no ``device`` raises), with
    one thread for the CPU's own ops.  ``fn`` must be a module-level
    function of this package, so a rank imports nothing else; its result
    must pickle (numpy arrays, floats).  When a rank fails, the others are
    stopped and the error is raised here; a collective that waits longer
    than ``timeout_s`` fails its rank.
    """
    import torch.multiprocessing as mp

    device = resolve_device(device).type
    with tempfile.TemporaryDirectory(prefix="gcn_world_") as tmp:
        store = os.path.join(tmp, "store")
        out = os.path.join(tmp, "rank0.pkl")
        mp.start_processes(
            _local_rank_main, args=(n_ranks, store, out, device, timeout_s, fn, args),
            nprocs=n_ranks, join=True, start_method="spawn",
        )
        with open(out, "rb") as f:
            return pickle.load(f)
