"""Checkpoints with ``torch.save``: params alone, or the full training state.

The JAX package writes Orbax checkpoints that cannot be read without
JAX.  The port writes ``<dir>/<tag>.pt``, with tags ``best`` and ``last``
as the JAX trainer uses them:

* ``save_params`` — the params dict alone: one float tensor per key of
  the model's ``param_keys``, at logical shapes, on the CPU;
* ``save_state`` — the full training state: ``{"params", "optimizer"
  (``torch.optim.Adam.state_dict()`` over the model's trainable keys, at
  logical shapes), "epoch", "best_recall", "generator" (the sampling
  generator's state)}``.

Nothing here knows a model: the keys are whatever the caller's dict
holds, and the model checks them when it loads (``load_params``).

``load_params`` reads either kind, so serving reads what training
wrote.  Every file is written to a temporary name and then moved into
place with ``os.replace``: a crash leaves the old checkpoint or the new
one, never a torn file.

Multi-process runs (``parallel/``).  Checkpoints stay logical: the
sharded trainers gather the unpadded tables and Adam moments, rank 0
writes, and every rank waits at a barrier before it goes on, so any rank
may read the file next.  A checkpoint of one mesh resumes on another.
Beside each training state, ``<path>.layout.json`` records
``{"layout": "logical", "process_count": world}``; ``load_state`` refuses,
with a message, a checkpoint whose sidecar names another layout.
"""

from __future__ import annotations

import json
import os
from typing import Any, Dict, Optional

import torch
import torch.distributed as dist

from gcn_recommendation_tpu_torch.core.device import DeviceLike, resolve_device


def checkpoint_path(ckpt_dir: str, tag: str = "best") -> str:
    return os.path.join(ckpt_dir, f"{tag}.pt")


def _cpu(params: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    return {k: v.detach().cpu().contiguous() for k, v in params.items()}


def is_multiprocess() -> bool:
    """True in a run of more than one process (``core/distributed.py``)."""
    return dist.is_initialized() and dist.get_world_size() > 1


def _writes() -> bool:
    """Only rank 0 writes files."""
    return not dist.is_initialized() or dist.get_rank() == 0


def _barrier() -> None:
    if is_multiprocess():
        from gcn_recommendation_tpu_torch.core.distributed import barrier

        barrier()


def _atomic_save(obj, ckpt_dir: str, tag: str) -> str:
    os.makedirs(ckpt_dir, exist_ok=True)
    path = checkpoint_path(ckpt_dir, tag)
    tmp = path + ".tmp"
    torch.save(obj, tmp)
    os.replace(tmp, path)
    return path


def _layout_sidecar(path: str) -> str:
    return path + ".layout.json"


def _write_layout(path: str) -> None:
    meta = {
        "layout": "logical",
        "process_count": dist.get_world_size() if dist.is_initialized() else 1,
    }
    sidecar = _layout_sidecar(path)
    tmp = sidecar + ".tmp"
    with open(tmp, "w") as f:
        json.dump(meta, f)
    os.replace(tmp, sidecar)


def _check_layout(path: str) -> None:
    sidecar = _layout_sidecar(path)
    if not os.path.exists(sidecar):
        return  # a checkpoint from before the sidecar: logical
    try:
        with open(sidecar) as f:
            meta = json.load(f)
    except (OSError, ValueError):
        return
    if meta.get("layout") != "logical":
        world = dist.get_world_size() if dist.is_initialized() else 1
        raise RuntimeError(
            f"checkpoint at {path} was written in {meta.get('layout')!r} "
            f"layout (process_count={meta.get('process_count')}) but this "
            f"run is 'logical' (process_count={world}): "
            "sharded checkpoints store padded/sharded shapes while "
            "this port stores logical shapes — restore it with a "
            "run of the same mode (or convert via a single-process "
            "save/load roundtrip)."
        )


def save_params(ckpt_dir: str, params: Dict[str, torch.Tensor], tag: str = "best") -> str:
    """Write ``params`` (moved to the CPU) atomically; returns the path."""
    return _atomic_save(_cpu(params), ckpt_dir, tag)


def save_state(
    ckpt_dir: str,
    tag: str,
    params: Dict[str, torch.Tensor],
    optimizer_state: Dict[str, Any],
    epoch: int,
    best_recall: float,
    generator_state: torch.Tensor,
) -> str:
    """Write the full training state atomically, with its layout
    sidecar; returns the path.  In a multi-process run rank 0 writes
    (every rank passes the same logical state) and all ranks wait for it."""
    path = checkpoint_path(ckpt_dir, tag)
    if _writes():
        state = {
            "params": _cpu(params),
            "optimizer": optimizer_state,
            "epoch": int(epoch),
            "best_recall": float(best_recall),
            "generator": generator_state.cpu(),
        }
        _atomic_save(state, ckpt_dir, tag)
        _write_layout(path)
    _barrier()
    return path


def load_state(ckpt_dir: str, tag: str = "last") -> Optional[Dict[str, Any]]:
    """The state ``save_state`` wrote (tensors on the CPU), or None when no
    checkpoint exists."""
    path = checkpoint_path(ckpt_dir, tag)
    if not os.path.exists(path):
        return None
    _check_layout(path)
    state = torch.load(path, map_location="cpu", weights_only=True)
    if "params" not in state:
        raise ValueError(f"'{path}' holds params only, not a training state")
    return state


def load_params(
    ckpt_dir: str, tag: str = "best", device: DeviceLike = None
) -> Optional[Dict[str, torch.Tensor]]:
    """The params dict on ``device`` from a params-only or a full-state
    checkpoint, or None when no checkpoint exists."""
    dev = resolve_device(device)
    path = checkpoint_path(ckpt_dir, tag)
    if not os.path.exists(path):
        return None
    state = torch.load(path, map_location="cpu", weights_only=True)
    params = state.get("params", state)
    return {k: v.to(dev) for k, v in params.items()}
