"""Minimal model checkpoints: the params dict with ``torch.save``.

The JAX package writes Orbax checkpoints (params, Adam state, epoch,
best metric, RNG key) that cannot be read without JAX.  This slice
serves, so a checkpoint here carries the params only: a dict of
``user_embedding`` / ``item_embedding`` / ``brand_embedding`` float
tensors at logical (unpadded) shapes, stored on the CPU.  A checkpoint
lives at ``<dir>/<tag>.pt``; ``best`` is the tag serving reads.
"""

from __future__ import annotations

import os
from typing import Dict, Optional

import torch

from gcn_recommendation_tpu_torch.core.device import DeviceLike, resolve_device


def checkpoint_path(ckpt_dir: str, tag: str = "best") -> str:
    return os.path.join(ckpt_dir, f"{tag}.pt")


def save_params(ckpt_dir: str, params: Dict[str, torch.Tensor], tag: str = "best") -> str:
    """Write ``params`` (moved to the CPU) atomically; returns the path."""
    os.makedirs(ckpt_dir, exist_ok=True)
    path = checkpoint_path(ckpt_dir, tag)
    tmp = path + ".tmp"
    torch.save({k: v.detach().cpu().contiguous() for k, v in params.items()}, tmp)
    os.replace(tmp, path)
    return path


def load_params(
    ckpt_dir: str, tag: str = "best", device: DeviceLike = None
) -> Optional[Dict[str, torch.Tensor]]:
    """The params dict on ``device``, or None when no checkpoint exists."""
    dev = resolve_device(device)
    path = checkpoint_path(ckpt_dir, tag)
    if not os.path.exists(path):
        return None
    state = torch.load(path, map_location="cpu", weights_only=True)
    return {k: v.to(dev) for k, v in state.items()}
