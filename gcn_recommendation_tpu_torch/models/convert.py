"""Weights carried across from the JAX package.

A JAX LightGCN params dict, turned into numpy arrays by the caller
(``{k: np.asarray(v) for k, v in params.items()}``), becomes a dict of
tensors that ``LightGCN.load_params`` takes.  The keys are those of the
JAX ``LightGCN.init``; the shapes are logical (no row padding).
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from gcn_recommendation_tpu_torch.core.device import DeviceLike, resolve_device
from gcn_recommendation_tpu_torch.models.lightgcn import PARAM_KEYS


def params_from_jax(
    arrays: Dict[str, np.ndarray], device: DeviceLike = None
) -> Dict[str, torch.Tensor]:
    """numpy copies of the three JAX tables -> float32 tensors on ``device``."""
    dev = resolve_device(device)
    missing = [k for k in PARAM_KEYS if k not in arrays]
    if missing:
        raise KeyError(f"JAX params lack {missing}")
    return {
        k: torch.from_numpy(np.array(arrays[k], dtype=np.float32)).to(dev)
        for k in PARAM_KEYS
    }
