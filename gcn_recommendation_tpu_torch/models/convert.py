"""Weights and optimizer state carried across from the JAX package.

A JAX LightGCN params dict, turned into numpy arrays by the caller
(``{k: np.asarray(v) for k, v in params.items()}``), becomes a dict of
tensors that ``LightGCN.load_params`` takes.  The keys are those of the
JAX ``LightGCN.init``; the shapes are logical (no row padding).  The
Adam state of ``optax.adam`` (its ``ScaleByAdamState``: ``count``, and
``mu`` / ``nu`` dicts keyed like the params) becomes the state of a
``torch.optim.Adam`` over the model's tables: the same moments and step
count, so the next update is the same.
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


def load_adam_state_from_jax(
    optimizer: torch.optim.Adam,
    model,
    count,
    mu: Dict[str, np.ndarray],
    nu: Dict[str, np.ndarray],
) -> None:
    """Set ``optimizer``'s state for each of ``model``'s tables from
    optax's Adam state given as numpy (``count`` a scalar)."""
    for key in PARAM_KEYS:
        p = getattr(model, key)
        optimizer.state[p] = {
            "step": torch.tensor(float(np.asarray(count)), dtype=torch.float32),
            "exp_avg": torch.from_numpy(np.array(mu[key], dtype=np.float32)).to(p.device),
            "exp_avg_sq": torch.from_numpy(np.array(nu[key], dtype=np.float32)).to(p.device),
        }
