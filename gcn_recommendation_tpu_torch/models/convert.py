"""Weights and optimizer state carried across from the JAX package.

The one place that turns JAX parameters and optax state, given as numpy
arrays by the caller (``{k: np.asarray(v) for k, v in params.items()}``),
into the port's, for both model families.  The keys are those of the JAX
model's ``init`` and of the port model's ``param_keys`` (the same names
and layouts, ``fusion_kernel`` as ``[fan_in, d]`` included), so every key
is carried across and a missing or an unknown key raises.  Shapes come
out logical: a row-padded JAX table is sliced back, and
``load_params`` / ``load_adam_state_from_jax`` pad again for a padded
port model.

The Adam state of ``optax.adam`` (its ``ScaleByAdamState``: ``count``, and
``mu`` / ``nu`` dicts keyed like the params) becomes the state of a
``torch.optim.Adam`` over the model's trainable parameters: the same
moments and step count, so the next update is the same.  optax also
keeps moments for the frozen content matrix of ``LightGCN_Fusion`` (all
zeros: its gradient is stopped); they have no place in the port's
optimizer and are dropped.
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from gcn_recommendation_tpu_torch.core.device import DeviceLike, resolve_device
from gcn_recommendation_tpu_torch.models.lightgcn import LightGCN


def _check_keys(what: str, have, want) -> None:
    missing = [k for k in want if k not in have]
    if missing:
        raise KeyError(f"{what} lack {missing}")
    unknown = [k for k in have if k not in want]
    if unknown:
        raise KeyError(f"{what} hold unknown keys {unknown}")


def params_from_jax(
    arrays: Dict[str, np.ndarray], model: LightGCN, device: DeviceLike = None
) -> Dict[str, torch.Tensor]:
    """numpy copies of a JAX model's params -> float32 tensors on
    ``device``, one per key of ``model.param_keys``, at logical shapes."""
    dev = resolve_device(device)
    keys = model.param_keys
    _check_keys("JAX params", arrays, keys)
    params = {k: torch.from_numpy(np.array(arrays[k], dtype=np.float32)).to(dev) for k in keys}
    return model.unpad_state_tree(params)


def load_adam_state_from_jax(
    optimizer: torch.optim.Adam,
    model: LightGCN,
    count,
    mu: Dict[str, np.ndarray],
    nu: Dict[str, np.ndarray],
) -> None:
    """Set ``optimizer``'s state for each trainable parameter of ``model``
    from optax's Adam state given as numpy (``count`` a scalar)."""
    for name, tree in (("mu", mu), ("nu", nu)):
        _check_keys(f"optax {name}", tree, model.param_keys)
        for k in model.frozen_keys:
            if np.any(np.asarray(tree[k])):
                raise ValueError(f"optax {name}[{k!r}] is not zero: {k} is frozen in the port")
    for key in model.trainable_keys:
        p = getattr(model, key)
        moments = model.pad_state_tree({
            "exp_avg": {key: torch.from_numpy(np.array(mu[key], dtype=np.float32))},
            "exp_avg_sq": {key: torch.from_numpy(np.array(nu[key], dtype=np.float32))},
        })
        optimizer.state[p] = {
            "step": torch.tensor(float(np.asarray(count)), dtype=torch.float32),
            "exp_avg": moments["exp_avg"][key].to(p.device),
            "exp_avg_sq": moments["exp_avg_sq"][key].to(p.device),
        }
