"""LightGCN (PyTorch port of ``gcn_recommendation_tpu/models/lightgcn.py``).

Reference semantics (models/lightgcn.py of the reference): three
Xavier-uniform tables (users / items / brands); forward concatenates them,
runs K propagations, averages the K+1 layer outputs and splits the block
back.  The layer mean is a running f32 sum, as in the JAX package.
"""

from __future__ import annotations

from typing import Dict, Optional

import numpy as np
import torch
from torch import nn

from gcn_recommendation_tpu_torch.core.device import DeviceLike, resolve_device
from gcn_recommendation_tpu_torch.ops.spmm import propagate

PARAM_KEYS = ("user_embedding", "item_embedding", "brand_embedding")


def xavier_uniform(
    shape, generator: Optional[torch.Generator] = None, dtype=torch.float32,
    device: DeviceLike = "cpu",
) -> torch.Tensor:
    """Xavier/Glorot uniform, as ``torch.nn.init.xavier_uniform_``
    (bound = sqrt(6 / (fan_in + fan_out)) for a 2-D table), drawn from
    ``generator``."""
    fan_in, fan_out = shape[0], shape[1]
    bound = float(np.sqrt(6.0 / (fan_in + fan_out)))
    out = torch.empty(shape, dtype=dtype, device=device)
    return out.uniform_(-bound, bound, generator=generator)


class LightGCN(nn.Module):
    """LightGCN over the users+items+brands graph."""

    name = "LightGCN"

    def __init__(
        self,
        num_users: int,
        num_items: int,
        num_brands: int,
        config,
        pretrained_item_emb: Optional[np.ndarray] = None,
        device: DeviceLike = None,
    ):
        super().__init__()
        self.device = resolve_device(device)
        self.num_users = num_users
        self.num_items = num_items
        self.num_brands = num_brands
        self.embedding_dim = config.embedding_dim
        self.n_layers = config.n_layers
        self.param_dtype = getattr(torch, config.param_dtype)
        self.compute_dtype = getattr(torch, config.compute_dtype)
        if pretrained_item_emb is not None and (
            pretrained_item_emb.shape[1] != self.embedding_dim
        ):
            raise ValueError(
                f"Pretrained embedding dim ({pretrained_item_emb.shape[1]}) "
                f"does not match model embedding dim ({self.embedding_dim})."
            )
        self.pretrained_item_emb = pretrained_item_emb
        d = self.embedding_dim
        for key, rows in zip(PARAM_KEYS, (num_users, num_items, num_brands)):
            self.register_parameter(
                key,
                nn.Parameter(
                    torch.zeros((rows, d), dtype=self.param_dtype, device=self.device)
                ),
            )

    def init(self, generator: Optional[torch.Generator] = None) -> Dict[str, torch.Tensor]:
        """Fill the tables (Xavier uniform, or the pretrained item matrix)
        from a CPU ``generator`` and return them as a params dict."""
        d = self.embedding_dim
        params = {
            "user_embedding": xavier_uniform((self.num_users, d), generator, self.param_dtype),
            "item_embedding": xavier_uniform((self.num_items, d), generator, self.param_dtype),
            "brand_embedding": xavier_uniform((self.num_brands, d), generator, self.param_dtype),
        }
        if self.pretrained_item_emb is not None:
            params["item_embedding"] = torch.as_tensor(
                np.asarray(self.pretrained_item_emb), dtype=self.param_dtype
            )
        self.load_params(params)
        return self.params()

    def params(self) -> Dict[str, torch.Tensor]:
        return {k: getattr(self, k).detach() for k in PARAM_KEYS}

    @torch.no_grad()
    def load_params(self, params: Dict[str, torch.Tensor]) -> None:
        """Copy a params dict (``user_embedding`` / ``item_embedding`` /
        ``brand_embedding``, logical shapes) into the tables."""
        for key in PARAM_KEYS:
            if key not in params:
                raise KeyError(f"params lack {key!r}")
            table = getattr(self, key)
            src = torch.as_tensor(params[key])
            if tuple(src.shape) != tuple(table.shape):
                raise ValueError(
                    f"{key}: shape {tuple(src.shape)} != {tuple(table.shape)}"
                )
            table.copy_(src)

    def forward(self, graph, path: str = "ell"):
        """Returns (final_user, final_item, final_brand, user0, item0).
        ``graph`` is a DeviceGraph or a TiledDeviceGraph; gradients flow
        to the tables through either (each propagation's backward is the
        same product on the cotangent)."""
        num_nodes = self.num_users + self.num_items + self.num_brands
        ego = torch.cat(
            [self.user_embedding, self.item_embedding, self.brand_embedding], dim=0
        )
        # propagate in compute dtype, accumulate the layer mean in f32
        acc = ego.float()
        x = ego.to(self.compute_dtype)
        for _ in range(self.n_layers):
            x = propagate(x, graph, num_nodes, path=path)
            acc = acc + x.float()
        final = (acc / (self.n_layers + 1)).to(ego.dtype)
        return self._split_final(final)

    def _split_final(self, final: torch.Tensor):
        u, i = self.num_users, self.num_items
        return (
            final[:u],
            final[u : u + i],
            final[u + i : u + i + self.num_brands],
            self.user_embedding[:u],
            self.item_embedding[:i],
        )
