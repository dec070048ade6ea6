"""LightGCN_Fusion: the content-embedding fusion variant (PyTorch port of
``gcn_recommendation_tpu/models/lightgcn_fusion.py``).

Reference semantics (models/lightgcn_fusion.py of the reference):

* requires pretrained content embeddings, and raises without them;
* learnable ID tables for users / items / brands; the *frozen* content
  matrix is fused with the item ID table before propagation,
  ``LeakyReLU(Linear(concat(id_emb, content_emb)))``;
* the same propagation, layer mean and split as LightGCN;
* the layer-0 item output (the L2 term) is the *ID* table.

The parameter names and layouts are the JAX package's, so its checkpoints
map key for key: ``fusion_kernel`` is ``[d + content_dim, d]`` (the
transpose of an ``nn.Linear`` weight), ``fusion_bias`` ``[d]``.  The
content matrix ``item_content_embedding`` is a buffer: it is in
``params()`` and in checkpoints, never in the optimizer, takes no
gradient, and rides the item table's row padding.
"""

from __future__ import annotations

from typing import Dict, Optional

import numpy as np
import torch

from gcn_recommendation_tpu_torch.core.device import DeviceLike
from gcn_recommendation_tpu_torch.models.lightgcn import LightGCN, xavier_uniform


class LightGCN_Fusion(LightGCN):
    name = "LightGCN_Fusion"
    param_keys = LightGCN.param_keys + (
        "fusion_kernel", "fusion_bias", "item_content_embedding",
    )
    frozen_keys = ("item_content_embedding",)
    needs_content = True
    # the dense self-check propagates the ID table, not the fused block
    has_debug_diagnostics = False

    def __init__(
        self,
        num_users: int,
        num_items: int,
        num_brands: int,
        config,
        pretrained_item_emb: Optional[np.ndarray] = None,
        device: DeviceLike = None,
    ):
        if pretrained_item_emb is None:
            raise ValueError("LightGCN_Fusion model requires pretrained item embeddings.")
        # the content matrix is not the item table's init: Fusion keeps a
        # random ID table unless fusion_id_init asks otherwise
        super().__init__(num_users, num_items, num_brands, config, None, device=device)
        content = np.asarray(pretrained_item_emb, dtype=np.float32)
        if content.ndim != 2 or content.shape[0] != num_items:
            raise ValueError(
                f"content embeddings {content.shape} do not match {num_items} items"
            )
        self.content_dim = int(content.shape[1])
        # ID table initialized from the content matrix and still trained
        self.fusion_id_init = bool(getattr(config, "fusion_id_init", False))
        if self.fusion_id_init and self.content_dim != self.embedding_dim:
            raise ValueError(
                f"fusion_id_init needs pretrained dim ({self.content_dim}) "
                f"== embedding dim ({self.embedding_dim})"
            )
        d = self.embedding_dim
        self._set_tensor(
            "fusion_kernel", torch.zeros((d + self.content_dim, d), dtype=self.param_dtype)
        )
        self._set_tensor("fusion_bias", torch.zeros((d,), dtype=self.param_dtype))
        self._set_tensor("item_content_embedding", torch.from_numpy(content.copy()))

    def _table_pad_spec(self):
        # the content matrix is row-aligned with the item ID table
        spec = super()._table_pad_spec()
        spec["item_content_embedding"] = (self.num_items, self.num_items_pad)
        return spec

    def _draw_params(self, generator: Optional[torch.Generator]) -> Dict[str, torch.Tensor]:
        """Xavier tables (the item ID table is the content matrix under
        ``fusion_id_init``), ``fusion_kernel`` Xavier over ``(fan_in, d)``,
        ``fusion_bias`` uniform in ``+-1/sqrt(fan_in)`` (the default of
        ``nn.Linear``, which the reference keeps); the content matrix as
        the model holds it."""
        d = self.embedding_dim
        fan_in = d + self.content_dim
        params = super()._draw_params(generator)
        content = self.item_content_embedding.detach()[: self.num_items].cpu()
        if self.fusion_id_init:
            params["item_embedding"] = content.to(self.param_dtype)
        params["fusion_kernel"] = xavier_uniform((fan_in, d), generator, self.param_dtype)
        bound = 1.0 / float(np.sqrt(fan_in))
        params["fusion_bias"] = torch.empty((d,), dtype=self.param_dtype).uniform_(
            -bound, bound, generator=generator
        )
        params["item_content_embedding"] = content
        return params

    def _initial_tables(self):
        """Fuse the ID table with the frozen content matrix, row by row.
        The product runs in full f32 (TF32 is off, ``core/device.py``): it
        sets the item features of the whole propagation.  Its result is
        cast to the table dtype before the bias is added."""
        item = self.item_embedding
        combined = torch.cat([item, self.item_content_embedding.to(item.dtype)], dim=1)
        fused = torch.matmul(combined.float(), self.fusion_kernel.float()).to(item.dtype)
        fused = torch.nn.functional.leaky_relu(fused + self.fusion_bias, negative_slope=0.01)
        return self.user_embedding, fused, self.brand_embedding
