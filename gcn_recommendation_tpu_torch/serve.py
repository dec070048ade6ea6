"""Retrieval serving: precomputed embeddings -> top-k recommendations.

PyTorch counterpart of ``gcn_recommendation_tpu/serve.py``:

* one propagation at load time (``Retriever.from_params``);
* ``recommend(user_ids, k)`` — masked full-catalog top-k per user batch,
  the user's train-seen items filtered exactly like evaluation;
* optional int8 item table (``quantize=True``): the catalog quantized by
  ``ops.quant.quantize_rows_int8`` (the CUDA kernel on the card) and
  padded for the int8 product once, here; scores as int8 x int8 -> int32,
  each request's users quantized by the same kernel's nearest mode into
  buffers kept per request shape;
* optional ``mesh`` (``core/mesh.py``): the catalog is padded to
  ``n_model * 8`` rows and row-sharded over the model axis, and every
  request scores through the distributed local top-k and all-gather merge
  (``parallel/spmd.py``).  With ``quantize`` each rank quantizes only its
  own shard, with the kernel's row offset at the shard's first row, so the
  sharded int8 catalog is bit-equal to the single-device one.  Every rank
  of the mesh makes the same calls in the same order (they meet in
  collectives); the serving daemon does that with a leader and followers
  (``server.py``).

A ``Retriever`` serves one caller at a time: its int8 user buffers are
reused from request to request (in stream order, so enqueueing several
requests before fetching any is fine).  The serving daemon calls it from
its one dispatcher thread.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from gcn_recommendation_tpu_torch.data.loader import DataBundle
from gcn_recommendation_tpu_torch.data.sampler import (
    membership_arrays,
    padded_filter_rows,
)
from gcn_recommendation_tpu_torch.ops.quant import (
    alloc_user_buffers,
    pad_int8_table,
    quantize_rows_int8,
    quantized_topk_scores,
)
from gcn_recommendation_tpu_torch.ops.spmm import to_device_graph_auto
from gcn_recommendation_tpu_torch.ops.topk import masked_topk_scores


def _bucket_up(n: int, floor: int, mult: int = 4) -> int:
    """Smallest ``floor * mult**j >= n``: request shapes land on a small
    geometric ladder, as in the JAX package, so both pad alike."""
    b = floor
    while b < n:
        b *= mult
    return b


class Retriever:
    """Top-k recommendation over a trained model's final embeddings."""

    def __init__(
        self,
        user_emb: torch.Tensor,
        item_emb: torch.Tensor,
        bundle: DataBundle,
        quantize: bool = False,
        mesh=None,
    ):
        """``user_emb`` / ``item_emb`` live on the serving device; every
        request runs there.  ``mesh``: this rank's view of a ('data',
        'model') mesh; the catalog is then this rank's shard."""
        self.device = item_emb.device
        self.num_items = int(item_emb.shape[0])
        self.quantized = quantize
        self.mesh = mesh
        row_offset = 0
        if mesh is not None:
            from gcn_recommendation_tpu_torch.core.mesh import MODEL_AXIS
            from gcn_recommendation_tpu_torch.parallel.spmd import catalog_shard

            item_emb = catalog_shard(item_emb, mesh)
            row_offset = mesh.coordinate(MODEL_AXIS) * item_emb.shape[0]
        if quantize:
            item_q, self.item_scale = quantize_rows_int8(
                item_emb.contiguous(), row_offset=row_offset)
            # padded once for the int8 product, not at every request
            self.item_q = pad_int8_table(item_q)
            self.item_emb = None
            self._user_buffers = {}  # padded batch size -> (codes, scales)
        else:
            self.item_emb = item_emb
        self.user_emb = user_emb
        # seen-item filter: the user's train interactions
        f_ptr, f_items = membership_arrays(
            bundle.train.user_idx, bundle.train.item_idx, bundle.num_users
        )
        self._f_ptr, self._f_items = f_ptr, f_items
        self._deg = f_ptr[1:] - f_ptr[:-1]

    @classmethod
    @torch.no_grad()
    def from_params(cls, model, params, bundle: DataBundle, quantize: bool = False,
                    mesh=None):
        """Load ``params`` (logical or padded shapes) into ``model``,
        propagate once on the model's device (over the padded node space
        when the model is row-padded), and build a retriever from the
        final embeddings, which have logical rows.  With ``mesh`` every
        rank propagates alike and keeps its shard of the catalog."""
        model.load_params(params)
        graph = to_device_graph_auto(
            model.padded_graph(bundle.graph), compute_dtype=model.compute_dtype,
            embedding_dim=model.embedding_dim,
            # serving propagates once per load: no merge-skip views, which
            # would hold the hub matrix twice
            fuse_layers=False, device=model.device,
        )
        fu, fi, *_ = model(graph)
        return cls(fu, fi, bundle, quantize=quantize, mesh=mesh)

    def _filter_batch(self, users: np.ndarray, filter_seen: bool) -> torch.Tensor:
        """[B_pad, F] int64 padded seen-item lists at bucketed width, on
        the serving device (int32 ids from the host become int64 here,
        once: ``scatter_`` takes int64)."""
        b = len(users)
        if not filter_seen:
            filt = np.full((b, 1), self.num_items, np.int32)
        else:
            lens = self._deg[users]
            fmax = max(1, int(lens.max()) if b else 1)
            global_max = max(1, int(self._deg.max())) if len(self._deg) else 1
            fmax = min(_bucket_up(fmax, 8), global_max)
            filt = padded_filter_rows(
                self._f_ptr, self._f_items, users, fmax, self.num_items
            )
        return torch.from_numpy(filt.astype(np.int64)).to(self.device)

    @torch.no_grad()
    def _dispatch(self, user_ids, k: int, filter_seen: bool):
        """Enqueue one masked top-k; returns DEVICE tensors plus the true
        request size.  CUDA launches are asynchronous, so callers may
        enqueue many before fetching any result."""
        users = np.asarray(user_ids, dtype=np.int32)
        n_req = len(users)
        # pad the batch onto the shape ladder (repeat user 0; sliced off)
        b_pad = _bucket_up(max(n_req, 1), 8, 2)
        users_pad = np.zeros(b_pad, np.int64)
        users_pad[:n_req] = users
        filt = self._filter_batch(users_pad, filter_seen)
        u = self.user_emb.index_select(0, torch.from_numpy(users_pad).to(self.device))
        buffers = None
        if self.quantized:
            buffers = self._user_buffers.get(b_pad)
            if buffers is None:
                buffers = self._user_buffers[b_pad] = alloc_user_buffers(
                    b_pad, u.shape[1], self.device)
        if self.mesh is not None:
            from gcn_recommendation_tpu_torch.parallel.spmd import (
                sharded_quantized_topk_batch,
                sharded_topk_eval_batch,
            )

            if self.quantized:
                vals, idx = sharded_quantized_topk_batch(
                    self.mesh, u, self.item_q, self.item_scale, filt, k,
                    num_valid_items=self.num_items, user_buffers=buffers)
            else:
                vals, idx = sharded_topk_eval_batch(
                    self.mesh, u, self.item_emb, filt, k, num_valid_items=self.num_items)
        elif self.quantized:
            vals, idx = quantized_topk_scores(
                u, self.item_q, self.item_scale, filt, k, user_buffers=buffers)
        else:
            vals, idx = masked_topk_scores(u, self.item_emb, filt, k)
        return vals, idx, n_req

    def recommend(
        self, user_ids, k: int = 20, filter_seen: bool = True
    ) -> Tuple[np.ndarray, np.ndarray]:
        """Return (scores, item_ids), each [len(user_ids), k]."""
        vals, idx, n_req = self._dispatch(user_ids, k, filter_seen)
        return vals[:n_req].cpu().numpy(), idx[:n_req].cpu().numpy()

    def recommend_pipelined(self, requests, k: int = 20, filter_seen: bool = True):
        """Serve a list of independent requests, enqueueing every one
        before fetching any result.  Returns (scores, item_ids) pairs in
        request order."""
        inflight = [self._dispatch(u, k, filter_seen) for u in requests]
        return [
            (v[:n].cpu().numpy(), i[:n].cpu().numpy()) for v, i, n in inflight
        ]

    def recommend_many(self, requests, k: int = 20, filter_seen: bool = True):
        """Micro-batched serving: coalesce the requests into ONE batch,
        then split the results back per request."""
        sizes = [len(np.atleast_1d(u)) for u in requests]
        if not sizes:
            return []
        users = np.concatenate(
            [np.atleast_1d(np.asarray(u, np.int32)) for u in requests]
        )
        vals, idx = self.recommend(users, k, filter_seen)
        out, off = [], 0
        for s in sizes:
            out.append((vals[off : off + s], idx[off : off + s]))
            off += s
        return out
