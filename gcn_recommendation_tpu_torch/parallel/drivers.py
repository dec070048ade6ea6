"""Drivers: one sharded computation, run on every rank, numpy results out.

Each function builds the mesh of this run (``core/mesh.py``), runs one
piece of the sharded path from plain inputs (numpy arrays, a
``DataBundle``, config keywords), and returns numpy arrays and floats,
the same on every rank.  They are what ``core.mesh.run_local_world``
runs on each rank of a small world (``run_local_world(2, train_case,
...)``): the multi-rank runs of the CPU tests over gloo and of the chip
smoke test's two-card phase over NCCL.  With ``mesh_shape=None`` a
driver runs the single-device path in the calling process, the
reference the sharded runs are held against.  Every driver runs on the
card unless it is given ``device="cpu"`` (``core/device.py``); on a mesh,
``device`` must name the mesh's device type.
"""

from __future__ import annotations

import numpy as np
import torch

from gcn_recommendation_tpu_torch.config import Config
from gcn_recommendation_tpu_torch.core.device import resolve_device
from gcn_recommendation_tpu_torch.core.mesh import MODEL_AXIS, MeshSpec, create_mesh
from gcn_recommendation_tpu_torch.models import get_model


def _np(t):
    return t.detach().cpu().numpy()


def _on(device, mesh=None) -> torch.device:
    """The device a driver runs on: ``device`` through ``resolve_device``
    (cuda unless the caller asks for the CPU), or the mesh's device, which
    must be of that type."""
    dev = resolve_device(device)
    if mesh is None:
        return dev
    if mesh.device.type != dev.type:
        raise ValueError(f"device {dev.type!r} asked of a mesh on {mesh.device}")
    return mesh.device


def _mesh(mesh_shape, device):
    """(the mesh of ``mesh_shape``, or None; the device the driver runs on).
    ``device`` resolves first: a call without one fails before a mesh."""
    resolve_device(device)
    mesh = create_mesh(MeshSpec(*mesh_shape)) if mesh_shape is not None else None
    return mesh, _on(device, mesh)


def make_trainer(bundle, cfg_kwargs, model_name="LightGCN", content=None, params=None,
                 mesh=None, schedule="gspmd", device=None):
    """A trainer over ``bundle`` whose model starts from ``params``
    (logical numpy or tensors; None: the config seed's fresh tables):
    ``Trainer`` without a mesh, else the ``schedule``'s sharded trainer on
    the mesh's device."""
    from gcn_recommendation_tpu_torch.parallel.halo import HaloTrainer
    from gcn_recommendation_tpu_torch.parallel.spmd import ShardedTrainer
    from gcn_recommendation_tpu_torch.train.trainer import Trainer

    cfg = Config(**cfg_kwargs)
    dev = _on(device, mesh)
    model = get_model(model_name)(bundle.num_users, bundle.num_items, bundle.num_brands, cfg,
                                  pretrained_item_emb=content, device=dev)
    if params is None:
        model.init(torch.Generator().manual_seed(cfg.seed))
    else:
        model.load_params({k: torch.as_tensor(np.asarray(v)) for k, v in params.items()})
    if mesh is None:
        return Trainer(cfg, model, bundle)
    cls = HaloTrainer if schedule == "halo" else ShardedTrainer
    return cls(cfg, model, bundle, mesh)


def train_case(bundle, cfg_kwargs, batches, model_name="LightGCN", content=None, params=None,
               mesh_shape=None, schedule="gspmd", epochs=0, validate=False, device=None,
               record_trajectory=True):
    """Steps on the given whole batches (``[(users, pos, neg)]`` numpy),
    then ``epochs`` sampled epochs from the trainer's seeded generator.
    Returns the step losses, the logical params before each step (with
    ``record_trajectory``), the epoch losses, the final logical params,
    the largest |pad row| of every table, and (with ``validate``)
    Recall/NDCG."""
    mesh, _ = _mesh(mesh_shape, device)
    tr = make_trainer(bundle, cfg_kwargs, model_name, content, params, mesh, schedule, device)
    step_losses, trajectory = [], []
    for s, batch in enumerate(batches):
        if record_trajectory:
            trajectory.append({k: _np(v) for k, v in tr._export_tree(tr.model.params()).items()})
        u, p, n = (torch.from_numpy(np.asarray(a, np.int64)).to(tr.device) for a in batch)
        step_losses.append(float(tr.train_step(u, p, n, step=s)))
    epoch_losses = [tr.run_epoch() for _ in range(epochs)]
    padded = {k: _np(v) for k, v in tr.params().items()}
    logical = {k: _np(v) for k, v in tr._export_tree(tr.model.params()).items()}
    pad_max = {k: float(np.abs(padded[k][logical[k].shape[0]:]).max(initial=0.0))
               for k in logical if padded[k].ndim >= 1}
    out = {"step_losses": np.asarray(step_losses), "trajectory": trajectory,
           "epoch_losses": epoch_losses,
           "params": logical, "pad_max": pad_max,
           "padded_rows": {k: padded[k].shape[0] for k in padded if padded[k].ndim >= 1},
           "local_rows": {k: int(v.shape[0]) for k, v in tr.model.params().items()
                          if v.ndim >= 1}}
    if validate:
        out["recall"], out["ndcg"] = tr.validate()
    return out


def fit_case(bundle, cfg_kwargs, mesh_shape=None, schedule="gspmd", resume=False,
             device=None):
    """``fit`` (or ``fit(resume=True)``) from the config seed's tables;
    returns the best recall."""
    mesh, _ = _mesh(mesh_shape, device)
    tr = make_trainer(bundle, cfg_kwargs, mesh=mesh, schedule=schedule, device=device)
    return {"best_recall": tr.fit(resume=resume)[1]}


def topk_case(mesh_shape, user_emb, k, filter_idx, num_valid_items, item_emb=None,
              item_q=None, item_scale=None, device=None):
    """The distributed top-k of ``user_emb`` against a catalog padded to a
    multiple of the model axis: f32 (``item_emb``) or int8 (``item_q``,
    ``item_scale``).  Each rank takes its rows; returns (values, indices)."""
    from gcn_recommendation_tpu_torch.parallel.spmd import (
        _shard,
        sharded_quantized_topk_batch,
        sharded_topk_eval_batch,
    )

    mesh, dev = _mesh(mesh_shape, device)

    def t(a):
        return torch.from_numpy(np.asarray(a)).to(dev)

    filt = t(np.asarray(filter_idx, np.int64))
    if item_emb is not None:
        vals, idx = sharded_topk_eval_batch(mesh, t(user_emb), _shard(t(item_emb), mesh), filt,
                                            k, num_valid_items=num_valid_items)
    else:
        vals, idx = sharded_quantized_topk_batch(
            mesh, t(user_emb), _shard(t(item_q), mesh), _shard(t(item_scale), mesh), filt, k,
            num_valid_items=num_valid_items)
    return _np(vals), _np(idx)


def evaluate_case(mesh_shape, fu, fi, eval_inter, filter_inter, num_users, num_items, k,
                  batch_size, device=None):
    """``evaluate_sharded`` of given final embeddings; (recall, ndcg)."""
    from gcn_recommendation_tpu_torch.parallel.spmd import evaluate_sharded

    mesh, dev = _mesh(mesh_shape, device)
    return evaluate_sharded(
        mesh, torch.from_numpy(fu).to(dev), torch.from_numpy(fi).to(dev),
        eval_inter, filter_inter, num_users, num_items, k, batch_size)


def retriever_case(bundle, cfg_kwargs, params, requests, k, quantize, mesh_shape=None,
                   device=None):
    """A ``Retriever`` over ``params`` (the mesh's sharded one, or the
    single-device one): each request's (scores, items), the int8 catalog's
    codes and scales over the logical rows (gathered from every model
    rank), and the quantizer's launches on this rank (load, dispatches)."""
    from gcn_recommendation_tpu_torch.ops import quant
    from gcn_recommendation_tpu_torch.parallel.collectives import all_gather_rows
    from gcn_recommendation_tpu_torch.serve import Retriever

    mesh, dev = _mesh(mesh_shape, device)
    cfg = Config(**cfg_kwargs)
    model = get_model("LightGCN")(bundle.num_users, bundle.num_items, bundle.num_brands, cfg,
                                  device=dev)
    quant.quantize_rows_int8.launches = quant.quantize_users_int8.launches = 0
    r = Retriever.from_params(model, {k_: torch.as_tensor(v) for k_, v in params.items()},
                              bundle, quantize=quantize, mesh=mesh)
    load_launches = quant.quantize_rows_int8.launches
    answers = [r.recommend(np.asarray(u, np.int32), k=k) for u in requests]
    out = {"answers": answers, "launches_load": load_launches,
           "launches_nearest": quant.quantize_users_int8.launches}
    if quantize:
        q, s = r.item_q, r.item_scale
        if mesh is not None:
            group = mesh.group(MODEL_AXIS)
            q, s = all_gather_rows(q, group), all_gather_rows(s, group)
        out["item_q"] = _np(q)[: bundle.num_items]
        out["item_scale"] = _np(s)[: bundle.num_items]
    return out


def run_cases(cases):
    """Run ``[(driver name, keyword arguments)]`` in order on every rank
    (one world for many cases: a world's start costs seconds); returns
    their results in order."""
    return [_DRIVERS[name](**kwargs) for name, kwargs in cases]


def halo_propagation_case(mesh_shape, graph, emb, cotangent, n_layers, dense_threshold=128,
                          device=None):
    """``make_halo_propagator`` over ``shard_ell(graph)`` on the mesh: the
    final block of ``emb`` (zero-padded to the sharded node count) and the
    gradient of ``sum(final * cotangent)`` in ``emb``, both over the
    padded rows."""
    from gcn_recommendation_tpu_torch.parallel.halo import make_halo_propagator, shard_ell

    mesh, dev = _mesh(mesh_shape, device)
    sharded = shard_ell(graph, mesh.shape[MODEL_AXIS], dense_threshold=dense_threshold)
    prop = make_halo_propagator(mesh, sharded, n_layers)
    n_pad = sharded.num_nodes_pad
    e = torch.zeros((n_pad, emb.shape[1]))
    e[: emb.shape[0]] = torch.from_numpy(emb)
    e = e.to(dev).requires_grad_(True)
    v = torch.zeros_like(e)
    v[: cotangent.shape[0]] = torch.from_numpy(cotangent).to(dev)
    out = prop(e)
    (grad,) = torch.autograd.grad((out * v).sum(), e)
    return _np(out), _np(grad)


_DRIVERS = {f.__name__: f for f in (train_case, fit_case, topk_case, evaluate_case,
                                    retriever_case, halo_propagation_case)}
