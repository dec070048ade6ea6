"""The benchmark's calls into the program under test, the PyTorch port
``gcn_recommendation_tpu_torch``, through its public entry points:
``build_normalized_adjacency``, ``get_model``, ``Trainer``, ``Retriever``
and ``server.Dispatcher``.  This is the one module of the benchmark that
imports the port.
"""

from __future__ import annotations

import numpy as np
import torch

from gcn_recommendation_tpu_torch.config import Config
from gcn_recommendation_tpu_torch.data.loader import DataBundle, Interactions, ItemBrand
from gcn_recommendation_tpu_torch.graph.build import build_normalized_adjacency
from gcn_recommendation_tpu_torch.models import get_model
from gcn_recommendation_tpu_torch.serve import Retriever
from gcn_recommendation_tpu_torch.server import Dispatcher, _Pending
from gcn_recommendation_tpu_torch.train.trainer import Trainer

__all__ = ["Dispatcher", "Pending", "make_config", "make_bundle", "make_model",
           "make_trainer", "make_retriever"]

Pending = _Pending


def make_config(cfg: dict, compute_dtype: str) -> Config:
    """The port's ``Config`` for a configuration file's sizes."""
    return Config(
        model_name=cfg["model"], embedding_dim=cfg["embedding_dim"], n_layers=cfg["n_layers"],
        learning_rate=cfg["learning_rate"], weight_decay=cfg["weight_decay"],
        batch_size=cfg["batch_size"], top_k=cfg["top_k"],
        eval_user_batch=cfg["eval_user_batch"], use_brand=cfg["graph"]["use_brand"],
        compute_dtype=compute_dtype,
    )


def make_bundle(ds, use_brand: bool) -> DataBundle:
    """The port's data bundle: its adjacency built by the port from the
    benchmark's arrays."""
    ib_item = np.arange(ds.num_items, dtype=np.int32)
    graph = build_normalized_adjacency(
        ds.train_user, ds.train_item, ds.num_users, ds.num_items, ds.num_brands,
        item_brand_item_idx=ib_item, item_brand_brand_idx=ds.item_brand, use_brand=use_brand)
    return DataBundle(
        train=Interactions(ds.train_user, ds.train_item),
        val=Interactions(ds.val_user, ds.val_item),
        test=Interactions(ds.test_user, ds.test_item),
        num_users=ds.num_users, num_items=ds.num_items, num_brands=ds.num_brands,
        graph=graph, item_brand=ItemBrand(ib_item, ds.item_brand),
        item_to_brand=ds.item_brand.copy(), graph_stats={},
    )


def make_model(config: Config, ds, device):
    return get_model(config.model_name)(ds.num_users, ds.num_items, ds.num_brands, config,
                                        device=device)


def make_trainer(config: Config, ds, bundle: DataBundle, tables, device) -> Trainer:
    """A ``Trainer`` whose model holds ``tables``; Adam starts fresh."""
    model = make_model(config, ds, device)
    trainer = Trainer(config, model, bundle)
    model.load_params(tables)
    return trainer


@torch.no_grad()
def make_retriever(config: Config, ds, bundle: DataBundle, tables, device) -> Retriever:
    """The f32 catalog of ``tables``, propagated once at load."""
    return Retriever.from_params(make_model(config, ds, device), tables, bundle)
