"""LightGCN (PyTorch port of ``gcn_recommendation_tpu/models/lightgcn.py``).

Reference semantics (models/lightgcn.py of the reference): three
Xavier-uniform tables (users / items / brands); forward concatenates them,
runs K propagations, averages the K+1 layer outputs and splits the block
back.  The layer mean is ``ops/spmm.py::layer_mean`` (in f32, as in the
JAX package); which propagation it runs is the graph kind's business.

The set of parameter keys belongs to the model (``param_keys``, and of
those ``trainable_keys``): ``params``, ``load_params``, the optimizer,
``models/convert.py`` and the checkpoints all read it, so a subclass
(``LightGCN_Fusion``) adds keys in one place.

Row padding (``set_row_multiple``): every table's row count is padded to a
multiple.  Pad rows are zero at init, receive zero gradient (the loss
gathers logical rows only, and pad nodes are isolated in the padded graph
of ``graph.build.pad_graph_nodes``) and so stay zero under Adam; the five
outputs of ``forward`` always have logical sizes.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import numpy as np
import torch
from torch import nn

from gcn_recommendation_tpu_torch.core.device import DeviceLike, resolve_device
from gcn_recommendation_tpu_torch.graph.build import Graph, pad_graph_nodes
from gcn_recommendation_tpu_torch.ops.spmm import layer_mean


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


def _pad_rows(x: torch.Tensor, target: int) -> torch.Tensor:
    n = x.shape[0]
    if target == n:
        return x
    return torch.cat([x, x.new_zeros((target - n,) + tuple(x.shape[1:]))])


class LightGCN(nn.Module):
    """LightGCN over the users+items+brands graph."""

    name = "LightGCN"
    # every key of ``params()`` and of a checkpoint, in the optimizer's order
    param_keys: Tuple[str, ...] = ("user_embedding", "item_embedding", "brand_embedding")
    # keys that are buffers: in ``params()`` and checkpoints, never trained
    frozen_keys: Tuple[str, ...] = ()
    # what shared code (the CLI, the trainer) asks of a model instead of
    # testing its name, so a registered subclass inherits the answer:
    # the pretrained item matrix must be loaded and handed to __init__
    needs_content = False
    # ``debug_diagnostics`` describes this model (its layer-0 item table
    # is the ID table that is propagated)
    has_debug_diagnostics = True

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
        # padded table sizes (== logical until set_row_multiple is called)
        self.row_multiple = 1
        self.num_users_pad = num_users
        self.num_items_pad = num_items
        self.num_brands_pad = num_brands
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
        for key, rows in zip(LightGCN.param_keys, (num_users, num_items, num_brands)):
            self._set_tensor(key, torch.zeros((rows, d), dtype=self.param_dtype))

    @property
    def trainable_keys(self) -> Tuple[str, ...]:
        """The keys the optimizer updates, in its parameter order."""
        return tuple(k for k in self.param_keys if k not in self.frozen_keys)

    def _set_tensor(self, key: str, value: torch.Tensor) -> None:
        """(Re)place ``key`` with ``value`` on the model's device: a buffer
        when the key is frozen, else a fresh ``nn.Parameter``."""
        value = value.to(self.device)
        if key in self.frozen_keys:
            self.register_buffer(key, value)
        else:
            self.register_parameter(key, nn.Parameter(value))

    # --- row padding ---
    def set_row_multiple(self, m: int) -> None:
        """Pad every embedding table's row count to a multiple of ``m``
        (logical rows kept, pad rows zero).  The graph must then be the
        padded-node-space remap ``padded_graph`` gives.  It replaces the
        model's parameters, so call it before building a trainer."""
        m = max(1, int(m))
        logical = self.unpad_state_tree(self.params())
        self.row_multiple = m
        up = lambda n: -(-n // m) * m  # noqa: E731
        self.num_users_pad = up(self.num_users)
        self.num_items_pad = up(self.num_items)
        self.num_brands_pad = up(self.num_brands)
        for key, value in self.pad_state_tree(logical).items():
            if key in self._table_pad_spec():
                self._set_tensor(key, value.clone())

    def needs_row_padding(self, m: int) -> bool:
        """True when some table's row count does not divide by ``m``: what
        a caller that shards the tables ``m`` ways asks before
        ``set_row_multiple(m)``."""
        return any(n % m for n in (self.num_users, self.num_items, self.num_brands))

    @property
    def is_row_padded(self) -> bool:
        """True when the device graph must come from ``pad_graph_nodes``:
        ELL bucket rows are padded even when the sizes already divide."""
        pads = (self.num_users_pad, self.num_items_pad, self.num_brands_pad)
        return pads != (self.num_users, self.num_items, self.num_brands) or self.row_multiple > 1

    def padded_graph(self, g: Graph) -> Graph:
        """The host graph the device layout is built from: ``g``, remapped
        into the padded node space when the tables are row-padded."""
        if not self.is_row_padded:
            return g
        return pad_graph_nodes(
            g, self.num_users_pad, self.num_items_pad, self.num_brands_pad,
            bucket_row_multiple=self.row_multiple,
        )

    def _table_pad_spec(self) -> Dict[str, Tuple[int, int]]:
        """params key -> (logical rows, padded rows) of the row-padded
        tables (``LightGCN_Fusion`` extends it)."""
        return {
            "user_embedding": (self.num_users, self.num_users_pad),
            "item_embedding": (self.num_items, self.num_items_pad),
            "brand_embedding": (self.num_brands, self.num_brands_pad),
        }

    def _map_tables(self, tree, fn):
        """Apply ``fn(x, logical, padded)`` to every tensor whose dict key
        names a row-padded table, through nested dicts (a params dict, or
        Adam moments keyed like it)."""
        spec = self._table_pad_spec()

        def walk(node):
            if not isinstance(node, dict):
                return node
            return {
                k: fn(v, *spec[k]) if k in spec and torch.is_tensor(v) and v.ndim >= 1
                else walk(v)
                for k, v in node.items()
            }

        return walk(tree)

    def unpad_state_tree(self, tree):
        """Slice padded table rows back to logical sizes (checkpoints store
        logical shapes, so they do not depend on the row multiple)."""
        return self._map_tables(
            tree, lambda x, logical, padded: x[:logical] if x.shape[0] == padded != logical else x
        )

    def pad_state_tree(self, tree):
        """Zero-pad logical table rows to the padded sizes."""
        return self._map_tables(
            tree,
            lambda x, logical, padded: _pad_rows(x, padded) if x.shape[0] == logical else x,
        )

    # --- params ---
    def _draw_params(self, generator: Optional[torch.Generator]) -> Dict[str, torch.Tensor]:
        """Fresh logical-shape params on the CPU; the logical rows do not
        depend on the row multiple."""
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
        return params

    def init(self, generator: Optional[torch.Generator] = None) -> Dict[str, torch.Tensor]:
        """Fill the model (Xavier uniform, or the pretrained item matrix)
        from a CPU ``generator`` and return ``params()``."""
        self.load_params(self._draw_params(generator))
        return self.params()

    def params(self) -> Dict[str, torch.Tensor]:
        """Every key of ``param_keys`` as stored (padded rows included)."""
        return {k: getattr(self, k).detach() for k in self.param_keys}

    @torch.no_grad()
    def load_params(self, params: Dict[str, torch.Tensor]) -> None:
        """Copy a params dict (every key of ``param_keys``, logical or
        padded shapes) into the model."""
        missing = [k for k in self.param_keys if k not in params]
        if missing:
            raise KeyError(f"params lack {missing}")
        unknown = [k for k in params if k not in self.param_keys]
        if unknown:
            raise KeyError(f"params hold keys {unknown} that {self.name} does not have")
        padded = self.pad_state_tree({k: torch.as_tensor(v) for k, v in params.items()})
        for key in self.param_keys:
            table, src = getattr(self, key), padded[key]
            if tuple(src.shape) != tuple(table.shape):
                raise ValueError(f"{key}: shape {tuple(src.shape)} != {tuple(table.shape)}")
            table.copy_(src)

    # --- forward ---
    def _initial_tables(self):
        """Layer-0 (user, item, brand) tables, padded rows as stored.  The
        Fusion variant overrides this to return the fused item block."""
        return self.user_embedding, self.item_embedding, self.brand_embedding

    def forward(self, graph):
        """Returns (final_user, final_item, final_brand, user0, item0), all
        of logical size.  ``graph`` is any graph kind of ``ops/spmm.py``
        (over the padded node space when the tables are row-padded);
        gradients flow to the tables through its propagation.  The layer
        mean is ``ops/spmm.py::layer_mean``: one merge-skip call on a graph
        with the permuted views, as in the JAX package."""
        ego = torch.cat(self._initial_tables(), dim=0)
        return self._split_final(layer_mean(ego, graph, self.n_layers, self.compute_dtype))

    def _split_final(self, final: torch.Tensor, gather_table=None):
        """Slice the propagated block back into logical-size (final_user,
        final_item, final_brand, user0, item0); item0 is the ID table.
        ``gather_table`` maps a stored table to the whole padded table (a
        model whose tables hold one rank's rows, ``parallel/``)."""
        up, ip = self.num_users_pad, self.num_items_pad
        user0, item0 = self.user_embedding, self.item_embedding
        if gather_table is not None:
            user0, item0 = gather_table(user0), gather_table(item0)
        return (
            final[: self.num_users],
            final[up : up + self.num_items],
            final[up + ip : up + ip + self.num_brands],
            user0[: self.num_users],
            item0[: self.num_items],
        )

    def apply_with_propagator(self, propagator, num_nodes_pad: int):
        """Forward pass through an external propagator that computes the
        whole mean over layers in one call (``parallel/halo.py``'s
        ``make_halo_propagator``): ``propagator(ego [num_nodes_pad, d]) ->
        final [num_nodes_pad, d]``.  Same returns as ``forward``."""
        num_nodes = self.num_users_pad + self.num_items_pad + self.num_brands_pad
        ego = torch.cat(self._initial_tables(), dim=0)
        if num_nodes_pad > num_nodes:
            ego = torch.cat([ego, ego.new_zeros((num_nodes_pad - num_nodes, ego.shape[1]))])
        return self._split_final(propagator(ego)[:num_nodes])

    def apply_with_table_propagator(self, propagator, gather_table=None):
        """Forward pass through a propagator that takes the three layer-0
        tables apart, ``propagator(user, item, brand) -> final [N_pad, d]``:
        the sharded schedules, whose tables hold this rank's rows and enter
        the propagator row-sharded (the fused item rows for
        ``LightGCN_Fusion``).  ``gather_table`` assembles the ID tables for
        the layer-0 outputs.  Same returns as ``forward``."""
        return self._split_final(propagator(*self._initial_tables()), gather_table)


def debug_diagnostics(
    model, params, graph_np: Graph, max_nodes: int = 20000, n_probe: int = 100, seed: int = 42
):
    """The reference's debug-mode self-checks, on the host in numpy:

    * per-layer brand-embedding L2 norms (models/lightgcn.py:49-51);
    * the brand-influence check: average cosine similarity between the
      final item embeddings and a one-hop user-item-only propagation via
      the *dense* adjacency on ``n_probe`` random items
      (models/lightgcn.py:62-78).

    ``graph_np`` is the unpadded bundle graph.  The dense adjacency is
    quadratic, so graphs above ``max_nodes`` are refused (an empty dict).
    Returns the diagnostics and prints them like the reference.
    """
    g = graph_np
    n = g.num_nodes
    nu, ni = model.num_users, model.num_items
    if n > max_nodes:
        print(f"[debug] graph too large for dense diagnostics ({n} nodes)")
        return {}
    dense = np.zeros((n, n), np.float32)
    # true edges only: the COO arrays are padded past g.nnz with weight-0
    # sentinels, and np.add.at accumulates duplicates where a fancy-index
    # += would keep the last write
    np.add.at(dense, (g.dst[: g.nnz], g.src[: g.nnz]), g.weight[: g.nnz])

    def table(key, rows):  # pad rows sliced off
        return np.asarray(torch.as_tensor(params[key]).detach().float().cpu())[:rows]

    user0 = table("user_embedding", model.num_users)
    item0 = table("item_embedding", model.num_items)
    brand0 = table("brand_embedding", model.num_brands)
    ego = np.concatenate([user0, item0, brand0])

    norms = []
    acc = ego.copy()
    e = ego
    for layer in range(model.n_layers):
        e = dense @ e
        acc += e
        bn = float(np.linalg.norm(e[nu + ni :]))
        norms.append(bn)
        print(f"Layer {layer + 1} brand embedding L2 norm: {bn:.6f}")
    final = acc / (model.n_layers + 1)
    final_item = final[nu : nu + ni]

    rng = np.random.default_rng(seed)
    probe = rng.integers(0, ni, n_probe)
    item_with_brand = final_item[probe]

    adj_ui = dense[: nu + ni, : nu + ni]
    ego_nb = adj_ui @ np.concatenate([user0, item0])
    item_nb = item0[probe] + ego_nb[nu : nu + ni][probe]

    dot = np.sum(item_with_brand * item_nb, axis=1)
    denom = np.linalg.norm(item_with_brand, axis=1) * np.linalg.norm(item_nb, axis=1)
    cos = float(np.mean(dot / np.maximum(denom, 1e-12)))
    print(f"Average cos similarity (item emb with/without brand): {cos:.6f}")
    return {"brand_norms": norms, "brand_influence_cosine": cos}
