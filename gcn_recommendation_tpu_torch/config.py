"""Run configuration (PyTorch port).

A copy of ``gcn_recommendation_tpu.config`` holding the fields the port
uses; the port imports nothing from the JAX package.  Defaults replicate
the reference (main.py:62-68): dim 64, 3 layers, lr 1e-3, weight decay
1e-4, top-k 20, val every 5 epochs, batch 2048 (128 in debug).
"""

from __future__ import annotations

import dataclasses
import os
from typing import Optional

# Processed-data directory of each dataset recipe (mirrors the five
# reference prepare_data.py variants plus the synthetic generator).
DATASET_DIR_TEMPLATES = {
    "amazon_books": "dataset/amazon_books/processed_data_{core}",
    "amazon_books_senti": "dataset/amazon_books_senti/processed_data_{core}",
    "amazon_books_emb": "dataset/amazon_books_emb/processed_data_{core}_pos_only_cat",
    "amazon_sport_emb": "dataset/amazon_sport_emb/processed_data_{core}_pos_only_cat",
    "steam_emb": "dataset/steam_emb/processed_data_{core}_pos_only_cat",
    "synthetic": "dataset/synthetic/processed_data_{core}",
}


def _debug_dir(d: str) -> str:
    """Redirect an output dir under ``debug/`` (reference main.py:82-83);
    absolute dirs nest ``debug`` as a suffix so a debug run never
    overwrites the real run's outputs."""
    if os.path.isabs(d):
        return os.path.join(d, "debug")
    return os.path.join("debug", d)


@dataclasses.dataclass
class Config:
    """Hyperparameters and run layout."""

    # --- model ---
    embedding_dim: int = 64
    n_layers: int = 3
    model_name: str = "LightGCN"

    # --- optimization ---
    learning_rate: float = 1e-3
    weight_decay: float = 1e-4
    batch_size: int = 2048
    epochs: int = 150
    brand_loss_weight: float = 0.1

    # --- evaluation ---
    top_k: int = 20
    val_interval: int = 5
    eval_user_batch: int = 1024

    # --- data ---
    dataset: str = "synthetic"
    core: int = 16
    data_root: str = "."
    processed_data_dir: Optional[str] = None
    use_brand: bool = True
    brand_loss: bool = False
    use_pretrained_emb: bool = False
    fusion_id_init: bool = False

    # --- run layout ---
    checkpoint_dir: str = "exp/checkpoints/checkpoints"
    results_dir: str = "exp/results/results"
    best_model_name: str = "best_model"
    seed: int = 42

    debug: bool = False
    debug_nans: bool = False            # autograd anomaly mode around each step,
                                        # stop at the first non-finite loss

    # --- storage dtypes ---
    param_dtype: str = "float32"        # embedding-table storage dtype
    compute_dtype: str = "float32"      # propagation storage dtype; the
                                        # reductions and layer mean stay f32
    tile_spmm: bool = False             # block-sparse tiles for the dense
                                        # row-block mass of the propagation
                                        # (graph/tiles.py, csrc/tile_spmm.cu)
    tile_min_fill: int = 64             # edges a 128x128 tile needs
    tile_dtype: str = "float32"         # tile-value storage ("bfloat16"
                                        # halves the tile bytes)

    def __post_init__(self):
        if self.debug:
            # reference debug mode (main.py:76-83); explicit flags win
            defaults = {f.name: f.default for f in dataclasses.fields(self)}
            self.epochs = 5
            if self.batch_size == defaults["batch_size"]:
                self.batch_size = 128
            if self.val_interval == defaults["val_interval"]:
                self.val_interval = 1
            self.checkpoint_dir = _debug_dir(self.checkpoint_dir)
            self.results_dir = _debug_dir(self.results_dir)

    @property
    def data_dir(self) -> str:
        if self.processed_data_dir is not None:
            return self.processed_data_dir
        try:
            template = DATASET_DIR_TEMPLATES[self.dataset]
        except KeyError:
            raise ValueError(
                f"Unknown dataset {self.dataset!r}; known: "
                f"{sorted(DATASET_DIR_TEMPLATES)} (or set processed_data_dir)"
            ) from None
        return os.path.join(self.data_root, template.format(core=self.core))

    @property
    def pretrained_emb_path(self) -> str:
        return os.path.join(self.data_dir, "item_embeddings.npy")

    def checkpoint_name(self) -> str:
        """Checkpoint name encoding, mirroring main.py:613-615."""
        ablation = "" if self.use_brand else "_no_brand"
        pretrained = "_embed" if self.use_pretrained_emb else ""
        return f"best_{self.model_name.lower()}_core{self.core}{ablation}{pretrained}"

    def logger_name(self) -> str:
        """Run name used for CSV/PNG artifacts, mirroring main.py:444-446."""
        name = f"{self.model_name}_{'brand' if self.use_brand else 'no_brand'}"
        if self.use_pretrained_emb:
            name += "_pretrained"
        return name
