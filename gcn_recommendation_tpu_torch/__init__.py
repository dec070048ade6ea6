"""gcn_recommendation_tpu_torch — the PyTorch/CUDA port of gcn_recommendation_tpu.

Serving (load a checkpoint, propagate once, masked top-k per request, f32
or int8 catalog) and training (BPR + Adam, evaluation, checkpoints and
resume) of ``LightGCN`` and ``LightGCN_Fusion`` on an NVIDIA card, with the
JAX package's Pallas kernels as hand-written CUDA kernels: the int8
quantizer (``csrc/quant_int8.cu``) and the block-sparse tile product
(``csrc/tile_spmm.cu``), which ``tools/exp_block_tiles.py`` also runs on
dense, balanced tiles.  Module names follow the JAX package so each
counterpart is easy to find; the port imports nothing from it.  Entry
points run on ``cuda`` unless the caller passes ``device="cpu"``.
"""

__version__ = "0.1.0"

from gcn_recommendation_tpu_torch.config import Config
from gcn_recommendation_tpu_torch.models import get_model

__all__ = ["Config", "get_model", "__version__"]
