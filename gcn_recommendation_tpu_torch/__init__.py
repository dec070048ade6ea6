"""gcn_recommendation_tpu_torch — the PyTorch/CUDA port of gcn_recommendation_tpu.

The serving path of the JAX package (load a checkpoint, propagate once,
masked top-k per request, f32 or int8 catalog) on an NVIDIA card, with
the Pallas int8 quantizer as a hand-written CUDA kernel
(``csrc/quant_int8.cu``).  Module names follow the JAX package so each
counterpart is easy to find; the port imports nothing from it.  Entry
points run on ``cuda`` unless the caller passes ``device="cpu"``.
"""

__version__ = "0.1.0"

from gcn_recommendation_tpu_torch.config import Config
from gcn_recommendation_tpu_torch.models import get_model

__all__ = ["Config", "get_model", "__version__"]
