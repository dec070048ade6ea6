"""Model registry (name -> class), as ``get_model`` at reference
main.py:42-50; unknown names raise ImportError like the reference."""

from gcn_recommendation_tpu_torch.models.lightgcn import LightGCN
from gcn_recommendation_tpu_torch.models.lightgcn_fusion import LightGCN_Fusion

_REGISTRY = {
    "LightGCN": LightGCN,
    "LightGCN_Fusion": LightGCN_Fusion,
}


def get_model(model_name: str):
    """Look up a model class by its reference-compatible name."""
    try:
        return _REGISTRY[model_name]
    except KeyError:
        raise ImportError(
            f"Could not import model {model_name!r}; known models: "
            f"{sorted(_REGISTRY)}"
        ) from None


def register_model(name: str, cls) -> None:
    """Register a custom model class under ``name``."""
    _REGISTRY[name] = cls


__all__ = ["LightGCN", "LightGCN_Fusion", "get_model", "register_model"]
