"""Model registry (name -> class), as ``get_model`` at reference
main.py:42-50; unknown names raise ImportError like the reference."""

from gcn_recommendation_tpu_torch.models.lightgcn import LightGCN

_REGISTRY = {"LightGCN": LightGCN}

# Models of the JAX package that the port does not have yet.
_NOT_PORTED = ("LightGCN_Fusion",)


def get_model(model_name: str):
    """Look up a model class by its reference-compatible name."""
    if model_name in _NOT_PORTED:
        raise NotImplementedError(
            f"{model_name} is not ported to PyTorch yet; known: {sorted(_REGISTRY)}"
        )
    try:
        return _REGISTRY[model_name]
    except KeyError:
        raise ImportError(
            f"Could not import model {model_name!r}; known models: "
            f"{sorted(_REGISTRY)}"
        ) from None


__all__ = ["LightGCN", "get_model"]
