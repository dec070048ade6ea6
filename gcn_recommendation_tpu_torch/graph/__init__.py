from gcn_recommendation_tpu_torch.graph.build import (
    Graph,
    build_chunked_ell,
    build_normalized_adjacency,
    normalize_sym,
)

__all__ = ["Graph", "build_chunked_ell", "build_normalized_adjacency", "normalize_sym"]
