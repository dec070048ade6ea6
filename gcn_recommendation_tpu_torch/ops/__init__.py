from gcn_recommendation_tpu_torch.ops.quant import (
    quantize_rows_int8,
    quantized_topk_scores,
)
from gcn_recommendation_tpu_torch.ops.spmm import (
    ChunkedDeviceGraph,
    DeviceGraph,
    propagate,
    propagate_coo,
    to_device_chunked_graph,
    to_device_coo_graph,
    to_device_graph,
    to_device_graph_auto,
)
from gcn_recommendation_tpu_torch.ops.topk import (
    masked_topk,
    masked_topk_scores,
    topk_eval_batch,
)

__all__ = [
    "ChunkedDeviceGraph",
    "DeviceGraph",
    "propagate",
    "propagate_coo",
    "to_device_chunked_graph",
    "to_device_coo_graph",
    "to_device_graph",
    "to_device_graph_auto",
    "masked_topk",
    "masked_topk_scores",
    "topk_eval_batch",
    "quantize_rows_int8",
    "quantized_topk_scores",
]
