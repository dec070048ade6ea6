from gcn_recommendation_tpu_torch.parallel.halo import (
    HaloTrainer,
    make_halo_propagator,
    shard_ell,
)
from gcn_recommendation_tpu_torch.parallel.spmd import (
    ShardedTrainer,
    evaluate_sharded,
    shard_params,
    sharded_topk_eval_batch,
)

__all__ = [
    "ShardedTrainer",
    "evaluate_sharded",
    "sharded_topk_eval_batch",
    "shard_params",
    "HaloTrainer",
    "make_halo_propagator",
    "shard_ell",
]
