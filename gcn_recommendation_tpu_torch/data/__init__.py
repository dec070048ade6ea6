from gcn_recommendation_tpu_torch.data.loader import DataBundle, load_preprocessed_data
from gcn_recommendation_tpu_torch.data.sampler import (
    epoch_batches,
    membership_arrays,
    sample_negatives,
)

__all__ = [
    "DataBundle",
    "load_preprocessed_data",
    "epoch_batches",
    "membership_arrays",
    "sample_negatives",
]
