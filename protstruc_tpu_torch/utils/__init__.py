"""Utilities: the warmed bucketed featurizer, length buckets, serialization,
validation, profiling."""

from protstruc_tpu_torch.utils.aot import CompiledFeaturizer, precompile_featurizer
from protstruc_tpu_torch.utils.buckets import bucket_length, pad_batch_to_bucket
from protstruc_tpu_torch.utils.serialization import (
    load_structure_batch,
    save_structure_batch,
)
