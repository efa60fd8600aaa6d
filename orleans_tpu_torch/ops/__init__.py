"""Hot-op library of the port: the fan-in segment sum (K1) and the
within-destination rank (K2) as hand-written CUDA kernels for Hopper
(``csrc/``), each beside its plain PyTorch version, and the directory
hash probe as plain torch gathers."""

from .hash_probe import (
    DeviceDirectory,
    DeviceDirectory64,
    build_directory_arrays,
    device_lookup,
    device_lookup64,
    split64,
)
from .route import (
    RANK_BY_DEST,
    pack_by_dest,
    rank_by_dest,
    rank_by_dest_ref,
    rank_dense_keys,
    rank_plan,
)
from .segment_reduce import (
    REDUCE_OPS,
    SEGMENT_SUM,
    host_fold,
    masked_reduce,
    segment_sum,
    segment_sum_onehot,
    segment_sum_plan,
    segment_sum_ref,
)

KERNELS = (SEGMENT_SUM, RANK_BY_DEST)

__all__ = [
    "KERNELS",
    "REDUCE_OPS",
    "RANK_BY_DEST",
    "SEGMENT_SUM",
    "host_fold",
    "masked_reduce",
    "segment_sum",
    "segment_sum_onehot",
    "segment_sum_ref",
    "segment_sum_plan",
    "rank_by_dest",
    "rank_by_dest_ref",
    "rank_dense_keys",
    "rank_plan",
    "pack_by_dest",
    "device_lookup",
    "device_lookup64",
    "build_directory_arrays",
    "split64",
    "DeviceDirectory",
    "DeviceDirectory64",
]
