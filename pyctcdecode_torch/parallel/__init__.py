"""Multi-process execution: sharded batch decoding and counter collectives (``torch.distributed``)."""
from .batch import ShardedCTCDecoder, all_reduce_counts, make_data_mesh
from .launch import initialize_from_env, local_batch, process_shard

__all__ = [
    "ShardedCTCDecoder",
    "all_reduce_counts",
    "initialize_from_env",
    "local_batch",
    "make_data_mesh",
    "process_shard",
]
