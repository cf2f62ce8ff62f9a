"""Distribution substrate: sharding rules, the GPipe pipeline, compression
and fault tolerance (the port of ``repro.distributed``)."""

from .sharding import (  # noqa: F401
    ShardingRules,
    base_rules,
    logical_sharding,
    long_context_rules,
    shard,
    use_rules,
)
from .compression import (  # noqa: F401
    compress_grads_int8,
    compress_with_error_feedback,
    decompress_grads_int8,
    init_residual,
)
