"""Distribution substrate: gradient compression and fault tolerance (the
port of ``repro.distributed``; sharding and the pipeline wait for ROADMAP.md
Queue 1 item 12)."""

from .compression import (  # noqa: F401
    compress_grads_int8,
    compress_with_error_feedback,
    decompress_grads_int8,
    init_residual,
)
