"""Worker-axis communication formats of the port (int8 + error feedback)
and the logical-axis -> mesh sharding rules of the dry run."""

from .compression import (EFState, compressed_worker_mean, dequantize_int8,
                          ef_init, quantize_int8)
from .sharding import (batch_shardings, cache_shardings, leaf_spec, named,
                       param_shardings)

__all__ = [
    "EFState", "compressed_worker_mean", "dequantize_int8", "ef_init",
    "quantize_int8", "batch_shardings", "cache_shardings", "leaf_spec",
    "named", "param_shardings",
]
